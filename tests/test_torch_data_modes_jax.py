"""The port's two data modes (``DataConfig.device_resident``) against the
JAX package's: ``fit`` over the tiny 2C model resident and host-fed
against the JAX ``fit`` with ``GatherSteps``/``DeviceData`` and with host
batches, ``run_eval`` over a resident split against the JAX gather eval,
and ``_run_folds`` host-fed against the JAX driver's streaming run
(``tests/test_device_resident.py::test_driver_streaming_mode_still_works``'s
case).  The JAX runs are shared in module fixtures."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import _run_folds as j_run_folds
from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models import TextClassifier as JText
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.train.loop import DeviceData as JDeviceData
from mpmc_tpu.train.loop import fit as j_fit
from mpmc_tpu.train.loop import run_eval as j_run_eval
from mpmc_tpu.train.step import (GatherSteps, create_train_state,
                                 make_eval_step as j_make_eval_step,
                                 make_gather_eval_step,
                                 make_gather_train_step, make_optimizer,
                                 make_train_step as j_make_train_step)
from mpmc_tpu_torch.cli.experiments import _run_folds
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig)
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.train.loop import DeviceData, fit, run_eval
from mpmc_tpu_torch.train.step import build_train_step, make_eval_step

CPU = torch.device("cpu")
TOL = 1e-5          # a step's loss: f32 on both sides, sums in other orders
B, LR, N, N_TEST = 4, 1e-4, 24, 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _ragged(rng, n, S, vocab=512):
    lens = rng.integers(2, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _mm_data(seed, n, mcfg):
    rng = np.random.default_rng(seed)
    t_ids, t_mask = _ragged(rng, n, mcfg.max_text_len)
    c_ids, c_mask = _ragged(rng, n, mcfg.max_caption_len)
    size = mcfg.image.image_size
    return {"text_ids": t_ids, "text_mask": t_mask, "caption_ids": c_ids,
            "caption_mask": c_mask,
            "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _zero_dropout(mcfg):
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        mcfg, dropout=0.0, text=dataclasses.replace(mcfg.text, **enc),
        caption=dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


def _select(data, idx):
    return {k: v[idx] for k, v in data.items()}


def _tensors(data):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in data.items()}


@pytest.fixture(scope="module")
def case():
    """tiny 2C, dropout 0, f32: 24 manifest rows (16 train, 4 steps of 4,
    an eval every 2; 8 val) and an 8-row test split; the augmentation's
    draws fixed (the same at every step on both sides); the flax init's
    weights; the JAX ``fit`` host-fed and resident (gather steps over
    ``DeviceData``), each step's loss recorded."""
    mcfg = _zero_dropout(ModelConfig.tiny_2c())
    jmcfg = _zero_dropout(JModelConfig.tiny_2c())
    full, test = _mm_data(1, N, mcfg), _mm_data(2, N_TEST, mcfg)
    order = np.random.default_rng(0).permutation(N)
    tr_idx, va_idx = np.sort(order[:16]), np.sort(order[16:])
    rng = np.random.default_rng(5)
    flip = rng.random(B) < 0.5
    bright = rng.uniform(0.9, 1.1, B).astype(np.float32)
    angle = (rng.uniform(-15, 15, B) * math.pi / 180).astype(np.float32)
    jmodel = JClassifier(jmcfg)
    variables = jmodel.init(jax.random.key(3, impl="threefry2x32"),
                            full["text_ids"][:2], full["text_mask"][:2],
                            full["image"][:2].astype(np.float32) / 255.0,
                            full["caption_ids"][:2], full["caption_mask"][:2])
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    base = make_apply_fn(jmodel, "multimodal", augment_images=False)

    def apply_fn(variables, batch, train, rngs, mutable):
        img = j_rotate_shear(j_fused(batch["image"], jnp.asarray(flip),
                                     jnp.asarray(bright), interpret=True),
                             jnp.asarray(angle), 15.0)
        return base(variables, dict(batch, image=img), train, rngs, mutable)

    eval_apply = make_apply_fn(jmodel, "multimodal", augment_images=True)
    runs = {}
    for resident in (False, True):
        jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(
            batch_size=B, device_resident=resident), learning_rate=LR,
            lr_schedule="constant", bf16=False, epochs=1)
        tx = make_optimizer(jcfg, 4)
        state, _ = create_train_state({"params": jax.tree_util.tree_map(
            jnp.asarray, params), "batch_stats": stats}, tx)
        losses = []

        def recording(fn):
            def step(*args):
                state, m = fn(*args)
                losses.append(float(m["loss"]))
                return state, m
            return step

        kw = {}
        if resident:
            dfull, dtest = jax.device_put(full), jax.device_put(test)
            kw = dict(gather_steps=GatherSteps(
                          train=recording(make_gather_train_step(
                              apply_fn, jcfg, tx, donate=False)),
                          eval=make_gather_eval_step(eval_apply, jcfg)),
                      dev_train=JDeviceData(dfull, tr_idx),
                      dev_test=JDeviceData(dtest, np.arange(N_TEST)),
                      dev_val=JDeviceData(dfull, va_idx))
        res = j_fit(state, recording(j_make_train_step(apply_fn, jcfg, tx)),
                    j_make_eval_step(eval_apply, jcfg), jcfg,
                    _select(full, tr_idx), test_data=test,
                    val_data=_select(full, va_idx), **kw)
        runs[resident] = dict(losses=losses, history=res.history,
                              params=_np(res.state.params),
                              stats=_np(res.state.batch_stats))
    return dict(mcfg=mcfg, jmcfg=jmcfg, full=full, test=test, tr_idx=tr_idx,
                va_idx=va_idx, draws=[torch.from_numpy(x) for x in
                                      (flip, bright, angle)],
                params=params, stats=stats, eval_apply=eval_apply,
                runs=runs)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host-fed", "resident"])
def test_fit_matches_jax_fit_in_each_mode(case, resident):
    """The port's ``fit`` in each mode against the JAX ``fit`` in the same
    mode: the history's ``(epoch, batch)``, every step's loss within 1e-5,
    each eval's loss within 1e-3 relative (BatchNorm running statistics
    from 4-row batches amplify f32 rounding) and the weights within Adam's
    bound."""
    mcfg, full = case["mcfg"], case["full"]
    cfg = TrainConfig(model=mcfg, data=DataConfig(
        batch_size=B, device_resident=resident), learning_rate=LR,
        lr_schedule="constant", bf16=False, epochs=1)
    model = build_model(mcfg, CPU)
    model.load_state_dict(from_jax_variables(case["params"], case["stats"]))
    store = _tensors(full) if resident else {}
    draws = case["draws"]
    step = build_train_step(model, cfg, 4, store, torch.Generator(),
                            augment=lambda u8, gen: augment_with_draws(
                                u8, *draws))
    evals = make_eval_step(model, cfg, cast_in_place=False)
    dev = {}
    if resident:
        dev = dict(dev_test=DeviceData(_tensors(case["test"]),
                                       np.arange(N_TEST)),
                   dev_val=DeviceData(store, case["va_idx"]))
    res = fit(step, evals, cfg, _select(full, case["tr_idx"]), CPU,
              test_data=case["test"],
              val_data=_select(full, case["va_idx"]),
              train_rows=case["tr_idx"] if resident else None, **dev)
    want = case["runs"][resident]
    assert [(h["epoch"], h["batch"]) for h in res.history] == [
        (h["epoch"], h["batch"]) for h in want["history"]] == [(0, 2), (0, 4)]
    np.testing.assert_allclose([m["loss"] for m in res.steps],
                               want["losses"], atol=TOL, rtol=TOL)
    for h, jh in zip(res.history, want["history"]):
        np.testing.assert_allclose(h["test_loss"], jh["test_loss"],
                                   rtol=1e-3, atol=0)
    ref = from_jax_variables(want["params"], want["stats"])
    bound = 2 * 3.17 * LR * 4
    got = model.state_dict()
    for name, w in ref.items():
        d = (got[name] - w).abs().max().item()
        assert d <= bound, (name, d)


def test_run_eval_resident_matches_jax_gather_eval(case):
    """The test split through the port's resident ``run_eval``, host-fed
    and the JAX ``run_eval`` with ``gather_eval``/``dev`` on the flax
    init's weights: the port's two modes bit-equal, the JAX probabilities
    within 1e-6 relative."""
    mcfg, test = case["mcfg"], case["test"]
    cfg = TrainConfig(model=mcfg, bf16=False)
    model = build_model(mcfg, CPU)
    model.load_state_dict(from_jax_variables(case["params"], case["stats"]))
    evals = make_eval_step(model, cfg, cast_in_place=False)
    rows = np.arange(N_TEST)
    resident = run_eval(evals, test, B, CPU,
                        dev=DeviceData(_tensors(test), rows))
    host = run_eval(evals, test, B, CPU)
    np.testing.assert_array_equal(resident.probs, host.probs)
    assert resident.loss == host.loss
    jcfg = JTrainConfig(model=case["jmcfg"], data=JDataConfig(batch_size=B),
                        bf16=False)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, case["params"]), "batch_stats": case["stats"]},
        make_optimizer(jcfg, 4))
    want = j_run_eval(state, j_make_eval_step(case["eval_apply"], jcfg), test,
                      B, gather_eval=make_gather_eval_step(case["eval_apply"],
                                                           jcfg),
                      dev=JDeviceData(jax.device_put(test), rows))
    np.testing.assert_allclose(resident.probs, want.probs, rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def driver_case(tmp_path_factory):
    """``test_driver_streaming_mode_still_works``'s case: the tiny text
    model (CLS pooling, 2 classes, CE), 64 memes whose first token gives
    the label away, 2 folds, fold 0, 6 epochs; the JAX driver host-fed."""
    rng = np.random.default_rng(0)
    n = 64
    y = (rng.random(n) > 0.5).astype(np.int32)
    ids_arr = rng.integers(5, 512, (n, 16)).astype(np.int32)
    ids_arr[:, 0] = y * 3 + 1
    data = {"text_ids": ids_arr, "text_mask": np.ones_like(ids_arr),
            "label": y}
    ids = [f"d/x_{i}.jpg" for i in range(n)]
    jmcfg = dataclasses.replace(JModelConfig.tiny_2c(), num_classes=2,
                                pooling=JPoolingType.CLS)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(
        batch_size=16, num_folds=2, device_resident=False), epochs=6,
        loss=JLossType.CROSS_ENTROPY, learning_rate=3e-3)
    out = tmp_path_factory.mktemp("jax_driver")
    res = j_run_folds(jcfg, lambda: JText(jmcfg), "text", data, ids, None,
                      None, str(out), "task2X", folds=[0])
    return data, ids, res.fold_results[0].best_macro_f1, out


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host-fed", "resident"])
def test_run_folds_matches_the_jax_streaming_driver(tmp_path, driver_case,
                                                    resident):
    """The port's ``_run_folds`` in each mode on the JAX driver's case:
    the same TSV files, fold 0's ids in the same order, and the same best
    macro-F1."""
    data, ids, j_f1, j_out = driver_case
    mcfg = dataclasses.replace(ModelConfig.tiny_2c(), num_classes=2,
                               pooling=PoolingType.CLS)
    cfg = TrainConfig(model=mcfg, data=DataConfig(
        batch_size=16, num_folds=2, device_resident=resident), epochs=6,
        loss=LossType.CROSS_ENTROPY, learning_rate=3e-3, bf16=False)
    res = _run_folds(cfg, data, ids, None, None, str(tmp_path), "task2X",
                     CPU, folds=[0], kind="text")
    assert res[0].best_macro_f1 == j_f1 > 0.8
    names = sorted(p for p in os.listdir(j_out) if p.endswith(".tsv"))
    assert names == sorted(p for p in os.listdir(tmp_path)
                           if p.endswith(".tsv"))
    for name in names:
        rows = [[r.split("\t")[0] for r in
                 open(os.path.join(d, name)).read().splitlines()]
                for d in (j_out, tmp_path)]
        assert rows[0] == rows[1], name
