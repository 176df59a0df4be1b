"""Tensor parallelism in the port (``parallel/tp.py``) on a gloo world of
two CPU processes (``torch_dist_cases.tp_cases``, run once for the file):
the rule table against the JAX ``spec_for_path`` over the mapped names;
three 2A train steps at ``--model-shards 2`` against the JAX replicated
step under the ``adam`` and ``factored`` embedding optimizers; the
gathered (unsharded) training state and its restore; a block whose heads
or vocabulary do not divide the group stays whole; ``train --subtask 2a
--model-shards 2`` end to end, whose ``model.pt`` ``predict`` reads.

Tolerances: f32.  Losses within 1e-5; grad norms 1e-4 relative; weights
within Adam's bound of 2 x 3.17 lr a step, all but 1 % of the entries
within 1e-5, as the single-process step tests hold them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPooling
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.classifier import TextClassifier as JTextClassifier
from mpmc_tpu.parallel.tp import spec_for_path
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (ModelConfig, PoolingType,
                                   TextEncoderConfig)
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.parallel.dist_worker import launch_processes
from mpmc_tpu_torch.parallel.tp import spec_for_name
from test_torch_pp import TSVS, driver_argv, write_planted

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL, LR, STEPS = 1e-5, 1e-3, 3
# A factored word-embedding table needs a second-largest dim of 128.
ENC = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           intermediate_size=256, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)


def _jax_text():
    mcfg = JModelConfig(text=JTextConfig(**ENC), pooling=JPooling.ATTENTION,
                        num_classes=2, dropout=0.0)
    ids = np.zeros((1, 16), np.int32)
    params = JTextClassifier(mcfg).init(jax.random.key(0), ids,
                                        np.ones_like(ids))["params"]
    return mcfg, jax.tree_util.tree_map(np.asarray, params)


def _batches():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(5, 512, (8, 16)).astype(np.int64)
        mask = np.ones_like(ids)
        mask[:, 10 + rng.integers(0, 6):] = 0
        out.append({"text_ids": ids, "text_mask": mask,
                    "label": rng.integers(0, 2, 8).astype(np.int64),
                    "valid": np.ones(8, np.float32)})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    _, params = _jax_text()
    mcfg = ModelConfig(text=TextEncoderConfig(**ENC),
                       pooling=PoolingType.ATTENTION, num_classes=2,
                       dropout=0.0)
    case = str(work / "case.pt")
    torch.save({"state": from_jax_variables(params), "mcfg": mcfg,
                "batches": _batches()}, case)
    write_planted(work / "train.json", 48, 0)
    write_planted(work / "dev.json", 16, 1, off=100)
    lines = launch_processes(
        2, target="torch_dist_cases:tp_cases",
        kwargs={"case": case, "out": str(work / "r"),
                "argv": driver_argv(work, ["--model-shards", "2"])},
        env={"PYTHONPATH": TESTS}, timeout=240, device="cpu")
    return work, [torch.load(line["result"], weights_only=False)
                  for line in lines]


def _split_dims(tree):
    """For each port name of the JAX ``tree``'s leaves: the dim its JAX
    spec splits over ``model``, found by converting leaves that vary only
    along that dim; None for a replicated leaf."""
    def marker(path, x):
        spec = spec_for_path(path)
        dims = [i for i, ax in enumerate(spec) if ax == "model"]
        if not dims:
            return np.zeros(x.shape, np.float32)
        shape = [1] * x.ndim
        shape[dims[0]] = x.shape[dims[0]]
        return np.broadcast_to(np.arange(x.shape[dims[0]], dtype=np.float32)
                               .reshape(shape), x.shape).copy()

    sd = from_jax_variables(jax.tree_util.tree_map_with_path(marker, tree))
    out = {}
    for name, t in sd.items():
        varying = [d for d in range(t.dim())
                   if (t - t.narrow(d, 0, 1)).abs().max() > 0]
        out[name] = varying[0] if varying else None
    return out


def test_rule_table_matches_jax_spec_for_path():
    _, text = _jax_text()
    jm = JClassifier(JModelConfig.tiny_2c())
    t = np.zeros((2, 8), np.int32)
    multimodal = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(0), t, np.ones_like(t),
        np.zeros((2, 64, 64, 3), np.float32), t, np.ones_like(t))["params"])
    for tree in (text, multimodal):
        want = _split_dims(tree)
        assert any(d is not None for d in want.values())
        for name, dim in want.items():
            assert spec_for_name(name) == dim, name


def _jax_steps(params, opt):
    jmcfg = JModelConfig(text=JTextConfig(**ENC), pooling=JPooling.ATTENTION,
                         num_classes=2, dropout=0.0)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=8),
                        learning_rate=LR, loss=JLossType.CROSS_ENTROPY,
                        lr_schedule="constant", embedding_optimizer=opt,
                        bf16=False)
    tx = make_optimizer(jcfg, STEPS)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, tx)
    step = jax.jit(build_train_step_fn(
        make_apply_fn(JTextClassifier(jmcfg), "text"), jcfg, tx))
    losses, norms = [], []
    for i, b in enumerate(_batches()):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.key(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params))


@pytest.mark.parametrize("opt", ["adam", "factored"])
def test_tp_step_matches_the_jax_replicated_step(ranks, opt):
    _, res = ranks
    _, params = _jax_text()
    losses, norms, want = _jax_steps(params, opt)
    r0, r1 = (r[opt] for r in res)
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    np.testing.assert_allclose(r0["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r0["grad_norm"], norms, rtol=1e-4, atol=TOL)
    got = r0["state"]
    assert set(got) == set(want)
    bound = 2 * 3.17 * LR * STEPS
    off = count = 0
    for name, w in want.items():
        assert got[name].shape == w.shape, name          # gathered whole
        d = np.abs(got[name].numpy() - w.numpy())
        assert d.max() <= bound, (name, d.max())
        off += int(np.sum(d > TOL))
        count += d.size
    assert off <= 0.01 * count, (off, count)
    for name, g in r1["state"].items():
        assert torch.equal(g, got[name]), name


def test_tp_splits_by_the_rules_and_gathers_whole_state(ranks):
    _, res = ranks
    for r in res:
        for opt in ("adam", "factored"):
            s = r[opt]
            assert s["restored"]
            assert s["sharded"] == {n: spec_for_name(n) for n in s["state"]
                                    if spec_for_name(n) is not None}
            for n, d in s["sharded"].items():
                assert s["local_shapes"][n][d] * 2 == s["state"][n].shape[d]
        emb = "encoder.word_embeddings.weight"
        assert dict(r["factored"]["slots"][emb]) == {"v_row": (128,),
                                                     "v_col": (512,)}
        assert dict(r["adam"]["slots"][emb]) == {"mu": (512, 128),
                                                 "nu": (512, 128)}


def test_tp_indivisible_blocks_stay_whole(ranks):
    _, res = ranks
    odd = res[0]["odd"]
    # One head and 511 rows do not split over 2; the MLPs' 256 units do.
    assert odd["sharded"] == sorted(
        f"encoder.layer_{i}.{m}" for i in range(2)
        for m in ("intermediate.weight", "intermediate.bias",
                  "output.weight"))
    assert odd["count"] == 6
    assert any("heads 1 not divisible by model=2" in w
               for w in odd["warnings"])
    assert any("vocabulary 511" in w and "word_embeddings" in w
               for w in odd["warnings"])


def test_tp_driver_learns_and_predict_reads_its_checkpoint(ranks, tmp_path,
                                                           monkeypatch):
    work, res = ranks
    assert [r["rc"] for r in res] == [0, 0]
    out = work / "out"
    assert sorted(p for p in os.listdir(out) if p.endswith(".tsv")) == TSVS
    with open(out / "task2A_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert max(e["test_f1"] for e in metrics["evals"]) > 0.8
    rows = [line.rstrip("\n").split("\t") for line in
            open(out / "task2A_kevinmathew_val_fold_0.tsv")][1:]
    records = {}
    for name in ("train.json", "dev.json"):
        with open(work / name, encoding="utf-8") as f:
            records.update({r["id"]: r for r in json.load(f)})
    monkeypatch.chdir(tmp_path)
    with open("val.json", "w", encoding="utf-8") as f:
        json.dump([records[r[0]] for r in rows], f, ensure_ascii=False)
    assert main(["predict", "--subtask", "2a", "--manifest", "val.json",
                 "--checkpoint", str(work / "ck" / "fold_0"), "--out",
                 "p.tsv", "--probs-out", "pp.tsv", "--device", "cpu"]) == 0
    again = [line.rstrip("\n").split("\t") for line in open("pp.tsv")][1:]
    np.testing.assert_allclose([float(r[2]) for r in again],
                               [float(r[2]) for r in rows], atol=1e-5,
                               rtol=0)
