"""Class-weighted cross-entropy in the port (``io.manifest.class_weights``,
``ops.losses.softmax_cross_entropy(class_weights=)``,
``TrainConfig.use_class_weights`` and the ``class_weights`` of the train
steps) against the JAX package: the balanced weights, the loss under each
reduction, three train steps of the tiny two-class text classifier
against ``build_train_step_fn(..., class_weights=)`` (the cross-entropy
weighted, the focal loss ignoring the weights, a short last batch), the
grouped step at K = 4 against K = 1, and a fold-parallel step per fold.

Tolerances: f32.  Losses within 1e-5; grad norms 1e-4 relative; weights
within Adam's bound of 2 x 3.17 lr a step, all but 1 % of the entries
within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.io.manifest import class_weights as j_class_weights
from mpmc_tpu.models.classifier import TextClassifier as JTextClassifier
from mpmc_tpu.ops.losses import softmax_cross_entropy as j_ce
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   TrainConfig)
from mpmc_tpu_torch.io.manifest import class_weights
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.ops.losses import softmax_cross_entropy
from mpmc_tpu_torch.parallel.fold_parallel import build_fold_parallel_steps
from mpmc_tpu_torch.train.graphs import make_scan_train_step
from mpmc_tpu_torch.train.step import build_train_step

TOL, LR, STEPS, B, N, S = 1e-5, 1e-3, 3, 8, 40, 16
CPU = torch.device("cpu")


@pytest.mark.parametrize("labels", [[0, 1, 1, 0, 0, 0, 0, 1, 0, 0],
                                    [1] * 7, [0, 0, 0, 1], list(range(2)) * 9],
                         ids=["skewed", "one_class", "three_to_one",
                              "balanced"])
def test_balanced_class_weights_equal_jax(labels):
    got = class_weights(np.array(labels))
    want = j_class_weights(np.array(labels))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_cross_entropy_equals_jax(reduction, weighted):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 2)).astype(np.float32) * 3
    labels = (rng.random(12) < 0.25).astype(np.int32)
    cw = class_weights(labels) if weighted else None
    got = softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if cw is None else torch.from_numpy(cw), reduction=reduction)
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                None if cw is None else jnp.asarray(cw), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_all_zero_weights_hit_the_floor():
    """A batch whose rows all weigh 0 divides by 1e-9, not by 0."""
    got = softmax_cross_entropy(torch.ones(3, 2), torch.ones(3),
                                torch.zeros(2))
    assert float(got) == 0.0


def test_use_class_weights_default_equals_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    assert ours["use_class_weights"] is theirs["use_class_weights"] is False


def _configs(loss, classes):
    zero = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jm = dataclasses.replace(JModelConfig.tiny_2c(), num_classes=classes,
                             dropout=0.0)
    jm = dataclasses.replace(jm, text=dataclasses.replace(jm.text, **zero))
    pm = dataclasses.replace(ModelConfig.tiny_2c(), num_classes=classes,
                             dropout=0.0)
    pm = dataclasses.replace(pm, text=dataclasses.replace(pm.text, **zero))
    jcfg = JTrainConfig(model=jm, data=JDataConfig(batch_size=B),
                        loss=JLossType(loss), learning_rate=LR, bf16=False,
                        use_class_weights=True)
    pcfg = TrainConfig(model=pm, data=DataConfig(batch_size=B),
                       loss=LossType(loss), learning_rate=LR, bf16=False,
                       use_class_weights=True)
    return jm, jcfg, pm, pcfg


def _data(folds=1):
    rng = np.random.default_rng(11)
    lens = rng.integers(4, S + 1, N)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    store = {"text_ids": rng.integers(5, 512, (N, S)) * mask,
             "text_mask": mask,
             "label": np.zeros(N, np.int64)}
    store["label"][rng.permutation(N)[:N // 4]] = 1
    idx = np.stack([np.stack([rng.permutation(N)[:B] for _ in range(folds)])
                    for _ in range(STEPS)])
    valid = np.ones((STEPS, folds, B), np.float32)
    valid[-1, :, B - 3:] = 0.0          # a short last batch
    return store, idx, valid


def _jax_run(jm, jcfg, tree, cw, store, idx, valid):
    tx = make_optimizer(jcfg, STEPS)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, tree)}, tx)
    step = jax.jit(build_train_step_fn(
        make_apply_fn(JTextClassifier(jm), "text"), jcfg, tx,
        class_weights=jnp.asarray(cw)))
    losses, norms = [], []
    for s in range(len(idx)):
        batch = {k: jnp.asarray(v[idx[s]].astype(np.int32))
                 for k, v in store.items()}
        batch["valid"] = jnp.asarray(valid[s])
        state, m = step(state, batch, jax.random.key(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params))


def _tree(jm, seed=0):
    ids = np.zeros((1, S), np.int32)
    return jax.tree_util.tree_map(np.asarray, JTextClassifier(jm).init(
        jax.random.key(seed), ids, np.ones_like(ids))["params"])


def _close(got, want, what):
    bound = 2 * 3.17 * LR * STEPS
    off = count = 0
    for name, w in want.items():
        d = np.abs(got[name].detach().numpy() - w.numpy())
        assert d.max() <= bound, (what, name, d.max())
        off += int(np.sum(d > TOL))
        count += d.size
    assert off <= 0.01 * count, (what, off, count)


@pytest.mark.parametrize("loss,classes", [("ce", 2),
                                          ("focal", 1)])
def test_train_steps_match_the_jax_step_with_class_weights(loss, classes):
    """The cross-entropy weighs each row by its class (a different loss
    from the unweighted one); the focal loss ignores the weights in both
    packages."""
    jm, jcfg, pm, pcfg = _configs(loss, classes)
    store, idx, valid = _data()
    cw = class_weights(store["label"])
    assert cw[1] == 3 * cw[0]
    tree = _tree(jm)
    want_l, want_n, want_w = _jax_run(jm, jcfg, tree, cw, store, idx[:, 0],
                                      valid[:, 0])
    tstore = {k: torch.from_numpy(v) for k, v in store.items()}
    losses = {}
    for weighted in (True, False):
        model = build_model(pm, CPU, kind="text")
        model.load_state_dict(from_jax_variables(tree))
        step = build_train_step(model, pcfg, STEPS, tstore,
                                torch.Generator().manual_seed(0),
                                class_weights=cw if weighted else None)
        ms = [step({"idx": torch.from_numpy(idx[s, 0]),
                    "valid": torch.from_numpy(valid[s, 0])})
              for s in range(STEPS)]
        losses[weighted] = [float(m["loss"]) for m in ms]
        if weighted:
            np.testing.assert_allclose(losses[True], want_l, rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose([float(m["grad_norm"]) for m in ms],
                                       want_n, rtol=1e-4, atol=TOL)
            _close(dict(model.named_parameters()), want_w, loss)
    if loss == "focal":
        assert losses[True] == losses[False]
    else:
        assert abs(losses[True][0] - losses[False][0]) > 1e-3


def test_grouped_steps_carry_the_class_weights():
    """``make_scan_train_step`` over a class-weighted step: a group of K =
    3 steps equals the three steps one by one, bit for bit."""
    _, _, pm, pcfg = _configs("ce", 2)
    store, idx, valid = _data()
    cw = class_weights(store["label"])
    tstore = {k: torch.from_numpy(v) for k, v in store.items()}
    runs = []
    for k in (1, STEPS):
        model = build_model(pm, CPU, seed=0, kind="text")
        step = build_train_step(model, pcfg, STEPS, tstore,
                                torch.Generator().manual_seed(0),
                                class_weights=cw)
        batch = {"idx": torch.from_numpy(idx[:, 0]),
                 "valid": torch.from_numpy(valid[:, 0])}
        if k == 1:
            ms = [step({n: v[s] for n, v in batch.items()})
                  for s in range(STEPS)]
            loss = torch.stack([m["loss"] for m in ms])
        else:
            loss = make_scan_train_step(step, k)(batch)["loss"]
        runs.append((loss, {n: p.detach().clone()
                            for n, p in model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


def test_fold_parallel_step_matches_the_jax_step_per_fold():
    jm, jcfg, pm, pcfg = _configs("ce", 2)
    store, idx, valid = _data(folds=2)
    cw = class_weights(store["label"])
    trees = [_tree(jm, seed) for seed in (0, 1)]
    tstore = {k: torch.from_numpy(v) for k, v in store.items()}
    models = [build_model(pm, CPU, seed=k, kind="text") for k in (0, 1)]
    for m, t in zip(models, trees):
        m.load_state_dict(from_jax_variables(t))
    step, _ = build_fold_parallel_steps(
        models, pcfg, STEPS, tstore, tstore,
        torch.Generator().manual_seed(0), class_weights=cw)
    ms = [step({"idx": torch.from_numpy(idx[s]),
                "valid": torch.from_numpy(valid[s])}) for s in range(STEPS)]
    for k in (0, 1):
        want_l, want_n, want_w = _jax_run(jm, jcfg, trees[k], cw, store,
                                          idx[:, k], valid[:, k])
        np.testing.assert_allclose([float(m["loss"][k]) for m in ms], want_l,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose([float(m["grad_norm"][k]) for m in ms],
                                   want_n, rtol=1e-4, atol=TOL)
        _close(step.fold_state(k)["model"], want_w, k)
