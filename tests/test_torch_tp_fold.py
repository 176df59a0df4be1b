"""Tensor parallelism inside the fold-parallel step (JAX's 3-D ``(fold,
data, model)`` composition, ``tests/test_tensor_parallel.py``'s
``test_tp_composes_with_fold_parallel_3d_mesh``) on a gloo world of 8 CPU
processes: fold 2 x data 2 x model 2 (``torch_dist_cases.tp_fold_cases``,
run once for the file).

Four folds with four different inits and four different batch orders, two
a fold group, so that a mix-up across folds, inside one process's
``vmap`` or across fold groups, shows.  The JAX reference is the tiny
two-class f32 ``TextClassifier`` of that test's ``_text_setup``, dropout
0, under the ``adam`` embedding optimizer; a second run at width 128 (a
factored word-embedding table needs a second-largest dim of 128) uses
``factored``.  Each fold's three steps are held against JAX's plain
``build_train_step_fn`` step on that fold; each fold group's gathered
stacked state, its folds' gathered states and eval probabilities against
one process running all four folds in one fold-parallel step.

Tolerances: f32.  Losses within 1e-5; grad norms 1e-4 relative; weights
within Adam's bound of 2 x 3.17 lr a step, all but 1 % of the entries
within 1e-5, as ``tests/test_torch_tp.py`` holds them; probabilities
within 1e-5."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import MeshConfig as JMeshConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPooling
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.models.classifier import TextClassifier as JTextClassifier
from mpmc_tpu.parallel.mesh import make_mesh as j_make_mesh
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TextEncoderConfig,
                                   TrainConfig)
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.parallel.dist_worker import launch_processes
from mpmc_tpu_torch.parallel.fold_parallel import build_fold_parallel_steps
from mpmc_tpu_torch.parallel.tp import spec_for_name
from test_torch_pp import write_planted
from test_torch_tp import _split_dims

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL, STEPS, FOLDS, B, N, S = 1e-5, 3, 4, 8, 40, 16
CPU = torch.device("cpu")
ENC = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           intermediate_size=256, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)
# name: (text encoder, pooling, train config fields shared by both sides)
RUNS = {
    "adam": (None, None, dict(learning_rate=1e-3)),
    "factored": (ENC, "attention", dict(learning_rate=1e-3,
                                        lr_schedule="constant",
                                        embedding_optimizer="factored")),
}


def _configs(run):
    enc, pooling, fields = RUNS[run]
    zero = dict(hidden_dropout=0.0, attention_dropout=0.0)
    if enc is None:                     # _text_setup's model, dropout 0
        jm = dataclasses.replace(JModelConfig.tiny_2c(), num_classes=2,
                                 dropout=0.0)
        jm = dataclasses.replace(jm, text=dataclasses.replace(jm.text,
                                                              **zero))
        pm = dataclasses.replace(ModelConfig.tiny_2c(), num_classes=2,
                                 dropout=0.0)
        pm = dataclasses.replace(pm, text=dataclasses.replace(pm.text,
                                                              **zero))
    else:
        jm = JModelConfig(text=JTextConfig(**enc),
                          pooling=JPooling(pooling), num_classes=2,
                          dropout=0.0)
        pm = ModelConfig(text=TextEncoderConfig(**enc),
                         pooling=PoolingType(pooling), num_classes=2,
                         dropout=0.0)
    jcfg = JTrainConfig(model=jm, data=JDataConfig(batch_size=B),
                        loss=JLossType.CROSS_ENTROPY, bf16=False, **fields)
    pcfg = TrainConfig(model=pm, data=DataConfig(batch_size=B),
                       loss=LossType.CROSS_ENTROPY, bf16=False, **fields)
    return jm, jcfg, pm, pcfg


def _trees(jm):
    ids = np.zeros((1, S), np.int32)
    return [jax.tree_util.tree_map(np.asarray, JTextClassifier(jm).init(
        jax.random.key(k), ids, np.ones_like(ids))["params"])
        for k in range(FOLDS)]


def _data():
    rng = np.random.default_rng(15)
    lens = rng.integers(4, S + 1, N)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    store = {"text_ids": rng.integers(5, 512, (N, S)) * mask,
             "text_mask": mask, "label": rng.integers(0, 2, N)}
    idx = np.stack([np.stack([rng.permutation(N)[:B] for _ in range(FOLDS)])
                    for _ in range(STEPS)])
    eval_idx = np.stack([rng.permutation(N)[:B] for _ in range(FOLDS)])
    return store, idx, eval_idx


@pytest.fixture(scope="module")
def setup():
    store, idx, eval_idx = _data()
    trees = {run: _trees(_configs(run)[0]) for run in RUNS}
    return store, idx, eval_idx, trees


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    store, idx, eval_idx, trees = setup
    work = tmp_path_factory.mktemp("tp_fold")
    case = str(work / "case.pt")
    runs = {run: {"cfg": _configs(run)[3], "trees": trees[run]}
            for run in RUNS}
    torch.save({"store": store, "idx": idx, "eval_idx": eval_idx,
                "runs": runs}, case)
    lines = launch_processes(
        8, target="torch_dist_cases:tp_fold_cases",
        kwargs={"case": case, "out": str(work / "r")},
        env={"PYTHONPATH": TESTS}, timeout=240, device="cpu")
    return [torch.load(line["result"], weights_only=False)
            for line in lines]


def _jax_fold(step, tx, tree, store, idx, fold):
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, tree)}, tx)
    losses, norms = [], []
    for s in range(STEPS):
        rows = idx[s, fold]
        batch = {k: jnp.asarray(v[rows].astype(np.int32))
                 for k, v in store.items()}
        batch["valid"] = jnp.ones(B, jnp.float32)
        state, m = step(state, batch, jax.random.key(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def jax_folds(setup):
    """Each fold's three steps through the JAX package's plain step."""
    store, idx, _, trees = setup
    out = {}
    for run in RUNS:
        jm, jcfg, _, _ = _configs(run)
        tx = make_optimizer(jcfg, STEPS)
        step = jax.jit(build_train_step_fn(
            make_apply_fn(JTextClassifier(jm), "text"), jcfg, tx))
        out[run] = [_jax_fold(step, tx, trees[run][k], store, idx, k)
                    for k in range(FOLDS)]
    return out


@pytest.fixture(scope="module")
def one_process(setup):
    """All four folds in one fold-parallel step in this process: no data
    split, no model split."""
    store, idx, eval_idx, trees = setup
    out = {}
    for run in RUNS:
        _, _, pm, pcfg = _configs(run)
        models = [build_model(pm, CPU, seed=k, kind="text")
                  for k in range(FOLDS)]
        for m, t in zip(models, trees[run]):
            m.load_state_dict(from_jax_variables(t))
        tstore = {k: torch.from_numpy(v) for k, v in store.items()}
        step, evaluate = build_fold_parallel_steps(
            models, pcfg, STEPS, tstore, tstore,
            torch.Generator().manual_seed(0))
        losses, norms = [], []
        for s in range(STEPS):
            m = step({"idx": torch.from_numpy(idx[s]),
                      "valid": torch.ones(FOLDS, B)})
            losses.append(m["loss"].tolist())
            norms.append(m["grad_norm"].tolist())
        probs, _ = evaluate({"idx": torch.from_numpy(eval_idx)})
        out[run] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                    "probs": probs.numpy(), "state": step.state_dict()[
                        "model"]}
    return out


def _close(got, want, what, lr=1e-3):
    bound = 2 * 3.17 * lr * STEPS
    assert set(got) == set(want), what
    off = count = 0
    for name, w in want.items():
        assert got[name].shape == w.shape, (what, name)
        d = np.abs(got[name].numpy() - w.numpy())
        assert d.max() <= bound, (what, name, d.max())
        off += int(np.sum(d > TOL))
        count += d.size
    assert off <= 0.01 * count, (what, off, count)


def _group(ranks, fold):
    """The ranks of the fold group holding ``fold``, and ``fold``'s place
    in that group's stack."""
    group = [r for r in ranks if fold in r["folds"]]
    assert len(group) == 4
    return group, group[0]["folds"].index(fold)


def test_world_is_fold_data_model_and_ranks_agree(ranks):
    coords = sorted(tuple(r["coords"][a] for a in ("fold", "data", "model"))
                    for r in ranks)
    assert coords == [(f, d, m) for f in (0, 1) for d in (0, 1)
                      for m in (0, 1)]
    for fold in range(FOLDS):
        group, _ = _group(ranks, fold)
        for run in RUNS:
            first = group[0][run]
            for r in group[1:]:
                assert r[run]["loss"] == first["loss"], (run, fold)
                assert r[run]["grad_norm"] == first["grad_norm"], (run, fold)
                for n, v in first["state"].items():
                    assert torch.equal(r[run]["state"][n], v), (run, n)


@pytest.mark.parametrize("run", list(RUNS))
def test_split_leaves_keep_the_fold_dim_and_the_model_split(ranks, setup,
                                                            run):
    """Every split leaf is split over ``model`` by JAX's rules (the dims
    JAX's ``spec_for_path`` gives, one behind the fold dim, as its
    ``shard_state(..., leading_axes=("fold",))`` places them), and every
    leaf carries the fold group's two folds in front."""
    want = {n: d for n, d in _split_dims(setup[3][run][0]).items()
            if d is not None}
    assert want
    for r in ranks:
        res = r[run]
        assert res["split"] == want
        assert all(spec_for_name(n) == d for n, d in want.items())
        for n, shape in res["local_shapes"].items():
            whole = tuple(res["state"][n].shape)
            assert shape[0] == whole[0] == 2, n
            if n in want:
                d = want[n] + 1
                assert shape[d] * 2 == whole[d], n
                assert shape[:d] + shape[d + 1:] == whole[:d] + whole[d + 1:]
            else:
                assert shape == whole, n


@pytest.mark.parametrize("run", list(RUNS))
def test_each_fold_matches_the_jax_step_on_that_fold(ranks, jax_folds, run):
    lr = RUNS[run][2]["learning_rate"]
    losses = [jax_folds[run][k][0] for k in range(FOLDS)]
    # The folds are distinct: a mix-up between any two would show.
    assert len({round(ls[0], 4) for ls in losses}) == FOLDS
    for k in range(FOLDS):
        want_l, want_n, want_w = jax_folds[run][k]
        group, j = _group(ranks, k)
        res = group[0][run]
        np.testing.assert_allclose([ls[j] for ls in res["loss"]], want_l,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose([ns[j] for ns in res["grad_norm"]],
                                   want_n, rtol=1e-4, atol=TOL)
        _close(res["fold_states"][j], want_w, (run, k), lr)


@pytest.mark.parametrize("run", list(RUNS))
def test_gathered_state_equals_one_process_fold_parallel(ranks, one_process,
                                                         run):
    one = one_process[run]
    lr = RUNS[run][2]["learning_rate"]
    for lo in (0, 2):
        group, _ = _group(ranks, lo)
        res = group[0][run]
        np.testing.assert_allclose(res["loss"], one["loss"][:, lo:lo + 2],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["grad_norm"],
                                   one["grad_norm"][:, lo:lo + 2],
                                   rtol=1e-4, atol=TOL)
        np.testing.assert_allclose(res["probs"], one["probs"][lo:lo + 2],
                                   atol=TOL)
        _close(res["state"], {n: v[lo:lo + 2] for n, v in
                              one["state"].items()}, (run, lo), lr)
        for j in range(2):
            assert set(res["fold_states"][j]) == set(one["state"])
            for n, v in res["fold_states"][j].items():
                assert torch.equal(v, res["state"][n][j]), n


def test_command_line_still_refuses_fold_parallel_with_model_shards(
        ranks, tmp_path):
    with pytest.raises(ValueError) as jax_err:
        j_make_mesh(JMeshConfig(fold_parallel=True, num_model_shards=2),
                    jax.devices()[:8])
    for r in ranks:
        assert r["refused"] == str(jax_err.value)
    write_planted(tmp_path / "t.json", 16, 0)
    write_planted(tmp_path / "d.json", 8, 1, off=100)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        main(["train", "--subtask", "2a", "-tr", str(tmp_path / "t.json"),
              "-te", str(tmp_path / "d.json"), "--small", "--fold-parallel",
              "--model-shards", "2", "--device", "cpu",
              "--out-dir", str(tmp_path / "out")])
