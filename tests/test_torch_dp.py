"""Data parallelism in the port (``parallel/mesh.py``, ``parallel/
collectives.py``, ``train.step.GradSync``, ``models.norm.set_data_shard``)
on a gloo world of two CPU processes, against one process and against the
JAX package's step on the same global batch; ``--fold-shards 2``; and the
launcher's report of a rank that dies.

The ranks run once for the whole file (``torch_dist_cases.dp_steps``):
three steps of the tiny 2C model (BatchNorm heads, dropout 0, fixed
augmentation draws) on each rank's rows of each global batch of 8 out of
20 memes, so the last batch holds 4 valid rows, all on rank 0; unpacked
and packed; three fold-parallel steps of two replicas over two data
ranks; then ``train --fold-parallel --fold-shards 2`` and ``train
--fold-parallel`` over two data ranks, each held against ``train
--fold-parallel`` on one process with dropout and augmentation on.

Tolerances: f32 on both sides.  Losses within 1e-5; grad norms 1e-4
relative; BatchNorm running statistics within 5e-5; every weight within
Adam's bound of 2 x 3.17 lr a step, all but 1 % of the entries within
1e-5, as the single-process step tests hold them."""

import dataclasses
import inspect
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.parallel import dist_worker
from mpmc_tpu_torch.parallel.dist_worker import launch_processes

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
B, N, LR, STEPS = 8, 20, 1e-4, 3
CLI_LR = 1e-5                           # the train command's --lr default
ORDER_SEED = 8


def _ragged(rng, n, S, vocab=512):
    lens = rng.integers(2, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _data(seed=6, n=N):
    mcfg = JModelConfig.tiny_2c()
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
        mcfg, dropout=0.0,
        text=dataclasses.replace(mcfg.text, **enc),
        caption=dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _draws():
    rng = np.random.default_rng(7)
    return [rng.random(B) < 0.5,
            rng.uniform(0.9, 1.1, B).astype(np.float32),
            (rng.uniform(-15, 15, B) * math.pi / 180).astype(np.float32)]


def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg",
             "text": " ".join("".join(rng.choice(letters,
                                                 int(rng.integers(2, 6))))
                              for _ in range(int(rng.integers(2, 10)))),
             "class_label": ("propaganda" if rng.random() < 0.4
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX weights and global batches; the ranks' results at world 2
    and world 1; the fold-shards run's directory."""
    work = tmp_path_factory.mktemp("dp")
    data = _data()
    jm = JClassifier(JModelConfig.tiny_2c())
    variables = jm.init(jax.random.key(3, impl="threefry2x32"),
                        data["text_ids"][:2], data["text_mask"][:2],
                        data["image"][:2].astype(np.float32) / 255.0,
                        data["caption_ids"][:2], data["caption_mask"][:2])
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    case = str(work / "case.pt")
    torch.save({"state": from_jax_variables(params, stats), "data": data,
                "draws": _draws(), "batch": B, "order_seed": ORDER_SEED},
               case)
    _write_manifest(work / "train.json", 24, 0)
    _write_manifest(work / "dev.json", 8, 1, off=100)
    out = {}
    for world in (2, 1):
        lines = launch_processes(
            world, target="torch_dist_cases:dp_steps",
            kwargs={"case": case, "out": str(work / f"w{world}")},
            env={"PYTHONPATH": TESTS}, timeout=240, device="cpu")
        out[world] = [torch.load(line["result"], weights_only=False)
                      for line in lines]
    def fold_argv(d, flags):
        return ["train", "--subtask", "2c", "-tr", str(work / "train.json"),
                "-te", str(work / "dev.json"), "--tiny", "--device", "cpu",
                "--epochs", "1", "--num-folds", "2", "--batch-size", "4",
                "--fold-parallel", "--scan-steps", "1",
                "--out-dir", str(work / d / "out"),
                "--checkpoint-dir", str(work / d / "ck"),
                "--cache-dir", str(work / "cache"), *flags]

    # Fold groups of one rank each; then one group of two data ranks.
    folds = launch_processes(2, target="torch_dist_cases:cli", kwargs={
        "argvs": [fold_argv("folds", ["--fold-shards", "2"]),
                  fold_argv("folds_dp", [])]},
        env={"PYTHONPATH": TESTS}, timeout=240, device="cpu")
    # All folds on one device in this process: what both layouts must give.
    assert main(fold_argv("folds_one", [])) == 0
    return {"params": params, "stats": stats, "data": data, "w": out,
            "folds": folds, "work": work}


def _jax_unpacked(params, stats, data):
    """Three JAX train steps (the test's draws, then the unpacked apply
    without augmentation) over the same global batches."""
    jmcfg = _zero_dropout(JModelConfig.tiny_2c())
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B),
                        learning_rate=LR, adam_mu_dtype="bfloat16",
                        embedding_optimizer="factored", bf16=False)
    flip, bright, angle = (jnp.asarray(d) for d in _draws())
    base = make_apply_fn(JClassifier(jmcfg), "multimodal")

    def apply_fn(variables, batch, train, rngs, mutable):
        img = j_rotate_shear(j_fused(batch["image"], flip, bright,
                                     interpret=True), angle, 15.0)
        return base(variables, dict(batch, image=img), train, rngs, mutable)

    tx = make_optimizer(jcfg, STEPS)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params), "batch_stats": stats}, tx)
    step = jax.jit(build_train_step_fn(apply_fn, jcfg, tx))
    losses, norms = [], []
    batches = j_batch_iter(data, B, shuffle=True,
                           rng=np.random.default_rng(ORDER_SEED),
                           with_valid=True)
    for i, (batch, _) in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.key(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, from_jax_variables(_np(state.params),
                                             _np(state.batch_stats))


def _states_close(got, want, what):
    bound = 2 * 3.17 * LR * STEPS
    off = count = 0
    assert set(got) == set(want), what
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        if "running_" in name:
            assert d.max() <= 5 * TOL, (what, name, d.max())
            continue
        assert d.max() <= bound, (what, name, d.max())
        off += int(np.sum(d > TOL))
        count += d.size
    assert off <= 0.01 * count, (what, off, count)


def test_global_batch_has_uneven_valid_rows():
    valid = [b["valid"] for b, _ in j_batch_iter(
        _data(), B, shuffle=True, rng=np.random.default_rng(ORDER_SEED),
        with_valid=True)]
    assert len(valid) == STEPS
    assert valid[-1][:B // 2].sum() == 4 and valid[-1][B // 2:].sum() == 0


@pytest.mark.parametrize("mode", ["unpacked", "packed"])
def test_two_ranks_step_alike_and_as_one(runs, mode):
    r0, r1 = (r[mode] for r in runs["w"][2])
    one = runs["w"][1][0][mode]
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-4)
    _states_close(r0["state"], one["state"], f"{mode} world 2 vs 1")


def test_fold_parallel_over_two_data_ranks_steps_as_one(runs):
    """Two folds stacked, each fold's batch split over two data ranks
    (BatchNorm statistics through the all-reduce's vmap rule), against
    one rank: per-fold losses and grad norms, the weights, an eval batch
    gathered from both ranks."""
    r0, r1 = (r["fold_parallel"] for r in runs["w"][2])
    one = runs["w"][1][0]["fold_parallel"]
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    np.testing.assert_array_equal(r0["probs"], r1["probs"])
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(r0["probs"], one["probs"], atol=TOL)
    bound = 2 * 3.17 * LR * STEPS
    for name, w in one["state"].items():
        assert torch.equal(r0["state"][name], r1["state"][name]), name
        assert (r0["state"][name] - w).abs().max() <= bound, name


def test_two_ranks_match_the_jax_step_on_the_global_batch(runs):
    losses, norms, want = _jax_unpacked(runs["params"], runs["stats"],
                                        runs["data"])
    got = runs["w"][2][0]["unpacked"]
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-4, atol=TOL)
    _states_close(got["state"], want, "world 2 vs JAX")


@pytest.mark.parametrize("layout", ["folds", "folds_dp"])
def test_fold_shards_train_each_fold_and_rank0_writes(runs, tmp_path,
                                                      monkeypatch, layout):
    """``--fold-shards 2`` (each rank a fold) and ``--fold-parallel`` over
    two data ranks through the command line."""
    assert [line["result"] for line in runs["folds"]] == [[0, 0], [0, 0]]
    out, ck = runs["work"] / layout / "out", runs["work"] / layout / "ck"
    names = sorted(os.listdir(out))
    for k in (0, 1):
        assert f"task2C_kevinmathew_probs_fold_{k}.tsv" in names
        assert f"task2C_train_metrics_fold_{k}.json" in names
        assert (ck / f"fold_{k}" / "model.pt").exists()
    assert "task2C_kevinmathew.tsv" in names
    # Fold 1's checkpoint (written by rank 1 under --fold-shards 2) gives
    # the TSV that rank 0 wrote from the gathered results.
    monkeypatch.chdir(tmp_path)
    assert main(["predict", "--subtask", "2c", "--manifest",
                 str(runs["work"] / "dev.json"), "--checkpoint",
                 str(ck / "fold_1"), "--out", "p.tsv", "--probs-out",
                 "pp.tsv", "--device", "cpu"]) == 0
    want = [line.split("\t") for line in open(
        out / "task2C_kevinmathew_probs_fold_1.tsv")][1:]
    got = [line.split("\t") for line in open("pp.tsv")][1:]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [float(r[2]) for r in want], atol=1e-5)


def _fold_metrics(run, k):
    with open(run / "out" / f"task2C_train_metrics_fold_{k}.json") as f:
        m = json.load(f)
    losses = [s["loss"] for s in m["steps"]]
    evals = [[v for _, v in sorted(e.items()) if isinstance(v, float)]
             for e in m["evals"]]
    return losses, evals


def _fold_probs(run, k):
    with open(run / "out" / f"task2C_kevinmathew_probs_fold_{k}.tsv") as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return [r[0] for r in rows], np.array([float(r[2]) for r in rows])


@pytest.mark.parametrize("layout", ["folds", "folds_dp"])
def test_fold_layouts_train_each_fold_as_one_device(runs, layout):
    """A layout places the folds' work and changes none of it: with
    dropout and augmentation on, each fold's step losses, evals, best
    probabilities and weights under ``--fold-shards 2`` (fold 1 on rank
    1) and over two data ranks are those of all folds on one device.
    f32: losses and evals within 1e-5 relative, probabilities 1e-5,
    weights within Adam's bound, as the step tests above hold them."""
    one, got = runs["work"] / "folds_one", runs["work"] / layout
    for k in (0, 1):
        want_l, want_e = _fold_metrics(one, k)
        got_l, got_e = _fold_metrics(got, k)
        np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_e, want_e, rtol=TOL, atol=TOL)
        want_ids, want_p = _fold_probs(one, k)
        got_ids, got_p = _fold_probs(got, k)
        assert got_ids == want_ids
        np.testing.assert_allclose(got_p, want_p, atol=TOL)
        want_w = torch.load(one / "ck" / f"fold_{k}" / "model.pt")
        got_w = torch.load(got / "ck" / f"fold_{k}" / "model.pt")
        assert set(got_w) == set(want_w)
        for name, w in want_w.items():
            d = (got_w[name].float() - w.float()).abs().max()
            assert d <= 2 * 3.17 * CLI_LR * len(want_l), (k, name, float(d))


def test_launch_names_the_rank_that_died():
    with pytest.raises(RuntimeError) as err:
        launch_processes(2, target="torch_dist_cases:crash",
                         kwargs={"rank": 1}, env={"PYTHONPATH": TESTS},
                         timeout=120, device="cpu")
    msg = str(err.value)
    assert "rank 1 exited with -9 (SIGKILL)" in msg
    assert "ranks [0] of 2 still running when a rank failed: killed" in msg


def test_worker_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """Like every entry point of the port, the worker, its launcher and
    its step default to CUDA and raise without it, starting no rank."""
    for fn in (dist_worker.launch_processes, dist_worker.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        launch_processes(1, timeout=60)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        dist_worker.main([])


def test_dist_worker_default_step_matches_one_process():
    """The worker's own DP step (the tiny 2C model on each rank's rows of
    a fixed global batch, its last one half valid) at world 2 and 1, as
    the JAX package's ``dist_worker`` test holds its step."""
    one_thread = {"OMP_NUM_THREADS": "1"}
    two = launch_processes(2, device="cpu", env=one_thread, timeout=120)
    one = launch_processes(1, device="cpu", env=one_thread, timeout=120)
    assert two[0]["result"] == two[1]["result"]
    np.testing.assert_allclose(two[0]["result"]["losses"],
                               one[0]["result"]["losses"], rtol=TOL)
    np.testing.assert_allclose(two[0]["result"]["grad_norms"],
                               one[0]["result"]["grad_norms"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["result"]["running_mean"],
                               one[0]["result"]["running_mean"], atol=5e-4)
    assert two[0]["collectives"]["all_reduce"] > 0
