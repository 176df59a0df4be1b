"""K steps a dispatch in the port (``--scan-steps``): the group plan
against the JAX package's, ``fit`` at K = 4 against K = 1 (bit for bit on
the CPU) and against the JAX ``fit`` at K = 4, the device-count optimizer
against the host-float arithmetic it replaced, a non-finite loss inside a
group, grouped ``run_eval``, crash and ``--resume`` at K = 4, and the
recipe's ``--scan-steps``.  On the CPU a group is K eager calls of the
same step; the CUDA graphs themselves run on the card (``chip_smoke.py``
phase 14)."""

import argparse
import dataclasses
import glob
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.cli.main import _resolve_recipe as j_resolve_recipe
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.train.loop import _scan_group_plan as j_plan
from mpmc_tpu.train.loop import fit as j_fit
from mpmc_tpu.train.step import (create_train_state, make_eval_step as
                                 j_make_eval_step, make_optimizer,
                                 make_scan_eval_step as j_scan_eval,
                                 make_scan_train_step as j_scan_train,
                                 make_train_step as j_make_train_step)
from mpmc_tpu_torch.cli.main import _resolve_recipe, build_parser, main
from mpmc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.train.checkpoint import Checkpointer
from mpmc_tpu_torch.train import graphs
from mpmc_tpu_torch.train.graphs import (GroupedSteps, make_scan_eval_step,
                                         make_scan_train_step)
from mpmc_tpu_torch.train.loop import (DeviceData, _scan_group_plan, fit,
                                       run_eval)
from mpmc_tpu_torch.train.step import (Optimizer, _factored_dims,
                                       build_train_step, make_eval_step)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread.  On a loaded machine
    (the suite's parallel workers) a pool of threads per process turns each
    small op into a wait at the pool's barrier, many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


# ---------------------------------------------------------------------------
# The group plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eval_on", [True, False], ids=["eval", "no-eval"])
def test_scan_group_plan_matches_jax(eval_on):
    for steps in (1, 3, 7, 8, 9, 16, 25):
        for interval in range(1, steps + 1):
            for k in (1, 2, 3, 4, 8):
                got = _scan_group_plan(steps, interval, k, eval_on)
                assert got == j_plan(steps, interval, k, eval_on), (
                    steps, interval, k)
                assert sum(got) == steps and max(got) <= k


# ---------------------------------------------------------------------------
# fit at K = 4 and K = 1 through the command line
# ---------------------------------------------------------------------------

def _rows(n, off, rng):
    """Memes whose label a pair of words gives away, so the F1 moves."""
    out = []
    for k in range(n):
        y = k % 2
        stem = "بتث جحخ" if y else "سشص ضطظ"
        noise = " ".join("".join(rng.choice(LETTERS, 3)) for _ in range(4))
        out.append({"id": f"d/x{off + k}.jpg", "img_path": f"d/x{off + k}.jpg",
                    "text": f"{stem} {noise}",
                    "class_label": "propaganda" if y else "not_propaganda"})
    return out


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """64 train memes (2 folds: 32 train rows of fold 0, 8 steps of 4, an
    eval every 4: groups of 4 at K = 4) and 12 dev memes."""
    root = tmp_path_factory.mktemp("scan")
    rng = np.random.default_rng(7)
    for name, n, off in (("tr.json", 64, 0), ("dv.json", 12, 100)):
        with open(root / name, "w", encoding="utf-8") as f:
            json.dump(_rows(n, off, rng), f, ensure_ascii=False)
    return root


def _args(root, out, ckpt, k, epochs=2, resume=False):
    a = ["train", "--subtask", "2c", "--tiny", "--epochs", str(epochs),
         "--num-folds", "2", "--fold", "0", "--batch-size", "4",
         "--lr", "1e-3", "-tr", str(root / "tr.json"),
         "-te", str(root / "dv.json"), "-o", str(out),
         "--checkpoint-dir", str(ckpt), "--cache-dir", str(ckpt / "cache"),
         "--device", "cpu", "--scan-steps", str(k)]
    return a + ["--resume"] if resume else a


def _tsvs(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.tsv"))}


def test_fit_k4_equals_k1_bit_for_bit(tmp_path, monkeypatch, manifests):
    """The fast recipe's packed 2C with dropout and augmentation draws:
    every step's loss and grad norm, the evals, the TSVs and the weights
    and optimizer state of each checkpoint equal at K = 4 and K = 1, and
    K = 4 ran whole groups through the grouped step."""
    monkeypatch.chdir(tmp_path)
    groups = []
    real_call = GroupedSteps.__call__

    def counting(self, group):
        groups.append(self.k)
        return real_call(self, group)

    monkeypatch.setattr(GroupedSteps, "__call__", counting)
    for k in (1, 4):
        assert main(_args(manifests, tmp_path / f"o{k}", tmp_path / f"c{k}",
                          k)) == 0
    metrics = [json.loads((tmp_path / f"o{k}" /
                           "task2C_train_metrics_fold_0.json").read_text())
               for k in (1, 4)]
    assert metrics[0]["steps_per_epoch"] == 8
    assert metrics[0]["steps"] == metrics[1]["steps"]
    assert metrics[0]["evals"] == metrics[1]["evals"]
    # 2 epochs x 8 steps: 4 groups of 4, the train and the eval steps.
    assert groups.count(4) >= 4
    assert _tsvs(tmp_path / "o1") == _tsvs(tmp_path / "o4")
    steps = [sorted(os.listdir(tmp_path / f"c{k}" / "fold_0")) for k in (1, 4)]
    assert steps[0] == steps[1]
    for name in steps[0]:
        if not name.isdigit():
            continue
        a, b = (torch.load(tmp_path / f"c{k}" / "fold_0" / name / "state.pt",
                           weights_only=True) for k in (1, 4))
        for key, v in a["model"].items():
            assert torch.equal(v, b["model"][key]), key
        assert a["optimizer"]["count"] == b["optimizer"]["count"]
        for n, slots in a["optimizer"]["state"].items():
            for s, v in slots.items():
                assert torch.equal(v, b["optimizer"]["state"][n][s]), (n, s)
        assert torch.equal(a["generator"], b["generator"])


def test_crash_resume_at_k4(tmp_path, monkeypatch, manifests):
    """Killed right after its first checkpoint (inside epoch 0) and
    ``--resume``d at K = 4: the TSVs equal the uninterrupted K = 4 run's
    byte for byte; the resumed run skips whole groups."""
    monkeypatch.chdir(tmp_path)
    assert main(_args(manifests, tmp_path / "outA", tmp_path / "ckA",
                      4)) == 0
    real_save, calls = Checkpointer.save, []

    def crashing_save(self, state, step, metrics=None):
        real_save(self, state, step, metrics)
        self.wait()
        calls.append(step)
        raise KeyboardInterrupt("injected crash after first checkpoint")

    monkeypatch.setattr(Checkpointer, "save", crashing_save)
    with pytest.raises(KeyboardInterrupt):
        main(_args(manifests, tmp_path / "outB", tmp_path / "ckB", 4))
    assert calls == [4]                 # the first eval: one group in
    monkeypatch.setattr(Checkpointer, "save", real_save)
    assert main(_args(manifests, tmp_path / "outB", tmp_path / "ckB", 4,
                      resume=True)) == 0
    assert _tsvs(tmp_path / "outA") == _tsvs(tmp_path / "outB")
    resumed = json.loads((tmp_path / "outB" /
                          "task2C_train_metrics_fold_0.json").read_text())
    assert len(resumed["steps"]) == 16 - 4


# ---------------------------------------------------------------------------
# Port fit at K = 4 against the JAX fit at K = 4
# ---------------------------------------------------------------------------

TOL = 1e-5          # f32 on both sides; sums in different orders


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


def test_fit_k4_matches_jax_fit_k4(tmp_path):
    """tiny 2C, unpacked, f32, dropout 0, the same augmentation draws at
    every step on both sides, weights bridged from the flax init: 8 steps
    in two groups of 4 and 4 eval batches in one group.  The history
    ``(epoch, batch)`` pairs equal the JAX loop's; every step's loss
    within 1e-5, each eval's loss within 1e-3 relative and the weights
    within Adam's bound."""
    mcfg = _zero_dropout(ModelConfig.tiny_2c())
    jmcfg = _zero_dropout(JModelConfig.tiny_2c())
    B, K, lr = 4, 4, 1e-4
    train, test = _mm_data(1, 32, mcfg), _mm_data(2, 16, mcfg)
    kw = dict(learning_rate=lr, lr_schedule="constant", bf16=False,
              epochs=1, scan_steps=K)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B), **kw)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B,
                                                      device_resident=False),
                        **kw)
    rng = np.random.default_rng(5)
    flip = rng.random(B) < 0.5
    bright = rng.uniform(0.9, 1.1, B).astype(np.float32)
    angle = (rng.uniform(-15, 15, B) * math.pi / 180).astype(np.float32)

    jmodel = JClassifier(jmcfg)
    variables = jmodel.init(jax.random.key(3, impl="threefry2x32"),
                            train["text_ids"][:2], train["text_mask"][:2],
                            train["image"][:2].astype(np.float32) / 255.0,
                            train["caption_ids"][:2],
                            train["caption_mask"][:2])
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    base = make_apply_fn(jmodel, "multimodal", augment_images=False)

    def apply_fn(variables, batch, train, rngs, mutable):
        img = j_rotate_shear(j_fused(batch["image"], jnp.asarray(flip),
                                     jnp.asarray(bright), interpret=True),
                             jnp.asarray(angle), 15.0)
        return base(variables, dict(batch, image=img), train, rngs, mutable)

    tx = make_optimizer(jcfg, 8)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params), "batch_stats": stats}, tx)
    eval_apply = make_apply_fn(jmodel, "multimodal", augment_images=True)
    j_losses, j_scan = [], j_scan_train(apply_fn, jcfg, tx)

    def j_scan_recording(state, batch, key):
        state, m = j_scan(state, batch, key)
        j_losses.extend(np.asarray(m["loss"]).tolist())
        return state, m

    jres = j_fit(state, j_make_train_step(apply_fn, jcfg, tx),
                 j_make_eval_step(eval_apply, jcfg), jcfg, train,
                 test_data=test, scan_train_step=j_scan_recording,
                 scan_eval_step=j_scan_eval(eval_apply, jcfg))

    model = build_model(mcfg, CPU)
    model.load_state_dict(from_jax_variables(params, stats))
    store = {k: torch.from_numpy(v) for k, v in train.items()}
    draws = [torch.from_numpy(x) for x in (flip, bright, angle)]
    step = build_train_step(model, cfg, 8, store, torch.Generator(),
                            augment=lambda u8, gen: augment_with_draws(
                                u8, *draws))
    evals = make_eval_step(model, cfg, cast_in_place=False)
    scan_train, scan_eval = (make_scan_train_step(step, K),
                             make_scan_eval_step(evals, K, CPU))
    seen = []
    real_train, real_eval = scan_train.step, scan_eval.step
    scan_train.step = lambda b: (seen.append("train"), real_train(b))[1]
    scan_eval.step = lambda b: (seen.append("eval"), real_eval(b))[1]
    res = fit(step, evals, cfg, train, CPU, test_data=test,
              scan_train_step=scan_train, scan_eval_step=scan_eval)

    assert [(h["epoch"], h["batch"]) for h in res.history] == [
        (h["epoch"], h["batch"]) for h in jres.history] == [(0, 4), (0, 8)]
    assert seen.count("train") == 8 and seen.count("eval") == 8
    # Every step's loss, inside both groups, at the train-step parity
    # tests' tolerance.
    np.testing.assert_allclose([m["loss"] for m in res.steps], j_losses,
                               atol=TOL, rtol=TOL)
    # The evals normalize by BatchNorm running statistics made from batch
    # statistics over 4 rows, whose small variances amplify f32 rounding
    # (PERF.md section 7): 1e-3 relative.
    for h, jh in zip(res.history, jres.history):
        np.testing.assert_allclose(h["test_loss"], jh["test_loss"],
                                   rtol=1e-3, atol=0)
    got = model.state_dict()
    ref = from_jax_variables(_np(jres.state.params),
                             _np(jres.state.batch_stats))
    bound = 2 * 3.17 * lr * 8
    for name, w in ref.items():
        d = (got[name] - w).abs().max().item()
        assert d <= bound, (name, d)


# ---------------------------------------------------------------------------
# The device-count optimizer against the host-float one it replaced
# ---------------------------------------------------------------------------

class _HostFloatOptimizer:
    """The optimizer as it was: Python floats from the host step count,
    the clip decided by reading the norm, the second moments rebound."""

    def __init__(self, cfg, total, params, support):
        self.new = Optimizer(cfg, total, params, embed_support=support)
        self.params, self.count = params, 0

    def adam(self, g, states, c):
        b1, b2 = 0.9, 0.999
        t = np.float32(c + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        out = []
        for g_, st in zip(g, states):
            decayed = st["mu"] * torch.tensor(b1, dtype=st["mu"].dtype)
            mu = g_ * (1 - b1) + decayed.float()
            nu = g_ * g_ * (1 - b2) + st["nu"] * b2
            out.append((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8))
            st["mu"] = mu.to(st["mu"].dtype)
            st["nu"] = nu
        return out

    def step(self, grads):
        o = self.new
        c = self.count
        names = list(self.params)
        g = [grads[n] for n in names]
        norm = Optimizer.global_norm(g)
        if float(norm) >= o.clip:
            g = [x / norm * o.clip for x in g]
        g = dict(zip(names, g))
        for label, sched in o.schedules.items():
            group = [n for n in names if o.label[n] == label]
            for n in group:
                p, st = self.params[n], self.state[n]
                if label == "embed" and o.support_rows:
                    k = min(o.support_rows, p.shape[0])
                    vals, idx = torch.topk(g[n].abs().sum(1), k)
                    valid = (vals > 0)[:, None]
                    rows = {"mu": st["mu"][idx].clone(),
                            "nu": st["nu"][idx].clone()}
                    u = self.adam([g[n][idx]], [rows], c)[0] * -sched(c)
                    st["mu"][idx] = torch.where(valid, rows["mu"],
                                                st["mu"][idx])
                    st["nu"][idx] = torch.where(valid, rows["nu"],
                                                st["nu"][idx])
                    p[idx] = torch.where(valid, p[idx] + u, p[idx])
                    continue
                if label == "embed":
                    decay = np.float32(1) - np.float32(c + 1) ** np.float32(
                        -0.8)
                    keep, new = float(decay), float(np.float32(1) - decay)
                    sq = g[n] * g[n] + 1e-30
                    dims = _factored_dims(p.shape)
                    if dims is None:
                        st["v"] = keep * st["v"] + new * sq
                        u = g[n] * st["v"] ** -0.5
                    else:
                        d1, d0 = dims
                        st["v_row"] = keep * st["v_row"] + new * sq.mean(d0)
                        st["v_col"] = keep * st["v_col"] + new * sq.mean(d1)
                        r = d1 - 1 if d1 > d0 else d1
                        rf = (st["v_row"] / st["v_row"].mean(
                            r, keepdim=True)) ** -0.5
                        u = (g[n] * rf.unsqueeze(d0)
                             * (st["v_col"] ** -0.5).unsqueeze(d1))
                else:
                    u = self.adam([g[n]], [st], c)[0]
                p.add_(u * -sched(c))
        self.count += 1


@pytest.mark.parametrize("mode", ["adam", "factored", "sparse"])
def test_device_count_optimizer_equals_host_floats(mode):
    """10 steps under a warmup schedule, the norm above the clip on some
    steps and below on others: parameters and every state slot bit-equal."""
    rng = np.random.default_rng(11)
    shapes = {"text_model.word_embeddings.weight": (200, 8),
              "caption_text_model.word_embeddings.weight": (130, 140),
              "text_model.layer.weight": (6, 5), "output.bias": (3,)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    cfg = TrainConfig(learning_rate=1e-2, lr_schedule="linear_warmup",
                      embedding_optimizer=mode,
                      adam_mu_dtype="bfloat16" if mode == "factored"
                      else None)
    new_p = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    old_p = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    new = Optimizer(cfg, 10, new_p, embed_support=24)
    old = _HostFloatOptimizer(cfg, 10, old_p, 24)
    old.state = {n: {k: v.clone() for k, v in st.items()}
                 for n, st in new.state.items()}
    for step in range(10):
        scale = 0.5 if step % 3 == 0 else 0.01
        grads = {}
        for n, s in shapes.items():
            g = rng.standard_normal(s).astype(np.float32) * scale
            if "word_embeddings" in n:
                g[rng.random(s[0]) < 0.8] = 0      # untouched rows
            grads[n] = torch.from_numpy(g)
        new.step(grads, Optimizer.global_norm(list(grads.values())))
        old.step(grads)
    assert new.count == old.count == int(new.count_t) == 10
    for n in shapes:
        assert torch.equal(new_p[n], old_p[n]), n
        for k, v in old.state[n].items():
            assert torch.equal(new.state[n][k], v), (n, k)


# ---------------------------------------------------------------------------
# The loop around the groups
# ---------------------------------------------------------------------------

class _Step:
    """A stand-in train step of the port's interface: a loss of 0.5, and
    NaN on call ``bad_at`` (1-based)."""

    def __init__(self, bad_at=None):
        self.optimizer = types.SimpleNamespace(count=0, device=CPU)
        self.generator = torch.Generator()
        self.bad_at, self.calls, self.batches = bad_at, 0, []

    def __call__(self, batch):
        self.calls += 1
        self.batches.append({k: v.clone() for k, v in batch.items()})
        bad = self.calls == self.bad_at
        return {"loss": torch.tensor(float("nan") if bad else 0.5),
                "grad_norm": torch.tensor(2.0 if bad else 1.0)}


def _eval_step(batch):
    p = torch.sigmoid(2.0 * batch["x"])
    return p, (p - batch["label"]).abs()


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.int32)
    x = ((y * 2.0 - 1.0) + rng.standard_normal(n) * 0.3).astype(np.float32)
    return {"x": x, "label": y}


def test_nonfinite_loss_inside_a_group_names_its_step(tmp_path,
                                                      monkeypatch):
    """12 steps of 4 rows, no eval: groups of 4; NaN on step 6 (the
    second group's second step) dumps that step's rows and names batch
    6."""
    monkeypatch.chdir(tmp_path)
    data = _data(48)
    rows = np.arange(200, 248)
    step = _Step(bad_at=6)
    with pytest.raises(FloatingPointError, match="batch 6 "):
        fit(step, _eval_step, TrainConfig(data=DataConfig(batch_size=4),
                                          epochs=1, scan_steps=4),
            data, CPU, train_rows=rows,
            scan_train_step=make_scan_train_step(step, 4))
    got = glob.glob("nonfinite_*.npz")
    assert got == ["nonfinite_fold0_epoch0_batch6.npz"]
    z = np.load(got[0])
    bad = step.batches[5]
    np.testing.assert_array_equal(z["idx"], bad["idx"].numpy())
    np.testing.assert_array_equal(z["valid"], bad["valid"].numpy())
    np.testing.assert_array_equal(z["x"], data["x"][z["idx"] - 200])
    assert float(z["grad_norm"]) == 2.0


def test_grouped_run_eval_equals_per_batch():
    """10 batches at K = 4: two groups and two single batches, the short
    last batch padded by wrap-around; every metric equal."""
    data = _data(37, seed=3)
    per = run_eval(_eval_step, data, 4, CPU)
    calls = []

    def counted(batch):
        calls.append(int(batch["x"].shape[0]))
        return _eval_step(batch)

    grouped = run_eval(counted, data, 4, CPU,
                       scan_eval_step=make_scan_eval_step(counted, 4, CPU))
    np.testing.assert_array_equal(grouped.probs, per.probs)
    assert (grouped.loss, grouped.accuracy, grouped.macro_f1,
            grouped.threshold) == (per.loss, per.accuracy, per.macro_f1,
                                   per.threshold)
    assert calls == [4] * 10


def test_grouped_steps_take_only_whole_groups():
    with pytest.raises(ValueError, match="K >= 2"):
        GroupedSteps(lambda b: b, 1, CPU)
    g = GroupedSteps(lambda b: {"y": b["x"] * 2}, 3, CPU)
    with pytest.raises(ValueError, match="leading dims"):
        g({"x": torch.zeros(2, 5)})
    out = g({"x": torch.arange(6.0).view(3, 2)})
    assert torch.equal(out["y"], torch.arange(6.0).view(3, 2) * 2)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("n,k,groups,singles", [
    (37, 2, 2, 1), (37, 4, 1, 1), (20, 4, 0, 3)])
def test_run_eval_sends_the_rest_through_single(monkeypatch, resident, n,
                                                k, groups, singles):
    """At batch 8 the batches outside a full group of K, a split of fewer
    than K batches included, go through ``single`` (the resident split's
    through its store's ``with_store``); the probabilities and metrics
    equal the per-batch pass."""
    data = _data(n, seed=4)
    calls = []
    real_call, real_single = GroupedSteps.__call__, GroupedSteps.single

    def grouped(self, group):
        calls.append(("group", self))
        return real_call(self, group)

    def single(self, batch):
        calls.append(("single", self))
        assert all(v.shape[0] == 8 for v in batch.values())
        return real_single(self, batch)

    monkeypatch.setattr(GroupedSteps, "__call__", grouped)
    monkeypatch.setattr(GroupedSteps, "single", single)
    scan = make_scan_eval_step(_eval_step, k, CPU)
    dev = None
    if resident:
        store = {key: torch.from_numpy(v) for key, v in data.items()}
        dev = DeviceData(store, np.arange(n))
    per = run_eval(_eval_step, data, 8, CPU)
    got = run_eval(_eval_step, data, 8, CPU, scan_eval_step=scan, dev=dev)
    np.testing.assert_array_equal(got.probs, per.probs)
    assert (got.loss, got.macro_f1, got.threshold) == (
        per.loss, per.macro_f1, per.threshold)
    assert [c for c, _ in calls] == ["group"] * groups + ["single"] * singles
    want = scan.with_store(dev.data) if resident else scan
    assert all(g is want for _, g in calls)


class _Graph:
    """``CapturedGraph`` on the CPU: replays run the captured function."""

    def __init__(self, fn, inputs, stream, pool=None, generators=(), *,
                 role):
        self.fn = fn

    def replay(self, values):
        return self.fn(values)


def test_replays_count_whole_groups_only(monkeypatch):
    """With graphs standing in on the CPU: the first group and the first
    single step of a shape warm and capture; ``replays`` counts the
    replays of whole groups, ``single_replays`` the others, and the
    counter advances by each replay's steps.  A single step after the
    optimizer's tables grew raises."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(graphs, "warm", lambda stream, fn, *a: fn(*a))
    monkeypatch.setattr(graphs, "CapturedGraph", _Graph)
    counter = types.SimpleNamespace(count=0, tables=object(),
                                    ensure_steps=lambda n: None)
    g = GroupedSteps(lambda b: {"y": b["x"].sum()}, 3, CPU, counter=counter)
    g.graphed = True
    group, one = {"x": torch.ones(3, 4)}, {"x": torch.ones(4)}
    for _ in range(3):
        assert g(group)["y"].shape == (3,)
    for _ in range(4):
        assert g.single(one)["y"].shape == ()
    assert g.single({"x": torch.ones(5)})["y"] == 5
    assert (g.replays, g.single_replays, g.captures) == (2, 3, 3)
    assert counter.count == 2 * 3 + 3
    counter.tables = object()
    with pytest.raises(RuntimeError, match="tables grew"):
        g.single(one)


def test_single_equals_the_step_bit_for_bit_on_the_cpu():
    """tiny 2C with dropout: three resident train steps through a group's
    ``single`` and three through the step itself, from the same weights
    and generator state, give the same losses, grad norms, weights,
    optimizer count and generator state; an eval batch likewise."""
    mcfg = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=4), bf16=False,
                      scan_steps=4)
    data = _mm_data(6, 12, mcfg)
    store = {key: torch.from_numpy(v) for key, v in data.items()}
    torch.manual_seed(0)
    models = [build_model(mcfg, CPU)]
    models.append(build_model(mcfg, CPU))
    models[1].load_state_dict(models[0].state_dict())
    steps = [build_train_step(m, cfg, 3, store,
                              torch.Generator().manual_seed(9))
             for m in models]
    scan = make_scan_train_step(steps[0], 4)
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = {"idx": torch.from_numpy(rng.choice(12, 4, replace=False)),
                 "valid": torch.ones(4)}
        a = scan.single(batch)
        b = steps[1]({key: v.to(CPU) for key, v in batch.items()})
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].shape == () and torch.equal(a[key], b[key]), key
    for key, v in models[0].state_dict().items():
        assert torch.equal(v, models[1].state_dict()[key]), key
    assert steps[0].optimizer.count == steps[1].optimizer.count == 3
    assert torch.equal(steps[0].generator.get_state(),
                       steps[1].generator.get_state())
    evals = make_eval_step(models[0], cfg, cast_in_place=False)
    batch = {key: torch.from_numpy(v[:4]) for key, v in data.items()}
    one = make_scan_eval_step(evals, 4, CPU).single(batch)
    probs, loss = evals(batch)
    assert torch.equal(one["probs"], probs) and torch.equal(one["loss"], loss)


# ---------------------------------------------------------------------------
# The recipe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe,flag,want", [
    ("fast", None, 8), ("reference", None, 1), ("fast", 2, 2),
    ("reference", 4, 4)])
def test_recipe_resolves_scan_steps_as_jax(recipe, flag, want):
    argv = ["train", "--subtask", "2c", "-tr", "a", "-te", "b",
            "--recipe", recipe]
    if flag is not None:
        argv += ["--scan-steps", str(flag)]
    args = build_parser().parse_args(argv)
    _resolve_recipe(args)
    jargs = argparse.Namespace(
        recipe=recipe, scan_steps=flag, embedding_optimizer=None,
        adam_mu_dtype=None, pack_rows=None, fold_parallel=False,
        fold_shards=1, pipeline_stages=1, seq_shards=1, model_shards=1,
        subtask="2c", simple=False)
    j_resolve_recipe(jargs)
    assert args.scan_steps == jargs.scan_steps == want
    assert args.pack_rows == jargs.pack_rows
    fp = build_parser().parse_args(argv + ["--fold-parallel"])
    _resolve_recipe(fp)
    jargs.fold_parallel, jargs.pack_rows = True, None
    j_resolve_recipe(jargs)
    assert fp.pack_rows == jargs.pack_rows == 0
    pr = build_parser().parse_args(["predict", "--subtask", "2c",
                                    "--manifest", "m", "--out", "o"])
    assert pr.scan_steps == 1
