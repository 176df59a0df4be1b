"""K steps a dispatch for the corpus MLM and SimCLR stages
(mpmc_tpu_torch.train.pretrain, pretrain_image) on the CPU: the device-side
AdamW tables against the host schedule and bias corrections, K grouped
AdamW steps against ``optax.adamw``, SimCLR's groups of rows against the
JAX loop's scan arguments, both stages at ``scan_steps = K`` equal to
``scan_steps = 1`` bit for bit, and both stages' steps under PyTorch's
deterministic algorithms.  On the CPU a group is K eager calls of the
same step (``train/graphs.GroupedSteps``); the graphs themselves run on
the card (``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.config import ImageEncoderConfig as JImageEncoderConfig
from mpmc_tpu.train.pretrain_image import SimCLRConfig as JSimCLRConfig
from mpmc_tpu.train.pretrain_image import simclr_pretrain as j_simclr_pretrain
from mpmc_tpu_torch.cli.experiments import corpus_wordpiece_vocab
from mpmc_tpu_torch.config import ImageEncoderConfig, TextEncoderConfig
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
from mpmc_tpu_torch.train import graphs
from mpmc_tpu_torch.train import pretrain_image as P
from mpmc_tpu_torch.train.pretrain import (AdamW, MLMConfig, MLMTrainer,
                                           adam_bias_corrections,
                                           mlm_pretrain,
                                           warmup_cosine_decay_schedule)

CPU = torch.device("cpu")
TINY = dict(arch="tiny_resnet", image_size=16, feature_dim=32,
            finetune_dim=32)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 1, 20),
                                               (1e-3, 7, 140)])
def test_adamw_tables_equal_the_host_schedule(peak, warmup, total):
    """Every step's lr, ``1 - b1^t`` and ``1 - b2^t`` in the device tables
    equal the host functions' f32 values; the tables grow to twice their
    length on demand and the step reads them at the device count."""
    sched = warmup_cosine_decay_schedule(peak, warmup, total)
    params = {"w": torch.zeros(3)}
    opt = AdamW(params, sched, 0.01, total_steps=total)
    t = {k: v.numpy() for k, v in opt.tables.items()}
    assert all(len(v) == total for v in t.values())
    want = np.array([sched(c) for c in range(total)], np.float32)
    np.testing.assert_array_equal(t["lr"], want)
    bc = np.array([adam_bias_corrections(c) for c in range(total)],
                  np.float32)
    np.testing.assert_array_equal(t["bc1"], bc[:, 0])
    np.testing.assert_array_equal(t["bc2"], bc[:, 1])
    opt.ensure_steps(total + 1)
    assert len(opt.tables["lr"]) == 2 * total
    np.testing.assert_array_equal(opt.tables["lr"][:total].numpy(), want)
    for c in range(3):
        opt.step([torch.ones(3)])
        assert opt.count == int(opt.count_t) == c + 1
        assert float(opt._at("lr")) == sched(c + 1)


def test_grouped_adamw_steps_match_optax():
    """K = 4 steps a group through ``GroupedSteps`` (the optimizer as its
    counter), two groups, against ``clip_by_global_norm(1)`` and
    ``optax.adamw`` under the warmup-cosine schedule: every parameter
    within 1e-6 after each group, the norms within 1e-6 relative."""
    k, total, peak = 4, 8, 1e-2
    shapes = {"a": (30, 16), "b": (16,), "c": (3, 5, 7)}
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, peak, 2, total),
        weight_decay=0.01))
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(jparams)
    params = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    opt = AdamW(params, warmup_cosine_decay_schedule(peak, 2, total), 0.01,
                total_steps=total)

    def step(batch):
        return {"norm": opt.step([batch[n] for n in params])}

    grouped = graphs.GroupedSteps(step, k, CPU, counter=opt)
    for g in range(total // k):
        grads = {n: (rng.standard_normal((k,) + s) * (0.3 if g else 0.01)
                     ).astype(np.float32) for n, s in shapes.items()}
        norms = grouped({n: torch.from_numpy(v) for n, v in grads.items()})
        for j in range(k):
            gj = {n: jnp.asarray(v[j]) for n, v in grads.items()}
            np.testing.assert_allclose(float(norms["norm"][j]),
                                       float(optax.global_norm(gj)),
                                       rtol=1e-6)
            updates, state = tx.update(gj, state, jparams)
            jparams = optax.apply_updates(jparams, updates)
        for n in params:
            np.testing.assert_allclose(params[n].numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=f"group {g} {n}")
    assert opt.count == int(opt.count_t) == total


def _spy_groups(monkeypatch):
    """The groups every ``GroupedSteps`` of the process is called with."""
    seen = []
    call = graphs.GroupedSteps.__call__

    def spy(self, group):
        seen.append({n: v.clone() for n, v in group.items()})
        return call(self, group)

    monkeypatch.setattr(graphs.GroupedSteps, "__call__", spy)
    return seen


@pytest.mark.parametrize("n,bs,epochs", [(20, 4, 2), (12, 4, 2)])
def test_simclr_group_rows_match_jax_scan(monkeypatch, n, bs, epochs):
    """The rows ``[K, bs]`` of every group the JAX loop dispatched (read
    from its jitted scan's arguments) equal the groups the port's
    ``simclr_pretrain`` hands to ``GroupedSteps`` (K = 4 of 5 steps an
    epoch; K = 3 when an epoch has 3)."""
    rng = np.random.default_rng(n)
    images = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    jax_rows = []
    real_jit = jax.jit

    def spy_jit(fn, *args, **kw):
        jitted = real_jit(fn, *args, **kw)
        if getattr(fn, "__name__", "") != "scan_step":
            return jitted

        def run(*a):
            jax_rows.append(np.asarray(a[4]))
            return jitted(*a)
        return run

    monkeypatch.setattr(jax, "jit", spy_jit)
    j_simclr_pretrain(JImageEncoderConfig(**TINY), images,
                      JSimCLRConfig(epochs=epochs, batch_size=bs,
                                    proj_dim=8, seed=5))
    monkeypatch.setattr(jax, "jit", real_jit)
    seen = _spy_groups(monkeypatch)
    run = P.simclr_pretrain(ImageEncoderConfig(**TINY), images,
                            P.SimCLRConfig(epochs=epochs, batch_size=bs,
                                           proj_dim=8, seed=5), device=CPU)
    k = min(4, n // bs)
    assert len(jax_rows) == len(seen) == epochs * ((n // bs) // k)
    for want, got in zip(jax_rows, seen):
        assert want.shape == (k, bs)
        np.testing.assert_array_equal(got["rows"].numpy(), want)
    assert run.steps == epochs * k and np.isfinite(run.epoch_losses).all()


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    return [" ".join("".join(rng.choice(letters, int(rng.integers(1, 7))))
                     for _ in range(int(rng.integers(2, 12))))
            for _ in range(n)]


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_mlm_groups_equal_single_steps(monkeypatch, pack):
    """``mlm_pretrain`` at ``scan_steps = 4`` against 1 over an epoch of 8
    steps (two groups, so the same steps run): the same epoch losses and
    encoder weights bit for bit, dropout on; the groups are ``[4, bs,
    L]``."""
    texts = _texts(9, 40 if pack else 32)
    tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    ids, mask = tok.encode_batch(texts, 16)
    cfg = TextEncoderConfig.tiny(max(tok.vocab.values()) + 1)
    if pack:
        from mpmc_tpu_torch.ops.packing import pack_sequences
        rows = pack_sequences(ids, mask, 16).num_rows
        bs = rows // 8
    else:
        bs = 4
    seen = _spy_groups(monkeypatch)
    runs = {k: mlm_pretrain(cfg, ids, mask, tok,
                            MLMConfig(epochs=2, batch_size=bs, scan_steps=k,
                                      pack=pack), CPU) for k in (4, 1)}
    assert len(seen) == 4 and all(
        tuple(g["ids"].shape) == (4, bs, 16) for g in seen)
    assert set(seen[0]) == ({"ids", "mask", "segments", "positions"}
                            if pack else {"ids", "mask"})
    assert runs[4].steps == runs[1].steps == 16
    assert runs[4].step_losses == runs[1].step_losses
    assert runs[4].epoch_losses == runs[1].epoch_losses
    assert runs[4].epoch_losses[0] == np.mean(
        np.asarray(runs[4].step_losses[:8], np.float32))
    assert np.isfinite(runs[4].epoch_losses).all()
    a, b = (runs[k].encoder.state_dict() for k in (4, 1))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_simclr_groups_equal_single_steps(monkeypatch):
    """``simclr_pretrain`` at ``scan_steps = 4`` against 1 (two epochs of
    4 steps): the same losses, backbone and BatchNorm statistics bit for
    bit, the statistics moved by the steps."""
    images = np.random.default_rng(4).integers(0, 256, (16, 16, 16, 3),
                                               dtype=np.uint8)
    cfg = P.SimCLRConfig(epochs=2, batch_size=4, proj_dim=8, seed=3)
    seen = _spy_groups(monkeypatch)
    runs = {k: P.simclr_pretrain(ImageEncoderConfig(**TINY), images,
                                 dataclasses.replace(cfg, scan_steps=k),
                                 device=CPU) for k in (4, 1)}
    assert len(seen) == 2 and tuple(seen[0]["rows"].shape) == (4, 4)
    assert runs[4].step_losses == runs[1].step_losses
    assert runs[4].epoch_losses == runs[1].epoch_losses
    a, b = (runs[k].backbone.state_dict() for k in (4, 1))
    moved = [n for n in a if "running_mean" in n
             and a[n].abs().max() > 0]
    assert moved
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _determinism():
    from torch.utils import deterministic
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            deterministic.fill_uninitialized_memory)


@pytest.mark.parametrize("stage", ["mlm", "simclr"])
def test_stage_steps_run_under_deterministic_algorithms(monkeypatch, stage):
    """Every step of either stage runs under PyTorch's deterministic
    algorithms (warnings only, new memory unfilled), which make K steps in
    a graph equal K single steps on the card; the caller's settings come
    back after the stage."""
    cls = MLMTrainer if stage == "mlm" else P.SimCLRTrainer
    real, seen = cls.step, []

    def spy(self, *args, **kwargs):
        seen.append(_determinism())
        return real(self, *args, **kwargs)

    monkeypatch.setattr(cls, "step", spy)
    before = _determinism()
    if stage == "mlm":
        texts = _texts(9, 32)
        tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
        ids, mask = tok.encode_batch(texts, 16)
        mlm_pretrain(TextEncoderConfig.tiny(max(tok.vocab.values()) + 1),
                     ids, mask, tok,
                     MLMConfig(epochs=1, batch_size=4, scan_steps=2), CPU)
    else:
        images = np.random.default_rng(5).integers(0, 256, (8, 16, 16, 3),
                                                   dtype=np.uint8)
        P.simclr_pretrain(ImageEncoderConfig(**TINY), images,
                          P.SimCLRConfig(epochs=1, batch_size=4, proj_dim=8,
                                         scan_steps=2), device=CPU)
    assert len(seen) >= 2 and set(seen) == {(True, True, False)}
    assert _determinism() == before
