"""Exact-state resume in the port (mpmc_tpu_torch/train/checkpoint.py,
``TrainStep.state_dict``, ``fit``'s resume, ``train --resume``): a run
killed right after its first checkpoint, inside epoch 0, and resumed gives
the final TSVs of an uninterrupted run byte for byte (2A, and packed 2C
with augmentation and dropout draws); the optimizer state and the
generator round-trip bit for bit; best-k retention and the metrics sidecar
follow the JAX package's orbax ``Checkpointer``; ``predict --checkpoint``
still reads ``model.pt``."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.train.checkpoint import Checkpointer as JCheckpointer
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig)
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.train.checkpoint import Checkpointer
from mpmc_tpu_torch.train.step import build_train_step

LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")


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
    root = tmp_path_factory.mktemp("resume")
    rng = np.random.default_rng(7)
    for name, n, off in (("tr.json", 48, 0), ("dv.json", 16, 100)):
        with open(root / name, "w", encoding="utf-8") as f:
            json.dump(_rows(n, off, rng), f, ensure_ascii=False)
    return root


# (subtask, flags, epochs): the fast recipe packs both (2A: 4 rows a step;
# 2C: each batch's text and caption tokens, images augmented on the way).
RUNS = [("2a", [], 3), ("2c", [], 2)]


def _args(root, subtask, epochs, out, ckpt, resume=False):
    a = ["train", "--subtask", subtask, "--tiny", "--epochs", str(epochs),
         "--num-folds", "2", "--fold", "0", "--batch-size", "8",
         "--lr", "1e-3", "-tr", str(root / "tr.json"),
         "-te", str(root / "dv.json"), "-o", str(out),
         "--checkpoint-dir", str(ckpt), "--cache-dir", str(ckpt / "cache"),
         "--device", "cpu"]
    return a + ["--resume"] if resume else a


@pytest.mark.parametrize("subtask,flags,epochs", RUNS, ids=["2a", "2c"])
def test_crash_resume_tsv_equivalence(tmp_path, monkeypatch, manifests,
                                      subtask, flags, epochs):
    """Port of the JAX package's ``test_crash_resume_tsv_equivalence``:
    killed right after the first committed checkpoint (mid-epoch: two
    evals an epoch), then ``--resume``: the final TSVs equal an
    uninterrupted run's byte for byte, and ``predict --checkpoint
    DIR/fold_0`` reproduces the final probabilities from ``model.pt``."""
    monkeypatch.chdir(tmp_path)
    assert main(_args(manifests, subtask, epochs, tmp_path / "outA",
                      tmp_path / "ckA") + flags) == 0

    real_save, calls = Checkpointer.save, []

    def crashing_save(self, state, step, metrics=None):
        real_save(self, state, step, metrics)
        self.wait()  # commit: a crash mid-write leaves only `<step>.tmp`
        calls.append(step)
        raise KeyboardInterrupt("injected crash after first checkpoint")

    monkeypatch.setattr(Checkpointer, "save", crashing_save)
    with pytest.raises(KeyboardInterrupt):
        main(_args(manifests, subtask, epochs, tmp_path / "outB",
                   tmp_path / "ckB") + flags)
    assert len(calls) == 1
    with open(tmp_path / "outA" / f"task2{subtask[1].upper()}_train_"
              f"metrics_fold_0.json") as f:
        steps_per_epoch = json.load(f)["steps_per_epoch"]
    assert 0 < calls[0] < steps_per_epoch          # inside epoch 0
    monkeypatch.setattr(Checkpointer, "save", real_save)
    assert main(_args(manifests, subtask, epochs, tmp_path / "outB",
                      tmp_path / "ckB", resume=True) + flags) == 0

    out_a, out_b = tmp_path / "outA", tmp_path / "outB"
    tsvs = sorted(p.name for p in out_a.glob("*.tsv"))
    assert tsvs and sorted(p.name for p in out_b.glob("*.tsv")) == tsvs
    for name in tsvs:
        assert (out_a / name).read_bytes() == (out_b / name).read_bytes(), \
            f"{name} differs between uninterrupted and crash+resume runs"
    # The resumed run trained only the steps after the checkpoint.
    with open(out_b / f"task2{subtask[1].upper()}_train_metrics_fold_0"
              f".json") as f:
        assert len(json.load(f)["steps"]) == (steps_per_epoch * epochs
                                              - calls[0])

    prob_tsv = next(p for p in tsvs if "_probs_fold_0" in p)
    rows = [r.rstrip("\n").split("\t")
            for r in open(out_b / prob_tsv)][1:]
    records = {}
    for name in ("tr.json", "dv.json"):
        with open(manifests / name, encoding="utf-8") as f:
            records.update({r["id"]: r for r in json.load(f)})
    with open("m.json", "w", encoding="utf-8") as f:
        json.dump([records[r[0]] for r in rows], f, ensure_ascii=False)
    assert main(["predict", "--subtask", subtask, "--manifest", "m.json",
                 "--checkpoint", str(tmp_path / "ckB" / "fold_0"),
                 "--out", "p.tsv", "--probs-out", "pp.tsv", "--batch-size",
                 "8", "--device", "cpu"]) == 0
    again = [r.rstrip("\n").split("\t") for r in open("pp.tsv")][1:]
    assert [r[0] for r in again] == [r[0] for r in rows]
    np.testing.assert_allclose([float(r[2]) for r in again],
                               [float(r[2]) for r in rows], atol=1e-6,
                               rtol=0)


def _train_step(recipe_fast: bool, seed: int = 0):
    mcfg = dataclasses.replace(ModelConfig.small_2a(), num_classes=2,
                               pooling=PoolingType.ATTENTION)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=4), bf16=False,
                      loss=LossType.CROSS_ENTROPY,
                      learning_rate=1e-3, lr_schedule="constant",
                      adam_mu_dtype="bfloat16" if recipe_fast else None,
                      embedding_optimizer=("factored" if recipe_fast
                                           else "adam"))
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 512, (8, 16))
    store = {"text_ids": torch.from_numpy(ids),
             "text_mask": torch.ones(8, 16, dtype=torch.long),
             "label": torch.from_numpy(rng.integers(0, 2, 8))}
    model = build_model(mcfg, torch.device("cpu"), seed=1, kind="text")
    gen = torch.Generator().manual_seed(3)
    return build_train_step(model, cfg, 10, store, gen)


def _batch(i):
    return {"idx": torch.tensor([i % 8, (i + 3) % 8, (i + 5) % 8, 7]),
            "valid": torch.ones(4)}


def _flat(sd, prefix=""):
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_train_state_round_trips_bit_for_bit(tmp_path):
    """The fast recipe's state (the bf16 first moment, the factored RMS
    rows and columns of the word embeddings, the f32 masters), the step
    count and the dropout generator through ``torch.save`` and
    ``torch.load(weights_only=True)``: every tensor equal at its own
    dtype, and the next step of the restored copy equal to the original's
    bit for bit."""
    a = _train_step(True)
    for i in range(2):
        a.model.train()
        a(_batch(i))
    path = tmp_path / "s.pt"
    torch.save(a.state_dict(), path)
    b = _train_step(True)
    b.load_state_dict(torch.load(path, weights_only=True))
    sa, sb = _flat(a.state_dict()), _flat(b.state_dict())
    assert sa.keys() == sb.keys()
    dtypes = {str(v.dtype) for k, v in sa.items() if ".mu" in k}
    assert dtypes == {"torch.bfloat16"}
    assert any(k.endswith("v_row") for k in sa)
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == sb[k].dtype and torch.equal(v, sb[k]), k
        else:
            assert v == sb[k], k
    assert sa["optimizer.count"] == 2
    ma, mb = a(_batch(2)), b(_batch(2))
    assert torch.equal(ma["loss"], mb["loss"])
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_train_state_refuses_another_recipe(tmp_path):
    """A reference-recipe state (f32 moments, Adam on the embeddings) does
    not load into a fast-recipe step."""
    ref = _train_step(False)
    with pytest.raises(ValueError, match="optimizer"):
        _train_step(True).load_state_dict(ref.state_dict())


def test_checkpointer_keeps_what_orbax_keeps(tmp_path):
    """Step-addressed saves, the two best by ``test_f1`` kept (ties to the
    newer step), a save at or below the newest kept step skipped, and the
    sidecar with every save's metrics: the same as the JAX package's
    orbax ``Checkpointer`` over the same sequence."""
    seq = [(3, {"test_f1": 0.5, "threshold": 0.1}),
           (6, {"test_f1": 0.7, "threshold": 0.2}),
           (9, {"test_f1": 0.6, "threshold": 0.3}),
           (12, {"test_f1": 0.4}), (1, {"test_f1": 0.9}),
           (20, {"test_f1": 0.6}), (25, {})]
    mine = Checkpointer(str(tmp_path / "port"))
    theirs = JCheckpointer(str(tmp_path / "jax"))

    class Target:
        def load_state_dict(self, sd):
            self.sd = sd

    for step, metrics in seq:
        mine.save({"w": torch.full((2,), float(step))}, step, metrics)
        theirs.save({"w": jnp.full((2,), float(step))}, step, metrics)
        theirs.wait()
        assert mine.all_steps() == list(theirs.manager.all_steps()), step
        assert mine.latest_metrics() == theirs.latest_metrics(), step
    with open(tmp_path / "port" / "ckpt_meta.json") as f, \
            open(tmp_path / "jax" / "ckpt_meta.json") as g:
        assert json.load(f) == json.load(g)
    target = mine.restore_latest(Target())
    step = mine.latest_step()
    assert torch.equal(target.sd["w"], torch.full((2,), float(step)))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        [str(s) for s in mine.all_steps()] + ["ckpt_meta.json"])
    empty = Checkpointer(str(tmp_path / "empty"))
    assert empty.latest_metrics() is None
    t = Target()
    assert empty.restore_latest(t) is t and not hasattr(t, "sd")


def test_checkpointer_writes_a_snapshot_in_the_background(tmp_path,
                                                          monkeypatch):
    """``save`` copies the state at the call (later in-place updates do not
    reach the file), a write that fails raises from ``wait`` and leaves
    no step directory, so the previous checkpoint stays the newest."""
    ckpt = Checkpointer(str(tmp_path))
    w = torch.zeros(3)
    ckpt.save({"w": w}, 1, {"test_f1": 0.5})
    w += 7.0                                   # the next training step
    ckpt.wait()
    state = torch.load(tmp_path / "1" / "state.pt", weights_only=True)
    assert torch.equal(state["w"], torch.zeros(3))

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ckpt.save({"w": w}, 2, {"test_f1": 0.9})
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert ckpt.all_steps() == [1]
    assert ckpt.latest_metrics() == {"test_f1": 0.5}
