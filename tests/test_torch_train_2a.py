"""The port's 2A training path (mpmc_tpu_torch) against the JAX package at
tiny sizes: manifests, the packed plan, the packed text classifier, the
schedules and parameter groups, three packed (fast recipe) and three
unpacked (reference recipe) train steps, and ``train --subtask 2a`` end to
end on the CPU beside the JAX driver.  Inputs and weights come from numpy
seeds and the JAX package's init; the parity checks run in f32 with
dropout 0."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.cli.experiments import run_subtask_2a as j_run_subtask_2a
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.io.manifest import read_manifest as j_read_manifest
from mpmc_tpu.models.classifier import PackedTextClassifier as JPacked
from mpmc_tpu.models.classifier import TextClassifier as JText
from mpmc_tpu.ops.packing import packed_sample_view as j_sample_view
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.packed import PackedTrainPlan as JPlan
from mpmc_tpu.train.packed import make_packed_text_apply_fn
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig)
from mpmc_tpu_torch.io.manifest import read_manifest
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.ops.packing import pack_sequences, packed_sample_view
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.packed import PackedTrainPlan, packed_model_inputs
from mpmc_tpu_torch.train.step import (Optimizer, build_train_step,
                                       constant_schedule)

# f32 on both sides; layers summed in different orders by XLA and PyTorch.
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _ragged(rng, n, S, vocab=512, min_len=2):
    lens = rng.integers(min_len, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _data(seed, n, S=32):
    rng = np.random.default_rng(seed)
    ids, mask = _ragged(rng, n, S)
    return {"text_ids": ids, "text_mask": mask,
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _cfgs(pooling="attention"):
    """The 2A model on the tiny text encoder, dropout 0: the port's and the
    JAX package's config."""
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    out = []
    for cls, pool in ((ModelConfig, PoolingType), (JModelConfig,
                                                   JPoolingType)):
        m = cls.tiny_2c()
        out.append(dataclasses.replace(
            m, pooling=pool(pooling), num_classes=2, dropout=0.0,
            text=dataclasses.replace(m.text, **enc)))
    return out


def _jax_params(jmcfg, data, seed=3):
    return _np(JText(jmcfg).init(jax.random.key(seed),
                                 data["text_ids"][:2],
                                 data["text_mask"][:2])["params"])


# ---------------------------------------------------------------------------
# Manifests, packing, the plan
# ---------------------------------------------------------------------------

def test_manifest_select_and_concat_match_jax(tmp_path):
    _write_manifest(tmp_path / "a.json", 7, 0)
    _write_manifest(tmp_path / "b.json", 5, 1, off=100)
    a, b = (read_manifest(str(tmp_path / f)) for f in ("a.json", "b.json"))
    ja, jb = (j_read_manifest(str(tmp_path / f)) for f in ("a.json",
                                                            "b.json"))
    for got, want in ((a.concat(b), ja.concat(jb)),
                      (a.concat(b).select([9, 0, 3]),
                       ja.concat(jb).select([9, 0, 3]))):
        assert got.ids == want.ids and got.texts == want.texts
        assert got.img_paths == want.img_paths
        np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("rows_per_batch", [3, 4])
def test_packed_train_plan_matches_jax(rows_per_batch):
    """Row budget, steps and every batch array, the zero-padded last row
    chunk and the empty sample slots included, over two epochs."""
    data = _data(0, n=45)
    plan = PackedTrainPlan(data, pack_len=32, rows_per_batch=rows_per_batch,
                           max_segments=4)
    jplan = JPlan(data, pack_len=32, rows_per_batch=rows_per_batch,
                  max_segments=4)
    assert plan.row_budget == jplan.row_budget
    assert plan.row_budgets == (jplan.row_budget,)
    assert plan.steps_per_epoch == jplan.steps_per_epoch
    assert plan.samples_per_batch == jplan.samples_per_batch
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    padded = 0
    for _ in range(2):
        pairs = list(zip(plan.epoch_iter(rng), jplan.epoch_iter(jrng)))
        assert len(pairs) == plan.steps_per_epoch
        for (b, k), (jb, jk) in pairs:
            assert k == jk and set(b) == set(jb)
            for key in b:
                assert b[key].dtype == jb[key].dtype, key
                np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
            padded += int((b["t_segments"] == 0).all(axis=1).sum())
    assert plan.row_budget % rows_per_batch and padded > 0


def test_packed_sample_view_matches_jax():
    data = _data(1, n=9)
    p = pack_sequences(data["text_ids"], data["text_mask"], 32,
                       max_segments=3)
    hidden = np.random.default_rng(2).standard_normal(
        (p.num_rows, 32, 8)).astype(np.float32)
    packed = {"segments": p.segments, "row_of": p.row_of,
              "slot_of": p.slot_of}
    rows, mask = packed_sample_view(
        torch.from_numpy(hidden), {k: torch.from_numpy(v)
                                   for k, v in packed.items()})
    jrows, jmask = j_sample_view(jnp.asarray(hidden),
                                 {k: jnp.asarray(v) for k, v in packed.items()})
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # Each sample's mask selects exactly its own tokens.
    np.testing.assert_array_equal(mask.sum(1).numpy(),
                                  data["text_mask"].sum(1))


# ---------------------------------------------------------------------------
# The packed text classifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["cls", "mean", "attention"])
def test_packed_text_classifier_matches_flax(pooling):
    """Logits of every sample slot of a plan batch (the empty slots
    included) against flax's ``PackedTextClassifier``, and of the real
    samples against the port's unpacked ``TextClassifier``."""
    mcfg, jmcfg = _cfgs(pooling)
    data = _data(4, n=30)
    params = _jax_params(jmcfg, data)
    model = build_model(mcfg, torch.device("cpu"), kind="text", packed=True)
    model.load_state_dict(from_jax_variables(params))
    plan = PackedTrainPlan(data, pack_len=32, rows_per_batch=3,
                           max_segments=16)
    batch, k = next(plan.epoch_iter(np.random.default_rng(0)))
    text, _ = packed_model_inputs({kk: torch.from_numpy(v)
                                   for kk, v in batch.items()})
    with torch.no_grad():
        got = model(text).numpy()
    jtext = {key: jnp.asarray(batch[f"t_{key}"]) for key in
             ("ids", "segments", "positions", "row_of", "slot_of",
              "start_of")}
    want = np.asarray(JPacked(jmcfg).apply({"params": params}, jtext))
    assert got.shape == (48, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # The real samples equal the unpacked forward: rebuild each slot's
    # own tokens from its packed row.
    ids = np.zeros((k, 32), np.int32)
    mask = np.zeros((k, 32), np.int32)
    for s in range(k):
        r, st = batch["t_row_of"][s], batch["t_start_of"][s]
        L = int((batch["t_segments"][r] == batch["t_slot_of"][s]).sum())
        ids[s, :L] = batch["t_ids"][r, st:st + L]
        mask[s, :L] = 1
    plain = build_model(mcfg, torch.device("cpu"), kind="text")
    plain.load_state_dict(from_jax_variables(params))
    with torch.no_grad():
        ref = plain(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[:k], ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("pooling", ["max", "cnn", "nopooling"])
def test_packed_text_classifier_refuses_unmasked_poolings(pooling):
    mcfg, _ = _cfgs(pooling)
    with pytest.raises(ValueError, match="cannot be packed"):
        build_model(mcfg, torch.device("cpu"), kind="text", packed=True)
    build_model(mcfg, torch.device("cpu"), kind="text")   # unpacked: fine


# ---------------------------------------------------------------------------
# Schedules and parameter groups
# ---------------------------------------------------------------------------

def test_constant_schedule_matches_optax():
    for lr in (1e-5, 3e-4 * 0.8, 2.0 / 3.0):
        got, want = constant_schedule(lr), optax.constant_schedule(lr)
        for step in (0, 1, 17, 10_000):
            assert np.float32(got(step)) == np.float32(want(step))
    cfg = TrainConfig(learning_rate=2e-5, lr_schedule="constant")
    opt = Optimizer(cfg, 40, {"output.weight": torch.zeros(2, 3)})
    assert opt.schedules["head"](0) == opt.schedules["head"](39) == 2e-5
    assert opt.schedules["encoder"](5) == 2e-5 * 0.8
    with pytest.raises(ValueError, match="lr_schedule"):
        Optimizer(TrainConfig(lr_schedule="cosine"), 4, {})


def _jax_labels(tx, params):
    """Parameter path -> label of optax's multi_transform, read from the
    masked inner states (a label's state holds only its parameters)."""
    labels = {}
    for label, st in tx.init(params)[1].inner_states.items():
        first = st.inner_state[0]
        tree = first.mu if hasattr(first, "mu") else first.v_row
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
            labels[tuple(p.key for p in path)] = label
    return labels


@pytest.mark.parametrize("recipe", ["fast", "reference"])
def test_2a_parameter_groups_match_make_optimizer(recipe):
    """Every 2A parameter is in the head group at the full LR, but the
    word-embedding table under factored RMS: the 2A names have no
    ``text_model``."""
    fast = recipe == "fast"
    kw = dict(lr_schedule="constant",
              embedding_optimizer="factored" if fast else "adam",
              adam_mu_dtype="bfloat16" if fast else None)
    mcfg, jmcfg = _cfgs()
    params = _jax_params(jmcfg, _data(0, n=4))
    want = _jax_labels(make_optimizer(JTrainConfig(**kw), 10), params)
    model = build_model(mcfg, torch.device("cpu"), kind="text")
    got = Optimizer(TrainConfig(**kw), 10, dict(model.named_parameters()))
    by_label = {}
    for path, label in want.items():
        node = by_label.setdefault(label, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _get(params, path)
    names = {label: set(from_jax_variables(tree))
             for label, tree in by_label.items()}
    assert {n for s in names.values() for n in s} == set(got.label)
    for label, members in names.items():
        assert {n for n in members if got.label[n] == label} == members
    assert set(names) == ({"head", "embed"} if fast else {"head"})
    assert names.get("embed", {"encoder.word_embeddings.weight"}) == {
        "encoder.word_embeddings.weight"}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

# Weights whose gradient is zero in exact arithmetic: the attention key
# bias (it adds the same q.b to every score of a query row) and the
# attention pooler's score bias (the softmax over positions removes it).
ZERO_GRAD = ("attention.key.bias", "pooler.attn_fc2.bias")


def _check_weights(model, state_params, lr, steps):
    want = from_jax_variables(_np(state_params))
    got = model.state_dict()
    assert set(got) == set(want)
    # Adam's step per entry is at most (1 - b1) / sqrt(1 - b2) ~ 3.17 lr;
    # an entry whose gradient is at the noise floor (exactly zero for the
    # names in ZERO_GRAD) may move the other way in the other package.
    # Every entry is held to that bound, all but 1 % of the others to TOL.
    bound = 2 * 3.17 * lr * steps
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(ZERO_GRAD):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


def _train_cfgs(mcfg, jmcfg, B, fast):
    kw = dict(learning_rate=1e-4, lr_schedule="constant", bf16=False,
              adam_mu_dtype="bfloat16" if fast else None,
              embedding_optimizer="factored" if fast else "adam")
    return (TrainConfig(model=mcfg, data=DataConfig(batch_size=B),
                        loss=LossType.CROSS_ENTROPY, **kw),
            JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B),
                         loss=JLossType.CROSS_ENTROPY, **kw))


def test_three_packed_2a_steps_match_build_train_step_fn():
    """The fast recipe: packed rows, CE, constant LR, bf16 first moment,
    factored embeddings."""
    mcfg, jmcfg = _cfgs()
    data = _data(6, n=60)
    params = _jax_params(jmcfg, data)
    cfg, jcfg = _train_cfgs(mcfg, jmcfg, 16, fast=True)
    tx = make_optimizer(jcfg, 3)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, tx)
    j_step = jax.jit(build_train_step_fn(
        make_packed_text_apply_fn(JPacked(jmcfg)), jcfg, tx))
    model = build_model(mcfg, torch.device("cpu"), kind="text", packed=True)
    model.load_state_dict(from_jax_variables(params))
    step = build_train_step(model, cfg, 3, {}, torch.Generator())
    assert step.optimizer.label["encoder.word_embeddings.weight"] == "embed"
    batches = [b for b, _ in JPlan(data, pack_len=32, rows_per_batch=2)
               .epoch_iter(np.random.default_rng(8))][:3]
    assert len(batches) == 3 and min(b["valid"].sum() for b in batches) > 0
    for i, batch in enumerate(batches):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.key(i))
        m = step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
    _check_weights(model, state.params, 1e-4, 3)


def test_three_unpacked_2a_steps_reference_recipe():
    """The reference recipe: unpacked batches gathered by row index from
    the resident arrays, f32 Adam everywhere, CE, constant LR."""
    mcfg, jmcfg = _cfgs()
    data = _data(7, n=40)
    params = _jax_params(jmcfg, data)
    B = 16
    cfg, jcfg = _train_cfgs(mcfg, jmcfg, B, fast=False)
    tx = make_optimizer(jcfg, 3)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, tx)
    j_step = jax.jit(build_train_step_fn(
        make_apply_fn(JText(jmcfg), "text"), jcfg, tx))
    model = build_model(mcfg, torch.device("cpu"), kind="text")
    model.load_state_dict(from_jax_variables(params))
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    step = build_train_step(model, cfg, 3, store, torch.Generator())
    jbatches = j_batch_iter(data, B, shuffle=True,
                            rng=np.random.default_rng(9), with_valid=True)
    batches = batch_iter({"idx": np.arange(40)}, B, shuffle=True,
                         rng=np.random.default_rng(9), with_valid=True)
    n = 0
    for i, ((jb, _), (b, _)) in enumerate(zip(jbatches, batches)):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in jb.items()},
                           jax.random.key(i))
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
        n += 1
    assert n == 3                      # the last batch is short: 8 valid
    _check_weights(model, state.params, 1e-4, 3)


# ---------------------------------------------------------------------------
# train --subtask 2a end to end
# ---------------------------------------------------------------------------

def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg",
             "text": " ".join("".join(rng.choice(letters,
                                                 int(rng.integers(2, 6))))
                              for _ in range(int(rng.integers(2, 12)))),
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


TSVS = ("task2A_kevinmathew.tsv", "task2A_kevinmathew_probs_fold_0.tsv",
        "task2A_kevinmathew_val_fold_0.tsv")


@pytest.fixture(scope="module")
def jax_2a_run(tmp_path_factory):
    """The JAX package's ``run_subtask_2a`` (small_2a, fold 0, one epoch,
    fast recipe's packing) on the manifests the port trains on."""
    root = tmp_path_factory.mktemp("jax2a")
    _write_manifest(root / "train.json", 40, 0)
    _write_manifest(root / "dev.json", 12, 1, off=1000)
    out = root / "jout"
    cfg = JTrainConfig(
        model=JModelConfig.small_2a(), epochs=1, lr_schedule="constant",
        data=JDataConfig(train_manifest=str(root / "train.json"),
                         dev_manifest=str(root / "dev.json"),
                         fold_over_train_plus_dev=True, pack_rows=4,
                         cache_dir=str(root / ".cache")))
    j_run_subtask_2a(cfg, out_dir=str(out), folds=[0])
    return root, out


@pytest.mark.parametrize("flags", [[], ["--recipe", "reference"],
                                   ["--mlm-epochs", "1"]],
                         ids=["fast", "reference", "mlm"])
def test_train_2a_cli_end_to_end_on_cpu(tmp_path, monkeypatch, jax_2a_run,
                                        flags):
    root, jout = jax_2a_run
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    assert main(["train", "--subtask", "2a", "-tr", str(root / "train.json"),
                 "-te", str(root / "dev.json"), "--small", "--device", "cpu",
                 "--fold", "0", "--epochs", "1", "--checkpoint-dir", "ck",
                 "--out-dir", str(out), *flags]) == 0
    tsvs = sorted(p.name for p in out.glob("*.tsv"))
    assert tsvs == sorted(p.name for p in jout.glob("*.tsv")) == sorted(TSVS)
    for name in TSVS:
        got, want = _rows(out / name), _rows(jout / name)
        assert got[0] == want[0]                     # header
        assert [r[0] for r in got] == [r[0] for r in want]   # ids
        assert all(r[-1] == "kevinmathew_mpmc_tpu" for r in got[1:])
    assert check_format(str(out / TSVS[0]))
    # Labels are the probabilities at 0.5, in the label TSV too.
    probs = {r[0]: float(r[2]) for r in _rows(out / TSVS[1])[1:]}
    for name in TSVS:
        for r in _rows(out / name)[1:]:
            assert r[1] == ("propaganda" if probs[r[0]] > 0.5
                            else "not_propaganda")
    assert (out / "vocab.txt").read_bytes() == (jout / "vocab.txt").read_bytes()
    with open(out / "run_meta.json") as f, open(jout / "run_meta.json") as g:
        assert json.load(f) == json.load(g)
    with open(out / "task2A_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert len(metrics["steps"]) == metrics["steps_per_epoch"] > 0
    assert all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in metrics["steps"])
    assert (metrics["row_budgets"] is None) == ("reference" in flags)
    assert (out / "mlm_encoder.npz").exists() == ("--mlm-epochs" in flags)
    # predict on the best checkpoint, over the fold's val memes (from both
    # manifests), gives the best eval's probabilities.
    records = {}
    for name in ("train.json", "dev.json"):
        with open(root / name, encoding="utf-8") as f:
            records.update({r["id"]: r for r in json.load(f)})
    with open("val.json", "w", encoding="utf-8") as f:
        json.dump([records[i] for i in probs], f, ensure_ascii=False)
    assert main(["predict", "--subtask", "2a", "--manifest", "val.json",
                 "--checkpoint", "ck/fold_0", "--out", "p.tsv",
                 "--probs-out", "pp.tsv", "--device", "cpu"]) == 0
    again = _rows("pp.tsv")[1:]
    assert [r[0] for r in again] == list(probs)
    np.testing.assert_allclose([float(r[2]) for r in again],
                               list(probs.values()), atol=1e-6, rtol=0)


def test_train_2a_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _write_manifest(tmp_path / "t.json", 6, 0)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(["train", "--subtask", "2a", "-tr", str(tmp_path / "t.json"),
              "-te", str(tmp_path / "t.json"), "--small"])
