"""The port's classic-to-neural distillation (mpmc_tpu_torch.train.distill,
the mixed loss of ``train/step.py``, the soft column of the packed plans
and of ``fit``, and ``train --distill-lambda``) against the JAX package.

The teacher's soft targets equal the JAX package's exactly on the same
texts and folds, and each package reads the other's cache file (a hit
imports no sklearn); the mixed loss is within 1e-6 of the JAX step's for
the cross-entropy and focal heads; a packed 2A step with soft targets
matches ``build_train_step_fn`` at the train-step tolerances; and the
command line gives the JAX command line's TSV names and ``_distill`` run
ids (untagged where no soft target is used), with the same cache file."""

import builtins
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.cli import experiments as j_experiments
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.cv.kfold import stratified_kfold as j_stratified_kfold
from mpmc_tpu.models.classifier import PackedTextClassifier as JPacked
from mpmc_tpu.models.classifier import TextClassifier as JText
from mpmc_tpu.train.distill import ngram_soft_targets as j_soft_targets
from mpmc_tpu.train.packed import PackedMultimodalPlan as JMultiPlan
from mpmc_tpu.train.packed import PackedTrainPlan as JPlan
from mpmc_tpu.train.packed import make_packed_text_apply_fn
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig)
from mpmc_tpu_torch.cv.kfold import stratified_kfold
from mpmc_tpu_torch.io.tsv import read_run_id
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.train import distill
from mpmc_tpu_torch.train.packed import PackedMultimodalPlan, PackedTrainPlan
from mpmc_tpu_torch.train.step import build_train_step, loss_from_outputs

TOL = 1e-5          # the train-step tolerance of tests/test_torch_train_2a.py
LOSS_TOL = 1e-6
LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")


def _corpus(n=60, seed=0):
    """Texts whose label shows in a signal word, among random words."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for i in range(n):
        y = int(rng.random() < 0.45)
        words = ["".join(rng.choice(LETTERS, rng.integers(2, 6)))
                 for _ in range(rng.integers(2, 8))]
        words.insert(int(rng.integers(0, len(words))),
                     "دعاية" if y else "عادي")
        texts.append(" ".join(words))
        labels.append(y)
    return texts, np.array(labels)


TEACHER = dict(inner_folds=3, max_features=500)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread.  On a loaded machine
    (the suite's parallel workers) a pool of threads per process turns each
    small op into a wait at the pool's barrier, many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("analyzer,ngram_range", [("char_wb", (2, 5)),
                                                  ("word", (1, 2))])
def test_soft_targets_equal_jax(analyzer, ngram_range):
    texts, labels = _corpus()
    splits = stratified_kfold(labels, 3, seed=42)
    jsplits = j_stratified_kfold(labels, 3, seed=42)
    for (a, b), (c, d) in zip(splits, jsplits):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    got = distill.ngram_soft_targets(texts, labels, splits,
                                     analyzer=analyzer,
                                     ngram_range=ngram_range, **TEACHER)
    want = j_soft_targets(texts, labels, jsplits, analyzer=analyzer,
                          ngram_range=ngram_range, **TEACHER)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for k, (tr, va) in enumerate(splits):
        assert np.all(got[k][va] == 0.5)       # validation rows: sentinel
        assert np.all((got[k][tr] >= 0) & (got[k][tr] <= 1))


def _no_sklearn(monkeypatch):
    """Make ``import sklearn`` (and its submodules) fail."""
    real = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_file_shared_with_jax(tmp_path, monkeypatch, writer):
    """Either package's cache file is the other's cache hit, and a hit
    imports no sklearn."""
    texts, labels = _corpus(seed=1)
    splits = stratified_kfold(labels, 3, seed=42)
    cache = str(tmp_path)
    if writer == "jax":
        want = j_soft_targets(texts, labels, splits, cache_dir=cache,
                              **TEACHER)
    else:
        want = distill.ngram_soft_targets(texts, labels, splits,
                                          cache_dir=cache, **TEACHER)
    files = os.listdir(cache)
    assert files == [os.path.basename(distill.cache_path(
        cache, texts, labels, splits, **TEACHER))]
    with monkeypatch.context() as mp:
        _no_sklearn(mp)
        got = distill.ngram_soft_targets(texts, labels, splits,
                                         cache_dir=cache, **TEACHER)
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ImportError, match="need scikit-learn"):
            distill.ngram_soft_targets(texts, labels, splits[:2],
                                       cache_dir=cache, **TEACHER)
    np.testing.assert_array_equal(
        j_soft_targets(texts, labels, splits, cache_dir=cache, **TEACHER),
        want)


# ---------------------------------------------------------------------------
# The mixed loss
# ---------------------------------------------------------------------------

def _jax_step_loss(outputs, labels, valid, soft, loss, lam):
    """The JAX train step's loss (``loss_from_outputs``) for fixed model
    outputs: the model returns them as they are."""
    cfg = JTrainConfig(loss=loss, bf16=False, distill_lambda=lam)
    tx = make_optimizer(cfg, total_steps=4)
    state, _ = create_train_state({"params": {"w": jnp.zeros(())}}, tx)

    def apply_fn(variables, batch, train, rngs, mutable):
        return batch["out"] + 0 * variables["params"]["w"], {}

    batch = {"out": outputs, "label": labels, "valid": valid}
    if soft is not None:
        batch["soft"] = soft
    step = build_train_step_fn(apply_fn, cfg, tx)
    _, m = step(state, batch, jax.random.key(0))
    return float(m["loss"])


@pytest.mark.parametrize("loss", ["ce", "focal"])
@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
def test_mixed_loss_equals_jax(loss, lam):
    rng = np.random.default_rng(3)
    B = 12
    shape = (B, 2) if loss == "ce" else (B,)
    outputs = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, 2, B).astype(np.int32)
    valid = (np.arange(B) < 9).astype(np.float32)
    soft = rng.random(B).astype(np.float32)
    cfg = TrainConfig(loss=LossType(loss), distill_lambda=lam)
    for s in (soft, None):
        got = float(loss_from_outputs(
            torch.from_numpy(outputs), torch.from_numpy(labels),
            torch.from_numpy(valid), cfg,
            None if s is None else torch.from_numpy(s)))
        want = _jax_step_loss(outputs, labels, valid, s, JLossType(loss),
                              lam)
        assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want)), (got,
                                                                   want)


def test_mixed_loss_refuses_other_heads():
    cfg = TrainConfig(loss=LossType.CROSS_ENTROPY, distill_lambda=0.5)
    out = np.zeros((4, 3), np.float32)
    labels, valid = np.zeros(4, np.int32), np.ones(4, np.float32)
    soft = np.full(4, 0.5, np.float32)
    with pytest.raises(ValueError, match="requires a binary head"):
        loss_from_outputs(torch.from_numpy(out), torch.from_numpy(labels),
                          torch.from_numpy(valid), cfg,
                          torch.from_numpy(soft))
    with pytest.raises(ValueError, match="requires a binary head"):
        _jax_step_loss(out, labels, valid, soft, JLossType.CROSS_ENTROPY,
                       0.5)


# ---------------------------------------------------------------------------
# The soft column through the packed plans, and a packed 2A step
# ---------------------------------------------------------------------------

def _text_data(seed, n, S=32, caption=False):
    rng = np.random.default_rng(seed)
    d = {}
    for key, length in (("text", S),) + ((("caption", 16),) if caption
                                        else ()):
        lens = rng.integers(2, length - 1, n)
        mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
        d[f"{key}_ids"] = (rng.integers(5, 512, (n, length)) * mask
                           ).astype(np.int32)
        d[f"{key}_mask"] = mask
    d["label"] = rng.integers(0, 2, n).astype(np.int32)
    d["soft"] = rng.random(n).astype(np.float32)
    return d


def _same_batches(got_iter, want_iter):
    n = 0
    for (got, gk), (want, wk) in zip(got_iter, want_iter):
        assert gk == wk and sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        n += 1
    return n


def test_packed_plans_carry_soft_like_jax():
    """2A: the soft targets in the sample slots, 0.5 in the empty ones; 2C:
    the batch's rows as they are."""
    data = _text_data(4, 50)
    n = _same_batches(
        PackedTrainPlan(data, 32, 3).epoch_iter(np.random.default_rng(5)),
        JPlan(data, pack_len=32, rows_per_batch=3).epoch_iter(
            np.random.default_rng(5)))
    assert n > 1
    batch, k = next(PackedTrainPlan(data, 32, 3).epoch_iter(
        np.random.default_rng(5)))
    assert np.all(batch["soft"][k:] == 0.5)
    data = _text_data(6, 21, caption=True)
    data["image"] = np.zeros((21, 4, 4, 3), np.uint8)
    abs_idx = np.arange(100, 121)
    assert _same_batches(
        PackedMultimodalPlan(data, 8, abs_idx, True).epoch_iter(
            np.random.default_rng(7)),
        JMultiPlan(data, batch_size=8, abs_idx=abs_idx,
                   resident_images=True).epoch_iter(
            np.random.default_rng(7))) == 3


# Weights whose gradient is zero in exact arithmetic (the attention key
# bias, the attention pooler's score bias): Adam may move them either way.
ZERO_GRAD = ("attention.key.bias", "pooler.attn_fc2.bias")


def check_weights(model, state_params, lr, steps):
    """Every weight within Adam's bound of the JAX step's, all but 1 % of
    the others within ``TOL`` (``tests/test_torch_train_2a.py``'s rule)."""
    want = from_jax_variables(jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32), state_params))
    got = model.state_dict()
    assert set(got) == set(want)
    bound = 2 * 3.17 * lr * steps
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(ZERO_GRAD):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


def _cfgs():
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    out = []
    for cls, pool in ((ModelConfig, PoolingType), (JModelConfig,
                                                   JPoolingType)):
        m = cls.tiny_2c()
        out.append(dataclasses.replace(
            m, pooling=pool("attention"), num_classes=2, dropout=0.0,
            text=dataclasses.replace(m.text, **enc)))
    return out


def test_packed_2a_steps_with_soft_targets_match_jax():
    """The fast recipe with ``distill_lambda`` 0.5: three packed steps, the
    losses, grad norms and weights against ``build_train_step_fn``."""
    mcfg, jmcfg = _cfgs()
    data = _text_data(8, 60)
    params = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32),
        JText(jmcfg).init(jax.random.key(3), data["text_ids"][:2],
                          data["text_mask"][:2])["params"])
    kw = dict(learning_rate=1e-4, lr_schedule="constant", bf16=False,
              adam_mu_dtype="bfloat16", embedding_optimizer="factored",
              distill_lambda=0.5)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=16),
                      loss=LossType.CROSS_ENTROPY, **kw)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=16),
                        loss=JLossType.CROSS_ENTROPY, **kw)
    tx = make_optimizer(jcfg, 3)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, tx)
    j_step = jax.jit(build_train_step_fn(
        make_packed_text_apply_fn(JPacked(jmcfg)), jcfg, tx))
    model = build_model(mcfg, torch.device("cpu"), kind="text", packed=True)
    model.load_state_dict(from_jax_variables(params))
    step = build_train_step(model, cfg, 3, {}, torch.Generator())
    plain = build_model(mcfg, torch.device("cpu"), kind="text", packed=True)
    plain.load_state_dict(from_jax_variables(params))
    no_distill = build_train_step(plain, dataclasses.replace(
        cfg, distill_lambda=0.0), 3, {}, torch.Generator())
    batches = [b for b, _ in PackedTrainPlan(data, 32, 2).epoch_iter(
        np.random.default_rng(8))][:3]
    assert len(batches) == 3 and "soft" in batches[0]
    for i, batch in enumerate(batches):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.key(i))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        m = step(tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
        if i == 0:   # the soft targets change the loss
            assert abs(float(no_distill(tb)["loss"])
                       - float(m["loss"])) > 1e-3
    check_weights(model, state.params, 1e-4, 3)


# ---------------------------------------------------------------------------
# train --distill-lambda beside the JAX command line
# ---------------------------------------------------------------------------

def _write_manifest(path, n, seed, off=0):
    """Memes whose text carries the label in a signal word."""
    texts, labels = _corpus(n, seed)
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg", "text": t,
             "class_label": "propaganda" if y else "not_propaganda"}
            for i, (t, y) in enumerate(zip(texts, labels))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def _stub_steps(model, cfg, train_data, kind, **kwargs):
    """The JAX ``_run_folds``' model and steps replaced by constants (the
    steps' arithmetic is held above); what stays is the driver's own:
    configs, vocabularies, soft targets, folds, evals and TSVs."""
    state, _ = create_train_state({"params": {"w": jnp.zeros(1)}},
                                  optax.sgd(0.0))

    def train_step(state, batch, rng):
        return state.replace(step=state.step + 1), {
            "loss": jnp.float32(0.5), "grad_norm": jnp.float32(1.0)}

    def eval_step(state, batch):
        n = batch["label"].shape[0]
        return jnp.linspace(0.2, 0.8, n), jnp.zeros(n)

    return state, train_step, eval_step, None, None, None


# (name, flags, distilled)
RUNS = [("2a_fast", ["--subtask", "2a", "--tiny", "--corpus-vocab",
                     "subword", "--corpus-vocab-size", "400"], True),
        ("2a_reference", ["--subtask", "2a", "--tiny", "--recipe",
                          "reference"], True),
        ("2c", ["--subtask", "2c", "--tiny"], True),
        ("2c_simple", ["--subtask", "2c", "--tiny", "--simple"], False),
        ("2b", ["--subtask", "2b", "--image-arch", "tiny_resnet",
                "--image-size", "32"], False)]


def _argv(root, flags, out, cache):
    return ["train", *flags, "-tr", str(root / "train.json"),
            "-te", str(root / "dev.json"), "--fold", "0", "--epochs", "1",
            "--num-folds", "2", "--batch-size", "8", "--distill-lambda", "0.5",
            "--out-dir", str(out), "--cache-dir", str(cache)]


@pytest.fixture(scope="module")
def jax_distill_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jaxdistill")
    _write_manifest(root / "train.json", 48, 0)
    _write_manifest(root / "dev.json", 12, 1, off=1000)
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_experiments, "_init_and_steps", _stub_steps)
        for name, flags, _ in RUNS:
            outs[name] = root / f"jout_{name}"
            args = j_build_parser().parse_args(
                _argv(root, flags, outs[name], root / f"jcache_{name}"))
            assert args.fn(args) == 0
    return root, outs


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("name,flags,distilled", RUNS,
                         ids=[r[0] for r in RUNS])
def test_train_distill_cli_beside_jax(tmp_path, monkeypatch,
                                      jax_distill_runs, name, flags,
                                      distilled):
    """The same TSV names, headers and ids as the JAX command line; the run
    id ends in ``_distill`` exactly where the JAX one does; the teacher's
    cache file has the same name and contents."""
    root, jouts = jax_distill_runs
    monkeypatch.chdir(tmp_path)
    out, cache = tmp_path / "out", tmp_path / "cache"
    assert main(_argv(root, flags, out, cache) + ["--device", "cpu"]) == 0
    jout = jouts[name]
    tsvs = sorted(p.name for p in out.glob("*.tsv"))
    assert tsvs == sorted(p.name for p in jout.glob("*.tsv")) and tsvs
    for tsv in tsvs:
        got, want = _rows(out / tsv), _rows(jout / tsv)
        assert got[0] == want[0]
        assert [r[0] for r in got] == [r[0] for r in want]
        run_id = read_run_id(str(out / tsv))
        assert run_id == read_run_id(str(jout / tsv))
        assert run_id == ("kevinmathew_mpmc_tpu"
                          + ("_distill" if distilled else ""))
    for vocab in ("vocab.txt", "caption_vocab.txt"):
        assert (out / vocab).exists() == (jout / vocab).exists()
        if (out / vocab).exists():
            assert (out / vocab).read_bytes() == (jout / vocab).read_bytes()
    def teacher_files(d):
        return sorted(f for f in os.listdir(d) if f.startswith("distill_")
                      ) if d.exists() else []

    jcache = root / f"jcache_{name}"
    files = teacher_files(cache)
    assert files == teacher_files(jcache)
    assert bool(files) == distilled
    for f in files:
        np.testing.assert_array_equal(np.load(cache / f)["soft"],
                                      np.load(jcache / f)["soft"])
