"""The port's 2B training path (mpmc_tpu_torch) against the JAX package at
tiny sizes: three ``kind="image"`` train steps (color through the
augmentation with its draws passed explicitly, on a ResNet and on a ViT;
grayscale through the deterministic eval transform), ``train --subtask
2b`` end to end on the CPU beside the JAX ``run_subtask_2b``, and two
command-line defaults held to the JAX command line's output: ``train
--subtask 2c --vocab`` and ``predict``'s run id.  Inputs and weights come
from numpy seeds and the JAX package's init; the parity checks run in f32
with dropout 0."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli import experiments as j_experiments
from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.cli.experiments import run_subtask_2b as j_run_subtask_2b
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ImageEncoderConfig as JImageEncoderConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models import classifier as j_classifier
from mpmc_tpu.models.vit import ViT as JViT
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.experiments import (grayscale_eval_transform,
                                            run_subtask_2b)
from mpmc_tpu_torch.cli.main import build_parser, main, train_config
from mpmc_tpu_torch.config import (DataConfig, ImageEncoderConfig,
                                   LossType, ModelConfig, TrainConfig)
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models import classifier
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.models.vit import ViT
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.step import build_train_step

# f32 on both sides; layers summed in different orders by XLA and PyTorch.
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

# A ViT narrow enough for three steps on the CPU (32 pixels, patch 8: 17
# tokens), built by both factories for the arch name "tiny_vit".
TINY_VIT = dict(patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64)


@pytest.fixture
def tiny_vit(monkeypatch):
    j_factory, factory = (j_classifier.create_image_backbone,
                          classifier.create_image_backbone)

    def j_make(cfg, name=None, num_classes=0):
        if cfg.arch == "tiny_vit":
            return JViT(**TINY_VIT, name=name)
        return j_factory(cfg, name, num_classes)

    def make(cfg, num_classes=0):
        if cfg.arch == "tiny_vit":
            return ViT(cfg.image_size, **TINY_VIT)
        return factory(cfg, num_classes)

    monkeypatch.setattr(j_classifier, "create_image_backbone", j_make)
    monkeypatch.setattr(classifier, "create_image_backbone", make)


# Weights whose gradient is zero in exact arithmetic: the attention key
# bias (it adds the same q.b to every score of a query row).
ZERO_GRAD = ("k.bias",)

# (arch, image size, grayscale): the color ResNet and ViT, and the
# grayscale variant at its own 64 pixels.
STEP_CASES = [("tiny_resnet", 32, False), ("tiny_vit", 32, False),
              ("tiny_resnet", 64, True)]


@pytest.mark.parametrize("arch,size,gray", STEP_CASES,
                         ids=["color-resnet", "color-vit", "grayscale"])
def test_three_image_steps_match_build_train_step_fn(tiny_vit, arch, size,
                                                     gray):
    """Unpacked batches gathered by row index from the resident images,
    cross-entropy over 2 classes, linear warmup (0 warmup steps in 3), f32
    Adam.  Color images go through the augmentation with fixed draws on
    both sides; the grayscale variant through the deterministic eval
    transform with grayscale statistics, as ``run_subtask_2b`` trains
    it."""
    B, n = 8, 20
    image = dict(arch=arch, image_size=size, grayscale=gray)
    mcfg = ModelConfig(num_classes=2, image=ImageEncoderConfig(**image))
    jmcfg = JModelConfig(num_classes=2, image=JImageEncoderConfig(**image))
    rng = np.random.default_rng(11)
    data = {"image": rng.integers(0, 256, (n, size, size, 1 if gray else 3),
                                  dtype=np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}
    kw = dict(learning_rate=1e-4, lr_schedule="linear_warmup", bf16=False,
              adam_mu_dtype=None, embedding_optimizer="adam")
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B),
                        loss=JLossType.CROSS_ENTROPY, **kw)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B),
                      loss=LossType.CROSS_ENTROPY, **kw)
    jmodel = j_classifier.ImageClassifier(jmcfg)
    variables = jax.jit(jmodel.init)(
        jax.random.key(3), data["image"][:2].astype(np.float32) / 255.0)
    params, stats = _np(variables["params"]), _np(variables.get(
        "batch_stats", {}))
    draws = (rng.random(B) < 0.5, rng.uniform(0.9, 1.1, B).astype(np.float32),
             (rng.uniform(-15, 15, B) * math.pi / 180).astype(np.float32))
    if gray:
        apply_fn = make_apply_fn(jmodel, "image", augment_images=True,
                                 grayscale=True, eval_transform_only=True)
        augment = grayscale_eval_transform
    else:
        base = make_apply_fn(jmodel, "image")

        def apply_fn(variables, batch, train, rngs, mutable):
            img = j_rotate_shear(j_fused(batch["image"],
                                         jnp.asarray(draws[0]),
                                         jnp.asarray(draws[1]),
                                         interpret=True),
                                 jnp.asarray(draws[2]), 15.0)
            return base(variables, dict(batch, image=img), train, rngs,
                        mutable)

        def augment(u8, generator):
            return augment_with_draws(u8, *(torch.from_numpy(d)
                                            for d in draws))
    tx = make_optimizer(jcfg, 3)
    state, _ = create_train_state(
        {"params": jax.tree_util.tree_map(jnp.asarray, params),
         **({"batch_stats": stats} if stats else {})}, tx)
    j_step = jax.jit(build_train_step_fn(apply_fn, jcfg, tx))

    model = build_model(mcfg, torch.device("cpu"), kind="image")
    model.load_state_dict(from_jax_variables(params, stats or None))
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    step = build_train_step(model, cfg, 3, store, torch.Generator(), augment)
    jbatches = j_batch_iter(data, B, shuffle=True,
                            rng=np.random.default_rng(9), with_valid=True)
    batches = batch_iter({"idx": np.arange(n)}, B, shuffle=True,
                         rng=np.random.default_rng(9), with_valid=True)
    steps = 0
    for i, ((jb, _), (b, _)) in enumerate(zip(jbatches, batches)):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in jb.items()},
                           jax.random.key(i))
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
        steps += 1
    assert steps == 3                        # the last batch is short: 4 valid
    want = from_jax_variables(_np(state.params),
                              _np(state.batch_stats) if stats else None)
    got = model.state_dict()
    assert set(got) == set(want)
    # Adam's step per entry is at most (1 - b1) / sqrt(1 - b2) ~ 3.17 lr; an
    # entry whose gradient is at the noise floor may step the other way.
    # Every entry is held to that bound, all but 1 % of the others to TOL.
    bound = 2 * 3.17 * 1e-4 * 3
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        if "running_" in name:
            assert d.max() <= 5 * TOL, (name, d.max())
            continue
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(ZERO_GRAD):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


# ---------------------------------------------------------------------------
# train --subtask 2b end to end
# ---------------------------------------------------------------------------

def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg", "text": "نص",
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


TSVS = ("task2B_kevinmathew.tsv", "task2B_kevinmathew_probs_fold_0.tsv")
# (name, image flags, grayscale): the grayscale tiny ResNet at 64 pixels
# and a color ResNet-18 at 32.
RUNS_2B = [("grayscale", ["--image-arch", "tiny_resnet", "--image-size",
                          "64"], True),
           ("resnet18", ["--image-arch", "resnet18", "--image-size", "32"],
            False)]


@pytest.fixture(scope="module")
def jax_2b_runs(tmp_path_factory):
    """The JAX package's ``run_subtask_2b`` (fold 0, one epoch) for each of
    ``RUNS_2B`` on the manifests the port trains on."""
    root = tmp_path_factory.mktemp("jax2b")
    _write_manifest(root / "train.json", 40, 0)
    _write_manifest(root / "dev.json", 12, 1, off=1000)
    outs = {}
    for name, flags, gray in RUNS_2B:
        image = JImageEncoderConfig(arch=flags[1], image_size=int(flags[3]),
                                    grayscale=gray)
        cfg = JTrainConfig(
            model=JModelConfig(image=image), epochs=1,
            data=JDataConfig(train_manifest=str(root / "train.json"),
                             dev_manifest=str(root / "dev.json"),
                             cache_dir=str(root / ".cache")))
        outs[name] = root / f"jout_{name}"
        j_run_subtask_2b(cfg, out_dir=str(outs[name]), folds=[0])
    return root, outs


@pytest.mark.parametrize("name,flags,gray", RUNS_2B,
                         ids=[r[0] for r in RUNS_2B])
def test_train_2b_end_to_end_on_cpu(tmp_path, monkeypatch, jax_2b_runs,
                                    name, flags, gray):
    """The same TSV names, headers and ids and the same ``run_meta.json``
    as the JAX ``run_subtask_2b``; finite losses, no packing; ``predict --checkpoint``
    gives the best eval's probabilities.  The color run goes through the
    command line; the grayscale variant, which neither command line
    selects, through ``run_subtask_2b`` with the command line's config."""
    root, jouts = jax_2b_runs
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    argv = ["train", "--subtask", "2b", "-tr", str(root / "train.json"),
            "-te", str(root / "dev.json"), *flags, "--device", "cpu",
            "--fold", "0", "--epochs", "1", "--checkpoint-dir", "ck",
            "--out-dir", str(out)]
    if gray:
        cfg, device = train_config(build_parser().parse_args(argv))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, image=dataclasses.replace(cfg.model.image,
                                                 grayscale=True)))
        run_subtask_2b(cfg, device, out_dir=str(out), folds=[0])
    else:
        assert main(argv) == 0
    jout = jouts[name]
    assert sorted(p.name for p in out.glob("*.tsv")) == sorted(
        p.name for p in jout.glob("*.tsv")) == sorted(TSVS)
    for tsv in TSVS:
        got, want = _rows(out / tsv), _rows(jout / tsv)
        assert got[0] == want[0]                     # header
        assert [r[0] for r in got] == [r[0] for r in want]   # dev ids
        assert all(r[-1] == "kevinmathew_mpmc_tpu" for r in got[1:])
    assert check_format(str(out / TSVS[0]))
    with open(out / "run_meta.json") as f, open(jout / "run_meta.json") as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert meta["kind"] == "image" and meta["grayscale"] == gray
    assert meta["eval_transform_only"] == gray
    with open(out / "task2B_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert len(metrics["steps"]) == metrics["steps_per_epoch"] == 2
    assert metrics["row_budgets"] is None
    assert all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in metrics["steps"])
    assert main(["predict", "--subtask", "2b", "--manifest",
                 str(root / "dev.json"), "--checkpoint", "ck/fold_0",
                 "--out", "p.tsv", "--probs-out", "pp.tsv", "--device",
                 "cpu"]) == 0
    best = [float(r[2]) for r in _rows(out / TSVS[1])[1:]]
    again = [float(r[2]) for r in _rows("pp.tsv")[1:]]
    np.testing.assert_allclose(again, best, atol=1e-6, rtol=0)


def test_train_2b_refuses_what_is_not_ported(tmp_path):
    _write_manifest(tmp_path / "t.json", 20, 0)
    base = ["train", "--subtask", "2b", "-tr", str(tmp_path / "t.json"),
            "-te", str(tmp_path / "t.json"), "--image-arch", "tiny_resnet",
            "--image-size", "32", "--out-dir", str(tmp_path / "o"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="not ported yet"):
        main(base + ["--simclr-epochs", "1"])
    with pytest.raises(ValueError, match="no text encoder"):
        main(base + ["--text-params", "enc.npz"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            main(base[:-2])


# ---------------------------------------------------------------------------
# train --subtask 2c --vocab, and predict's run id, against the JAX CLI
# ---------------------------------------------------------------------------

def _vocab_file(path):
    """A WordPiece vocab that no corpus vocab of the manifests equals."""
    letters = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + [a + b for a in letters[:12] for b in letters[:12]]
              + ["##" + c for c in letters] + list(letters))
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")


def test_train_2c_trains_with_the_vocab_file(tmp_path, monkeypatch):
    """``--vocab V`` gives the 2C text branch V's tokens: the saved
    ``vocab.txt`` and the text vocab size in ``run_meta.json`` are the JAX
    command line's for the same flags (its fold loop skipped: the files
    are written before it)."""
    monkeypatch.chdir(tmp_path)
    _write_manifest(tmp_path / "train.json", 24, 0)
    _write_manifest(tmp_path / "dev.json", 8, 1, off=1000)
    _vocab_file(tmp_path / "V.txt")
    flags = ["train", "--subtask", "2c", "-tr", "train.json", "-te",
             "dev.json", "--tiny", "--vocab", "V.txt", "--fold", "0",
             "--epochs", "1", "--batch-size", "8"]
    monkeypatch.setattr(j_experiments, "_run_folds",
                        lambda *a, **k: j_experiments.SubtaskResult([], []))
    args = j_build_parser().parse_args(flags + ["--out-dir", "jout"])
    assert args.fn(args) == 0
    assert main(flags + ["--out-dir", "out", "--device", "cpu"]) == 0
    assert (tmp_path / "out" / "vocab.txt").read_bytes() == (
        tmp_path / "jout" / "vocab.txt").read_bytes()
    size = max(JWordPiece.from_file("V.txt").vocab.values()) + 1
    for d in ("out", "jout"):
        with open(tmp_path / d / "run_meta.json") as f:
            assert json.load(f)["model"]["text"]["vocab_size"] == size
    assert check_format(str(tmp_path / "out" / "task2C_kevinmathew.tsv"))


def test_predict_default_run_id_is_the_jax_one(tmp_path, monkeypatch):
    """Without ``--run-id`` the label and probability TSVs carry the JAX
    command line's run id, header and ids."""
    monkeypatch.chdir(tmp_path)
    _write_manifest(tmp_path / "m.json", 5, 2)
    flags = ["predict", "--subtask", "2b", "--image-arch", "tiny_resnet",
             "--image-size", "64", "--manifest", "m.json"]
    args = j_build_parser().parse_args(flags + ["--out", "j.tsv",
                                                "--probs-out", "jp.tsv"])
    assert args.fn(args) == 0
    assert main(flags + ["--out", "t.tsv", "--probs-out", "tp.tsv",
                         "--device", "cpu"]) == 0
    for mine, theirs in (("t.tsv", "j.tsv"), ("tp.tsv", "jp.tsv")):
        got, want = _rows(mine), _rows(theirs)
        assert got[0] == want[0]
        assert [(r[0], r[-1]) for r in got[1:]] == [
            (r[0], r[-1]) for r in want[1:]]
        assert all(r[-1] == "mpmc_tpu" for r in got[1:])
