"""The port's 2C ``predict`` end to end on the CPU, against the JAX
package's ``run_eval`` on the same data and weights; the port's import
isolation; its entry points' default device."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import (_init_and_steps, build_tokenizer,
                                      corpus_wordpiece_vocab, prepare_images,
                                      prepare_text)
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.config import model_config_to_dict
from mpmc_tpu.io.manifest import read_manifest as j_read_manifest
from mpmc_tpu.models import MultimodalClassifier as JClassifier
from mpmc_tpu.models.captioner import precompute_captions as j_captions
from mpmc_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from mpmc_tpu.train.loop import run_eval as j_run_eval
from mpmc_tpu_torch.cli.main import build_parser, main
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models.convert import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_manifest(path, n):
    rows = [{"id": f"d/img_{i}.png", "img_path": f"d/img_{i}.png",
             "text": ("كلمة نص دعاية مهم جدا" if i % 3 == 0
                      else f"نص عادي يومي رقم {i} هنا")} for i in range(n)]
    with open(path, "w") as f:
        json.dump(rows, f)


def _read_probs(path):
    with open(path) as f:
        next(f)
        return np.array([float(line.split("\t")[2]) for line in f])


def test_predict_cpu_matches_jax_run_eval(tmp_path, monkeypatch):
    """JAX tiny_2c weights (BatchNorm statistics from a numpy seed) carried
    into a port checkpoint; the port's predict --device cpu reproduces the
    JAX run_eval probs in f32 (21 memes at batch 8: the last batch is
    padded by replicating rows and trimmed)."""
    monkeypatch.chdir(tmp_path)           # caption caches land in .cache
    manifest_path = str(tmp_path / "m.json")
    _write_manifest(manifest_path, 21)
    manifest = j_read_manifest(manifest_path, is_test=True)
    caps = j_captions(manifest.img_paths, None, cache_dir=str(tmp_path / "j"))
    vocab = corpus_wordpiece_vocab(manifest.texts)
    cap_vocab = corpus_wordpiece_vocab(caps)
    base = JModelConfig.tiny_2c()
    mcfg = dataclasses.replace(
        base, text=dataclasses.replace(base.text, vocab_size=len(vocab)),
        caption=dataclasses.replace(base.caption, vocab_size=len(cap_vocab)))

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    JWordPiece(vocab).save(str(ckpt / "vocab.txt"))
    JWordPiece(cap_vocab).save(str(ckpt / "caption_vocab.txt"))
    tok = build_tokenizer(manifest.texts, str(ckpt / "vocab.txt"))
    cap_tok = build_tokenizer(caps, str(ckpt / "caption_vocab.txt"))
    data = {}
    data["text_ids"], data["text_mask"] = prepare_text(manifest, tok, 32)
    data["image"] = prepare_images(manifest, str(tmp_path), 64)
    data["caption_ids"], data["caption_mask"] = cap_tok.encode_batch(caps, 16)

    cfg = JTrainConfig(model=mcfg, data=JDataConfig(batch_size=8), bf16=False)
    model = JClassifier(mcfg)
    dummy = dict(data, label=np.zeros(len(manifest), np.int32))
    state, _, eval_step, _, _, _ = _init_and_steps(model, cfg, dummy,
                                                   "multimodal", augment=True)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.5, x.shape)).astype(np.float32),
        jax.device_get(state.batch_stats))
    state = state.replace(batch_stats=stats)
    want = j_run_eval(state, eval_step, data, 8).probs

    torch.save(from_jax_variables(jax.device_get(state.params), stats),
               str(ckpt / "model.pt"))
    with open(ckpt / "run_meta.json", "w") as f:
        json.dump({"kind": "multimodal", "model": model_config_to_dict(mcfg),
                   "augment": True, "grayscale": False, "text_len": 32,
                   "caption_len": 16}, f)
    out, probs_out = str(tmp_path / "pred.tsv"), str(tmp_path / "probs.tsv")
    assert main(["predict", "--subtask", "2c", "--manifest", manifest_path,
                 "--out", out, "--probs-out", probs_out, "--checkpoint",
                 str(ckpt), "--image-root", str(tmp_path), "--batch-size",
                 "8", "--device", "cpu"]) == 0
    got = _read_probs(probs_out)
    assert got.shape == (21,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert check_format(out)


def test_predict_checkpoint_needs_its_vocab(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    manifest_path = str(tmp_path / "m.json")
    _write_manifest(manifest_path, 3)
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(SystemExit, match="vocab"):
        main(["predict", "--subtask", "2c", "--tiny", "--manifest",
              manifest_path, "--out", str(tmp_path / "p.tsv"),
              "--checkpoint", str(tmp_path / "ckpt"), "--device", "cpu"])


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter
    (this test process has JAX loaded already); importing them loads no
    sklearn, transformers or safetensors either (a GPU host need not have
    any of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpmc_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(mpmc_tpu_torch.__path__,"
        " 'mpmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mpmc_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('models.captioner', 'train.checkpoint', "
        "'train.trainer', 'text.wordpiece_learn', 'train.distill', "
        "'baselines.classic', 'baselines.extract_features', "
        "'models.hf_convert', 'models.vision_convert'):\n"
        "    assert 'mpmc_tpu_torch.' + m in sys.modules, m\n"
        "host_only = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('sklearn', 'transformers', 'safetensors'))\n"
        "assert not host_only, host_only\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('mpmc_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    # Imports inside functions never run above: read the sources too.
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"orbax|mpmc_tpu)(\.|\s|$)", re.M)
    sources = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                               "attention_f32_compare.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mpmc_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path,
                                                           monkeypatch):
    args = build_parser().parse_args(["predict", "--subtask", "2c",
                                      "--manifest", "m", "--out", "o"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    manifest_path = str(tmp_path / "m.json")
    _write_manifest(manifest_path, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["predict", "--subtask", "2c", "--tiny", "--manifest",
              manifest_path, "--out", str(tmp_path / "p.tsv")])
    assert not (tmp_path / "p.tsv").exists()
    train = ["train", "--subtask", "2c", "-tr", manifest_path, "-te",
             manifest_path, "--tiny", "--out-dir", str(tmp_path / "out")]
    assert build_parser().parse_args(train).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(train)
    assert not (tmp_path / "out").exists()
    # Flags the port does not take are refused, not ignored.
    with pytest.raises(SystemExit):
        build_parser().parse_args(train + ["--scan-steps", "8"])
