"""The port's ``predict`` for the text (2A), image (2B) and simple (2C
``--simple``) kinds end to end on the CPU, against the JAX package's own
``predict`` on the same manifest and weights.

The JAX command runs with the variant flags and no checkpoint, in f32; its
random weights (BatchNorm statistics drawn from a numpy seed) are carried
into a port checkpoint.  The port then reproduces its probabilities within
1e-5 twice: from a checkpoint with ``run_meta.json`` (the variant comes
from the file) and from one without (the variant comes from the same
flags).  Without a checkpoint the port resolves the same variant and the
same input arrays as the JAX command."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mpmc_tpu.cli import experiments as j_experiments
from mpmc_tpu.cli.experiments import corpus_wordpiece_vocab
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.config import model_config_to_dict as j_config_to_dict
from mpmc_tpu.io.manifest import read_manifest as j_read_manifest
from mpmc_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from mpmc_tpu_torch.cli.main import build_parser, main, prepare_inputs
from mpmc_tpu_torch.config import model_config_to_dict
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models.convert import from_jax_variables

TOL = 1e-5
N_MEMES = 21          # at batch 8 the last batch replicates rows
FLAGS = {
    "2a": ["--subtask", "2a", "--small"],
    "2b": ["--subtask", "2b", "--image-arch", "tiny_resnet",
           "--image-size", "64", "--binary-head"],
    # The distilbert-multilingual text branch at full width (6 x 768) over
    # a corpus vocab, beside the tiny ResNet with its 1000-logit head.
    "simple": ["--subtask", "2c", "--simple", "--image-arch", "tiny_resnet",
               "--image-size", "64"],
}


def _write_manifest(path, n):
    rows = [{"id": f"d/img_{i}.png", "img_path": f"d/img_{i}.png",
             "text": ("كلمة نص دعاية مهم جدا" if i % 3 == 0
                      else " ".join(["نص عادي يومي"] * (1 + i % 5))
                      + f" رقم {i}")} for i in range(n)]
    with open(path, "w") as f:
        json.dump(rows, f, ensure_ascii=False)


def _read_probs(path):
    with open(path) as f:
        next(f)
        return np.array([float(line.split("\t")[2]) for line in f])


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape)
                         if path[-1].key == "var"
                         else rng.normal(0.0, 0.5, x.shape)).astype(np.float32),
        jax.device_get(stats))


@pytest.fixture(scope="module", params=sorted(FLAGS))
def jax_run(request, tmp_path_factory):
    """The JAX package's predict for one kind (f32, no checkpoint), with
    what it resolved: model, kind, input arrays, weights."""
    case = request.param
    work = tmp_path_factory.mktemp(f"predict_{case}")
    manifest = str(work / "m.json")
    _write_manifest(manifest, N_MEMES)
    seen = {}
    init_and_steps = j_experiments._init_and_steps

    def capture(model, cfg, data, kind, **kw):
        cfg = dataclasses.replace(cfg, bf16=False)
        state, *rest = init_and_steps(model, cfg, data, kind, **kw)
        stats = state.batch_stats
        if jax.tree_util.tree_leaves(stats):
            stats = _random_stats(stats, 0)
            state = state.replace(batch_stats=stats)
        seen.update(model=model, kind=kind, data=data, state=state)
        return (state, *rest)

    probs_out = str(work / "jax_probs.tsv")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_experiments, "_init_and_steps", capture)
        mp.chdir(work)                       # caption caches land in .cache
        args = j_build_parser().parse_args(
            ["predict", *FLAGS[case], "--manifest", manifest, "--out",
             str(work / "jax.tsv"), "--probs-out", probs_out,
             "--image-root", str(work), "--batch-size", "8"])
        assert args.fn(args) == 0
    return dict(case=case, work=work, manifest=manifest, probs=probs_out,
                **seen)


def _checkpoint(run, name, with_meta):
    """The JAX run's weights as a port checkpoint with the corpus vocab the
    JAX command built, and (``with_meta``) the run_meta.json that training
    would write."""
    ck = run["work"] / name
    ck.mkdir()
    state = run["state"]
    torch.save(from_jax_variables(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats) or None),
               str(ck / "model.pt"))
    texts = j_read_manifest(run["manifest"], is_test=True).texts
    JWordPiece(corpus_wordpiece_vocab(texts)).save(str(ck / "vocab.txt"))
    if with_meta:
        data = run["data"]
        with open(ck / "run_meta.json", "w") as f:
            json.dump({
                "kind": run["kind"],
                "model": j_config_to_dict(run["model"].cfg),
                "augment": run["kind"] != "text",
                "grayscale": False,
                "eval_transform_only": run["kind"] == "simple",
                "binary_head": getattr(run["model"], "binary_head", False),
                "text_len": (data["text_ids"].shape[1]
                             if "text_ids" in data else None),
                "caption_len": None}, f)
    return str(ck)


def _port_predict(run, argv):
    out = str(run["work"] / "port.tsv")
    probs_out = str(run["work"] / "port_probs.tsv")
    assert main(["predict", *argv, "--manifest", run["manifest"], "--out",
                 out, "--probs-out", probs_out, "--image-root",
                 str(run["work"]), "--batch-size", "8", "--device",
                 "cpu"]) == 0
    assert check_format(out)
    return _read_probs(probs_out)


@pytest.mark.parametrize("with_meta", [True, False],
                         ids=["run_meta", "flags"])
def test_predict_checkpoint_matches_jax_predict(jax_run, with_meta,
                                                monkeypatch):
    monkeypatch.chdir(jax_run["work"])
    ck = _checkpoint(jax_run, f"ck_{with_meta}", with_meta)
    subtask = FLAGS[jax_run["case"]][:2]
    argv = subtask if with_meta else FLAGS[jax_run["case"]]
    got = _port_predict(jax_run, argv + ["--checkpoint", ck])
    want = _read_probs(jax_run["probs"])
    assert got.shape == want.shape == (N_MEMES,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_predict_without_checkpoint_resolves_the_jax_variant(jax_run,
                                                             monkeypatch):
    """The same config, kind and input arrays (no image decode for 2A, no
    captions for the simple model) as the JAX command; random weights."""
    monkeypatch.chdir(jax_run["work"])
    args = build_parser().parse_args(
        ["predict", *FLAGS[jax_run["case"]], "--manifest",
         jax_run["manifest"], "--out", "x", "--image-root",
         str(jax_run["work"])])
    inputs = prepare_inputs(args)
    assert inputs.variant.kind == jax_run["kind"]
    assert (model_config_to_dict(inputs.variant.model_cfg)
            == j_config_to_dict(jax_run["model"].cfg))
    want = {k: v for k, v in jax_run["data"].items() if k != "label"}
    assert sorted(inputs.data) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(inputs.data[key], value)
    probs = _port_predict(jax_run, FLAGS[jax_run["case"]])
    assert probs.shape == (N_MEMES,) and np.all((probs >= 0) & (probs <= 1))
