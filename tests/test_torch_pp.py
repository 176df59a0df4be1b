"""Pipeline parallelism in the port (``parallel/pp.py``) on a gloo world of
two CPU processes (``torch_dist_cases.pp_cases``, run once for the file):
the GPipe forward and its gradients at S = 2 stages, M = 4 microbatches
against the JAX ``make_pp_forward`` on the conftest mesh; the pipelined
train step's gathered state and its restore; ``train --subtask 2a
--pipeline-stages 2`` end to end, whose ``model.pt`` ``predict
--checkpoint`` reads as it is; the split/merge round trip; the
microbatch-divisibility error.

Tolerances: f32 forwards within 1e-5; gradients within 1e-4 relative
(atol 1e-5)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPooling
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.models.classifier import TextClassifier as JTextClassifier
from mpmc_tpu.parallel import pp as jpp
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (MeshConfig, ModelConfig, PoolingType,
                                   TextEncoderConfig)
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.parallel.dist_worker import launch_processes
from mpmc_tpu_torch.parallel.pp import (merge_stage_params, microbatches,
                                        split_stage_params)

TESTS = os.path.dirname(os.path.abspath(__file__))
ENC = dict(vocab_size=100, hidden_size=32, num_layers=4, num_heads=4,
           intermediate_size=64, max_position_embeddings=64)
TSVS = ["task2A_kevinmathew.tsv", "task2A_kevinmathew_probs_fold_0.tsv",
        "task2A_kevinmathew_val_fold_0.tsv"]


def _inputs(batch=8, seq=16):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    for i in range(batch):              # every microbatch its own mask
        mask[i, 8 + (i % 8):] = 0
    return ids, mask


def _jax_model():
    mcfg = JModelConfig(text=JTextConfig(**ENC), pooling=JPooling.ATTENTION,
                        num_classes=2)
    ids, mask = _inputs()
    params = JTextClassifier(mcfg).init(jax.random.key(0), ids[:1],
                                        mask[:1])["params"]
    return mcfg, jax.tree_util.tree_map(np.asarray, params)


def port_config(**text):
    return ModelConfig(text=TextEncoderConfig(**{**ENC, **text}),
                       pooling=PoolingType.ATTENTION, num_classes=2)


def write_planted(path, n, seed, off=0):
    """Memes whose text carries its label in one word (a learnable 2A
    signal)."""
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    rows = []
    for i in range(n):
        y = rng.random() < 0.4
        words = ["".join(rng.choice(letters, int(rng.integers(2, 6))))
                 for _ in range(int(rng.integers(2, 10)))]
        words.insert(int(rng.integers(0, len(words) + 1)),
                     "كذبة" if y else "سلام")
        rows.append({"id": f"memes/img_{off + i}.jpg",
                     "img_path": f"memes/img_{off + i}.jpg",
                     "text": " ".join(words),
                     "class_label": "propaganda" if y else "not_propaganda"})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def driver_argv(work, flags):
    return ["train", "--subtask", "2a", "-tr", str(work / "train.json"),
            "-te", str(work / "dev.json"), "--small", "--device", "cpu",
            "--fold", "0", "--epochs", "3", "--num-folds", "2", "--lr",
            "1e-3", "--scan-steps", "2", "--out-dir", str(work / "out"),
            "--checkpoint-dir", str(work / "ck"),
            "--cache-dir", str(work / "cache"), *flags]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp")
    _, params = _jax_model()
    ids, mask = _inputs()
    case = str(work / "case.pt")
    torch.save({"state": from_jax_variables(params), "mcfg": port_config(),
                "ids": ids, "mask": mask}, case)
    write_planted(work / "train.json", 48, 0)
    write_planted(work / "dev.json", 16, 1, off=100)
    argv = driver_argv(work, ["--pipeline-stages", "2",
                              "--pp-microbatches", "4"])
    lines = launch_processes(2, target="torch_dist_cases:pp_cases",
                             kwargs={"case": case, "out": str(work / "r"),
                                     "argv": argv},
                             env={"PYTHONPATH": TESTS}, timeout=240,
                             device="cpu")
    return work, [torch.load(line["result"], weights_only=False)
                  for line in lines]


def test_pp_forward_and_grads_match_jax(ranks):
    _, res = ranks
    mcfg, params = _jax_model()
    ids, mask = _inputs()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "stage"))
    rest, stages = jpp.split_stage_params(params, 2)
    rest, stages = jpp.place_pp_params(rest, stages, mesh)
    fwd = jpp.make_pp_forward(mcfg, mesh, 2, 4)
    want = np.asarray(jax.jit(fwd)(rest, stages, ids, mask))
    g_rest, g_stages = jax.jit(jax.grad(
        lambda r, s: fwd(r, s, ids, mask).sum(), argnums=(0, 1)))(
            rest, stages)
    g_want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, jpp.merge_stage_params(jax.device_get(g_rest),
                                           jax.device_get(g_stages))))
    for r in res:
        np.testing.assert_allclose(r["logits"], want, atol=1e-5, rtol=0)
        assert set(r["grads"]) <= set(g_want)
        for name, g in g_want.items():
            got = r["grads"].get(name)
            if got is None:             # unused: the encoder's pooler
                assert not g.numpy().any(), name
                continue
            np.testing.assert_allclose(got, g.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    # Each rank holds its stage's two layers alone.
    assert {n.split(".")[1] for n in res[0]["sharded_params"]} == {
        "layer_0", "layer_1"}
    assert {n.split(".")[1] for n in res[1]["sharded_params"]} == {
        "layer_2", "layer_3"}


def test_pp_state_is_the_plain_one_and_restores(ranks):
    _, res = ranks
    plain = build_model(port_config(), torch.device("meta"), kind="text")
    for r in res:
        assert r["restored"]
        assert r["full_keys"] == sorted(plain.state_dict())
        assert r["opt_keys"] == sorted(n for n, _ in
                                       plain.named_parameters())


def test_pp_driver_learns_and_predict_reads_its_checkpoint(ranks, tmp_path,
                                                           monkeypatch):
    work, res = ranks
    assert [r["rc"] for r in res] == [0, 0]
    out = work / "out"
    assert sorted(p for p in os.listdir(out) if p.endswith(".tsv")) == TSVS
    with open(out / "task2A_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert max(e["test_f1"] for e in metrics["evals"]) > 0.8
    rows = [line.rstrip("\n").split("\t") for line in
            open(out / "task2A_kevinmathew_val_fold_0.tsv")][1:]
    records = {}
    for name in ("train.json", "dev.json"):
        with open(work / name, encoding="utf-8") as f:
            records.update({r["id"]: r for r in json.load(f)})
    monkeypatch.chdir(tmp_path)
    with open("val.json", "w", encoding="utf-8") as f:
        json.dump([records[r[0]] for r in rows], f, ensure_ascii=False)
    assert main(["predict", "--subtask", "2a", "--manifest", "val.json",
                 "--checkpoint", str(work / "ck" / "fold_0"), "--out",
                 "p.tsv", "--probs-out", "pp.tsv", "--device", "cpu"]) == 0
    again = [line.rstrip("\n").split("\t") for line in open("pp.tsv")][1:]
    assert [r[0] for r in again] == [r[0] for r in rows]
    np.testing.assert_allclose([float(r[2]) for r in again],
                               [float(r[2]) for r in rows], atol=1e-5,
                               rtol=0)


def test_split_merge_round_trip_follows_the_jax_stages():
    model = build_model(port_config(num_layers=8), torch.device("cpu"),
                        seed=0, kind="text")
    sd = model.state_dict()
    rest, stages = split_stage_params(sd, 4)
    assert [sorted({n.split(".")[1] for n in s}) for s in stages] == [
        [f"layer_{2 * s}", f"layer_{2 * s + 1}"] for s in range(4)]
    merged = merge_stage_params(rest, stages)
    assert list(merged) == list(sd)
    assert all(merged[k] is sd[k] for k in sd)
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        split_stage_params(sd, 3)


def test_pp_microbatch_divisibility_error():
    mesh = MeshConfig(num_stage_shards=2, pp_microbatches=5)
    with pytest.raises(ValueError, match="pipeline microbatches=5"):
        microbatches(mesh, 16)
    assert microbatches(MeshConfig(num_stage_shards=2), 16) == 8
