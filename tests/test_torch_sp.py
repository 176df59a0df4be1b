"""Sequence parallelism in the port (``ring_attention``,
``ulysses_attention``, ``parallel/sp.py``) on a gloo world of four CPU
processes (``torch_dist_cases.sp_cases``, run once for the file): ring
attention over 4 ranks and Ulysses over 4 and over the 2-rank ``seq``
groups of a ``(data 2, seq 2)`` mesh (H = 4), forward and gradients,
against the JAX ``dot_product_attention(impl="ring:seq"|"ulysses:seq")``
under ``shard_map`` on the conftest mesh, with a ragged padding mask;
``make_sp_forward`` against JAX's; ``train --subtask 2a --seq-shards 2``
on that world (data 2 x seq 2), which learns and writes the plain run's
TSV set, whose ``model.pt`` ``predict`` reads as it is.

Tolerances: f32 forwards within 1e-5; gradients within 1e-4 relative
(atol 1e-5)."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPooling
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.models.classifier import TextClassifier as JTextClassifier
from mpmc_tpu.ops.attention import dot_product_attention as j_attention
from mpmc_tpu.parallel import sp as jsp
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.ops.attention import dot_product_attention
from mpmc_tpu_torch.parallel.dist_worker import launch_processes
from test_torch_pp import (ENC, TSVS, driver_argv, port_config,
                           write_planted)
from torch_dist_cases import _qkvm

TESTS = os.path.dirname(os.path.abspath(__file__))


def _text_inputs(batch=4, seq=16):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    for i in range(batch):
        mask[i, 10 + (i % 6):] = 0
    return ids, mask


def _jax_text():
    mcfg = JModelConfig(text=JTextConfig(**ENC), pooling=JPooling.ATTENTION,
                        num_classes=2)
    ids, mask = _text_inputs()
    params = JTextClassifier(mcfg).init(jax.random.key(0), ids[:1],
                                        mask[:1])["params"]
    return mcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp")
    _, params = _jax_text()
    ids, mask = _text_inputs()
    case = str(work / "case.pt")
    torch.save({"state": from_jax_variables(params), "mcfg": port_config(),
                "ids": ids, "mask": mask}, case)
    write_planted(work / "train.json", 48, 0)
    write_planted(work / "dev.json", 16, 1, off=100)
    argv = driver_argv(work, ["--seq-shards", "2"])
    lines = launch_processes(4, target="torch_dist_cases:sp_cases",
                             kwargs={"case": case, "out": str(work / "r"),
                                     "argv": argv},
                             env={"PYTHONPATH": TESTS}, timeout=240,
                             device="cpu")
    return work, [torch.load(line["result"], weights_only=False)
                  for line in lines]


def _jax_sp(impl, seq):
    """JAX's SP attention on a 1 x ``seq`` mesh: out and the gradients of
    ``sum(out * w)``."""
    q, k, v, mask, w = _qkvm()
    mesh = Mesh(np.array(jax.devices()[:seq]).reshape(1, seq),
                ("data", "seq"))
    spec = P(None, "seq")
    fn = jax.shard_map(functools.partial(j_attention, impl=f"{impl}:seq"),
                       mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)
    out = jax.jit(fn)(q, k, v, mask)
    grads = jax.jit(jax.grad(lambda q, k, v: (fn(q, k, v, mask) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("impl,seq", [("ring", 4), ("ulysses", 4),
                                      ("ulysses", 2)])
def test_sp_attention_matches_jax(ranks, impl, seq):
    _, res = ranks
    want = _jax_sp(impl, seq)
    for r in res:
        got = r[f"{impl}{seq}"]
        np.testing.assert_allclose(got["out"], want[0], atol=1e-5, rtol=0)
        for name, w in zip(("dq", "dk", "dv"), want[1:]):
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{impl}{seq} {name}")


def test_sp_attention_matches_the_plain_attention(ranks):
    """The gathered SP outputs are the one-process attention's."""
    _, res = ranks
    q, k, v, mask, _ = _qkvm()
    plain = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(mask)).numpy()
    for key in ("ring4", "ulysses4", "ulysses2"):
        np.testing.assert_allclose(res[0][key]["out"], plain, atol=1e-5,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_make_sp_forward_matches_jax(ranks, impl):
    _, res = ranks
    mcfg, params = _jax_text()
    ids, mask = _text_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))
    fwd = jsp.make_sp_forward(mcfg, mesh, impl=impl)
    want = np.asarray(jax.jit(fwd)(jsp.place_sp_params(params, mesh), ids,
                                   mask))
    for r in res:
        np.testing.assert_allclose(r["forward"][impl], want, atol=1e-5,
                                   rtol=0)


def test_sp_driver_learns_and_writes_the_plain_tsvs(ranks, tmp_path,
                                                    monkeypatch):
    work, res = ranks
    assert [r["rc"] for r in res] == [0] * 4
    out = work / "out"
    assert sorted(p for p in os.listdir(out) if p.endswith(".tsv")) == TSVS
    with open(out / "task2A_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert max(e["test_f1"] for e in metrics["evals"]) > 0.8
    # The checkpoint is the plain model's: predict reproduces the val TSV.
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
    np.testing.assert_allclose([float(r[2]) for r in again],
                               [float(r[2]) for r in rows], atol=1e-5,
                               rtol=0)


def test_sp_refuses_segments_and_unknown_impls():
    from mpmc_tpu_torch.parallel.sp import make_sp_stack
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="segment packing"):
        dot_product_attention(q, q, q, segments=torch.ones(1, 4),
                              impl="ring")
    with pytest.raises(ValueError, match="unknown SP impl"):
        make_sp_stack(None, "nope")
