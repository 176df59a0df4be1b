"""The port's spans and counters (``utils/profiling.py``): nothing kept
and one shared no-op context while no profiler runs; under
``torch.profiler`` nesting, parents and the profiler's own clock; the spans
``fit`` and ``run_eval`` open at their boundaries, with tiny CPU stand-ins
for the steps; and the host-to-device byte counters."""

import types

import numpy as np
import pytest
import torch

from mpmc_tpu_torch.config import DataConfig, TrainConfig
from mpmc_tpu_torch.train import graphs
from mpmc_tpu_torch.train.graphs import GroupedSteps, make_scan_eval_step
from mpmc_tpu_torch.train.loop import fit, run_eval
from mpmc_tpu_torch.utils import profiling
from mpmc_tpu_torch.utils.profiling import (count, h2d, recorded, reset,
                                            span)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_recorder():
    reset()
    yield
    reset()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_off_span_is_one_shared_noop_and_records_nothing():
    assert not profiling.recording()
    a, b = span("mpmc.a"), span("mpmc.b", k=2)
    assert a is b and h2d([torch.ones(3)]) is a
    with a, b:
        count("h2d.pageable_bytes", 12)
    assert recorded() == ([], {})


def test_on_spans_nest_and_line_up_with_the_profilers_clock():
    with _profiled() as prof:
        with span("mpmc.outer", fold=3):
            with span("mpmc.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            with span("mpmc.second"):
                pass
        count("h2d.pinned_bytes", 5)
        count("h2d.pinned_bytes", 7)
    spans, counts = recorded()
    by = {s.name: s for s in spans}
    assert set(by) == {"mpmc.outer", "mpmc.inner", "mpmc.second"}
    outer = by["mpmc.outer"]
    assert outer.parent is None and outer.attrs == {"fold": 3}
    assert by["mpmc.inner"].parent == outer.sid
    assert by["mpmc.second"].parent == outer.sid
    for s in spans:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert counts == {"h2d.pinned_bytes": 12}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mpmc.")}
    assert set(events) == set(by)
    for name, s in by.items():
        assert abs(s.start_ns - events[name].start_ns()) < 1_000_000
    with span("mpmc.after"):
        pass
    assert len(recorded()[0]) == 3


class _Step:
    """A stand-in train step: a loss of 0.5, each batch kept."""

    def __init__(self):
        self.optimizer = types.SimpleNamespace(count=0)
        self.batches = []

    def __call__(self, batch):
        self.batches.append(batch)
        return {"loss": torch.tensor(0.5), "grad_norm": torch.tensor(1.0)}


def _eval_step(batch):
    p = torch.sigmoid(batch["x"][:, 0])
    return p, torch.zeros_like(p)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3)).astype(np.float32),
            "label": (rng.random(n) > 0.5).astype(np.int32)}


class _Graph:
    """``CapturedGraph`` on the CPU: replays run the captured function."""

    def __init__(self, fn, inputs, stream, pool=None, generators=(), *,
                 role):
        self.fn, self.role = fn, role

    def replay(self, values):
        return self.fn(values)


def test_fit_with_grouped_steps_records_warm_replay_eager_and_evals(
        monkeypatch):
    """Two epochs of 5 steps at K = 2 (groups 2, 2 and a single step): the
    first group warms, the other three replay; the first single step warms
    its one-step graph and the second replays it; an eval of 20 rows (3
    eager batches) ends each epoch."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(graphs, "warm", lambda stream, fn, *a: fn(*a))
    monkeypatch.setattr(graphs, "CapturedGraph", _Graph)
    step = _Step()
    grouped = GroupedSteps(step, 2, CPU)
    grouped.graphed = True
    cfg = TrainConfig(data=DataConfig(batch_size=8), epochs=2,
                      eval_per_epoch=1, scan_steps=2)
    with _profiled():
        res = fit(step, _eval_step, cfg, _data(40), CPU,
                  test_data=_data(20, 1), scan_train_step=grouped)
    assert len(res.steps) == 10 and len(res.history) == 2
    assert (grouped.replays, grouped.single_replays, grouped.captures) == (
        3, 1, 2)
    spans, counts = recorded()
    names = _names(spans)
    assert names["mpmc.train.warm"] == 2
    assert names["mpmc.train.replay"] == 4
    assert "mpmc.train.eager" not in names
    assert names["mpmc.eval.run"] == 2 and names["mpmc.eval.eager"] == 6
    assert names["mpmc.sync"] >= 2
    # Copies: the warm group's two steps, the warm single step and the six
    # eval batches (the stand-in replays copy nothing).
    assert names["mpmc.h2d"] == 9
    parent = {s.sid: s.name for s in spans}
    assert sorted(parent[s.parent] for s in spans
                  if s.name == "mpmc.h2d") == (
        ["mpmc.eval.eager"] * 6 + ["mpmc.train.warm"] * 3)
    assert {s.attrs["rows"] for s in spans if s.name == "mpmc.eval.run"} == {
        20}
    ks = sorted(s.attrs["k"] for s in spans
                if s.name in ("mpmc.train.warm", "mpmc.train.replay"))
    assert ks == [1, 1, 2, 2, 2, 2]
    assert counts["graph.train.single"] == 1
    assert counts["h2d.pinned_bytes"] == 0 and counts["h2d.pageable_bytes"]


@pytest.mark.parametrize("k", [1, 2])
def test_run_eval_host_fed_counts_every_batch_byte_as_pageable(k):
    """20 rows at batch 8: 3 batches of 8 rows of ``x`` and ``label``, at
    K = 2 one CPU group of 2 (``mpmc.eval.eager`` of the group) and 1
    eager batch."""
    data = _data(20)
    scan = make_scan_eval_step(_eval_step, k, CPU) if k > 1 else None
    with _profiled():
        res = run_eval(_eval_step, data, 8, CPU, scan_eval_step=scan)
    assert res.probs.shape == (20,)
    spans, counts = recorded()
    per_batch = 8 * (3 * 4 + 4)
    copies = [s for s in spans if s.name == "mpmc.h2d"]
    assert len(copies) == 3
    assert sum(s.attrs["bytes"] for s in copies) == 3 * per_batch
    assert counts == {"h2d.pageable_bytes": 3 * per_batch,
                      "h2d.pinned_bytes": 0}
    names = _names(spans)
    assert names["mpmc.eval.run"] == 1 and names["mpmc.sync"] == 1
    assert names["mpmc.eval.eager"] == (3 if k == 1 else 2)
    run = next(s for s in spans if s.name == "mpmc.eval.run")
    assert run.attrs == {"rows": 20}
    assert all(run.start_ns <= s.start_ns and s.end_ns <= run.end_ns
               for s in spans)


def test_h2d_sorts_cpu_sources_by_pinning_and_skips_device_ones(
        monkeypatch):
    pinned, pageable = torch.ones(4, 5), torch.ones(3, dtype=torch.int64)
    ptr = pinned.data_ptr()
    monkeypatch.setattr(torch.Tensor, "is_pinned",
                        lambda self: self.data_ptr() == ptr)
    on_device = torch.empty(100, device="meta")
    with _profiled():
        with h2d([pinned, pageable, on_device]):
            pass
    spans, counts = recorded()
    assert counts == {"h2d.pinned_bytes": 80, "h2d.pageable_bytes": 24}
    assert [(s.name, s.attrs) for s in spans] == [("mpmc.h2d",
                                                   {"bytes": 104})]
