"""The five readers of the port's spans and counters, on a synthetic
recording and window; each gives None without a trace or with the port's
recorder empty."""

import types

import pytest

from mpmc_tpu_torch.utils import profiling
from mpmc_tpu_torch.utils.profiling import SpanRecord
from portbench import spec

MS = 1_000_000

# A traced fold of 10 s: a 2 s build, a 300 ms eager warm group holding a
# 50 ms copy, a 1 s capture, a 100 ms eager step, two replays, two evals
# (400 and 600 ms) with a nested eager batch; a copy inside one replay.
FOLD = [("mpmc.fold.build", 0, 2000, None),
        ("mpmc.train.warm", 2000, 2300, None),
        ("mpmc.h2d", 2100, 2150, 1),
        ("mpmc.graph.capture", 2300, 3300, None),
        ("mpmc.train.replay", 3300, 3400, None),
        ("mpmc.train.eager", 3400, 3500, None),
        ("mpmc.eval.run", 3500, 3900, None),
        ("mpmc.eval.eager", 3600, 3700, 6),
        ("mpmc.train.replay", 3900, 4000, None),
        ("mpmc.h2d", 3910, 3930, 8),
        ("mpmc.eval.run", 4000, 4600, None)]

# Three traced requests: each copies 20 ms and 30 ms.
REQUESTS = [(name, 1000 * r + a, 1000 * r + b, None)
            for r in range(3)
            for name, a, b in (("mpmc.eval.run", 0, 500),
                               ("mpmc.h2d", 10, 30),
                               ("mpmc.h2d", 100, 130))]


def _records(rows):
    return [SpanRecord(n, s * MS, e * MS, p, {}, i)
            for i, (n, s, e, p) in enumerate(rows)]


def _ctx(window_s=10.0):
    return {"trace": types.SimpleNamespace(window_s=window_s)}


@pytest.fixture
def recording(monkeypatch):
    def use(rows, counts=None):
        monkeypatch.setattr(profiling, "recorded",
                            lambda: (_records(rows), dict(counts or {})))
    return use


@pytest.mark.parametrize("metric,rows,counts,want", [
    ("fold_setup_s.train", FOLD, None, 3.0),
    ("eager_step_pct.train", FOLD, None, 4.0),
    ("eval_pct.train", FOLD, None, 10.0),
    ("h2d_ms.predict", REQUESTS, None, 50.0),
    ("pageable_h2d_pct.predict", REQUESTS,
     {"h2d.pageable_bytes": 300, "h2d.pinned_bytes": 100}, 75.0),
])
def test_reader_on_a_synthetic_recording(recording, metric, rows, counts,
                                         want):
    recording(rows, counts)
    assert spec.metric_reader(metric)(_ctx()) == pytest.approx(want)


NAMES = ["fold_setup_s.train", "eager_step_pct.train", "eval_pct.train",
         "h2d_ms.predict", "pageable_h2d_pct.predict"]


@pytest.mark.parametrize("metric", NAMES)
def test_reader_is_none_with_the_recorder_empty_or_no_trace(recording,
                                                            metric):
    read = spec.metric_reader(metric)
    recording(FOLD + REQUESTS, {"h2d.pageable_bytes": 1})
    assert read({}) is None
    profiling.reset()
    recording([], {})
    assert read(_ctx()) is None


def test_reader_is_none_where_the_port_has_no_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    for metric in NAMES:
        assert spec.metric_reader(metric)(_ctx()) is None


def test_every_reader_is_declared_for_the_cells_it_reads():
    layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric in NAMES:
        cells = layer[metric]["workloads"]
        kind = metric.rsplit(".", 1)[1]
        assert cells and all(c.startswith(kind) for c in cells)
