"""The two readers of the port's single-step graph counters
(``graph.train.single``, ``graph.eval.single``) on a synthetic recording:
the share of steps or batches, and None without a trace, without the
counter (a port that has no single-step graphs), with the recorder empty
or without the port's recorder."""

import types

import pytest

from mpmc_tpu_torch.utils import profiling
from mpmc_tpu_torch.utils.profiling import SpanRecord
from portbench import spec

SPANS = [SpanRecord("mpmc.eval.run", 0, 10, None, {}, 0)]
COUNTS = {"graph.train.single": 23, "graph.eval.single": 4,
          "h2d.pageable_bytes": 100}


def _ctx(**kw):
    return dict(kw, trace=types.SimpleNamespace(window_s=10.0))


@pytest.fixture
def recording(monkeypatch):
    def use(spans, counts):
        monkeypatch.setattr(profiling, "recorded",
                            lambda: (list(spans), dict(counts)))
    return use


@pytest.mark.parametrize("metric,ctx,want", [
    ("single_graphed_pct.train", {"train_steps": 216}, 100.0 * 23 / 216),
    ("single_graphed_pct.predict", {"batches": 20}, 20.0),
])
def test_reader_gives_the_share_of_single_replays(recording, metric, ctx,
                                                  want):
    recording(SPANS, COUNTS)
    assert spec.metric_reader(metric)(_ctx(**ctx)) == pytest.approx(want)


CASES = [("single_graphed_pct.train", {"train_steps": 216},
          "graph.train.single"),
         ("single_graphed_pct.predict", {"batches": 20}, "graph.eval.single")]


@pytest.mark.parametrize("metric,ctx,counter", CASES)
def test_reader_is_none_without_a_trace_or_the_counter(recording, metric,
                                                       ctx, counter):
    read = spec.metric_reader(metric)
    recording(SPANS, COUNTS)
    assert read(dict(ctx)) is None
    recording(SPANS, {k: v for k, v in COUNTS.items() if k != counter})
    assert read(_ctx(**ctx)) is None
    recording([], {})
    assert read(_ctx(**ctx)) is None


@pytest.mark.parametrize("metric,ctx,counter", CASES)
def test_reader_is_none_where_the_port_has_no_recorder(monkeypatch, metric,
                                                       ctx, counter):
    monkeypatch.delattr(profiling, "recorded")
    assert spec.metric_reader(metric)(_ctx(**ctx)) is None


def test_both_readers_are_declared_for_the_cells_they_read():
    layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric, _, _ in CASES:
        entry = layer[metric]
        kind = metric.rsplit(".", 1)[1]
        assert entry["layer"] == "dispatch"
        assert entry["source"] == "program_counter"
        assert entry["workloads"] and all(c.startswith(kind)
                                          for c in entry["workloads"])
