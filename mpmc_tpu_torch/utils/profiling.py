"""Profiling (port of ``mpmc_tpu/utils/profiling.py``) and the port's own
spans and counters.

* ``trace(logdir)``: a context manager around ``torch.profiler`` (host
  activity, and the CUDA device's when one is present) that writes a Chrome
  trace under ``logdir``, viewable in TensorBoard or Perfetto;
* ``span(name, **attrs)``, ``count(name, n)`` and :func:`h2d`: the spans
  and counters at the port's layer boundaries (the ``mpmc.*`` names), kept
  in memory while a torch profiler is active on the calling thread
  (``trace``, or any other ``torch.profiler.profile``) and costing one C
  call each otherwise;
  :func:`recorded` returns them and :func:`reset` clears them.

A span opens ``torch.profiler.record_function(name)``, so it lands in the
profiler's own trace as a ``user_annotation``, and records ``(name,
start_ns, end_ns, parent, attrs, sid)`` with ``time.time_ns()``, the clock
the profiler's events are on, read around that range; ``parent`` is the
``sid`` of the innermost span open on the same thread (None at the top).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

# True while a torch profiler is active on the calling thread: the gate
# every span and count checks before it reads a clock or touches
# ``record_function``.
recording = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``<logdir>/trace_<pid>_<ns>.json``
    (Chrome trace format).  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                    f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    attrs: Dict[str, object]
    sid: int


_spans: List[SpanRecord] = []
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    """One open span: its ``record_function`` and its place on the
    thread's stack of open spans."""

    __slots__ = ("name", "attrs", "sid", "parent", "start", "rf")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.sid = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.sid)
        self.start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        _spans.append(SpanRecord(self.name, self.start, end, self.parent,
                                 self.attrs, self.sid))
        return False


def span(name: str, **attrs):
    """A context manager timing the block as span ``name`` while a
    profiler is active; otherwise one shared no-op context."""
    if not recording():
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler is active."""
    if not recording():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def h2d(tensors: Iterable[torch.Tensor]):
    """The ``mpmc.h2d`` span of a copy of ``tensors`` to the device, its
    ``bytes`` those of the CPU tensors among them, each counted into
    ``h2d.pinned_bytes`` or ``h2d.pageable_bytes`` by ``is_pinned()``."""
    if not recording():
        return _OFF
    pinned = pageable = 0
    for t in tensors:
        if t.device.type == "cpu":
            n = t.numel() * t.element_size()
            if t.is_pinned():
                pinned += n
            else:
                pageable += n
    count("h2d.pinned_bytes", pinned)
    count("h2d.pageable_bytes", pageable)
    return _Span("mpmc.h2d", {"bytes": pinned + pageable})


def recorded() -> Tuple[List[SpanRecord], Dict[str, int]]:
    """The spans closed and the counts made since the last :func:`reset`
    (copies)."""
    with _lock:
        return list(_spans), dict(_counts)


def reset() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()
