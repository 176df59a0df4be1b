"""Profiling and per-step timing (port of ``mpmc_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` (host
  activity, and the CUDA device's when one is present) that writes a Chrome
  trace under ``logdir``, viewable in TensorBoard or Perfetto;
* ``StepTimer``: a rolling step-time and throughput tracker (items/s, p50
  and p95 step ms) that the train loop reports from.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Dict, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``<logdir>/trace_<pid>_<ns>.json``
    (Chrome trace format).  Yields the ``torch.profiler.profile``."""
    import torch
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


class StepTimer:
    def __init__(self, window: int = 100):
        self.times: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self, n: int = 1) -> None:
        """Record one dispatch covering ``n`` optimizer steps (its wall time
        is spread evenly over them)."""
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) / max(n, 1)
            self.times.extend([dt] * max(n, 1))
        self._last = now

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        mean = sum(ts) / n
        return {
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": ts[n // 2] * 1e3,
            "step_ms_p95": ts[min(int(n * 0.95), n - 1)] * 1e3,
            "items_per_sec": batch_size / mean,
        }
