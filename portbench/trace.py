"""A ``torch.profiler`` trace of part of a run, read into what the per-layer
metrics and the ``breakdown`` need: each device operation (kernels,
copies, sets) with its start and length, the host operations, the device's
busy time (the union of its operations), the longest idle gaps and what
the host was doing in each."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


def _kind(e) -> str:
    """The event's activity kind; PyTorch releases without
    ``activity_type`` tell device events by their device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "cpu_op"
    if getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """``start()`` and ``stop()`` around the traced part; then ``kernels``
    (name, ns), ``busy_s``, ``window_s`` and :meth:`breakdown`."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0

    def start(self) -> None:
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self._read()

    def _read(self) -> None:
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            kind = _kind(e)
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind in DEVICE_KINDS:
                device.append((start, end, e.name(), kind))
            elif kind in HOST_KINDS:
                host.append((start, end, e.name()))
        self.device = device
        self.host = sorted(host)
        self.kernels = [(n, s, t) for s, t, n, k in device if k == "kernel"]
        self.spans = _union([(s, t) for s, t, _, _ in device])
        self.busy_s = sum(t - s for s, t in self.spans) * 1e-9
        del self.prof

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of
        ``patterns``."""
        return 1e-9 * sum(t - s for n, s, t in self.kernels
                          if any(p in n for p in patterns))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, int] = {}
        for s, t, n, _ in self.device:
            by_name[n] = by_name.get(n, 0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo = min([s for s, _, _ in self.host] + [s for s, _ in self.spans])
        hi = max([t for _, t, _ in self.host] + [t for _, t in self.spans])
        edges = [lo] + [x for span in self.spans for x in span] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return {"device_ops": [[n[:160], v * 1e-9] for n, v in ops],
                "idle_gaps": [[self._host_at(s, t), d * 1e-9]
                              for d, s, t in gaps]}

    def _host_at(self, s: int, t: int) -> str:
        """The host operation that overlaps the gap ``[s, t)`` the most
        (the shorter one on a tie), or ``idle host``."""
        best, key = "idle host", (0, 0)
        for hs, ht, name in self.host:
            if hs >= t:
                break
            overlap = min(ht, t) - max(hs, s)
            if overlap > 0 and (overlap, -(ht - hs)) > key:
                best, key = name, (overlap, -(ht - hs))
        return best[:160]
