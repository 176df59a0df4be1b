"""What the port's own spans and counters (``mpmc_tpu_torch.utils.profiling``)
recorded, for the per-layer metrics that read them.  The port records only
while a profiler runs, so after a traced run its recorder holds exactly the
traced part (the traced fold, or the traced requests): never set-up, the
untraced folds or the reference.  A port without the recorder, or a run
without a trace, gives nothing."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.trace import _union


def recorded(ctx: dict) -> Optional[tuple]:
    """``(spans, counts)`` of the traced part of the run, or None without a
    trace, without the port's recorder, or when it recorded nothing."""
    if ctx.get("trace") is None:
        return None
    try:
        from mpmc_tpu_torch.utils.profiling import recorded as port_recorded
    except ImportError:
        return None
    spans, counts = port_recorded()
    return (spans, counts) if spans or counts else None


def seconds(spans, names: Iterable[str]) -> Optional[float]:
    """Seconds covered by the spans named ``names`` (the union of their
    intervals, so a nested one counts once), or None without one."""
    names = set(names)
    found = [(s.start_ns, s.end_ns) for s in spans if s.name in names]
    if not found:
        return None
    return 1e-9 * sum(e - s for s, e in _union(found))
