"""Share of the bytes the traced requests copied to the device from
pageable host memory: the port's ``h2d.pageable_bytes`` over it and
``h2d.pinned_bytes``, counted at the copies the ``mpmc.h2d`` spans time."""

from portbench.spans import recorded


def read(ctx):
    got = recorded(ctx)
    if got is None:
        return None
    counts = got[1]
    pageable = counts.get("h2d.pageable_bytes", 0)
    total = pageable + counts.get("h2d.pinned_bytes", 0)
    return 100.0 * pageable / total if total else None
