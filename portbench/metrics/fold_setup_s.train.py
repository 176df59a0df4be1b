"""Seconds of the traced fold spent building it and capturing its graphs:
the port's ``mpmc.fold.build`` (``build_fold``) and ``mpmc.graph.capture``
(each CUDA graph's static inputs, capture and instantiation) spans."""

from portbench.spans import recorded, seconds


def read(ctx):
    got = recorded(ctx)
    if got is None:
        return None
    return seconds(got[0], ("mpmc.fold.build", "mpmc.graph.capture"))
