"""Share of the traced requests' eval batches that ran as replays of a
graph of one batch: the port's ``graph.eval.single`` counter (the batches
outside a full group of K, each request's rest) over all batches."""

from portbench.spans import recorded


def read(ctx):
    got = recorded(ctx)
    batches = ctx.get("batches")
    if got is None or "graph.eval.single" not in got[1] or not batches:
        return None
    return 100.0 * got[1]["graph.eval.single"] / batches
