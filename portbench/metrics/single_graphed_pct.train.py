"""Share of the traced fold's train steps that ran as replays of a graph of
one step: the port's ``graph.train.single`` counter (the steps outside a
full group of K, each eval interval's rest) over all steps."""

from portbench.spans import recorded


def read(ctx):
    got = recorded(ctx)
    steps = ctx.get("train_steps")
    if got is None or "graph.train.single" not in got[1] or not steps:
        return None
    return 100.0 * got[1]["graph.train.single"] / steps
