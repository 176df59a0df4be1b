"""Host milliseconds a traced request spent copying its batches to the
device: the port's ``mpmc.h2d`` spans (``run_eval``'s eager batches and
each graph replay's input copies) over its ``mpmc.eval.run`` spans, one a
request."""

from portbench.spans import recorded, seconds


def read(ctx):
    got = recorded(ctx)
    if got is None:
        return None
    requests = sum(1 for s in got[0] if s.name == "mpmc.eval.run")
    spent = seconds(got[0], ("mpmc.h2d",))
    if not requests or spent is None:
        return None
    return 1e3 * spent / requests
