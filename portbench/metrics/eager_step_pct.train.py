"""Share of the traced fold's window spent in train steps run eagerly: the
port's ``mpmc.train.eager`` (single steps, the remainder of each eval
interval) and ``mpmc.train.warm`` (each graph's eager first group) spans."""

from portbench.spans import recorded, seconds


def read(ctx):
    got = recorded(ctx)
    if got is None or not ctx["trace"].window_s:
        return None
    spent = seconds(got[0], ("mpmc.train.eager", "mpmc.train.warm"))
    return None if spent is None else 100.0 * spent / ctx["trace"].window_s
