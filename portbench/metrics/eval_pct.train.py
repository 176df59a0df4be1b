"""Share of the traced fold's window spent in its evals: the port's
``mpmc.eval.run`` spans (``run_eval``, test and val splits, inside
``fit``)."""

from portbench.spans import recorded, seconds


def read(ctx):
    got = recorded(ctx)
    if got is None or not ctx["trace"].window_s:
        return None
    spent = seconds(got[0], ("mpmc.eval.run",))
    return None if spent is None else 100.0 * spent / ctx["trace"].window_s
