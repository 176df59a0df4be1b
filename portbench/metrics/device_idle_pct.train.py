"""Share of the traced window in which no kernel, copy or set ran on the
device: 1 - (the union of their intervals) / window, from the profiler."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.window_s or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
