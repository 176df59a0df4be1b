"""Device kernels in the traced fold (its evals included) per train step."""


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("train_steps")
    if trace is None or not steps or not trace.kernels:
        return None
    return len(trace.kernels) / steps
