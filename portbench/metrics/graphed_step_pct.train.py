"""Share of the traced fold's train steps that ran inside CUDA graph
replays: the grouped dispatch's replays times K over all steps."""


def read(ctx):
    steps = ctx.get("train_steps")
    return 100.0 * ctx["graphed_steps"] / steps if steps else None
