"""Share of the traced requests' eval batches that ran inside CUDA graph
replays: the grouped dispatch's replays times K over all batches."""


def read(ctx):
    batches = ctx.get("batches")
    return 100.0 * ctx["graphed_batches"] / batches if batches else None
