"""Host time the training loop waited for its next batch, per batch got:
``fit``'s prefetch counters (``wait_s`` over ``gets``) of the traced fold."""


def read(ctx):
    gets = ctx.get("input_gets")
    return 1e3 * ctx["input_wait_s"] / gets if gets else None
