"""Model FLOPs the traced work needs (``portbench/counts/flops.py``: each
meme's own tokens, forward, and backward for trained memes) over the traced
window's seconds, as a share of the chip's bf16 dense peak."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.window_s or not ctx.get("flops"):
        return None
    rate = ctx["flops"] / trace.window_s
    return 100.0 * rate / ctx["peaks"]["bf16_flops_per_s"]
