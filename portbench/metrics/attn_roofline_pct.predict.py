"""The attention the traced work needs (``portbench/counts/attention.py``:
each sequence over its own tokens; q, k, v and out moved once) at the
chip's roofline, over the device time of the attention kernels in the
trace: the system's bf16 pair and PyTorch's fused attention kernels, by
the names below."""

from portbench.counts.attention import bound_seconds

KERNELS = ("attention_fwd", "attention_bwd", "flash", "fmha",
           "efficient_attention", "scaled_dot_product")


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("attn_ops"):
        return None
    spent = trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    need = bound_seconds(ctx["attn_ops"], ctx["attn_bytes"], ctx["peaks"])
    return 100.0 * need / spent
