"""What attention needs: operations and bytes of one sequence's attention
over its own ``L`` tokens in one layer, whatever the implementation.
Forward: 4 L^2 H operations (scores and weighted sum; H the hidden width,
heads times head size), q, k, v read and out written once.  Backward: 10
L^2 H (the recomputed scores, dV, dP, dQ and dK), q, k, v, out and dOut
read and dQ, dK, dV written once.  Elements are ``elem_bytes`` wide (2:
bf16)."""

from __future__ import annotations

import numpy as np


def forward(tokens, hidden: int, layers: int = 1, elem_bytes: int = 2):
    L = np.asarray(tokens, np.float64)
    return (layers * 4 * L * L * hidden,
            layers * 4 * L * hidden * elem_bytes)


def backward(tokens, hidden: int, layers: int = 1, elem_bytes: int = 2):
    L = np.asarray(tokens, np.float64)
    return (layers * 10 * L * L * hidden,
            layers * 8 * L * hidden * elem_bytes)


def bound_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time: the larger of the operations over the bf16 peak and
    the bytes over the memory bandwidth."""
    return max(ops / peaks["bf16_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def model_need(cfg: dict, n: int, text_tokens=None, caption_tokens=None,
               train: bool = False):
    """Total (operations, bytes) of every attention layer of ``n`` memes
    with these token counts (``[n]``; an image model's tokens are its
    patches and class token) in one forward, plus the backward when
    ``train``."""
    parts = []
    if cfg["kind"] == "image":
        c = cfg["image_encoder"]
        parts.append((np.full(n, (c["image_size"] // c["patch_size"]) ** 2
                              + 1), c))
    else:
        parts += [(text_tokens, cfg["text_encoder"]),
                  (caption_tokens, cfg["caption_encoder"])]
    ops = nbytes = 0.0
    for tokens, c in parts:
        fns = (forward, backward) if train else (forward,)
        for fn in fns:
            o, b = fn(tokens, c["hidden_size"], c["num_hidden_layers"])
            ops += float(np.sum(o))
            nbytes += float(np.sum(b))
    return ops, nbytes
