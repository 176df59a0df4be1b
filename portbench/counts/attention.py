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


def model_need(parts, train: bool = False):
    """Total (operations, bytes) of every attention layer in one forward,
    plus the backward when ``train``, of the stacks ``parts``: each
    ``(tokens [n], encoder configuration)``, as a model kind's
    ``attention_parts`` gives them (an image model's tokens are its patches
    and class token)."""
    ops = nbytes = 0.0
    for tokens, c in parts:
        fns = (forward, backward) if train else (forward,)
        for fn in fns:
            o, b = fn(tokens, c["hidden_size"], c["num_hidden_layers"])
            ops += float(np.sum(o))
            nbytes += float(np.sum(b))
    return ops, nbytes
