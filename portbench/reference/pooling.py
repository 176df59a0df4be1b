"""Attention pooling in float32, from its description: each token's score
from a tanh MLP (Linear, tanh, Linear to one), a softmax over the
sequence's own tokens (padding masked out), and the tokens' hidden states
summed with those weights.  Weights ``<p>attn_fc1`` and ``<p>attn_fc2``."""

from __future__ import annotations

import torch

from portbench.reference.nets import Precision, Weights, linear


def attention_pool(W: Weights, p: str, hidden: torch.Tensor,
                   mask: torch.Tensor, P: Precision) -> torch.Tensor:
    """``hidden [B, S, H]`` and ``mask [B, S]`` (1 = a real token) to
    ``[B, H]``."""
    h = P.a(torch.tanh(linear(W, p + "attn_fc1", hidden, P)))
    scores = linear(W, p + "attn_fc2", h, P)[..., 0]
    scores = scores.masked_fill(~mask.bool(), float("-inf"))
    weights = torch.softmax(scores, dim=1)
    return P.a(torch.einsum("bs,bsh->bh", P.q(weights), P.q(hidden)))
