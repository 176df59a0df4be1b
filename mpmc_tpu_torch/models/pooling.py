"""Six pooling strategies over encoder hidden states (port of
``mpmc_tpu/models/pooling.py``):

* cls        -- ``hidden[:, 0]``
* nopooling  -- ``hidden`` unchanged
* max        -- max over the sequence axis (unmasked, as the reference)
* mean       -- mask-weighted mean, the token count clamped at 1e-9
* attention  -- Linear(H->A), tanh, Linear(A->1) scores, the additive
                -1e9 mask, softmax over the sequence, weighted sum
* cnn        -- Conv1d(H->H, k=3, "same" padding), ReLU, max over the
                sequence

Every operation runs in the dtype of ``hidden`` (bf16 on the card), with
the mask cast to it, as the JAX package computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import PoolingType


ATTENTION_HIDDEN = 512     # attention pooler's score MLP width
CNN_KERNEL = 3             # CNN pooler's kernel size


class Pooler(nn.Module):
    """``hidden [B, S, H]``, ``attention_mask [B, S]`` (1 = token) to the
    pooled features ``[B, H]`` (``nopooling``: ``[B, S, H]``)."""

    def __init__(self, pooling: PoolingType, hidden_size: int = 768):
        super().__init__()
        self.pooling = PoolingType(pooling)
        if self.pooling == PoolingType.ATTENTION:
            self.attn_fc1 = nn.Linear(hidden_size, ATTENTION_HIDDEN)
            self.attn_fc2 = nn.Linear(ATTENTION_HIDDEN, 1)
        elif self.pooling == PoolingType.CNN:
            self.conv1d = nn.Conv1d(hidden_size, hidden_size, CNN_KERNEL,
                                    padding="same")

    def forward(self, hidden: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        p = self.pooling
        if p == PoolingType.CLS:
            return hidden[:, 0]
        if p == PoolingType.NOPOOLING:
            return hidden
        if p == PoolingType.MAX:
            return hidden.amax(dim=1)
        if p == PoolingType.MEAN:
            m = attention_mask.to(hidden.dtype)[..., None]
            denom = torch.clamp(m.sum(dim=1), min=1e-9)
            return (hidden * m).sum(dim=1) / denom
        if p == PoolingType.ATTENTION:
            scores = self.attn_fc2(torch.tanh(self.attn_fc1(hidden)))[..., 0]
            scores = scores + (1.0 - attention_mask.to(scores.dtype)) * -1e9
            weights = torch.softmax(scores, dim=1)
            return (hidden * weights[..., None]).sum(dim=1)
        # CNN: the sequence axis is Conv1d's length axis.
        h = F.relu(self.conv1d(hidden.transpose(1, 2)))
        return h.amax(dim=2)
