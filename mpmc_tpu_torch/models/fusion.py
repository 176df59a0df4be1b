"""Concatenation fusion (port of ``_GatedConcat``, ``ConcatAttention``,
``ConcatAttention3`` and the concatenation branch of ``make_fusion`` in
``mpmc_tpu/models/fusion.py``): feature concat, then a Linear+BN+ReLU
softmax gate over the features, the gated features, and a reducing
Linear+BN+ReLU.  The MCA, cross-modal and self-attention fusions wait."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import FusionMethod
from mpmc_tpu_torch.models.norm import BatchNorm


class _GatedConcat(nn.Module):
    def __init__(self, input_dim: int, attention_dim: int):
        super().__init__()
        self.gate_fc = nn.Linear(input_dim, input_dim)
        self.gate_bn = BatchNorm(input_dim)
        self.reduce_fc = nn.Linear(input_dim, attention_dim)
        self.reduce_bn = BatchNorm(attention_dim)

    def forward(self, concat):
        g = self.gate_bn(self.gate_fc(concat))
        g = torch.softmax(F.relu(g), dim=1)
        h = self.reduce_bn(self.reduce_fc(g * concat))
        return F.relu(h)


class ConcatAttention(nn.Module):
    """ConcatAttention (two modalities) and ConcatAttention3 (three): the
    JAX package's two classes differ only in how many features they
    concatenate."""

    def __init__(self, input_dim: int, attention_dim: int):
        super().__init__()
        self.gated = _GatedConcat(input_dim, attention_dim)

    def forward(self, *feats):
        return self.gated(torch.cat(feats, dim=1))


ConcatAttention3 = ConcatAttention


def make_fusion(method: FusionMethod, proj_dim: int,
                feat_dims: Sequence[int]) -> nn.Module:
    """The fusion module for per-modality features of widths ``feat_dims``."""
    method = FusionMethod(method)
    if method == FusionMethod.CONCATENATION:
        return ConcatAttention(sum(feat_dims), proj_dim)
    raise ValueError(f"{method.value} fusion is not ported yet")
