"""Fusion mechanisms (port of ``mpmc_tpu/models/fusion.py``), all four
families in two and three arities:

* ``ConcatAttention`` (two or three modalities): feature concat, a
  Linear+BN+ReLU softmax gate over the features, the gated features, and a
  reducing Linear+BN+ReLU (the flagship default, "concatenation");
* ``MCA`` / ``MCA3``: additive attention, ``score = tanh(W1 text +
  W2 image[:, None] (+ W3 caption))``, weights ``softmax(V score)`` over
  axis 1, context ``sum(weights * features, axis 1)``; MCA3 concatenates
  the text and caption contexts and reduces 2U -> U.  The features are
  pooled ``[B, F]``, so ``W2(image)[:, None]`` broadcasts against
  ``W1(text)`` to ``[B, B, U]`` and the softmax runs over the OTHER
  SAMPLES of the batch: a sample's output depends on its batch, padding
  rows included (the JAX package's formula, kept exactly);
* ``CrossModalAttention``: single-token attention text -> image and image
  -> text (and text -> caption with three inputs), averaged, then
  BatchNorm;
* ``SelfAttentionFusion``: the modality features stacked as tokens,
  self-attention over them, the tokens summed, then BatchNorm.

The attention-style fusions run plain PyTorch (the JAX package calls its
plain XLA attention there, not a Pallas kernel).  Their q/k/v and ``out``
are the JAX module's DenseGeneral layers flattened over (heads, head_dim);
a single query over a single key has softmax weight 1, so
``_SingleTokenMHA`` is ``out(v(key_value))`` and keeps ``q`` and ``k`` for
the tree's sake (their gradient is zero on both sides).  BatchNorm is
flax's, momentum 0.99 (``models/norm.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import FusionMethod
from mpmc_tpu_torch.models.norm import BatchNorm


class MCA(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.W1 = nn.Linear(units, units)
        self.W2 = nn.Linear(units, units)
        self.V = nn.Linear(units, 1)

    def forward(self, text, image):
        score = torch.tanh(self.W1(text) + self.W2(image)[:, None])
        weights = torch.softmax(self.V(score), dim=1)     # [B, B, 1]
        return torch.sum(weights * text, dim=1)


class MCA3(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.W1 = nn.Linear(units, units)
        self.W2 = nn.Linear(units, units)
        self.W3 = nn.Linear(units, units)
        self.V = nn.Linear(units, 1)
        self.reduce = nn.Linear(2 * units, units)

    def forward(self, text, image, caption):
        score = torch.tanh(self.W1(text) + self.W2(image)[:, None]
                           + self.W3(caption))
        weights = torch.softmax(self.V(score), dim=1)
        ctx1 = torch.sum(weights * text, dim=1)
        ctx2 = torch.sum(weights * caption, dim=1)
        return self.reduce(torch.cat([ctx1, ctx2], dim=-1))


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


def _attention(q, k, v):
    """The JAX package's plain attention over ``[B, S, H, D]``: f32 scores
    scaled by ``1/sqrt(D)``, softmax over the keys, probabilities in v's
    dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


class _SingleTokenMHA(nn.Module):
    num_heads = 1                 # the JAX modules' default, never changed

    def __init__(self, feature_dim: int):
        super().__init__()
        self.q = nn.Linear(feature_dim, feature_dim)
        self.k = nn.Linear(feature_dim, feature_dim)
        self.v = nn.Linear(feature_dim, feature_dim)
        self.out = nn.Linear(feature_dim, feature_dim)

    def forward(self, query, key_value):
        return self.out(self.v(key_value))


class CrossModalAttention(nn.Module):
    """``text_to_caption`` exists with three modalities only, as in the
    flax tree."""

    def __init__(self, feature_dim: int, n_modalities: int = 2):
        super().__init__()
        self.text_to_image = _SingleTokenMHA(feature_dim)
        self.image_to_text = _SingleTokenMHA(feature_dim)
        self.text_to_caption = (_SingleTokenMHA(feature_dim)
                                if n_modalities == 3 else None)
        self.bn = BatchNorm(feature_dim)

    def forward(self, text, image, caption: Optional[torch.Tensor] = None):
        att_img = self.text_to_image(text, image)
        att_txt = self.image_to_text(image, text)
        if caption is None:
            combined = (att_txt + att_img) / 2
        else:
            att_cap = self.text_to_caption(text, caption)
            combined = (att_txt + att_img + att_cap) / 3
        return self.bn(combined)


class SelfAttentionFusion(nn.Module):
    num_heads = 1

    def __init__(self, feature_dim: int):
        super().__init__()
        self.q = nn.Linear(feature_dim, feature_dim)
        self.k = nn.Linear(feature_dim, feature_dim)
        self.v = nn.Linear(feature_dim, feature_dim)
        self.out = nn.Linear(feature_dim, feature_dim)
        self.bn = BatchNorm(feature_dim)

    def forward(self, text, image, caption: Optional[torch.Tensor] = None):
        feats = [text, image] + ([caption] if caption is not None else [])
        tokens = torch.stack(feats, dim=1)                # [B, T, F]
        B, T, _ = tokens.shape
        shape = (B, T, self.num_heads, -1)
        ctx = _attention(self.q(tokens).view(shape),
                         self.k(tokens).view(shape),
                         self.v(tokens).view(shape))
        att = self.out(ctx.reshape(B, T, -1))
        return self.bn(torch.sum(att, dim=1))


def make_fusion(method: FusionMethod, proj_dim: int,
                feat_dims: Sequence[int]) -> nn.Module:
    """The fusion module for per-modality features of widths ``feat_dims``
    (two or three).  Only concatenation takes unequal widths; the others
    take ``proj_dim``-wide features (every modality FC projects to it)."""
    method = FusionMethod(method)
    dims = list(feat_dims)
    if method == FusionMethod.CONCATENATION:
        return ConcatAttention(sum(dims), proj_dim)
    if len(set(dims)) > 1:
        raise ValueError(
            f"{method.value} fusion requires equal modality widths, got "
            f"{dims} — set ImageEncoderConfig.finetune_dim == proj_dim")
    if method == FusionMethod.MCA:
        return MCA3(proj_dim) if len(dims) == 3 else MCA(proj_dim)
    if method == FusionMethod.CROSS_MODAL:
        return CrossModalAttention(proj_dim, len(dims))
    if method == FusionMethod.SELF_ATTENTION:
        return SelfAttentionFusion(proj_dim)
    raise ValueError(f"Unsupported fusion method: {method}")
