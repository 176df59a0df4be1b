"""ConvNeXt (port of ``mpmc_tpu/models/convnext.py``): ConvNeXt-Tiny by
default, stages ``depths`` (3, 3, 9, 3) of widths ``dims`` (96, 192, 384,
768), which the tests narrow.

A 4x4/4 stem conv and its LayerNorm; before each later stage a LayerNorm
and a 2x2/2 conv; each block a 7x7 depthwise conv, LayerNorm, Linear to
4 x dim, exact GELU, Linear back, times the per-channel layer scale
``gamma``, plus the residual; global average pool and ``final_norm``.
Every LayerNorm normalizes the channels at epsilon 1e-6, as the JAX
module's channel-last LayerNorm does: the convolutions run NCHW and the
norms and pointwise Linears channel-last.  There is no BatchNorm, so
training and eval compute the same.  Images arrive in the JAX package's
``[B, H, W, C]`` layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def _channel_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # NCHW
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))   # channel-last
        y = self.pwconv2(F.gelu(self.pwconv1(y))) * self.gamma
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """Returns the ``final_norm`` pooled features ``[B, dims[-1]]``, or with
    ``num_classes`` the ``classifier`` logits."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 0, in_channels: int = 3):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.feature_dim = dims[-1]
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, 4)
        self.stem_norm = nn.LayerNorm(dims[0], LN_EPS)
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                setattr(self, f"down{si}_norm",
                        nn.LayerNorm(dims[si - 1], LN_EPS))
                setattr(self, f"down{si}_conv",
                        nn.Conv2d(dims[si - 1], dim, 2, 2))
            for bi in range(depth):
                setattr(self, f"stage{si}_block{bi}", ConvNeXtBlock(dim))
        self.final_norm = nn.LayerNorm(dims[-1], LN_EPS)
        self.classifier = (nn.Linear(dims[-1], num_classes)
                           if num_classes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _channel_norm(self.stem_norm,
                          self.stem_conv(x.permute(0, 3, 1, 2)))
        for si, depth in enumerate(self.depths):
            if si > 0:
                y = getattr(self, f"down{si}_conv")(
                    _channel_norm(getattr(self, f"down{si}_norm"), y))
            for bi in range(depth):
                y = getattr(self, f"stage{si}_block{bi}")(y)
        feats = self.final_norm(y.mean(dim=(2, 3)))
        return self.classifier(feats) if self.classifier is not None else feats
