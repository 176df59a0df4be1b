"""EfficientNet-B0..B4 (port of ``mpmc_tpu/models/efficientnet.py``).

Compound-scaled MBConv stacks: the width and depth multipliers of each
variant scale the base stages (``_round_channels`` to multiples of 8,
``ceil`` of the repeats), each MBConv a 1x1 expansion (skipped at expand
ratio 1), a depthwise k x k convolution (``groups = mid``), squeeze-excite
whose hidden width comes from the block's pre-expansion width, and a 1x1
projection, with a residual when the shape is kept.  SiLU activations;
BatchNorm through ``models/norm.py`` with flax's momentum 0.9 as the JAX
module sets it.  Images arrive in the JAX package's ``[B, H, W, C]``
layout and run as NCHW; ``num_classes`` > 0 keeps a ``classifier`` Linear
on the pooled features.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.models.norm import BatchNorm

# (expand_ratio, channels, repeats, stride, kernel)
BASE_BLOCKS: List[Tuple[int, int, int, int, int]] = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# width and depth multipliers of each variant
SCALES = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
          "b3": (1.2, 1.4), "b4": (1.4, 1.8)}

BN_MOMENTUM = 0.9


def _round_channels(ch: float, divisor: int = 8) -> int:
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return new


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int,
                 kernel: int, se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.expand_bn = BatchNorm(mid, momentum=BN_MOMENTUM)
        else:
            self.expand_conv = None
        self.dw_conv = nn.Conv2d(mid, mid, kernel, stride, kernel // 2,
                                 groups=mid, bias=False)
        self.dw_bn = BatchNorm(mid, momentum=BN_MOMENTUM)
        se_ch = max(1, int(in_ch * se_ratio))
        self.se_reduce = nn.Linear(mid, se_ch)
        self.se_expand = nn.Linear(se_ch, mid)
        self.project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.project_bn = BatchNorm(out_ch, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # NCHW
        y = x
        if self.expand_conv is not None:
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        s = F.silu(self.se_reduce(y.mean(dim=(2, 3))))
        y = y * torch.sigmoid(self.se_expand(s))[:, :, None, None]
        y = self.project_bn(self.project_conv(y))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Stem (3x3/2 conv, BN, SiLU), the scaled MBConv stages, a 1x1 head
    conv to ``feature_dim`` (BN, SiLU), global average pool."""

    def __init__(self, variant: str = "b3", num_classes: int = 0,
                 in_channels: int = 3):
        super().__init__()
        w_mult, d_mult = SCALES[variant]
        self.feature_dim = _round_channels(1280 * w_mult)
        stem = _round_channels(32 * w_mult)
        self.stem_conv = nn.Conv2d(in_channels, stem, 3, 2, 1, bias=False)
        self.stem_bn = BatchNorm(stem, momentum=BN_MOMENTUM)
        self.blocks = []
        in_ch = stem
        for bi, (expand, ch, reps, stride, kernel) in enumerate(BASE_BLOCKS):
            out_ch = _round_channels(ch * w_mult)
            for r in range(int(math.ceil(reps * d_mult))):
                name = f"block{bi}_{r}"
                setattr(self, name, MBConv(in_ch, out_ch, expand,
                                           stride if r == 0 else 1, kernel))
                self.blocks.append(name)
                in_ch = out_ch
        self.head_conv = nn.Conv2d(in_ch, self.feature_dim, 1, bias=False)
        self.head_bn = BatchNorm(self.feature_dim, momentum=BN_MOMENTUM)
        self.classifier = (nn.Linear(self.feature_dim, num_classes)
                           if num_classes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        for name in self.blocks:
            y = getattr(self, name)(y)
        feats = F.silu(self.head_bn(self.head_conv(y))).mean(dim=(2, 3))
        return self.classifier(feats) if self.classifier is not None else feats
