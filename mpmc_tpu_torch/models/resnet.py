"""ResNet with basic blocks (port of ``BasicBlock``, ``ResNet`` and
``TinyResNet`` in ``mpmc_tpu/models/resnet.py``).

Images arrive in the JAX package's ``[B, H, W, C]`` layout and are viewed as
NCHW for the convolutions.  Convolutions and max-pool are plain
``torch.nn.functional`` ops, as the JAX package leaves them to XLA.
BatchNorm (``models/norm.py``) uses the running statistics in eval mode and
the batch statistics, updating the running ones, in training mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.models.norm import BatchNorm


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters)
        self.has_downsample = stride != 1 or in_channels != filters
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, filters, 1, stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max-pool), stages of basic blocks,
    global average pool; returns pooled features ``[B, widths[-1]]``."""

    def __init__(self, depths: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 stem_width: int = 64, in_channels: int = 3):
        super().__init__()
        self.feature_dim = widths[-1]
        self.stem_conv = nn.Conv2d(in_channels, stem_width, 7, 2, 3,
                                   bias=False)
        self.stem_bn = BatchNorm(stem_width)
        self.blocks = []
        ch = stem_width
        for si, (depth, width) in enumerate(zip(depths, widths)):
            for bi in range(depth):
                stride = 2 if (bi == 0 and si > 0) else 1
                name = f"stage{si}_block{bi}"
                setattr(self, name, BasicBlock(ch, width, stride))
                self.blocks.append(name)
                ch = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)                  # [B,H,W,C] -> NCHW view
        y = F.relu(self.stem_bn(self.stem_conv(y)))
        y = F.max_pool2d(y, 3, 2, 1)
        for name in self.blocks:
            y = getattr(self, name)(y)
        return y.mean(dim=(2, 3))


def resnet18(in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), (64, 128, 256, 512), in_channels=in_channels)


def TinyResNet(in_channels: int = 3) -> ResNet:
    """The from-scratch tiny ResNet of the HF-Trainer 2B example: 64-wide
    stem, basic blocks with depths [2, 2] and widths [32, 64]."""
    return ResNet((2, 2), (32, 64), in_channels=in_channels)
