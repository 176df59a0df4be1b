"""ResNet family (port of ``SEModule``, ``BasicBlock``, ``BottleneckBlock``,
``ResNet`` and ``TinyResNet`` in ``mpmc_tpu/models/resnet.py``): ResNet-18,
ResNet-50, ResNeXt-50 32x4d and SE-ResNeXt-50 32x4d, and the from-scratch
tiny ResNet.

Images arrive in the JAX package's ``[B, H, W, C]`` layout and are viewed as
NCHW for the convolutions.  Convolutions and max-pool are plain
``torch.nn.functional`` ops, as the JAX package leaves them to XLA.
BatchNorm (``models/norm.py``) uses the running statistics in eval mode and
the batch statistics, updating the running ones, in training mode.
``num_classes`` > 0 keeps a Linear head named ``classifier`` on the pooled
features (the simple 2C baseline reads ResNet-50's 1000 logits).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.models.norm import BatchNorm


class SEModule(nn.Module):
    """Squeeze-and-excitation: channel means, Linear, ReLU, Linear, sigmoid
    gate; the hidden width is ``max(int(channels / 16), 8)``."""

    def __init__(self, channels: int, ratio: float = 1 / 16):
        super().__init__()
        hidden = max(int(channels * ratio), 8)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x):                          # NCHW
        s = F.relu(self.fc1(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(s))[:, :, None, None]


class _Block(nn.Module):
    """The residual join shared by both block kinds: a 1x1 projection (conv
    and BatchNorm) when the shape changes, the optional SE gate on the main
    branch, then ReLU of the sum."""

    def _init_join(self, in_channels: int, out_channels: int, stride: int,
                   use_se: bool):
        self.se = SEModule(out_channels) if use_se else None
        self.has_downsample = stride != 1 or in_channels != out_channels
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, out_channels, 1,
                                             stride, bias=False)
            self.downsample_bn = BatchNorm(out_channels)

    def _join(self, x, y):
        if self.se is not None:
            y = self.se(y)
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return F.relu(y + residual)


class BasicBlock(_Block):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 use_se: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters)
        self._init_join(in_channels, filters, stride, use_se)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return self._join(x, self.bn2(self.conv2(y)))


class BottleneckBlock(_Block):
    """1x1 conv to ``int(filters * base_width / 64) * groups`` channels, a
    3x3 conv (strided, ``groups`` groups), 1x1 conv to ``4 * filters``."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64,
                 use_se: bool = False):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out_channels = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels)
        self._init_join(in_channels, out_channels, stride, use_se)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self._join(x, self.bn3(self.conv3(y)))


class ResNet(nn.Module):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max-pool), stages of ``block``
    blocks ("basic" or "bottleneck"), global average pool; returns the
    pooled features ``[B, feature_dim]``, or with ``num_classes`` the
    ``classifier`` logits."""

    def __init__(self, depths: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 block: str = "basic", groups: int = 1, base_width: int = 64,
                 use_se: bool = False, num_classes: int = 0,
                 stem_width: int = 64, in_channels: int = 3):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown ResNet block {block!r}")
        mult = BottleneckBlock.expansion if block == "bottleneck" else 1
        self.feature_dim = widths[-1] * mult
        self.stem_conv = nn.Conv2d(in_channels, stem_width, 7, 2, 3,
                                   bias=False)
        self.stem_bn = BatchNorm(stem_width)
        self.blocks = []
        ch = stem_width
        for si, (depth, width) in enumerate(zip(depths, widths)):
            for bi in range(depth):
                stride = 2 if (bi == 0 and si > 0) else 1
                name = f"stage{si}_block{bi}"
                if block == "bottleneck":
                    mod = BottleneckBlock(ch, width, stride, groups,
                                          base_width, use_se)
                else:
                    mod = BasicBlock(ch, width, stride, use_se)
                setattr(self, name, mod)
                self.blocks.append(name)
                ch = width * mult
        self.classifier = (nn.Linear(self.feature_dim, num_classes)
                           if num_classes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)                  # [B,H,W,C] -> NCHW view
        y = F.relu(self.stem_bn(self.stem_conv(y)))
        y = F.max_pool2d(y, 3, 2, 1)
        for name in self.blocks:
            y = getattr(self, name)(y)
        feats = y.mean(dim=(2, 3))
        return self.classifier(feats) if self.classifier is not None else feats


def resnet18(num_classes: int = 0, in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), (64, 128, 256, 512), "basic",
                  num_classes=num_classes, in_channels=in_channels)


def resnet50(num_classes: int = 0, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), "bottleneck",
                  num_classes=num_classes, in_channels=in_channels)


def resnext50_32x4d(num_classes: int = 0, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), "bottleneck",
                  groups=32, base_width=4, num_classes=num_classes,
                  in_channels=in_channels)


def seresnext50_32x4d(num_classes: int = 0, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), "bottleneck",
                  groups=32, base_width=4, use_se=True,
                  num_classes=num_classes, in_channels=in_channels)


def TinyResNet(num_classes: int = 0, in_channels: int = 3) -> ResNet:
    """The from-scratch tiny ResNet of the HF-Trainer 2B example: 64-wide
    stem, basic blocks with depths [2, 2] and widths [32, 64]."""
    return ResNet((2, 2), (32, 64), num_classes=num_classes,
                  in_channels=in_channels)
