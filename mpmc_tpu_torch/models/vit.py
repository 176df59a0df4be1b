"""Port of ``mpmc_tpu/models/vit.py``: so far only ``BinaryHead``, the 2B
zoo's head.  The ViT backbone itself is not ported yet."""

from __future__ import annotations

import torch
from torch import nn


class BinaryHead(nn.Module):
    """l2-normalize the features (1e-12 inside the square root), then a
    Linear named ``fc`` (the JAX head's scale, 1 wherever it is built, is
    left out)."""

    def __init__(self, in_features: int, num_classes: int = 2):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(feats ** 2, dim=-1, keepdim=True) + 1e-12)
        return self.fc(feats / norm)
