"""Eval-mode BatchNorm with the JAX package's (flax) semantics."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Normalizes dim 1 (features of ``[B, F]``, channels of NCHW) with the
    running statistics: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``
    in f32, cast back to the input dtype, as flax's ``nn.BatchNorm`` does
    with ``use_running_average=True``.  The running statistics stay f32
    when the parameters are cast to bf16.  Training-mode statistics and
    flax's momentum wait for the training port."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = ((x.float() - self.running_mean.float().view(shape))
             * mul.view(shape) + self.bias.float().view(shape))
        return y.to(x.dtype)
