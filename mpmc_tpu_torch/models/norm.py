"""BatchNorm and Dropout with the JAX package's (flax) semantics."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Normalizes dim 1 (features of ``[B, F]``, channels of NCHW) as
    flax's ``nn.BatchNorm`` does, which a stock ``nn.BatchNorm*`` does not:

    * eval: the running statistics;
    * training: the batch mean and the biased batch variance over every
      other axis, computed in f32 as ``max(E[x^2] - E[x]^2, 0)``
      (``use_fast_variance``), and the running statistics updated in place
      as ``ra = momentum * ra + (1 - momentum) * batch_stat`` (flax's
      ``momentum=0.99``), in f32.

    Either way ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in
    f32, cast back to the input dtype.  The running statistics stay f32
    when the parameters run in bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp(torch.mean(xf * xf, dim=axes) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = ((x.float() - mean.view(shape)) * mul.view(shape)
             + self.bias.float().view(shape))
        return y.to(x.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed;
    the identity in eval or at rate 0.  The keep mask is drawn from
    ``generator`` (set by :func:`set_dropout_generator`; the default
    generator when None) into a tensor made like ``x``, so that under
    ``torch.func.vmap(randomness="different")`` (the fold-parallel step)
    every fold draws its own mask from the one generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.empty_like(
            x, dtype=torch.float32, memory_format=torch.contiguous_format
        ).bernoulli_(keep_prob, generator=self.generator).bool()
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Make every :class:`Dropout` of ``model`` draw from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
