"""BatchNorm and Dropout with the JAX package's (flax) semantics."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
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
    when the parameters run in bf16.

    Under data parallelism (``group``, set by :func:`set_data_shard`) the
    training statistics are the global batch's, as JAX's mean over a
    batch-sharded array is: each rank's ``E[x]`` and ``E[x^2]`` divided by
    the group's size are summed over the group through the autograd
    ``all_reduce``, so the gradient flows through the global statistics.
    In a group of one this is the same arithmetic as without one."""

    group = None

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
            mean_sq = torch.mean(xf * xf, dim=axes)
            if self.group is not None:
                from mpmc_tpu_torch.parallel.collectives import all_reduce
                n = dist.get_world_size(self.group)
                both = all_reduce(torch.stack([mean, mean_sq]) / n,
                                  self.group)
                mean, mean_sq = both[0], both[1]
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
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


def _keep_mask(shape, dim: int, device, keep_prob: float, generator,
               shard: Optional[Tuple[int, int]]) -> torch.Tensor:
    """A bool keep mask of ``shape``, rows along ``dim``: with ``shard``
    ``(rank, size)`` drawn for ``size`` times the rows, the rank's rows
    kept."""
    shape = list(shape)
    n = shape[dim]
    if shard is not None:
        shape[dim] = n * shard[1]
    keep = torch.empty(shape, dtype=torch.float32, device=device).bernoulli_(
        keep_prob, generator=generator).bool()
    return keep if shard is None else keep.narrow(dim, shard[0] * n, n)


class _KeepMask(torch.autograd.Function):
    """``apply(x, keep_prob, generator, shard, folds)``: the keep mask of
    ``x``'s shape.  Under ``torch.func.vmap`` over stacked folds (the
    fold-parallel step, ``randomness="different"``) one draw covers every
    fold, ``[F, ...]``; with ``folds`` ``(lo, total)`` (this process holds
    folds ``lo .. lo + F - 1`` of ``total``) it covers all ``total`` folds
    and keeps this process's, so a fold's mask does not depend on where
    the folds are placed."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, keep_prob, generator, shard, folds):
        return _keep_mask(x.shape, 0, x.device, keep_prob, generator, shard)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, x, keep_prob, generator, shard, folds):
        if info.randomness != "different":
            raise ValueError("dropout under vmap draws a mask per fold: "
                             "use randomness='different'")
        x = x.movedim(in_dims[0], 0)
        F = x.shape[0]
        lo, total = folds if folds is not None else (0, F)
        keep = _keep_mask((total,) + x.shape[1:], 1, x.device, keep_prob,
                          generator, shard)
        return keep[lo:lo + F], 0


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed;
    the identity in eval or at rate 0.  The keep mask is drawn from
    ``generator`` (set by :func:`set_dropout_generator`; the default
    generator when None); under ``torch.func.vmap(randomness="different")``
    (the fold-parallel step) every fold draws its own mask from the one
    generator (:class:`_KeepMask`).

    Under data parallelism (``shard`` ``(rank, size)``, set by
    :func:`set_data_shard`) the mask is drawn for the global batch, ``size``
    times the local rows, and the rank keeps its rows of it: every rank's
    generator advances alike, and the masks are those of one process
    running the global batch.  Under fold sharding (``folds`` ``(lo,
    total)``, set by :func:`set_fold_slice`) the stacked folds' masks are
    drawn for all ``total`` folds and this process keeps its own: the
    masks of one process holding every fold."""

    shard: Optional[Tuple[int, int]] = None
    folds: Optional[Tuple[int, int]] = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = _KeepMask.apply(x.detach(), keep_prob, self.generator,
                               self.shard, self.folds)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Make every :class:`Dropout` of ``model`` draw from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def set_fold_slice(model: nn.Module,
                   folds: Optional[Tuple[int, int]]) -> None:
    """Under fold sharding the stacked replicas run through ``model`` are
    folds ``lo .. lo + F - 1`` of ``total`` (``folds`` ``(lo, total)``;
    None: all of them): dropout draws every fold's mask and keeps
    these."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.folds = folds


def set_data_shard(model: nn.Module, group) -> None:
    """Put ``model`` under data parallelism over ``group`` (None: undo):
    BatchNorm takes the global batch's statistics and dropout the global
    batch's masks."""
    shard = (None if group is None
             else (dist.get_rank(group), dist.get_world_size(group)))
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group
        elif isinstance(mod, Dropout):
            mod.shard = shard
