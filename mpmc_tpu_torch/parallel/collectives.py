"""Collectives with their gradients: each function makes one
``torch.distributed`` call forward and declares its transpose backward.

JAX differentiates ``psum``, ``all_gather``, ``all_to_all`` and
``ppermute`` inside ``shard_map`` itself; ``torch.distributed`` calls have
no autograd, so these ``torch.autograd.Function``s supply it.  The
convention is JAX's: every rank's loss is one term of the global loss, and
a parameter's gradient is the sum of its ranks' terms, so

* :func:`all_reduce` (sum) transposes to an all-reduce of the gradient;
* :func:`all_gather` transposes to a reduce-scatter;
* :func:`all_to_all` (chunk ``j`` of dim 0 to rank ``j``) is its own
  inverse, and transposes to itself;
* :func:`shift` (JAX's neighbour ``ppermute``: rank ``i`` sends to ``i +
  1``) transposes to the reverse shift.

Megatron's pair for replicated losses is :func:`copy_to_group` (identity
forward, all-reduce backward; "f") and :func:`reduce_from_group`
(all-reduce forward, identity backward; "g").

:func:`all_reduce`, :func:`copy_to_group`, :func:`reduce_from_group` and
:func:`all_gather` have a ``vmap`` rule for the fold-parallel step
(``torch.func.vmap`` over stacked folds): the collective runs once on the
unwrapped tensor, which holds every fold, and the fold dim rides along
(the all-gather's ``dim`` moves past it).

Every call counts itself in ``ops.build.collective_calls``.  A group of one
process still makes its call, so a world of one runs the same program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from mpmc_tpu_torch.ops import build


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    build.count_launch("all_reduce")
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over ``group``, no gradient."""
    build.count_launch("all_reduce")
    dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, ...]`` from every rank of ``group`` stacked in rank order to
    ``[size * n, ...]``, no gradient (eval outputs)."""
    build.count_launch("all_gather")
    out = x.new_empty((_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # Elementwise over the ranks: the vmapped dim rides along (the
        # fold-parallel step's BatchNorm statistics, one row a fold; the
        # tensor-parallel partial sums of every fold at once).  The rules
        # below are the same: a collective runs once on the unwrapped
        # tensor, which holds every fold.
        return _AllReduce.apply(x, group), in_dims[0]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToGroup.apply(x, group), in_dims[0]


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromGroup.apply(x, group), in_dims[0]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        moved = x.movedim(dim, 0)
        return gather_rows(moved, group).movedim(0, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        build.count_launch("reduce_scatter")
        moved = g.movedim(ctx.dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // _size(ctx.group),
                               *moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        # The vmapped dim goes in front; the gathered dim is then one
        # further right (counted from the left; a negative dim is the
        # same dim either way).
        bdim = in_dims[0]
        if bdim is None:
            return _AllGather.apply(x, group, dim), None
        x = x.movedim(bdim, 0)
        return _AllGather.apply(x, group, dim + 1 if dim >= 0 else dim), 0


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    build.count_launch("all_to_all")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _send_recv(x: torch.Tensor, group, offset: int, wrap: bool
               ) -> torch.Tensor:
    """Rank ``i`` of ``group`` sends ``x`` to ``i + offset`` and returns
    what ``i - offset`` sent, ranks taken modulo the size when ``wrap``,
    else zeros where no rank sends."""
    n, r = _size(group), _rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if n == 1:
        return x.clone() if wrap else out
    build.count_launch("shift")
    dst, src = r + offset, r - offset
    if wrap:
        dst, src = dst % n, src % n
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, wrap):
        ctx.group, ctx.wrap = group, wrap
        return _send_recv(x, group, 1, wrap)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1, ctx.wrap), None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` on every rank; the gradient is summed
    over ``group`` too (each rank's loss a term of the global one)."""
    return _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity, whose gradient is summed over
    ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over ``group``, whose gradient passes as it
    is (the loss is the same on every rank)."""
    return _ReduceFromGroup.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient is reduce-scattered back."""
    return _AllGather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x [P, ...]``: chunk ``j`` of dim 0 goes to rank ``j`` of
    ``group``, and chunk ``j`` of the result came from rank ``j``."""
    return _AllToAll.apply(x, group)


def shift(x: torch.Tensor, group, wrap: bool = False) -> torch.Tensor:
    """Rank ``i`` sends ``x`` to rank ``i + 1`` of ``group`` and gets rank
    ``i - 1``'s (JAX's ``ppermute`` over ``[(i, i + 1)]``, zeros on rank
    0; with ``wrap`` the ring ``[(i, (i + 1) % P)]``)."""
    return _Shift.apply(x, group, wrap)


def group_size(group: Optional[object]) -> int:
    return 1 if group is None else _size(group)


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor, group
                 ) -> torch.Tensor:
    """``linear(x)``; under tensor parallelism (``group``) the Linear holds
    this rank's columns of the weight and ``x`` its slice of the features,
    so the partial products are summed over ``group`` (Megatron's g) before
    the replicated bias is added."""
    if group is None:
        return linear(x)
    y = torch.nn.functional.linear(x, linear.weight)
    return reduce_from_group(y, group) + linear.bias
