"""Differentiable collectives over a ``torch.distributed`` process group:
the port's counterparts of the JAX collectives that the sharded paths call
inside ``shard_map`` (``psum``, ``pmax``/``pmin``, ``all_to_all``,
``all_gather``).

Gradient convention. Under edge and node sharding every rank of a group
computes the replicated parts of the model (the loss, the task head) alike
and backpropagates its own copy. A collective's backward then collects the
cotangents of all those copies (the backward of a sum over ranks is a sum
over ranks), so each rank's partial gradient carries the group's size as a
factor; summing the parameter gradients over the group and dividing by its
size gives the true gradient. ``DataParallel``'s all-reduce over the world
does exactly that (``parallel/dp.py``). It is the JAX package's convention:
``shard_map``'s transpose divides the replicated output's cotangent by the
axis size and sums the per-device cotangents of replicated inputs.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """psum: forward and backward are both a sum over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The elementwise sum of ``x`` over the group's ranks (differentiable)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_sum_(x: torch.Tensor, group: Any) -> torch.Tensor:
    """In place and not differentiated: counts, masks, statistics."""
    dist.all_reduce(x, group=group)
    return x


class _AllReduceExtremum(torch.autograd.Function):
    """pmax/pmin over the group as one all-reduce of [N, D] (nothing is
    gathered). Backward: JAX's tie split. The output is replicated, so the
    cotangents of every rank's copy are summed first, then split evenly
    among the ranks whose local value equals the extremum."""

    @staticmethod
    def forward(ctx, local, group, is_max):
        total = local.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.MAX if is_max else dist.ReduceOp.MIN, group=group)
        ctx.save_for_backward(local, total)
        ctx.group = group
        return total

    @staticmethod
    def backward(ctx, g):
        local, total = ctx.saved_tensors
        winner = (local == total).to(g.dtype)
        ties = winner.clone()
        dist.all_reduce(ties, group=ctx.group)
        g_total = g.contiguous().clone()
        dist.all_reduce(g_total, group=ctx.group)
        return winner * g_total / ties.clamp_min(1.0), None, None


def all_reduce_extremum(local: torch.Tensor, group: Any, is_max: bool) -> torch.Tensor:
    return _AllReduceExtremum.apply(local, group, is_max)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of equal row blocks: block o of the input goes to rank
    o, block o of the output came from rank o. Its own inverse, so the
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    """[S * b, ...] rows, block o for rank o -> [S * b, ...], block o from
    rank o (differentiable)."""
    return _AllToAll.apply(x, group)


class _AllGather(torch.autograd.Function):
    """Tiled all_gather along dim 0; backward: the sum over the group of the
    cotangent, then this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The group's [rows, ...] blocks concatenated in rank order
    (differentiable)."""
    return _AllGather.apply(x, group)
