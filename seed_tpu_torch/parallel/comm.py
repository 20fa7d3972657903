"""Collectives over a mesh axis with the gradients of seed_tpu's shard_map
programs (the port's counterpart of ``lax.ppermute``, ``psum``,
``all_gather`` and the unmapped inputs and outputs of ``shard_map``).

Every rank runs the same program on its own shard and calls ``backward`` on
its own copy of the result. Gradients then follow the rules JAX transposes
shard_map with (``check_vma=False``, as seed_tpu runs it):

- ``ppermute``: the gradient goes back along the inverse permutation;
- ``psum``: the gradient is summed over the axis too;
- ``all_gather``: each rank's block gets the sum of every rank's gradient
  for it (a reduce-scatter);
- ``replicated_in``: a value every rank holds whole (an unmapped input) has
  its gradient summed over the axes it is replicated on;
- ``replicated_out``: a value every rank computes whole (an unmapped
  output) hands each rank 1/size of its gradient.

So the gradient a rank holds for a replicated input is the gradient of the
whole program, as ``jax.grad`` of seed_tpu's function gives it.

``axis`` is a mesh axis name, a tuple of names (their product, the first
outermost) or a ProcessGroup; names resolve against ``mesh.current_mesh()``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from . import mesh as _mesh


def group_of(axis):
    if isinstance(axis, dist.ProcessGroup):
        return axis
    return _mesh.axis_group(axis)


def size_of(axis) -> int:
    return dist.get_world_size(group_of(axis))


def index_of(axis) -> int:
    return dist.get_rank(group_of(axis))


def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]):
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]]):
    """Send ``x`` from axis index src to dst for each (src, dst) of
    ``perm`` (batched isend/irecv); a rank no pair sends to gets zeros."""
    return _PPermute.apply(x, group_of(axis), [tuple(p) for p in perm])


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    return _PSum.apply(x, group_of(axis))


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    return psum(x, axis) / size_of(axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.group, ctx.dim, ctx.tiled = group, dim, tiled
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        me = dist.get_rank(ctx.group)
        if ctx.tiled:
            n = dist.get_world_size(ctx.group)
            return g.chunk(n, ctx.dim)[me], None, None, None
        return g.select(ctx.dim, me), None, None, None


def all_gather(x: torch.Tensor, axis, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along the axis, stacked on a new ``dim`` or, with
    ``tiled``, concatenated along ``dim`` (in axis order)."""
    return _AllGather.apply(x, group_of(axis), dim, tiled)


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def replicated_in(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axis``."""
    if not isinstance(x, torch.Tensor) or not x.requires_grad:
        return x
    return _ReplicatedIn.apply(x, group_of(axis))


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated_out(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as it is; each rank's gradient 1/size of what it is handed."""
    return _ReplicatedOut.apply(x, size_of(axis))


def ring(size: int) -> List[Tuple[int, int]]:
    """The one-hop ring j -> j + 1."""
    return [(j, (j + 1) % size) for j in range(size)]
