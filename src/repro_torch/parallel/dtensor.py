"""DTensor mechanics of the sharded path: the test for a DTensor, a
redistribute that moves no data over mesh dims of one rank, ``local_map``
with gradient placements, the collectives on plain local tensors, and the
two autograd functions that move a block of rows between the ranks that
hold it and the ranks that work on it.

Nothing here reads the model's shard context (``models.layers``'s): each
function takes its mesh and its axes. ``torch.distributed`` is imported
only once a DTensor exists.
"""
from __future__ import annotations

from typing import Tuple

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def redistribute(x, want):
    """DTensor ``x`` in the placements ``want``. Where it differs only on
    mesh dims of one rank no data moves, so the local tensor is re-tagged
    (exactly what the collective over one rank would give)."""
    mesh = x.device_mesh
    if tuple(x.placements) == tuple(want):
        return x
    if all(mesh.size(i) == 1 for i, (a, b) in enumerate(zip(x.placements, want))
           if a != b):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.redistribute(mesh, want)


def _grad_placements(pl, work):
    """The gradient placements of an input with placements ``pl`` to a local
    computation sharded as ``work`` (per mesh dim, whether some input is
    sharded there): a replicated input gets a Partial sum where the work is
    split, its own placement elsewhere."""
    from torch.distributed.tensor import Partial
    return [Partial() if (w and pl_i.is_replicate()) else pl_i
            for pl_i, w in zip(pl, work)]


def local_map(fn, out_placements, *args, grads=None):
    """``fn`` on the local shards of its DTensor arguments, its outputs
    wrapped with ``out_placements`` (``torch.distributed.tensor.experimental
    .local_map``). A DTensor argument keeps its placements; its gradient's
    come from ``grads`` (a dict: argument index -> placements) or else
    ``_grad_placements`` against the mesh dims where any argument is
    sharded. Other arguments pass as they are."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map as _lm
    from torch.distributed.tensor.placement_types import Placement
    dts = [a for a in args if is_dtensor(a)]
    mesh = dts[0].device_mesh
    work = [any(isinstance(a.placements[i], Shard) for a in dts)
            for i in range(mesh.ndim)]
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None for a in args)
    in_grad = tuple(
        None if pl is None else tuple((grads or {}).get(i) or
                                      _grad_placements(pl, work))
        for i, pl in enumerate(in_pl))
    if all(isinstance(o, Placement) for o in out_placements):
        out_placements = list(out_placements)     # one output
    else:
        out_placements = tuple(list(o) for o in out_placements)
    return _lm(fn, out_placements=out_placements, in_placements=in_pl,
               in_grad_placements=in_grad, device_mesh=mesh)(*args)


def sharded_on(x, tensor_dim: int, axis) -> bool:
    """Whether DTensor ``x`` is sharded on ``tensor_dim`` over mesh axis
    ``axis``."""
    if not axis:
        return False
    pl = x.placements[list(x.device_mesh.mesh_dim_names).index(axis)]
    return pl.is_shard(tensor_dim)


def _group(mesh, axis):
    return mesh.get_group(list(mesh.mesh_dim_names).index(axis))


def axes_size(mesh, axes) -> int:
    """The number of ranks over the mesh axes ``axes``."""
    n = 1
    for axis in axes:
        n *= mesh.size(list(mesh.mesh_dim_names).index(axis))
    return n


def all_gather(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``t`` gathered along ``dim`` over the mesh axes ``axes`` (the first
    outermost), no autograd; an axis of one rank is skipped (``t`` itself
    comes back when every axis is)."""
    import torch.distributed as dist
    for axis in reversed(tuple(axes)):
        g = _group(mesh, axis)
        n = dist.get_world_size(g)
        if n == 1:
            continue
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim)
    return t


def all_reduce(t: torch.Tensor, mesh, axes, op=None,
               inplace: bool = False) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over the mesh axes ``axes``, no
    autograd; in a new tensor unless ``inplace``."""
    import torch.distributed as dist
    if not inplace:
        t = t.clone()
    for axis in axes:
        g = _group(mesh, axis)
        if dist.get_world_size(g) > 1:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=g)
    return t


def block_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's block along a dim split over ``axes``, the number of
    blocks), the first axis outermost."""
    idx, n = 0, 1
    for axis in axes:
        size = mesh.size(list(mesh.mesh_dim_names).index(axis))
        idx, n = idx * size + mesh.get_local_rank(axis), n * size
    return idx, n


def gather_rows(t: torch.Tensor, lo: int, n: int, mesh, axes) -> torch.Tensor:
    """The block [n, ...] whose rows ``lo .. lo + len(t)`` are this rank's
    ``t`` and whose other rows are the other ranks' of ``axes``: each rank
    writes its rows into zeros and the blocks are summed (one nonzero term
    per row, so the sum is exact), no autograd. The ranks' rows may differ
    in number, and some may have none."""
    out = t.new_zeros((n,) + tuple(t.shape[1:]))
    out[lo:lo + t.shape[0]] = t
    return all_reduce(out, mesh, axes, inplace=True)


class GatherRows(torch.autograd.Function):
    """Forward: ``gather_rows(t, lo, n, mesh, axes)``. Backward: the
    block's gradient summed over ``axes`` and the mesh axes ``work_axes``
    (the ranks that worked on the block, each on its part), then this
    rank's rows cut out."""

    @staticmethod
    def forward(ctx, t, lo, n, mesh, axes, work_axes):
        ctx.lo, ctx.rows, ctx.mesh = lo, t.shape[0], mesh
        ctx.sum_axes = tuple(axes) + tuple(work_axes)
        return gather_rows(t, lo, n, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.mesh, ctx.sum_axes)
        return g[ctx.lo:ctx.lo + ctx.rows], None, None, None, None, None


class SumRows(torch.autograd.Function):
    """Forward: partial sums [n, ...] of a block added over the mesh axes
    ``axes``, and this rank's rows ``lo .. lo + rows`` kept. Backward: the
    gradient of those rows written into zeros and summed over ``grad_axes``
    (the ranks that hold the block's rows), so every rank has the whole
    block's."""

    @staticmethod
    def forward(ctx, t, lo, rows, mesh, axes, grad_axes):
        ctx.lo, ctx.n, ctx.mesh, ctx.grad_axes = lo, t.shape[0], mesh, grad_axes
        return all_reduce(t, mesh, axes)[lo:lo + rows].clone()

    @staticmethod
    def backward(ctx, g):
        return (gather_rows(g, ctx.lo, ctx.n, ctx.mesh, ctx.grad_axes),
                None, None, None, None, None)
