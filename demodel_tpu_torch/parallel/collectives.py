"""Collectives over a mesh (the port of
``demodel_tpu/parallel/collectives.py``).

The JAX package holds global arrays and lets XLA pick the collective a
layout change needs. The port runs one process per rank and holds each
rank's local shard, so these functions take the local shard and the
partition specs (tuples as in :mod:`~demodel_tpu_torch.sink.plan`:
per leading dim None, an axis name, or a tuple of axis names) and call
c10d on the mesh's sub-groups: NCCL between CUDA ranks, gloo between
CPU ranks. On a mesh outside a ``torch.distributed`` world (one process,
one device) every shard is the whole tensor and nothing is sent.

The JAX package's ``shard_map_nocheck`` has no counterpart: the port's
per-rank code is already the body of a ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from demodel_tpu_torch.parallel.mesh import Mesh, shard_index


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _dims(spec: tuple, ndim: int) -> list[tuple[str, ...]]:
    """Per dim, the axes that split it."""
    return [_axes(spec[d] if d < len(spec) else None) for d in range(ndim)]


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Concatenate ``x`` of every rank along ``axis`` on ``dim``, in the
    axis's rank order."""
    if not mesh.distributed:
        return x
    n = mesh.axis_size(axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    if not mesh.distributed:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, gather_dim: int,
                split_dim: int) -> torch.Tensor:
    """Switch which dim ``axis`` splits: ``x`` is split on ``gather_dim``
    and whole on ``split_dim``; the result is whole on ``gather_dim`` and
    split on ``split_dim``. One all-to-all."""
    n = mesh.axis_size(axis)
    send = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    return torch.cat(list(recv.unbind(0)), dim=gather_dim)


def redistribute(x: torch.Tensor, mesh: Mesh, src: tuple,
                 dst: tuple) -> torch.Tensor:
    """This rank's shard under ``dst`` from its shard ``x`` under ``src``.

    The least traffic the layouts allow: a dim whose axis moves to
    another dim is one all-to-all; a dim split under ``src`` but not
    ``dst`` is all-gathered (its axes innermost first); a dim split under
    ``dst`` only is sliced, with no traffic (``src=()`` takes this rank's
    shard of a whole tensor)."""
    if not mesh.distributed:
        return x
    cur = _dims(src, x.ndim)
    want = _dims(dst, x.ndim)
    # one axis moving from one dim to another: all-to-all
    for d, axes in enumerate(cur):
        if len(axes) == 1 and axes != want[d]:
            (a,) = axes
            to = [e for e, w in enumerate(want) if w == (a,) and not cur[e]]
            if to:
                x = _all_to_all(x, mesh, a, d, to[0])
                cur[d], cur[to[0]] = (), (a,)
    # gather what dst does not split the same way
    for d, axes in enumerate(cur):
        if axes and axes != want[d]:
            for a in reversed(axes):
                x = all_gather(x, mesh, a, dim=d)
            cur[d] = ()
    # slice what dst splits and x holds whole
    need = tuple(w if w and not c else None for w, c in zip(want, cur))
    if any(need):
        x = x[shard_index(mesh, need, tuple(x.shape))].contiguous()
    return x


def replicate(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """All-gather a shard so every rank holds the full tensor."""
    return redistribute(x, mesh, spec, ())


def allgather_axis(x: torch.Tensor, mesh: Mesh,
                   axis: str = "tp") -> torch.Tensor:
    """Explicit all-gather over one axis: ``x`` is this rank's block of a
    tensor split on dim 0 over ``axis``; every rank gets the tensor."""
    return all_gather(x, mesh, axis, dim=0)


def psum_across(x: torch.Tensor, mesh: Mesh,
                axis: str = "dp") -> torch.Tensor:
    """The elementwise sum of every rank's block over ``axis`` (the
    delivery checksum across hosts), on every rank. ``x`` is this rank's
    block of a tensor split on dim 0 over ``axis``."""
    if x.ndim == 0:
        raise ValueError("psum_across: a 0-d tensor has no leading dim to "
                         f"split over mesh axis {axis!r}")
    return all_reduce(x, mesh, axis)


def fingerprint(x: torch.Tensor, mesh: Mesh | None = None,
                spec: tuple = ()) -> torch.Tensor:
    """Content fingerprint: the fp32 sum, absolute sum and sum of squares
    of the tensor (float sums are layout-invariant up to reordering). With
    ``mesh`` and ``spec``, ``x`` is this rank's shard and the partial sums
    add up over the axes that split it, so every rank holding a copy of
    the tensor gets the same three numbers."""
    f = x.detach().float().reshape(-1)
    out = torch.stack([f.sum(), f.abs().sum(), (f * f).sum()])
    if mesh is not None:
        for axes in _dims(spec, x.ndim):
            for a in axes:
                out = all_reduce(out, mesh, a)
    return out


# ------------------------------------------------ differentiable (models)
#
# The operators of Megatron-style tensor parallelism and of a sequence
# split, each a pair of a forward collective and its adjoint: what the
# JAX package leaves to XLA's transposes. "Replicated" means every rank
# of the axis holds the same tensor and runs the same code after it, so
# the gradient arriving at a replicated tensor is the same on each rank.


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradients over the axis
    (the input of a column-parallel projection)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the axis forward (the output of a row-parallel
    projection); the gradient passes through."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather on ``dim`` forward; the backward keeps this rank's
    block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.axis_size(ctx.axis), ctx.mesh.coords[ctx.axis]
        return torch.chunk(g, n, dim=ctx.dim)[i].contiguous(), None, None, \
            None


class _ScatterTo(torch.autograd.Function):
    """This rank's block on ``dim`` of a replicated tensor forward; the
    backward gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n, i = mesh.axis_size(axis), mesh.coords[axis]
        return torch.chunk(x, n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SelectFrom(torch.autograd.Function):
    """``index_select`` of a replicated tensor forward (the ranks' index
    sets may overlap); the backward sums the scattered gradients over the
    axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, index):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.save_for_backward(index)
        ctx.shape = x.shape
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape).index_add_(ctx.dim, index, g)
        return all_reduce(full, ctx.mesh, ctx.axis), None, None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, mesh, axis, dim)


def scatter_to(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int) -> torch.Tensor:
    return _ScatterTo.apply(x, mesh, axis, dim)


def select_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int,
                index: torch.Tensor) -> torch.Tensor:
    return _SelectFrom.apply(x, mesh, axis, dim, index)
