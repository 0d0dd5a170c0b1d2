"""Collectives over the axes of a ``DeviceMesh`` that carry a gradient:
the port's counterpart of the transposes JAX applies when it
differentiates through ``shard_map``.

- ``psum(x, mesh, axis)``: ``lax.psum``.  The sum over the axis's ranks,
  out of place; its backward is the same all-reduce of the cotangent
  (JAX transposes ``psum`` to ``psum``).
- ``all_gather_tiled(x, mesh, axis)``: ``lax.all_gather(..., tiled=True)``
  on dim 0, the blocks in the axis's rank order (``mesh.get_local_rank``).
  JAX transposes it to ``psum_scatter``; gloo on CUDA tensors has neither
  reduce-scatter nor all-to-all, so the backward is an all-reduce of the
  cotangent and this rank's block of it.

The training step (``launch.steps``) makes the rest of JAX's transpose
explicit: every rank scales its loss by 1 / (the mesh's ranks), and after
the backward each leaf's gradient is summed over the ranks that hold the
same block of it (``reduce_``, in place, no gradient), so that the sum over
the ranks of each rank's share is the gradient of the global mean.

``reduce_`` and ``gather_block`` work one axis at a time, which serves a
mesh over a subset of the world's ranks as well as one over all of them.
Every collective runs on the tensors' own device, as NCCL needs; gloo
takes CUDA tensors through the host.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import P, mesh_shape


class _Psum(torch.autograd.Function):

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


class _AllGatherTiled(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group, ctx.index, ctx.n = group, index, n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        size = g.shape[0] // ctx.n
        return g.narrow(0, ctx.index * size, size).clone(), None, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable."""
    return _Psum.apply(x, mesh.get_group(axis))


def all_gather_tiled(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated on dim 0 in the axis's
    order, differentiable."""
    return _AllGatherTiled.apply(x, mesh.get_group(axis),
                                 mesh.get_local_rank(axis),
                                 mesh_shape(mesh)[axis])


def live_axes(mesh, axes: Sequence[str]) -> tuple:
    """The axes of ``axes`` that have more than one rank."""
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if shape.get(a, 1) > 1)


def reduce_(t: torch.Tensor, mesh, axes: Sequence[str],
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ranks of each axis of ``axes`` in
    turn (one of a single rank is skipped); returns ``t``.  Every rank
    ends with the same bytes."""
    for a in live_axes(mesh, axes):
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def split_axes(spec: P) -> tuple:
    """The mesh axes a block spec splits some dim over, in dim order."""
    out = []
    for part in spec:
        if part is not None:
            out.extend((part,) if isinstance(part, str) else part)
    return tuple(out)


def gather_block(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under ``spec``
    (``sharding.local_block``'s inverse), on every rank: one all-gather an
    axis, the minor axis of a dim split over several first."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in reversed((part,) if isinstance(part, str) else part):
            n = mesh_shape(mesh)[a]
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
            t = torch.cat(parts, dim=dim)
            del parts
    return t
