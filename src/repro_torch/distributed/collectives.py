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
- ``all_gather_dim(x, mesh, axis, dim)``: ``lax.all_gather(..., tiled=
  True)`` on any dim.  Its backward is JAX's transpose, a reduce-scatter:
  the cotangent summed over the axis **in fp32** and cut to the rank's
  block, rounded once to ``x``'s dtype.
- ``psum_scatter(x, mesh, axis, dim)``: ``lax.psum_scatter(...,
  tiled=True)``.  The sum over the axis in fp32, cut to the rank's block
  along ``dim`` and rounded once to ``x``'s dtype; its backward is an
  all-gather of the cotangent (JAX's transpose), not an all-reduce.
  Both reduce-scatters are one reduce-scatter call on NCCL and on
  the dry run's ``fake`` group; gloo has none on CUDA tensors, so there
  they all-reduce the fp32 sum and cut it: the same arithmetic.

The training step (``launch.steps``) makes the rest of JAX's transpose
explicit: every rank scales its loss by 1 / (the mesh's ranks), and after
the backward each leaf's gradient is summed over the ranks that hold the
same block of it (``reduce_``, in place, no gradient), so that the sum over
the ranks of each rank's share is the gradient of the global mean.

- ``reshard(x, src, dst, mesh)``: a block of one tensor taken from its
  block under one spec to its block under another, the step GSPMD takes
  between a parameter's sharding and the layout an op wants.  It gathers
  every dim that ``src`` splits and ``dst`` does not (or splits over
  other axes), then cuts the rank's ``dst`` block; its backward is the
  transpose: the cotangent put into zeros where the cut took it, summed
  **in fp32** over the gathered axes (an all-reduce: gloo has no
  reduce-scatter on CUDA tensors) and cut to the rank's ``src`` block,
  rounded once to ``x``'s dtype.  A bf16 sum through gloo rounds at every
  add (1.1e-2 of qwen3-moe's logits over four ranks on an H100).

``reduce_`` and ``gather_block`` work one axis at a time, which serves a
mesh over a subset of the world's ranks as well as one over all of them.
Every collective runs on the tensors' own device, as NCCL needs; gloo
takes CUDA tensors through the host.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (P, block_index, mesh_coords,
                                              mesh_shape)


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


# ``reduce_scatter_tensor`` under its newer name where torch has it
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _scatter_sum(t: torch.Tensor, group, index: int, n: int,
                 dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in fp32, this rank's ``index`` of
    ``n`` blocks along ``dim``, rounded once to ``t``'s dtype."""
    dtype = t.dtype
    full = t.float().movedim(dim, 0).contiguous()
    if dist.get_backend(group) in ("nccl", "fake"):
        out = full.new_empty((full.shape[0] // n,) + full.shape[1:])
        _reduce_scatter(out, full, group=group)
    else:
        dist.all_reduce(full, group=group)
        size = full.shape[0] // n
        out = full.narrow(0, index * size, size)
    return out.movedim(0, dim).to(dtype).contiguous()


def _gather_cat(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along ``dim`` in
    the group's order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGatherDim(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, index, n, dim):
        ctx.group, ctx.index, ctx.n, ctx.dim = group, index, n, dim
        return _gather_cat(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_sum(g, ctx.group, ctx.index, ctx.n, ctx.dim), None,
                None, None, None)


class _PsumScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, index, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter_sum(x, group, index, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.group, ctx.n, ctx.dim), None, None, None, None


def _axis(mesh, axis: str):
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh_shape(mesh)[axis])


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated on ``dim`` in the axis's
    order, differentiable (the backward a reduce-scatter in fp32)."""
    return _AllGatherDim.apply(x, *_axis(mesh, axis), dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axis`` (summed in fp32), differentiable (the backward an
    all-gather)."""
    return _PsumScatter.apply(x, *_axis(mesh, axis), dim)


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


def _gather_dim(t: torch.Tensor, dim: int, part, mesh) -> torch.Tensor:
    """The blocks of every rank along the axes of ``part`` (a name or a
    tuple, the first the major) concatenated on ``dim``: one all-gather an
    axis, the minor first."""
    for a in reversed((part,) if isinstance(part, str) else part):
        n = mesh_shape(mesh)[a]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts, dim=dim)
        del parts
    return t


def gather_block(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under ``spec``
    (``sharding.local_block``'s inverse), on every rank."""
    for dim, part in enumerate(spec):
        if part is not None:
            t = _gather_dim(t, dim, part, mesh)
    return t


def _live_part(spec: P, dim: int, mesh):
    """``spec``'s entry for ``dim`` without its axes of one rank: None, a
    name or a tuple of names."""
    part = spec[dim] if dim < len(spec) else None
    live = live_axes(mesh, () if part is None else
                     ((part,) if isinstance(part, str) else part))
    return None if not live else (live[0] if len(live) == 1 else live)


def _moves(ndim: int, src: P, dst: P, mesh):
    """(the dims to gather and their ``src`` parts, the dims to cut and
    their ``dst`` parts) that take a ``src`` block to a ``dst`` block."""
    gathers, cuts = [], []
    for d in range(ndim):
        a, b = _live_part(src, d, mesh), _live_part(dst, d, mesh)
        if a != b:
            if a is not None:
                gathers.append((d, a))
            if b is not None:
                cuts.append((d, b))
    return tuple(gathers), tuple(cuts)


class _Reshard(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, gathers, cuts):
        ctx.mesh, ctx.gathers, ctx.cuts = mesh, gathers, cuts
        coords = mesh_coords(mesh)
        t = x
        for d, part in gathers:            # every gather before any cut
            t = _gather_dim(t, d, part, mesh)
        for d, part in cuts:
            i, n = block_index(part, mesh, coords)
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
        # a cut is a view of x or of the gathered tensor: a copy of its own
        return t.clone(memory_format=torch.contiguous_format) if cuts else t

    @staticmethod
    def backward(ctx, g):
        mesh, coords = ctx.mesh, mesh_coords(ctx.mesh)
        dtype = g.dtype
        g = g.float()
        for d, part in reversed(ctx.cuts):  # zeros where the cut took g
            i, n = block_index(part, mesh, coords)
            shape = list(g.shape)
            shape[d] *= n
            full = g.new_zeros(shape)
            full.narrow(d, i * g.shape[d], g.shape[d]).copy_(g)
            g = full
        for d, part in reversed(ctx.gathers):
            g = g.contiguous()
            reduce_(g, mesh, (part,) if isinstance(part, str) else part)
            i, n = block_index(part, mesh, coords)
            size = g.shape[d] // n
            g = g.narrow(d, i * size, size)
        return g.to(dtype).contiguous(), None, None, None


def moves(ndim: int, src: P, dst: P, mesh) -> bool:
    """A block under ``src`` is not the block under ``dst`` on some rank."""
    return any(_moves(ndim, src, dst, mesh))


def reshard(x: torch.Tensor, src: P, dst: P, mesh) -> torch.Tensor:
    """This rank's block under ``dst`` of the tensor whose block under
    ``src`` is ``x``, differentiable; ``x`` itself where the blocks are
    the same."""
    gathers, cuts = _moves(x.dim(), src, dst, mesh)
    if not gathers and not cuts:
        return x
    return _Reshard.apply(x, mesh, gathers, cuts)
