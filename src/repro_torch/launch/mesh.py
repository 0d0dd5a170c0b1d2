"""Meshes of ranks: the JAX package's ``launch/mesh.py``.

A mesh is a ``torch.distributed.DeviceMesh`` over a process group that the
caller has initialised, with the backend of the caller's choosing (NCCL
for one card a rank, gloo where ranks share a card or run on the CPU):
nothing here picks or falls back to a backend.  The mesh path keeps its
collectives on the tensors' own device, as NCCL needs, but has run only
under gloo so far (on the CPU, and ranks sharing one card).  ``init_group`` starts a
group from a ``file://`` store in a directory the caller names, so
concurrent runs (tests under several workers) never race for a TCP port.
``run_ranks`` starts the ranks of one host as processes (spawned, so a
parent that has started CUDA can start them) under a deadline.  The
production shapes are data, as functions, so importing this module
touches no device or group.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Single pod: 16 x 16 = 256 ranks ("data", "model"); multi-pod: 2 x 16
    x 16 = 512 ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_group(store_dir: str, rank: int, world_size: int, backend: str,
               timeout_s: float = 600.0) -> None:
    """``dist.init_process_group`` for rank ``rank`` of ``world_size`` on
    ``backend``, rendezvousing through the file ``store_dir/store`` (the
    directory must be the same for every rank and the file absent before
    the first)."""
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s))


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the initialised
    default group, its tensors on ``device`` (None: the card).  Raises if no
    group is initialised or the group's size is not the product of
    ``shape``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised; call "
                           "launch.mesh.init_group (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_mesh: a {tuple(shape)} mesh needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    if len(names) != len(shape):
        raise ValueError(f"make_mesh: {len(shape)} dims, names {names}")
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_local_mesh(device=None) -> DeviceMesh:
    """(1, world) over ("data", "model"): every rank of the group on the
    model axis."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no process group is initialised")
    return make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device=device)


def run_ranks(fn: Callable, world: int, *args, timeout_s: float = 600.0
              ) -> None:
    """Run ``fn(rank, world, store_dir, *args)`` in ``world`` processes
    started by spawn (``fn`` importable by name), each to call
    ``init_group(store_dir, rank, world, backend)`` with the backend it
    chooses.  Waits at most ``timeout_s``: past it, or when a rank raises,
    every rank still running is killed (one that dies can leave the others
    blocked in a collective) and this raises."""
    import torch.multiprocessing as mp
    store_dir = tempfile.mkdtemp(prefix="mesh-store-")
    ctx = mp.start_processes(fn, args=(world, store_dir) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_ranks: {world} ranks of "
                                   f"{getattr(fn, '__name__', fn)} still "
                                   f"running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
