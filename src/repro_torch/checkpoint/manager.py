"""Checkpointing with atomic commits, as the JAX package's
``checkpoint/manager.py`` lays it out on disk.

Layout:  <dir>/step_<N>/
            index.json          tree structure, shapes, dtypes, step, extras
            leaf_<i>.npy        one file per tree leaf

Leaves are numbered in ``tree_leaves`` order (dict keys sorted, lists,
tuples and NamedTuples in order), the JAX package's.  Writes go to
``step_<N>.tmp`` and are atomically renamed, so a crash mid-save never
corrupts the latest checkpoint (restart safety).  A bfloat16 leaf, which
numpy has no type for, is stored as the JAX package stores it: a 2-byte
void (``<V2``) ``.npy`` of its bits with ``"bfloat16"`` in ``index.json``,
so the two packages' files are byte-equal.  ``restore`` reads those bits as
int16 first, which also takes the ``<i2`` files of the port's older
checkpoints.  ``restore`` puts every leaf on one named device (None: the
card).  ``keep`` bounds disk usage.

Over a mesh (``mesh`` and ``specs``, the spec of the block each rank holds
of each leaf) every rank calls ``save``: each split leaf is gathered whole
over its axes, one leaf at a time, and the mesh's first rank writes the
whole tree, so the files are the one-card layout; a barrier over the mesh
follows the commit.  ``restore`` with a mesh gives each rank its block of
each leaf, so a checkpoint written over any mesh (or one card) restores
onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as SH
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


def _treedef(tree: Pytree) -> str:
    """The structure of ``tree`` with ``*`` for each leaf."""
    return str(tree_map(lambda _: "*", tree))


def _save_bf16_bits(path: Path, bits: np.ndarray) -> None:
    """``np.save`` of bf16 bits with the header that numpy writes for an
    ``ml_dtypes.bfloat16`` array (descr ``<V2``), which plain numpy cannot
    make: a ``V2`` view alone would say ``|V2``."""
    bits = np.ascontiguousarray(bits)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": bits.shape})
        f.write(bits.tobytes())


def _mesh_barrier(mesh) -> None:
    coll.reduce_(torch.zeros(1, device=mesh.device_type), mesh,
                 tuple(SH.mesh_shape(mesh)))


def save(ckpt_dir: str, step: int, tree: Pytree, *,
         extras: Optional[Dict] = None, keep: int = 3, mesh=None,
         specs: Optional[Pytree] = None) -> str:
    """Write ``tree`` as step ``step``; over ``mesh`` every rank calls it
    with its blocks and ``specs`` (a spec a leaf) and the first rank
    writes."""
    leaves = tree_leaves(tree)
    if mesh is None:
        return _write(Path(ckpt_dir), step, tree, iter(leaves), extras, keep)
    whole = (coll.gather_block(t, sp, mesh) if sp else t
             for t, sp in zip(leaves, tree_leaves(specs, is_leaf=SH.is_spec)))
    if SH.is_first_rank(mesh):
        path = _write(Path(ckpt_dir), step, tree, whole, extras, keep)
    else:
        for _ in whole:       # the gathers are collectives: every rank joins
            pass
        path = str(Path(ckpt_dir) / f"step_{step:08d}")
    _mesh_barrier(mesh)
    return path


def _write(base: Path, step: int, tree: Pytree, whole, extras, keep) -> str:
    """Write the whole leaves ``whole`` yields (``tree``'s, in order) under
    ``base/step_<step>``, atomically, and drop all but the ``keep``
    newest."""
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    meta = {
        "step": step,
        "treedef": _treedef(tree),
        "n_leaves": len(tree_leaves(tree)),
        "extras": extras or {},
        "leaves": [],
    }
    for i, leaf in enumerate(whole):
        t = torch.as_tensor(leaf).detach().cpu()
        dtype = str(t.dtype).split(".")[1]
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy()
            _save_bf16_bits(tmp / f"leaf_{i}.npy", arr)
        else:
            arr = t.numpy()
            np.save(tmp / f"leaf_{i}.npy", arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    (tmp / "index.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit

    # retention
    ckpts = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _block(arr: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's block of ``arr`` under ``spec`` (a copy)."""
    coords = SH.mesh_coords(mesh)
    idx = []
    for dim, part in enumerate(spec):
        if part is None:
            idx.append(slice(None))
            continue
        i, n = SH.block_index(part, mesh, coords)
        size = arr.shape[dim] // n
        idx.append(slice(i * size, (i + 1) * size))
    return np.ascontiguousarray(arr[tuple(idx)])


def restore(ckpt_dir: str, template: Pytree, *, step: Optional[int] = None,
            device=None, mesh=None, specs: Optional[Pytree] = None
            ) -> Tuple[Pytree, int, Dict]:
    """Restore into the structure of ``template`` (shapes must match), every
    leaf on ``device`` (None: the card); over ``mesh``, ``template`` holds
    the rank's blocks and each leaf is cut to its block under ``specs``."""
    dev = resolve(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "index.json").read_text())

    leaves = tree_leaves(template)
    if len(leaves) != meta["n_leaves"]:
        raise ValueError(f"tree structure changed: {len(leaves)} leaves, the "
                         f"checkpoint has {meta['n_leaves']}")
    spec_leaves = (tree_leaves(specs, is_leaf=SH.is_spec) if mesh is not None
                   else [SH.P()] * len(leaves))
    out = []
    for i, (tmpl, info, spec) in enumerate(zip(leaves, meta["leaves"],
                                               spec_leaves)):
        arr = np.load(d / f"leaf_{i}.npy", mmap_mode="r" if spec else None)
        if spec:
            arr = _block(arr, spec, mesh)
        expect = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {i}: shape {arr.shape}, want {expect}")
        if not arr.flags.writeable and dev.type == "cpu":
            arr = np.array(arr)     # the train step writes a leaf in place
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(dev))
    return tree_unflatten(template, out), step, meta["extras"]
