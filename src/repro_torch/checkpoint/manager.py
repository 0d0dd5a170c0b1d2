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
card); there is no mesh to re-shard onto.  ``keep`` bounds disk usage.
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


def save(ckpt_dir: str, step: int, tree: Pytree, *,
         extras: Optional[Dict] = None, keep: int = 3) -> str:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = tree_leaves(tree)
    meta = {
        "step": step,
        "treedef": _treedef(tree),
        "n_leaves": len(leaves),
        "extras": extras or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
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


def restore(ckpt_dir: str, template: Pytree, *, step: Optional[int] = None,
            device=None) -> Tuple[Pytree, int, Dict]:
    """Restore into the structure of ``template`` (shapes must match), every
    leaf on ``device`` (None: the card)."""
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
    out = []
    for i, (tmpl, info) in enumerate(zip(leaves, meta["leaves"])):
        arr = np.load(d / f"leaf_{i}.npy")
        expect = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {i}: shape {arr.shape}, want {expect}")
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(dev))
    return tree_unflatten(template, out), step, meta["extras"]
