"""Dry run of every (arch x shape x mesh) cell: the port's counterpart of
the JAX package's ``launch/dryrun.py``, and the one entry point that needs
no card.

For each cell this driver:
  1. starts a ``fake`` process group of the production mesh's ranks
     (16 x 16 = 256 single-pod, 2 x 16 x 16 = 512 multi-pod) as rank 0, and
     over it a ``DeviceMesh`` that names no card (``launch.mesh.make_mesh``
     asks ``device.resolve`` for one);
  2. builds rank 0's blocks as ``meta`` tensors (shape and dtype, no
     storage): every parameter under ``transformer.param_block_specs``,
     the AdamW moments alike, the batch and the cache under
     ``steps.shardings_for``'s specs;
  3. runs the real step of ``steps.make_train_step`` (whose AdamW
     update writes the parameters and moments in place, JAX's donation),
     ``make_prefill_step`` or ``make_decode_step`` on them once, eagerly,
     and counts as it goes: FLOPs with ``torch.utils.flop_counter``
     (each hand-written kernel through its shape-only form at its
     ``analysis.roofline`` work count), bytes accessed as each operator's
     inputs plus outputs (views and allocations move none), the
     collectives as ``analysis.collectives`` records them, and the peak of
     live bytes with ``torch.distributed._tools.mem_tracker.MemTracker``;
  4. turns them into roofline terms at the H100's peaks
     (``analysis.roofline``) and writes one resumable JSON per cell under
     ``--out``, in the JAX dry run's schema, which ``analysis.report``
     reads.

It allocates no real tensor, initialises no CUDA context, builds and
loads no kernel and runs no kernel's plain version: each launch function
hands its meta tensors to its shape-only form (``kernels.shape_only``).
The record keeps the proof: the operators that saw a tensor on a card
(none) or on the host (none but M-RoPE's, which builds its 16-entry
table of frequency bands there), every kernel's launch count (0), the
kernel libraries loaded (none) and whether CUDA was initialised (no).  The meta
device stands in for JAX's ShapeDtypeStructs: autograd runs on it, where
on a build of torch without CUDA it cannot take a fake tensor on ``cuda``.

An eager count sees every layer, so there are no L0/L1 variants: ``raw``
holds ``real`` only.  Four operators' output sizes depend on the data:
``bincount`` of the routing (sized by its ``minlength``, the experts,
which the ids lie below), ``nonzero`` of the kept assignments and
``unique`` of the tokens (both counted at their bound: every element
kept, every token distinct).  Over a mesh the decode cache is each rank's
block under the JAX package's spec (``sharding.cache_specs``: the batch
over ``pod``/``data``, the sequence over ``model`` where it divides, the
SSD state's heads over ``model``), the layout the port's decode keeps.
``seqpar`` cells run with the residual stream split over ``model``
along the sequence between blocks (the parameters' blocks are
``train``'s; a layer's remat unit keeps the rank's rows, and its row-
parallel sums are reduce-scatters beside the sequence's all-gathers).
``decode2d`` cells run with the weights resident, the residual stream
split over ``data`` along the hidden dim and the batch over ``pod``
alone; a train cell's backward counts the reduce-scatters that carry
the hidden-split stream's gathers back.  ``long_500k`` is skipped on a
quadratic arch, as in the JAX dry run.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import collectives as CO
from repro_torch.analysis import roofline as RL
from repro_torch.configs import SHAPES_BY_NAME, TrainConfig, cells, get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SHD
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

RULES = {"train": SHD.TRAIN_RULES, "tp": SHD.TP_RULES,
         "seqpar": SHD.SEQPAR_RULES, "decode2d": SHD.DECODE_RULES}
# the hand-written kernels' launch functions, by module
LAUNCHES = {"systolic_matmul": ("systolic_matmul",),
            "vector_engine": ("fused_affine_act", "quantize_int8",
                              "dequantize_int8"),
            "flash_attention": ("flash_attention", "flash_attention_bwd"),
            "lindley": ("lindley_scan",),
            "rglru": ("rglru_scan", "rglru_scan_bwd"),
            "ssd": ("ssd_scan", "ssd_scan_bwd")}


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------

def _blocks(shapes, specs, mesh, device):
    """``shapes``' tree of tensors (anything with ``shape`` and ``dtype``)
    as empty blocks under ``specs``' tree on ``device``."""
    return tree_map(lambda s, sp: torch.empty(
        SHD.block_shape(s.shape, sp, mesh), dtype=s.dtype, device=device),
        shapes, specs)


def cell_blocks(cfg: ModelConfig, shape: ShapeConfig, mesh, rules=None,
                device="meta") -> Dict[str, object]:
    """Rank 0's blocks of one cell's arguments on ``mesh``: ``params``
    (``transformer.param_block_specs`` of ``rules``), for a train cell
    ``opt`` (the AdamW state, its moments in the parameters' blocks),
    ``batch`` and for a decode cell ``cache`` (its blocks under
    ``steps.shardings_for``'s cache specs, the JAX package's: the batch
    over ``pod``/``data``, the sequence and the SSD heads over
    ``model``).  Every rank of a mesh holds blocks of the same shapes."""
    rules = rules or SHD.TRAIN_RULES
    pspec = T.param_block_specs(cfg, mesh, rules)
    sh = ST.shardings_for(cfg, mesh, shape, rules,
                          with_opt=shape.kind == "train")
    out = {"params": _blocks(sh["param_shapes"], pspec, mesh, device)}
    if shape.kind == "train":
        o = sh["opt_shapes"]
        out["opt"] = adamw.AdamWState(
            step=torch.empty(o.step.shape, dtype=o.step.dtype, device=device),
            mu=_blocks(o.mu, pspec, mesh, device),
            nu=_blocks(o.nu, pspec, mesh, device))
    out["batch"] = _blocks(sh["batch_shapes"], sh["batch"], mesh, device)
    if shape.kind == "decode":
        out["cache"] = _blocks(sh["cache_shapes"], sh["cache"], mesh, device)
    return out


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def alias_nbytes(out, args) -> int:
    """The bytes of ``out``'s tensors that share storage with a tensor of
    ``args``: a decode step hands back the cache it was given, updated in
    place, and a train step the parameters and the AdamW state (the JAX
    package's train step donates both, ``donate_argnums=(0, 1)``).
    Storage identity holds on meta and fake tensors too."""
    from torch.multiprocessing.reductions import StorageWeakRef
    held = {StorageWeakRef(t.untyped_storage()) for t in tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor)
               and StorageWeakRef(t.untyped_storage()) in held)


# ---------------------------------------------------------------------------
# the fake mesh
# ---------------------------------------------------------------------------

def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group of its
    ranks, this process rank 0: its collectives return at once and move
    nothing.  The group is started here (and an earlier one of another
    size ended); no card is asked for."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return DeviceMesh("cpu", torch.arange(world).view(*shape),
                      mesh_dim_names=tuple(names))


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.new_empty.default, _aten.new_empty_strided.default,
                _aten.empty_like.default}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _moves_bytes(func) -> bool:
    """Operators that read or write memory: not views (whose results alias
    an input and write nothing), allocations or collectives."""
    if func.namespace == "c10d" or func in _ALLOCATIONS:
        return False
    rets = func._schema.returns
    return not (rets and all(r.alias_info is not None
                             and not r.alias_info.is_write for r in rets))


class StepCounter(CO.CollectiveCounter):
    """The collectives of ``CollectiveCounter``, the bytes each operator
    accesses (``bytes``), and the data-dependent sizes at their bounds."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.card = 0       # operators that saw a tensor on a card
        self.host = 0       # ... or one on the host (not a wrapped scalar)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten.bincount.default:
            # the routing's expert ids lie below minlength, the experts
            x = args[0]
            weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            out = x.new_empty((n,), dtype=torch.int64 if weights is None
                              else weights.dtype)
        elif func is _aten.nonzero.default:
            x = args[0]          # every element kept
            out = x.new_empty((x.numel(), x.dim()), dtype=torch.int64)
        elif func is _aten._unique2.default:
            x = args[0]          # every element distinct
            counts = (kwargs.get("return_counts", args[3] if len(args) > 3
                                 else False))
            out = (x.new_empty((x.numel(),)),
                   x.new_empty(x.shape, dtype=torch.int64),
                   x.new_empty((x.numel() if counts else 0,),
                               dtype=torch.int64))
        else:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        if _moves_bytes(func):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        kinds = {t.device.type for t in _tensors((args, kwargs, out))
                 if t.dim() or t.device.type != "cpu"}
        self.card += bool(kinds - {"meta", "cpu"})
        self.host += "cpu" in kinds
        return out


def kernel_launches() -> Dict[str, int]:
    """Every hand-written kernel's launch count in this process."""
    import importlib
    out = {}
    for module, names in LAUNCHES.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        out.update({n: getattr(mod, n).launches for n in names})
    return out


def _step(cfg, shape, mesh, rules, blocks):
    baxes = SHD.batch_axes(shape.global_batch, rules, mesh)
    if shape.kind == "train":
        fn = ST.make_train_step(cfg, TrainConfig(), mesh=mesh,
                                batch_axes=baxes, rules=rules)
        return fn(blocks["params"], blocks["opt"], blocks["batch"])
    if shape.kind == "prefill":
        fn = ST.make_prefill_step(cfg, mesh=mesh, batch_axes=baxes,
                                  rules=rules)
        return fn(blocks["params"], blocks["batch"])
    fn = ST.make_decode_step(cfg, mesh=mesh, batch_axes=baxes, rules=rules,
                             seq=shape.seq_len)
    return fn(blocks["params"], blocks["cache"], blocks["batch"])


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, rules) -> dict:
    """Run one cell's step on rank 0's meta blocks, counted: the JAX dry
    run's ``real`` metrics and memory."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    blocks = cell_blocks(cfg, shape, mesh, rules)
    args = tree_nbytes(blocks)
    mem = MemTracker()
    mem.track_external(*tree_leaves(blocks))
    flops = FlopCounterMode(display=False)
    counter = StepCounter()
    t0 = time.time()
    with mem, flops, counter:
        out = _step(cfg, shape, mesh, rules, blocks)
    t_run = time.time() - t0
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    outs = tree_nbytes(out)
    alias = alias_nbytes(out, blocks)
    coll = counter.stats()
    rec = {
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "coll_bytes": sum(v["traffic_bytes"] for v in coll.values()),
        "coll_detail": coll,
        "card_tensor_ops": counter.card,
        "host_tensor_ops": counter.host,
        "t_run_s": t_run,
    }
    # JAX's peak = argument + temp + output - alias
    rec["memory"] = {"argument_bytes": args, "output_bytes": outs,
                     "temp_bytes": peak - args - outs + alias,
                     "alias_bytes": alias, "code_bytes": 0,
                     "peak_bytes": peak}
    return rec


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path,
             rules_name: str = "train", force: bool = False,
             overrides: dict = None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """One cell's record, written to ``out_dir`` (and read back from there
    unless ``force``).  ``mesh_name`` is ``single`` or ``multi``, or any
    name for ``mesh_shape``, a (data, model) or (pod, data, model)
    shape."""
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape_name]
    tag = f"{arch}__{shape_name}__{mesh_name}__{rules_name}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "rules": rules_name, "status": "ok"}
    if shape.name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full attention (quadratic); skipped per assignment rules"
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    if mesh_shape is None:
        dims, names = production_mesh_shape(multi_pod=(mesh_name == "multi"))
    else:
        dims = tuple(mesh_shape)
        names = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                          "model")
    rules = RULES[rules_name]
    period = len(cfg.block_pattern)
    groups = cfg.num_layers // period

    try:
        t0 = time.time()
        mesh = fake_mesh(dims, names)
        real = count_step(cfg, shape, mesh, rules)
        chips = math.prod(dims)
        mf = RL.model_flops(cfg, shape)
        terms = RL.RooflineTerms(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            flops_per_chip=real["flops"], bytes_per_chip=real["bytes"],
            coll_bytes_per_chip=real["coll_bytes"], model_flops_total=mf,
            peak_memory_bytes=real["memory"]["peak_bytes"])
        from repro_torch.kernels import _build
        rec.update(
            chips=chips, groups=groups, period=period,
            raw={"real": real},
            corrected={k: real[k] for k in ("flops", "bytes", "coll_bytes")},
            memory=real["memory"],
            roofline=terms.to_dict(),
            kernel_launches=kernel_launches(),
            libraries_loaded=sorted(_build._LIBS),
            cuda_initialized=torch.cuda.is_initialized(),
            wall_s=time.time() - t0,
        )
        if shape.kind == "decode":
            rec["cache_layout"] = ("each rank's block under the JAX "
                                   "package's cache spec (cache_batch, "
                                   "cache_seq over model, SSD heads)")
        print(f"[dryrun] {tag}: dominant={terms.dominant} "
              f"compute={terms.compute_s:.4f}s memory={terms.memory_s:.4f}s "
              f"coll={terms.collective_s:.4f}s frac={terms.roofline_fraction:.3f} "
              f"peakGB={real['memory']['peak_bytes']/1e9:.2f} "
              f"wall={rec['wall_s']:.0f}s", flush=True)
        print(f"  memory: {real['memory']}", flush=True)
        print(f"  counts: flops/chip={real['flops']:.3e} "
              f"bytes/chip={real['bytes']:.3e} "
              f"coll/chip={real['coll_bytes']:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        print(f"[dryrun] {tag}: FAILED {rec['error']}", flush=True)

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=float))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--rules", default="train")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(a.name, s.name) for a, s, _ in cells()]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    n_ok = n_skip = n_err = 0
    for arch, shape in todo:
        for mesh_name in meshes:
            rec = run_cell(arch, shape, mesh_name, out_dir, args.rules,
                           force=args.force)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            n_err += rec["status"] == "error"
    print(f"[dryrun] done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
