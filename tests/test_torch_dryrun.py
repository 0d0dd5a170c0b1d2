"""The port's dry run and roofline against the JAX package's, on the CPU.

``analysis/roofline.py`` keeps the JAX package's formulas with an H100's
peaks in place of a TPU v5e's; ``analysis/collectives.py`` keeps
``analysis/hlo.py``'s traffic formulas for the collectives the port
issues; ``analysis/report.py`` is a copy that reads
``results/dryrun_torch``.  ``launch/dryrun.py`` runs a cell's real step
on rank 0's meta blocks over a fake process group, in a subprocess here
(the group is the process's default one), with every kernel's plain
version and library loader patched to raise: the step must still run,
through the kernels' shape-only forms, with no tensor off the meta
device, no launch, no library and no CUDA.  Its argument bytes must equal
the JAX package's shard bytes from ``shardings_for`` on an 8-device host
mesh of the same shape (a JAX subprocess), its ``model_flops`` JAX's, and
the FLOPs of a dense prefill on one rank a hand count of its GEMMs plus
K5's work count.  Under ``SEQPAR_RULES`` (``seqpar``) a train cell keeps
``train``'s argument bytes, falls in temporaries by at least the stream
its remat units no longer keep and records reduce-scatters.  Under ``DECODE_RULES`` (``decode2d``) its decode cells
take the argument bytes of JAX's ``shardings_for`` under those rules, a
reduced qwen3-8b step issues the hand-counted activation collectives of
the hidden-split stream and no weight gather; its train cells take JAX's
argument bytes too, and the gathers of the stream's whole-width rows
(the MoE's) are reduce-scattered back in the backward.
"""
import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import hlo as JHLO
from repro.analysis import report as JREP
from repro.analysis import roofline as JRL
from repro.configs import cells as jcells
from repro_torch.analysis import collectives as CO
from repro_torch.analysis import report as REP
from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 4)
# (arch, shape, overrides of the reduced config, mesh): the cells whose
# argument bytes are held to JAX's
HELD = [("qwen3-8b", "train_4k", {}, MESH),
        ("qwen3-8b", "prefill_32k", {}, MESH),
        ("qwen3-moe-235b-a22b", "train_4k", {"moe_impl": "ep"}, MESH),
        ("qwen3-moe-235b-a22b", "prefill_32k", {"moe_impl": "ep"}, MESH)]
# decode cells on MESH whose argument and cache bytes are held to JAX's
# (the cache under its spec: the sequence over model, the SSD heads)
HELD_DECODE = [("qwen3-8b", "decode_32k", {}, MESH),
               ("qwen3-moe-235b-a22b", "decode_32k", {"moe_impl": "ep"}, MESH),
               ("recurrentgemma-2b", "decode_32k", {}, MESH),
               ("minicpm3-4b", "decode_32k", {}, MESH),
               ("mamba2-370m", "decode_32k", {}, MESH),
               ("whisper-medium", "decode_32k", {}, MESH)]
# the first two again under DECODE_RULES (``decode2d``): the weights
# resident, every data rank the whole token batch, the cache split
HELD_DECODE2D = HELD_DECODE[:2]
# train cells under DECODE_RULES whose argument bytes are held to JAX's
HELD_TRAIN2D = HELD[::2]
PLAIN = {"systolic_matmul": ["systolic_matmul_plain"],
         "vector_engine": ["fused_affine_act_plain", "quantize_int8_plain",
                           "dequantize_int8_plain"],
         "flash_attention": ["flash_attention_plain",
                             "flash_attention_bwd_plain"],
         "rglru": ["rglru_scan_plain", "rglru_scan_bwd_plain"],
         "ssd": ["ssd_scan_plain", "ssd_scan_bwd_plain"]}


def reduced(arch, **kw):
    """The reduced config's fields that differ from the full one's, and
    ``kw``: ``run_cell``'s overrides."""
    full, red = get_arch(arch), get_arch(arch).reduced()
    out = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
           if getattr(red, f.name) != getattr(full, f.name)}
    return {**out, **kw}


_TORCH = textwrap.dedent("""
    import dataclasses, importlib, json, sys, tempfile
    from pathlib import Path
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} ran in the dry run")
        return f

    plain = json.loads(sys.argv[2])
    for module, names in plain.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        mod._lib = refuse(f"{module}._lib")
        for n in names:
            setattr(mod, n, refuse(n))
            if hasattr(ops, n):
                setattr(ops, n, refuse(n))
    cells = json.loads(sys.argv[3])
    out = Path(tempfile.mkdtemp())
    recs = []
    for arch, shape, ov, mesh, rules in cells:
        rec = DR.run_cell(arch, shape, "x".join(map(str, mesh)), out, rules,
                          force=True, overrides=ov, mesh_shape=tuple(mesh))
        shp = DR.SHAPES_BY_NAME[shape]
        if rec["status"] == "ok" and shp.kind in ("decode", "train"):
            # the blocks a rank is given that the step hands back (the
            # cache; the parameters and the AdamW state), counted apart
            cfg = dataclasses.replace(DR.get_arch(arch), **ov)
            blocks = DR.cell_blocks(cfg, shp, DR.fake_mesh(
                tuple(mesh), ("data", "model")), DR.RULES[rules])
            if shp.kind == "decode":
                rec["cache_bytes"] = DR.tree_nbytes(blocks["cache"])
            else:
                rec["param_bytes"] = DR.tree_nbytes(blocks["params"])
                rec["opt_bytes"] = DR.tree_nbytes(blocks["opt"])
        recs.append(rec)
    # the vocabulary-parallel loss on a (2, 4) fake mesh: its collectives
    from repro_torch.analysis import collectives as CO
    from repro_torch.models import transformer as T
    mesh = DR.fake_mesh((2, 4), ("data", "model"))
    with CO.CollectiveCounter() as counter:
        T.softmax_xent(torch.zeros(2, 16, 8), torch.zeros(2, 16, dtype=
                       torch.int32), (mesh, 0))
    Path(sys.argv[1]).write_text(json.dumps(
        {"recs": recs, "loss": [list(c) for c in counter.records]}))
""")

_JAX = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs import SHAPES_BY_NAME, get_arch
    from repro.distributed import sharding as SH
    from repro.launch import steps as ST
    _at = getattr(jax.sharding, "AxisType", None)
    out = []
    for arch, shape, ov, mesh, rules in json.loads(sys.argv[2]):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **ov)
        shp = SHAPES_BY_NAME[shape]
        m = jax.make_mesh(tuple(mesh), ("data", "model"),
                          **({"axis_types": (_at.Auto,) * 2} if _at else {}))
        sh = ST.shardings_for(cfg, m, shp, getattr(SH, rules),
                              with_opt=shp.kind == "train")
        total = cache = 0
        for part in ("param", "opt", "batch", "cache"):
            if f"{part}_shapes" not in sh:
                continue
            key = "params" if part == "param" else part
            for s, ns in zip(jax.tree.leaves(sh[f"{part}_shapes"]),
                             jax.tree.leaves(sh[key])):
                nb = (int(np.prod(ns.shard_shape(s.shape)))
                      * np.dtype(s.dtype).itemsize)
                total += nb
                cache += nb if part == "cache" else 0
        out.append([total, cache])
    open(sys.argv[1], "w").write(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry runs (torch) and JAX's shard bytes, in two subprocesses
    started together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    cells = [(a, s, reduced(a, **ov), m, "train") for a, s, ov, m in HELD]
    cells.append(("qwen3-8b", "prefill_32k", reduced("qwen3-8b"), (1, 1),
                  "train"))
    cells += [(a, "train_4k", reduced(a, **({"moe_impl": "ep"}
                                             if get_arch(a).num_experts
                                             else {})), MESH, "train")
              for a in ARCHS]
    cells += [(a, "train_4k", reduced(a, **ov), (8, 1), "train")
              for a, _, ov, _ in HELD[::2]]
    cells += [("qwen3-8b", "train_4k", reduced("qwen3-8b"), MESH, "seqpar"),
              ("qwen3-8b", "long_500k", reduced("qwen3-8b"), MESH, "train"),
              ("mamba2-370m", "long_500k", reduced("mamba2-370m"), MESH,
               "train"),
              ("recurrentgemma-2b", "decode_32k",
               reduced("recurrentgemma-2b"), MESH, "train")]
    cells += [(a, "decode_32k", reduced(a, **ov), MESH, "train")
              for a, _, ov, _ in HELD[::2]]
    cells += [(a, s, reduced(a, **ov), m, "train")
              for a, s, ov, m in HELD_DECODE[3:]]
    cells += [(a, s, reduced(a, **ov), m, "decode2d")
              for a, s, ov, m in HELD_DECODE2D]
    cells += [(a, s, reduced(a, **ov), m, "decode2d")
              for a, s, ov, m in HELD_TRAIN2D]
    tp = subprocess.Popen(
        [sys.executable, "-c", _TORCH, str(tmp / "torch.json"),
         json.dumps(PLAIN), json.dumps(cells)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jp = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "jax.json"),
         json.dumps([(a, s, ov, m, "TRAIN_RULES")
                     for a, s, ov, m in HELD + HELD_DECODE]
                    + [(a, s, ov, m, "DECODE_RULES")
                       for a, s, ov, m in HELD_DECODE2D + HELD_TRAIN2D])],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    outs = [p.communicate(timeout=300)[0] for p in (tp, jp)]
    assert tp.returncode == 0, outs[0][-4000:]
    assert jp.returncode == 0, outs[1][-4000:]
    got = json.loads((tmp / "torch.json").read_text())
    return {"recs": got["recs"], "cells": cells,
            "loss_collectives": got["loss"],
            "jax_bytes": json.loads((tmp / "jax.json").read_text())}


# -- roofline ----------------------------------------------------------------
def test_model_flops_equal_jax_for_every_cell():
    for arch, shape, _ in jcells():
        cfg = get_arch(arch.name)
        assert RL.active_params(cfg) == JRL.active_params(arch), arch.name
        assert (RL.model_flops(cfg, SHAPES_BY_NAME[shape.name])
                == JRL.model_flops(arch, shape)), (arch.name, shape.name)


def test_roofline_terms_are_jax_formulas_at_h100_peaks(monkeypatch):
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 450e9)
    monkeypatch.setattr(JRL, "PEAK_FLOPS", RL.PEAK_FLOPS)
    monkeypatch.setattr(JRL, "HBM_BW", RL.HBM_BW)
    monkeypatch.setattr(JRL, "ICI_BW", RL.LINK_BW)
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c, m = (float(x) for x in rng.uniform(1e9, 1e15, 4))
        kw = dict(arch="a", shape="s", mesh="single", chips=256,
                  flops_per_chip=f, bytes_per_chip=b, coll_bytes_per_chip=c,
                  model_flops_total=m, peak_memory_bytes=1e9)
        assert RL.RooflineTerms(**kw).to_dict() == \
            JRL.RooflineTerms(**kw).to_dict()


@pytest.mark.parametrize("kind", CO.KINDS)
def test_collective_traffic_matches_hlo_formulas(kind):
    for dt, esz in (("bf16", 2), ("f32", 4)):
        for dims in ((8, 16), (3, 5, 7), (1,)):
            for g in (1, 2, 4, 16):
                line = (f"  %x = {dt}[{','.join(map(str, dims))}]{{1,0}} "
                        f"{kind}(%p), replica_groups=[{64 // g},{g}]<=[64]")
                want = JHLO.collective_stats(line)
                rb = math.prod(dims) * esz
                got = CO.collective_stats([CO.Collective(kind, rb, g)])
                assert got == want, (line, got, want)


def test_kernel_bounds_follow_their_work():
    """Each bound is the larger of the work's bytes over HBM and its
    operations over the peak of the operand type."""
    nb, ops_ = RL.k5_work(2, 8, 2, 300, 500, 64, True, 128, torch.bfloat16)
    assert ops_ == 2 * 2 * 8 * 128 * sum(
        min(q, 499) - max(0, q - 127) + 1 for q in range(300))
    ms, by = RL.k5_bound(2, 8, 2, 300, 500, 64, True, 128, torch.bfloat16)
    assert ms == max(1e3 * nb / RL.HBM_BW, 1e3 * ops_ / RL.PEAK_FLOPS)
    for Sq, Skv, causal, window in ((7, 7, True, 0), (64, 128, False, 16),
                                    (100, 40, True, 8), (5, 9, False, 0)):
        q = np.arange(Sq)[:, None]
        k = np.arange(Skv)[None, :]
        keep = np.ones((Sq, Skv), bool)
        if causal:
            keep &= k <= q
        if window:
            keep &= (q - k) < window
        assert RL.attn_pairs(Sq, Skv, causal, window) == int(keep.sum())


# -- report ------------------------------------------------------------------
def test_report_is_a_copy_and_gives_jax_tables():
    want = re.sub(r"\brepro\.", "repro_torch.",
                  (ROOT / "src/repro/analysis/report.py").read_text())
    want = want.replace("results/dryrun]", "results/dryrun_torch]").replace(
        '"results/dryrun"', '"results/dryrun_torch"')
    assert (ROOT / "src/repro_torch/analysis/report.py").read_text() == want
    recs = []
    for i, (arch, shape) in enumerate([("qwen3-8b", "train_4k"),
                                       ("mamba2-370m", "decode_32k"),
                                       ("qwen3-8b", "prefill_32k")]):
        terms = RL.RooflineTerms(arch, shape, "single", 256, 1e12 * (i + 1),
                                 3e11, 2e9 * i, 5e14, 7e10)
        recs.append({"arch": arch, "shape": shape, "mesh": "single",
                     "rules": "train", "status": "ok",
                     "roofline": terms.to_dict(),
                     "memory": {"peak_bytes": 7e10, "argument_bytes": 2e10,
                                "temp_bytes": 4e10},
                     "raw": {"real": {"coll_detail": {
                         "all-gather": {"count": 3 + i}}}}})
    recs.append({"arch": "qwen3-8b", "shape": "long_500k", "mesh": "single",
                 "rules": "train", "status": "skipped", "reason": "quadratic"})
    assert REP.roofline_table(recs) == JREP.roofline_table(recs)
    assert REP.dryrun_table(recs) == JREP.dryrun_table(recs)


# -- the dry run -------------------------------------------------------------
def _rec(runs, arch, shape, mesh=MESH, rules="train"):
    for (a, s, _, m, r), rec in zip(runs["cells"], runs["recs"]):
        if (a, s, tuple(m), r) == (arch, shape, tuple(mesh), rules):
            return rec
    raise KeyError((arch, shape, mesh, rules))


def test_dry_run_needs_no_card_and_no_kernel(runs):
    """Every cell ran with the plain versions and library loaders raising,
    no operator saw a tensor on a card or (but M-RoPE's table of frequency
    bands) on the host, and no kernel launched, no library loaded and CUDA
    never started."""
    ok = [r for r in runs["recs"] if r["status"] == "ok"]
    assert len(ok) >= len(ARCHS) + len(HELD) + 1
    for r in ok:
        real = r["raw"]["real"]
        assert real["card_tensor_ops"] == 0, r["arch"]
        mrope = get_arch(r["arch"]).rope == "mrope"
        assert (real["host_tensor_ops"] > 0) == mrope, r["arch"]
        assert set(r["kernel_launches"].values()) == {0}, r["arch"]
        assert r["libraries_loaded"] == [] and not r["cuda_initialized"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_trains_in_the_dry_run(runs, arch):
    rec = _rec(runs, arch, "train_4k")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    real = rec["raw"]["real"]
    assert real["flops"] > 0 and real["bytes"] > 0
    # the step updates the parameters and the AdamW state in place and
    # hands them back: the JAX package's donated train step
    # (src/repro/launch/dryrun.py:64, donate_argnums=(0, 1)), whose
    # outputs alias those arguments; JAX's peak = argument + temp + output
    # - alias, with no negative term
    m = rec["memory"]
    assert m["alias_bytes"] == rec["param_bytes"] + rec["opt_bytes"] > 0
    assert m["temp_bytes"] >= 0
    assert m["peak_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                               + m["output_bytes"] - m["alias_bytes"])
    assert m["peak_bytes"] >= (m["argument_bytes"] + m["output_bytes"]
                               - m["alias_bytes"])
    # over a (2, 4) mesh the step gathers and reduces over its ranks
    assert real["coll_bytes"] > 0 and "all-reduce" in real["coll_detail"]


@pytest.mark.parametrize("i", range(len(HELD)))
def test_argument_bytes_equal_jax_shard_bytes(runs, i):
    arch, shape, _, mesh = HELD[i]
    rec = _rec(runs, arch, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["memory"]["argument_bytes"] == runs["jax_bytes"][i][0]


@pytest.mark.parametrize("i", range(len(HELD_DECODE)))
def test_decode_cache_bytes_equal_jax_spec_blocks(runs, i):
    """Rank 0's decode arguments, and its cache within them, take the
    bytes of the JAX package's ``shardings_for`` blocks: the cache split
    along the sequence over ``model`` (and the SSD state by heads)."""
    arch, shape, _, mesh = HELD_DECODE[i]
    rec = _rec(runs, arch, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback", rec)
    total, cache = runs["jax_bytes"][len(HELD) + i]
    assert rec["cache_bytes"] == cache > 0
    assert rec["memory"]["argument_bytes"] == total


@pytest.mark.parametrize("i", range(len(HELD_DECODE2D)))
def test_decode2d_argument_bytes_equal_jax_spec_blocks(runs, i):
    """Under ``DECODE_RULES`` rank 0's decode arguments take the bytes of
    JAX's ``shardings_for`` blocks under those rules, the cache its block
    split over data by batch and over model by sequence; against the
    ``TRAIN_RULES`` cell only the token batch grows: every data rank holds
    the whole of it."""
    arch, shape, _, mesh = HELD_DECODE2D[i]
    rec = _rec(runs, arch, shape, mesh, "decode2d")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    total, cache = runs["jax_bytes"][len(HELD) + len(HELD_DECODE) + i]
    assert rec["cache_bytes"] == cache > 0
    assert rec["memory"]["argument_bytes"] == total
    train = _rec(runs, arch, shape, mesh)
    assert rec["cache_bytes"] == train["cache_bytes"]
    B = SHAPES_BY_NAME[shape].global_batch
    assert (rec["memory"]["argument_bytes"]
            - train["memory"]["argument_bytes"]) == 4 * (B - B // mesh[0])


def test_decode2d_collectives_are_counted(runs):
    """A (2, 4) ``DECODE_RULES`` decode step of the reduced qwen3-8b, the
    whole batch of B tokens on every rank: all-reduces of the embedding
    over ``model`` (the rank's D/2 columns), the final norm's sum of
    squares and the logits' partials over ``data``, and a layer's eight:
    its two norms' sums of squares and the q|k|v and w1|w3 partials over
    ``data``, the split softmax's max and sums, ``wo`` and ``w2`` over
    ``model``; all-gathers of a layer's q, K and V heads over ``model``
    and of the attention output over the cache's batch rows (``data``),
    and of the logits over the vocabulary.  No weight is gathered."""
    cfg = get_arch("qwen3-8b").reduced()
    rec = _rec(runs, "qwen3-8b", "decode_32k", MESH, "decode2d")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    det = rec["raw"]["real"]["coll_detail"]
    assert cfg.dtype == "float32" and MESH == (2, 4)
    L, B = cfg.num_layers, SHAPES_BY_NAME["decode_32k"].global_batch
    D, Dh, F, Vp = (cfg.d_model, cfg.resolved_head_dim, cfg.d_ff,
                    cfg.padded_vocab)
    H, KV = cfg.num_heads // 4, cfg.num_kv_heads // 4
    rows = B // 2
    # the softmax over the cache's rows, every head: the max, then the
    # weighted values and the weights' sums in one
    Hw = cfg.num_heads
    layer = [B, B * (H + 2 * KV) * Dh,               # ln, q|k|v
             rows * Hw, rows * Hw * (Dh + 1),        # max, sums
             B * D // 2, B, B * 2 * F // 4, B * D // 2]  # wo, ln, w1|w3, w2
    reduce = [B * D // 2] + layer * L + [B, B * Vp // 4]
    assert det["all-reduce"]["count"] == len(reduce)
    assert det["all-reduce"]["result_bytes"] == 4 * sum(reduce)
    gather = ([B * cfg.num_heads * Dh, 2 * B * cfg.num_kv_heads * Dh,
               B * cfg.num_heads * Dh] * L + [B * Vp])
    assert det["all-gather"]["count"] == 4 * L + 1
    assert det["all-gather"]["result_bytes"] == 4 * sum(gather)
    assert set(det) == {"all-reduce", "all-gather"}


@pytest.mark.parametrize("i", range(len(HELD_TRAIN2D)))
def test_decode2d_train_argument_bytes_equal_jax_spec_blocks(runs, i):
    """A ``train_4k`` cell under ``DECODE_RULES`` runs, and rank 0's
    arguments (its parameter and AdamW moment blocks, the whole token
    batch) take the bytes of JAX's ``shardings_for`` blocks under those
    rules: against the ``TRAIN_RULES`` cell the parameters and moments
    are the same blocks (FSDP over data, TP and the experts over model)
    and only the batch grows, every data rank holding the whole of it."""
    arch, shape, _, mesh = HELD_TRAIN2D[i]
    rec = _rec(runs, arch, shape, mesh, "decode2d")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    total, _ = runs["jax_bytes"][len(HELD) + len(HELD_DECODE)
                                 + len(HELD_DECODE2D) + i]
    assert rec["memory"]["argument_bytes"] == total
    train = _rec(runs, arch, shape, mesh)
    assert (rec["param_bytes"], rec["opt_bytes"]) == (
        train["param_bytes"], train["opt_bytes"])
    shp = SHAPES_BY_NAME[shape]
    B = shp.global_batch
    assert (rec["memory"]["argument_bytes"]
            - train["memory"]["argument_bytes"]) == (
        2 * 4 * (B - B // mesh[0]) * shp.seq_len)


def test_decode2d_train_gathers_are_reduce_scattered_back(runs):
    """The reduced qwen3-moe (``ep``) ``train_4k`` cell over (2, 4) under
    ``DECODE_RULES``: each layer's MoE gathers the rank's D / 2 columns of
    the stream's B S rows whole over ``data`` (twice under remat, beside
    the three expert leaves' reshards, which gather their fsdp dim over
    data as the ``ep`` in_specs ask), and the backward carries each of
    the stream's gathers back by one reduce-scatter over ``data`` in
    fp32, its output the rank's B S D / 2 block.  The reduced qwen3-8b's
    cell, whose heads divide over ``model``, gathers nothing and
    reshards no dense leaf."""
    cfg = get_arch("qwen3-moe-235b-a22b").reduced()
    rec = _rec(runs, "qwen3-moe-235b-a22b", "train_4k", MESH, "decode2d")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert cfg.dtype == "float32" and cfg.remat
    det = rec["raw"]["real"]["coll_detail"]
    shp = SHAPES_BY_NAME["train_4k"]
    L, B, S, D = (cfg.num_layers, shp.global_batch, shp.seq_len,
                  cfg.d_model)
    assert det["reduce-scatter"]["count"] == L
    assert det["reduce-scatter"]["result_bytes"] == L * B * S * D // 2 * 4
    assert det["all-gather"]["count"] == 2 * L * (1 + 3)
    stream = 2 * L * B * S * D * 4
    assert stream < det["all-gather"]["result_bytes"] < 1.01 * stream
    dense = _rec(runs, "qwen3-8b", "train_4k", MESH, "decode2d")
    assert dense["status"] == "ok", dense.get("traceback", dense)
    assert set(dense["raw"]["real"]["coll_detail"]) == {"all-reduce"}


def test_dense_prefill_flops_are_its_gemms_and_k5(runs):
    """At (1, 1): per layer q, o and the K/V projections twice (the
    cache's and attention's: ROADMAP lists the second as waste), the
    gated MLP's three, and K5's two products, causal with no window,
    over the S (S + 1) / 2 pairs of each head; the head over the last
    position."""
    rec = _rec(runs, "qwen3-8b", "prefill_32k", (1, 1))
    c = get_arch("qwen3-8b").reduced()
    shape = SHAPES_BY_NAME["prefill_32k"]
    B, S = shape.global_batch, shape.seq_len
    D, H, KV, Dh, F = (c.d_model, c.num_heads, c.num_kv_heads,
                       c.resolved_head_dim, c.d_ff)
    gemms = 2 * B * S * (2 * D * H * Dh + 4 * D * KV * Dh + 3 * D * F)
    assert not c.sliding_window
    k5 = 2 * B * H * S * (S + 1) // 2 * (Dh + Dh)
    want = c.num_layers * (gemms + k5) + 2 * B * D * c.padded_vocab
    assert rec["raw"]["real"]["flops"] == want


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-235b-a22b"])
def test_train_flops_lie_in_the_model_flops_band(runs, arch):
    """test_system.py's band for JAX's dry run: counted FLOPs x chips over
    MODEL_FLOPS in (0.9, 12), over eight ranks of data and over (2, 4).
    There TP's compute split gives a rank along ``model`` its heads,
    columns and vocabulary block of the dense layers: a dense rank does
    under 1.25 times the work of a rank of (8, 1) (before the split, with
    every dense leaf gathered whole, exactly 4 times)."""
    want = RL.model_flops(get_arch(arch).reduced(),
                          SHAPES_BY_NAME["train_4k"])
    t = _rec(runs, arch, "train_4k", (8, 1))["roofline"]
    tp = _rec(runs, arch, "train_4k")["roofline"]
    for r in (t, tp):
        assert r["model_flops_total"] == want
        assert 0.9 < r["flops_per_chip"] * r["chips"] / want < 12
    if not get_arch(arch).num_experts:
        assert tp["flops_per_chip"] < 1.25 * t["flops_per_chip"]


def test_tp_collectives_are_counted(runs):
    """A (2, 4) prefill of the reduced qwen3-8b sums over ``model`` once
    for the vocabulary-parallel embedding and twice for each layer
    (attention's ``wo`` and the MLP's ``w2``, row-parallel: the prefill
    computes on TP's blocks), and gathers the cache's K/V heads and the
    last position's logits over the vocabulary; at (1, 1) it issues no
    collective.
    The vocabulary-parallel loss issues its MAX all-reduce and its two
    ``psum``s, each of the (B, S) fp32 rows (``analysis.collectives``
    counts all three)."""
    cfg = get_arch("qwen3-8b").reduced()
    rec = _rec(runs, "qwen3-8b", "prefill_32k")
    det = rec["raw"]["real"]["coll_detail"]
    assert det["all-reduce"]["count"] == 1 + 2 * cfg.num_layers
    shape = SHAPES_BY_NAME["prefill_32k"]
    act = shape.global_batch // MESH[0] * shape.seq_len * cfg.d_model
    assert cfg.dtype == "float32"       # every sum of 4-byte elements
    assert det["all-reduce"]["result_bytes"] == (
        1 + 2 * cfg.num_layers) * act * 4
    assert "all-gather" in det
    one = _rec(runs, "qwen3-8b", "prefill_32k", (1, 1))["raw"]["real"]
    assert one["coll_detail"] == {}
    loss = runs["loss_collectives"]
    assert [c[0] for c in loss] == ["all-reduce"] * 3
    assert all(c[1] == 2 * 16 * 4 and c[2] == 4 for c in loss)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-2b"])
def test_decode_memory_counts_the_returned_cache_once(runs, arch):
    """A decode step updates the cache it is given in place and hands it
    back: those output bytes alias the arguments, and the record keeps
    JAX's peak = argument + temp + output - alias with no negative
    term."""
    rec = _rec(runs, arch, "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    m = rec["memory"]
    assert m["alias_bytes"] == rec["cache_bytes"] > 0
    assert m["temp_bytes"] >= 0
    assert m["peak_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                               + m["output_bytes"] - m["alias_bytes"])


def test_seqpar_cell_keeps_the_rank_s_rows_of_the_stream(runs):
    """The reduced qwen3-8b ``train_4k`` cell over (2, 4) under
    ``SEQPAR_RULES`` runs: its arguments are the ``train`` cell's bytes
    (the same parameter, moment and batch blocks), which are JAX's
    ``shardings_for``; its temporaries fall by at least the stream the
    remat units keep, by hand: each of the L layers' inputs, a rank's
    B / 2 sequences of S tokens of width D in fp32, is S / 4 rows where
    ``train`` keeps S; its row-parallel sums are reduce-scatters (none
    under ``train``), beside the sequence's all-gathers, and its
    all-reduces move a small part of ``train``'s bytes."""
    cfg = get_arch("qwen3-8b").reduced()
    rec = _rec(runs, "qwen3-8b", "train_4k", rules="seqpar")
    train = _rec(runs, "qwen3-8b", "train_4k")
    assert rec["status"] == "ok", rec.get("traceback", rec)
    m, t = rec["memory"], train["memory"]
    assert m["argument_bytes"] == t["argument_bytes"] == runs["jax_bytes"][
        0][0]
    shape = SHAPES_BY_NAME["train_4k"]
    B, S = shape.global_batch // MESH[0], shape.seq_len
    assert cfg.dtype == "float32" and S % MESH[1] == 0
    saved = cfg.num_layers * B * (S - S // MESH[1]) * cfg.d_model * 4
    assert t["temp_bytes"] - m["temp_bytes"] >= saved > 0
    assert m["peak_bytes"] < t["peak_bytes"]
    det, tdet = (rec["raw"]["real"]["coll_detail"],
                 train["raw"]["real"]["coll_detail"])
    assert det["reduce-scatter"]["count"] > 0
    assert "reduce-scatter" not in tdet
    assert det["all-gather"]["count"] > tdet["all-gather"]["count"]
    assert (det["all-reduce"]["result_bytes"]
            < tdet["all-reduce"]["result_bytes"] / 100)


def test_refusals_and_skips(runs):
    assert _rec(runs, "qwen3-8b", "long_500k")["status"] == "skipped"
    for arch, shape in (("mamba2-370m", "long_500k"),
                        ("recurrentgemma-2b", "decode_32k")):
        rec = _rec(runs, arch, shape)
        assert rec["status"] == "ok", rec.get("traceback", rec)
        assert "cache_seq over model" in rec["cache_layout"]


def test_argument_bytes_are_what_a_real_rank_holds(tmp_path):
    """On 4 gloo ranks over (2, 2) and (1, 4), the reduced qwen3-moe
    (``ep``) and qwen3-8b: each rank's placed parameters, batch block and
    AdamW state take the dry run's argument bytes, and its reduced
    gradient one moment's (``chip_smoke.py`` phase 17 holds the same at
    full width on the card)."""
    from repro_torch.launch import mesh as M
    from torch_mesh_ranks import held_bytes_rank
    cases = [("qwen3-moe-235b-a22b", (2, 2), {"moe_impl": "ep"}, 4, 32),
             ("qwen3-moe-235b-a22b", (1, 4), {"moe_impl": "ep"}, 4, 32),
             ("qwen3-8b", (2, 2), {}, 4, 32)]
    M.run_ranks(held_bytes_rank, 4, cases, str(tmp_path), timeout_s=300)
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        for i in range(len(cases)):
            held, dry, grad, moment = got[str(i)]
            assert held == dry and grad == moment, (r, cases[i])


# -- the kernels' shape-only forms -------------------------------------------
def _meta(*ts):
    return [None if t is None else t.to("meta") for t in ts]


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_only_forms_match_the_plain_versions(dtype):
    from repro_torch.kernels import (flash_attention as FA, rglru as RG,
                                     ssd as SS, systolic_matmul as SM,
                                     vector_engine as VE)
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=dtype: torch.randn(*s, generator=g).to(dt)
    x, w, b = r(5, 12), r(12, 7), r(7)
    _same(SM.systolic_matmul(*_meta(x, w, b), act="relu"),
          SM.systolic_matmul_plain(x, w, b, act="relu"))
    s, c = r(12, dt=torch.float32), r(12, dt=torch.float32)
    _same(VE.fused_affine_act(*_meta(x, s, c), out_dtype=torch.float32),
          VE.fused_affine_act_plain(x, s, c, out_dtype=torch.float32))
    amax = x.float().abs().amax(1)
    for given in (None, amax):
        _same(VE.quantize_int8(*_meta(x, given)),
              VE.quantize_int8_plain(x, given))
    qq, sc = VE.quantize_int8_plain(x)
    _same(VE.dequantize_int8(*_meta(qq, sc), out_dtype=dtype),
          VE.dequantize_int8_plain(qq, sc, out_dtype=dtype))
    q, k, v = r(2, 4, 9, 32), r(2, 2, 11, 32), r(2, 2, 11, 16)
    for lse in (False, True):
        _same(FA.flash_attention(*_meta(q, k, v), causal=True, window=4,
                                 return_lse=lse),
              FA.flash_attention_plain(q, k, v, causal=True, window=4,
                                       return_lse=lse))
    o, l = FA.flash_attention_plain(q, k, v, return_lse=True)
    _same(FA.flash_attention_bwd(*_meta(q, k, v, o, l, o)),
          FA.flash_attention_bwd_plain(q, k, v, o, l, o))
    xs, la, h0 = r(2, 6, 8), r(8, dt=torch.float32), r(2, 8,
                                                       dt=torch.float32)
    for keep in (False, True):
        _same(RG.rglru_scan(*_meta(xs, xs, xs, la, h0), keep_states=keep),
              RG.rglru_scan_plain(xs, xs, xs, la, h0, keep_states=keep))
    y, h32 = RG.rglru_scan_plain(xs, xs, xs, la, h0, keep_states=True)
    _same(RG.rglru_scan_bwd(*_meta(xs, xs, xs, la, h0, h32, y)),
          RG.rglru_scan_bwd_plain(xs, xs, xs, la, h0, h32, y))
    xs, dt = r(2, 16, 4, 8), r(2, 16, 4, dt=torch.float32)
    A, Bm = r(4, dt=torch.float32), r(2, 16, 1, 8)
    h0 = r(2, 4, 8, 8, dt=torch.float32)
    _same(SS.ssd_scan(*_meta(xs, dt, A, Bm, Bm), chunk=8,
                      h0=h0.to("meta")),
          SS.ssd_scan_plain(xs, dt, A, Bm, Bm, chunk=8, h0=h0))
    _, _, states = SS.ssd_scan(*_meta(xs, dt, A, Bm, Bm), chunk=8,
                               keep_states=True)
    assert tuple(states.shape) == (2, 4, 1, 8, 8)    # one 64-row chunk
    _, st = SS.ssd_scan_plain(xs, dt, A, Bm, Bm, chunk=8, h0=h0)
    _same(SS.ssd_scan_bwd(*_meta(xs, dt, A, Bm, Bm, h0, xs, st),
                          states=states, chunk=8),
          SS.ssd_scan_bwd_plain(xs, dt, A, Bm, Bm, h0, xs, st, chunk=8))
