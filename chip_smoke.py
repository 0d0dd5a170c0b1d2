#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, runs the
DSCS executor for every non-LM workload, and then serves the main path: 8
requests to a full-width ResNet-50 at 224x224 (``asset_damage``) and 8 to
the ViT of ``remote_sensing`` at 176x176, with every launch counter set to 0
just before and read just after.  The fleet slice follows: K6, the fp64
Lindley scan, byte for byte against its plain version; the sharded fleet
engine at the size of ``poisson-1m-f1024`` (10^6 requests, 1024 drives and
1024 CPU nodes, 8 shards), run ``segmented, cuda, cuda, segmented`` with the
cuda traces byte-identical to the numpy ones and K6 launched once for each
length bucket; and the Zipf-skewed solver of ``lindley-zipf-1m``.  The LM
slice last: K8, the Mamba-2 SSD chunk scan, against its plain version at
``tests/test_kernels.py``'s shapes, with h0, and at Mamba-2 370M's layer
shape in bf16 and fp32, with the grid that spreads its chunks over
clusters of blocks; ``serve("mamba2-370m", smoke=False)`` at full width
and depth (48 layers, bf16, batch 4, 1024-token prompts, 32 new tokens)
with K8 launched once per layer; at fp32 the served prefill against one
with K8's plain version swapped in, and decode == forward.  Phase 9, the
RecurrentGemma slice: K7, the RG-LRU scan, against its plain version at
``tests/test_kernels.py``'s shapes, a ragged one and the layer shape
(4, 1024, 2560) in fp32 and bf16; K5 at head dim 256; ``serve
("recurrentgemma-2b", smoke=False)`` at full width and depth (26 layers,
bf16, batch 4, 1024-token prompts, 32 new tokens) with K7 launched once per
rglru layer and K5 once per attention layer, profiled, and again with
4096-token prompts past the 2048-token window (the ring cache); at fp32 the
served prefill against one with K7's and K5's plain versions swapped in,
and decode == forward.  Phase 10, the training slice: K3 and K4, int8
quantize and dequantize, byte for byte against their plain versions (one
row of 215,482,368 elements among them, the stacked in_proj's gradient);
K8b, the SSD scan's gradient, against its plain version at
``tests/test_kernels.py``'s shapes in fp32 and at the layer shape in bf16,
and its grid;
the full model's loss and every gradient leaf at fp32 with K8/K8b and with
their plain versions; 10 AdamW steps of Mamba-2 370M at full width and
depth (bf16, batch 8 x 1024 tokens, int8 gradient compression) with 48 K8
and 48 K8b launches and one K3 and one K4 call per gradient leaf each
step (a K3 call launches two kernels, its absmax and quantize passes),
profiled; the launcher's ``train`` with a checkpoint that restores
byte for byte; and K7 refusing to cut an autograd graph.  Last, K1 (3xTF32
``wgmma``) at each distinct shape of a ResNet-50 request, with w in the
layout the request hands over, beside ``torch.matmul``, its tile plan and
both bounds (3xTF32 and the fp32 FMA pipes).  Any failed
check raises, so the exit code is non-zero.  fp32 products and
convolutions run without TF32 throughout (``allow_tf32 = False`` for both
cuBLAS and cuDNN), so the plain versions are true fp32 references.

Output: one line per check and timing, the card's name and power limit
from ``nvidia-smi``, a ``{"kernels": [...]}`` JSON line, and as the last
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import cProfile
import json
import math
import pstats
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12,     # fp32 FMA pipes, no tensor cores
                  "tf32": 495e12,       # tensor cores, TF32
                  "bfloat16": 989e12,   # tensor cores
                  "float64": 34e12}     # fp64 FMA pipes, no tensor cores
REQUESTS = 8
RESNET_LAUNCHES = 53                    # convolutions per ResNet-50 request
# The fleet at the size of benchmarks/bench_engine.py's poisson-1m-f1024:
# 1024 DSCS drives and 1024 CPU nodes, Poisson arrivals at utilisation 0.95,
# 10^6 requests, hedge budget 0.08 s, 8 shards; and its lindley-zipf-1m
# solver cell: 10^6 requests over 128 servers, Zipf(1.2) popularity.
FLEET = {"n_dscs": 1024, "n_cpu": 1024, "utilization": 0.95,
         "requests": 1_000_000, "hedge_budget_s": 0.08, "n_shards": 8}
ZIPF = {"requests": 1_000_000, "n_servers": 128, "zipf_s": 1.2}
# Mamba-2 370M at full width and depth (src/repro_torch/configs/
# mamba2_370m.py), served at batch 4 with 1024-token prompts and 32
# generated tokens; K8's layer shape (B, S, H, P, G, N) on that path.
MAMBA = "mamba2-370m"
SERVE = {"batch": 4, "prompt": 1024, "gen": 32}
MAMBA_CHUNK = 256
K8_LAYER = (4, 1024, 32, 64, 1, 128)
K8_CHUNK = 64                           # rows a K8 block walks at a time
# RecurrentGemma-2B at full width and depth (src/repro_torch/configs/
# recurrentgemma_2b.py), served at batch 4 with 1024-token prompts and 32
# new tokens, and with 4096-token prompts (past the 2048-token window: the
# ring cache) and 16; K7's layer shape (B, S, W) and K5's shapes (B, H, KV,
# Sq, Skv, D) on that path, causal with the model's window.
GEMMA = "recurrentgemma-2b"
GEMMA_SERVE = {"batch": 4, "prompt": 1024, "gen": 32}
GEMMA_RING = {"batch": 4, "prompt": 4096, "gen": 16}
K7_SHAPES = [(2, 64, 128), (4, 128, 256), (1, 32, 128), (3, 77, 200)]
K7_LAYER = (4, 1024, 2560)
K7_OPS = 17                 # fp32 operations a K7 element (gates, a, b, FMA)
K5_GEMMA = [(4, 10, 1, 1024, 1024, 256), (1, 10, 1, 4096, 4096, 256)]
GEMMA_WINDOW = 2048
# Mamba-2 370M trained at full width and depth: bf16, batch 8 of 1024
# tokens (chunk 256), int8 gradient compression, 10 steps of a 10-step
# cosine schedule with 2 warm-up steps; the fp32 gradient check at batch 2;
# the launcher's run; K8b's layer shape (B, S, H, P, G, N); K3's largest
# row, the stacked in_proj's gradient (48 x 1024 x 4384) as one row.
TRAIN = {"batch": 8, "seq": 1024, "steps": 10, "warmup": 2}
GRAD_CHECK = {"batch": 2, "seq": 1024}
LAUNCHER = {"steps": 2, "batch": 2, "seq": 1024}
K8B_LAYER = (8, 1024, 32, 64, 1, 128)
K3_ROW = 48 * 1024 * 4384


def bound(nbytes, ops_, dtype):
    """(least ms for the work, "bytes" or "operations"); dtype a torch dtype
    or a key of PEAK_OPS_PER_S."""
    key = dtype if isinstance(dtype, str) else str(dtype).split(".")[1]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops_ / PEAK_OPS_PER_S[key]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bounds(M, K, N, dtype):
    """K1's bound for the work it does, (ms, by): fp32 as three TF32
    products on the tensor cores (3xTF32), bf16 as one bf16 product; and
    the fp32 FMA pipes' bound of the same product (None for bf16)."""
    import torch
    esz = 4 if dtype == torch.float32 else 2
    nbytes, flops = (M * K + K * N + M * N) * esz, 2 * M * N * K
    if dtype != torch.float32:
        return bound(nbytes, flops, dtype), None
    return bound(nbytes, 3 * flops, "tf32"), bound(nbytes, flops, dtype)


def k1_ptxas(log):
    """{(dtype name, BM, BN): (registers, spilled bytes)} of each K1
    instance, from ptxas's -v lines."""
    out, key, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"matmul_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d+)E", ln)
        if m:
            key = ("float32" if m[1] == "f" else "bfloat16",
                   64 * int(m[2]), int(m[3]))
        elif key and "spill" in ln:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        elif key and "Used" in ln:
            out[key] = (int(re.search(r"Used (\d+) registers", ln)[1]), spill)
            key = None
    return out


def k6_bound(R, W):
    """K6 at (R, W): 24 B an element (t, s read, the start written) and 6
    fp64 operations; the serial chain along W is no part of this bound."""
    import torch
    return bound(24 * R * W, 6 * R * W, torch.float64)


def lindley_inputs(R, W, seed):
    """CPU float64 (t, s): sorted arrivals, rows zero-padded past a random
    length, as the solver's length buckets hand them over."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 1e3, size=(R, W)), axis=1)
    s = rng.uniform(1e-4, 2.0, size=(R, W))
    pad = np.arange(W)[None, :] >= rng.integers(W // 2 + 1, W + 1,
                                                size=R)[:, None]
    t[pad] = 0.0
    s[pad] = 0.0
    return torch.from_numpy(t), torch.from_numpy(s)


def check_k6(dev, time_ms, call_ms):
    """K6 byte for byte against its plain version on a CPU copy of the
    inputs (torch.cumsum on the card re-associates; on the CPU it gives
    numpy's bytes), and its times.  Returns the largest abs error (0)."""
    from repro_torch.kernels.lindley import lindley_scan, lindley_scan_plain
    k6_err = 0.0
    for (R, W) in [(3, 17), (128, 1024), (257, 4096), (1, 1 << 19)]:
        t_cpu, s_cpu = lindley_inputs(R, W, R + W)
        t, s = t_cpu.to(dev), s_cpu.to(dev)
        got = lindley_scan(t, s).cpu()
        want = lindley_scan_plain(t_cpu, s_cpu)
        if got.numpy().tobytes() != want.numpy().tobytes():
            raise AssertionError(
                f"K6 ({R}, {W}): not byte-equal to the plain version, max "
                f"abs err {(got - want).abs().max().item():.3e}")
        k6_err = max(k6_err, (got - want).abs().max().item())
        ms = time_ms(lambda: lindley_scan(t, s))
        plain = time_ms(lambda: lindley_scan_plain(t, s))
        bnd, by = k6_bound(R, W)
        print(f"K6 lindley_scan R={R} W={W} float64: byte-equal to the plain "
              f"version on a CPU copy (max_abs_err {k6_err:.1e}); ms={ms:.4f} "
              f"(per Python call {call_ms(lambda: lindley_scan(t, s)):.4f}) "
              f"plain_ms(on the card)={plain:.4f} library_ms=none "
              f"bound_ms={bnd:.4f} ({by})")
    return k6_err


def drive_fleet(dev, time_ms):
    """The fleet slice's path at real size, on K6; returns K6's entry of
    the kernels line, all but its max_abs_err (check_k6's)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lindley import lindley_scan, lindley_scan_plain
    from repro_torch.kernels.systolic_matmul import systolic_matmul
    from repro_torch.kernels.vector_engine import fused_affine_act

    # ---- 6. the second path: the sharded fleet on K6 ---------------------
    from repro_torch.core import lindley as L
    from repro_torch.core.arrivals import make_arrivals
    from repro_torch.core.engine import ClusterEngine
    from repro_torch.core.function import standard_pipeline
    from repro_torch.core.latency import LatencyModel
    from repro_torch.core.platforms import PLATFORMS

    pipes = [standard_pipeline(n)
             for n in ("asset_damage", "content_moderation")]
    lm = LatencyModel()
    svc = sum(lm.e2e(PLATFORMS["DSCS-Serverless"], p.workload, q=0.5)
              for p in pipes) / len(pipes)
    rate = FLEET["utilization"] * FLEET["n_dscs"] / svc
    duration = FLEET["requests"] / rate
    all_counters = (systolic_matmul, fused_affine_act, flash_attention,
                    lindley_scan)

    def fleet(backend):
        eng = ClusterEngine(n_dscs=FLEET["n_dscs"], n_cpu=FLEET["n_cpu"],
                            hedge_budget_s=FLEET["hedge_budget_s"], seed=0)
        t0 = time.perf_counter()
        tr = eng.run_sharded(pipes, arrivals=make_arrivals("poisson", rate),
                             duration_s=duration, n_shards=FLEET["n_shards"],
                             processes=1, backend=backend)
        torch.cuda.synchronize()
        return eng, tr, time.perf_counter() - t0

    # the segment lengths of every solve, recorded in the first (numpy) run:
    # the cuda runs must launch K6 once for each non-empty length bucket
    seg_lens = []
    real_solve = L.solve_segments

    def record_solve(seg, t, s, start, fin, *, backend):
        seg_lens.append(np.diff(seg))
        return real_solve(seg, t, s, start, fin, backend=backend)

    L.solve_segments = record_solve
    try:
        runs = [fleet("segmented")]
    finally:
        L.solve_segments = real_solve

    def bucket_shapes(lens):
        """(rows, width) of each non-empty power-of-two length bucket."""
        b = np.array([(int(v) - 1).bit_length() for v in lens[lens > 0]])
        return [(int(np.count_nonzero(b == w)), 1 << int(w))
                for w in np.unique(b)]

    buckets = [shp for lens in seg_lens for shp in bucket_shapes(lens)]
    fleet_launches = []
    for backend in ("cuda", "cuda", "segmented"):
        if backend == "cuda":
            for c in all_counters:
                c.launches = 0
        runs.append(fleet(backend))
        if backend == "cuda":
            fleet_launches.append([c.launches for c in all_counters])
    want_fleet = [0, 0, 0, len(buckets)]
    if any(n != want_fleet for n in fleet_launches) or not buckets:
        raise AssertionError(f"fleet launches K1/K2/K5/K6 {fleet_launches}, "
                             f"want {want_fleet} per cuda run")
    base_eng, base_tr, _ = runs[0]
    for (eng, tr, _), backend in zip(runs[1:], ("cuda", "cuda", "segmented")):
        for col in ("arrival", "finish", "winner", "drive", "start",
                    "service", "hedged", "dscs_finish", "cpu_finish"):
            if getattr(tr, col).tobytes() != getattr(base_tr, col).tobytes():
                raise AssertionError(f"fleet {backend}: column {col} differs "
                                     f"from the segmented run")
        if (tr.events != base_tr.events or eng._qstate != base_eng._qstate
                or eng._pstate != base_eng._pstate
                or dict(eng.telemetry.counters)
                != dict(base_eng.telemetry.counters)
                or eng.last_shard_stats["path"] != "partitioned"):
            raise AssertionError(f"fleet {backend}: books differ from the "
                                 f"segmented run")
    lat = base_tr.latency[base_tr.completed]
    if not (np.isfinite(lat).all() and lat.size == base_tr.n
            and base_tr.n > 0.99 * FLEET["requests"]):
        raise AssertionError(f"fleet: {lat.size} of {base_tr.n} requests "
                             f"completed with finite latency")
    walls = [w for _, _, w in runs]
    qs = base_eng.queue_stats()
    print(f"fleet poisson-1m-f1024: {base_tr.n} requests, {FLEET['n_dscs']} "
          f"DSCS + {FLEET['n_cpu']} CPU, rate {rate:.1f}/s, {duration:.3f} s "
          f"simulated, {FLEET['n_shards']} shards, processes=1; host wall s "
          f"segmented {walls[0]:.3f}, cuda {walls[1]:.3f}, cuda "
          f"{walls[2]:.3f}, segmented {walls[3]:.3f}; cuda traces, queue "
          f"and power books and counters byte-identical to segmented; K6 "
          f"launches {fleet_launches[0][3]} per run = the {len(buckets)} "
          f"non-empty length buckets of {len(seg_lens)} solves; p50/p99 "
          f"latency {np.percentile(lat, 50):.6f}/{np.percentile(lat, 99):.6f}"
          f" s; hedged {int(base_tr.hedged.sum())}; DSCS max depth "
          f"{qs['dscs']['max_depth']}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, prof_wall = fleet("cuda")
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
    k6_dev = sum(e.self_device_time_total for e in dev_rows
                 if "lindley" in e.key) / 1e3
    h2d = sum(e.self_device_time_total for e in dev_rows
              if "HtoD" in e.key) / 1e3
    d2h = sum(e.self_device_time_total for e in dev_rows
              if "DtoH" in e.key) / 1e3
    host_ops = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
    host_top = "; ".join(
        f"{e.key[:28]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms"
        for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:6])
    print(f"profile fleet cuda run (profiler on, host wall "
          f"{prof_wall * 1e3:.3f} ms): device busy {busy_ms:.3f} ms (busy "
          f"share {busy_ms / (prof_wall * 1e3):.5f}); K6 {k6_dev:.3f} ms, "
          f"copies H2D {h2d:.3f} ms, D2H {d2h:.3f} ms; host self time of "
          f"torch ops: {host_top}")

    # where a run's host time goes, by function of the engine (cProfile)
    for backend in ("segmented", "cuda"):
        prof_host = cProfile.Profile()
        prof_host.enable()
        _, _, wall = fleet(backend)
        prof_host.disable()
        stats = pstats.Stats(prof_host).stats
        cum = {}
        for (path, _, fn), (_, _, _, cumtime, _) in stats.items():
            if "repro_torch" in path:
                key = f"{Path(path).stem}.{fn}"
                cum[key] = max(cum.get(key, 0.0), cumtime)
        top = "; ".join(f"{k} {v * 1e3:.1f} ms" for k, v in sorted(
            cum.items(), key=lambda kv: -kv[1])[:12])
        print(f"host profile fleet {backend} run (cProfile on, wall "
              f"{wall * 1e3:.1f} ms), cumulative ms by function: {top}")

    # K6 over the fleet run's buckets, at their (rows, width) shapes
    k6 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    shapes = {}
    for shp in buckets:
        shapes[shp] = shapes.get(shp, 0) + 1
    for (R, W), count in sorted(shapes.items()):
        t_cpu, s_cpu = lindley_inputs(R, W, R * W)
        t, s = t_cpu.to(dev), s_cpu.to(dev)
        if lindley_scan(t, s).cpu().numpy().tobytes() != \
                lindley_scan_plain(t_cpu, s_cpu).numpy().tobytes():
            raise AssertionError(f"K6 fleet shape ({R}, {W}) not byte-equal")
        k6["ms"] += count * time_ms(lambda: lindley_scan(t, s), reps=5)
        k6["plain_ms"] += count * time_ms(lambda: lindley_scan_plain(t, s),
                                          reps=5)
        k6["bound_ms"] += count * k6_bound(R, W)[0]
    print(f"K6 over the {len(buckets)} buckets of one fleet run "
          f"({len(shapes)} shapes, widest {max(w for _, w in shapes)}, most "
          f"rows {max(r for r, _ in shapes)}): ms={k6['ms']:.4f} "
          f"plain_ms={k6['plain_ms']:.4f} bound_ms={k6['bound_ms']:.4f} "
          f"(bytes) library_ms=none; byte-equal to the plain version")

    # ---- 7. the Zipf-skewed solver (lindley-zipf-1m) ----------------------
    rng = np.random.default_rng(0)
    ranks = np.arange(1, ZIPF["n_servers"] + 1, dtype=np.float64)
    p = ranks ** -ZIPF["zipf_s"]
    p /= p.sum()
    n = ZIPF["requests"]
    keys = np.sort(rng.choice(ZIPF["n_servers"], size=n, p=p))
    zt = np.sort(rng.uniform(0.0, n / 1e4, size=n))
    zs = rng.uniform(1e-4, 2e-3, size=n)
    seg = L.segment_fenceposts(keys, 0, ZIPF["n_servers"])
    zipf_out, zipf_s = {}, {"segmented": [], "cuda": []}
    for backend in ("segmented", "cuda", "cuda", "segmented"):
        start, fin = np.empty(n), np.empty(n)
        t0 = time.perf_counter()
        L.solve_segments(seg, zt, zs, start, fin, backend=backend)
        zipf_s[backend].append(time.perf_counter() - t0)
        zipf_out.setdefault(backend, (start.tobytes(), fin.tobytes()))
        if (start.tobytes(), fin.tobytes()) != zipf_out[backend]:
            raise AssertionError(f"zipf {backend}: reruns differ")
    if zipf_out["cuda"] != zipf_out["segmented"]:
        raise AssertionError("zipf: cuda starts not byte-equal to segmented")
    print(f"zipf lindley-zipf-1m: {n} requests over {ZIPF['n_servers']} "
          f"servers, longest queue {int(np.diff(seg).max())}; cuda byte-equal "
          f"to segmented; solve s segmented "
          f"{[round(x, 4) for x in zipf_s['segmented']]}, cuda "
          f"{[round(x, 4) for x in zipf_s['cuda']]}")
    return {"name": "lindley_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lindley.cu",
            "replaces": "src/repro/kernels/lindley.py:66",
            "launches": fleet_launches[0][3], "ms": k6["ms"],
            "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def k8_bound(B, S, H, P, G, N, dtype):
    """K8 at one shape.  Bytes: x and y, B and C in ``dtype``, dt and the
    final state in fp32.  Operations of the kernel's 64-row chunks, an FMA
    counted as two: C.B^T once per group over the causal pairs, W @ x over
    the same pairs, and the two (P, N) state products of every row."""
    import torch
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = (esz * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + H + B * H * P * N))
    ops_ = (B * G * S * (K8_CHUNK + 1) * N + B * H * S * (K8_CHUNK + 1) * P
            + 4 * B * H * S * P * N)
    return bound(nbytes, ops_, dtype)


def ssd_inputs(shape, dtype, dev, seed):
    """tests/test_kernels.py::test_ssd_kernel's distributions on the card."""
    import torch
    b, s, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    x = (f(b, s, h, p) * 0.4).to(dtype)
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(f(h) * 0.4)
    return x, dt, A, (f(b, s, g, n) * 0.3).to(dtype), \
        (f(b, s, g, n) * 0.3).to(dtype)


def check_k8(dev, time_ms, call_ms, max_err):
    """K8 against its plain version at tests/test_kernels.py's shapes, one
    with h0, and Mamba-2 370M's layer shape in bf16 and fp32; the layer
    shape's times by dtype.  Returns (largest abs err, {dtype: times})."""
    import torch
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    cases = [((2, 128, 4, 32, 2, 16), 32, torch.float32, False),
             ((1, 256, 2, 16, 1, 8), 64, torch.float32, False),
             ((2, 64, 4, 16, 4, 16), 64, torch.float32, False),
             ((2, 128, 4, 32, 2, 16), 32, torch.float32, True),
             (K8_LAYER, MAMBA_CHUNK, torch.bfloat16, False),
             (K8_LAYER, MAMBA_CHUNK, torch.float32, False)]
    worst, times = 0.0, {}
    for i, (shape, chunk, dtype, with_h0) in enumerate(cases):
        x, dt, A, Bm, Cm = ssd_inputs(shape, dtype, dev, seed=i)
        b, s, h, p, g, n = shape
        h0 = (torch.randn(b, h, p, n, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(99))
              if with_h0 else None)
        y, hf = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        yp, hp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        bf = dtype == torch.bfloat16
        # fp32: tests/test_kernels.py's rtol 1e-3 with a tighter atol; bf16
        # y: one bf16 rounding (2^-8 relative) apart; the state is fp32
        rtol, atol = (1e-2, 1e-2) if bf else (1e-3, 1e-4)
        what = f"K8 {shape} chunk={chunk} {dtype} h0={with_h0}"
        err = max(max_err(y, yp, rtol, atol, what + " y"),
                  max_err(hf, hp, 1e-3, 1e-4, what + " state"))
        worst = max(worst, err)
        line = (f"K8 ssd_scan B,S,H,P,G,N={shape} chunk={chunk} {dtype} "
                f"h0={with_h0}: max_abs_err={err:.3e} (y rtol={rtol} "
                f"atol={atol}; state rtol=1e-3 atol=1e-4)")
        if shape == K8_LAYER:
            ms = time_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
            plain = time_ms(lambda: ssd_scan_plain(x, dt, A, Bm, Cm,
                                                   chunk=chunk), reps=3)
            bnd, by = k8_bound(*shape, dtype)
            times[dtype] = {"err": err, "ms": ms, "plain_ms": plain,
                            "bound_ms": bnd, "bound_by": by}
            line += (f"; ms={ms:.4f} (per Python call "
                     f"{call_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)):.4f}) "
                     f"plain_ms={plain:.4f} library_ms=none bound_ms={bnd:.4f} "
                     f"({by})")
        print(line)
    print_ssd_launch("K8", K8_LAYER, backward=False)
    return worst, times


def print_ssd_launch(name, shape, backward):
    """The grid K8 (K8b) launches at a layer shape, as the library
    computes it: the chunks of one (batch row, head) spread over a
    cluster of blocks."""
    import torch
    from repro_torch.kernels.ssd import launch_shape
    for dtype in (torch.bfloat16, torch.float32):
        ls = launch_shape(*shape, dtype, backward=backward)
        heads = (f", {ls['heads_per_block']} heads a block" if backward
                 else "")
        print(f"{name} launch B,S,H,P,G,N={shape} {dtype}: grid "
              f"{ls['grid']}, {ls['blocks']} blocks in clusters of "
              f"{ls['cluster']} along y (the 64-row chunks of one batch row "
              f"and head spread over a cluster{heads}), "
              f"{ls['smem_bytes']} bytes of shared memory a block")


def profile_run(what, run, steps, kernels, unit):
    """Run ``run`` ``steps`` times under the profiler and print the device
    busy time, idle share, launches a ``unit`` and device ms by kind
    (``kernels`` names the port's, by substrings of their kernel names, in
    the order to match them; then GEMMs, copies and PyTorch's other
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if busy == 0:
        print(f"profile {what}): device time not measured (the profiler saw "
              f"none)")
        return
    top = "; ".join(
        f"{e.key[:40]} x{e.count // steps} "
        f"{e.self_device_time_total / 1e3 / steps:.3f} ms"
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8])
    kinds = {**kernels, "copies": ("Memcpy", "Memset"),
             "GEMMs": ("nvjet", "gemm", "cutlass", "xmma")}
    by_kind = dict.fromkeys([*kinds, "other PyTorch kernels"], 0.0)
    for e in rows:
        kind = next((k for k, names in kinds.items()
                     if any(n in e.key for n in names)),
                    "other PyTorch kernels")
        by_kind[kind] += e.self_device_time_total / 1e3 / steps
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in by_kind.items()) + \
        "; by kernel: " + top
    launches_ = sum(e.count for e in prof.key_averages()
                    if e.key == "cudaLaunchKernel") // steps
    print(f"profile {what}, profiler on, host wall {wall:.3f} ms a {unit}): "
          f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); "
          f"cudaLaunchKernel x{launches_}; kernels by device time: {top}")


def profile_serving(cfg, params, tok, cache, nxt, kernels):
    """Profile one prefill of ``tok`` and four decode steps of ``nxt`` on
    ``cache`` (``profile_run``'s line for each)."""
    from repro_torch.models import decode as DE
    B, S = tok.shape
    profile_run(f"prefill (B={B}, S={S}", lambda: DE.prefill(cfg, params, tok),
                1, kernels, "call")
    profile_run(f"decode (B={B}, S={S}",
                lambda: DE.decode_step(cfg, params, cache, nxt), 4, kernels,
                "step")


def drive_lm(dev, counters):
    """The LM slice's path at full width and depth: ``serve`` of Mamba-2
    370M in bf16, K8 launched once per layer; then, at fp32, the served
    prefill against one with K8's plain version in its place, and decode ==
    forward.  Returns K8's launches in the counted ``serve`` call."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    cfg = mamba_config()
    pbytes = sum(t.numel() * t.element_size()
                 for t in T.tree_leaves(T.param_shapes(cfg)))
    B, S, G_ = SERVE["batch"], SERVE["prompt"], SERVE["gen"]

    # ---- 8. the third path: Mamba-2 370M serving on K8 -------------------
    serve(MAMBA, smoke=False, batch=B, prompt=256, gen=2)     # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = serve(MAMBA, smoke=False, batch=B, prompt=S, gen=G_)
    launches = [c.launches for c in counters]
    gen_tok = out["generated"]
    want = [0] * (len(counters) - 1) + [cfg.num_layers]
    if launches != want:
        raise AssertionError(f"serve launches K1/K2/K5/K6/K8 {launches}, "
                             f"want {want}")
    if not (gen_tok.shape == (B, G_) and gen_tok.dtype == np.int32
            and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
        raise AssertionError(f"serve generated {gen_tok.shape} "
                             f"{gen_tok.dtype}, range {gen_tok.min()}.."
                             f"{gen_tok.max()}")
    print(f"serve {MAMBA} (48 layers, d_model 1024, din 2048, 32 heads x 64,"
          f" N 128, chunk 256, vocab 50280 padded to 50432, bf16, "
          f"{T.count_params(cfg)} parameters, {pbytes} bytes): batch {B}, "
          f"prompt {S}, gen {G_}: prefill_ms={out['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_token={out['decode_s_per_token'] * 1e3:.3f}; K8 "
          f"launches {launches[-1]} (one per layer), K1/K2/K5/K6 none; "
          f"generated {gen_tok.shape} int32, first row "
          f"{gen_tok[0, :8].tolist()}")

    # where a prefill's and a decode step's time goes (profiler on)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    _, cache = DE.prefill(cfg, params, tok)
    nxt = tok[:, -1:]
    DE.decode_step(cfg, params, cache, nxt)
    torch.cuda.synchronize()
    profile_serving(cfg, params, tok, cache, nxt,
                    {"K8": ("ssd_kernel",)})
    del params, cache

    # fp32, TF32 off: the served prefill against K8's plain version
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    real = ops.ssd_scan

    def plain_k8(x, dt, A, Bm, Cm, *, chunk, h0):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

    runs = {}
    for name in ("kernel", "plain", "kernel", "plain"):
        before = ssd_scan.launches
        ops.ssd_scan = plain_k8 if name == "plain" else real
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = DE.prefill(cfg32, params32, tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.ssd_scan = real
        n = ssd_scan.launches - before
        if n != (cfg.num_layers if name == "kernel" else 0):
            raise AssertionError(f"fp32 prefill ({name}): {n} K8 launches")
        runs.setdefault(name, (logits[:, -1].float(), []))[1].append(ms)
    (lk, ms_k), (lp, ms_p) = runs["kernel"], runs["plain"]
    real_cols = slice(0, cfg.vocab_size)
    rel = ((lk[:, real_cols] - lp[:, real_cols]).norm()
           / lp[:, real_cols].norm()).item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    if not (torch.isfinite(lk[:, real_cols]).all() and rel <= 1e-3 and same):
        raise AssertionError(f"fp32 prefill: K8 vs plain rel err {rel:.3e} "
                             f"(limit 1e-3), same argmax {same}")
    print(f"fp32 prefill (TF32 off, B={B}, S={S}): last-position logits, K8 "
          f"vs its plain version: rel Frobenius err {rel:.3e} (limit 1e-3), "
          f"same argmax in all {B} rows; host ms kernel "
          f"{[round(t, 3) for t in ms_k]}, plain {[round(t, 3) for t in ms_p]}")

    # decode == forward at full width (tests/test_models.py:80's tolerance)
    tok256 = tok[:, :256]
    full = T.forward(cfg32, params32, tok256)
    _, cache = DE.prefill(cfg32, params32, tok256[:, :255])
    dl, cache = DE.decode_step(cfg32, params32, cache, tok256[:, 255:])
    got, want_ = dl[:, 0, real_cols], full[:, 255, real_cols]
    err = (got - want_).abs()
    share = (err / (2e-3 + 2e-2 * want_.abs())).max().item()
    if not (int(cache["pos"]) == 256 and torch.isfinite(got).all()
            and share <= 1.0):
        raise AssertionError(f"decode != forward: max abs err "
                             f"{err.max().item():.3e}")
    print(f"decode == forward (fp32, B={B}): prefill 255 tokens + one "
          f"decode_step vs forward on 256: max abs err "
          f"{err.max().item():.3e}, at most {share:.2e} of the limit "
          f"(rtol 2e-2 atol 2e-3)")
    return launches[-1]


def attn_pairs(Sq, Skv, causal, window):
    """The (Sq, Skv) mask of the query-key pairs attention computes."""
    import torch
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= (qp - kp) < window
    return keep


def k5_tiles(Sq, Skv, causal, window, dtype):
    """(KV tiles K5 walks, KV tiles there are) for one (batch, head), by
    the kernel's rule (csrc/flash_attention.cu, ``tile_range``): a query
    tile of bq rows walks from the key tile holding q0 - window + 1 to the
    one ending at min(Skv, q0 + bq), or every tile where it holds a row
    that sees no key.  bf16 takes 128-query, 64-key tiles; fp32 32-query
    tiles of 32 keys (16 at D = 256 are not counted here)."""
    import torch
    bq, bk = (128, 64) if dtype == torch.bfloat16 else (32, 32)
    n_kv = -(-Skv // bk)
    walked = 0
    for q0 in range(0, Sq, bq):
        q_last = min(q0 + bq, Sq) - 1
        full = bool(window) and q_last >= Skv + window - 1
        lo = max(0, q0 - window + 1) if window and not full else 0
        hi = min(Skv, q_last + 1) if causal and not full else Skv
        walked += -(-hi // bk) - lo // bk
    return walked, -(-Sq // bq) * n_kv


def check_k5_case(shape, causal, window, dtype, randn, time_ms, call_ms,
                  max_err):
    """K5 at one shape (B, H, KV, Sq, Skv, D) against its plain version,
    and its times beside F.scaled_dot_product_attention's and its bound.
    Where the window masks nothing, SDPA is timed both with the mask and
    with ``is_causal=True``, and the faster is ``library_ms``.  Returns a
    dict of the kernels line's keys (``library`` holds each SDPA form)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, H, KV, Sq, Skv, D = shape
    q = randn(B, H, Sq, D, dtype=dtype)
    k, v = randn(B, KV, Skv, D, dtype=dtype), randn(B, KV, Skv, D, dtype=dtype)
    rtol, atol = (0.05, 0.03) if dtype == torch.bfloat16 else (1e-3, 2e-4)
    err = max_err(flash_attention(q, k, v, causal=causal, window=window),
                  flash_attention_plain(q, k, v, causal=causal,
                                        window=window),
                  rtol, atol, f"K5 {(B, H, KV, Sq, Skv, D)} {dtype}")
    keep = attn_pairs(Sq, Skv, causal, window)
    mask = keep.to(q.device) if (causal or window) else None
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window))
    plain = time_ms(lambda: flash_attention_plain(
        q, k, v, causal=causal, window=window))
    libs = {"sdpa_mask": time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=KV != H))}
    if causal and (not window or Sq <= window):   # the window masks nothing
        libs["sdpa_is_causal"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=KV != H))
    esz = q.element_size()
    bnd, by = bound((2 * q.numel() + 2 * k.numel()) * esz,
                    4 * B * H * D * int(keep.sum()), dtype)
    walked, tiles = k5_tiles(Sq, Skv, causal, window, dtype)
    print(f"K5 flash_attention B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} "
          f"D={D} causal={causal} window={window} {dtype}: "
          f"max_abs_err={err:.3e} rtol={rtol} atol={atol}; "
          f"ms={ms:.4f} (per Python call {call_ms(lambda: flash_attention(q, k, v, causal=causal, window=window)):.4f}) "
          f"plain_ms={plain:.4f} library_ms "
          + " ".join(f"({name}) {t:.4f}" for name, t in libs.items())
          + f" bound_ms={bnd:.4f} ({by}); KV tiles walked {walked} of "
          f"{tiles} a (batch, head)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by,
            "library_ms": min(libs.values()), "library": libs}


def k7_bound(B, S, W, dtype):
    """K7 at (B, S, W): x, gx, ga read and y written in ``dtype``, log_a and
    h0 in fp32; K7_OPS fp32 operations an element (the state and all the
    arithmetic are fp32 whatever the input type)."""
    import torch
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * B * S * W * esz + 4 * (W + B * W)
    return bound(nbytes, K7_OPS * B * S * W, torch.float32)


def rglru_inputs(shape, dtype, dev, seed):
    """tests/test_kernels.py::test_rglru_kernel's distributions on the card."""
    import torch
    b, s, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    return ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
            f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)


def check_k7(dev, time_ms, call_ms, max_err):
    """Phase 9(a): K7 against its plain version at tests/test_kernels.py's
    shapes and a ragged one in fp32, and at RecurrentGemma-2B's layer shape
    in fp32 and bf16, all with h0; the layer shape's times by dtype.
    Returns (largest abs err, {dtype: times})."""
    import torch
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    cases = [(shape, torch.float32) for shape in K7_SHAPES] + [
        (K7_LAYER, torch.float32), (K7_LAYER, torch.bfloat16)]
    worst, times = 0.0, {}
    for i, (shape, dtype) in enumerate(cases):
        args = rglru_inputs(shape, dtype, dev, seed=i)
        bf = dtype == torch.bfloat16
        # fp32: tests/test_kernels.py's rtol/atol 1e-4; bf16 y: one bf16
        # rounding apart (the state is fp32 in both)
        tol = 1e-2 if bf else 1e-4
        err = max_err(rglru_scan(*args), rglru_scan_plain(*args), tol, tol,
                      f"K7 {shape} {dtype}")
        worst = max(worst, err)
        line = (f"K7 rglru_scan B,S,W={shape} {dtype} h0=True: "
                f"max_abs_err={err:.3e} (rtol={tol} atol={tol})")
        if shape == K7_LAYER:
            ms = time_ms(lambda: rglru_scan(*args))
            plain = time_ms(lambda: rglru_scan_plain(*args), reps=3)
            bnd, by = k7_bound(*shape, dtype)
            times[dtype] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                            "bound_by": by}
            line += (f"; ms={ms:.4f} (per Python call "
                     f"{call_ms(lambda: rglru_scan(*args)):.4f}) "
                     f"plain_ms={plain:.4f} library_ms=none "
                     f"bound_ms={bnd:.4f} ({by})")
        print(line)
    return worst, times


def gemma_config():
    """RecurrentGemma-2B as the port's registry gives it, checked to be the
    full-width, full-depth model."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(GEMMA)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
             cfg.sliding_window, cfg.block_pattern, cfg.dtype,
             T.count_params(cfg))
    if shape != (26, 2560, 10, 1, 256, 7680, 256000, GEMMA_WINDOW,
                 ("rglru", "rglru", "attn"), "bfloat16", 2_894_528_000):
        raise AssertionError(f"{GEMMA}: config {shape}")
    return cfg


def drive_gemma(dev, counters, time_ms, call_ms, max_err, randn):
    """Phase 9: the RecurrentGemma-2B slice at full width and depth.  K7
    and K5 at D = 256 against their plain versions; ``serve`` in bf16 with
    K7 launched once per rglru layer and K5 once per attention layer, with
    a profile of a prefill and a decode step; the ring cache's run at a
    4096-token prompt; at fp32 the served prefill against one with K7's
    and K5's plain versions swapped in, and decode == forward.  Returns
    K7's entry of the kernels line and K5's at the serving shape (bf16,
    launches a ``serve``), which K5's entry carries as ``serving``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.launch.serve import _grow_cache, serve
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    # ---- 9(a), 9(b): K7, and K5 at head dim 256 ---------------------------
    k7_err, k7_times = check_k7(dev, time_ms, call_ms, max_err)
    k5_serving = {}
    for shape in K5_GEMMA:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_k5_case(shape, True, GEMMA_WINDOW, dtype, randn,
                                time_ms, call_ms, max_err)
            if dtype == torch.bfloat16:
                k5_serving[shape] = row

    # ---- 9(c): the fourth path, RecurrentGemma-2B serving on K7 and K5 ----
    cfg = gemma_config()
    kinds = [cfg.block_pattern[j % len(cfg.block_pattern)]
             for j in range(cfg.num_layers)]
    want = [0] * len(counters)
    want[counters.index(flash_attention)] = kinds.count("attn")
    want[counters.index(rglru_scan)] = kinds.count("rglru")
    pbytes = sum(t.numel() * t.element_size()
                 for t in T.tree_leaves(T.param_shapes(cfg)))
    names = ("K1", "K2", "K5", "K6", "K8", "K7")
    k5_launches = []

    def counted_serve(run):
        for c in counters:
            c.launches = 0
        out = serve(GEMMA, smoke=False, batch=run["batch"],
                    prompt=run["prompt"], gen=run["gen"])
        launches = [c.launches for c in counters]
        k5_launches.append(launches[names.index("K5")])
        gen_tok = out["generated"]
        if launches != want:
            raise AssertionError(f"serve {run}: launches "
                                 f"{dict(zip(names, launches))}, want "
                                 f"{dict(zip(names, want))}")
        if not (gen_tok.shape == (run["batch"], run["gen"])
                and gen_tok.dtype == np.int32
                and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
            raise AssertionError(f"serve {run}: generated {gen_tok.shape} "
                                 f"{gen_tok.dtype}, range {gen_tok.min()}.."
                                 f"{gen_tok.max()}")
        cache = ("ring" if run["prompt"] + run["gen"] > cfg.sliding_window
                 else "full")
        print(f"serve {GEMMA} (26 layers, d_model 2560, 10 heads x 256 with "
              f"1 KV head, d_ff 7680, window {cfg.sliding_window}, vocab "
              f"256000, bf16, {T.count_params(cfg)} parameters, {pbytes} "
              f"bytes): batch {run['batch']}, prompt {run['prompt']}, gen "
              f"{run['gen']} ({cache} K/V cache): prefill_ms="
              f"{out['prefill_s'] * 1e3:.3f} decode_ms_per_token="
              f"{out['decode_s_per_token'] * 1e3:.3f}; K7 launches "
              f"{launches[-1]} (one per rglru layer), K5 "
              f"{launches[names.index('K5')]} (one per attention layer), "
              f"K1/K2/K6/K8 none; generated {gen_tok.shape} int32, first "
              f"row {gen_tok[0, :8].tolist()}")
        return launches[-1]

    B, S, G_ = (GEMMA_SERVE[k] for k in ("batch", "prompt", "gen"))
    serve(GEMMA, smoke=False, batch=B, prompt=256, gen=2)     # warm-up
    torch.cuda.synchronize()
    k7_launches = counted_serve(GEMMA_SERVE)

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    _, cache = DE.prefill(cfg, params, tok)
    cache = _grow_cache(cfg, cache, B, S + 8)
    nxt = tok[:, -1:]
    DE.decode_step(cfg, params, cache, nxt)
    torch.cuda.synchronize()
    profile_serving(cfg, params, tok, cache, nxt,
                    {"K7": ("rglru_kernel",),
                     "K5": ("flash_bf16_kernel", "flash_f32_kernel")})
    del params, cache

    # ---- 9(d): the ring cache, prompt past the window ---------------------
    counted_serve(GEMMA_RING)

    # ---- 9(e): fp32, TF32 off: the served prefill against the plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    real = (ops.rglru_scan, ops.flash_attention)

    def plain_k5(q, k, v, *, causal, window):
        return flash_attention_plain(q, k, v, causal=causal, window=window)

    runs = {}
    for name in ("kernel", "plain", "kernel", "plain"):
        before = (rglru_scan.launches, flash_attention.launches)
        if name == "plain":
            ops.rglru_scan, ops.flash_attention = rglru_scan_plain, plain_k5
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = DE.prefill(cfg32, params32, tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.rglru_scan, ops.flash_attention = real
        n = (rglru_scan.launches - before[0],
             flash_attention.launches - before[1])
        if n != ((kinds.count("rglru"), kinds.count("attn"))
                 if name == "kernel" else (0, 0)):
            raise AssertionError(f"fp32 prefill ({name}): K7/K5 launches {n}")
        runs.setdefault(name, (logits[:, -1].float(), []))[1].append(ms)
    (lk, ms_k), (lp, ms_p) = runs["kernel"], runs["plain"]
    rel = ((lk - lp).norm() / lp.norm()).item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    if not (torch.isfinite(lk).all() and rel <= 1e-3 and same):
        raise AssertionError(f"fp32 prefill: K7/K5 vs plain rel err "
                             f"{rel:.3e} (limit 1e-3), same argmax {same}")
    print(f"fp32 prefill {GEMMA} (TF32 off, B={B}, S={S}): last-position "
          f"logits, K7 and K5 vs their plain versions: rel Frobenius err "
          f"{rel:.3e} (limit 1e-3), same argmax in all {B} rows; host ms "
          f"kernel {[round(t, 3) for t in ms_k]}, plain "
          f"{[round(t, 3) for t in ms_p]}")

    # decode == forward at full width (tests/test_models.py:80's tolerance)
    tok256 = tok[:, :256]
    full = T.forward(cfg32, params32, tok256)
    _, cache = DE.prefill(cfg32, params32, tok256[:, :255])
    cache = _grow_cache(cfg32, cache, B, 256)
    dl, cache = DE.decode_step(cfg32, params32, cache, tok256[:, 255:])
    got, want_ = dl[:, 0], full[:, 255]
    err = (got - want_).abs()
    share = (err / (2e-3 + 2e-2 * want_.abs())).max().item()
    if not (int(cache["pos"]) == 256 and torch.isfinite(got).all()
            and share <= 1.0):
        raise AssertionError(f"{GEMMA} decode != forward: max abs err "
                             f"{err.max().item():.3e}")
    print(f"decode == forward {GEMMA} (fp32, B={B}): prefill 255 tokens + "
          f"one decode_step vs forward on 256: max abs err "
          f"{err.max().item():.3e}, at most {share:.2e} of the limit "
          f"(rtol 2e-2 atol 2e-3)")
    del params32, cache, full

    # ---- 9(f): K7's entry of the kernels line (bf16, the serving dtype),
    # and K5's at the serving shape (bf16, 1024 tokens; launches a serve)
    k7_entry = {"name": "rglru_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rglru.cu",
                "replaces": "src/repro/kernels/rglru.py:54",
                "launches": k7_launches, "max_abs_err": k7_err,
                **k7_times[torch.bfloat16], "library_ms": None}
    k5_entry = {"shape": list(K5_GEMMA[0]), "dtype": "bfloat16",
                "causal": True, "window": GEMMA_WINDOW,
                "launches": k5_launches[0], **k5_serving[K5_GEMMA[0]],
                "at_4096": {k: v for k, v in k5_serving[K5_GEMMA[1]].items()
                            if k != "library"}}
    return k7_entry, k5_entry


def k8b_bound(B, S, H, P, G, N, dtype):
    """K8b at one shape.  Bytes: the gradient's inputs (x, dy, B and C in
    ``dtype``, dt fp32) read once and its outputs (dx, dB, dC in ``dtype``;
    ddt, dA and dh0 fp32) written once.  Operations of the kernel's 64-row
    chunks, an FMA counted as two: per row and head, C.B^T and dy.x^T over
    the causal pairs, C S_in^T and B G^T, the weights on dy, the two
    (P, N)-sized products each of dC and dB, and the update of G."""
    import torch
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = (esz * (3 * B * S * H * P + 4 * B * S * G * N)
              + 4 * (2 * B * S * H + 2 * H + B * H * P * N))
    ops_ = B * H * S * ((K8_CHUNK + 1) * (3 * N + 2 * P) + 10 * P * N)
    return bound(nbytes, ops_, dtype)


def check_k3_k4(dev, time_ms):
    """Phase 10(a): K3 and K4 byte for byte against their plain versions,
    on the card and, for the small shapes, on a CPU copy; their times on
    the training path's largest leaf, one fp32 row of K3_ROW elements.
    Returns K3's and K4's entries of the kernels line, all but
    ``launches``."""
    import torch
    from repro_torch.kernels import vector_engine as VE
    gen = torch.Generator(device=dev).manual_seed(10)
    cases = [((128, 256), 3.0, torch.float32), ((128, 256), 3.0,
                                                torch.bfloat16),
             ((3, 1000), 1.0, torch.float32), ((3, 1000), 1.0, torch.bfloat16),
             ((4, 512), 0.0, torch.float32), ((1, K3_ROW), 1e-3,
                                              torch.float32)]
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for shape, scale, dtype in cases:
        x = (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
        q, s = VE.quantize_int8(x)
        wants = [VE.quantize_int8_plain(x)]
        if x.numel() < 1 << 20:
            wants.append(VE.quantize_int8_plain(x.cpu()))
        for wq, ws in wants:
            if not (torch.equal(q.to(wq.device), wq) and torch.equal(
                    s.to(ws.device).view(torch.int32), ws.view(torch.int32))):
                raise AssertionError(
                    f"K3 {shape} {dtype}: codes or scales not byte-equal to "
                    f"the plain version on {wq.device}")
        for out_dtype in (torch.float32, torch.bfloat16):
            got = VE.dequantize_int8(q, s, out_dtype=out_dtype)
            want = VE.dequantize_int8_plain(q, s, out_dtype=out_dtype)
            if not torch.equal(got.view(bits[out_dtype]),
                               want.view(bits[out_dtype])):
                raise AssertionError(f"K4 {shape} -> {out_dtype}: not "
                                     f"byte-equal to the plain version")
        print(f"K3/K4 {shape} {dtype} x{scale}: codes, scales and the "
              f"dequantized float32 and bfloat16 values byte-equal to the "
              f"plain versions (on the card"
              f"{' and on a CPU copy' if len(wants) > 1 else ''})")
    del wants, want, got
    # a NaN and a -Inf in row 0 (the -Inf in its last block): codes 0, a NaN
    # scale and an all-NaN dequantized row, NaN for NaN as the plain version
    for shape, dtype in (((3, 1000), torch.float32),
                         ((3, 1000), torch.bfloat16),
                         ((1, (1 << 22) + 3), torch.float32)):
        bad = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        bad[0, shape[1] // 3] = float("nan")
        bad[0, -1] = float("-inf")
        bq, bs = VE.quantize_int8(bad)
        wq, ws = VE.quantize_int8_plain(bad)
        ok = (torch.equal(bq, wq) and not bool(bq[0].any())
              and bool(bs[0].isnan()) and torch.equal(bs[1:], ws[1:])
              and bool(ws[0].isnan()))
        for out_dtype in (torch.float32, torch.bfloat16):
            got = VE.dequantize_int8(bq, bs, out_dtype=out_dtype)
            want = VE.dequantize_int8_plain(wq, ws, out_dtype=out_dtype)
            ok = ok and bool(got[0].isnan().all()) and torch.equal(
                got[1:].view(bits[out_dtype]), want[1:].view(bits[out_dtype]))
        if not ok:
            raise AssertionError(f"K3/K4 {shape} {dtype} with a NaN and an "
                                 f"Inf: not the plain version's NaN row")
        print(f"K3/K4 {shape} {dtype} with a NaN and a -Inf in row 0: codes "
              f"0, scale NaN, dequantized row NaN, as the plain version")
    del bad, bq, bs, wq, ws, want, got
    # times at the training path's largest leaf (x, q, s: the last case)
    k3 = {"ms": time_ms(lambda: VE.quantize_int8(x), reps=3),
          "plain_ms": time_ms(lambda: VE.quantize_int8_plain(x), reps=2)}
    k3["bound_ms"], k3["bound_by"] = bound(5 * K3_ROW + 4, 5 * K3_ROW,
                                           torch.float32)
    k4 = {"ms": time_ms(lambda: VE.dequantize_int8(q, s), reps=3),
          "plain_ms": time_ms(lambda: VE.dequantize_int8_plain(q, s), reps=2),
          "library_ms": time_ms(lambda: torch.mul(q, s), reps=3)}
    k4["bound_ms"], k4["bound_by"] = bound(5 * K3_ROW + 4, K3_ROW,
                                           torch.float32)
    for name, t in (("K3 quantize_int8", k3), ("K4 dequantize_int8", k4)):
        lib = t.get("library_ms")
        print(f"{name} (1, {K3_ROW}) float32 (the stacked in_proj's gradient "
              f"as one row): ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms{'(torch.mul)=%.4f' % lib if lib else '=none'} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    del x, q, s
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, **k3}, {"max_abs_err": 0.0, **k4}


def check_k8b(dev, time_ms, call_ms, max_err):
    """Phase 10(b): K8b against its plain version at tests/test_kernels.py's
    shapes with h0 and a nonzero dstate in fp32 (K8's card bar), and at the
    training layer shape in bf16 (relative Frobenius error 1e-2 for each
    gradient); its times there.  Returns K8b's entry of the kernels line,
    all but ``launches``."""
    import torch
    from repro_torch.kernels import ssd as SSD
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")
    worst = 0.0
    for i, (shape, chunk) in enumerate([((2, 128, 4, 32, 2, 16), 32),
                                        ((1, 256, 2, 16, 1, 8), 64),
                                        ((2, 64, 4, 16, 4, 16), 64)]):
        x, dt, A, Bm, Cm = ssd_inputs(shape, torch.float32, dev, seed=20 + i)
        b, s, h, p, g, n = shape
        gen = torch.Generator(device=dev).manual_seed(30 + i)
        h0 = torch.randn(b, h, p, n, generator=gen, device=dev) * 0.5
        dy = torch.randn(b, s, h, p, generator=gen, device=dev)
        dstate = torch.randn(b, h, p, n, generator=gen, device=dev) * 0.1
        states = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                              keep_states=True)[2]
        got = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                               states=states)
        want = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate,
                                      chunk=chunk)
        err = max(max_err(gg, ww, 1e-3, 1e-4, f"K8b {shape} {name}")
                  for name, gg, ww in zip(names, got, want))
        worst = max(worst, err)
        print(f"K8b ssd_scan_bwd B,S,H,P,G,N={shape} chunk={chunk} float32 "
              f"h0 and dstate: six gradients max_abs_err={err:.3e} "
              f"(rtol=1e-3 atol=1e-4)")
    gen = torch.Generator(device=dev).manual_seed(33)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = ssd_inputs(K8B_LAYER, dtype, dev, seed=23)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        _, _, states = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=MAMBA_CHUNK,
                                    keep_states=True)
        run = lambda: SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, None, dy, None,
                                       chunk=MAMBA_CHUNK, states=states)
        line = f"K8b ssd_scan_bwd B,S,H,P,G,N={K8B_LAYER} {dtype}"
        if dtype == torch.bfloat16:
            got = run()
            want = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, None, dy, None,
                                          chunk=MAMBA_CHUNK)
            rels = {name: ((gg.float() - ww.float()).norm()
                           / ww.float().norm()).item()
                    for name, gg, ww in zip(names, got, want)}
            if not all(torch.isfinite(gg).all() for gg in got) or \
                    max(rels.values()) > 1e-2:
                raise AssertionError(f"K8b at the layer shape in bf16: rel "
                                     f"Frobenius errors {rels} (limit 1e-2)")
            del got, want
            line += ": rel Frobenius err " + ", ".join(
                f"{k} {v:.2e}" for k, v in rels.items()) + " (limit 1e-2)"
        ms = time_ms(run, reps=3)
        plain = call_ms(lambda: SSD.ssd_scan_bwd_plain(
            x, dt, A, Bm, Cm, None, dy, None, chunk=MAMBA_CHUNK), reps=2)
        bnd, by = k8b_bound(*K8B_LAYER, dtype)
        times[dtype] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                        "bound_by": by}
        print(f"{line}; ms={ms:.4f} (with K8's kept chunk states, "
              f"{states.numel() * 4} bytes) plain_ms(per Python call, "
              f"autograd through the plain scan)={plain:.4f} library_ms=none "
              f"bound_ms={bnd:.4f} ({by})")
        del x, dt, A, Bm, Cm, dy, states, run
        torch.cuda.empty_cache()
    print_ssd_launch("K8b", K8B_LAYER, backward=True)
    return {"max_abs_err": worst, **times[torch.bfloat16]}


def mamba_config():
    """Mamba-2 370M as the port's registry gives it, checked to be the
    full-width, full-depth model."""
    from repro_torch.configs import get_arch
    cfg = get_arch(MAMBA)
    shape = (cfg.num_layers, cfg.d_model, cfg.ssm_expand * cfg.d_model,
             cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size, cfg.padded_vocab,
             cfg.dtype)
    if shape != (48, 1024, 2048, 128, 256, 50280, 50432, "bfloat16"):
        raise AssertionError(f"{MAMBA}: config {shape}")
    return cfg


def drive_train(dev, counters, time_ms, call_ms, max_err):
    """Phase 10: the training slice.  K3/K4 and K8b against their plain
    versions; the full model's fp32 loss and gradients with K8/K8b and with
    their plain versions swapped in; 10 train steps of Mamba-2 370M at full
    width and depth in bf16 with int8 gradient compression, counted and
    profiled; the launcher's ``train`` and a byte-exact restore; K7's
    refusal under autograd.  Returns the K3, K4 and K8b entries of the
    kernels line."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    # ---- 10(a), 10(b): K3 and K4; K8b -----------------------------------
    k3_entry, k4_entry = check_k3_k4(dev, time_ms)
    k8b_entry = check_k8b(dev, time_ms, call_ms, max_err)
    cfg = mamba_config()
    n_leaves = len(T.tree_leaves(T.param_shapes(cfg)))

    # ---- 10(c): fp32, TF32 off: the gradients against the plain versions --
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    batch = TokenStream(cfg, GRAD_CHECK["batch"], GRAD_CHECK["seq"], 0,
                        device=dev).batch_at(0)
    real = (SSD.ssd_scan, SSD.ssd_scan_bwd)

    def plain_fwd(x, dt, A, Bm, Cm, *, chunk, h0, keep_states=False):
        y, hf = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return (y, hf, None) if keep_states else (y, hf)

    def plain_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, *, states, chunk):
        return SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate,
                                      chunk=chunk)

    runs = {}
    for name in ("kernel", "plain"):
        before = (real[0].launches, real[1].launches)
        if name == "plain":
            SSD.ssd_scan, SSD.ssd_scan_bwd = plain_fwd, plain_bwd
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = ST.value_and_grad(cfg32, params32, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            SSD.ssd_scan, SSD.ssd_scan_bwd = real
        n = (real[0].launches - before[0], real[1].launches - before[1])
        if n != ((cfg.num_layers,) * 2 if name == "kernel" else (0, 0)):
            raise AssertionError(f"fp32 gradients ({name}): K8/K8b launches "
                                 f"{n}")
        runs[name] = (loss.item(), T.tree_leaves(grads), ms)
    (lk, gk, ms_k), (lp, gp, ms_p) = runs["kernel"], runs["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    rels = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp)]
    finite = all(torch.isfinite(a).all() for a in gk)
    if not (finite and rel_loss <= 1e-5 and max(rels) <= 1e-3):
        raise AssertionError(f"fp32 gradients, K8/K8b vs plain: loss rel err "
                             f"{rel_loss:.3e} (limit 1e-5), leaf rel errs "
                             f"{[f'{r:.2e}' for r in rels]} (limit 1e-3)")
    print(f"fp32 gradients {MAMBA} (TF32 off, batch {GRAD_CHECK['batch']}, "
          f"seq {GRAD_CHECK['seq']}, {cfg.num_layers} layers): loss {lk:.6f}, "
          f"K8/K8b vs "
          f"their plain versions: loss rel err {rel_loss:.3e} (limit 1e-5), "
          f"{len(rels)} gradient leaves, worst rel Frobenius err "
          f"{max(rels):.3e} (limit 1e-3); host ms kernel {ms_k:.3f}, plain "
          f"{ms_p:.3f}")
    del params32, batch, runs, gk, gp, grads, loss
    torch.cuda.empty_cache()

    # ---- 10(d): the fifth path, Mamba-2 370M training on K8, K8b, K3, K4 --
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init(params)
    tcfg = TrainConfig(grad_compression="int8", warmup_steps=TRAIN["warmup"],
                       total_steps=TRAIN["steps"])
    step_fn = ST.make_train_step(cfg, tcfg)
    B, S = TRAIN["batch"], TRAIN["seq"]
    stream = TokenStream(cfg, B, S, 0, device=dev)
    counted = counters + (VE.quantize_int8, VE.dequantize_int8,
                          SSD.ssd_scan_bwd)
    names = ("K1", "K2", "K5", "K6", "K8", "K7", "K3", "K4", "K8b")
    want = dict.fromkeys(names, 0)
    want.update(K8=cfg.num_layers, K8b=cfg.num_layers, K3=n_leaves,
                K4=n_leaves)
    batches = [stream.batch_at(i) for i in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counted:
        c.launches = 0
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN["steps"]):
        before = [c.launches for c in counted]
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batches[i])
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(dict(zip(names, (c.launches - b for c, b in
                                         zip(counted, before)))))
    launches = dict(zip(names, (c.launches for c in counted)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, n in enumerate(per_step):
        if n != want:
            raise AssertionError(f"train step {i + 1}: launches {n}, want "
                                 f"{want}")
    if not (all(math.isfinite(l) for l in losses) and losses[-1] < losses[0]
            and int(opt.step) == TRAIN["steps"]):
        raise AssertionError(f"train: losses {losses}, step {int(opt.step)}")
    med = statistics.median(step_ms[2:])
    print(f"train {MAMBA} ({cfg.num_layers} layers, {cfg.dtype}, "
          f"{T.count_params(cfg)} "
          f"parameters, AdamW with fp32 moments, int8 error-feedback "
          f"gradients, warm-up {TRAIN['warmup']} of {TRAIN['steps']} steps): "
          f"batch {B} x seq {S}, {TRAIN['steps']} steps: losses "
          f"{[round(l, 4) for l in losses]}; step ms "
          f"{[round(t, 3) for t in step_ms]}; median of steps 3-"
          f"{TRAIN['steps']} {med:.3f} ms, {B * S / med * 1e3:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; launches a step K8 "
          f"{want['K8']}, K8b {want['K8b']}, K3 {want['K3']} and K4 "
          f"{want['K4']} (one call each per gradient leaf; a K3 call is two "
          f"kernel launches, absmax and quantize), K1/K2/K5/K6/K7 none; "
          f"in all {launches}")
    profile_run(f"train step (B={B}, S={S}",
                lambda: step_fn(params, opt, batches[0])[2]["loss"].item(), 1,
                {"K8b": ("ssd_bwd_kernel",), "K8": ("ssd_kernel",),
                 "K4": ("dequantize_kernel",),
                 "K3": ("absmax_kernel", "quantize_kernel")}, "step")
    del params, opt, batches, metrics
    torch.cuda.empty_cache()

    # ---- 10(e): the launcher, with a checkpoint restored byte for byte ----
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved = {}
    real_save = ckpt.save

    def recording_save(d, step, tree, **kw):
        saved[step] = [t.detach().clone() for t in T.tree_leaves(tree)]
        return real_save(d, step, tree, **kw)

    ckpt.save = recording_save
    try:
        t0 = time.perf_counter()
        tl = TR.train(MAMBA, smoke=False, steps=LAUNCHER["steps"],
                      batch=LAUNCHER["batch"], seq=LAUNCHER["seq"],
                      ckpt_dir=str(ckpt_dir), checkpoint_every=2, log_every=1)
        wall = time.perf_counter() - t0
    finally:
        ckpt.save = real_save
    meta = lambda dtype: (lambda p: torch.empty(p.shape, dtype=dtype,
                                                device="meta"))
    shapes = T.param_shapes(cfg)
    template = (shapes, adamw.AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"),
        T.tree_map(meta(torch.float32), shapes),
        T.tree_map(meta(torch.float32), shapes)))
    t0 = time.perf_counter()
    restored, step, extras = ckpt.restore(str(ckpt_dir), template)
    t_restore = time.perf_counter() - t0
    got = T.tree_leaves(restored)
    ibits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int32: torch.int32}
    exact = (sorted(saved) == [LAUNCHER["steps"]] and step == LAUNCHER["steps"]
             and len(got) == len(saved[step]) == 1 + 3 * n_leaves
             and all(a.dtype == b.dtype and a.device == b.device and
                     torch.equal(a.view(ibits[a.dtype]),
                                 b.view(ibits[b.dtype]))
                     for a, b in zip(got, saved[step])))
    nbytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
    if not (exact and len(tl) == LAUNCHER["steps"]
            and all(math.isfinite(l) for l in tl)
            and extras == {"arch": MAMBA, "seed": 0}):
        raise AssertionError(f"launcher: losses {tl}, checkpoint steps "
                             f"{sorted(saved)}, restore step {step}, "
                             f"byte-equal {exact}, extras {extras}")
    shutil.rmtree(ckpt_dir)
    print(f"train() launcher {MAMBA} (smoke=False, {LAUNCHER['steps']} "
          f"steps, batch {LAUNCHER['batch']} x seq {LAUNCHER['seq']}): "
          f"losses {[round(l, 4) for l in tl]} in {wall:.1f} s; checkpoint "
          f"of step {step}: {1 + 3 * n_leaves} leaves, {nbytes} bytes, "
          f"restored in {t_restore:.1f} s, parameters and moments byte-equal "
          f"to what was saved")
    del restored, got, saved
    torch.cuda.empty_cache()

    # ---- 10(f): a kernel without a backward refuses to cut the graph ------
    gen = torch.Generator(device=dev).manual_seed(40)
    x, gx, ga = (torch.randn(1, 16, 32, generator=gen, device=dev)
                 for _ in range(3))
    la = torch.randn(32, generator=gen, device=dev).requires_grad_()
    h0 = torch.zeros(1, 32, device=dev)
    before = rglru_scan.launches
    try:
        ops.rglru(x, gx, ga, la, h0)
    except NotImplementedError as e:
        msg = str(e)
    else:
        raise AssertionError("ops.rglru under requires_grad returned a tensor "
                             "cut off from the autograd graph")
    if rglru_scan.launches != before:
        raise AssertionError("ops.rglru launched K7 under requires_grad")
    print(f"K7 under requires_grad: NotImplementedError, no launch "
          f"({msg.split(';')[0]})")

    # ---- 10(g): the kernels line's entries --------------------------------
    # K3's launches count quantize_int8 calls: each one launches two
    # kernels, absmax_kernel and quantize_kernel (after a memset)
    src = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "quantize_int8", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:69",
         "launches": launches["K3"], **k3_entry, "library_ms": None},
        {"name": "dequantize_int8", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:91",
         "launches": launches["K4"], **k4_entry},
        {"name": "ssd_scan_bwd", "route": "cuda", "source": src + "ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:87",
         "launches": launches["K8b"], **k8b_entry, "library_ms": None},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import executor as E
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lindley import lindley_scan
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.systolic_matmul import (_ACTS, _lib, tile_plan,
                                                     systolic_matmul,
                                                     systolic_matmul_plain)
    from repro_torch.kernels.vector_engine import (fused_affine_act,
                                                   fused_affine_act_plain)
    from repro_torch.models import vision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (systolic_matmul, fused_affine_act, flash_attention)
    t_start = time.perf_counter()

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.splitlines() if "Used " in ln})
        spills = any("spill" in ln and not ln.strip().startswith("0 bytes")
                     and " 0 bytes spill stores, 0 bytes spill loads" not in ln
                     for ln in log.splitlines())
        print(f"  {name}: ptxas {', '.join(regs)}; spills: {spills}")
    k1_regs = k1_ptxas(logs.get("systolic_matmul", ""))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k1_design(M, K, N, dtype):
        """K1's plan for a shape and its instance's ptxas counts."""
        esz = torch.tensor([], dtype=dtype).element_size()
        bm, bn, sl = tile_plan(M, K, N, sms, bk=128 // esz)
        name = str(dtype).split(".")[1]
        regs, spill = k1_regs.get((name, bm, bn), ("(not rebuilt)", "?"))
        smem = _lib().systolic_matmul_smem_bytes(bm, bn,
                                                 _build.dtype_code(dtype))
        kind = "3xtf32" if dtype == torch.float32 else "bf16"
        return (f"{kind}-wgmma tile {bm}x{bn} cluster {sl}; ptxas {regs} "
                f"registers, {spill} B spilled, {smem} B shared")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def events_ms(run, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def call_ms(fn, reps=20):
        """Per call as Python issues it: host launch cost included."""
        fn()
        return events_ms(fn, reps)

    def time_ms(fn, reps=10):
        """Device time per call: `reps` calls captured in one CUDA graph,
        replayed, so the host's launch cost drops out."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        return events_ms(graph.replay, 5) / reps

    def max_err(got, want, rtol, atol, what):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite output")
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                                 f"rtol={rtol} atol={atol}, max err "
                                 f"{err.max().item():.3e}")
        return err.max().item()

    # ---- 3. kernels against their plain versions -------------------------
    # K1 tolerance as tests/test_kernels.py::test_systolic_matmul states it.
    def k1_tol(dtype, K):
        bf = dtype == torch.bfloat16
        return (0.05 if bf else 1e-4), (2e-2 if bf else 2e-4) * max(1, K // 64)

    for (M, K, N) in [(12544, 147, 64), (3136, 576, 64), (777, 300, 130)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = randn(M, K, dtype=dtype), randn(K, N, dtype=dtype), \
                randn(N, dtype=dtype)
            rtol, atol = k1_tol(dtype, K)
            err = 0.0
            for act in _ACTS:
                for bias in (None, b):
                    err = max(err, max_err(
                        systolic_matmul(x, w, bias, act=act),
                        systolic_matmul_plain(x, w, bias, act=act), rtol, atol,
                        f"K1 {M}x{K}x{N} {dtype} {act} bias={bias is not None}"))
            ms = time_ms(lambda: systolic_matmul(x, w))
            plain = time_ms(lambda: systolic_matmul_plain(x, w))
            lib = time_ms(lambda: torch.matmul(x, w))
            (bnd, by), fma = k1_bounds(M, K, N, dtype)
            fma = "" if fma is None else \
                f" bound_fma_ms={fma[0]:.4f} ({fma[1]})"
            print(f"K1 systolic_matmul M={M} K={K} N={N} {dtype}: 12 cases "
                  f"(6 acts x bias) max_abs_err={err:.3e} rtol={rtol} "
                  f"atol={atol:.0e}; ms={ms:.4f} (per Python call "
                  f"{call_ms(lambda: systolic_matmul(x, w)):.4f}) plain_ms={plain:.4f} "
                  f"library_ms(torch.matmul)={lib:.4f} bound_ms={bnd:.4f} "
                  f"({by}){fma}; {k1_design(M, K, N, dtype)}")

    k2_rows = {}
    for (M, N) in [(1, 150528), (256, 1024)]:
        x, s, b = randn(M, N), randn(N), randn(N)
        err = max(max_err(fused_affine_act(x, s, b, act=a),
                          fused_affine_act_plain(x, s, b, act=a), 1e-5, 1e-5,
                          f"K2 {M}x{N} {a}") for a in _ACTS)
        ms = time_ms(lambda: fused_affine_act(x, s, b))
        plain = time_ms(lambda: fused_affine_act_plain(x, s, b))
        lib = time_ms(lambda: torch.addcmul(b, x, s))
        bnd, by = bound((2 * M * N + 2 * N) * 4, 2 * M * N, torch.float32)
        k2_rows[(M, N)] = (err, ms, plain, lib, bnd, by)
        print(f"K2 fused_affine_act M={M} N={N} float32: 6 acts "
              f"max_abs_err={err:.3e} rtol=1e-5 atol=1e-5; ms={ms:.4f} "
              f"(per Python call {call_ms(lambda: fused_affine_act(x, s, b)):.4f}) "
              f"plain_ms={plain:.4f} library_ms(torch.addcmul)={lib:.4f} "
              f"bound_ms={bnd:.4f} ({by})")

    k5_rows = {}
    for (B, H, KV, Sq, Skv, D, causal, window) in [
            (1, 4, 4, 17, 17, 32, False, 0), (1, 4, 4, 122, 122, 32, False, 0),
            (2, 8, 2, 512, 512, 64, True, 128),
            (1, 2, 2, 128, 32, 64, False, 16)]:      # rows that see no key
        for dtype in (torch.float32, torch.bfloat16):
            k5_rows[(Sq, dtype)] = check_k5_case(
                (B, H, KV, Sq, Skv, D), causal, window, dtype, randn,
                time_ms, call_ms, max_err)

    k6_err = check_k6(dev, time_ms, call_ms)
    k8_err, k8_times = check_k8(dev, time_ms, call_ms, max_err)

    # ---- 4. the executor for every non-LM workload -----------------------
    for wl in list(E._MODEL_BUILDERS) + ["credit_risk"]:
        ex = E.DSCSExecutor(wl)
        req = ex.make_request(torch.Generator().manual_seed(1))
        for c in counters:
            c.launches = 0
        rep = ex(req)
        torch.cuda.synchronize()
        n = [c.launches for c in counters]
        if not (rep.accelerated and rep.latency_breakdown["total"] > 0
                and rep.energy_breakdown["total"] > 0):
            raise AssertionError(f"{wl}: report {rep}")
        if wl == "credit_risk":
            if n != [0, 0, 0] or not torch.isfinite(rep.result).all():
                raise AssertionError(f"{wl}: launches {n}, result {rep.result}")
            print(f"executor {wl}: result {rep.result.flatten().tolist()} "
                  f"(no kernel on this path)")
            continue
        apply = E._MODEL_BUILDERS[wl][1]
        x = E._preprocess_vector_engine(req, use_kernel=False)
        got = apply(ex.params, x, use_kernel=True)
        want = apply(ex.params, x, use_kernel=False)
        rel = ((got - want).norm() / want.norm()).item()
        vit = wl == "remote_sensing"
        want_n = [0 if vit else n[0], 1, 4 if vit else 0]
        if n != want_n or n[0 if not vit else 2] == 0 or not rel <= 1e-4:
            raise AssertionError(f"{wl}: launches K1/K2/K5 {n} (want {want_n}),"
                                 f" f2 rel err {rel:.3e} (limit 1e-4)")
        if wl == "asset_damage" and n[0] != RESNET_LAUNCHES:
            raise AssertionError(f"{wl}: {n[0]} K1 launches, want 53")
        print(f"executor {wl} image {ex.image_size}: launches K1={n[0]} "
              f"K2={n[1]} K5={n[2]}; f2 kernel vs plain rel err {rel:.3e} "
              f"(limit 1e-4); out {tuple(got.shape)}")

    # ---- 5. the main path: full-width ResNet-50 and the ViT --------------
    resnet = E.DSCSExecutor("asset_damage", image_size=224)
    resnet.params = vision.resnet50_init(torch.Generator().manual_seed(0),
                                         width=1.0)
    vit = E.DSCSExecutor("remote_sensing", image_size=176)
    served = [(ex, [ex.make_request(torch.Generator().manual_seed(100 + i))
                    for i in range(REQUESTS)]) for ex in (resnet, vit)]
    for ex, reqs in served:                       # one warm request each
        ex(reqs[0])
    torch.cuda.synchronize()

    # shapes K1 sees in one ResNet-50 request, recorded outside the counted run
    k1_shapes = []
    real = ops.matmul_padded

    def record(x, w, *a, **kw):
        k1_shapes.append((x.shape[0], x.shape[1], w.shape[1],
                          not w.is_contiguous()))
        return real(x, w, *a, **kw)

    ops.matmul_padded = record
    try:
        vision.resnet50_apply(resnet.params, E._preprocess_vector_engine(
            served[0][1][0], use_kernel=False), use_kernel=True)
    finally:
        ops.matmul_padded = real

    for c in counters:
        c.launches = 0
    reports, ms_per = {}, {}
    for ex, reqs in served:
        name = ex.pipeline.name
        reports[name], ms_per[name] = [], []
        for r in reqs:
            t0 = time.perf_counter()
            rep = ex(r)
            torch.cuda.synchronize()
            ms_per[name].append((time.perf_counter() - t0) * 1e3)
            reports[name].append(rep)
        if name == "asset_damage":
            after_resnet = [c.launches for c in counters]
    launches = [c.launches for c in counters]

    want_resnet = [RESNET_LAUNCHES * REQUESTS, REQUESTS, 0]
    want_all = [RESNET_LAUNCHES * REQUESTS, 2 * REQUESTS, 4 * REQUESTS]
    if after_resnet != want_resnet or launches != want_all:
        raise AssertionError(f"main path launches K1/K2/K5: after ResNet-50 "
                             f"{after_resnet} (want {want_resnet}), in all "
                             f"{launches} (want {want_all})")
    for ex, reqs in served:
        name = ex.pipeline.name
        apply = E._MODEL_BUILDERS[name][1]
        worst = 0.0
        for r, rep in zip(reqs, reports[name]):
            x = E._preprocess_vector_engine(r, use_kernel=False)
            got = apply(ex.params, x, use_kernel=True)
            want = apply(ex.params, x, use_kernel=False)
            rel = ((got - want).norm() / want.norm()).item()
            worst = max(worst, rel)
            if not (torch.isfinite(got).all() and rel <= 1e-3
                    and torch.equal(rep.result, want.argmax(-1))
                    and tuple(got.shape) == (1, 1000)):
                raise AssertionError(
                    f"{name}: logits {tuple(got.shape)} rel err {rel:.3e} "
                    f"(limit 1e-3), class {rep.result.tolist()} vs plain "
                    f"{want.argmax(-1).tolist()}")
        ms = ms_per[name]
        print(f"main path {name} image {ex.image_size}: {REQUESTS} requests, "
              f"ms per request {[round(t, 3) for t in ms]} "
              f"(median {statistics.median(ms):.3f}); logits vs plain "
              f"path max rel err {worst:.3e} (limit 1e-3), same class")
    print(f"main path launches: K1={launches[0]} ({launches[0] // REQUESTS} "
          f"per ResNet-50 request) K2={launches[1]} K5={launches[2]} "
          f"({launches[2] // REQUESTS} per ViT request)")

    # where one ResNet-50 request's device time goes: kernel events only
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in served[0][1][:2]:
            resnet(r)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 2e3
    if device_ms == 0:
        print("profile: device time not measured (the profiler saw none)")
    else:
        host_ms = statistics.median(ms_per["asset_damage"])
        top = "; ".join(
            f"{e.key[:40]} x{e.count // 2} {e.self_device_time_total / 2e3:.3f} ms"
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8])
        print(f"profile ResNet-50 request: device busy {device_ms:.3f} ms of "
              f"{host_ms:.3f} ms on the host clock (idle share "
              f"{1 - device_ms / host_ms:.3f}); kernels by device time: {top}")
        ops_ = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        host_top = "; ".join(
            f"{e.key[:32]} x{e.count // 2} {e.self_cpu_time_total / 2e3:.3f} ms"
            for e in sorted(ops_, key=lambda e: -e.self_cpu_time_total)[:8])
        print(f"profile ResNet-50 request (profiler on): host self time by "
              f"op: {host_top}")

    k6_entry = drive_fleet(dev, time_ms)
    k8_launches = drive_lm(dev, counters + (lindley_scan, ssd_scan))
    k7_entry, k5_serving = drive_gemma(
        dev, counters + (lindley_scan, ssd_scan, rglru_scan), time_ms,
        call_ms, max_err, randn)
    torch.cuda.empty_cache()
    train_entries = drive_train(dev, counters + (lindley_scan, ssd_scan,
                                                 rglru_scan),
                                time_ms, call_ms, max_err)

    # ---- the kernels line: K1 over one request's 53 shapes ---------------
    # Each distinct shape is checked and timed once, with w in the layout the
    # request hands over (K-major for the 3x3 and 7x7 convolutions), and
    # counted as often as the request runs it.
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "bound_fma_ms": 0.0, "err": 0.0, "bytes": 0.0, "operations": 0.0,
          "call_ms": 0.0}
    per_shape = []
    rtol, atol = k1_tol(torch.float32, 1)
    counts = {}
    for shape in k1_shapes:
        counts[shape] = counts.get(shape, 0) + 1
    for (M, K, N, kmajor), n in counts.items():
        x, w = randn(M, K), randn(K, N, std=math.sqrt(2.0 / K))
        if kmajor:
            w = w.t().contiguous().t()
        k1["err"] = max(k1["err"], max_err(
            systolic_matmul(x, w), systolic_matmul_plain(x, w), rtol,
            atol * max(1, K // 64), f"K1 request shape {(M, K, N)}"))
        ms = time_ms(lambda: systolic_matmul(x, w))
        lib = time_ms(lambda: torch.matmul(x, w))
        per_shape.append((M, K, N, kmajor, n, ms, lib))
        k1["ms"] += n * ms
        k1["library_ms"] += n * lib
        k1["call_ms"] += n * call_ms(lambda: systolic_matmul(x, w), reps=10)
        k1["plain_ms"] += n * time_ms(lambda: systolic_matmul_plain(x, w))
        (bnd, by), (fma, _) = k1_bounds(M, K, N, torch.float32)
        k1["bound_ms"] += n * bnd
        k1[by] += n * bnd
        k1["bound_fma_ms"] += n * fma
    k1_by = "bytes" if k1["bytes"] > k1["operations"] else "operations"
    shapes = "; ".join(
        f"({M}, {K}, {N}){' K-major w' if kmajor else ''} x{n} {ms:.4f} ms "
        f"torch.matmul {lib:.4f} "
        f"{k1_design(M, K, N, torch.float32).split(';')[0]}"
        for M, K, N, kmajor, n, ms, lib in per_shape)
    print(f"K1 over the {len(k1_shapes)} GEMMs of one ResNet-50 request "
          f"(float32, {len(counts)} distinct): ms={k1['ms']:.4f} (per Python "
          f"call {k1['call_ms']:.4f}) plain_ms={k1['plain_ms']:.4f} "
          f"library_ms={k1['library_ms']:.4f} bound_ms={k1['bound_ms']:.4f} "
          f"(3xTF32; {k1_by}: {k1['operations']:.4f} ms of it "
          f"operations-bound) bound_fma_ms={k1['bound_fma_ms']:.4f} "
          f"max_abs_err={k1['err']:.3e}; per shape (M, K, N) x count: "
          f"{shapes}")

    k2 = k2_rows[(1, 224 * 224 * 3)]
    k5 = k5_rows[(122, torch.float32)]
    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "systolic_matmul", "route": "cuda",
         "source": src + "systolic_matmul.cu",
         "replaces": "src/repro/kernels/systolic_matmul.py:92",
         "launches": launches[0], "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1_by, "library_ms": k1["library_ms"],
         "bound_fma_ms": k1["bound_fma_ms"]},
        {"name": "fused_affine_act", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:41",
         "launches": launches[1], "max_abs_err": k2[0], "ms": k2[1],
         "plain_ms": k2[2], "bound_ms": k2[4], "bound_by": k2[5],
         "library_ms": k2[3]},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:86",
         "launches": launches[2],
         **{k: v for k, v in k5.items() if k != "library"},
         "serving": k5_serving},
        {**k6_entry, "max_abs_err": k6_err},
        {"name": "ssd_scan", "route": "cuda", "source": src + "ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:87", "launches": k8_launches,
         "max_abs_err": k8_err, **{k: v for k, v in k8_times[
             torch.bfloat16].items() if k != "err"}, "library_ms": None},
        k7_entry,
        *train_entries,
    ]
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
