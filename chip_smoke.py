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
length bucket; and the Zipf-skewed solver of ``lindley-zipf-1m``.  Any
failed check raises, so the exit code is non-zero.  fp32 products and
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
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12,     # fp32 FMA pipes, no tensor cores
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


def bound(nbytes, ops_, dtype):
    """(least ms for the work, "bytes" or "operations")."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops_ / PEAK_OPS_PER_S[str(dtype).split(".")[1]]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import executor as E
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.systolic_matmul import (_ACTS, k_splits,
                                                     systolic_matmul,
                                                     systolic_matmul_plain)
    from repro_torch.kernels.vector_engine import (fused_affine_act,
                                                   fused_affine_act_plain)
    from repro_torch.models import vision
    import torch.nn.functional as F

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
            esz = x.element_size()
            bnd, by = bound((M * K + K * N + M * N) * esz, 2 * M * N * K, dtype)
            print(f"K1 systolic_matmul M={M} K={K} N={N} {dtype}: 12 cases "
                  f"(6 acts x bias) max_abs_err={err:.3e} rtol={rtol} "
                  f"atol={atol:.0e}; ms={ms:.4f} (per Python call "
                  f"{call_ms(lambda: systolic_matmul(x, w)):.4f}) plain_ms={plain:.4f} "
                  f"library_ms(torch.matmul)={lib:.4f} bound_ms={bnd:.4f} "
                  f"({by})")

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

    def attn_pairs(Sq, Skv, causal, window):
        qp = torch.arange(Sq)[:, None]
        kp = torch.arange(Skv)[None, :]
        keep = torch.ones(Sq, Skv, dtype=torch.bool)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= (qp - kp) < window
        return keep

    k5_rows = {}
    for (B, H, KV, Sq, Skv, D, causal, window) in [
            (1, 4, 4, 17, 17, 32, False, 0), (1, 4, 4, 122, 122, 32, False, 0),
            (2, 8, 2, 512, 512, 64, True, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(B, H, Sq, D, dtype=dtype)
            k, v = randn(B, KV, Skv, D, dtype=dtype), randn(B, KV, Skv, D, dtype=dtype)
            rtol, atol = (0.05, 0.03) if dtype == torch.bfloat16 else (1e-3, 2e-4)
            err = max_err(flash_attention(q, k, v, causal=causal, window=window),
                          flash_attention_plain(q, k, v, causal=causal,
                                                window=window),
                          rtol, atol, f"K5 {(B, H, KV, Sq, Skv, D)} {dtype}")
            keep = attn_pairs(Sq, Skv, causal, window)
            mask = keep.to(dev) if (causal or window) else None
            ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                 window=window))
            plain = time_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal, window=window))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=KV != H))
            esz = q.element_size()
            bnd, by = bound((2 * q.numel() + 2 * k.numel()) * esz,
                            4 * B * H * D * int(keep.sum()), dtype)
            k5_rows[(Sq, dtype)] = (err, ms, plain, lib, bnd, by)
            print(f"K5 flash_attention B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} "
                  f"D={D} causal={causal} window={window} {dtype}: "
                  f"max_abs_err={err:.3e} rtol={rtol} atol={atol}; "
                  f"ms={ms:.4f} (per Python call {call_ms(lambda: flash_attention(q, k, v, causal=causal, window=window)):.4f}) "
                  f"plain_ms={plain:.4f} library_ms(sdpa)={lib:.4f} "
                  f"bound_ms={bnd:.4f} ({by})")

    k6_err = check_k6(dev, time_ms, call_ms)

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
        k1_shapes.append((x.shape[0], x.shape[1], w.shape[1]))
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

    # ---- the kernels line: K1 over one request's 53 shapes ---------------
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "err": 0.0, "bytes": 0.0, "operations": 0.0, "call_ms": 0.0}
    per_shape = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rtol, atol = k1_tol(torch.float32, 1)
    for (M, K, N) in k1_shapes:
        x, w = randn(M, K), randn(K, N, std=math.sqrt(2.0 / K))
        k1["err"] = max(k1["err"], max_err(
            systolic_matmul(x, w), systolic_matmul_plain(x, w), rtol,
            atol * max(1, K // 64), f"K1 request shape {(M, K, N)}"))
        ms = time_ms(lambda: systolic_matmul(x, w))
        per_shape.append((ms, M, K, N, k_splits(M, N, K, sms)))
        k1["ms"] += ms
        k1["call_ms"] += call_ms(lambda: systolic_matmul(x, w), reps=10)
        k1["plain_ms"] += time_ms(lambda: systolic_matmul_plain(x, w))
        k1["library_ms"] += time_ms(lambda: torch.matmul(x, w))
        bnd, by = bound((M * K + K * N + M * N) * 4, 2 * M * N * K,
                        torch.float32)
        k1["bound_ms"] += bnd
        k1[by] += bnd
    k1_by = "bytes" if k1["bytes"] > k1["operations"] else "operations"
    slow = "; ".join(f"M={M} K={K} N={N} splits={sp} {ms:.4f} ms"
                     for ms, M, K, N, sp in sorted(per_shape)[::-1][:5])
    print(f"K1 over the {len(k1_shapes)} GEMMs of one ResNet-50 request "
          f"(float32): ms={k1['ms']:.4f} (per Python call "
          f"{k1['call_ms']:.4f}) plain_ms={k1['plain_ms']:.4f} "
          f"library_ms={k1['library_ms']:.4f} bound_ms={k1['bound_ms']:.4f} "
          f"({k1_by}: {k1['operations']:.4f} ms of it operations-bound) "
          f"max_abs_err={k1['err']:.3e}; slowest: {slow}")

    k2 = k2_rows[(1, 224 * 224 * 3)]
    k5 = k5_rows[(122, torch.float32)]
    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "systolic_matmul", "route": "cuda",
         "source": src + "systolic_matmul.cu",
         "replaces": "src/repro/kernels/systolic_matmul.py:92",
         "launches": launches[0], "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1_by, "library_ms": k1["library_ms"]},
        {"name": "fused_affine_act", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:41",
         "launches": launches[1], "max_abs_err": k2[0], "ms": k2[1],
         "plain_ms": k2[2], "bound_ms": k2[4], "bound_by": k2[5],
         "library_ms": k2[3]},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:86",
         "launches": launches[2], "max_abs_err": k5[0], "ms": k5[1],
         "plain_ms": k5[2], "bound_ms": k5[4], "bound_by": k5[5],
         "library_ms": k5[3]},
        {**k6_entry, "max_abs_err": k6_err},
    ]
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
