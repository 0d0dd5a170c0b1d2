#!/usr/bin/env python3
"""Time K6 (the fleet's Lindley scan) and K2 (the affine pass) of two
checkouts in turns, on one card, with the fleet's wall beside them.

    python3 tools/k6_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process runs the fleet of ``chip_smoke.py`` phase 6 (``poisson-1m-f1024``:
10^6 requests, 1024 + 1024 servers, 8 shards, ``processes=1``) once with
the numpy solver, keeping every solve's (seg, t, s), and makes the
``lindley-zipf-1m`` solve from its seed.  Then it times, each as calls
captured in one CUDA graph and replayed (as ``chip_smoke.py``'s
``time_ms``):

- ``k6_fleet``: K6 summed over the fleet run's solves, as the checkout's
  solver hands them over: one call a power-of-two length bucket, padded,
  where the checkout has no ``lindley_scan_segments``; one call a solve
  where it has (``k6_launches``: the calls);
- ``k6_zipf``: the same for the Zipf solve;
- ``k2`` and ``k2_256``: K2 at (1, 150528) and (256, 1024) fp32, and
  ``torch.addcmul`` at the same shapes (``addcmul``, ``addcmul_256``).

Unless ``--no-model``, it then times on the host's clock the median of 3
fleet runs with ``backend="cuda"`` after one warm-up (``fleet_cuda_s``).
It prints the card's name and power limit, then one JSON line per run.  The
turns are ``tools/k3_ab.py``'s.
"""
from __future__ import annotations

import sys

from k3_ab import run_in_turns

CHILD = """
import json, statistics, sys, time
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch.core import lindley as L
from repro_torch.core.arrivals import make_arrivals
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.function import standard_pipeline
from repro_torch.core.latency import LatencyModel
from repro_torch.core.platforms import PLATFORMS
from repro_torch.kernels import lindley as KL
from repro_torch.kernels.vector_engine import fused_affine_act
dev = torch.device("cuda")

def time_ms(fn, reps=10):
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 5 / reps

pipes = [standard_pipeline(n) for n in ("asset_damage", "content_moderation")]
lm = LatencyModel()
svc = sum(lm.e2e(PLATFORMS["DSCS-Serverless"], p.workload, q=0.5)
          for p in pipes) / len(pipes)
rate = 0.95 * 1024 / svc

def fleet(backend):
    eng = ClusterEngine(n_dscs=1024, n_cpu=1024, hedge_budget_s=0.08, seed=0)
    t0 = time.perf_counter()
    eng.run_sharded(pipes, arrivals=make_arrivals("poisson", rate),
                    duration_s=1_000_000 / rate, n_shards=8, processes=1,
                    backend=backend)
    torch.cuda.synchronize()
    return time.perf_counter() - t0

solves = []
real = L.solve_segments
def record(seg, t, s, start, fin, *, backend):
    if t.size:
        solves.append((seg.copy(), t.copy(), s.copy()))
    return real(seg, t, s, start, fin, backend=backend)
L.solve_segments = record
fleet("segmented")
L.solve_segments = real

rng = np.random.default_rng(0)
p = np.arange(1, 129, dtype=np.float64) ** -1.2
p /= p.sum()
keys = np.sort(rng.choice(128, size=1_000_000, p=p))
zt = np.sort(rng.uniform(0.0, 100.0, size=1_000_000))
zs = rng.uniform(1e-4, 2e-3, size=1_000_000)
zipf = (L.segment_fenceposts(keys, 0, 128), zt, zs)

def calls(seg, t, s):
    # the calls this checkout's solver makes for one solve
    if hasattr(KL, "lindley_scan_segments"):
        cols = [torch.from_numpy(a).to(dev) for a in (seg, t, s)]
        return [lambda: KL.lindley_scan_segments(*cols)]
    lens = np.diff(seg)
    order, bounds, widths = L._bucket_rows(lens)
    out = []
    for bi in range(bounds.size - 1):
        rows = order[bounds[bi]:bounds[bi + 1]]
        w = int(widths[bi])
        T = np.zeros((rows.size, w))
        S = np.zeros((rows.size, w))
        for i, j in enumerate(rows):
            T[i, :lens[j]] = t[seg[j]:seg[j + 1]]
            S[i, :lens[j]] = s[seg[j]:seg[j + 1]]
        Td, Sd = torch.from_numpy(T).to(dev), torch.from_numpy(S).to(dev)
        out.append(lambda Td=Td, Sd=Sd: KL.lindley_scan(Td, Sd))
    return out

fleet_calls = [c for sv in solves for c in calls(*sv)]
out = {{"k6_fleet": sum(time_ms(c) for c in fleet_calls),
        "k6_launches": len(fleet_calls),
        "k6_zipf": sum(time_ms(c, reps=3) for c in calls(*zipf))}}
g = torch.Generator(device=dev).manual_seed(0)
for (M, N), key in (((1, 150528), ""), ((256, 1024), "_256")):
    x = torch.randn(M, N, generator=g, device=dev)
    sc = torch.randn(N, generator=g, device=dev)
    b = torch.randn(N, generator=g, device=dev)
    out["k2" + key] = time_ms(lambda: fused_affine_act(x, sc, b))
    out["addcmul" + key] = time_ms(lambda: torch.addcmul(b, x, sc))
if {model!r}:
    fleet("cuda")
    out["fleet_cuda_s"] = statistics.median(fleet("cuda") for _ in range(3))
print(json.dumps(out))
"""


if __name__ == "__main__":
    sys.exit(run_in_turns(CHILD))
