#!/usr/bin/env python3
"""Where K6's time goes (the fleet's Lindley scan, ``csrc/lindley.cu``):
the latency of its chain's step, and variants of the kernel.

    python3 tools/k6_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
First it reads the latency of one dependent fp64 add (``__dadd_rn``, the
step of K6's chain) from ``lindley_add_latency``: SM clocks and ns an
add, over 2^20 and 2^22 adds.  Then it builds ``src/repro_torch/kernels/
csrc/lindley.cu`` as it is (``base``, printing what ``ptxas`` says of it)
and, in parallel, copies of it changed by text substitutions:

- ``solo``:     one warp a segment takes the chain and the scan in turn
- ``stages2``, ``stages3``: two or three tiles in flight a segment, not four
- ``tile128``, ``tile512``: tiles of 128 or 512 steps (4 or 16 a scan
                lane), not 256
- ``nofence``:  no ``__threadfence_block`` before a named barrier's arrive
- ``nostore``:  the chain writes no c at the runs' starts (wrong starts:
                a time only)
- ``batch2``, ``batch4``: the chain reads s two or four runs of eight
                ahead, not one
- ``noload``:   the chain reads s for its first batch only (wrong starts:
                a time only)

Each variant is called through the port's own wrapper (its library put in
place of the built one) on the ``lindley-zipf-1m`` solve (one launch;
``ns_a_step`` is its time over its longest queue's steps) and summed over
the solves of the ``poisson-1m-f1024`` fleet run of ``chip_smoke.py``
phase 6, timed in a CUDA graph as ``chip_smoke.py`` times kernels, and
checked byte for byte against the base; one JSON line a variant.  A
substitution that no longer matches the source fails the script.  The
build and timing helpers are ``tools/k3_ablate.py``'s.
"""
from __future__ import annotations

import json
import sys

from k3_ablate import ROOT, build, card, install, time_ms

sys.path.insert(0, str(ROOT / "src"))


def batched(runs: int) -> list:
    """The chain reading s ``runs`` runs of eight ahead, not one."""
    word = "(w / (LANE_STEPS / 2)) * LANE_STRIDE + 2 * (w % (LANE_STEPS / 2))"
    return [
        ("  constexpr int W = LANE_STEPS / 2;                 // 16-byte words a run\n"
         "  const int runs = len / LANE_STEPS;\n",
         f"  constexpr int W = {runs} * LANE_STEPS / 2;\n"
         f"  const int runs = len / LANE_STEPS / {runs} * {runs};\n"),
        ("nx[w] = ld2(st.s + 2 * w);", f"nx[w] = ld2(st.s + {word});"),
        ("  for (int q = 0; q < runs; ++q) {",
         f"  for (int q = 0; q < runs; q += {runs}) {{"),
        ("    const int next = q + 1 < runs ? q + 1 : q;",
         f"    const int next = q + {runs} < runs ? q + {runs} : q;"),
        ("nx[w] = ld2(st.s + next * LANE_STRIDE + 2 * w);",
         f"nx[w] = ld2(st.s + next * LANE_STRIDE + {word});"),
        ("    st.c[q] = c;\n#pragma unroll\n    for (int w = 0; w < W; ++w) {\n",
         "#pragma unroll\n    for (int w = 0; w < W; ++w) {\n"
         "      if (w % (LANE_STEPS / 2) == 0) st.c[q + w / (LANE_STEPS / 2)] = c;\n"),
    ]


def variants():
    solo = [
        ("constexpr int THREADS = 64;", "constexpr int THREADS = 32;"),
        ("  if (threadIdx.x < 32) {            // the chain warp",
         "  if (false) {"),
        ("  wait_async<STAGES - 2>();          // tile 0 landed\n"
         "  __syncwarp();\n  bar_signal(loaded_id(0));\n",
         "  double c = 0.0;\n"),
        ("    wait_async<STAGES - 2>();        // tile k + 1 landed\n"
         "    __syncwarp();\n"
         "    if (k + 1 < tiles) bar_signal(loaded_id(k + 1));\n"
         "    bar_wait(cready_id(k));\n",
         "    wait_async<STAGES - 1>();        // tile k landed\n"
         "    __syncwarp();\n"
         "    if (lane == 0) c = chain_tile(st, tile_len(k), c);\n"
         "    __syncwarp();\n"),
    ]
    return {
        "base": [],
        "solo": solo,
        "stages2": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
        "stages3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
        "tile128": [("constexpr int TILE = 256;", "constexpr int TILE = 128;")],
        "tile512": [("constexpr int TILE = 256;", "constexpr int TILE = 512;")],
        "nofence": [("  __threadfence_block();\n  asm volatile(\"bar.arrive",
                     "  asm volatile(\"bar.arrive")],
        "nostore": [("    st.c[q] = c;\n", "")],
        "batch2": batched(2),
        "batch4": batched(4),
        "noload": [("nx[w] = ld2(st.s + next * LANE_STRIDE + 2 * w);",
                    "nx[w].x += next;")],
    }


def fleet_solves():
    """Every non-empty solve (seg, t, s) of one poisson-1m-f1024 fleet run
    (numpy solver), and the lindley-zipf-1m solve."""
    import numpy as np
    from repro_torch.core import lindley as L
    from repro_torch.core.arrivals import make_arrivals
    from repro_torch.core.engine import ClusterEngine
    from repro_torch.core.function import standard_pipeline
    from repro_torch.core.latency import LatencyModel
    from repro_torch.core.platforms import PLATFORMS
    pipes = [standard_pipeline(n)
             for n in ("asset_damage", "content_moderation")]
    lm = LatencyModel()
    rate = 0.95 * 1024 / (sum(lm.e2e(PLATFORMS["DSCS-Serverless"],
                                     p.workload, q=0.5) for p in pipes) / 2)
    solves = []
    real = L.solve_segments

    def record(seg, t, s, start, fin, *, backend):
        if t.size:
            solves.append((seg.copy(), t.copy(), s.copy()))
        return real(seg, t, s, start, fin, backend=backend)

    L.solve_segments = record
    try:
        ClusterEngine(n_dscs=1024, n_cpu=1024, hedge_budget_s=0.08,
                      seed=0).run_sharded(
            pipes, arrivals=make_arrivals("poisson", rate),
            duration_s=1_000_000 / rate, n_shards=8, processes=1,
            backend="segmented")
    finally:
        L.solve_segments = real
    rng = np.random.default_rng(0)
    p = np.arange(1, 129, dtype=np.float64) ** -1.2
    p /= p.sum()
    keys = np.sort(rng.choice(128, size=1_000_000, p=p))
    zt = np.sort(rng.uniform(0.0, 100.0, size=1_000_000))
    zs = rng.uniform(1e-4, 2e-3, size=1_000_000)
    return solves, (L.segment_fenceposts(keys, 0, 128), zt, zs)


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import lindley as KL
    print(card())
    dev = torch.device("cuda")
    for steps in (1 << 20, 1 << 22):
        print(json.dumps({"probe": "dependent __dadd_rn", "adds": steps,
                          **KL.add_latency(dev, steps)}))
    built = build("lindley", variants(), ROOT / "build/k6_ablate")
    print("ptxas base:", _build.ptxas_counts(built["base"][1],
                                             "lindley_kernel"))
    solves, zipf = fleet_solves()
    on_card = lambda sv: [torch.from_numpy(a).to(dev) for a in sv]
    fleet = [on_card(sv) for sv in solves]
    zseg, zt, zs = on_card(zipf)
    longest = int(np.diff(zipf[0]).max())
    want = None
    for var, (path, _) in built.items():
        install("lindley", path)
        got = [KL.lindley_scan_segments(*cols) for cols in fleet + [
            (zseg, zt, zs)]]
        got = b"".join(g.cpu().numpy().tobytes() for g in got)
        want = want or got
        zipf_ms = time_ms(lambda: KL.lindley_scan_segments(zseg, zt, zs), 3)
        row = {"variant": var, "exact": got == want,
               "fleet_ms": sum(time_ms(lambda c=c: KL.lindley_scan_segments(*c))
                               for c in fleet),
               "zipf_ms": zipf_ms, "ns_a_step": zipf_ms * 1e6 / longest}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
