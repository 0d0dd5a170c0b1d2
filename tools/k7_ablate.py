#!/usr/bin/env python3
"""Where K7's time goes (the RG-LRU scan, ``csrc/rglru.cu``): time variants
of the kernel with one part changed or cut.

    python3 tools/k7_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/rglru.cu`` as it is (``base``,
printing what ``ptxas`` says of the kernel) and, in parallel, copies of
it changed by text substitutions:

- ``m6``, ``s8x8m4``, ``s8x16m2``, ``s16x4m4``, ``s8x2m16``, ``s16x2m8``: other
  blocks, steps x sub-chunks (a block spans steps x sub-chunks of the time
  axis), and the blocks an SM the registers are bounded for
- ``rolled``:    each thread's prefix folded in a rolled loop
- ``nomath``:    no exp, sqrt or sigmoid: a_t and b_t from the inputs by
                 multiplies (wrong results)
- ``noscan``:    no cluster barrier and no reads of the other blocks'
                 composites (wrong results)
- ``noload``:    no loads of x, gx and ga (the tiles as they are)
- ``noprefetch``: each unit's tiles waited for before it computes (the
                 next unit's copies not overlapped)
- ``r1``:        clusters of one block walking every window (the wrapper's
                 cluster limit set to 1)
- ``accurate``:  the sigmoids' IEEE division and an IEEE sqrtf in place
                 of the kernel's SFU forms
- ``fastmath``:  built with ``--use_fast_math`` (approximate exp, sqrt and
                 division: how much of the time the arithmetic takes)
- ``nostore``:   no stores of y
- ``empty``:     every block returns at once (launch and cluster cost)

Each variant is called through the port's own wrapper (its library put in
place of the built one, the wrapper's block constants set to the
variant's) in bf16 at RecurrentGemma-2B's layer shape (4, 1024, 2560), in
fp32 there and in bf16 at (4, 4096, 2560), timed in a CUDA graph as
``chip_smoke.py`` times kernels, with its largest error against the plain
version; one JSON line a variant.  A substitution that no longer matches
the source fails the script.
"""
from __future__ import annotations

import json
import sys

from k3_ablate import ROOT, build, card, install, time_ms

SHAPES = (((4, 1024, 2560), "bfloat16"), ((4, 1024, 2560), "float32"),
          ((4, 4096, 2560), "bfloat16"))


def block(steps, sub, min_blocks):
    return [("constexpr int SUB = 4; ", f"constexpr int SUB = {sub}; "),
            ("constexpr int STEPS = 8; ", f"constexpr int STEPS = {steps}; "),
            ("constexpr int MIN_BLOCKS = 8; ",
             f"constexpr int MIN_BLOCKS = {min_blocks}; ")]


def variants():
    return {
        "base": [],
        "m6": block(8, 4, 6),
        "s8x8m4": block(8, 8, 4),
        "s8x16m2": block(8, 16, 2),
        "s16x4m4": block(16, 4, 4),
        "s8x2m16": block(8, 2, 16),
        "s16x2m8": block(16, 2, 8),
        "rolled": [("#pragma unroll\n    for (int k = 0; k < SUB - 1; ++k)\n"
                    "      if (k < j) fold(",
                    "    for (int k = 0; k < j; ++k)\n      fold(")],
        "nomath": [
            ("      const float l = sp * sigmoid_sfu(gai);",
             "      const float l = sp * gai;"),
            ("      const float m = sqrt_sfu(fmaxf(1.0f - expf(2.0f * l), 1e-12f));",
             "      const float m = l;"),
            ("      av[i] = in ? expf(l) : 1.0f;", "      av[i] = in ? l : 1.0f;"),
            ("m * sigmoid_sfu(gxi) * xi", "m * gxi * xi")],
        "noscan": [("    cluster_sync();                     // every block's "
                    "composite published\n", ""),
                   ("    if (j == 0) {\n", "    if (j < 0) {\n")],
        "noload": [("  if (a.vec) {\n", "  if (a.S < 0) {\n"),
                   ("  } else {\n    for (int e = threadIdx.x;",
                    "  } else if (a.S < 0) {\n    for (int e = threadIdx.x;")],
        "noprefetch": [('      asm volatile("cp.async.wait_group 1;\\n" ::: "memory");',
                        '      asm volatile("cp.async.wait_group 0;\\n" ::: "memory");')],
        "r1": [],
        "accurate": [
            ("sp * sigmoid_sfu(gai)", "sp * sigmoid_f32(gai)"),
            ("      const float m = sqrt_sfu(", "      const float m = sqrtf("),
            ("m * sigmoid_sfu(gxi)", "m * sigmoid_f32(gxi)")],
        "fastmath": [],
        "nostore": [("      if (inw && t0 + i < a.S)\n",
                     "      if (!inw && t0 + i < a.S)\n")],
        "empty": [("  const int c = threadIdx.x % CH;\n",
                   "  if (a.S > 0) return;\n  const int c = threadIdx.x % CH;\n")],
    }


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru as RG
    print(card())
    table = variants()
    built = build("rglru", table, ROOT / "build/k7_ablate",
                  flags={"fastmath": ("--use_fast_math",)})
    print("ptxas base:", _build.ptxas_counts(built["base"][1],
                                             "rglru_chunked_kernel"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for (b, s, w), dt in SHAPES:
        f = lambda *shp: torch.randn(*shp, generator=gen, device="cuda")
        dtype = getattr(torch, dt)
        args = ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
                f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)
        cases.append((f"{(b, s, w)} {dt}", args, RG.rglru_scan_plain(*args)))
    for var, (path, log) in built.items():
        subs = dict((old.split(" =")[0].split()[-1], new)
                    for old, new in table[var] if "constexpr" in old)
        steps = int(subs["STEPS"].split("= ")[1][:-2]) if subs else 8
        sub = int(subs["SUB"].split("= ")[1][:-2]) if subs else 4
        RG.SUBCHUNKS, RG.SUB_STEPS = sub, steps
        RG.MAX_CLUSTER = 1 if var == "r1" else 8
        install("rglru", path)
        row = {"variant": var, "block": [steps, sub],
               "ptxas": _build.ptxas_counts(log, "rglru_chunked_kernel")[:1]}
        for name, args, want in cases:
            got = RG.rglru_scan(*args)
            row[name] = {"ms": time_ms(lambda: RG.rglru_scan(*args)),
                         "err": (got.float() - want.float()).abs().max()
                         .item()}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
