#!/usr/bin/env python3
"""Where K7b's time goes (the RG-LRU scan's backward, ``csrc/rglru.cu``):
time variants of the kernel with one part changed or cut.

    python3 tools/k7b_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/rglru.cu`` as it is (``base``,
printing what ``ptxas`` says of the kernel) and, in parallel, copies of
it changed by text substitutions:

- ``m2``, ``m3``, ``m6``: the blocks an SM the registers are bounded for
                 (the kernel's 4: at most 128 registers a thread)
- ``accurate``:  the sigmoids' IEEE division, an IEEE sqrtf and an IEEE
                 division in place of the kernel's SFU forms
- ``fastmath``:  built with ``--use_fast_math`` (approximate exp, sqrt and
                 division: how much of the time the arithmetic takes)
- ``noprefetch``: each unit's tiles waited for before it computes (the
                 next unit's copies not overlapped)
- ``nostore``:   no stores of dx, dgx, dga (and no dlog_a terms)
- ``r1``:        clusters of one block walking every window (the plan's
                 cluster set to 1 for K7b)

Each variant is called through the port's own wrapper (its library put in
place of the built one), fed K7's kept fp32 states, in bf16 at
RecurrentGemma-2B's layer shape (4, 1024, 2560), in fp32 there and in bf16
at (4, 4096, 2560), timed in a CUDA graph as ``chip_smoke.py`` times
kernels, with its largest error against the plain version; one JSON line a
variant.  A substitution that no longer matches the source fails the
script.
"""
from __future__ import annotations

import json
import sys

from k3_ablate import ROOT, build, card, install, time_ms

SHAPES = (((4, 1024, 2560), "bfloat16"), ((4, 1024, 2560), "float32"),
          ((4, 4096, 2560), "bfloat16"))


def min_blocks(n):
    return [("constexpr int BWD_MIN_BLOCKS = 4; ",
             f"constexpr int BWD_MIN_BLOCKS = {n}; ")]


def variants():
    return {
        "base": [],
        "m2": min_blocks(2),
        "m3": min_blocks(3),
        "m6": min_blocks(6),
        "accurate": [
            ("rv[i] = sigmoid_sfu(to_f32(", "rv[i] = sigmoid_f32(to_f32("),
            ("const float ig = sigmoid_sfu(", "const float ig = sigmoid_f32("),
            ("const float m = sqrt_sfu(fmaxf(uu", "const float m = sqrtf(fmaxf(uu"),
            ("__fdividef(e2, m)", "(e2 / m)")],
        "fastmath": [],
        "noprefetch": [
            ("                   unit_tb(u + 1), nit % a.tiles * CH);\n"
             '      asm volatile("cp.async.wait_group 1;\\n" ::: "memory");',
             "                   unit_tb(u + 1), nit % a.tiles * CH);\n"
             '      asm volatile("cp.async.wait_group 0;\\n" ::: "memory");')],
        "nostore": [("      if (inw && t < a.S) {\n        const long long o",
                     "      if (!inw && t < a.S) {\n        const long long o")],
        "r1": [],
    }


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru as RG
    print(card())
    built = build("rglru", variants(), ROOT / "build/k7b_ablate",
                  flags={"fastmath": ("--use_fast_math",)})
    print("ptxas base:", _build.ptxas_counts(built["base"][1],
                                             "rglru_bwd_chunked_kernel"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    install("rglru", built["base"][0])
    cases = []
    for (b, s, w), dt in SHAPES:
        f = lambda *shp: torch.randn(*shp, generator=gen, device="cuda")
        dtype = getattr(torch, dt)
        args = ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
                f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)
        _, h32 = RG.rglru_scan(*args, keep_states=True)
        args = (*args, h32, f(b, s, w).to(dtype))
        cases.append((f"{(b, s, w)} {dt}", args,
                      RG.rglru_scan_bwd_plain(*args)))
    plan = RG.launch_plan
    for var, (path, log) in built.items():
        install("rglru", path)
        RG.launch_plan = ((lambda B, S, W: {**plan(B, S, W), "cluster": 1})
                          if var == "r1" else plan)
        row = {"variant": var,
               "ptxas": _build.ptxas_counts(log, "rglru_bwd_chunked_kernel")}
        for name, args, want in cases:
            got = RG.rglru_scan_bwd(*args)
            row[name] = {"ms": time_ms(lambda: RG.rglru_scan_bwd(*args), 5),
                         "err": max((g.float() - w.float()).abs().max().item()
                                    for g, w in zip(got, want))}
        print(json.dumps(row), flush=True)
    RG.launch_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
