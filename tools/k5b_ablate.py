#!/usr/bin/env python3
"""Where K5b's bf16 time goes (flash attention's backward,
``csrc/flash_attention.cu``): time its design choices and variants of the
kernel with one part changed or cut.

    python3 tools/k5b_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is
(``base``, printing what ``ptxas`` says of the backward's kernels) and, in
parallel, copies of it changed by text substitutions:

- ``stages1``:   each step's copies of the next steps' tiles waited for
                 before its products (no copy behind a product)
- ``stages3``:   three stages up to D 128 (copies two steps ahead; the
                 kernel keeps two, and D 256 has no room for a third)
- ``nomask``:    no tile masked pair by pair (wrong results)
- ``noexchange``: warpgroup 1 takes P without waiting for warpgroup 0
                 (wrong results: the cost of the hand-over)
- ``noss``:      no S or dP products (wrong results)
- ``nors``:      no dV, dK or dQ products (wrong results)
- ``noexp``:     no exponential: P = S - lse (wrong results)
- ``noload``:    no copies of the other side's tiles after the first
                 (wrong results)
- ``nodq``:      no dQ pass (Delta and the dK/dV pass alone)
- ``nodkdv``:    no dK/dV pass (Delta and the dQ pass alone)

Each variant is called through the port's own wrapper (its library put in
place of the built one) in bf16 at ``chip_smoke.py``'s three training
shapes, fed K5's output and log-sum-exp, timed in a CUDA graph as
``chip_smoke.py`` times kernels, with its largest relative Frobenius error
against the plain version.  Then ``base`` again at RecurrentGemma-2B's
shape with the dK/dV pass's cluster forced to each R from 1 to 8 (the
plan's R marked).  One JSON line a row.  A substitution that no longer
matches the source fails the script.
"""
from __future__ import annotations

import json
import sys

from k3_ablate import ROOT, build, card, install, time_ms

SHAPES = (((4, 10, 1, 1024, 1024, 256), 2048), ((1, 10, 1, 4096, 4096, 256),
                                                2048),
          ((4, 32, 8, 1024, 1024, 128), 0))


def variants():
    return {
        "base": [],
        "stages1": [("    publish_stage<NST - 2>();\n",
                     "    publish_stage<0>();\n"),
                    ('    if (s + NST - 1 < n_steps) load_step(s + NST - 1, '
                     '(s + NST - 1) % NST);\n'
                     '    asm volatile("cp.async.commit_group;\\n" ::: "memory");\n',
                     '    if (s + NST - 1 < n_steps) load_step(s + NST - 1, '
                     '(s + NST - 1) % NST);\n'
                     '    asm volatile("cp.async.commit_group;\\n" ::: "memory");\n'
                     '    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n')],
        "stages3": [("__host__ __device__ constexpr int bwd_stages() {\n  return 2;",
                     "__host__ __device__ constexpr int bwd_stages() {\n"
                     "  return DQK <= 128 ? 3 : 2;")],
        "nomask": [("    if (!pair_tile_masked(k0, q0, a))\n",
                    "    if (true)\n")],
        "noexchange": [("        bar_wait(1);\n", "")],
        "noss": [
            ("        qk_products<DQK / 16>(x, wgmma_desc(own1 + wg * TQ, 16, "
             "1024),\n                              wgmma_desc(o1, 16, 1024));\n",
             ""),
            ("        qk_products<DV / 16>(y, wgmma_desc(own2 + wg * TV, 16, "
             "1024),\n                             wgmma_desc(o2, 16, 1024));\n",
             ""),
            ("        qk_products<DQK / 16>(x, wgmma_desc(wg ? own2 : own1, 16, "
             "1024),\n                              wgmma_desc(wg ? o2 : o1, 16, "
             "1024));\n", "")],
        "nors": [("          pv_product<NDV>(acc, f, o2);\n", ""),
                 ("          pv_product<NDQ>(acc2, f, o1);\n", ""),
                 ("          pv_product<NDQ>(acc, f, o1);  // dQ += dS K\n", ""),
                 ("          pv_product<NDQ>(acc, f, wg ? o1 : o2);\n", ""),
                 ("          pv_product<NDQ / 2>(acc, f, o1 + wg * (NDQ / 2) * "
                  "BLOCK_BYTES);\n", "")],
        "noexp": [("          float p = ex2(fmaf(x[i], scale_log2, -l2));",
                   "          float p = x[i] - l2;")],
        "noload": [('    if (s + NST - 1 < n_steps) load_step(s + NST - 1, '
                    '(s + NST - 1) % NST);\n', "")],
        "nodq": [("    flash_bwd_bf16_kernel<DQK, DV, false>\n        <<<",
                  "    if (B < 0) flash_bwd_bf16_kernel<DQK, DV, false>\n"
                  "        <<<")],
        "nodkdv": [("    err = static_cast<int>(\n        cudaLaunchKernelEx(",
                    "    if (B < 0) err = static_cast<int>(\n        cudaLaunchKernelEx(")],
    }


def rel(got, want):
    return max(((g.float() - w.float()).norm() / w.float().norm()).item()
               for g, w in zip(got, want))


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    print(card())
    built = build("flash_attention", variants(), ROOT / "build/k5b_ablate")
    print("ptxas base:", _build.ptxas_counts(built["base"][1],
                                             "flash_bwd_bf16_kernel"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for (B, H, KV, Sq, Skv, D), window in SHAPES:
        f = lambda *shp: torch.randn(*shp, generator=gen,
                                     device="cuda").to(torch.bfloat16)
        q, k, v, do = f(B, H, Sq, D), f(B, KV, Skv, D), f(B, KV, Skv, D), \
            f(B, H, Sq, D)
        install("flash_attention", built["base"][0])
        o, lse = FA.flash_attention(q, k, v, causal=True, window=window,
                                    return_lse=True)
        args = (q, k, v, o, lse, do)
        want = FA.flash_attention_bwd_plain(*args, causal=True, window=window)
        cases.append((f"{(B, H, KV, Sq, Skv, D)} window {window}",
                      (B, H, KV, Sq, Skv, D), args, window, want))
    for var, (path, log) in built.items():
        install("flash_attention", path)
        row = {"variant": var}
        for name, _, args, window, want in cases:
            run = lambda: FA.flash_attention_bwd(*args, causal=True,
                                                 window=window)
            row[name] = {"ms": time_ms(run, 5), "rel": rel(run(), want)}
        print(json.dumps(row), flush=True)
    install("flash_attention", built["base"][0])
    name, shape, args, window, want = cases[0]
    plan = FA.bwd_plan
    own = plan(*shape, True, window, FA._sms(args[0].device))["cluster"]
    for r in range(1, 9):
        FA.bwd_plan = lambda *a, r=r, **kw: plan(*a, **kw, cluster=r)
        run = lambda: FA.flash_attention_bwd(*args, causal=True,
                                             window=window)
        print(json.dumps({"shape": name, "cluster": r, "plan's": r == own,
                          "ms": time_ms(run, 5), "rel": rel(run(), want)}),
              flush=True)
    FA.bwd_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
