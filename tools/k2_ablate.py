#!/usr/bin/env python3
"""Where K2's time goes (the fused affine pass, ``csrc/vector_engine.cu``):
time variants of the kernel with one part changed.

    python3 tools/k2_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/vector_engine.cu`` as it is
(``base``) and, in parallel, copies of it changed by text substitutions:

- ``threads64``, ``threads256``: blocks of 64 or 256 threads, not 128
- ``unroll1``:   a thread loads one row at a time, not four at a time
- ``scalar``:    every row read and written element by element (as if no
                 row were 16-byte aligned)

Each variant is called through the port's own wrapper (its library put in
place of the built one) at the request's shape (1, 150528) and at (256,
1024), fp32, timed in a CUDA graph as ``chip_smoke.py`` times kernels,
beside ``torch.addcmul`` at the same shapes and checked against the plain
version; one JSON line a variant.  A substitution that no longer matches
the source fails the script.  The helpers are ``tools/k3_ablate.py``'s.
"""
from __future__ import annotations

import json
import sys

from k3_ablate import ROOT, build, card, install, time_ms

sys.path.insert(0, str(ROOT / "src"))


def variants():
    threads = "constexpr int THREADS = 128;"
    return {
        "base": [],
        "threads64": [(threads, "constexpr int THREADS = 64;")],
        "threads256": [(threads, "constexpr int THREADS = 256;")],
        "unroll1": [("constexpr int ROW_UNROLL = 4;",
                     "constexpr int ROW_UNROLL = 1;")],
        "scalar": [("n == V && aligned_to(xr, 16)", "false"),
                   ("n == V && aligned_to(orow, OUT_ALIGN)", "false")],
    }


def main() -> int:
    import torch
    from repro_torch.kernels import vector_engine as VE
    print(card())
    built = build("vector_engine", variants(), ROOT / "build/k2_ablate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {}
    for M, N in ((1, 150528), (256, 1024)):
        shapes[(M, N)] = [torch.randn(*sh, generator=gen, device="cuda")
                          for sh in ((M, N), (N,), (N,))]
    for var, (path, _) in built.items():
        install("vector_engine", path)
        row = {"variant": var}
        for (M, N), (x, s, b) in shapes.items():
            err = (VE.fused_affine_act(x, s, b, act="gelu")
                   - VE.fused_affine_act_plain(x, s, b, act="gelu")).abs()
            row[f"{M}x{N}"] = time_ms(lambda: VE.fused_affine_act(x, s, b))
            row[f"addcmul_{M}x{N}"] = time_ms(lambda: torch.addcmul(b, x, s))
            row[f"err_{M}x{N}"] = err.max().item()
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
