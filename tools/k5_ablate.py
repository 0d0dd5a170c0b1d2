#!/usr/bin/env python3
"""Where K5's bf16 time goes: time variants of the kernel with one part cut.

    python3 tools/k5_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is
(``base``, timing the ``nvcc`` call of that one source and printing what
``ptxas`` says of each kernel: registers, spills, shared memory) and, in
parallel, copies of it with one part of the bf16 kernel removed by a text
substitution (the copies compute wrong results; only their times count):

- ``noload``:    no K/V copies inside the loop (the first tile's only)
- ``loadsonly``: no products and no softmax (copies, barriers, output)
- ``nosoftmax``: no masking, no max, no exponentials
- ``norescale``: O never moves to a new maximum inside the loop
- ``nostore``:   no output written
- ``onetile``:   every query tile walks one KV tile (the fixed cost a block)

Each library goes to ``build/k5_ablate/`` and is called through its C entry
point at RecurrentGemma-2B's two serving shapes, timed in a CUDA graph as
``chip_smoke.py`` times kernels.  A substitution that no longer matches the
source fails the script, so it cannot time a variant it did not make.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT = ROOT / "build/k5_ablate"
SHAPES = [(4, 10, 1, 1024, 1024, 256), (1, 10, 1, 4096, 4096, 256)]
WINDOW = 2048


def between(text, start, end):
    return text[text.index(start):text.index(end)]


def variants(src):
    softmax = between(src, "    // Online softmax in fp32: m in",
                      "    // P_j in bf16 once")
    in_loop_loads = (
        "    if (j + 1 < j_hi)\n      load_tile<BK, NDQ>(k_smem + (stage ^ 1)"
        " * TILE, kg, (j + 1) * BK, Skv,\n                         DQK);\n"
        "    load_tile<BK, NDV>(v_smem + stage * TILE_V, vg, j * BK, Skv, DV);"
        "\n")
    store = "    if (wq0 + row < Sq && col < DV)\n"
    return {
        "base": [],
        "noload": [(in_loop_loads, "")],
        "loadsonly": [
            ("    qk_products<DQK / 16>(s, qd, wgmma_desc(k_smem + stage * "
             "TILE, 16, 1024));\n", ""),
            ("      pv_product<NDV>(acc, p, v_smem + (stage ^ 1) * TILE_V);"
             "\n", ""),
            ("    pv_product<NDV>(acc, p, v_smem + ((j_hi - 1 - j_lo) & 1) * "
             "TILE_V);\n", ""),
            (softmax, "")],
        "nosoftmax": [(softmax, "")],
        "norescale": [("      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || "
                       "alpha[1] != 1.0f)) {", "      if (false) {")],
        "nostore": [(store, "    if (row < 0)\n")],
        "onetile": [("  const int j_hi = (t.k_hi + BK - 1) / BK;",
                     "  const int j_hi = j_lo + 1;")],
    }


def build(src):
    from repro_torch.kernels import _build
    procs = {}
    for name, subs in variants(src).items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k5_ablate: variant {name} no longer "
                                 f"matches the source: {old[:60]!r}")
            text = text.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
               "-o", str(OUT / f"{name}.so"), str(path)]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (t0, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k5_ablate: nvcc failed for {name}:\n{log}")
        if name == "base":
            print(f"nvcc flash_attention.cu (base, built beside "
                  f"{len(procs) - 1} others): {time.perf_counter() - t0:.1f} s")
            kernel = ""
            for ln in log.splitlines():
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1]
                elif "spill" in ln or "Used" in ln:
                    print(f"  {kernel[-60:]}: {ln.strip()}")
    return list(procs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_ablate: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(OUT / "solo.so"), str(SRC)], check=True,
                   capture_output=True)
    print(f"nvcc flash_attention.cu alone: {time.perf_counter() - t0:.1f} s")
    names = build(SRC.read_text())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, reps=10):
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
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

    for B, H, KV, Sq, Skv, D in SHAPES:
        q = torch.randn(B, H, Sq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, KV, Skv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, KV, Skv, D, generator=gen, device=dev).bfloat16()
        o = torch.empty_like(q)
        row = []
        for name in names:
            fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])

            def run(fn=fn):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), None, B, H, KV, Sq, Skv, D, D,
                          1.0 / math.sqrt(D), 1, WINDOW, 1,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: launch failed ({code})")
            row.append(f"{name} {time_ms(run):.4f}")
        print(f"K5 bf16 {(B, H, KV, Sq, Skv, D)} causal window {WINDOW} ms: "
              + "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
