#!/usr/bin/env python3
"""Where K1's fp32 time goes: time variants of the kernel with one part cut,
and every tile plan of each request shape.

    python3 tools/k1_ablate.py [--sweep]

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/systolic_matmul.cu`` as it is
(``base``, printing what ``ptxas`` says of each instance) and, in parallel,
copies of it with one part removed by a text substitution (the copies
compute wrong results; only their times count):

- ``noload``:      no global loads inside the K loop (the first tile's only)
- ``nostore``:     no split and no shared-memory stores inside the K loop
- ``oneproduct``:  one TF32 product a k8 step (hi.hi) instead of three
- ``noproduct``:   no wgmma at all
- ``noepilogue``:  no output written (nor the cluster sum that feeds it)
- ``noact``:       no activation in the epilogue
- ``empty``:       every block returns at once (launch and cluster cost)

Each library goes to ``build/k1_ablate/`` and is called through its C entry
point at the 20 distinct shapes of one ResNet-50 request (fp32, w in the
layout the main path hands over, the plan ``tile_plan`` picks), timed in a CUDA graph as ``chip_smoke.py`` times
kernels; a line gives each variant's sum over the request's 53 GEMMs and
its per-shape ms.  With ``--sweep`` the base kernel is also timed at every
plan (BM, BN, slices) that the kernel takes for each shape, and the fastest
three are printed beside the picker's, then every plan's ms as JSON.  A substitution that no longer
matches the source fails the script, so it cannot time a variant it did
not make.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
SRC = ROOT / "src/repro_torch/kernels/csrc/systolic_matmul.cu"
OUT = ROOT / "build/k1_ablate"
sys.path.insert(0, str(ROOT / "tools"))
from k1_ab import KMAJOR, SHAPES  # noqa: E402


def variants(src):
    loads = "    if (t + 2 < tiles) load(set, k_lo + (t + 2) * BK);\n"
    stores = "    if (t + 1 < tiles) store(Next{}, s ^ 1);\n"
    three = ("        Mma<BN>::tf32_rs(acc, a_lo[ks], db + o);\n"
             "        Mma<BN>::tf32_rs(acc, a_hi[ks], dbl + o);\n")
    one = "        Mma<BN>::tf32_rs(acc, a_hi[ks], db + o);\n"
    start = "  const Tin* __restrict__ x = static_cast<const Tin*>(p.x);\n"
    return {
        "base": [],
        "noload": [(loads, "")],
        "nostore": [(stores, "")],
        "oneproduct": [(three, "")],
        "noproduct": [(three, ""), (one, "")],
        "noepilogue": [("      if (gm < p.M && gn < p.N) {\n",
                        "      if (gm < 0) {\n"),
                       ("    if (e < chunks && gm < p.M && gn < p.N) {\n",
                        "    if (e < 0) {\n")],
        "noact": [("apply_act(ACT, o[j])", "o[j]")],
        "empty": [(start, "  if (p.M >= 0) return;\n" + start)],
    }


def build(src):
    from repro_torch.kernels import _build
    texts = {}
    for name, subs in variants(src).items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k1_ablate: variant {name} no longer "
                                 f"matches the source: {old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        path = OUT / f"{name}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
               "-o", str(OUT / f"{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k1_ablate: nvcc failed for {name}:\n{log}")
        if name == "base":
            kernel = ""
            for ln in log.splitlines():
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1]
                elif "spill" in ln or "Used" in ln:
                    print(f"  {kernel[-40:]}: {ln.strip()}")
    return list(procs)


def time_ms(fn, reps=10):
    import torch
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_ablate: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.systolic_matmul import tile_plan
    OUT.mkdir(parents=True, exist_ok=True)
    names = build(SRC.read_text())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev) * math.sqrt(2.0 / K)
        if (M, K, N) in KMAJOR:
            w = w.t().contiguous().t()
        inputs[(M, K, N)] = (x, w, torch.empty(M, N, device=dev))

    def caller(fn, shape, plan):
        x, w, out = inputs[shape]
        M, K, N = shape

        def run():
            code = fn(x.data_ptr(), w.data_ptr(), int(not w.is_contiguous()),
                      None, out.data_ptr(), M, N, K, *plan, 0, 0, 0,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{shape} {plan}: launch failed ({code})")
        return run

    fns = {}
    for name in names:
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).systolic_matmul
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fns[name] = fn
        ms = {s: time_ms(caller(fn, s, tile_plan(*s, sms))) for s in SHAPES}
        total = sum(n * ms[s] for s, n in SHAPES.items())
        print(json.dumps({"variant": name, "sum_53_ms": total,
                          "ms": {str(s): v for s, v in ms.items()}}))
    if args.sweep:
        for (M, K, N) in SHAPES:
            got = []
            for bm in (64, 128):
                for bn in (32, 64):
                    for sl in range(1, 9):
                        if sl > 1 and K < 128 * sl:
                            break
                        got.append((time_ms(caller(fns["base"], (M, K, N),
                                                   (bm, bn, sl))),
                                    bm, bn, sl))
            picked = tile_plan(M, K, N, sms)
            mine = next(t for t in got if t[1:] == picked)
            best = "; ".join(f"{bm}x{bn}/{sl} {t:.4f}"
                             for t, bm, bn, sl in sorted(got)[:3])
            print(f"sweep ({M}, {K}, {N}): picked {picked[0]}x{picked[1]}/"
                  f"{picked[2]} {mine[0]:.4f}; fastest {best}")
            print(json.dumps({"sweep": [M, K, N], "ms": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
