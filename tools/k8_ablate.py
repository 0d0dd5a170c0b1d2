#!/usr/bin/env python3
"""Where K8b's (and K8's) bf16 time goes: time variants of the kernels with
one part cut.

    python3 tools/k8_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/ssd.cu`` as it is (``base``,
printing what ``ptxas`` says of each kernel) and, in parallel, copies of
it with one part removed by a text substitution (the copies compute wrong
results; only their times count):

- ``nodelta``:    K8b without its run-local Delta walk (the clusters' first
                  pass over the chunks)
- ``noprefix``:   neither kernel carries the states across its cluster
- ``nocb``:       K8b without C.B^T
- ``nodyx``:      K8b without dy.x^T (R' and L . dy.x^T still formed)
- ``nouv``:       K8b without C.S_in^T and B.G^T
- ``nodcum``:     K8b without warp 0's dcum, ddt and dA
- ``nodx``:       K8b without M^T.dy
- ``nodc``:       K8b without dC's two products
- ``nodb``:       K8b without dB's two products
- ``nog``:        K8b without the update of G
- ``nosplit``:    one product where an operand is split (hi.hi only)
- ``noproduct``:  no mma.sync at all
- ``nostate``:    K8b without the loads of S_in (the kept chunk states)
- ``nostage``:    K8b's run without any loads of x, dy, S_in and dt
- ``now``:        K8b without <G, S_in>
- ``nostore``:    K8b without the stores of dB and dC
- ``nostage8``:   K8 without the loads of B, C and x
- ``norun``:      K8 without its first walk (the run-local state)
- ``empty``:      every block returns at once (launch and cluster cost)

Each library goes to ``build/k8_ablate/`` and is called through its C
entry points in bf16 at Mamba-2 370M's layer shapes, K8 at the serving
shape (4, 1024, 32, 64, G 1, N 128), K8b at the training shape (8, ...)
from chunk states the repository's own K8 kept, timed in a CUDA graph as
``chip_smoke.py`` times kernels; one JSON line a variant.  A substitution
that no longer matches the source fails the script, so it cannot time a
variant it did not make.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
SRC = ROOT / "src/repro_torch/kernels/csrc/ssd.cu"
OUT = ROOT / "build/k8_ablate"
K8_LAYER = (4, 1024, 32, 64, 1, 128)
K8B_LAYER = (8, 1024, 32, 64, 1, 128)


def variants():
    split = ("        if constexpr (ALO) {\n"
             "#pragma unroll\n"
             "          for (int u = 0; u < NG; ++u)\n"
             "            if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], al, bh[u]);\n"
             "        }\n"
             "        if constexpr (BLO) {\n"
             "#pragma unroll\n"
             "          for (int u = 0; u < NG; ++u)\n"
             "            if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], ah, bl[u]);\n"
             "        }\n")
    one = "          if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], ah, bh[u]);\n"
    return {
        "base": [],
        "nodelta": [("      if (rank > 0) {   // the first run's Delta",
                     "      if (rank < 0) {   // the first run's Delta")],
        "noprefix": [("  if (e >= 8 * cpr) return;\n",
                      "  if (e >= 0) return;\n")],
        "nocb": [("      gemm<E>(cb, Rm<E>{Cs, lde}, Cm<E>{Bs, lde}, r16, c32, "
                  "NP, 4);\n      frag_store(cb, CBs",
                  "      frag_store(cb, CBs")],
        "nodyx": [("        gemm<E>(dd, Rm<E>{dys, ldx}, Cm<E>{xs, ldx}, r16, "
                   "c32, PT, 4);\n", "")],
        "nouv": [("        gemm<E>(cs, Rm<E>{Cs, lde}, Ss.cm(), r16, c32, NP, "
                  "4);\n        gemm<E>(bg, Rm<E>{Bs, lde}, Gq.cm(), r16, "
                  "c32, NP, 4);\n", "")],
        "nodcum": [("      if (warp == 0) {\n        float w = 0.0f;",
                    "      if (warp < 0) {\n        float w = 0.0f;")],
        "nodx": [("        gemm<E>(bg, DecayT{CBs, cum}, Rm<E>{dys, ldx}, r16, "
                  "c32, T, 4);\n", "")],
        "nodc": [("        gemm<E>(dCa, Scaled<Rm<E>, true>{{dys, ldx}, ecum}, "
                  "Ss.rm(), r16, sn0,\n                PT, nts);\n"
                  "        gemm<E>(dCa, Qs.rm(), Rm<E>{Bs, lde}, r16, sn0, T, "
                  "nts);\n", "")],
        "nodb": [("        gemm<E>(dBa, Scaled<Rm<E>, true>{{xs, ldx}, wv}, "
                  "Gq.rm(), r16, sn0,\n                PT, nts);\n"
                  "        gemm<E>(dBa, Qs.cm(), Rm<E>{Cs, lde}, r16, sn0, T, "
                  "nts);\n", "")],
        "nog": [("        gemm<E>(gn, Scaled<Cm<E>, false>{{dys, ldx}, ecum}, "
                 "Rm<E>{Cs, lde},\n                r16, sn0, T, nts);\n", "")],
        "nosplit": [(split, "")],
        "noproduct": [(split, ""), (one, "          ;\n")],
        "nostate": [("  auto state_stage = [&](int q, int c) {\n",
                     "  auto state_stage = [&](int q, int c) {\n"
                     "    if (p.S >= 0) return;\n")],
        "nostage": [("  auto head_load = [&](int q, int c) {\n",
                     "  auto head_load = [&](int q, int c) {\n"
                     "    if (p.S >= 0) return;\n"),
                    ("  auto state_stage = [&](int q, int c) {\n",
                     "  auto state_stage = [&](int q, int c) {\n"
                     "    if (p.S >= 0) return;\n")],
        "now": [("        for (int e = tid; e < PT * NP / 2; e += THREADS) {",
                 "        for (int e = tid; e < 0; e += THREADS) {")],
        "nostore": [("    frag_gstore(dBa, p.dB_p", "    if (p.S < 0) frag_gstore(dBa, p.dB_p"),
                    ("    frag_gstore(dCa, p.dC_p", "    if (p.S < 0) frag_gstore(dCa, p.dC_p")],
        "nostage8": [("    stage<E>(Bs, lde, Bb + r0 * brow, brow, len, N, NP, p.vec_bc);\n"
                      "    if (with_c) stage",
                      "    if (with_c && p.S < 0) stage"),
                     ("    stage<E>(xs, ldx, xb + r0 * xrow, xrow, len, pv, PT, p.vec_x);\n",
                      "")],
        "norun": [("    if (rank < R - 1) {   // the last run's local state",
                   "    if (rank < 0) {   // the last run's local state")],
        "empty": [("ssd_kernel(const FwdArgs p) {\n",
                   "ssd_kernel(const FwdArgs p) {\n  if (p.S >= 0) return;\n"),
                  ("ssd_bwd_kernel(const BwdArgs p) {\n",
                   "ssd_bwd_kernel(const BwdArgs p) {\n"
                   "  if (p.S >= 0) return;\n")],
    }


def build(src):
    from repro_torch.kernels import _build
    procs = {}
    for name, subs in variants().items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k8_ablate: variant {name} no longer "
                                 f"matches the source: {old[:60]!r}")
            text = text.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
               "-o", str(OUT / f"{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k8_ablate: nvcc failed for {name}:\n{log}")
        if name == "base":
            kernel = ""
            for ln in log.splitlines():
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1]
                elif "spill" in ln or "Used" in ln:
                    print(f"  {kernel[-40:]}: {ln.strip()}")
    return list(procs)


def time_ms(fn, reps=5):
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
        print("k8_ablate: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ssd as SSD
    OUT.mkdir(parents=True, exist_ok=True)
    names = build(SRC.read_text())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, h, p, g, n):
        f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
        return ((f(b, s, h, p) * 0.4).bfloat16(),
                torch.nn.functional.softplus(f(b, s, h)),
                -torch.exp(f(h) * 0.4), (f(b, s, g, n) * 0.3).bfloat16(),
                (f(b, s, g, n) * 0.3).bfloat16())

    fwd = inputs(*K8_LAYER)
    y = torch.empty_like(fwd[0])
    hout = torch.empty(4, 32, 64, 128, device=dev)
    bwd = inputs(*K8B_LAYER)
    x, dt, A, Bm, Cm = bwd
    states = SSD.ssd_scan(*bwd, chunk=256, keep_states=True)[2]
    dy = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    B, S, H, P, G, N = K8B_LAYER
    hb = G * -(-(H // G) // SSD.launch_shape(*K8B_LAYER, torch.bfloat16,
                                             backward=True)["heads_per_block"])
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty_like(x), torch.empty(1, B, S, H, **f32),
            torch.empty(1, B, S // 64, H, **f32),
            torch.empty(1, B, S, hb, N, **f32),
            torch.empty(1, B, S, hb, N, **f32), torch.empty(B, H, P, N, **f32))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for name in names:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.ssd_scan.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
        lib.ssd_scan_bwd.argtypes = ([ctypes.c_void_p] * 14
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])

        def k8():
            code = lib.ssd_scan(*(t.data_ptr() for t in fwd[:5]), None,
                                y.data_ptr(), hout.data_ptr(), None,
                                *K8_LAYER, 1, stream())
            if code:
                raise RuntimeError(f"{name}: K8 launch failed ({code})")

        def k8b():
            code = lib.ssd_scan_bwd(
                *(t.data_ptr() for t in bwd), states.data_ptr(),
                dy.data_ptr(), None, *(t.data_ptr() for t in outs),
                *K8B_LAYER, 1, stream())
            if code:
                raise RuntimeError(f"{name}: K8b launch failed ({code})")

        print(json.dumps({"variant": name, "k8_ms": time_ms(k8, 10),
                          "k8b_ms": time_ms(k8b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
