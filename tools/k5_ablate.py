#!/usr/bin/env python3
"""Where K5's and K5b's time goes: time variants of the kernels with one
part cut.

    python3 tools/k5_ablate.py [bf16|fp32]

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is
(``base``, timing the ``nvcc`` call of that one source and printing what
``ptxas`` says of the kernels timed: registers, spills) and, in parallel,
copies of it with one part of a kernel changed by a text substitution (the
cut copies compute wrong results; only their times count).  With no
argument it times both sets.

bf16, K5's bf16 kernel at RecurrentGemma-2B's two serving shapes (causal,
window 2048):

- ``noload``:    no K/V copies inside the loop (the first tile's only)
- ``loadsonly``: no products and no softmax (copies, barriers, output)
- ``nosoftmax``: no masking, no max, no exponentials
- ``norescale``: O never moves to a new maximum inside the loop
- ``nostore``:   no output written
- ``onetile``:   every query tile walks one KV tile (the fixed cost a block)

fp32, K5's and K5b's 3xTF32 kernels at ``FWD`` and ``BWD``'s shapes, K5b
with ``bwd_plan``'s cluster (``base`` also with a cluster of 1):

- ``nosplit``: no hi/lo split of the streamed K/V (or Q/dO) tiles in the
  loops (what splitting each tile once it lands costs)
- ``nw4``:     K5 at head dim 128 in blocks of four warps, not eight
- ``nw2bk16``: K5's two-warp blocks at head dim 128 with 16-key tiles,
  not 32
- ``dqonly``:  K5b's dQ pass alone (with Delta); ``kvonly`` its dK/dV
  pass alone

Each library goes to ``build/k5_ablate/`` and is called through its C entry
points, timed in a CUDA graph as ``chip_smoke.py`` times kernels.  A
substitution that no longer matches the source fails the script, so it
cannot time a variant it did not make.  It prints the card's name and
power limit, then a line a shape.
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
# bf16: (B, H, KV, Sq, Skv, D), causal with WINDOW
SHAPES = [(4, 10, 1, 1024, 1024, 256), (1, 10, 1, 4096, 4096, 256)]
WINDOW = 2048
# fp32: ((B, H, KV, Sq, Skv, D), causal)
FWD = [((4, 20, 20, 1024, 1024, 128), True),
       ((4, 16, 16, 384, 1500, 64), False),
       ((1, 16, 4, 256, 256, 128), True),
       ((2, 16, 4, 256, 256, 128), True),
       ((4, 32, 8, 1024, 1024, 128), True)]
BWD = [((2, 16, 4, 256, 256, 128), True),
       ((4, 32, 8, 1024, 1024, 128), True),
       ((4, 16, 16, 1500, 1500, 64), False)]
KERNELS = {"bf16": ("flash_bf16_kernel",),
           "fp32": ("flash_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                    "flash_bwd_dkdv_tf32_kernel")}
FWD_ONLY, BWD_ONLY = ("nw4", "nw2bk16"), ("dqonly", "kvonly")


def between(text, start, end):
    return text[text.index(start):text.index(end)]


def bf16_variants(src):
    softmax = between(src, "    // Online softmax in fp32: m in",
                      "    // P_j in bf16 once")
    in_loop_loads = (
        "    if (j + 1 < j_hi)\n      load_tile<BK, NDQ>(k_smem + (stage ^ 1)"
        " * TILE, kg, (j + 1) * BK, Skv,\n                         DQK);\n"
        "    load_tile<BK, NDV>(v_smem + stage * TILE_V, vg, j * BK, Skv, DV);"
        "\n")
    store = "    if (wq0 + row < Sq && col < DV)\n"
    return {
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


def fp32_variants(src):
    fwd_split = ("    tf_split<BK, DQK, THREADS>(stage(st), stage(st) + C::KW);\n"
                 "    tf_split<BK, DV, THREADS>(stage(st) + 2 * C::KW,\n"
                 "                              stage(st) + 2 * C::KW + C::VW);"
                 "\n")
    dq_split = ("    tf_split<BT, DQK, THREADS>(stage(st), stage(st) + KW);\n"
                "    tf_split<BT, DV, THREADS>(stage(st) + 2 * KW, stage(st) + "
                "2 * KW + VW);\n")
    kv_split = ("    tf_split<BT, DQK, THREADS>(stage(st), stage(st) + QW);\n"
                "    tf_split<BT, DV, THREADS>(stage(st) + 2 * QW, stage(st) + "
                "2 * QW + GW);\n")
    kv_launch = ("    err = launch_clusters(\n"
                 "        flash_bwd_dkdv_tf32_kernel<DQK, DV>,")
    dq_launch = "    flash_bwd_dq_tf32_kernel<DQK, DV>\n        <<<"
    return {
        "nosplit": [(fwd_split, ""), (dq_split, ""), (kv_split, "")],
        "nw4": [("    if (heads * ((Sq + 127) / 128) >= sms)",
                 "    if (false)")],
        "nw2bk16": [("DQK == 128 ? (NW == 8 ? 16 : 32)",
                     "DQK == 128 ? (NW == 4 ? 32 : 16)")],
        "dqonly": [(kv_launch, "    err = 0;\n    if (false) " +
                    kv_launch.strip())],
        "kvonly": [(dq_launch, "    if (false) " + dq_launch.strip())],
    }


def build(src, sets):
    """Builds ``base`` and the variants of ``sets``, all at once; returns
    {set: [its names, base first]}."""
    from repro_torch.kernels import _build
    made = {"bf16": bf16_variants, "fp32": fp32_variants}
    table = {"base": []}
    names = {}
    for which in sets:
        variants = made[which](src)
        table.update(variants)
        names[which] = ["base", *variants]
    procs = {}
    for name, subs in table.items():
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
            for kernel in (k for which in sets for k in KERNELS[which]):
                for row in _build.ptxas_counts(log, kernel):
                    print(f"  {kernel}{row['instance'][:16]}: "
                          f"{row['registers']} registers, "
                          f"{row['spilled']} bytes spilled")
    return names


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


def load(name):
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p])
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    return lib


def forward(lib, name, q, k, v, o, causal, window):
    """A call of ``lib``'s K5 on q, k, v into o."""
    import torch
    from repro_torch.kernels import _build
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]

    def run():
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, B,
            H, KV, Sq, Skv, D, D, 1.0 / math.sqrt(D), int(causal), window, 0,
            Skv, None, _build.dtype_code(q.dtype),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{name}: launch failed ({code})")
    return run


def main(argv) -> int:
    import torch
    sets = argv or ["bf16", "fp32"]
    if not set(sets) <= {"bf16", "fp32"}:
        print("usage: k5_ablate.py [bf16|fp32]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k5_ablate: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(OUT / "solo.so"), str(SRC)], check=True,
                   capture_output=True)
    print(f"nvcc flash_attention.cu alone: {time.perf_counter() - t0:.1f} s")
    names = build(SRC.read_text(), sets)
    libs = {n: load(n) for ns in names.values() for n in ns}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*s, dtype=torch.float32):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    for B, H, KV, Sq, Skv, D in SHAPES if "bf16" in names else ():
        q = randn(B, H, Sq, D, dtype=torch.bfloat16)
        k, v = (randn(B, KV, Skv, D, dtype=torch.bfloat16) for _ in range(2))
        o = torch.empty_like(q)
        row = [f"{n} {time_ms(forward(libs[n], n, q, k, v, o, True,
                                      WINDOW)):.4f}" for n in names["bf16"]]
        print(f"K5 bf16 {(B, H, KV, Sq, Skv, D)} causal window {WINDOW} ms: "
              + "; ".join(row), flush=True)
    if "fp32" not in names:
        return 0
    for shape, causal in FWD:
        B, H, KV, Sq, Skv, D = shape
        q = randn(B, H, Sq, D)
        k, v = (randn(B, KV, Skv, D) for _ in range(2))
        o = torch.empty_like(q)
        row = [f"{n} {time_ms(forward(libs[n], n, q, k, v, o, causal,
                                      0)):.4f}"
               for n in names["fp32"] if n not in BWD_ONLY]
        print(f"K5 fp32 {shape} causal={causal} ms: " + "; ".join(row),
              flush=True)
    for shape, causal in BWD:
        B, H, KV, Sq, Skv, D = shape
        q, do = randn(B, H, Sq, D), randn(B, H, Sq, D)
        k, v = (randn(B, KV, Skv, D) for _ in range(2))
        o, lse = FA.flash_attention(q, k, v, causal=causal, return_lse=True)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        plan = FA.bwd_plan(B, H, KV, Sq, Skv, D, causal, 0,
                           FA._sms(dev), fp32=True)["cluster"]
        row = []
        for name in names["fp32"]:
            if name in FWD_ONLY:
                continue
            for cluster in ((plan, 1) if name == "base" else (plan,)):
                def run(fn=libs[name].flash_attention_bwd, r=cluster):
                    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq,
                              Skv, D, D, 1.0 / math.sqrt(D), int(causal), 0,
                              0, Skv, None, r, _build.dtype_code(q.dtype),
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{name}: launch failed ({code})")
                row.append(f"{name} R={cluster} {time_ms(run):.4f}")
        print(f"K5b fp32 {shape} causal={causal} ms: " + "; ".join(row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
