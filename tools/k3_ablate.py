#!/usr/bin/env python3
"""Where K3's time goes (int8 quantize, ``csrc/vector_engine.cu``): time
variants of the kernel with one part changed or cut.

    python3 tools/k3_ablate.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
It builds ``src/repro_torch/kernels/csrc/vector_engine.cu`` as it is
(``base``, printing what ``ptxas`` says of K3's kernels) and, in parallel,
copies of it changed by text substitutions:

- ``unroll8``:   eight 16-byte vectors in flight a thread, not four
- ``occ8``:      at most 32 registers, so that eight blocks fit an SM
- ``forward``:   phase 2 walks its share in phase 1's order (no L2 reuse)
- ``nostash``:   no share kept in shared memory across the barrier
- ``stash40``:   40 KB of the share kept, not 24
- ``nodiv``:     x * scale in place of the IEEE x / scale (wrong codes)
- ``ldcs``:      phase 2 reloads marked evict-first (``__ldcs``)
- ``nol2pf``:    the 16-byte loads without the L2 256-byte prefetch hint
- ``plainst``:   plain stores of the codes, not evict-first
- ``noreload``:  phase 2 reads no x past the stash (wrong codes)
- ``nocodes``:   phase 2 neither reads x nor writes codes
- ``phase1``:    phase 1 and the barrier only (no codes written)

Each variant is called through the port's own wrapper (its library put in
place of the built one) at the training path's largest leaf, (1,
215,482,368) fp32, and summed over a Mamba-2 370M train step's ten leaf
shapes, timed in a CUDA graph as ``chip_smoke.py`` times kernels; one JSON
line a variant.  A substitution that no longer matches the source fails
the script, so it cannot time a variant it did not make.  The helpers are
shared with ``tools/k7_ablate.py``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
CSRC = ROOT / "src/repro_torch/kernels/csrc"
sys.path.insert(0, str(ROOT / "src"))
# Mamba-2 370M's gradient leaves, each quantized as one row
STEP_LEAVES = (1536, 442368, 1536, 1536, 215482368, 49152, 98304, 100663296,
               51642368, 1024)


def variants():
    body = "    for (long long k0 = nv > 0 ? (nv - 1) / STEP * STEP : -1; " \
           "k0 >= 0;\n         k0 -= STEP) {"
    return {
        "base": [],
        "unroll8": [("constexpr int QUNROLL = 4;", "constexpr int QUNROLL = 8;")],
        "occ8": [("__launch_bounds__(QTHREADS, 4)",
                  "__launch_bounds__(QTHREADS, 8)")],
        "forward": [(body, "    for (long long k0 = 0; k0 < nv; k0 += STEP) {")],
        "nostash": [("constexpr int STASH_BYTES = 24 * 1024;",
                     "constexpr int STASH_BYTES = 16;")],
        "stash40": [("constexpr int STASH_BYTES = 24 * 1024;",
                     "constexpr int STASH_BYTES = 40 * 1024;")],
        "nodiv": [("  const float r = rintf(__fdiv_rn(v, scale));",
                   "  const float r = rintf(v * scale);")],
        "ldcs": [(": ldg16_l2(xv + k);", ": __ldcs(xv + k);")],
        "nol2pf": [("ldg16_l2(xv + k)", "ldg16(xv + k)")],
        "plainst": [("__stcs(reinterpret_cast<typename Q::Codes*>(qv) + k, c);",
                     "reinterpret_cast<typename Q::Codes*>(qv)[k] = c;")],
        "noreload": [(": ldg16_l2(xv + k);", ": stash[k & (STASH_VECS - 1)];")],
        "nocodes": [("        if (k >= nv) continue;", "        if (k >= 0) continue;")],
        "phase1": [("  if constexpr (!GIVEN) grid_sync();\n\n",
                    "  if constexpr (!GIVEN) grid_sync();\n  if (N > 0) return;\n")],
    }


def build(name: str, table: dict, out: Path, flags=()) -> dict:
    """Build ``csrc/<name>.cu`` once per variant of ``table`` into
    ``out``, all at once; returns {variant: (library path, ptxas log)}."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / f"{name}.cu").read_text()
    procs = {}
    for var, subs in table.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{var}: substitution no longer matches:\n"
                                 f"{old}")
            text = text.replace(old, new)
        cu = out / f"{var}.cu"
        cu.write_text(text)
        extra = flags.get(var, ()) if isinstance(flags, dict) else flags
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(CSRC),
               "-o", str(out / f"{var}.so"), str(cu)]
        procs[var] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    built = {}
    for var, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{var}: nvcc failed:\n{log}")
        built[var] = (out / f"{var}.so", log)
    return built


def install(name: str, path: Path) -> None:
    """Put the library at ``path`` in place of ``csrc/<name>.cu``'s."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _build._LIBS[name] = lib


def time_ms(fn, reps=10):
    """Device ms a call: ``reps`` calls in one CUDA graph, replayed."""
    import torch
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import vector_engine as VE
    print(card())
    built = build("vector_engine", variants(), ROOT / "build/k3_ablate")
    print("ptxas base:", _build.ptxas_counts(built["base"][1],
                                             "quantize_int8_kernel"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = [torch.randn(1, n, generator=gen, device="cuda") * 1e-3
              for n in STEP_LEAVES]
    want = VE.quantize_int8_plain(leaves[4])
    for var, (path, _) in built.items():
        install("vector_engine", path)
        got = VE.quantize_int8(leaves[4])
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        row = {"variant": var, "exact": exact,
               "largest_ms": time_ms(lambda: VE.quantize_int8(leaves[4]), 3),
               "step_ms": sum(time_ms(lambda: VE.quantize_int8(x), 3)
                              for x in leaves)}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
