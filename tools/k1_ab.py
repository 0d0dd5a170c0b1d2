#!/usr/bin/env python3
"""Time K1 (the systolic GEMM) of two checkouts in turns, on one card.

    python3 tools/k1_ab.py OLD_ROOT NEW_ROOT [--rounds 1]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K1 in fp32 at the 20 distinct shapes of one ResNet-50
request's 53 GEMMs (224x224, batch 1), and ``torch.matmul`` (cuBLAS, TF32
off) beside it: ``reps`` calls captured in one CUDA graph, replayed, so the
host's launch cost drops out (as ``chip_smoke.py``'s ``time_ms``).  ``k1``
takes every w row-major, as both trees do; ``k1_main`` takes w as the main
path hands it over (K-major for the 3x3 and 7x7 convolutions, whose weight
``models/vision.py`` copies in that layout), where the tree's kernel takes
that layout, else row-major.  It prints the card's name and power limit,
then one JSON line per run: each series' sum over the 53 GEMMs and its ms
at each shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (M, K, N): times in one request
SHAPES = {(12544, 147, 64): 1, (3136, 64, 256): 4, (3136, 64, 64): 1,
          (3136, 576, 64): 3, (3136, 256, 64): 2, (3136, 256, 128): 1,
          (784, 256, 512): 1, (784, 1152, 128): 4, (784, 128, 512): 4,
          (784, 512, 128): 3, (784, 512, 256): 1, (196, 512, 1024): 1,
          (196, 2304, 256): 6, (196, 256, 1024): 6, (196, 1024, 256): 5,
          (196, 1024, 512): 1, (49, 1024, 2048): 1, (49, 4608, 512): 3,
          (49, 512, 2048): 3, (49, 2048, 512): 2}
# the shapes whose w the main path passes K-major (3x3 and 7x7 convolutions)
KMAJOR = {(12544, 147, 64), (3136, 576, 64), (784, 1152, 128),
          (196, 2304, 256), (49, 4608, 512)}

CHILD = """
import json, math, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels.systolic_matmul import systolic_matmul
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)

def time_ms(fn, reps=10):
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

out = {{"k1": {{}}, "k1_main": {{}}, "torch.matmul": {{}}}}
for (M, K, N), n in {shapes!r}:
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) * math.sqrt(2.0 / K)
    wt = w.t().contiguous().t()
    out["k1"][str((M, K, N))] = ms = time_ms(lambda: systolic_matmul(x, w))
    if (M, K, N) in {kmajor!r}:
        try:
            ms = time_ms(lambda: systolic_matmul(x, wt))
        except ValueError:             # a kernel that takes w row-major only
            pass
    out["k1_main"][str((M, K, N))] = ms
    out["torch.matmul"][str((M, K, N))] = time_ms(lambda: torch.matmul(x, w))
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    shapes = list(SHAPES.items())
    for label in ("old", "new", "new", "old") * args.rounds:
        src = str(Path(getattr(args, label)).resolve() / "src")
        code = CHILD.format(src=src, shapes=shapes, kmajor=KMAJOR)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        total = {k: sum(n * row[k][str(s)] for s, n in shapes) for k in row}
        print(json.dumps({"tree": label, "sum_53_ms": total, "ms": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
