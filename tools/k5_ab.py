#!/usr/bin/env python3
"""Time K5 (flash attention) of two checkouts in turns, on one card.

    python3 tools/k5_ab.py OLD_ROOT NEW_ROOT [--rounds 2]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K5 at the ViT's fp32 shape and at RecurrentGemma-2B's two
bf16 serving shapes: ``reps`` calls captured in one CUDA graph, replayed,
so the host's launch cost drops out (as ``chip_smoke.py``'s ``time_ms``).
It prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (B, H, KV, Sq, Skv, D), causal, window, dtype
SHAPES = [((1, 4, 4, 122, 122, 32), False, 0, "float32"),
          ((4, 10, 1, 1024, 1024, 256), True, 2048, "bfloat16"),
          ((1, 10, 1, 4096, 4096, 256), True, 2048, "bfloat16")]

CHILD = """
import json, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels.flash_attention import flash_attention
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

out = {{}}
for (B, H, KV, Sq, Skv, D), causal, window, dt in {shapes!r}:
    dtype = getattr(torch, dt)
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, KV, Skv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, KV, Skv, D, generator=gen, device=dev).to(dtype)
    out[f"{{(B, H, KV, Sq, Skv, D)}} {{dt}}"] = time_ms(
        lambda: flash_attention(q, k, v, causal=causal, window=window))
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    for label in ("old", "new", "new", "old") * args.rounds:
        src = str(Path(getattr(args, label)).resolve() / "src")
        code = CHILD.format(src=src, shapes=SHAPES)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "ms": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
