#!/usr/bin/env python3
"""Time K5 (flash attention) of two checkouts in turns, on one card.

    python3 tools/k5_ab.py OLD_ROOT NEW_ROOT [--rounds 2]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K5 at the ViT's fp32 request shape, at RecurrentGemma-2B's
two bf16 serving shapes, and in fp32 at ``FP32``'s shapes: the serving
and rank shapes whose fp32 times ``PERF.md`` lists, each beside
F.scaled_dot_product_attention on the same fp32 inputs (TF32 off; its
EFFICIENT_ATTENTION backend, the one fused backend that takes fp32), the
yardstick.  Each time is ``reps`` calls captured in one CUDA graph,
replayed, so the host's launch cost drops out (as ``chip_smoke.py``'s
``time_ms``).  It prints the card's name and power limit, then one JSON
line per run.
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
# fp32: name: ((B, H, KV, Sq, Skv, D[, Dv]), causal)
FP32 = {"qwen1.5-4b": ((4, 20, 20, 1024, 1024, 128), True),
        "whisper_encoder": ((4, 16, 16, 1500, 1500, 64), False),
        "whisper_cross": ((4, 16, 16, 384, 1500, 64), False),
        "minicpm3": ((4, 40, 40, 1024, 1024, 96, 64), True),
        "gpt2": ((4, 25, 25, 992, 992, 64), True),
        "vit-632m": ((4, 16, 16, 512, 512, 80), True),
        "rank_17e": ((1, 16, 4, 256, 256, 128), True),
        "rank_17f": ((2, 16, 4, 256, 256, 128), True),
        "qwen3-8b": ((4, 32, 8, 1024, 1024, 128), True),
        "qwen3-moe": ((4, 64, 4, 1024, 1024, 128), True),
        "qwen3-8b_tp_rank": ((4, 8, 2, 1024, 1024, 128), True),
        "vit_request": ((1, 4, 4, 122, 122, 32), False)}

CHILD = """
import json, sys
sys.path.insert(0, {src!r})
import torch
import torch.nn.functional as F
from repro_torch.kernels.flash_attention import flash_attention
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
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

def inputs(shape, dtype):
    B, H, KV, Sq, Skv, D, *rest = shape
    Dv = rest[0] if rest else D
    f = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    return f(B, H, Sq, D), f(B, KV, Skv, D), f(B, KV, Skv, Dv)

out = {{}}
for shape, causal, window, dt in {shapes!r}:
    q, k, v = inputs(shape, getattr(torch, dt))
    out[f"{{shape}} {{dt}}"] = time_ms(
        lambda: flash_attention(q, k, v, causal=causal, window=window))
for name, (shape, causal) in {fp32!r}.items():
    q, k, v = inputs(shape, torch.float32)
    gqa = k.shape[1] != q.shape[1]
    out[name + " float32"] = {{
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa))}}
    del q, k, v
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
        code = CHILD.format(src=src, shapes=SHAPES, fp32=FP32)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
