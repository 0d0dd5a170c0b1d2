#!/usr/bin/env python3
"""Time K3 (int8 quantize) of two checkouts in turns, on one card, with the
Mamba-2 370M train step beside it.

    python3 tools/k3_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times, on fp32 rows made from a seed:

- ``k3``: K3 at the training path's largest leaf, (1, 215,482,368), the
  stacked ``in_proj``'s gradient as one row;
- ``k3_step``: K3 summed over the ten leaves of a Mamba-2 370M train step,
  each one row, as ``distributed/compression.py`` hands them over;

each as ``reps`` calls captured in one CUDA graph and replayed, so the
host's launch cost drops out (as ``chip_smoke.py``'s ``time_ms``).  Unless
``--no-model``, it then builds Mamba-2 370M at full width and depth from a
seed and times, on the host's clock around work that ends in a
synchronize, the median of 3 train steps at batch 8 x 1024 (AdamW, int8
gradients; ``train_step_ms``) after warm-up.  It prints the card's name and
power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

STEP_LEAVES = (1536, 442368, 1536, 1536, 215482368, 49152, 98304, 100663296,
               51642368, 1024)

CHILD = """
import json, statistics, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import vector_engine as VE
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)

def time_ms(fn, reps=3):
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

out = {{"k3_step": 0.0}}
for n in {leaves!r}:
    x = torch.randn(1, n, generator=gen, device=dev) * 1e-3
    ms = time_ms(lambda: VE.quantize_int8(x))
    out["k3_step"] += ms
    if n == max({leaves!r}):
        out["k3"] = ms
    del x
torch.cuda.empty_cache()
if {model!r}:
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_arch("mamba2-370m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init(params)
    step_fn = ST.make_train_step(cfg, TrainConfig(
        grad_compression="int8", warmup_steps=2, total_steps=10))
    batch = TokenStream(cfg, 8, 1024, 0, device=dev).batch_at(0)
    state = [params, opt]

    def step():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        m["loss"].item()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    out["train_step_ms"] = statistics.median(ts)
print(json.dumps(out))
"""


def run_in_turns(child: str, argv=None, **fields) -> int:
    """Parse OLD NEW [--rounds] [--no-model], then run ``child`` (formatted
    with ``src``, ``model`` and ``fields``) old, new, new, old; one JSON
    line a run after the card's name and power limit."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--no-model", action="store_true")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    for label in ("old", "new", "new", "old") * args.rounds:
        src = str(Path(getattr(args, label)).resolve() / "src")
        code = child.format(src=src, model=not args.no_model, **fields)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run_in_turns(CHILD, leaves=STEP_LEAVES))
