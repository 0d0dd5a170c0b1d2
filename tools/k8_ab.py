#!/usr/bin/env python3
"""Time K8 and K8b (the Mamba-2 SSD scan and its gradient) of two checkouts
in turns, on one card, with the paths they serve beside them.

    python3 tools/k8_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times, in bf16 with inputs made from a seed:

- ``k8``: K8 at Mamba-2 370M's serving layer shape (4, 1024, 32, 64, G 1,
  N 128), and ``k8_keep``: the same with the chunk states kept, as the
  training forward runs it at (8, 1024, 32, 64, 1, 128);
- ``k8b``: K8b at the training layer shape, from the kept chunk states;

each as ``reps`` calls captured in one CUDA graph and replayed, so the
host's launch cost drops out (as ``chip_smoke.py``'s ``time_ms``).  Unless
``--no-model``, it then builds Mamba-2 370M at full width and depth from a
seed and times, on the host's clock around work that ends in a
synchronize, the median of 5 prefills at batch 4 x 1024 tokens
(``prefill_ms``) and of 3 train steps at batch 8 x 1024 (AdamW, int8
gradients; ``train_step_ms``), each after warm-up.  It prints the card's
name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, statistics, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import ssd as SSD
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

def host_ms(fn, warm, n):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)

def inputs(b, s, h, p, g, n):
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    x = (f(b, s, h, p) * 0.4).bfloat16()
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(f(h) * 0.4)
    return (x, dt, A, (f(b, s, g, n) * 0.3).bfloat16(),
            (f(b, s, g, n) * 0.3).bfloat16())

out = {{}}
x, dt, A, Bm, Cm = inputs(4, 1024, 32, 64, 1, 128)
out["k8"] = time_ms(lambda: SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=256))
x, dt, A, Bm, Cm = inputs(8, 1024, 32, 64, 1, 128)
out["k8_keep"] = time_ms(lambda: SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=256,
                                              keep_states=True), reps=3)
states = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=256, keep_states=True)[2]
dy = (torch.randn(x.shape, generator=gen, device=dev)).bfloat16()
out["k8b"] = time_ms(lambda: SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, None, dy,
                                              None, chunk=256,
                                              states=states), reps=3)
del x, dt, A, Bm, Cm, states, dy
torch.cuda.empty_cache()
if {model!r}:
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.pipeline import RequestStream, TokenStream
    from repro_torch.launch import steps as ST
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_arch("mamba2-370m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, 4, 1024, 0).requests_at(0)
                           ["tokens"]).to(dev)
    with torch.no_grad():
        out["prefill_ms"] = host_ms(lambda: DE.prefill(cfg, params, tok), 2,
                                    5)
    opt = adamw.init(params)
    step_fn = ST.make_train_step(cfg, TrainConfig(
        grad_compression="int8", warmup_steps=2, total_steps=10))
    batch = TokenStream(cfg, 8, 1024, 0, device=dev).batch_at(0)
    state = [params, opt]

    def step():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        m["loss"].item()

    out["train_step_ms"] = host_ms(step, 2, 3)
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--no-model", action="store_true")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    for label in ("old", "new", "new", "old") * args.rounds:
        src = str(Path(getattr(args, label)).resolve() / "src")
        code = CHILD.format(src=src, model=not args.no_model)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
