#!/usr/bin/env python3
"""Time K7 (the RG-LRU scan) of two checkouts in turns, on one card, with
the RecurrentGemma-2B prefill beside it.

    python3 tools/k7_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K7 with inputs made from a seed at RecurrentGemma-2B's
layer shape (4, 1024, 2560) in bf16 (``k7``) and fp32 (``k7_f32``) and at
the ring serve's (4, 4096, 2560) in bf16 (``k7_4096``), each as 10 calls
captured in one CUDA graph and replayed (as ``chip_smoke.py``'s
``time_ms``).  Unless ``--no-model``, it then builds RecurrentGemma-2B at
full width and depth from a seed and times, on the host's clock around
work that ends in a synchronize, the median of 5 prefills at batch 4 x
1024 tokens (``prefill_ms``) after warm-up.  It prints the card's name and
power limit, then one JSON line per run.  The turns and the timer are
``tools/k3_ab.py``'s.
"""
from __future__ import annotations

import sys

from k3_ab import run_in_turns

CHILD = """
import json, statistics, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels.rglru import rglru_scan
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

out = {{}}
for key, (b, s, w), dtype in (("k7", (4, 1024, 2560), torch.bfloat16),
                              ("k7_f32", (4, 1024, 2560), torch.float32),
                              ("k7_4096", (4, 4096, 2560), torch.bfloat16)):
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    args = ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
            f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)
    out[key] = time_ms(lambda: rglru_scan(*args))
    del args
torch.cuda.empty_cache()
if {model!r}:
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import RequestStream
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T
    cfg = get_arch("recurrentgemma-2b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, 4, 1024, 0).requests_at(0)
                           ["tokens"]).to(dev)
    with torch.no_grad():
        for _ in range(2):
            DE.prefill(cfg, params, tok)
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            DE.prefill(cfg, params, tok)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
    out["prefill_ms"] = statistics.median(ts)
print(json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(run_in_turns(CHILD))
