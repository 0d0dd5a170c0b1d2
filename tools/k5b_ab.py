#!/usr/bin/env python3
"""Time K5b (flash attention's backward) of two checkouts in turns, on one
card, with the RecurrentGemma-2B train step beside it.

    python3 tools/k5b_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K5b in bf16, fed K5's output and log-sum-exp, with inputs
made from a seed at ``chip_smoke.py``'s three training shapes (B, H, KV,
Sq, Skv, D): RecurrentGemma-2B's (4, 10, 1, 1024, 1024, 256) causal with
its 2048-token window (``gemma``), its 4096-token shape where the window
bites (``gemma_4096``) and qwen3-8b's (4, 32, 8, 1024, 1024, 128) causal
(``qwen``), each as 5 calls captured in one CUDA graph and replayed (as
``chip_smoke.py``'s ``time_ms``).  Then K5b in fp32 at ``FP32``'s shapes,
each beside the backward alone of F.scaled_dot_product_attention on the
same inputs (TF32 off; EFFICIENT_ATTENTION, the one fused backend that
takes fp32), timed the same way: the yardstick.  Unless ``--no-model``, it then builds
RecurrentGemma-2B at full width over 12 of its 26 layers from a seed and
times, on the host's clock around work that ends in a synchronize, the
median of 5 bf16 train steps at batch 4 x 1024 after 2 warm-up steps
(``step_ms``).  It prints the card's name and power limit, then one JSON
line per run.  The turns are ``tools/k3_ab.py``'s.
"""
from __future__ import annotations

import sys

from k3_ab import run_in_turns

# fp32: name: ((B, H, KV, Sq, Skv, D), causal): 17(f)'s rank, qwen3-8b's
# training shape and Whisper's encoder
FP32 = {"rank_17f": ((2, 16, 4, 256, 256, 128), True),
        "qwen3-8b": ((4, 32, 8, 1024, 1024, 128), True),
        "whisper_encoder": ((4, 16, 16, 1500, 1500, 64), False)}

CHILD = """
import dataclasses, json, statistics, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)

def time_ms(fn, reps=5, stream=None):
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
for key, (B, H, KV, Sq, Skv, D), window in (
        ("gemma", (4, 10, 1, 1024, 1024, 256), 2048),
        ("gemma_4096", (1, 10, 1, 4096, 4096, 256), 2048),
        ("qwen", (4, 32, 8, 1024, 1024, 128), 0)):
    f = lambda *shp: torch.randn(*shp, generator=gen,
                                 device=dev).to(torch.bfloat16)
    q, k, v, do = f(B, H, Sq, D), f(B, KV, Skv, D), f(B, KV, Skv, D), \\
        f(B, H, Sq, D)
    o, lse = flash_attention(q, k, v, causal=True, window=window,
                             return_lse=True)
    out[key] = time_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=True, window=window))
    del q, k, v, do, o, lse
import torch.nn.functional as F
for key, ((B, H, KV, Sq, Skv, D), causal) in {fp32!r}.items():
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    q, k, v, do = f(B, H, Sq, D), f(B, KV, Skv, D), f(B, KV, Skv, D), \
        f(B, H, Sq, D)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    row = {{"ms": time_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal))}}
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = F.scaled_dot_product_attention(*ins, is_causal=causal,
                                           enable_gqa=KV != H)
    torch.cuda.current_stream().wait_stream(side)
    # the backward runs on the forward's stream: captured there
    row["sdpa_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(y, ins, do, retain_graph=True),
        stream=side)
    out[key + " float32"] = row
    del q, k, v, do, o, lse, ins, y
torch.cuda.empty_cache()
if {model!r}:
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b"), num_layers=12)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init(params)
    step = ST.make_train_step(cfg, TrainConfig(total_steps=10,
                                               warmup_steps=2))
    batch = TokenStream(cfg, 4, 1024, 0, device=dev).batch_at(0)
    ts = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = statistics.median(ts[2:])
print(json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(run_in_turns(CHILD, fp32=FP32))
