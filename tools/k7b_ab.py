#!/usr/bin/env python3
"""Time K7b (the RG-LRU scan's backward) of two checkouts in turns, on one
card, with the RecurrentGemma-2B train step beside it.

    python3 tools/k7b_ab.py OLD_ROOT NEW_ROOT [--rounds 1] [--no-model]

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old (``--rounds`` times), each in a process of its
own that builds its own kernels (into its own ``build/kernels``).  Each
process times K7b, fed K7's kept fp32 states, with inputs made from a seed
at RecurrentGemma-2B's layer shape (4, 1024, 2560) in bf16 (``k7b``) and
fp32 (``k7b_f32``) and at (4, 4096, 2560) in bf16 (``k7b_4096``), each as
5 calls captured in one CUDA graph and replayed (as ``chip_smoke.py``'s
``time_ms``).  Unless ``--no-model``, it then times the median of 5 bf16
train steps of RecurrentGemma-2B at full width over 12 of its 26 layers
(batch 4 x 1024, after 2 warm-up steps; ``step_ms``), as
``tools/k5b_ab.py`` does.  It prints the card's name and power limit, then
one JSON line per run.  The turns are ``tools/k3_ab.py``'s.
"""
from __future__ import annotations

import sys

from k3_ab import run_in_turns
from k5b_ab import CHILD as K5B_CHILD

# K5b's child with its timed kernel swapped for K7b at the RG-LRU's shapes
KERNELS = K5B_CHILD[K5B_CHILD.index("out = {{}}"):K5B_CHILD.index(
    "torch.cuda.empty_cache()")]
CHILD = K5B_CHILD.replace(KERNELS, """out = {{}}
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
for key, (b, s, w), dtype in (("k7b", (4, 1024, 2560), torch.bfloat16),
                              ("k7b_f32", (4, 1024, 2560), torch.float32),
                              ("k7b_4096", (4, 4096, 2560), torch.bfloat16)):
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    args = ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
            f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)
    _, h32 = rglru_scan(*args, keep_states=True)
    dy = f(b, s, w).to(dtype)
    out[key] = time_ms(lambda: rglru_scan_bwd(*args, h32, dy))
    del args, h32, dy
""")

if __name__ == "__main__":
    sys.exit(run_in_turns(CHILD))
