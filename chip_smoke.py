#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, runs the
DSCS executor for every non-LM workload, and then serves the main path: 8
requests to a full-width ResNet-50 at 224x224 (``asset_damage``), 8 to
the ViT of ``remote_sensing`` at 176x176 and 8 each to ``chatbot`` and
``translation`` (the reduced qwen3-8b on 32 tokens, K5 in its two
layers), with every launch counter set to 0 just before and read just
after.  The fleet slice follows: K6, the fp64
Lindley scan, byte for byte against its plain version (NaN rows and ragged
flat solves among the cases); the sharded fleet engine at the size of
``poisson-1m-f1024`` (10^6 requests, 1024 drives and 1024 CPU nodes, 8
shards), run ``segmented, cuda, cuda, segmented`` with the cuda traces
byte-identical to the numpy ones and K6 launched once for each solve, then
timed over that run's solves beside its byte and chain bounds; and the
Zipf-skewed solve of ``lindley-zipf-1m``, one launch.  The LM
slice last: K8, the Mamba-2 SSD chunk scan, against its plain version at
``tests/test_kernels.py``'s shapes, with h0, and at Mamba-2 370M's layer
shape in bf16 and fp32, with the grid that spreads its chunks over
clusters of blocks; ``serve("mamba2-370m", smoke=False)`` at full width
and depth (48 layers, bf16, batch 4, 1024-token prompts, 32 new tokens)
with K8 launched once per layer; at fp32 the served prefill against one
with K8's plain version swapped in, and decode == forward.  Phase 9, the
RecurrentGemma slice: K7, the RG-LRU scan, against its plain version at
``tests/test_kernels.py``'s shapes, ragged ones, the layer shape (4, 1024,
2560) in fp32 and bf16 and (4, 4096, 2560) in bf16, with the grid that
spreads the time axis over clusters of blocks; K5 at head dim 256; ``serve
("recurrentgemma-2b", smoke=False)`` at full width and depth (26 layers,
bf16, batch 4, 1024-token prompts, 32 new tokens) with K7 launched once per
rglru layer and K5 once per attention layer, profiled, and again with
4096-token prompts past the 2048-token window (the ring cache); at fp32 the
served prefill against one with K7's and K5's plain versions swapped in,
and decode == forward.  Phase 10, the training slice: K3 and K4, int8
quantize and dequantize, byte for byte against their plain versions (one
row of 215,482,368 elements among them, the stacked in_proj's gradient);
K8b, the SSD scan's gradient, against its plain version at
``tests/test_kernels.py``'s shapes in fp32 and at the layer shape in bf16,
and its grid;
the full model's loss and every gradient leaf at fp32 with K8/K8b and with
their plain versions; 10 AdamW steps of Mamba-2 370M at full width and
depth (bf16, batch 8 x 1024 tokens, int8 gradient compression, remat, the
parameters and moments updated in place) with 96 K8 launches (each
layer's forward and its recompute in the backward), 48 K8b and one K3 and
one K4 call per gradient leaf each step (a K3 call is one cooperative
launch; K3 timed over a step's ten leaves too),
profiled; and the launcher's ``train`` with a checkpoint that restores
byte for byte.  Phase 11, the
Qwen decoders: K5 at their serving shapes (head dim 128; GQA 4:1, MHA
20:20, GQA 16:1; 1024 causal tokens) in fp32 and bf16; ``serve`` of
qwen3-8b (36 layers) and qwen1.5-4b (40) at full width and depth and of
qwen3-moe-235b-a22b at full width over 4 of its 94 layers, bf16, batch 4,
1024-token prompts, with K5 launched once per layer and no other kernel,
qwen3-8b profiled and the MoE's routing printed; at fp32, cut in depth,
each served prefill against one with K5's plain version swapped in, and
decode == forward.  Phase 12, training beyond Mamba-2: K5's output and
lse against the plain forward's, then K5b (flash attention's backward)
against its plain version, in fp32 at ``tests/test_kernels.py``'s
attention shapes and in bf16 at the training shapes (elementwise and by
relative Frobenius error, beside two planted faults), timed in CUDA graphs
beside SDPA's backward timed alike; K7 keeping its states against the
plain forward, then K7b (the RG-LRU scan's backward), at phase 9's cases
and the layer shape, each run twice byte for byte;
RecurrentGemma-2B (one period) and qwen3-8b (2 layers) at full width, the
fp32 loss and every gradient leaf with K5/K5b/K7/K7b and with their plain
versions; ``launch.train.train`` of RecurrentGemma-2B at full width and
depth (26 layers, 10 bf16 steps, batch 4 x 1024, remat and the in-place
AdamW, K7 36, K7b 18, K5 16 and K5b 8 launches a step and no other kernel,
profiled) and of qwen3-8b over 4 of 36 (5 steps, K5 8 and K5b 4 a step);
and K1 refusing to cut an autograd graph.  Phase 13, Whisper and the
paper's own LMs: K5 at their head dim 64
shapes (Whisper's 1500-frame non-causal encoder, its cross-attention of
384 decoder rows over 1500 keys, its decoder; GPT-2 1.5B's 25 heads over
992 tokens; BERT-base) in fp32 and bf16, elementwise and by relative
Frobenius error, beside three planted faults; whisper-medium, gpt2-1.5b and
bert-base served at full width and depth in bf16 (batch 4, prompts 384,
992 and 480, 32 new tokens), by ``serve`` and through the step functions
with Whisper's frames drawn as ``TokenStream`` draws them, with 72, 48 and
12 K5 launches a prefill and no plain attention there, Whisper profiled;
at fp32, full depth and the served batch each prefill against one with
K5's plain version, and decode == forward.  Phase 14, MLA and the vision
frontend: K5 at minicpm3-4b's q/k 96 with v 64 and at ViT-632M's head dim
80 in fp32 and bf16, elementwise and within K5_REL beside three planted
faults, timed in CUDA graphs beside each of SDPA's fused backends alone;
minicpm3-4b (MLA) and ViT-632M (the patch frontend) served at full width
and depth and qwen2-vl-72b (M-RoPE, 1024 patch positions + 256 tokens) at
full width over 8 of its 80 layers, bf16, batch 4, with 62, 32 and 8 K5
launches a prefill and no plain attention there, each profiled; at fp32
over 4 layers each prefill against one with K5's plain version, and
decode == forward.  Phase 15, training of MLA, ViT-632M and Whisper: K5b
at the (Dqk, Dv) pairs (96, 64), (80, 80) and (32, 16) in fp32 and at
the training shapes in bf16 (minicpm3-4b's q/k 96 with v 64, the ViT's
80, Whisper's encoder, cross-attention and decoder at 64), elementwise
and within K5B_REL beside two planted faults, timed in CUDA graphs beside
SDPA's backward and each of its fused backends alone; the fp32 loss and
every gradient leaf of minicpm3-4b (2 layers), ViT-632M (4) and
Whisper-medium (2 + 2) at full width with K5/K5b and with their plain
versions; minicpm3-4b, ViT-632M and Whisper-medium trained at full width
and depth through ``launch.train.train`` (bf16, batch 4, 5 steps, remat
and the in-place AdamW; K5 124, 64 and 144 and K5b 62, 32 and 72 launches
a step, no other kernel and no plain attention), each profiled and its
first two losses against a run with the plain versions.  Phase
16, the mesh: qwen3-moe-235b-a22b at full width served over (1, 4) and
(2, 2) meshes of 4 ranks, processes sharing the card through a gloo group
(expert-parallel ``moe_ffn_ep``, and ``moe_ffn_ep_resident`` on (2, 2)):
(a) at fp32 over 2 layers, batch 4 x 1024, each mesh's prefill and 4
decode steps against the one-card gather path on the same weights, no
expert past its capacity; (b) at the config's capacity factor, (1, 4)
and the resident form against the one-card path over the batch, (2, 2)
against it over each data block; (c) ``serve`` in bf16 over 4 layers, the
(1, 4) mesh's first greedy tokens equal to the one-card ``serve``'s and
its prefill logits within MESH_REL, K5 once a layer in every rank's
prefill, with each mesh's times, collectives and memory; (d) qwen3-8b
over (1, 4) ``TP_RULES`` (TP's compute split; the served prefill's K5 on
a rank's heads, no weight resharded in serving, the cache split along
the sequence); (e) minicpm3-4b, Mamba-2 370M, RecurrentGemma-2B (a
4096-token prompt, the ring) and Whisper-medium over the same ranks, the
fp32 prefill logits within TP_REL of one card's and the greedy tokens
equal, each rank's cache its spec blocks' bytes, a decode step
resharding only what TP computes whole.  Phase 17,
training over a mesh: qwen3-moe's gradient over (1, 4) and (2, 2) meshes
against one card's, each rank's weights, reduced gradient and train-step
arguments equal in bytes to the dry run's blocks of it
(``launch.dryrun.cell_blocks``), and Mamba-2 370M trained over two ranks.
Phase 18: (a) phase 6's fleet through the façade,
``core.scheduler.ClusterSim.run_sharded``, ``segmented, cuda, cuda,
segmented``, the cuda runs' traces and books byte-identical to the numpy
one's and K6 launched once a solve, K6's device time over one cuda run
by CUDA events; (b) the dry run (``python -m repro_torch.launch.dryrun``) of
qwen3-moe-235b-a22b's ``train_4k`` and qwen3-8b's ``prefill_32k`` on the
single-pod mesh, each a subprocess with the card hidden, started before
phase 16 and waited for after (a): exit 0, status ok, no kernel launched or
built, CUDA never initialised, its roofline line printed; (c) phase 17's
train-step argument bytes of each rank against the dry run's.  Last,
K1 (3xTF32
``wgmma``) at each distinct shape of a ResNet-50 request, with w in the
layout the request hands over, beside ``torch.matmul``, its tile plan and
both bounds (3xTF32 and the fp32 FMA pipes).  Any failed
check raises, so the exit code is non-zero.  fp32 products and
convolutions run without TF32 throughout (``allow_tf32 = False`` for both
cuBLAS and cuDNN), so the plain versions are true fp32 references.

Output: one line per check and timing, the card's name and power limit
from ``nvidia-smi``, a ``{"kernels": [...]}`` JSON line, and as the last
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import cProfile
import gc
import json
import math
import pstats
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# The kernels' work and least times at an H100 SXM's peaks (NVIDIA data
# sheet, dense, at a 700 W power limit): one count with the dry run's.
from repro_torch.analysis.roofline import (  # noqa: E402
    k1_bounds, k2_bound, k3_bound, k4_bound, k5_bounds, k5b_bounds,
    k6_bound, k7_bound, k7b_bound, k8_bound, k8b_bound)

REQUESTS = 8
RESNET_LAUNCHES = 53                    # convolutions per ResNet-50 request
# The fleet at the size of benchmarks/bench_engine.py's poisson-1m-f1024:
# 1024 DSCS drives and 1024 CPU nodes, Poisson arrivals at utilisation 0.95,
# 10^6 requests, hedge budget 0.08 s, 8 shards; and its lindley-zipf-1m
# solver cell: 10^6 requests over 128 servers, Zipf(1.2) popularity.
FLEET = {"n_dscs": 1024, "n_cpu": 1024, "utilization": 0.95,
         "requests": 1_000_000, "hedge_budget_s": 0.08, "n_shards": 8}
ZIPF = {"requests": 1_000_000, "n_servers": 128, "zipf_s": 1.2}
# Mamba-2 370M at full width and depth (src/repro_torch/configs/
# mamba2_370m.py), served at batch 4 with 1024-token prompts and 32
# generated tokens; K8's layer shape (B, S, H, P, G, N) on that path.
MAMBA = "mamba2-370m"
SERVE = {"batch": 4, "prompt": 1024, "gen": 32}
MAMBA_CHUNK = 256
K8_LAYER = (4, 1024, 32, 64, 1, 128)
# RecurrentGemma-2B at full width and depth (src/repro_torch/configs/
# recurrentgemma_2b.py), served at batch 4 with 1024-token prompts and 32
# new tokens, and with 4096-token prompts (past the 2048-token window: the
# ring cache) and 16; K7's layer shape (B, S, W) and K5's shapes (B, H, KV,
# Sq, Skv, D) on that path, causal with the model's window.
GEMMA = "recurrentgemma-2b"
GEMMA_SERVE = {"batch": 4, "prompt": 1024, "gen": 32}
GEMMA_RING = {"batch": 4, "prompt": 4096, "gen": 16}
K7_SHAPES = [(2, 64, 128), (4, 128, 256), (1, 32, 128), (3, 77, 200),
             (2, 1, 256), (2, 31, 201), (2, 255, 200)]
K7_LAYER = (4, 1024, 2560)
K7_RING = (4, 4096, 2560)   # the ring serve's prefill
K7_SFU = 7                  # of them on the SFU: 4 exp2, 2 reciprocals, rsqrt
SFU_PER_CLOCK = 16          # SFU operations an SM a clock (Hopper)
BOOST_HZ = 1.98e9           # H100 SXM boost clock
K5_GEMMA = [(4, 10, 1, 1024, 1024, 256), (1, 10, 1, 4096, 4096, 256)]
GEMMA_WINDOW = 2048
# Mamba-2 370M trained at full width and depth: bf16, batch 8 of 1024
# tokens (chunk 256), int8 gradient compression, 10 steps of a 10-step
# cosine schedule with 2 warm-up steps; the fp32 gradient check at batch 2;
# the launcher's run; K8b's layer shape (B, S, H, P, G, N); K3's largest
# row, the stacked in_proj's gradient (48 x 1024 x 4384) as one row.
TRAIN = {"batch": 8, "seq": 1024, "steps": 10, "warmup": 2}
GRAD_CHECK = {"batch": 2, "seq": 1024}
LAUNCHER = {"steps": 2, "batch": 2, "seq": 1024}
K8B_LAYER = (8, 1024, 32, 64, 1, 128)
K3_ROW = 48 * 1024 * 4384

# The Qwen decoders (src/repro_torch/configs/qwen3_8b.py, qwen15_4b.py,
# qwen3_moe_235b.py): qwen3-8b and qwen1.5-4b served at full width and
# depth, qwen3-moe-235b-a22b at full width over MOE_LAYERS of its 94 layers
# (about 11.2 B parameters, 22 GB in bf16: what one card holds with room to
# run), batch 4 of 1024-token prompts; the fp32 checks at depth
# QWEN_CHECK_LAYERS (MOE_CHECK_LAYERS), batch 2 of 256 tokens; K5's shapes
# (B, H, KV, Sq, Skv, D) on those paths, causal with no window.
QWEN_SERVE = {"qwen3-8b": {"batch": 4, "prompt": 1024, "gen": 32},
              "qwen1.5-4b": {"batch": 4, "prompt": 1024, "gen": 8},
              "qwen3-moe-235b-a22b": {"batch": 4, "prompt": 1024, "gen": 16}}
MOE_LAYERS = 4
QWEN_CHECK = {"batch": 2, "prompt": 256}
QWEN_CHECK_LAYERS = 4
MOE_CHECK_LAYERS = 2
K5_QWEN = [(4, 32, 8, 1024, 1024, 128), (4, 20, 20, 1024, 1024, 128),
           (4, 64, 4, 1024, 1024, 128)]
# K5 at the shapes of a rank along ``model`` under TP's compute split
# (phase 16's forwards): qwen3-8b's 32 heads and 8 kv heads over 4 ranks,
# qwen3-moe's 64 and 4 over 4 and over 2, each at a batch of 4 (a (2, 2)
# rank's data block is 2 prompts: the same heads at half the work).
K5_TP = [(4, 8, 2, 1024, 1024, 128), (4, 16, 1, 1024, 1024, 128),
         (4, 32, 2, 1024, 1024, 128)]
# K5 at the other shapes a rank's served prefill launches in phase 16,
# (shape, causal), bf16, each also in CUDA graph windows beside SDPA's
# fused backends: (e)'s over (1, 4) TP_RULES, minicpm3-4b's 10 heads and
# Whisper's 4 (encoder 1500², decoder 384², cross-attention 384 x 1500),
# and (f)'s over (2, 2) DECODE_RULES, the whole batch of 4 on the rank's
# heads, qwen3-8b's 16 (KV 4) and minicpm3-4b's 20.
K5_RANKS = [((4, 10, 10, 1024, 1024, 96, 64), True),
            ((4, 4, 4, 1500, 1500, 64), False),
            ((4, 4, 4, 384, 384, 64), True),
            ((4, 4, 4, 384, 1500, 64), False),
            ((4, 16, 4, 1024, 1024, 128), True),
            ((4, 20, 20, 1024, 1024, 96, 64), True)]
# K5 at two more shapes the mesh phases launch, (shape, causal, window,
# dtype), timed the same way: RecurrentGemma-2B's 4096-token prompt at
# batch 4 in phase 16(e) (window 2048), and a (2, 2) SEQPAR_RULES rank of
# qwen3-8b's gradient in phase 17(e) (1 of the 2 sequences, 16 heads, KV
# 4, 256 tokens; fp32, as that gradient runs), and a (2, 2) DECODE_RULES
# rank of the same gradient in 17(f) (both sequences, 16 heads, KV 4; K5b
# timed there too, in fp32)
K5_LATE = [((4, 10, 1, 4096, 4096, 256), True, GEMMA_WINDOW, "bfloat16"),
           ((1, 16, 4, 256, 256, 128), True, 0, "float32"),
           ((2, 16, 4, 256, 256, 128), True, 0, "float32")]
# K5b in fp32, timed beside SDPA's fp32 backward: qwen3-8b's training
# shape and Whisper-medium's encoder; name: (shape, causal)
K5B_FP32_TIMED = {"qwen3-8b": ((4, 32, 8, 1024, 1024, 128), True),
                  "whisper_encoder": ((4, 16, 16, 1500, 1500, 64), False)}
# K5 and K5b with the queries shifted and the keys cut to a valid prefix
# (the JAX package's _attn_block positions): a chunk of 256 query rows of
# qwen3-8b's heads at positions 768-1023 against a cache of 1024 rows, 900
# of them valid, bf16, causal; (shape, q_offset, kv_len)
K5_OFFSET = ((4, 32, 8, 256, 1024, 128), 768, 900)
QWEN_FULL = {   # (layers, d_model, heads, KV, head dim, (expert) d_ff,
                #  experts, top-k, qk-norm, QKV bias, vocab, parameters)
    "qwen3-8b": (36, 4096, 32, 8, 128, 12288, 0, 0, True, False, 151936,
                 8_191_783_936),
    "qwen1.5-4b": (40, 2560, 20, 20, 128, 6912, 0, 0, False, True, 151936,
                   3_951_024_640),
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 128, 1536, 128, 8, True, False,
                            151936, 235_094_683_136),
}

# Phase 13, Whisper and the paper's own LMs (src/repro_torch/configs/
# whisper_medium.py, paper_suite.py): each served at full width and depth in
# bf16, batch 4: whisper-medium with 1500 encoder frames and a 384-token
# prompt + 32 (416 of Whisper's published 448-token text context,
# arXiv:2212.04356), gpt2-1.5b 992 + 32 (its 1024 learned positions),
# bert-base 480 + 32 (its 512); the fp32 checks at full depth on the served
# batch and prompt.  K5's shapes (B, H, KV, Sq, Skv,
# D) and causality on those paths, all at head dim 64, KV = H.
PAPER_SERVE = {"whisper-medium": {"batch": 4, "prompt": 384, "gen": 32},
               "gpt2-1.5b": {"batch": 4, "prompt": 992, "gen": 32},
               "bert-base": {"batch": 4, "prompt": 480, "gen": 32}}
K5_PAPER = {  # name: (shape, causal, the model, launches a prefill)
    "whisper_encoder": ((4, 16, 16, 1500, 1500, 64), False,
                        "whisper-medium", 24),
    "whisper_cross": ((4, 16, 16, 384, 1500, 64), False, "whisper-medium",
                      24),
    "whisper_decoder": ((4, 16, 16, 384, 384, 64), True, "whisper-medium",
                        24),
    "gpt2": ((4, 25, 25, 992, 992, 64), True, "gpt2-1.5b", 48),
    "bert": ((4, 12, 12, 480, 480, 64), True, "bert-base", 12),
}
# K5's output at those shapes within this relative Frobenius error of its
# plain version, beside the elementwise tolerances (the same bar as
# K5B_REL): at std-1 inputs over 1500 keys a row's |o| is about 0.04, so
# the elementwise atol of 0.03 alone would pass a dropped key tile.  Three
# planted faults (o x 0.9; the plain version with a key tile dropped, the
# ragged last one where no mask hides it, the middle one under the causal
# mask; the last query tile zeroed) must read above it.
K5_REL = {"bfloat16": 2e-2, "float32": 1e-4}
# K5 and K5b in fp32 run 3xTF32 on the tensor cores: where the 1xTF32
# stand-in is read (``tf32_standin``), the kernel is held within this
# relative Frobenius error of the plain version, and the stand-in, which
# drops the split's lo terms, must read above K5_REL's fp32 bar.  Beside
# those rows, the times of the CUDA-core fp32 kernels the 3xTF32 ones
# replaced, as this script measured them on an NVIDIA H100 80GB HBM3 at
# 700 W (ms; K5 by (shape, causal), K5b at 17(f)'s rank shape).
K5_TF32_REL = 1e-5
K5_FP32_BEFORE = {
    ((4, 32, 8, 1024, 1024, 128), True): 2.8972,
    ((4, 20, 20, 1024, 1024, 128), True): 1.9955,
    ((4, 64, 4, 1024, 1024, 128), True): 5.7196,
    ((4, 8, 2, 1024, 1024, 128), True): 0.7283,
    ((1, 16, 4, 256, 256, 128), True): 0.0825,
    ((2, 16, 4, 256, 256, 128), True): 0.0923}
K5B_FP32_BEFORE = {((2, 16, 4, 256, 256, 128), True): 0.6351}
# Phase 14, MLA and the vision frontend (src/repro_torch/configs/
# minicpm3_4b.py, qwen2_vl_72b.py, paper_suite.py), each served in bf16 at
# batch 4 with 32 new tokens: minicpm3-4b at full width and depth (62
# layers, 4.07 B parameters, 8.1 GB) on a 1024-token prompt; qwen2-vl-72b at
# full width over VLM_LAYERS of its 80 layers (9.58 B parameters, 19.2 GB in
# bf16 with its untied 152064-token embedding and head: what one card holds
# with room to run; all 80 are 72.8 B, 146 GB) on 1024 patch positions (its
# frontend_seq) + 256 text tokens; ViT-632M at full width and depth (32
# layers) on its 256 patch positions + 256 tokens, within its 1024 learned
# positions.  The patch embeddings: serve's stub zeros, then drawn as
# TokenStream draws them.  The fp32 checks at VLM_CHECK_LAYERS of each,
# batch 2, on the served prompt.  K5's shapes (B, H, KV, Sq, Skv, Dqk, Dv)
# new to this phase, causal: minicpm3's (q/k 96 = nope 64 + rope 32, v 64)
# and the ViT's (head dim 80); qwen2-vl's head dim 128 is phase 11's.
VLM_SERVE = {"minicpm3-4b": {"batch": 4, "prompt": 1024, "gen": 32},
             "qwen2-vl-72b": {"batch": 4, "prompt": 1280, "gen": 32},
             "vit-632m": {"batch": 4, "prompt": 512, "gen": 32}}
VLM_LAYERS = 8
VLM_CHECK = {"layers": 4, "batch": 2}
VLM_FULL = {   # (layers, d_model, heads, KV, q/k head dim, v head dim,
    #           d_ff, vocab, frontend positions, parameters)
    "minicpm3-4b": (62, 2560, 40, 40, 96, 64, 6400, 73448, 0, 4073937408),
    "qwen2-vl-72b": (80, 8192, 64, 8, 128, 0, 29568, 152064, 1024,
                     72773312512),
    "vit-632m": (32, 1280, 16, 16, 80, 0, 5120, 1000, 256, 844514560),
}
K5_VLM = {  # name: (shape, the model, launches a prefill)
    "minicpm3": ((4, 40, 40, 1024, 1024, 96, 64), "minicpm3-4b", 62),
    "vit": ((4, 16, 16, 512, 512, 80, 80), "vit-632m", 32),
}


# Phase 12, training beyond Mamba-2: K5b's shapes (B, H, KV, Sq, Skv, D,
# causal, window) in bf16: RecurrentGemma-2B's training attention, its
# 4096-token shape where the window bites, and qwen3-8b's; in fp32
# tests/test_kernels.py's attention shapes and masks.  RecurrentGemma-2B
# trained at full width and depth (26 layers, 2,894,528,000 parameters:
# about 34.7 GB of parameters, gradients and moments at TRAIN_BYTES a
# parameter before activations) and qwen3-8b over 4 of 36 layers (2.02 B;
# all 36 need about 98 GB, past the card): bf16, fp32 AdamW moments
# updated in place, remat, no gradient compression, batch 4 of 1024
# tokens; the fp32 gradient checks over one period (3 layers) and 2
# layers, batch 2.
K5B_TRAIN = [((4, 10, 1, 1024, 1024, 256), True, GEMMA_WINDOW),
             ((1, 10, 1, 4096, 4096, 256), True, GEMMA_WINDOW),
             ((4, 32, 8, 1024, 1024, 128), True, 0)]
K5B_FP32 = [(2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 128, 32),
            (2, 4, 4, 128, 64, 64)]
K5B_MASKS = [(True, 0), (False, 0), (True, 48)]
# K5b's bar beside the elementwise one: each of dq, dk, dv within this
# relative Frobenius error of the plain version (tests/test_torch_cuda.py
# holds the card tests to the same), the norm floored at an rms of
# K5B_REL_FLOOR where a gradient cancels to ~0 (one key: dQ = dK = 0, fp32
# residues of ~2e-7); a planted fault (dQ x 0.9, one 64-key tile dropped)
# must read above it
K5B_REL = {"bfloat16": 2e-2, "float32": 1e-4}
K5B_REL_FLOOR = 1e-2
GEMMA_TRAIN = {"batch": 4, "seq": 1024, "steps": 10}
QWEN_TRAIN = {"layers": 4, "batch": 4, "seq": 1024, "steps": 5}
GEMMA_GRAD = {"layers": 3, "batch": 2, "seq": 1024}
# What a training step holds a parameter, with AdamW updating the
# parameters and its fp32 moments in place (the JAX train step's
# donation): the bf16 parameter and gradient and the two fp32 moments
TRAIN_BYTES = 2 + 2 + 4 + 4
QWEN_GRAD = {"layers": 2, "batch": 2, "seq": 1024}
# Phase 15, training of MLA, ViT-632M and Whisper-medium.  K5b's shapes
# (B, H, KV, Sq, Skv, Dqk, Dv) and causality in bf16 on those training
# paths: minicpm3-4b's (q/k 96, v 64), ViT-632M's (80), and Whisper's three
# at head dim 64 (the encoder's 1500 frames and cross-attention over them,
# non-causal, with a ragged last key tile; the decoder's 384 tokens,
# causal); in fp32 K5B_FP32's shapes and K5B_MASKS at each new pair.
# minicpm3-4b trained at full width and depth through launch.train.train
# (62 layers, 4,073,937,408 parameters, about 48.9 GB at TRAIN_BYTES a
# parameter before activations); ViT-632M (32 layers, 844,514,560) and
# Whisper-medium (24 + 24, 1,027,954,688) whole, also through
# launch.train.train, fed TokenStream's
# patch embeddings or frames (the port casts both to bf16); bf16, fp32
# AdamW moments, batch 4, 5 steps.  The fp32 gradient checks at full width
# over VLM_GRAD's layers, batch 2.
K5B_PAIRS = [(96, 64), (80, 80), (32, 16)]
K5B_VLM = {  # name: (shape, causal, the model)
    "minicpm3": ((4, 40, 40, 1024, 1024, 96, 64), True, "minicpm3-4b"),
    "vit": ((4, 16, 16, 512, 512, 80, 80), True, "vit-632m"),
    "whisper_encoder": ((4, 16, 16, 1500, 1500, 64, 64), False,
                        "whisper-medium"),
    "whisper_cross": ((4, 16, 16, 384, 1500, 64, 64), False,
                      "whisper-medium"),
    "whisper_decoder": ((4, 16, 16, 384, 384, 64, 64), True,
                        "whisper-medium"),
}
VLM_TRAIN = {"minicpm3-4b": {"batch": 4, "seq": 1024, "steps": 5},
             "vit-632m": {"batch": 4, "seq": 512, "steps": 5},
             "whisper-medium": {"batch": 4, "seq": 384, "steps": 5}}
VLM_GRAD = {"minicpm3-4b": {"num_layers": 2},
            "vit-632m": {"num_layers": 4},
            "whisper-medium": {"num_layers": 2, "encoder_layers": 2}}

def k1_ptxas(log):
    """{(dtype name, BM, BN): (registers, spilled bytes)} of each K1
    instance, from ptxas's -v lines."""
    from repro_torch.kernels import _build
    out = {}
    for row in _build.ptxas_counts(log, "matmul_kernel"):
        m = re.match(r"I(f|13__nv_bfloat16)Li(\d)ELi(\d+)E", row["instance"])
        if m:
            out[("float32" if m[1] == "f" else "bfloat16", 64 * int(m[2]),
                 int(m[3]))] = (row["registers"], row["spilled"])
    return out


def k6_chain_ms(longest, add_ns):
    """K6's chain bound for a solve: its longest queue's steps, each one
    dependent fp64 add of ``add_ns`` (as lindley_add_latency measured)."""
    return longest * add_ns * 1e-6


def flat_solve(lens, seed, nan=None):
    """CPU float64 (seg, t, s) of a flat solve with queues of ``lens``:
    sorted arrivals a queue; ``nan`` ("t" or "s") puts a NaN into the
    longest queue ("2": a second NaN arrival of other bits after it,
    numpy's and x86's)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, dtype=np.int64)
    seg = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    t = np.concatenate([np.sort(rng.uniform(0.0, 1e3, n)) for n in lens]
                       + [np.empty(0)])
    s = rng.uniform(1e-4, 2.0, int(seg[-1]))
    if nan:
        j = int(np.argmax(lens))
        (t if nan != "s" else s)[seg[j] + lens[j] // 3] = np.nan
    if nan == "2":                   # x86's inf - inf, later in the queue
        t[seg[j] + 2 * lens[j] // 3] = np.array(
            [0xfff8000000000000], dtype=np.uint64).view(np.float64)[0]
    return tuple(torch.from_numpy(a) for a in (seg, t, s))


def lindley_inputs(R, W, seed):
    """CPU float64 (t, s): sorted arrivals, rows zero-padded past a random
    length, as the solver's length buckets hand them over."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 1e3, size=(R, W)), axis=1)
    s = rng.uniform(1e-4, 2.0, size=(R, W))
    pad = np.arange(W)[None, :] >= rng.integers(W // 2 + 1, W + 1,
                                                size=R)[:, None]
    t[pad] = 0.0
    s[pad] = 0.0
    return torch.from_numpy(t), torch.from_numpy(s)


def check_k6(dev, time_ms, call_ms):
    """K6 byte for byte against its plain version on a CPU copy of the
    inputs (torch.cumsum on the card re-associates; on the CPU it gives
    numpy's bytes), and its times: (R, W) calls, then flat solves, ragged
    and with NaN rows.  Returns the largest abs error (0; NaN = NaN)."""
    import torch
    from repro_torch.kernels.lindley import (lindley_scan, lindley_scan_plain,
                                             lindley_scan_segments,
                                             lindley_scan_segments_plain)

    def same(got, want, what):
        if got.numpy().tobytes() != want.numpy().tobytes():
            raise AssertionError(
                f"K6 {what}: not byte-equal to the plain version, max abs "
                f"err {(got - want).abs().nan_to_num(float('inf')).max():.3e}")
        return (got - want).nan_to_num(0.0).abs().max().item()

    k6_err = 0.0
    for (R, W) in [(3, 17), (128, 1024), (257, 4096), (1, 1 << 19)]:
        t_cpu, s_cpu = lindley_inputs(R, W, R + W)
        t, s = t_cpu.to(dev), s_cpu.to(dev)
        k6_err = max(k6_err, same(lindley_scan(t, s).cpu(),
                                  lindley_scan_plain(t_cpu, s_cpu),
                                  f"({R}, {W})"))
        ms = time_ms(lambda: lindley_scan(t, s))
        plain = time_ms(lambda: lindley_scan_plain(t, s))
        bnd, by = k6_bound(R * W)
        print(f"K6 lindley_scan R={R} W={W} float64: byte-equal to the plain "
              f"version on a CPU copy (max_abs_err {k6_err:.1e}); ms={ms:.4f} "
              f"(per Python call {call_ms(lambda: lindley_scan(t, s)):.4f}) "
              f"plain_ms(on the card)={plain:.4f} library_ms=none "
              f"bound_ms={bnd:.4f} ({by})")
    ragged = [1000, 3, 257, 0, 1, 513, 1, 0, 2048, 255, 256, 4097]
    for name, lens, nan in [("ragged", ragged, None), ("nan_t", ragged, "t"),
                            ("nan_s", ragged, "s"), ("nan_2", ragged, "2"),
                            ("empty_and_one", [0, 1, 0, 0, 1, 1, 0], None),
                            ("5000 short", [(j * 7919) % 61
                                            for j in range(5000)], None)]:
        seg_c, t_c, s_c = flat_solve(lens, len(name), nan)
        got = lindley_scan_segments(*(a.to(dev) for a in (seg_c, t_c, s_c)))
        k6_err = max(k6_err, same(got.cpu(), lindley_scan_segments_plain(
            seg_c, t_c, s_c), name))
        nans = int(torch.isnan(got).sum())
        if (nans > 0) != (nan is not None):
            raise AssertionError(f"K6 {name}: {nans} NaN starts")
        print(f"K6 lindley_scan_segments {name} ({len(lens)} queues, "
              f"{t_c.numel()} steps, {nans} NaN starts): byte-equal to the "
              f"plain version on a CPU copy")
    return k6_err


def drive_fleet(dev, time_ms, call_ms):
    """The fleet slice's path at real size, on K6; returns K6's entry of
    the kernels line, all but its max_abs_err (check_k6's)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lindley import (add_latency, lindley_scan,
                                             lindley_scan_segments,
                                             lindley_scan_segments_plain)
    from repro_torch.kernels.systolic_matmul import systolic_matmul
    from repro_torch.kernels.vector_engine import fused_affine_act

    # ---- 6. the second path: the sharded fleet on K6 ---------------------
    from repro_torch.core import lindley as L
    from repro_torch.core.arrivals import make_arrivals
    from repro_torch.core.engine import ClusterEngine
    from repro_torch.core.function import standard_pipeline
    from repro_torch.core.latency import LatencyModel
    from repro_torch.core.platforms import PLATFORMS

    pipes = [standard_pipeline(n)
             for n in ("asset_damage", "content_moderation")]
    lm = LatencyModel()
    svc = sum(lm.e2e(PLATFORMS["DSCS-Serverless"], p.workload, q=0.5)
              for p in pipes) / len(pipes)
    rate = FLEET["utilization"] * FLEET["n_dscs"] / svc
    duration = FLEET["requests"] / rate
    all_counters = (systolic_matmul, fused_affine_act, flash_attention,
                    lindley_scan)

    def fleet(backend):
        eng = ClusterEngine(n_dscs=FLEET["n_dscs"], n_cpu=FLEET["n_cpu"],
                            hedge_budget_s=FLEET["hedge_budget_s"], seed=0)
        t0 = time.perf_counter()
        tr = eng.run_sharded(pipes, arrivals=make_arrivals("poisson", rate),
                             duration_s=duration, n_shards=FLEET["n_shards"],
                             processes=1, backend=backend)
        torch.cuda.synchronize()
        return eng, tr, time.perf_counter() - t0

    # every solve's (seg, t, s), recorded in the first (numpy) run: the cuda
    # runs must launch K6 once for each solve with a non-empty input
    solves = []
    real_solve = L.solve_segments

    def record_solve(seg, t, s, start, fin, *, backend):
        if t.size:
            solves.append((seg.copy(), t.copy(), s.copy()))
        return real_solve(seg, t, s, start, fin, backend=backend)

    L.solve_segments = record_solve
    try:
        runs = [fleet("segmented")]
    finally:
        L.solve_segments = real_solve

    fleet_launches = []
    for backend in ("cuda", "cuda", "segmented"):
        if backend == "cuda":
            for c in all_counters:
                c.launches = 0
        runs.append(fleet(backend))
        if backend == "cuda":
            fleet_launches.append([c.launches for c in all_counters])
    want_fleet = [0, 0, 0, len(solves)]
    if any(n != want_fleet for n in fleet_launches) or not solves:
        raise AssertionError(f"fleet launches K1/K2/K5/K6 {fleet_launches}, "
                             f"want {want_fleet} per cuda run")
    base_eng, base_tr, _ = runs[0]
    for (eng, tr, _), backend in zip(runs[1:], ("cuda", "cuda", "segmented")):
        for col in ("arrival", "finish", "winner", "drive", "start",
                    "service", "hedged", "dscs_finish", "cpu_finish"):
            if getattr(tr, col).tobytes() != getattr(base_tr, col).tobytes():
                raise AssertionError(f"fleet {backend}: column {col} differs "
                                     f"from the segmented run")
        if (tr.events != base_tr.events or eng._qstate != base_eng._qstate
                or eng._pstate != base_eng._pstate
                or dict(eng.telemetry.counters)
                != dict(base_eng.telemetry.counters)
                or eng.last_shard_stats["path"] != "partitioned"):
            raise AssertionError(f"fleet {backend}: books differ from the "
                                 f"segmented run")
    lat = base_tr.latency[base_tr.completed]
    if not (np.isfinite(lat).all() and lat.size == base_tr.n
            and base_tr.n > 0.99 * FLEET["requests"]):
        raise AssertionError(f"fleet: {lat.size} of {base_tr.n} requests "
                             f"completed with finite latency")
    walls = [w for _, _, w in runs]
    qs = base_eng.queue_stats()
    print(f"fleet poisson-1m-f1024: {base_tr.n} requests, {FLEET['n_dscs']} "
          f"DSCS + {FLEET['n_cpu']} CPU, rate {rate:.1f}/s, {duration:.3f} s "
          f"simulated, {FLEET['n_shards']} shards, processes=1; host wall s "
          f"segmented {walls[0]:.3f}, cuda {walls[1]:.3f}, cuda "
          f"{walls[2]:.3f}, segmented {walls[3]:.3f}; cuda traces, queue "
          f"and power books and counters byte-identical to segmented; K6 "
          f"launches {fleet_launches[0][3]} per run = its {len(solves)} "
          f"solves with a non-empty input; p50/p99 "
          f"latency {np.percentile(lat, 50):.6f}/{np.percentile(lat, 99):.6f}"
          f" s; hedged {int(base_tr.hedged.sum())}; DSCS max depth "
          f"{qs['dscs']['max_depth']}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, prof_wall = fleet("cuda")
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
    k6_dev = sum(e.self_device_time_total for e in dev_rows
                 if "lindley" in e.key) / 1e3
    h2d = sum(e.self_device_time_total for e in dev_rows
              if "HtoD" in e.key) / 1e3
    d2h = sum(e.self_device_time_total for e in dev_rows
              if "DtoH" in e.key) / 1e3
    host_ops = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
    host_top = "; ".join(
        f"{e.key[:28]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms"
        for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:6])
    print(f"profile fleet cuda run (profiler on, host wall "
          f"{prof_wall * 1e3:.3f} ms): device busy {busy_ms:.3f} ms (busy "
          f"share {busy_ms / (prof_wall * 1e3):.5f}); K6 {k6_dev:.3f} ms, "
          f"copies H2D {h2d:.3f} ms, D2H {d2h:.3f} ms; host self time of "
          f"torch ops: {host_top}")

    # where a run's host time goes, by function of the engine (cProfile)
    for backend in ("segmented", "cuda"):
        prof_host = cProfile.Profile()
        prof_host.enable()
        _, _, wall = fleet(backend)
        prof_host.disable()
        stats = pstats.Stats(prof_host).stats
        cum = {}
        for (path, _, fn), (_, _, _, cumtime, _) in stats.items():
            if "repro_torch" in path:
                key = f"{Path(path).stem}.{fn}"
                cum[key] = max(cum.get(key, 0.0), cumtime)
        top = "; ".join(f"{k} {v * 1e3:.1f} ms" for k, v in sorted(
            cum.items(), key=lambda kv: -kv[1])[:12])
        print(f"host profile fleet {backend} run (cProfile on, wall "
              f"{wall * 1e3:.1f} ms), cumulative ms by function: {top}")

    # K6 over the fleet run's solves, at their own inputs
    add = add_latency(dev)
    k6 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "chain_bound_ms": 0.0}
    steps = longest = 0
    for seg_np, t_np, s_np in solves:
        cols = [torch.from_numpy(a) for a in (seg_np, t_np, s_np)]
        seg, t, s = (a.to(dev) for a in cols)
        if lindley_scan_segments(seg, t, s).cpu().numpy().tobytes() != \
                lindley_scan_segments_plain(*cols).numpy().tobytes():
            raise AssertionError("K6 on a fleet solve: not byte-equal")
        lens = np.diff(seg_np)
        k6["ms"] += time_ms(lambda: lindley_scan_segments(seg, t, s))
        k6["plain_ms"] += call_ms(
            lambda: lindley_scan_segments_plain(seg, t, s), reps=3)
        k6["bound_ms"] += k6_bound(t_np.size, lens.size)[0]
        k6["chain_bound_ms"] += k6_chain_ms(int(lens.max()), add["ns"])
        steps += t_np.size
        longest = max(longest, int(lens.max()))
    print(f"K6 over the {len(solves)} solves of one fleet run ({steps} "
          f"steps, {solves[0][0].size - 1} queues a solve, longest "
          f"{longest}): ms={k6['ms']:.4f} plain_ms(per Python call, "
          f"bucketed on the card)={k6['plain_ms']:.4f} bound_ms="
          f"{k6['bound_ms']:.4f} (bytes) chain_bound_ms="
          f"{k6['chain_bound_ms']:.4f} (the longest queue a solve x one "
          f"dependent fp64 add, {add['clocks']:.3f} clocks = {add['ns']:.4f} "
          f"ns) library_ms=none; byte-equal to the plain version")

    # ---- 7. the Zipf-skewed solve (lindley-zipf-1m), one launch ----------
    rng = np.random.default_rng(0)
    ranks = np.arange(1, ZIPF["n_servers"] + 1, dtype=np.float64)
    p = ranks ** -ZIPF["zipf_s"]
    p /= p.sum()
    n = ZIPF["requests"]
    keys = np.sort(rng.choice(ZIPF["n_servers"], size=n, p=p))
    zt = np.sort(rng.uniform(0.0, n / 1e4, size=n))
    zs = rng.uniform(1e-4, 2e-3, size=n)
    seg = L.segment_fenceposts(keys, 0, ZIPF["n_servers"])
    zipf_out, zipf_s = {}, {"segmented": [], "cuda": []}
    for backend in ("segmented", "cuda", "cuda", "segmented"):
        start, fin = np.empty(n), np.empty(n)
        before = lindley_scan.launches
        t0 = time.perf_counter()
        L.solve_segments(seg, zt, zs, start, fin, backend=backend)
        zipf_s[backend].append(time.perf_counter() - t0)
        if lindley_scan.launches - before != (backend == "cuda"):
            raise AssertionError(f"zipf {backend}: K6 launched "
                                 f"{lindley_scan.launches - before} times")
        zipf_out.setdefault(backend, (start.tobytes(), fin.tobytes()))
        if (start.tobytes(), fin.tobytes()) != zipf_out[backend]:
            raise AssertionError(f"zipf {backend}: reruns differ")
    if zipf_out["cuda"] != zipf_out["segmented"]:
        raise AssertionError("zipf: cuda starts not byte-equal to segmented")
    zseg, zt_d, zs_d = (torch.from_numpy(a).to(dev) for a in (seg, zt, zs))
    lens = np.diff(seg)
    zipf_ms = time_ms(lambda: lindley_scan_segments(zseg, zt_d, zs_d), reps=3)
    zipf_plain = call_ms(lambda: lindley_scan_segments_plain(zseg, zt_d, zs_d),
                         reps=3)
    print(f"zipf lindley-zipf-1m: {n} requests over {ZIPF['n_servers']} "
          f"servers, longest queue {int(lens.max())} (next "
          f"{int(np.sort(lens)[-2])}); cuda byte-equal to segmented, one K6 "
          f"launch a solve; K6 ms={zipf_ms:.4f} plain_ms(per Python call)="
          f"{zipf_plain:.4f} bound_ms={k6_bound(n, lens.size)[0]:.4f} (bytes) "
          f"chain_bound_ms={k6_chain_ms(int(lens.max()), add['ns']):.4f}; "
          f"solve s segmented {[round(x, 4) for x in zipf_s['segmented']]}, "
          f"cuda {[round(x, 4) for x in zipf_s['cuda']]}")
    return {"name": "lindley_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lindley.cu",
            "replaces": "src/repro/kernels/lindley.py:66",
            "launches": fleet_launches[0][3], "ms": k6["ms"],
            "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "chain_bound_ms": k6["chain_bound_ms"], "zipf_ms": zipf_ms}


def ssd_inputs(shape, dtype, dev, seed):
    """tests/test_kernels.py::test_ssd_kernel's distributions on the card."""
    import torch
    b, s, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    x = (f(b, s, h, p) * 0.4).to(dtype)
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(f(h) * 0.4)
    return x, dt, A, (f(b, s, g, n) * 0.3).to(dtype), \
        (f(b, s, g, n) * 0.3).to(dtype)


def check_k8(dev, time_ms, call_ms, max_err):
    """K8 against its plain version at tests/test_kernels.py's shapes, one
    with h0, and Mamba-2 370M's layer shape in bf16 and fp32; the layer
    shape's times by dtype.  Returns (largest abs err, {dtype: times})."""
    import torch
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    cases = [((2, 128, 4, 32, 2, 16), 32, torch.float32, False),
             ((1, 256, 2, 16, 1, 8), 64, torch.float32, False),
             ((2, 64, 4, 16, 4, 16), 64, torch.float32, False),
             ((2, 128, 4, 32, 2, 16), 32, torch.float32, True),
             (K8_LAYER, MAMBA_CHUNK, torch.bfloat16, False),
             (K8_LAYER, MAMBA_CHUNK, torch.float32, False)]
    worst, times = 0.0, {}
    for i, (shape, chunk, dtype, with_h0) in enumerate(cases):
        x, dt, A, Bm, Cm = ssd_inputs(shape, dtype, dev, seed=i)
        b, s, h, p, g, n = shape
        h0 = (torch.randn(b, h, p, n, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(99))
              if with_h0 else None)
        y, hf = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        yp, hp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        bf = dtype == torch.bfloat16
        # fp32: tests/test_kernels.py's rtol 1e-3 with a tighter atol; bf16
        # y: one bf16 rounding (2^-8 relative) apart; the state is fp32
        rtol, atol = (1e-2, 1e-2) if bf else (1e-3, 1e-4)
        what = f"K8 {shape} chunk={chunk} {dtype} h0={with_h0}"
        err = max(max_err(y, yp, rtol, atol, what + " y"),
                  max_err(hf, hp, 1e-3, 1e-4, what + " state"))
        worst = max(worst, err)
        line = (f"K8 ssd_scan B,S,H,P,G,N={shape} chunk={chunk} {dtype} "
                f"h0={with_h0}: max_abs_err={err:.3e} (y rtol={rtol} "
                f"atol={atol}; state rtol=1e-3 atol=1e-4)")
        if shape == K8_LAYER:
            ms = time_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
            plain = time_ms(lambda: ssd_scan_plain(x, dt, A, Bm, Cm,
                                                   chunk=chunk), reps=3)
            bnd, by = k8_bound(*shape, dtype)
            times[dtype] = {"err": err, "ms": ms, "plain_ms": plain,
                            "bound_ms": bnd, "bound_by": by}
            line += (f"; ms={ms:.4f} (per Python call "
                     f"{call_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)):.4f}) "
                     f"plain_ms={plain:.4f} library_ms=none bound_ms={bnd:.4f} "
                     f"({by})")
        print(line)
    print_ssd_launch("K8", K8_LAYER, backward=False)
    return worst, times


def print_ssd_launch(name, shape, backward):
    """The grid K8 (K8b) launches at a layer shape, as the library
    computes it: the chunks of one (batch row, head) spread over a
    cluster of blocks."""
    import torch
    from repro_torch.kernels.ssd import launch_shape
    for dtype in (torch.bfloat16, torch.float32):
        ls = launch_shape(*shape, dtype, backward=backward)
        heads = (f", {ls['heads_per_block']} heads a block" if backward
                 else "")
        print(f"{name} launch B,S,H,P,G,N={shape} {dtype}: grid "
              f"{ls['grid']}, {ls['blocks']} blocks in clusters of "
              f"{ls['cluster']} along y (the 64-row chunks of one batch row "
              f"and head spread over a cluster{heads}), "
              f"{ls['smem_bytes']} bytes of shared memory a block")


def profile_run(what, run, steps, kernels, unit, card=None):
    """Run ``run`` ``steps`` times under the profiler and print the device
    busy time, idle share, launches a ``unit`` and device ms by kind
    (``kernels`` names the port's, by substrings of their kernel names, in
    the order to match them; then GEMMs, copies and PyTorch's other
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if busy == 0:
        print(f"profile {what}): device time not measured (the profiler saw "
              f"none)")
        return
    top = "; ".join(
        f"{e.key[:40]} x{e.count // steps} "
        f"{e.self_device_time_total / 1e3 / steps:.3f} ms"
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8])
    kinds = {**kernels, "copies": ("Memcpy", "Memset"),
             "GEMMs": ("nvjet", "gemm", "cutlass", "xmma")}
    by_kind = dict.fromkeys([*kinds, "other PyTorch kernels"], 0.0)
    for e in rows:
        kind = next((k for k, names in kinds.items()
                     if any(n in e.key for n in names)),
                    "other PyTorch kernels")
        by_kind[kind] += e.self_device_time_total / 1e3 / steps
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in by_kind.items()) + \
        "; by kernel: " + top
    # cudaLaunchKernelExC: the cluster (K1, K7, K8) and cooperative (K3)
    # launches; cudaLaunchKernel: the rest
    launches_ = sum(e.count for e in prof.key_averages()
                    if e.key.startswith(("cudaLaunchKernel",
                                         "cudaLaunchCooperativeKernel"))
                    ) // steps
    print(f"profile {what}, profiler on, host wall {wall:.3f} ms a {unit}): "
          f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); "
          f"kernel launches x{launches_}; kernels by device time: {top}"
          + (f"; card {card}" if card else ""))


def profile_serving(cfg, params, tok, cache, nxt, kernels, card=None):
    """Profile one prefill of ``tok`` and four decode steps of ``nxt`` on
    ``cache`` (``profile_run``'s line for each)."""
    from repro_torch.models import decode as DE
    B, S = tok.shape
    profile_run(f"prefill (B={B}, S={S}", lambda: DE.prefill(cfg, params, tok),
                1, kernels, "call", card)
    profile_run(f"decode (B={B}, S={S}",
                lambda: DE.decode_step(cfg, params, cache, nxt), 4, kernels,
                "step", card)


def drive_lm(dev, counters):
    """The LM slice's path at full width and depth: ``serve`` of Mamba-2
    370M in bf16, K8 launched once per layer; then, at fp32, the served
    prefill against one with K8's plain version in its place, and decode ==
    forward.  Returns K8's launches in the counted ``serve`` call."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    cfg = mamba_config()
    pbytes = sum(t.numel() * t.element_size()
                 for t in T.tree_leaves(T.param_shapes(cfg)))
    B, S, G_ = SERVE["batch"], SERVE["prompt"], SERVE["gen"]

    # ---- 8. the third path: Mamba-2 370M serving on K8 -------------------
    serve(MAMBA, smoke=False, batch=B, prompt=256, gen=2)     # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = serve(MAMBA, smoke=False, batch=B, prompt=S, gen=G_)
    launches = [c.launches for c in counters]
    gen_tok = out["generated"]
    want = [0] * (len(counters) - 1) + [cfg.num_layers]
    if launches != want:
        raise AssertionError(f"serve launches K1/K2/K5/K6/K8 {launches}, "
                             f"want {want}")
    if not (gen_tok.shape == (B, G_) and gen_tok.dtype == np.int32
            and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
        raise AssertionError(f"serve generated {gen_tok.shape} "
                             f"{gen_tok.dtype}, range {gen_tok.min()}.."
                             f"{gen_tok.max()}")
    print(f"serve {MAMBA} (48 layers, d_model 1024, din 2048, 32 heads x 64,"
          f" N 128, chunk 256, vocab 50280 padded to 50432, bf16, "
          f"{T.count_params(cfg)} parameters, {pbytes} bytes): batch {B}, "
          f"prompt {S}, gen {G_}: prefill_ms={out['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_token={out['decode_s_per_token'] * 1e3:.3f}; K8 "
          f"launches {launches[-1]} (one per layer), K1/K2/K5/K6 none; "
          f"generated {gen_tok.shape} int32, first row "
          f"{gen_tok[0, :8].tolist()}")

    # where a prefill's and a decode step's time goes (profiler on)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    _, cache = DE.prefill(cfg, params, tok)
    nxt = tok[:, -1:]
    DE.decode_step(cfg, params, cache, nxt)
    torch.cuda.synchronize()
    profile_serving(cfg, params, tok, cache, nxt,
                    {"K8": ("ssd_kernel",)})
    del params, cache

    # fp32, TF32 off: the served prefill against K8's plain version
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    real = ops.ssd_scan

    def plain_k8(x, dt, A, Bm, Cm, *, chunk, h0):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

    runs = {}
    for name in ("kernel", "plain", "kernel", "plain"):
        before = ssd_scan.launches
        ops.ssd_scan = plain_k8 if name == "plain" else real
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = DE.prefill(cfg32, params32, tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.ssd_scan = real
        n = ssd_scan.launches - before
        if n != (cfg.num_layers if name == "kernel" else 0):
            raise AssertionError(f"fp32 prefill ({name}): {n} K8 launches")
        runs.setdefault(name, (logits[:, -1].float(), []))[1].append(ms)
    (lk, ms_k), (lp, ms_p) = runs["kernel"], runs["plain"]
    real_cols = slice(0, cfg.vocab_size)
    rel = ((lk[:, real_cols] - lp[:, real_cols]).norm()
           / lp[:, real_cols].norm()).item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    if not (torch.isfinite(lk[:, real_cols]).all() and rel <= 1e-3 and same):
        raise AssertionError(f"fp32 prefill: K8 vs plain rel err {rel:.3e} "
                             f"(limit 1e-3), same argmax {same}")
    print(f"fp32 prefill (TF32 off, B={B}, S={S}): last-position logits, K8 "
          f"vs its plain version: rel Frobenius err {rel:.3e} (limit 1e-3), "
          f"same argmax in all {B} rows; host ms kernel "
          f"{[round(t, 3) for t in ms_k]}, plain {[round(t, 3) for t in ms_p]}")

    # decode == forward at full width (tests/test_models.py:80's tolerance)
    tok256 = tok[:, :256]
    full = T.forward(cfg32, params32, tok256)
    _, cache = DE.prefill(cfg32, params32, tok256[:, :255])
    dl, cache = DE.decode_step(cfg32, params32, cache, tok256[:, 255:])
    got, want_ = dl[:, 0, real_cols], full[:, 255, real_cols]
    err = (got - want_).abs()
    share = (err / (2e-3 + 2e-2 * want_.abs())).max().item()
    if not (int(cache["pos"]) == 256 and torch.isfinite(got).all()
            and share <= 1.0):
        raise AssertionError(f"decode != forward: max abs err "
                             f"{err.max().item():.3e}")
    print(f"decode == forward (fp32, B={B}): prefill 255 tokens + one "
          f"decode_step vs forward on 256: max abs err "
          f"{err.max().item():.3e}, at most {share:.2e} of the limit "
          f"(rtol 2e-2 atol 2e-3)")
    return launches[-1]


def attn_pairs(Sq, Skv, causal, window, q_offset=0, kv_len=None):
    """The (Sq, Skv) mask of the query-key pairs attention computes, query
    row i at position i + ``q_offset``, the keys below ``kv_len`` (an int;
    None: every key)."""
    import torch
    qp = torch.arange(Sq)[:, None] + q_offset
    kp = torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= (qp - kp) < window
    if kv_len is not None:
        keep &= kp < kv_len
    return keep


def k5_tiles(B, H, Sq, Skv, D, causal, window, dtype, sms, q_offset=0,
             kv_len=None):
    """(KV tiles K5 walks, KV tiles there are) for one (batch, head), by
    the kernel's rule (csrc/flash_attention.cu, ``tile_range``), query row
    i at position i + ``q_offset`` and the keys below ``kv_len`` valid: a
    query tile of bq rows walks from the key tile holding its first
    position - window + 1 to the one ending at its last position + 1 (up
    to the valid keys), or every tile where it holds a row that sees no
    key.  bf16 takes 128-query, 64-key tiles; fp32 the block of
    ``launch_f32`` on a card of ``sms`` SMs (16 query rows a warp: eight
    warps at head dim 128 where those fill the SMs, else four where they
    do, else two) and ``TfFwd::BK``'s keys."""
    import torch
    if dtype == torch.bfloat16:
        bq, bk = 128, 64
    else:
        nw = (8 if D == 128 and B * H * -(-Sq // 128) >= sms
              else 4 if B * H * -(-Sq // 64) >= sms else 2)
        bq = 16 * nw
        bk = (32 if D <= 64 else 16 if D < 128
              else (16 if nw == 8 else 32) if D == 128
              else (8 if nw == 4 else 16))
    kvl = Skv if kv_len is None else max(0, min(kv_len, Skv))
    n_kv = -(-Skv // bk)
    walked = 0
    for q0 in range(0, Sq, bq):
        q_last = min(q0 + bq, Sq) - 1 + q_offset
        full = kvl <= 0 or (bool(window) and q_last >= kvl + window - 1)
        lo = max(0, q0 + q_offset - window + 1) if window and not full else 0
        hi = Skv if full else (min(kvl, q_last + 1) if causal else kvl)
        walked += -(-hi // bk) - lo // bk
    return walked, -(-Sq // bq) * n_kv


def check_k5_case(shape, causal, window, dtype, randn, time_ms, call_ms,
                  max_err, card=None, planted=False, backends=False,
                  q_offset=0, kv_len=None, standin=False):
    """K5 at one shape (B, H, KV, Sq, Skv, D), or (..., D, Dv) with v's
    own head dim, against its plain version, and its times beside
    F.scaled_dot_product_attention's and its bound.  Where the window masks
    nothing, SDPA is timed both with the mask and with ``is_causal=True``,
    and the faster is ``library_ms``.  With ``planted``, the output is also
    held to K5_REL's relative Frobenius bar, and in bf16 the planted faults
    of ``k5_planted`` must read above it.  With ``backends``, K5 and each
    of SDPA's fused backends alone (``sdpa_backends``) are also timed in
    CUDA graphs, among the forms ``library_ms`` takes the fastest of.
    Where a window masks, SDPA's masked form stands in for the backends
    (``is_causal`` computes another function).  ``q_offset`` and
    ``kv_len`` (an int, handed to K5 as a 0-d tensor on the card, which
    the kernel reads there) place the queries and bound the keys; SDPA
    then takes the boolean mask of those positions.  In fp32 the bound is
    the 3xTF32 route's, with the FMA pipes' beside it (``bound_fma_ms``);
    with ``standin`` (fp32) the output is held within K5_TF32_REL of the
    plain version and the 1xTF32 stand-in must read above K5_REL.
    Returns a dict of the kernels line's keys
    (``library`` holds each SDPA form; ``rel_frobenius`` and ``planted``
    their readings)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, H, KV, Sq, Skv, D, *rest = shape
    Dv = rest[0] if rest else D
    q = randn(B, H, Sq, D, dtype=dtype)
    k, v = randn(B, KV, Skv, D, dtype=dtype), randn(B, KV, Skv, Dv,
                                                    dtype=dtype)
    rtol, atol = (0.05, 0.03) if dtype == torch.bfloat16 else (1e-3, 2e-4)
    shifted = bool(q_offset) or kv_len is not None
    pos = {"q_offset": q_offset, "kv_len": None if kv_len is None else
           torch.tensor(kv_len, device=q.device)}
    got = flash_attention(q, k, v, causal=causal, window=window, **pos)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 **pos)
    tag = f"K5 {tuple(shape)} {dtype}" + (
        f" q_offset {q_offset} kv_len {kv_len}" if shifted else "")
    err = max_err(got, want, rtol, atol, tag)
    checked = {}
    if planted:
        limit = K5_REL[str(dtype).split(".")[1]]
        rel = rel_frobenius(got, want)
        if rel > limit:
            raise AssertionError(f"{tag}: relative Frobenius error "
                                 f"{rel:.3e}, limit {limit}")
        checked = {"rel_frobenius": rel, "rel_limit": limit}
        if dtype == torch.bfloat16:
            faults = k5_planted(q, k, v, causal, window, got, want)
            if min(faults.values()) <= limit:
                raise AssertionError(f"{tag}: a planted fault reads within "
                                     f"the bar: {faults}, limit {limit}")
            checked["planted"] = faults
    if standin:
        checked.update(tf32_readings(
            tag, {"o": (got, want, tf32_standin(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len))}))
    del got, want
    torch.cuda.empty_cache()
    keep = attn_pairs(Sq, Skv, causal, window, q_offset, kv_len)
    mask = keep.to(q.device) if (causal or window or shifted) else None
    run = lambda: flash_attention(q, k, v, causal=causal,  # noqa: E731
                                  window=window, **pos)
    ms = time_ms(run)
    plain = time_ms(lambda: flash_attention_plain(
        q, k, v, causal=causal, window=window, **pos))
    libs = {"sdpa_mask": time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=KV != H))}
    if causal and (not window or Sq <= window) and not shifted:
        # the window masks nothing
        libs["sdpa_is_causal"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=KV != H))
    (bnd, by), fma = k5_bounds(B, H, KV, Sq, Skv, D, causal, window, dtype,
                               Dv, q_offset, kv_len)
    if fma is not None:
        checked["bound_fma_ms"] = fma[0]
    before = K5_FP32_BEFORE.get((tuple(shape), causal)) \
        if dtype == torch.float32 and not shifted else None
    walked, tiles = k5_tiles(
        B, H, Sq, Skv, D, causal, window, dtype,
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        q_offset, kv_len)
    graphs = ""
    if backends:
        wins = graph_windows_ms(run)
        if "sdpa_is_causal" in libs or not (causal or window or shifted):
            sdpa = sdpa_backends(q, k, v, causal)
        else:
            # is_causal is not K5's function where the window masks: SDPA
            # with the mask, in the same windows
            sdpa = {"masked": graph_windows_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=KV != H))}
        ran = {n: statistics.median(w) for n, w in sdpa.items()
               if not isinstance(w, str)}
        checked.update(ms_graph=statistics.median(wins),
                       ms_spread=[min(wins), max(wins)],
                       sdpa_backends={n: (statistics.median(w)
                                          if n in ran else w)
                                      for n, w in sdpa.items()})
        libs.update({f"sdpa {n} alone": t for n, t in ran.items()})
        graphs = (f"; in CUDA graphs (median of 5 windows) K5 "
                  f"{checked['ms_graph']:.4f} ({min(wins):.4f}-"
                  f"{max(wins):.4f}), SDPA by backend: " + "; ".join(
                      f"{n} {ran[n]:.4f}" if n in ran else f"{n} {w}"
                      for n, w in sdpa.items()))
    print(f"K5 flash_attention B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} "
          f"D={D}{f' Dv={Dv}' if Dv != D else ''} causal={causal} "
          f"window={window}"
          + (f" q_offset={q_offset} kv_len={kv_len} (a 0-d tensor on the "
             f"card, read by the kernel; pairs kept "
             f"{int(keep.sum())} of {Sq * Skv})" if shifted else "")
          + f" {dtype}: "
          f"max_abs_err={err:.3e} rtol={rtol} atol={atol}; "
          f"ms={ms:.4f} (per Python call {call_ms(run):.4f}) "
          f"plain_ms={plain:.4f} library_ms "
          + " ".join(f"({name}) {t:.4f}" for name, t in libs.items())
          + f" bound_ms={bnd:.4f} ({by})"
          + (f" (3xTF32 on the tensor cores) bound_fma_ms={fma[0]:.4f} "
             f"({fma[1]})" if fma else "")
          + (f"; the CUDA-core kernel it replaced {before:.4f}" if before
             else "")
          + f"; KV tiles walked {walked} of {tiles} a (batch, head)"
          + (f"; relative Frobenius err {checked['rel_frobenius']:.3e} "
             f"(limit {checked['rel_limit']})" if "rel_limit" in checked
             else "")
          + ("; planted faults read " + ", ".join(
              f"{n} {r:.3e}" for n, r in checked["planted"].items())
             if "planted" in checked else "")
          + (f"; {checked['tf32_line']}" if "tf32_line" in checked else "")
          + graphs + (f"; card {card}" if card else ""))
    checked.pop("tf32_line", None)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by,
            "library_ms": min(libs.values()), "library": libs,
            **checked}


def tf32_standin(q, k, v, do=None, *, causal, window, q_offset=0,
                 kv_len=None, terms=1):
    """K5's output (with ``do``, K5b's dq, dk, dv from it) with every
    product one TF32 product, operands truncated to TF32 and the split's
    lo terms dropped: what a kernel without them would give.  Dense and
    masked as the plain versions, in fp32.  With ``terms`` 0 every product
    is a plain one in the inputs' dtype (in fp64, the exact reference of
    ``tests/test_torch_cuda.py``'s 3xTF32 tests)."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    def mm(a, b):
        if not terms:
            return a @ b

        def hi(t):
            return (t.contiguous().view(torch.int32) & -8192).view(
                torch.float32)
        return hi(a) @ hi(b)
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    kv = None if kv_len is None else int(kv_len)
    keep = FA._mask(Sq, Skv, causal, window, q.device, q_offset, kv)
    scale = 1.0 / math.sqrt(D)
    s = torch.where(keep, mm(q, kk.transpose(-1, -2)) * scale, FA.NEG_INF)
    p = torch.softmax(s, -1)
    o = mm(p, vv)
    if do is None:
        return o
    dead = ~keep.any(-1, keepdim=True)
    dp = mm(do, vv.transpose(-1, -2))
    delta = (do * o).sum(-1, keepdim=True)
    ds = torch.where(keep & ~dead, p * (dp - delta), 0.0) * scale
    dk = mm(ds.transpose(-1, -2), q).reshape(B, KV, G, Skv, D).sum(2)
    dv = mm(p.transpose(-1, -2), do).reshape(B, KV, G, Skv, Dv).sum(2)
    return mm(ds, kk), dk, dv


def tf32_readings(tag, outs):
    """Each output's kernel and 1xTF32 stand-in readings against the plain
    version, ``outs`` {name: (kernel's, plain's, stand-in's)}: the kernel
    within K5_TF32_REL, the stand-in above K5_REL's fp32 bar.  Returns
    the readings and a line for the check's print."""
    rel = {n: rel_frobenius(g, w) for n, (g, w, _) in outs.items()}
    one = {n: rel_frobenius(s, w) for n, (_, w, s) in outs.items()}
    bar = K5_REL["float32"]
    if max(rel.values()) > K5_TF32_REL or min(one.values()) <= bar:
        raise AssertionError(f"{tag}: 3xTF32 reads {rel} (bar "
                             f"{K5_TF32_REL}), the 1xTF32 stand-in {one} "
                             f"(must read above {bar})")
    return {"rel_frobenius_3xtf32": rel, "standin_1xtf32": one,
            "tf32_line": "relative Frobenius against the plain version "
            + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
            + f" (3xTF32 bar {K5_TF32_REL}); the 1xTF32 stand-in reads "
            + ", ".join(f"{n} {r:.3e}" for n, r in one.items())
            + f" (must read above {bar})"}


def sdpa_backends(q, k, v, causal):
    """Each of F.scaled_dot_product_attention's fused backends alone on
    q, k, v (``is_causal``), timed as ``graph_windows_ms`` times K5: its
    windows, or why it did not run (flash needs v's head dim to be q's)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = k.shape[1] != q.shape[1]
    out = {}
    run = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=gqa)
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                run()
                torch.cuda.synchronize()
                out[name] = graph_windows_ms(run)
        except RuntimeError as e:
            out[name] = "unavailable (" + str(e).strip().splitlines()[0][
                :80].replace(";", ",") + ")"
            torch.cuda.synchronize()
    return out


def k5_planted(q, k, v, causal, window, got, want):
    """Readings against the plain version ``want`` of three planted faults
    in K5's output: ``got`` x 0.9; the plain version with one 64-key tile
    dropped from every row (the ragged last tile where the mask hides no
    key, else the middle tile); ``got`` with its last 128-query tile
    zeroed, the rows of bf16 K5's last query tile."""
    from repro_torch.kernels import flash_attention as FA
    Sq, Skv = q.shape[2], k.shape[2]
    t0 = ((Skv - 1) // 64 if not (causal or window) else Skv // 2 // 64) * 64
    t1 = min(t0 + 64, Skv)
    real = FA._mask

    def dropped(*args):
        keep = real(*args)
        keep[:, t0:t1] = False
        return keep

    FA._mask = dropped
    try:
        drop = FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
    finally:
        FA._mask = real
    r0 = (Sq - 1) // 128 * 128
    zeroed = got.clone()
    zeroed[:, :, r0:] = 0
    out = {"o x 0.9": rel_frobenius(got * 0.9, want),
           f"keys {t0}-{t1 - 1} dropped": rel_frobenius(drop, want),
           f"rows {r0}-{Sq - 1} zeroed": rel_frobenius(zeroed, want)}
    del drop, zeroed
    return out


def rglru_inputs(shape, dtype, dev, seed):
    """tests/test_kernels.py::test_rglru_kernel's distributions on the card."""
    import torch
    b, s, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shp: torch.randn(*shp, generator=gen, device=dev)
    return ((f(b, s, w) * 0.2).to(dtype), f(b, s, w).to(dtype),
            f(b, s, w).to(dtype), f(w), f(b, w) * 0.1)


def check_k7(dev, time_ms, call_ms, max_err):
    """Phase 9(a): K7 against its plain version at tests/test_kernels.py's
    shapes and ragged ones (S 1, 31, 77, 255; W 200, 201) in fp32, and at
    RecurrentGemma-2B's layer shape in fp32 and bf16 and the ring serve's
    4096-token shape in bf16, all with h0; those three timed, with the
    launch that spreads their time axis over a cluster.  Returns (largest
    abs err, {(shape, dtype): times})."""
    import torch
    from repro_torch.kernels.rglru import (launch_plan, launch_shape,
                                           rglru_scan, rglru_scan_plain)
    timed = [(K7_LAYER, torch.float32), (K7_LAYER, torch.bfloat16),
             (K7_RING, torch.bfloat16)]
    cases = [(shape, torch.float32) for shape in K7_SHAPES] + timed
    worst, times = 0.0, {}
    for i, (shape, dtype) in enumerate(cases):
        args = rglru_inputs(shape, dtype, dev, seed=i)
        bf = dtype == torch.bfloat16
        # fp32: tests/test_kernels.py's rtol/atol 1e-4; bf16 y: one bf16
        # rounding apart (the state is fp32 in both)
        tol = 1e-2 if bf else 1e-4
        err = max_err(rglru_scan(*args), rglru_scan_plain(*args), tol, tol,
                      f"K7 {shape} {dtype}")
        worst = max(worst, err)
        line = (f"K7 rglru_scan B,S,W={shape} {dtype} h0=True: "
                f"max_abs_err={err:.3e} (rtol={tol} atol={tol})")
        if (shape, dtype) in timed:
            ms = time_ms(lambda: rglru_scan(*args))
            plain = time_ms(lambda: rglru_scan_plain(*args), reps=3)
            bnd, by = k7_bound(*shape, dtype)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            sfu = 1e3 * K7_SFU * math.prod(shape) / (SFU_PER_CLOCK * sms
                                                     * BOOST_HZ)
            times[(shape, dtype)] = {"ms": ms, "plain_ms": plain,
                                     "bound_ms": bnd, "bound_by": by,
                                     "bound_sfu_ms": sfu}
            plan, launch = launch_plan(*shape), launch_shape(*shape, dtype)
            line += (f"; ms={ms:.4f} (per Python call "
                     f"{call_ms(lambda: rglru_scan(*args)):.4f}) "
                     f"plain_ms={plain:.4f} library_ms=none "
                     f"bound_ms={bnd:.4f} ({by}) bound_sfu_ms={sfu:.4f}; "
                     f"grid {launch['grid']} of "
                     f"{launch['threads']} threads: {plan['items']} items "
                     f"(batch row, channel tile) over {launch['grid'][1]} "
                     f"clusters of {plan['cluster']} blocks along x, "
                     f"{plan['windows']} window(s) an item, "
                     f"{launch['smem_bytes']} bytes of shared memory a block")
        print(line)
    return worst, times


def gemma_config():
    """RecurrentGemma-2B as the port's registry gives it, checked to be the
    full-width, full-depth model."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(GEMMA)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
             cfg.sliding_window, cfg.block_pattern, cfg.dtype,
             T.count_params(cfg))
    if shape != (26, 2560, 10, 1, 256, 7680, 256000, GEMMA_WINDOW,
                 ("rglru", "rglru", "attn"), "bfloat16", 2_894_528_000):
        raise AssertionError(f"{GEMMA}: config {shape}")
    return cfg


def drive_gemma(dev, counters, time_ms, call_ms, max_err, randn):
    """Phase 9: the RecurrentGemma-2B slice at full width and depth.  K7
    and K5 at D = 256 against their plain versions; ``serve`` in bf16 with
    K7 launched once per rglru layer and K5 once per attention layer, with
    a profile of a prefill and a decode step; the ring cache's run at a
    4096-token prompt; at fp32 the served prefill against one with K7's
    and K5's plain versions swapped in, and decode == forward.  Returns
    K7's entry of the kernels line and K5's at the serving shape (bf16,
    launches a ``serve``), which K5's entry carries as ``serving``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.launch.serve import _grow_cache, serve
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    # ---- 9(a), 9(b): K7, and K5 at head dim 256 ---------------------------
    k7_err, k7_times = check_k7(dev, time_ms, call_ms, max_err)
    k5_serving = {}
    for shape in K5_GEMMA:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_k5_case(shape, True, GEMMA_WINDOW, dtype, randn,
                                time_ms, call_ms, max_err)
            if dtype == torch.bfloat16:
                k5_serving[shape] = row

    # ---- 9(c): the fourth path, RecurrentGemma-2B serving on K7 and K5 ----
    cfg = gemma_config()
    kinds = [cfg.block_pattern[j % len(cfg.block_pattern)]
             for j in range(cfg.num_layers)]
    want = [0] * len(counters)
    want[counters.index(flash_attention)] = kinds.count("attn")
    want[counters.index(rglru_scan)] = kinds.count("rglru")
    pbytes = sum(t.numel() * t.element_size()
                 for t in T.tree_leaves(T.param_shapes(cfg)))
    names = ("K1", "K2", "K5", "K6", "K8", "K7")
    k5_launches = []

    def counted_serve(run):
        for c in counters:
            c.launches = 0
        out = serve(GEMMA, smoke=False, batch=run["batch"],
                    prompt=run["prompt"], gen=run["gen"])
        launches = [c.launches for c in counters]
        k5_launches.append(launches[names.index("K5")])
        gen_tok = out["generated"]
        if launches != want:
            raise AssertionError(f"serve {run}: launches "
                                 f"{dict(zip(names, launches))}, want "
                                 f"{dict(zip(names, want))}")
        if not (gen_tok.shape == (run["batch"], run["gen"])
                and gen_tok.dtype == np.int32
                and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
            raise AssertionError(f"serve {run}: generated {gen_tok.shape} "
                                 f"{gen_tok.dtype}, range {gen_tok.min()}.."
                                 f"{gen_tok.max()}")
        cache = ("ring" if run["prompt"] + run["gen"] > cfg.sliding_window
                 else "full")
        print(f"serve {GEMMA} (26 layers, d_model 2560, 10 heads x 256 with "
              f"1 KV head, d_ff 7680, window {cfg.sliding_window}, vocab "
              f"256000, bf16, {T.count_params(cfg)} parameters, {pbytes} "
              f"bytes): batch {run['batch']}, prompt {run['prompt']}, gen "
              f"{run['gen']} ({cache} K/V cache): prefill_ms="
              f"{out['prefill_s'] * 1e3:.3f} decode_ms_per_token="
              f"{out['decode_s_per_token'] * 1e3:.3f}; K7 launches "
              f"{launches[-1]} (one per rglru layer), K5 "
              f"{launches[names.index('K5')]} (one per attention layer), "
              f"K1/K2/K6/K8 none; generated {gen_tok.shape} int32, first "
              f"row {gen_tok[0, :8].tolist()}")
        return launches[-1]

    B, S, G_ = (GEMMA_SERVE[k] for k in ("batch", "prompt", "gen"))
    serve(GEMMA, smoke=False, batch=B, prompt=256, gen=2)     # warm-up
    torch.cuda.synchronize()
    k7_launches = counted_serve(GEMMA_SERVE)

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    _, cache = DE.prefill(cfg, params, tok)
    cache = _grow_cache(cfg, cache, B, S + 8)
    nxt = tok[:, -1:]
    DE.decode_step(cfg, params, cache, nxt)
    torch.cuda.synchronize()
    profile_serving(cfg, params, tok, cache, nxt,
                    {"K7": ("rglru_chunked_kernel",),
                     "K5": ("flash_bf16_kernel", "flash_tf32_kernel")})
    del params, cache

    # ---- 9(d): the ring cache, prompt past the window ---------------------
    counted_serve(GEMMA_RING)

    # ---- 9(e): fp32, TF32 off: the served prefill against the plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    real = (ops.rglru_scan, ops.flash_attention)

    def plain_k5(q, k, v, *, causal, window, **pos):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     **pos)

    runs = {}
    for name in ("kernel", "plain", "kernel", "plain"):
        before = (rglru_scan.launches, flash_attention.launches)
        if name == "plain":
            ops.rglru_scan, ops.flash_attention = rglru_scan_plain, plain_k5
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = DE.prefill(cfg32, params32, tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.rglru_scan, ops.flash_attention = real
        n = (rglru_scan.launches - before[0],
             flash_attention.launches - before[1])
        if n != ((kinds.count("rglru"), kinds.count("attn"))
                 if name == "kernel" else (0, 0)):
            raise AssertionError(f"fp32 prefill ({name}): K7/K5 launches {n}")
        runs.setdefault(name, (logits[:, -1].float(), []))[1].append(ms)
    (lk, ms_k), (lp, ms_p) = runs["kernel"], runs["plain"]
    rel = ((lk - lp).norm() / lp.norm()).item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    if not (torch.isfinite(lk).all() and rel <= 1e-3 and same):
        raise AssertionError(f"fp32 prefill: K7/K5 vs plain rel err "
                             f"{rel:.3e} (limit 1e-3), same argmax {same}")
    print(f"fp32 prefill {GEMMA} (TF32 off, B={B}, S={S}): last-position "
          f"logits, K7 and K5 vs their plain versions: rel Frobenius err "
          f"{rel:.3e} (limit 1e-3), same argmax in all {B} rows; host ms "
          f"kernel {[round(t, 3) for t in ms_k]}, plain "
          f"{[round(t, 3) for t in ms_p]}")

    # decode == forward at full width (tests/test_models.py:80's tolerance)
    tok256 = tok[:, :256]
    full = T.forward(cfg32, params32, tok256)
    _, cache = DE.prefill(cfg32, params32, tok256[:, :255])
    cache = _grow_cache(cfg32, cache, B, 256)
    dl, cache = DE.decode_step(cfg32, params32, cache, tok256[:, 255:])
    got, want_ = dl[:, 0], full[:, 255]
    err = (got - want_).abs()
    share = (err / (2e-3 + 2e-2 * want_.abs())).max().item()
    if not (int(cache["pos"]) == 256 and torch.isfinite(got).all()
            and share <= 1.0):
        raise AssertionError(f"{GEMMA} decode != forward: max abs err "
                             f"{err.max().item():.3e}")
    print(f"decode == forward {GEMMA} (fp32, B={B}): prefill 255 tokens + "
          f"one decode_step vs forward on 256: max abs err "
          f"{err.max().item():.3e}, at most {share:.2e} of the limit "
          f"(rtol 2e-2 atol 2e-3)")
    del params32, cache, full

    # ---- 9(f): K7's entry of the kernels line (bf16, the serving dtype),
    # and K5's at the serving shape (bf16, 1024 tokens; launches a serve)
    k7_entry = {"name": "rglru_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rglru.cu",
                "replaces": "src/repro/kernels/rglru.py:54",
                "launches": k7_launches, "max_abs_err": k7_err,
                **k7_times[(K7_LAYER, torch.bfloat16)], "library_ms": None,
                "float32": k7_times[(K7_LAYER, torch.float32)],
                "at_4096": k7_times[(K7_RING, torch.bfloat16)]}
    k5_entry = {"shape": list(K5_GEMMA[0]), "dtype": "bfloat16",
                "causal": True, "window": GEMMA_WINDOW,
                "launches": k5_launches[0], **k5_serving[K5_GEMMA[0]],
                "at_4096": {k: v for k, v in k5_serving[K5_GEMMA[1]].items()
                            if k != "library"}}
    return k7_entry, k5_entry


def check_k3_k4(dev, time_ms, leaves):
    """Phase 10(a): K3 and K4 byte for byte against their plain versions,
    on the card and, for the small shapes, on a CPU copy; their times on
    the training path's largest leaf, one fp32 row of K3_ROW elements, and
    K3's summed over a train step's ``leaves`` (element counts, each one
    row, as ``distributed/compression.py`` hands them over).  Returns K3's
    and K4's entries of the kernels line, all but ``launches``."""
    import torch
    from repro_torch.kernels import vector_engine as VE
    gen = torch.Generator(device=dev).manual_seed(10)
    cases = [((128, 256), 3.0, torch.float32), ((128, 256), 3.0,
                                                torch.bfloat16),
             ((3, 1000), 1.0, torch.float32), ((3, 1000), 1.0, torch.bfloat16),
             ((4, 512), 0.0, torch.float32), ((1, K3_ROW), 1e-3,
                                              torch.float32)]
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for shape, scale, dtype in cases:
        x = (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
        q, s = VE.quantize_int8(x)
        wants = [VE.quantize_int8_plain(x)]
        if x.numel() < 1 << 20:
            wants.append(VE.quantize_int8_plain(x.cpu()))
        for wq, ws in wants:
            if not (torch.equal(q.to(wq.device), wq) and torch.equal(
                    s.to(ws.device).view(torch.int32), ws.view(torch.int32))):
                raise AssertionError(
                    f"K3 {shape} {dtype}: codes or scales not byte-equal to "
                    f"the plain version on {wq.device}")
        for out_dtype in (torch.float32, torch.bfloat16):
            got = VE.dequantize_int8(q, s, out_dtype=out_dtype)
            want = VE.dequantize_int8_plain(q, s, out_dtype=out_dtype)
            if not torch.equal(got.view(bits[out_dtype]),
                               want.view(bits[out_dtype])):
                raise AssertionError(f"K4 {shape} -> {out_dtype}: not "
                                     f"byte-equal to the plain version")
        print(f"K3/K4 {shape} {dtype} x{scale}: codes, scales and the "
              f"dequantized float32 and bfloat16 values byte-equal to the "
              f"plain versions (on the card"
              f"{' and on a CPU copy' if len(wants) > 1 else ''})")
    del wants, want, got
    # a NaN and a -Inf in row 0 (the -Inf in its last block): codes 0, a NaN
    # scale and an all-NaN dequantized row, NaN for NaN as the plain version
    for shape, dtype in (((3, 1000), torch.float32),
                         ((3, 1000), torch.bfloat16),
                         ((1, (1 << 22) + 3), torch.float32)):
        bad = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        bad[0, shape[1] // 3] = float("nan")
        bad[0, -1] = float("-inf")
        bq, bs = VE.quantize_int8(bad)
        wq, ws = VE.quantize_int8_plain(bad)
        ok = (torch.equal(bq, wq) and not bool(bq[0].any())
              and bool(bs[0].isnan()) and torch.equal(bs[1:], ws[1:])
              and bool(ws[0].isnan()))
        for out_dtype in (torch.float32, torch.bfloat16):
            got = VE.dequantize_int8(bq, bs, out_dtype=out_dtype)
            want = VE.dequantize_int8_plain(wq, ws, out_dtype=out_dtype)
            ok = ok and bool(got[0].isnan().all()) and torch.equal(
                got[1:].view(bits[out_dtype]), want[1:].view(bits[out_dtype]))
        if not ok:
            raise AssertionError(f"K3/K4 {shape} {dtype} with a NaN and an "
                                 f"Inf: not the plain version's NaN row")
        print(f"K3/K4 {shape} {dtype} with a NaN and a -Inf in row 0: codes "
              f"0, scale NaN, dequantized row NaN, as the plain version")
    del bad, bq, bs, wq, ws, want, got
    # times at the training path's largest leaf (x, q, s: the last case)
    k3 = {"ms": time_ms(lambda: VE.quantize_int8(x), reps=3),
          "plain_ms": time_ms(lambda: VE.quantize_int8_plain(x), reps=2)}
    k3["bound_ms"], k3["bound_by"] = k3_bound(1, K3_ROW, torch.float32)
    plan = VE.quantize_plan(1, K3_ROW, torch.float32)
    print(f"K3 quantize_int8 launch at (1, {K3_ROW}) float32: grid "
          f"({plan['grid']},) of {plan['threads']} threads, cooperative "
          f"({plan['resident']} blocks co-resident), {plan['segs']} items a "
          f"row, {plan['stash_bytes']} bytes a block kept in shared memory "
          f"across the grid barrier")
    k4 = {"ms": time_ms(lambda: VE.dequantize_int8(q, s), reps=3),
          "plain_ms": time_ms(lambda: VE.dequantize_int8_plain(q, s), reps=2),
          "library_ms": time_ms(lambda: torch.mul(q, s), reps=3)}
    k4["bound_ms"], k4["bound_by"] = k4_bound(1, K3_ROW)
    for name, t in (("K3 quantize_int8", k3), ("K4 dequantize_int8", k4)):
        lib = t.get("library_ms")
        print(f"{name} (1, {K3_ROW}) float32 (the stacked in_proj's gradient "
              f"as one row): ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms{'(torch.mul)=%.4f' % lib if lib else '=none'} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    del x, q, s
    torch.cuda.empty_cache()
    # K3 over one train step's leaves, each checked and timed, the bound
    # summed the same way
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "leaves": len(leaves)}
    for n in leaves:
        x = torch.randn(1, n, generator=gen, device=dev) * 1e-3
        q, s = VE.quantize_int8(x)
        wq, ws = VE.quantize_int8_plain(x)
        if not (torch.equal(q, wq) and torch.equal(s.view(torch.int32),
                                                    ws.view(torch.int32))):
            raise AssertionError(f"K3 (1, {n}): not byte-equal")
        step["ms"] += time_ms(lambda: VE.quantize_int8(x), reps=3)
        step["plain_ms"] += time_ms(lambda: VE.quantize_int8_plain(x), reps=1)
        step["bound_ms"] += k3_bound(1, n, torch.float32)[0]
    del x, q, s, wq, ws
    torch.cuda.empty_cache()
    print(f"K3 quantize_int8 over a train step's {len(leaves)} leaves "
          f"({sum(leaves)} fp32 elements, each leaf one row, byte-equal to "
          f"the plain version): ms={step['ms']:.4f} "
          f"plain_ms={step['plain_ms']:.4f} "
          f"bound_ms={step['bound_ms']:.4f} (bytes)")
    return ({"max_abs_err": 0.0, **k3, "step": step},
            {"max_abs_err": 0.0, **k4})


def check_k8b(dev, time_ms, call_ms, max_err):
    """Phase 10(b): K8b against its plain version at tests/test_kernels.py's
    shapes with h0 and a nonzero dstate in fp32 (K8's card bar), and at the
    training layer shape in bf16 (relative Frobenius error 1e-2 for each
    gradient); its times there.  Returns K8b's entry of the kernels line,
    all but ``launches``."""
    import torch
    from repro_torch.kernels import ssd as SSD
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")
    worst = 0.0
    for i, (shape, chunk) in enumerate([((2, 128, 4, 32, 2, 16), 32),
                                        ((1, 256, 2, 16, 1, 8), 64),
                                        ((2, 64, 4, 16, 4, 16), 64)]):
        x, dt, A, Bm, Cm = ssd_inputs(shape, torch.float32, dev, seed=20 + i)
        b, s, h, p, g, n = shape
        gen = torch.Generator(device=dev).manual_seed(30 + i)
        h0 = torch.randn(b, h, p, n, generator=gen, device=dev) * 0.5
        dy = torch.randn(b, s, h, p, generator=gen, device=dev)
        dstate = torch.randn(b, h, p, n, generator=gen, device=dev) * 0.1
        states = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                              keep_states=True)[2]
        got = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                               states=states)
        want = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate,
                                      chunk=chunk)
        err = max(max_err(gg, ww, 1e-3, 1e-4, f"K8b {shape} {name}")
                  for name, gg, ww in zip(names, got, want))
        worst = max(worst, err)
        print(f"K8b ssd_scan_bwd B,S,H,P,G,N={shape} chunk={chunk} float32 "
              f"h0 and dstate: six gradients max_abs_err={err:.3e} "
              f"(rtol=1e-3 atol=1e-4)")
    gen = torch.Generator(device=dev).manual_seed(33)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = ssd_inputs(K8B_LAYER, dtype, dev, seed=23)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        _, _, states = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=MAMBA_CHUNK,
                                    keep_states=True)
        run = lambda: SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, None, dy, None,
                                       chunk=MAMBA_CHUNK, states=states)
        line = f"K8b ssd_scan_bwd B,S,H,P,G,N={K8B_LAYER} {dtype}"
        if dtype == torch.bfloat16:
            got = run()
            want = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, None, dy, None,
                                          chunk=MAMBA_CHUNK)
            rels = {name: ((gg.float() - ww.float()).norm()
                           / ww.float().norm()).item()
                    for name, gg, ww in zip(names, got, want)}
            if not all(torch.isfinite(gg).all() for gg in got) or \
                    max(rels.values()) > 1e-2:
                raise AssertionError(f"K8b at the layer shape in bf16: rel "
                                     f"Frobenius errors {rels} (limit 1e-2)")
            del got, want
            line += ": rel Frobenius err " + ", ".join(
                f"{k} {v:.2e}" for k, v in rels.items()) + " (limit 1e-2)"
        ms = time_ms(run, reps=3)
        plain = call_ms(lambda: SSD.ssd_scan_bwd_plain(
            x, dt, A, Bm, Cm, None, dy, None, chunk=MAMBA_CHUNK), reps=2)
        bnd, by = k8b_bound(*K8B_LAYER, dtype)
        times[dtype] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                        "bound_by": by}
        print(f"{line}; ms={ms:.4f} (with K8's kept chunk states, "
              f"{states.numel() * 4} bytes) plain_ms(per Python call, "
              f"autograd through the plain scan)={plain:.4f} library_ms=none "
              f"bound_ms={bnd:.4f} ({by})")
        del x, dt, A, Bm, Cm, dy, states, run
        torch.cuda.empty_cache()
    print_ssd_launch("K8b", K8B_LAYER, backward=True)
    return {"max_abs_err": worst, **times[torch.bfloat16]}


def mamba_config():
    """Mamba-2 370M as the port's registry gives it, checked to be the
    full-width, full-depth model."""
    from repro_torch.configs import get_arch
    cfg = get_arch(MAMBA)
    shape = (cfg.num_layers, cfg.d_model, cfg.ssm_expand * cfg.d_model,
             cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size, cfg.padded_vocab,
             cfg.dtype)
    if shape != (48, 1024, 2048, 128, 256, 50280, 50432, "bfloat16"):
        raise AssertionError(f"{MAMBA}: config {shape}")
    return cfg


def drive_train(dev, counters, time_ms, call_ms, max_err, card):
    """Phase 10: the training slice.  K3/K4 and K8b against their plain
    versions; the full model's fp32 loss and gradients with K8/K8b and with
    their plain versions swapped in; 10 train steps of Mamba-2 370M at full
    width and depth in bf16 under remat with int8 gradient compression and
    the in-place AdamW, counted and profiled (the profiled step trains on
    in place); the launcher's ``train`` and a byte-exact restore.  Returns
    the K3, K4 and K8b entries of the kernels line."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    # ---- 10(a), 10(b): K3 and K4; K8b -----------------------------------
    cfg = mamba_config()
    leaves = [t.numel() for t in T.tree_leaves(T.param_shapes(cfg))]
    n_leaves = len(leaves)
    k3_entry, k4_entry = check_k3_k4(dev, time_ms, leaves)
    k8b_entry = check_k8b(dev, time_ms, call_ms, max_err)

    # ---- 10(c): fp32, TF32 off: the gradients against the plain versions --
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    batch = TokenStream(cfg, GRAD_CHECK["batch"], GRAD_CHECK["seq"], 0,
                        device=dev).batch_at(0)
    real = (SSD.ssd_scan, SSD.ssd_scan_bwd)

    def plain_fwd(x, dt, A, Bm, Cm, *, chunk, h0, keep_states=False):
        y, hf = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return (y, hf, None) if keep_states else (y, hf)

    def plain_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, *, states, chunk):
        return SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate,
                                      chunk=chunk)

    runs = {}
    for name in ("kernel", "plain"):
        before = (real[0].launches, real[1].launches)
        if name == "plain":
            SSD.ssd_scan, SSD.ssd_scan_bwd = plain_fwd, plain_bwd
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = ST.value_and_grad(cfg32, params32, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            SSD.ssd_scan, SSD.ssd_scan_bwd = real
        n = (real[0].launches - before[0], real[1].launches - before[1])
        # under remat each layer's forward (K8) runs again in the backward
        want_n = ((2 if cfg32.remat else 1) * cfg.num_layers, cfg.num_layers)
        if n != (want_n if name == "kernel" else (0, 0)):
            raise AssertionError(f"fp32 gradients ({name}): K8/K8b launches "
                                 f"{n}, want {want_n}")
        runs[name] = (loss.item(), T.tree_leaves(grads), ms)
    (lk, gk, ms_k), (lp, gp, ms_p) = runs["kernel"], runs["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    rels = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp)]
    finite = all(torch.isfinite(a).all() for a in gk)
    if not (finite and rel_loss <= 1e-5 and max(rels) <= 1e-3):
        raise AssertionError(f"fp32 gradients, K8/K8b vs plain: loss rel err "
                             f"{rel_loss:.3e} (limit 1e-5), leaf rel errs "
                             f"{[f'{r:.2e}' for r in rels]} (limit 1e-3)")
    print(f"fp32 gradients {MAMBA} (TF32 off, batch {GRAD_CHECK['batch']}, "
          f"seq {GRAD_CHECK['seq']}, {cfg.num_layers} layers, remat "
          f"{cfg32.remat}): loss {lk:.6f}, K8/K8b (launches {want_n}) vs "
          f"their plain versions: loss rel err {rel_loss:.3e} (limit 1e-5), "
          f"{len(rels)} gradient leaves, worst rel Frobenius err "
          f"{max(rels):.3e} (limit 1e-3); host ms kernel {ms_k:.3f}, plain "
          f"{ms_p:.3f}")
    del params32, batch, runs, gk, gp, grads, loss
    torch.cuda.empty_cache()

    # ---- 10(d): the fifth path, Mamba-2 370M training on K8, K8b, K3, K4 --
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init(params)
    tcfg = TrainConfig(grad_compression="int8", warmup_steps=TRAIN["warmup"],
                       total_steps=TRAIN["steps"])
    step_fn = ST.make_train_step(cfg, tcfg)
    B, S = TRAIN["batch"], TRAIN["seq"]
    stream = TokenStream(cfg, B, S, 0, device=dev)
    counted = counters + (VE.quantize_int8, VE.dequantize_int8,
                          SSD.ssd_scan_bwd)
    names = ("K1", "K2", "K5", "K6", "K8", "K7", "K3", "K4", "K8b")
    want = dict.fromkeys(names, 0)
    # under remat each layer's forward (K8) runs again in the backward
    want.update(K8=(2 if cfg.remat else 1) * cfg.num_layers,
                K8b=cfg.num_layers, K3=n_leaves, K4=n_leaves)
    batches = [stream.batch_at(i) for i in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counted:
        c.launches = 0
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN["steps"]):
        before = [c.launches for c in counted]
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batches[i])
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(dict(zip(names, (c.launches - b for c, b in
                                         zip(counted, before)))))
    launches = dict(zip(names, (c.launches for c in counted)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, n in enumerate(per_step):
        if n != want:
            raise AssertionError(f"train step {i + 1}: launches {n}, want "
                                 f"{want}")
    if not (all(math.isfinite(l) for l in losses) and losses[-1] < losses[0]
            and int(opt.step) == TRAIN["steps"]):
        raise AssertionError(f"train: losses {losses}, step {int(opt.step)}")
    med = statistics.median(step_ms[2:])
    print(f"train {MAMBA} ({cfg.num_layers} layers, {cfg.dtype}, "
          f"{T.count_params(cfg)} parameters, remat {cfg.remat}, AdamW with "
          f"fp32 moments updated in place, int8 error-feedback "
          f"gradients, warm-up {TRAIN['warmup']} of {TRAIN['steps']} steps): "
          f"batch {B} x seq {S}, {TRAIN['steps']} steps: losses "
          f"{[round(l, 4) for l in losses]}; step ms "
          f"{[round(t, 3) for t in step_ms]}; median of steps 3-"
          f"{TRAIN['steps']} {med:.3f} ms, {B * S / med * 1e3:.1f} tokens/s; "
          f"card {card}; peak memory {peak_gb:.2f} GB; launches a step K8 "
          f"{want['K8']} (the forward and its recompute), K8b "
          f"{want['K8b']}, K3 {want['K3']} and K4 "
          f"{want['K4']} (one call each per gradient leaf; a K3 call is one "
          f"cooperative kernel launch), K1/K2/K5/K6/K7 none; "
          f"in all {launches}")
    profile_run(f"train step (B={B}, S={S}",
                lambda: step_fn(params, opt, batches[0])[2]["loss"].item(), 1,
                {"K8b": ("ssd_bwd_kernel",), "K8": ("ssd_kernel",),
                 "K4": ("dequantize_kernel",),
                 "K3": ("quantize_int8_kernel",)}, "step")
    del params, opt, batches, metrics
    torch.cuda.empty_cache()

    # ---- 10(e): the launcher, with a checkpoint restored byte for byte ----
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved = {}
    real_save = ckpt.save

    def recording_save(d, step, tree, **kw):
        saved[step] = [t.detach().clone() for t in T.tree_leaves(tree)]
        return real_save(d, step, tree, **kw)

    ckpt.save = recording_save
    try:
        t0 = time.perf_counter()
        tl = TR.train(MAMBA, smoke=False, steps=LAUNCHER["steps"],
                      batch=LAUNCHER["batch"], seq=LAUNCHER["seq"],
                      ckpt_dir=str(ckpt_dir), checkpoint_every=2, log_every=1)
        wall = time.perf_counter() - t0
    finally:
        ckpt.save = real_save
    meta = lambda dtype: (lambda p: torch.empty(p.shape, dtype=dtype,
                                                device="meta"))
    shapes = T.param_shapes(cfg)
    template = (shapes, adamw.AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"),
        T.tree_map(meta(torch.float32), shapes),
        T.tree_map(meta(torch.float32), shapes)))
    t0 = time.perf_counter()
    restored, step, extras = ckpt.restore(str(ckpt_dir), template)
    t_restore = time.perf_counter() - t0
    got = T.tree_leaves(restored)
    ibits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int32: torch.int32}
    exact = (sorted(saved) == [LAUNCHER["steps"]] and step == LAUNCHER["steps"]
             and len(got) == len(saved[step]) == 1 + 3 * n_leaves
             and all(a.dtype == b.dtype and a.device == b.device and
                     torch.equal(a.view(ibits[a.dtype]),
                                 b.view(ibits[b.dtype]))
                     for a, b in zip(got, saved[step])))
    nbytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
    if not (exact and len(tl) == LAUNCHER["steps"]
            and all(math.isfinite(l) for l in tl)
            and extras == {"arch": MAMBA, "seed": 0}):
        raise AssertionError(f"launcher: losses {tl}, checkpoint steps "
                             f"{sorted(saved)}, restore step {step}, "
                             f"byte-equal {exact}, extras {extras}")
    shutil.rmtree(ckpt_dir)
    print(f"train() launcher {MAMBA} (smoke=False, {LAUNCHER['steps']} "
          f"steps, batch {LAUNCHER['batch']} x seq {LAUNCHER['seq']}): "
          f"losses {[round(l, 4) for l in tl]} in {wall:.1f} s; checkpoint "
          f"of step {step}: {1 + 3 * n_leaves} leaves, {nbytes} bytes, "
          f"restored in {t_restore:.1f} s, parameters and moments byte-equal "
          f"to what was saved")
    del restored, got, saved
    torch.cuda.empty_cache()

    # ---- 10(f): the kernels line's entries --------------------------------
    # K3's launches count quantize_int8 calls, each one kernel launch
    src = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "quantize_int8", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:69",
         "launches": launches["K3"], **k3_entry, "library_ms": None},
        {"name": "dequantize_int8", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:91",
         "launches": launches["K4"], **k4_entry},
        {"name": "ssd_scan_bwd", "route": "cuda", "source": src + "ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:87",
         "launches": launches["K8b"], **k8b_entry, "library_ms": None},
    ]


def qwen_config(arch, layers=None):
    """``arch`` as the port's registry gives it, checked to be the full
    model, and cut to ``layers`` (None: full depth)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(arch)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.moe_d_ff or cfg.d_ff,
             cfg.num_experts, cfg.experts_per_token, cfg.qk_norm,
             cfg.qkv_bias, cfg.vocab_size, T.count_params(cfg))
    if shape != QWEN_FULL[arch] or cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: config {shape} {cfg.dtype}")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def as_fp32(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, dtype="float32", **kw)


def describe(cfg):
    """One line of a Qwen config's shape, parameters and bytes."""
    from repro_torch.models import transformer as T
    nbytes = sum(t.numel() * t.element_size()
                 for t in T.tree_leaves(T.param_shapes(cfg)))
    ffn = (f"{cfg.num_experts} experts of d_ff {cfg.moe_d_ff}, top-"
           f"{cfg.experts_per_token}, capacity factor "
           f"{cfg.moe_capacity_factor}" if cfg.num_experts
           else f"d_ff {cfg.d_ff}")
    extra = " qk-norm" * cfg.qk_norm + " QKV bias" * cfg.qkv_bias
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads x {cfg.resolved_head_dim} with "
            f"{cfg.num_kv_heads} KV heads{',' + extra if extra else ''}, "
            f"{ffn}, vocab "
            f"{cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.dtype}, "
            f"{T.count_params(cfg)} parameters, {nbytes} bytes")


class serving_config:
    """Within the block, ``serve`` builds ``cfg`` for ``cfg.name``: the
    registered model's widths at a cut depth."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        from repro_torch.launch import serve as S
        self.real = S.get_arch
        S.get_arch = lambda name: (self.cfg if name == self.cfg.name
                                   else self.real(name))

    def __exit__(self, *exc):
        from repro_torch.launch import serve as S
        S.get_arch = self.real


def draw_attn_leaves(params, gen):
    """The QKV biases (std 0.2) and qk-norm scales (MLA: its latent norms'
    scales; std 0.5) drawn from ``gen`` in place of ``init_params``'s
    zeros, which would hide a missing bias or scale; returns their
    names."""
    import torch
    attn = params["blocks"]["b0_attn"]["attn"]
    names = [n for n in ("bq", "bk", "bv", "qn", "kn", "q_ln", "kv_ln")
             if n in attn]
    for n in names:
        t = attn[n]
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                * (0.2 if n.startswith("b") else 0.5))
    return names


def k5_per_prefill(cfg):
    """K5's launches in one prefill of ``cfg``: one a decoder layer, one
    more where it cross-attends, one an encoder layer."""
    return (cfg.num_layers * (2 if cfg.cross_attention else 1)
            + cfg.encoder_layers)


def fp32_prefill_check(cfg32, dev, run, card, inputs=None):
    """The served prefill at fp32 (TF32 off) against one with K5's plain
    version swapped into ``ops.flash_attention``: last-position logits
    within 1e-3 relative Frobenius, the same argmax; and decode == forward
    (tests/test_models.py:80's tolerance).  ``inputs``: the frontend's
    keyword arguments of ``prefill`` and ``forward`` (``paper_inputs``),
    an encoder-decoder's frames or the patch embeddings."""
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    B, S = run["batch"], run["prompt"]
    inputs = inputs or {}
    params = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    drawn = draw_attn_leaves(params, torch.Generator(device=dev).manual_seed(2))
    tok = torch.from_numpy(RequestStream(cfg32, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    real = ops.flash_attention

    def plain_k5(q, k, v, *, causal, window, **pos):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     **pos)

    runs = {}
    for name in ("kernel", "plain", "kernel", "plain"):
        before = flash_attention.launches
        ops.flash_attention = plain_k5 if name == "plain" else real
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = DE.prefill(cfg32, params, tok, **inputs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.flash_attention = real
        n = flash_attention.launches - before
        if n != (k5_per_prefill(cfg32) if name == "kernel" else 0):
            raise AssertionError(f"{cfg32.name} fp32 prefill ({name}): {n} "
                                 f"K5 launches")
        runs.setdefault(name, (logits[:, -1].float(), []))[1].append(ms)
    (lk, ms_k), (lp, ms_p) = runs["kernel"], runs["plain"]
    cols = slice(0, cfg32.vocab_size)
    rel = ((lk[:, cols] - lp[:, cols]).norm() / lp[:, cols].norm()).item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    if not (torch.isfinite(lk[:, cols]).all() and rel <= 1e-3 and same):
        raise AssertionError(f"{cfg32.name} fp32 prefill: K5 vs plain rel "
                             f"err {rel:.3e} (limit 1e-3), same argmax {same}")
    print(f"fp32 prefill {cfg32.name} ({describe(cfg32)}; "
          f"{f'{drawn} drawn nonzero' if drawn else 'no bias or norm drawn'}"
          f"; TF32 off, B={B}, S={S}): last-position logits, K5 vs "
          f"its plain version: rel Frobenius err {rel:.3e} (limit 1e-3), "
          f"same argmax in all {B} rows; host ms kernel "
          f"{[round(t, 3) for t in ms_k]}, plain {[round(t, 3) for t in ms_p]}"
          f"; card {card}")

    full = T.forward(cfg32, params, tok, **inputs)
    _, cache = DE.prefill(cfg32, params, tok[:, :S - 1], **inputs)
    cache = _grow_cache(cfg32, cache, B, S)
    dl, cache = DE.decode_step(cfg32, params, cache, tok[:, S - 1:])
    got, want = dl[:, 0, cols], full[:, S - 1, cols]
    err = (got - want).abs()
    share = (err / (2e-3 + 2e-2 * want.abs())).max().item()
    if not (int(cache["pos"]) == S and torch.isfinite(got).all()
            and share <= 1.0):
        raise AssertionError(f"{cfg32.name} decode != forward: max abs err "
                             f"{err.max().item():.3e}")
    print(f"decode == forward {cfg32.name} (fp32, B={B}): prefill {S - 1} "
          f"tokens + one decode_step vs forward on {S}: max abs err "
          f"{err.max().item():.3e}, at most {share:.2e} of the limit "
          f"(rtol 2e-2 atol 2e-3)")


def moe_routing(cfg, dev):
    """Route the served prompts (``serve``'s parameters and tokens, seed 0)
    through a prefill with ``layers.moe_ffn`` wrapped to record, per layer,
    the tokens, slots an expert, assignments dropped past them and the
    least and most loaded expert."""
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.models import decode as DE
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    run = QWEN_SERVE[cfg.name]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, run["batch"], run["prompt"], 0)
                           .requests_at(0)["tokens"]).to(dev)
    real, rows = L.moe_ffn, []

    def recording(x, gate_w, *args, num_experts, k, capacity_factor,
                  block_tokens=0, **kw):
        if block_tokens:
            raise AssertionError("moe_routing reads one block of tokens")
        top = torch.topk(torch.softmax((x @ gate_w).float(), -1), k).indices
        load = torch.bincount(top.flatten(), minlength=num_experts)
        C = max(8, int(math.ceil(x.shape[0] * k * capacity_factor
                                 / num_experts)))
        rows.append((x.shape[0], C, int((load - C).clamp(min=0).sum()),
                     int(load.min()), int(load.max())))
        return real(x, gate_w, *args, num_experts=num_experts, k=k,
                    capacity_factor=capacity_factor,
                    block_tokens=block_tokens, **kw)

    L.moe_ffn = recording
    try:
        DE.prefill(cfg, params, tok)
    finally:
        L.moe_ffn = real
    return rows


def drive_qwen(dev, counters, time_ms, call_ms, max_err, randn, card):
    """Phase 11: the Qwen decoders (dense GQA with qk-norm or QKV bias, and
    the top-k MoE FFN).  K5 at their three serving shapes; ``serve`` of
    qwen3-8b and qwen1.5-4b at full width and depth and qwen3-moe-235b at
    full width over 4 of its 94 layers, each in bf16 with K5 launched once
    per layer of the prefill and no other kernel, qwen3-8b profiled; at
    fp32 each served prefill (cut in depth) against one with K5's plain
    version, and decode == forward.  Every line with a time ends with
    ``card``, the card's name and power limit.  Returns K5's entries at the
    three shapes (bf16, with launches a ``serve``) for its kernels line."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.launch.serve import _grow_cache, serve
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T

    # ---- 11(a): K5 at the Qwen serving shapes ----------------------------
    rows = {}
    for shape in K5_QWEN + K5_TP:
        for dtype in (torch.float32, torch.bfloat16):
            rows[(shape, dtype)] = check_k5_case(
                shape, True, 0, dtype, randn, time_ms, call_ms, max_err, card,
                standin=dtype == torch.float32)

    names = ("K1", "K2", "K5", "K6", "K8", "K7")
    entries = {}

    def counted_serve(cfg):
        run = QWEN_SERVE[cfg.name]
        with serving_config(cfg):
            serve(cfg.name, smoke=False, batch=run["batch"], prompt=256,
                  gen=2)                                     # warm-up
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            out = serve(cfg.name, smoke=False, **run)
        launches = dict(zip(names, (c.launches for c in counters)))
        want = {n: cfg.num_layers if n == "K5" else 0 for n in names}
        gen_tok = out["generated"]
        if launches != want:
            raise AssertionError(f"serve {cfg.name} {run}: launches "
                                 f"{launches}, want {want}")
        if not (gen_tok.shape == (run["batch"], run["gen"])
                and gen_tok.dtype == np.int32
                and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
            raise AssertionError(f"serve {cfg.name}: generated "
                                 f"{gen_tok.shape} {gen_tok.dtype}, range "
                                 f"{gen_tok.min()}..{gen_tok.max()}")
        print(f"serve {cfg.name} ({describe(cfg)}): batch {run['batch']}, "
              f"prompt {run['prompt']}, gen {run['gen']}: prefill_ms="
              f"{out['prefill_s'] * 1e3:.3f} decode_ms_per_token="
              f"{out['decode_s_per_token'] * 1e3:.3f}; K5 launches "
              f"{launches['K5']} (one per layer), K1/K2/K6/K7/K8 none; "
              f"generated {gen_tok.shape} int32, first row "
              f"{gen_tok[0, :8].tolist()}; card {card}")
        return launches["K5"]

    def entry(cfg, shape, launches):
        entries[cfg.name] = {
            "shape": list(shape), "dtype": "bfloat16", "causal": True,
            "window": 0, "launches": launches,
            **rows[(shape, torch.bfloat16)],
            "float32": {k: v for k, v in rows[(shape, torch.float32)].items()
                        if k != "library"}}

    # ---- 11(b), 11(c): qwen3-8b, full width and depth; the fp32 check ----
    cfg = qwen_config("qwen3-8b")
    entry(cfg, K5_QWEN[0], counted_serve(cfg))
    run = QWEN_SERVE[cfg.name]
    B, S = run["batch"], run["prompt"]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tok = torch.from_numpy(RequestStream(cfg, B, S, 0).requests_at(0)
                           ["tokens"]).to(dev)
    _, cache = DE.prefill(cfg, params, tok)
    cache = _grow_cache(cfg, cache, B, S + 8)
    nxt = tok[:, -1:]
    DE.decode_step(cfg, params, cache, nxt)
    torch.cuda.synchronize()
    profile_serving(cfg, params, tok, cache, nxt,
                    {"K5": ("flash_bf16_kernel", "flash_tf32_kernel")}, card)
    del params, cache
    torch.cuda.empty_cache()
    fp32_prefill_check(as_fp32(qwen_config("qwen3-8b", QWEN_CHECK_LAYERS)), dev,
                    QWEN_CHECK, card)
    torch.cuda.empty_cache()

    # ---- 11(d): qwen1.5-4b (MHA 20:20, QKV bias) --------------------------
    cfg = qwen_config("qwen1.5-4b")
    entry(cfg, K5_QWEN[1], counted_serve(cfg))
    torch.cuda.empty_cache()
    fp32_prefill_check(as_fp32(qwen_config("qwen1.5-4b", QWEN_CHECK_LAYERS)),
                    dev, QWEN_CHECK, card)
    torch.cuda.empty_cache()

    # ---- 11(e): qwen3-moe-235b-a22b, full width, 4 of 94 layers ----------
    cfg = qwen_config("qwen3-moe-235b-a22b", MOE_LAYERS)
    print(f"{cfg.name} cut to {MOE_LAYERS} of 94 layers: what one card holds "
          f"with room to run ({describe(cfg)})")
    entry(cfg, K5_QWEN[2], counted_serve(cfg))
    torch.cuda.empty_cache()
    route = moe_routing(cfg, dev)
    torch.cuda.empty_cache()
    print(f"routing of the served prefill {cfg.name} (per layer: tokens, "
          f"slots an expert, assignments dropped by capacity, least and most "
          f"loaded expert): {route}; dropped {sum(r[2] for r in route)} of "
          f"{sum(r[0] for r in route) * cfg.experts_per_token}")
    fp32_prefill_check(as_fp32(qwen_config(cfg.name, MOE_CHECK_LAYERS),
                            moe_capacity_factor=16.0), dev, QWEN_CHECK, card)
    torch.cuda.empty_cache()
    # K5 at the TP ranks' shapes: launched in phase 16, whose count main
    # adds to these rows
    entries["tp_ranks"] = [
        {"shape": list(shape), "dtype": "bfloat16", "causal": True,
         "window": 0, **rows[(shape, torch.bfloat16)],
         "float32": {k: v for k, v in rows[(shape, torch.float32)].items()
                     if k != "library"}} for shape in K5_TP]
    entries["rank_shapes"] = []
    for shape, causal, window, dtype in (
            [(shape, causal, 0, "bfloat16") for shape, causal in K5_RANKS]
            + K5_LATE):
        entries["rank_shapes"].append(
            {"shape": list(shape), "dtype": dtype, "causal": causal,
             "window": window, **check_k5_case(
                 shape, causal, window, getattr(torch, dtype), randn,
                 time_ms, call_ms, max_err, card, backends=True,
                 standin=dtype == "float32")})
        torch.cuda.empty_cache()
    # K5b at 17(f)'s rank shape, fp32, timed beside SDPA's backward
    shape = K5_LATE[-1][0]
    _, _, entries["rank_shapes"][-1]["k5b"] = k5b_case(
        shape, True, 0, torch.float32, time_ms, call_ms, max_err, randn,
        card, timed=True, standin=True)
    # K5b in fp32 beside SDPA's fp32 backward at two training shapes
    entries["k5b_fp32"] = {
        name: k5b_case(shape, causal, 0, torch.float32, time_ms, call_ms,
                       max_err, randn, card, timed=True)[2]
        for name, (shape, causal) in K5B_FP32_TIMED.items()}
    # ---- 11(f): K5 and K5b with q_offset and kv_len ----------------------
    shape, q_offset, kv_len = K5_OFFSET
    entries["offsets"] = {
        "shape": list(shape), "dtype": "bfloat16", "causal": True,
        "window": 0, "q_offset": q_offset, "kv_len": kv_len,
        **check_k5_case(shape, True, 0, torch.bfloat16, randn, time_ms,
                        call_ms, max_err, card, q_offset=q_offset,
                        kv_len=kv_len)}
    err, rel, k5b_row = k5b_case(shape, True, 0, torch.bfloat16, time_ms,
                                 call_ms, max_err, randn, card,
                                 q_offset=q_offset, kv_len=kv_len)
    entries["offsets"]["k5b"] = {"max_abs_err": err, "rel_frobenius": rel,
                                 **k5b_row}
    torch.cuda.empty_cache()
    return entries


def paper_config(name, dtype=None):
    """``name`` (whisper-medium from the port's registry, the paper's LMs
    from ``configs.paper_suite``) at full size; in ``dtype`` where given."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.paper_suite import PAPER_LM_SUITE
    cfg = {**PAPER_LM_SUITE, **ARCHS}[name]
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def paper_inputs(cfg, batch, seq, dev):
    """The frontend's inputs of ``prefill`` in the model's dtype, drawn as
    ``TokenStream`` draws them (normal(0, 0.02), seed 0): the frame
    embeddings (batch, encoder_seq, d_model) of the audio frontend, the
    patch embeddings (batch, frontend_seq, d_model) of the vision one, or
    none."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    names = {"audio_frames": "encoder_frames",
             "vision_patches": "frontend_embeds"}
    if cfg.frontend not in names:
        return {}
    name = names[cfg.frontend]
    drawn = TokenStream(cfg, batch, seq, 0, device=dev).batch_at(0)[name]
    return {name: drawn.to(getattr(torch, cfg.dtype))}


def serve_counted(cfg, run, dev, counters, card):
    """``cfg`` served in its dtype: ``launch.serve.serve`` (its stub
    frontend's zeros), then through ``ST.make_prefill_step`` and
    ``make_decode_step`` with the frontend's inputs drawn as ``TokenStream``
    draws them (``paper_inputs``), timed; ``counters`` (K1, K2, K5, K6, K8,
    K7) must read K5 ``k5_per_prefill(cfg)`` times a prefill and no other
    kernel, with no plain attention in the prefill and one a layer (and
    cross-attention) a decode step: ``layers._attn_block``, or MLA's
    absorbed ``decode.mla_step``, as the JAX package decodes.  Prints one
    line ending with ``card``; returns (params, the batch, K5's launches a
    prefill)."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import _grow_cache, serve
    from repro_torch.models import decode as DE
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    names = ("K1", "K2", "K5", "K6", "K8", "K7")
    launched = lambda: dict(zip(names, (c.launches for c in counters)))
    B, S, G_ = run["batch"], run["prompt"], run["gen"]
    want = {n: k5_per_prefill(cfg) if n == "K5" else 0 for n in names}
    with serving_config(cfg):
        for c in counters:
            c.launches = 0
        warm = serve(cfg.name, smoke=False, batch=B, prompt=S, gen=2)
    if launched() != want or warm["generated"].shape != (B, 2):
        raise AssertionError(f"serve {cfg.name} {run}: launches "
                             f"{launched()}, want {want}")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    batch_in = {"tokens": torch.from_numpy(RequestStream(
        cfg, B, S, 0).requests_at(0)["tokens"]).to(dev),
        **paper_inputs(cfg, B, S, dev)}
    prefill_fn, decode_fn = (ST.make_prefill_step(cfg),
                             ST.make_decode_step(cfg))
    mla = cfg.attention == "mla"
    plain_name = "mla_step" if mla else "_attn_block"
    module = DE if mla else L
    real = getattr(module, plain_name)
    plain = [0]

    def counting(*args, **kw):
        plain[0] += 1
        return real(*args, **kw)

    setattr(module, plain_name, counting)
    try:
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, batch_in)
        cache = _grow_cache(cfg, cache, B, S + G_)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        at_prefill, plain_prefill = launched(), plain[0]
        tokens = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tokens]
        t0 = time.perf_counter()
        for _ in range(G_ - 1):
            logits, cache = decode_fn(params, cache, {"tokens": tokens})
            tokens = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            out.append(tokens)
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / (G_ - 1)
    finally:
        setattr(module, plain_name, real)
    gen_tok = torch.cat(out, dim=1).cpu().numpy()
    per_step = cfg.num_layers * (2 if cfg.cross_attention else 1)
    if (at_prefill != want or launched() != want or plain_prefill
            or plain[0] != per_step * (G_ - 1)):
        raise AssertionError(
            f"{cfg.name} served through the step functions: launches "
            f"after the prefill {at_prefill}, after decode {launched()} "
            f"(want {want} for both); plain attention calls in the "
            f"prefill {plain_prefill} (want 0), in decode "
            f"{plain[0] - plain_prefill} (want {per_step * (G_ - 1)})")
    if not (gen_tok.shape == (B, G_) and gen_tok.dtype == np.int32
            and ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: generated {gen_tok.shape} "
                             f"{gen_tok.dtype}, range {gen_tok.min()}.."
                             f"{gen_tok.max()}")
    front = (f", {cfg.encoder_layers} encoder layers over "
             f"{cfg.encoder_seq} frames (TokenStream's draw)"
             if cfg.encoder_layers else
             f", {cfg.frontend_seq} patch positions of the prompt "
             f"(TokenStream's draw){', M-RoPE' * (cfg.rope == 'mrope')}"
             if cfg.frontend == "vision_patches" else "")
    if mla:
        front += (f", MLA (q latent {cfg.q_lora_rank}, kv latent "
                  f"{cfg.kv_lora_rank}, q/k {cfg.nope_head_dim} + "
                  f"{cfg.rope_head_dim}, v {cfg.v_head_dim})")
    stub = (" with the stub frontend's zero frames"
            if cfg.frontend == "audio_frames" else
            " with the stub frontend's zero patch embeddings"
            if cfg.frontend == "vision_patches" else "")
    print(f"serve {cfg.name} ({describe(cfg)}{front}): batch {B}, prompt "
          f"{S}, gen {G_}, through ST.make_prefill_step and "
          f"make_decode_step: prefill_ms={t_prefill * 1e3:.3f} "
          f"decode_ms_per_token={t_decode * 1e3:.3f}; K5 launches "
          f"{want['K5']} a prefill (`serve`{stub}: the same), "
          f"K1/K2/K6/K7/K8 none; plain attention "
          f"none in the prefill, {per_step} calls a decode step (plain "
          f"{plain_name}, as the JAX package decodes); generated "
          f"{gen_tok.shape} int32, first row {gen_tok[0, :8].tolist()}; "
          f"card {card}")
    return params, batch_in, at_prefill["K5"]


def drive_paper(dev, counters, time_ms, call_ms, max_err, randn, card):
    """Phase 13: Whisper's encoder-decoder and the paper's own GPT-2 1.5B
    and BERT-base, all on K5 at head dim 64.  (d) K5 at each of their
    shapes in fp32 and bf16, elementwise and within K5_REL, beside planted
    faults that must read above it; (a) whisper-medium served at full width
    and depth in bf16, first by ``launch.serve.serve`` (its stub frontend's
    zero frames), then through ``ST.make_prefill_step`` and
    ``make_decode_step`` with frames drawn as ``TokenStream`` draws them,
    timed, K5 launched 72 times a prefill (24 encoder, 24 self- and 24
    cross-attention layers) and no plain attention there, profiled; (b) its
    fp32 prefill at full depth and the served batch against one with K5's
    plain version, and decode == forward; (c) gpt2-1.5b and bert-base the
    same way (48 and 12 K5 launches).  Every
    line with a time ends with ``card``.  Returns K5's entries at the five
    shapes (bf16, with launches a prefill) for its kernels line."""
    import torch

    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import _grow_cache

    # ---- 13(d): K5 at the shapes of the three models' prefills -----------
    rows = {}
    for name, (shape, causal, _, _) in K5_PAPER.items():
        for dtype in (torch.float32, torch.bfloat16):
            rows[(name, dtype)] = check_k5_case(
                shape, causal, 0, dtype, randn, time_ms, call_ms, max_err,
                card, planted=True)

    prefill_launches = {}

    def served(cfg):
        params, batch_in, prefill_launches[cfg.name] = serve_counted(
            cfg, PAPER_SERVE[cfg.name], dev, counters, card)
        return params, batch_in

    def entry(name):
        shape, causal, model, n = K5_PAPER[name]
        return {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
                "window": 0, "model": model, "launches": n,
                "model_prefill_launches": prefill_launches[model],
                **rows[(name, torch.bfloat16)],
                "float32": {k: v for k, v in rows[(name, torch.float32)]
                            .items() if k != "library"}}

    # ---- 13(a): whisper-medium served, profiled --------------------------
    cfg = paper_config("whisper-medium")
    params, batch_in = served(cfg)
    B, S = batch_in["tokens"].shape
    prefill_fn = ST.make_prefill_step(cfg)
    decode_fn = ST.make_decode_step(cfg)
    _, cache = prefill_fn(params, batch_in)
    cache = _grow_cache(cfg, cache, B, S + 8)
    nxt = {"tokens": batch_in["tokens"][:, -1:]}
    decode_fn(params, cache, nxt)
    torch.cuda.synchronize()
    kernels = {"K5": ("flash_bf16_kernel", "flash_tf32_kernel")}
    profile_run(f"prefill whisper-medium (B={B}, S={S}, "
                f"{cfg.encoder_seq} frames", lambda: prefill_fn(params,
                                                               batch_in),
                1, kernels, "call", card)
    profile_run(f"decode whisper-medium (B={B}, S={S}",
                lambda: decode_fn(params, cache, nxt), 4, kernels, "step",
                card)
    del params, batch_in, cache
    torch.cuda.empty_cache()

    # ---- 13(b), 13(c): each model's fp32 check at full depth, after the
    # paper's LMs are served as Whisper was --------------------------------
    for name in ("whisper-medium", "gpt2-1.5b", "bert-base"):
        if name != "whisper-medium":
            served(paper_config(name))
            torch.cuda.empty_cache()
        cfg32 = paper_config(name, "float32")
        run = PAPER_SERVE[name]
        fp32_prefill_check(cfg32, dev, run, card, inputs=paper_inputs(
            cfg32, run["batch"], run["prompt"], dev))
        torch.cuda.empty_cache()
    return {name: entry(name) for name in K5_PAPER}


def vlm_config(name, layers=None, dtype=None):
    """``name`` (minicpm3-4b or qwen2-vl-72b from the port's registry,
    vit-632m from ``configs.paper_suite``), checked to be the full model,
    cut to ``layers`` (None: full depth), in ``dtype`` where given."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.paper_suite import PAPER_LM_SUITE
    from repro_torch.models import transformer as T
    cfg = {**PAPER_LM_SUITE, **ARCHS}[name]
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.v_head_dim, cfg.d_ff,
             cfg.vocab_size, cfg.frontend_seq, T.count_params(cfg))
    if shape != VLM_FULL[name] or cfg.dtype != "bfloat16":
        raise AssertionError(f"{name}: config {shape} {cfg.dtype}")
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               dtype=dtype or cfg.dtype)


def drive_vlm(dev, counters, time_ms, call_ms, max_err, randn, card):
    """Phase 14: MLA (minicpm3-4b) and the vision frontend (qwen2-vl-72b's
    M-RoPE, ViT-632M), every prefill attention on K5.  (a) K5 at its new
    shapes (minicpm3's q/k 96 with v 64, the ViT's 80), causal, in fp32 and
    bf16: elementwise and within K5_REL, beside planted faults that must
    read above it, and timed in CUDA graphs beside each of SDPA's fused
    backends alone; (b) each model served in bf16 at VLM_SERVE's sizes
    (``serve_counted``: K5 62, 8 and 32 times a prefill, no plain attention
    there; minicpm3 decoding by the absorbed ``mla_step``), its prefill and
    four decode steps profiled; (c) each at fp32 over VLM_CHECK's layers
    and batch with patch embeddings drawn as ``TokenStream`` draws them:
    the prefill against one with K5's plain version, and decode == forward.
    Returns K5's entries at the two new shapes (bf16, with launches a
    prefill) and qwen2-vl's launches, for the kernels line."""
    import torch

    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import _grow_cache

    # ---- 14(a): K5 at the new shapes -------------------------------------
    rows = {}
    for name, (shape, _, _) in K5_VLM.items():
        for dtype in (torch.float32, torch.bfloat16):
            rows[(name, dtype)] = check_k5_case(
                shape, True, 0, dtype, randn, time_ms, call_ms, max_err,
                card, planted=True, backends=True)
            torch.cuda.empty_cache()

    # ---- 14(b), 14(c): each model served, profiled, then its fp32 check ---
    kernels = {"K5": ("flash_bf16_kernel", "flash_tf32_kernel")}
    launches = {}
    for name, run in VLM_SERVE.items():
        cfg = vlm_config(name, VLM_LAYERS if name == "qwen2-vl-72b" else None)
        params, batch_in, launches[name] = serve_counted(cfg, run, dev,
                                                         counters, card)
        B, S = batch_in["tokens"].shape
        prefill_fn = ST.make_prefill_step(cfg)
        decode_fn = ST.make_decode_step(cfg)
        _, cache = prefill_fn(params, batch_in)
        cache = _grow_cache(cfg, cache, B, S + 8)
        nxt = {"tokens": batch_in["tokens"][:, -1:]}
        decode_fn(params, cache, nxt)
        torch.cuda.synchronize()
        profile_run(f"prefill {name} ({cfg.num_layers} layers, B={B}, "
                    f"S={S}", lambda: prefill_fn(params, batch_in), 1,
                    kernels, "call", card)
        profile_run(f"decode {name} ({cfg.num_layers} layers, B={B}, "
                    f"S={S}", lambda: decode_fn(params, cache, nxt), 4,
                    kernels, "step", card)
        del params, batch_in, cache
        torch.cuda.empty_cache()
        cfg32 = vlm_config(name, VLM_CHECK["layers"], "float32")
        check = {"batch": VLM_CHECK["batch"], "prompt": run["prompt"]}
        fp32_prefill_check(cfg32, dev, check, card, inputs=paper_inputs(
            cfg32, check["batch"], check["prompt"], dev))
        torch.cuda.empty_cache()

    def entry(name):
        shape, model, n = K5_VLM[name]
        if launches[model] != n:
            raise AssertionError(f"{model}: {launches[model]} K5 launches "
                                 f"a prefill, want {n}")
        return {"shape": list(shape), "dtype": "bfloat16", "causal": True,
                "window": 0, "model": model, "launches": n,
                "model_prefill_launches": launches[model],
                **rows[(name, torch.bfloat16)],
                "float32": {k: v for k, v in rows[(name, torch.float32)]
                            .items() if k != "library"}}

    return {**{name: entry(name) for name in K5_VLM},
            "qwen2-vl-72b_prefill_launches": launches["qwen2-vl-72b"]}


def graph_windows_ms(fn, reps=5, windows=5, stream=None):
    """Device ms a call of ``fn`` in each of ``windows`` windows: ``reps``
    calls captured in one CUDA graph on ``stream`` (a new side stream when
    None), replayed five times a window after a warm-up replay."""
    import torch
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
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / (5 * reps))
    del graph
    return out


def sdpa_bwd_windows(q, k, v, do, causal, window, q_offset=0, kv_len=None):
    """(form, ms of each window) of the backward alone of
    F.scaled_dot_product_attention on the same inputs, timed as
    ``graph_windows_ms`` times K5b: the forward runs once on a side stream,
    ``autograd.grad`` of it is captured there.  ``is_causal`` where the
    window masks nothing, no mask where nothing is masked, else the
    explicit mask (of ``q_offset`` and ``kv_len``'s positions where
    given)."""
    import torch
    import torch.nn.functional as F
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    shifted = bool(q_offset) or kv_len is not None
    with torch.cuda.stream(side):
        if causal and (not window or Sq <= window) and not shifted:
            form = "sdpa_is_causal"
            out = F.scaled_dot_product_attention(*ins, is_causal=True,
                                                 enable_gqa=KV != H)
        elif not causal and not window and not shifted:
            form = "sdpa_no_mask"
            out = F.scaled_dot_product_attention(*ins, enable_gqa=KV != H)
        else:
            form = "sdpa_mask"
            mask = attn_pairs(Sq, Skv, causal, window, q_offset,
                              kv_len).to(q.device)
            out = F.scaled_dot_product_attention(*ins, attn_mask=mask,
                                                 enable_gqa=KV != H)
    windows = graph_windows_ms(
        lambda: torch.autograd.grad(out, ins, do, retain_graph=True),
        stream=side)
    return form, windows


def sdpa_bwd_backends(q, k, v, do, causal):
    """Each of F.scaled_dot_product_attention's fused backends alone, its
    backward timed as ``sdpa_bwd_windows`` times it: its windows, or why it
    did not run (flash needs v's head dim to be q's)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                out[name] = sdpa_bwd_windows(q, k, v, do, causal, 0)[1]
        except RuntimeError as e:
            out[name] = "unavailable (" + str(e).strip().splitlines()[0][
                :80].replace(";", ",") + ")"
        torch.cuda.synchronize()
    return out


def rel_frobenius(got, want):
    """||got - want|| / ||want|| in fp32, the norm floored at an rms of
    K5B_REL_FLOOR."""
    got, want = got.float(), want.float()
    floor = K5B_REL_FLOOR * math.sqrt(want.numel())
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


def k5b_planted(q, k, v, o, lse, do, causal, window, got, want, **pos):
    """Readings of two planted faults against the plain version ``want``:
    K5b's dQ scaled by 0.9, and the plain version with the 64-key tile in
    the middle of the keys dropped from every sum (the dQ pass's, the
    dK/dV blocks'), one reading for each of dq, dk, dv."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    Skv = k.shape[2]
    t0 = Skv // 2 // 64 * 64
    real = FA._mask

    def dropped(*args):
        keep = real(*args)
        keep[:, t0:t0 + 64] = False
        return keep

    FA._mask = dropped
    try:
        drop = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            **pos)
    finally:
        FA._mask = real
    out = {"dq x 0.9": rel_frobenius(got[0] * 0.9, want[0])}
    for name, gg, ww in zip(("dq", "dk", "dv"), drop, want):
        out[f"keys {t0}-{t0 + 63} dropped, {name}"] = rel_frobenius(gg, ww)
    del drop
    torch.cuda.empty_cache()
    return out


def k5b_case(shape, causal, window, dtype, time_ms, call_ms, max_err, randn,
             card, backends=False, q_offset=0, kv_len=None, timed=None,
             standin=False):
    """K5's output and log-sum-exp against its plain version's, then K5b
    against its plain version, both fed K5's output and lse, at one shape
    (B, H, KV, Sq, Skv, D) or (..., D, Dv): K5's elementwise tolerances and
    K5B_REL's relative Frobenius bar, two calls byte-equal; in bf16 two
    planted faults read against that bar; the times (K5b and SDPA's
    backward each in CUDA graphs, five windows; with ``backends`` also each
    of SDPA's fused backends alone) beside the bound where ``timed`` (None:
    in bf16).  ``q_offset`` and ``kv_len`` (an int, handed to K5 and K5b
    as a 0-d tensor on the card) place the queries and bound the keys.
    In fp32 the bound is the 3xTF32 route's, with the FMA pipes' beside it;
    with ``standin`` (fp32) each gradient is held within K5_TF32_REL of the
    plain version and the 1xTF32 stand-in must read above K5_REL.  Prints
    one line; returns (max abs error, the relative errors, the row of times
    or None)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    B, H, KV, Sq, Skv, D = shape[:6]
    Dv = shape[6] if len(shape) > 6 else D
    q = randn(B, H, Sq, D, dtype=dtype)
    k = randn(B, KV, Skv, D, dtype=dtype)
    v = randn(B, KV, Skv, Dv, dtype=dtype)
    do = randn(B, H, Sq, Dv, dtype=dtype)
    bf = dtype == torch.bfloat16
    timed = bf if timed is None else timed
    rtol, atol = (0.05, 0.03) if bf else (1e-3, 2e-4)
    shifted = bool(q_offset) or kv_len is not None
    pos = {"q_offset": q_offset, "kv_len": None if kv_len is None else
           torch.tensor(kv_len, device=q.device)}
    tag = f"{shape} {dtype}" + (f" q_offset {q_offset} kv_len {kv_len}"
                                if shifted else "")
    # the forward that training runs: o at K5's bar, the lse (fp32 in
    # both) as the card tests hold it, rows that saw no key alike
    o, lse = FA.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True, **pos)
    want_o, want_lse = FA.flash_attention_plain(
        q, k, v, causal=causal, window=window, return_lse=True, **pos)
    o_err = max_err(o, want_o, rtol, atol, f"K5 {tag} o")
    lse_err = max_err(lse, want_lse, 1e-5, 1e-4, f"K5 {tag} lse")
    if not torch.equal(lse == FA.NEG_INF, want_lse == FA.NEG_INF):
        raise AssertionError(f"K5 {tag}: rows that saw no key differ")
    del want_o, want_lse
    run = lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                         causal=causal, window=window, **pos)
    got = run()
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window, **pos)
    err = max(max_err(gg, ww, rtol, atol, f"K5b {tag} {name}")
              for name, gg, ww in zip(("dq", "dk", "dv"), got, want))
    limit = K5B_REL[str(dtype).split(".")[1]]
    rel = {name: rel_frobenius(gg, ww)
           for name, gg, ww in zip(("dq", "dk", "dv"), got, want)}
    if max(rel.values()) > limit:
        raise AssertionError(f"K5b {tag}: relative Frobenius errors {rel}, "
                             f"limit {limit}")
    again = run()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K5b {tag}: two calls differ")
    del again
    line = (f"K5b flash_attention_bwd B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} "
            f"D={D}{f' Dv={Dv}' if Dv != D else ''} causal={causal} "
            f"window={window}"
            + (f" q_offset={q_offset} kv_len={kv_len} (a 0-d tensor on the "
               f"card, read by K5 and K5b)" if shifted else "")
            + f" {dtype}: K5's o max_abs_err={o_err:.3e}, lse "
            f"{lse_err:.3e} (rtol 1e-5 atol 1e-4); dq, dk, dv "
            f"max_abs_err={err:.3e} rtol={rtol} atol={atol}, relative "
            f"Frobenius " + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
            + f" (limit {limit}); a second call byte-equal")
    row = None
    planted = None
    if bf:
        planted = k5b_planted(q, k, v, o, lse, do, causal, window, got, want,
                              **pos)
        if min(planted.values()) <= limit:
            raise AssertionError(f"K5b {tag}: a planted fault reads within "
                                 f"the bar: {planted}, limit {limit}")
        line += "; planted faults read " + ", ".join(
            f"{n} {r:.3e}" for n, r in planted.items())
    tf32 = {}
    if standin:
        one = tf32_standin(q, k, v, do, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len)
        tf32 = tf32_readings(f"K5b {tag}", {
            name: (gg, ww, ss)
            for name, gg, ww, ss in zip(("dq", "dk", "dv"), got, want, one)})
        line += "; " + tf32.pop("tf32_line")
        del one
    del got, want
    if timed:
        wins = graph_windows_ms(run)
        ms = statistics.median(wins)
        plain = time_ms(lambda: FA.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, window=window, **pos), reps=2)
        form, lib_wins = sdpa_bwd_windows(q, k, v, do, causal, window,
                                          q_offset, kv_len)
        lib = statistics.median(lib_wins)
        (bnd, by), fma = k5b_bounds(B, H, KV, Sq, Skv, D, causal, window,
                                    dtype, Dv, q_offset, kv_len)
        cluster = FA.bwd_plan(B, H, KV, Sq, Skv, D, causal, window,
                              FA._sms(q.device), q_offset=q_offset,
                              kv_len=kv_len, fp32=not bf)["cluster"]
        before = None if bf or shifted else K5B_FP32_BEFORE.get(
            (tuple(shape), causal))
        row = {"cluster": cluster,
               "ms": ms, "ms_spread": [min(wins), max(wins)],
               "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
               "library_ms": lib, "library": form,
               "library_spread": [min(lib_wins), max(lib_wins)],
               "planted": planted, **tf32,
               **({"bound_fma_ms": fma[0]} if fma else {})}
        line += (f"; ms={ms:.4f} (CUDA graph, median of 5 windows, "
                 f"{min(wins):.4f}-{max(wins):.4f}; per Python call "
                 f"{call_ms(run, reps=20):.4f}) plain_ms={plain:.4f} "
                 f"library_ms ({form} backward alone, timed the same way) "
                 f"{lib:.4f} ({min(lib_wins):.4f}-{max(lib_wins):.4f}) "
                 f"bound_ms={bnd:.4f} ({by})"
                 + (f" (3xTF32 on the tensor cores) bound_fma_ms="
                    f"{fma[0]:.4f} ({fma[1]})" if fma else "")
                 + (f"; the CUDA-core kernel it replaced {before:.4f}"
                    if before else "")
                 + ("; wgmma" if bf else "; 3xTF32 on mma.sync")
                 + f", dK/dV over clusters of {cluster}")
        if backends:
            alone = sdpa_bwd_backends(q, k, v, do, causal)
            row["backends"] = {
                n: statistics.median(w) if isinstance(w, list) else w
                for n, w in alone.items()}
            line += "; backward alone by backend: " + ", ".join(
                f"{n} {statistics.median(w):.4f}" if isinstance(w, list)
                else f"{n} {w}" for n, w in alone.items())
        line += f"; card {card}"
    print(line)
    del q, k, v, do, o, lse, run
    torch.cuda.empty_cache()
    return err, rel, row


def check_k5b(time_ms, call_ms, max_err, randn, card):
    """Phase 12(a): ``k5b_case`` in fp32 at tests/test_kernels.py's
    attention shapes and masks and in bf16 at the training shapes.
    Returns K5b's entry of the kernels line (the first training shape),
    all but ``launches``."""
    import torch
    worst, rows, sound = 0.0, {}, {}
    cases = [(shape, causal, window, torch.float32)
             for shape in K5B_FP32 for causal, window in K5B_MASKS]
    cases += [(shape, causal, window, torch.bfloat16)
              for shape, causal, window in K5B_TRAIN]
    for shape, causal, window, dtype in cases:
        err, rel, row = k5b_case(shape, causal, window, dtype, time_ms,
                                 call_ms, max_err, randn, card)
        worst = max(worst, err)
        sound[(shape, causal, window, dtype)] = rel
        if row is not None:
            rows[(shape, window)] = row
    first = rows[(K5B_TRAIN[0][0], K5B_TRAIN[0][2])]
    return {"max_abs_err": worst, **first,
            "rel_frobenius_worst": max(max(r.values())
                                       for r in sound.values()),
            "at_4096": rows[(K5B_TRAIN[1][0], K5B_TRAIN[1][2])],
            "qwen": rows[(K5B_TRAIN[2][0], K5B_TRAIN[2][2])]}


def check_k7b(dev, time_ms, call_ms, max_err, card):
    """Phase 12(b): K7 keeping its fp32 states against its plain version,
    then K7b against its plain version, both fed K7's states, at phase 9's
    K7 cases in fp32 (h0 nonzero) and at the layer shape in fp32 and bf16,
    each run twice and compared byte for byte; its times at the layer
    shape.  Returns K7b's entry of the kernels line
    (bf16), all but ``launches``."""
    import torch
    from repro_torch.kernels import rglru as RG
    names = ("dx", "dgx", "dga", "dlog_a", "dh0")
    cases = [(shape, torch.float32) for shape in K7_SHAPES] + [
        (K7_LAYER, torch.float32), (K7_LAYER, torch.bfloat16)]
    worst, times = 0.0, {}
    for i, (shape, dtype) in enumerate(cases):
        x, gx, ga, la, h0 = rglru_inputs(shape, dtype, dev, seed=50 + i)
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        bf = dtype == torch.bfloat16
        # the forward that training runs (K7 keeping its fp32 states, its
        # own template instance): y at K7's bar and equal to the serving
        # instance's, the states within K7's fp32 bar, as the card tests
        y, h32 = RG.rglru_scan(x, gx, ga, la, h0, keep_states=True)
        want_y, want_h = RG.rglru_scan_plain(x, gx, ga, la, h0,
                                             keep_states=True)
        ytol = 1e-2 if bf else 1e-4
        y_err = max_err(y, want_y, ytol, ytol, f"K7 {shape} {dtype} y")
        h_err = max_err(h32, want_h, 1e-4, 1e-4, f"K7 {shape} {dtype} h32")
        if not torch.equal(y, RG.rglru_scan(x, gx, ga, la, h0)):
            raise AssertionError(f"K7 {shape} {dtype}: y keeping the states "
                                 f"differs from the serving instance's")
        del y, want_y, want_h
        run = lambda: RG.rglru_scan_bwd(x, gx, ga, la, h0, h32, dy)
        got, again = run(), run()
        want = RG.rglru_scan_bwd_plain(x, gx, ga, la, h0, h32, dy)
        err = 0.0
        for name, gg, ww in zip(names, got, want):
            # fp32: K7's bar (1e-4; dlog_a, a sum of B x S terms in another
            # order, 1e-3 relative); bf16 outputs one rounding apart (1e-2)
            tol = (1e-3 if name in ("dlog_a", "dh0") else 1e-2) if bf \
                else 1e-4
            rtol = 1e-3 if name == "dlog_a" else tol
            err = max(err, max_err(gg, ww, rtol, tol,
                                   f"K7b {shape} {dtype} {name}"))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K7b {shape} {dtype}: two calls differ")
        worst = max(worst, err)
        line = (f"K7b rglru_scan_bwd B,S,W={shape} {dtype} h0=True: K7 "
                f"keeping its states: y max_abs_err={y_err:.3e} (rtol=atol="
                f"{ytol}), equal to the serving instance's, h32 "
                f"{h_err:.3e} (1e-4); five gradients max_abs_err="
                f"{err:.3e}; a second call byte-equal")
        if shape == K7_LAYER:
            ms = time_ms(run, reps=5)
            plain = time_ms(lambda: RG.rglru_scan_bwd_plain(
                x, gx, ga, la, h0, h32, dy), reps=2)
            bnd, by = k7b_bound(*shape, dtype)
            times[dtype] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                            "bound_by": by}
            line += (f"; ms={ms:.4f} (per Python call "
                     f"{call_ms(run, reps=5):.4f}) plain_ms={plain:.4f} "
                     f"library_ms=none bound_ms={bnd:.4f} ({by}); K7's "
                     f"chunked scan walked backward, plan "
                     f"{RG.launch_plan(*shape)}; card {card}")
        print(line)
    return {"max_abs_err": worst, **times[torch.bfloat16],
            "library_ms": None, "float32": times[torch.float32]}


class training_config:
    """Within the block, ``launch.train.train`` builds ``cfg`` for
    ``cfg.name`` (the registered model's widths, at its depth or a cut
    one), and each step it runs is timed (host clock to a synchronize) and
    its kernel launches counted by ``counters``; checkpoints are recorded,
    not written (phase 10(e) holds a written one to its bytes).  ``last``
    keeps the step and the trees it updated in place last, so a profiled
    step after the run trains on from them.  ``grad_peak`` and
    ``update_peak`` are each step's peak allocated GB up to its AdamW
    update (the forward and backward) and within it."""

    def __init__(self, cfg, counters):
        self.cfg, self.counters = cfg, counters
        self.step_ms, self.launches, self.saved = [], [], []
        self.grad_peak, self.update_peak = [], []
        self.last = None

    def __enter__(self):
        import torch
        from repro_torch.launch import train as TR
        self.real = (TR.get_arch, TR.ST.make_train_step, TR.ckpt.save,
                     TR.ST.adamw.apply_)
        TR.get_arch = lambda name: (self.cfg if name == self.cfg.name
                                    else self.real[0](name))

        def update(*args, **kw):
            self.grad_peak.append(torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            out = self.real[3](*args, **kw)
            self.update_peak.append(torch.cuda.max_memory_allocated() / 1e9)
            return out

        def make_train_step(cfg, tcfg, **kw):
            step = self.real[1](cfg, tcfg, **kw)

            def timed(params, opt, batch):
                before = [c.launches for c in self.counters]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = step(params, opt, batch)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.launches.append([c.launches - b for c, b in
                                      zip(self.counters, before)])
                self.last = (step, out[0], out[1], batch)
                return out
            return timed

        TR.ST.make_train_step = make_train_step
        TR.ST.adamw.apply_ = update
        TR.ckpt.save = lambda d, step, tree, **kw: self.saved.append(step)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train as TR
        (TR.get_arch, TR.ST.make_train_step, TR.ckpt.save,
         TR.ST.adamw.apply_) = self.real


class plain_versions:
    """Within the block K5, K5b, K7 and K7b are their plain versions,
    swapped into ``kernels.flash_attention`` and ``kernels.rglru``, where
    ``FlashAttention`` and ``RGLRUScan`` look them up."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import rglru as RG
        self.real = (FA.flash_attention, FA.flash_attention_bwd,
                     RG.rglru_scan, RG.rglru_scan_bwd)

        def plain_fwd(q, k, v, *, causal, window, return_lse=False, **pos):
            return FA.flash_attention_plain(q, k, v, causal=causal,
                                            window=window,
                                            return_lse=return_lse, **pos)

        FA.flash_attention = plain_fwd
        FA.flash_attention_bwd = FA.flash_attention_bwd_plain
        RG.rglru_scan = RG.rglru_scan_plain
        RG.rglru_scan_bwd = RG.rglru_scan_bwd_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import rglru as RG
        (FA.flash_attention, FA.flash_attention_bwd, RG.rglru_scan,
         RG.rglru_scan_bwd) = self.real


def grad_check(cfg32, batch, dev, counted, want_n, what, card):
    """Phase 12(c): the loss and every gradient leaf of ``value_and_grad``
    at fp32 with K5/K5b/K7/K7b, and with their plain versions swapped into
    ``kernels.flash_attention`` and ``kernels.rglru``: loss within 1e-5,
    leaves within 1e-3 relative Frobenius (phase 10(c)'s bars).
    ``counted`` are the four kernels, ``want_n`` their launches."""
    import contextlib

    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    params = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    drawn = (draw_attn_leaves(params, torch.Generator(device=dev)
                              .manual_seed(2))
             if cfg32.qk_norm or cfg32.attention == "mla" else [])
    runs = {}
    for name in ("kernel", "plain"):
        before = [c.launches for c in counted]
        with (plain_versions() if name == "plain"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = ST.value_and_grad(cfg32, params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        n = [c.launches - b for c, b in zip(counted, before)]
        if n != (want_n if name == "kernel" else [0] * len(counted)):
            raise AssertionError(f"{what} fp32 gradients ({name}): K5/K5b/"
                                 f"K7/K7b launches {n}")
        runs[name] = (loss.item(), T.tree_leaves(grads), ms)
        del loss, grads
    (lk, gk, ms_k), (lp, gp, ms_p) = runs["kernel"], runs["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    rels = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for a, b in zip(gk, gp)]
    finite = all(torch.isfinite(a).all() for a in gk)
    if not (finite and rel_loss <= 1e-5 and max(rels) <= 1e-3):
        raise AssertionError(f"{what} fp32 gradients, kernels vs plain: loss "
                             f"rel err {rel_loss:.3e} (limit 1e-5), leaf rel "
                             f"errs {[f'{r:.2e}' for r in rels]} (limit "
                             f"1e-3)")
    B, S = batch["tokens"].shape
    print(f"fp32 gradients {what} ({describe(cfg32)}"
          f"{f'; {drawn} drawn nonzero' if drawn else ''}; TF32 off, batch "
          f"{B}, seq {S}): loss {lk:.6f}, K5/K5b/K7/K7b (launches {want_n}) "
          f"vs their plain versions: loss rel err {rel_loss:.3e} (limit "
          f"1e-5), {len(rels)} gradient leaves, worst rel Frobenius err "
          f"{max(rels):.3e} (limit 1e-3); host ms kernel {ms_k:.3f}, plain "
          f"{ms_p:.3f}; card {card}")


class plain_attention_counted:
    """Within the block, calls of the plain attention (K5's and K5b's plain
    versions, ``layers._attn_block``) are counted in ``calls``."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models import layers as L
        self.calls = 0
        self.real = [(m, n, getattr(m, n)) for m, n in (
            (FA, "flash_attention_plain"), (FA, "flash_attention_bwd_plain"),
            (L, "_attn_block"))]
        for m, n, fn in self.real:
            setattr(m, n, self.counting(fn))
        return self

    def counting(self, fn):
        def run(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return run

    def __exit__(self, *exc):
        for m, n, fn in self.real:
            setattr(m, n, fn)


def train_counted(cfg, run, what, counted, names, want, card, falling=True):
    """``launch.train.train(cfg.name, smoke=False)`` within
    ``training_config`` (and ``plain_attention_counted``): every step's
    launches of the ``counted`` kernels (``names``) must be ``want``, no
    plain attention may run, the losses must be finite (and fall, where
    ``falling``) and the last step checkpointed.  Prints the losses, step
    times, tokens/s and the steps' peak memory, up to the update and
    within it; returns (the record, the losses, the
    launches in all by name)."""
    import torch
    from repro_torch.launch import train as TR
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for c in counted:
        c.launches = 0
    with training_config(cfg, counted) as rec, \
            plain_attention_counted() as plain:
        t0 = time.perf_counter()
        losses = TR.train(cfg.name, smoke=False, steps=run["steps"],
                          batch=run["batch"], seq=run["seq"],
                          log_every=run["steps"])
        wall = time.perf_counter() - t0
    grad_gb, update_gb = max(rec.grad_peak), max(rec.update_peak)
    peak_gb = max(grad_gb, update_gb)
    for i, n in enumerate(rec.launches):
        if dict(zip(names, n)) != want:
            raise AssertionError(f"train {what} step {i + 1}: launches "
                                 f"{dict(zip(names, n))}, want {want}")
    total = dict(zip(names, (c.launches for c in counted)))
    if not (len(losses) == run["steps"]
            and all(math.isfinite(l) for l in losses)
            and (losses[-1] < losses[0] or not falling)
            and rec.saved == [run["steps"]] and plain.calls == 0):
        raise AssertionError(f"train {what}: losses {losses}, checkpoints "
                             f"{rec.saved}, plain attention calls "
                             f"{plain.calls}")
    B, S = run["batch"], run["seq"]
    med = statistics.median(rec.step_ms[2:])
    print(f"train {what} through launch.train.train(smoke=False) ("
          f"{describe(cfg)}; remat {cfg.remat}, AdamW with fp32 moments "
          f"updated in place, no gradient compression, warm-up 2 of "
          f"{run['steps']} steps): "
          f"batch {B} x seq {S}: losses {[round(l, 4) for l in losses]}; "
          f"step ms {[round(t, 3) for t in rec.step_ms]}; median of "
          f"steps 3-{run['steps']} {med:.3f} ms, "
          f"{B * S / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB (the steps' forward and backward "
          f"{grad_gb:.2f}, their in-place AdamW update {update_gb:.2f}); "
          f"{wall:.1f} s in train(); launches a step "
          + ", ".join(f"{k} {v}" for k, v in want.items() if v)
          + f", no other kernel, no plain attention; card {card}")
    return rec, losses, total


def drive_train_hybrid(dev, counters, time_ms, call_ms, max_err, randn,
                       card):
    """Phase 12: training beyond Mamba-2.  K5b and K7b against their plain
    versions; RecurrentGemma-2B (one period) and qwen3-8b (2 layers) at
    full width, their fp32 loss and gradients with K5/K5b/K7/K7b and with
    the plain versions; ``launch.train.train`` of RecurrentGemma-2B at full
    width and depth (26 layers, 10 bf16 steps under remat, K7 36, K7b 18,
    K5 16, K5b 8 launches a step: the forwards twice, with their recompute,
    and no other kernel, profiled) and of qwen3-8b over 4 of 36 (5 steps,
    K5 8 and K5b 4 a step); K1 refusing to cut an autograd graph.
    ``counters`` are main's launch counters (K1, K2, K5, K6, K8,
    K7).  Returns (K5b's and K7b's entries of the kernels line, K5's and
    K7's launches on this phase's training paths)."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.systolic_matmul import systolic_matmul
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()

    def lap(what):
        print(f"phase 12: {what} in {time.perf_counter() - t0:.1f} s")

    # ---- 12(a), 12(b): K5b and K7b ---------------------------------------
    k5b_entry = check_k5b(time_ms, call_ms, max_err, randn, card)
    torch.cuda.empty_cache()
    lap("12(a), K5b")
    k7b_entry = check_k7b(dev, time_ms, call_ms, max_err, card)
    torch.cuda.empty_cache()
    lap("12(a)-(b), K5b and K7b")

    # ---- 12(c): fp32, TF32 off: the gradients against the plain versions --
    four = (flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd)
    gemma = gemma_config()
    cfg32 = dataclasses.replace(gemma, num_layers=GEMMA_GRAD["layers"],
                                dtype="float32")
    batch = TokenStream(gemma, GEMMA_GRAD["batch"], GEMMA_GRAD["seq"], 0,
                        device=dev).batch_at(0)
    r = 2 if cfg32.remat else 1       # K5's and K7's recompute under remat
    grad_check(cfg32, batch, dev, four, [r, 1, 2 * r, 2],
               f"{GEMMA} (one period)", card)
    torch.cuda.empty_cache()
    qwen = qwen_config("qwen3-8b")
    cfg32 = as_fp32(qwen_config("qwen3-8b", QWEN_GRAD["layers"]))
    batch = TokenStream(qwen, QWEN_GRAD["batch"], QWEN_GRAD["seq"], 0,
                        device=dev).batch_at(0)
    grad_check(cfg32, batch, dev, four, [2 * r, 2, 0, 0], "qwen3-8b", card)
    del batch
    torch.cuda.empty_cache()
    lap("12(a)-(c), with the fp32 gradients")

    # ---- 12(d), 12(e): the sixth path, training through launch.train -----
    counted = counters + (flash_attention_bwd, rglru_scan_bwd,
                          SSD.ssd_scan_bwd, VE.quantize_int8,
                          VE.dequantize_int8)
    names = ("K1", "K2", "K5", "K6", "K8", "K7", "K5b", "K7b", "K8b", "K3",
             "K4")
    path_launches = {"K5": 0, "K7": 0, "K5b": 0, "K7b": 0}

    def counted_train(cfg, run, what, falling=True):
        kinds = [cfg.block_pattern[j % len(cfg.block_pattern)]
                 for j in range(cfg.num_layers)]
        r = 2 if cfg.remat else 1     # the forward and its recompute
        want = dict.fromkeys(names, 0)
        want.update(K5=r * kinds.count("attn"), K5b=kinds.count("attn"),
                    K7=r * kinds.count("rglru"), K7b=kinds.count("rglru"))
        rec, losses, total = train_counted(cfg, run, what, counted, names,
                                           want, card, falling)
        for k in path_launches:
            path_launches[k] += total[k]
        return rec, losses

    print(f"{GEMMA} trained at full width and depth ({gemma.num_layers} "
          f"layers, {T.count_params(gemma)} parameters: "
          f"{TRAIN_BYTES * T.count_params(gemma) / 1e9:.1f} GB of "
          f"parameters, gradients and moments at {TRAIN_BYTES} bytes a "
          f"parameter, updated in place, before activations; remat "
          f"{gemma.remat})")
    what = f"{GEMMA} ({gemma.num_layers} layers)"
    rec, _ = counted_train(gemma, GEMMA_TRAIN, what)
    step, params, opt, batch = rec.last
    B, S = GEMMA_TRAIN["batch"], GEMMA_TRAIN["seq"]
    profile_run(f"train step {what} (B={B}, S={S}",
                lambda: step(params, opt, batch)[2]["loss"].item(), 1,
                {"K5b": ("flash_bwd",), "K5": ("flash_bf16_kernel",),
                 "K7b": ("rglru_bwd",), "K7": ("rglru_chunked_kernel",)},
                "step", card)
    del rec, step, params, opt, batch
    torch.cuda.empty_cache()
    lap("12(a)-(d), with RecurrentGemma-2B's training")

    qcfg = qwen_config("qwen3-8b", QWEN_TRAIN["layers"])
    print(f"qwen3-8b cut to {QWEN_TRAIN['layers']} of 36 layers for training "
          f"({T.count_params(qcfg)} parameters, about "
          f"{TRAIN_BYTES * T.count_params(qcfg) / 1e9:.1f} GB at "
          f"{TRAIN_BYTES} bytes a parameter; all 36 layers need "
          f"{TRAIN_BYTES * T.count_params(qwen) / 1e9:.1f} GB)")
    what = f"qwen3-8b ({QWEN_TRAIN['layers']} layers)"
    rec, losses = counted_train(qcfg, QWEN_TRAIN, what, falling=False)
    step, params, opt, batch = rec.last
    profile_run(f"train step {what} (B={QWEN_TRAIN['batch']}, "
                f"S={QWEN_TRAIN['seq']}",
                lambda: step(params, opt, batch)[2]["loss"].item(), 1,
                {"K5b": ("flash_bwd",), "K5": ("flash_bf16_kernel",)},
                "step", card)
    del rec, step, params, opt, batch
    torch.cuda.empty_cache()
    # Its first two steps again with K5/K5b's plain versions: the same
    # schedule (warm-up 2) and batches, so the same losses up to bf16's
    # rounding, whatever way the loss then moves
    before = [c.launches for c in counted]
    with plain_versions(), training_config(qcfg, counted):
        plain = TR.train(qcfg.name, smoke=False, steps=2,
                         batch=QWEN_TRAIN["batch"], seq=QWEN_TRAIN["seq"],
                         log_every=2)
    n = [c.launches - b for c, b in zip(counted, before)]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    if any(n) or not (rel[0] <= 1e-2 and rel[1] <= 5e-2):
        raise AssertionError(f"train {what}: losses {losses[:2]} with K5/K5b "
                             f"against {plain} with their plain versions "
                             f"(limits 1e-2, 5e-2 relative), launches {n}")
    print(f"train {what}, first two steps with K5/K5b's plain versions "
          f"swapped in: losses {[round(l, 4) for l in plain]} against "
          f"{[round(l, 4) for l in losses[:2]]} (rel {rel[0]:.2e}, "
          f"{rel[1]:.2e}; limits 1e-2, 5e-2): K5/K5b do not set the "
          f"loss's course")
    torch.cuda.empty_cache()

    # ---- 12(f): a kernel without a backward refuses to cut the graph ------
    gen = torch.Generator(device=dev).manual_seed(40)
    x = torch.randn(64, 32, generator=gen, device=dev)
    w = torch.randn(32, 16, generator=gen, device=dev).requires_grad_()
    before = systolic_matmul.launches
    try:
        ops.matmul(x, w)
    except NotImplementedError as e:
        msg = str(e)
    else:
        raise AssertionError("ops.matmul under requires_grad returned a "
                             "tensor cut off from the autograd graph")
    if systolic_matmul.launches != before:
        raise AssertionError("ops.matmul launched K1 under requires_grad")
    print(f"K1 under requires_grad: NotImplementedError, no launch "
          f"({msg.split(';')[0]})")

    src = "src/repro_torch/kernels/csrc/"
    entries = [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/models/layers.py:129",
         "launches": path_launches["K5b"],
         "shape": list(K5B_TRAIN[0][0]), "dtype": "bfloat16",
         "causal": True, "window": GEMMA_WINDOW, **k5b_entry},
        {"name": "rglru_scan_bwd", "route": "cuda", "source": src + "rglru.cu",
         "replaces": "src/repro/models/layers.py:253",
         "launches": path_launches["K7b"], "shape": list(K7_LAYER),
         "dtype": "bfloat16", **k7b_entry},
    ]
    return entries, path_launches["K5"], path_launches["K7"]


class k5b_shapes:
    """Within the block, K5b's launches at each of K5B_VLM's shapes are
    counted, one counter a shape whose ``launches`` ``train_counted`` reads
    a step as it reads the kernels' own.  The wrapper swapped into
    ``kernels.flash_attention``, where ``FlashAttention`` looks K5b up,
    adds one where K5b launched."""

    def __init__(self):
        import types
        self.counters = {name: types.SimpleNamespace(launches=0)
                         for name in K5B_VLM}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        real = self.real = FA.flash_attention_bwd
        by_shape = {shape: self.counters[name]
                    for name, (shape, _, _) in K5B_VLM.items()}

        def counting(q, k, v, *args, **kw):
            # K5b counts its launch on the module's name, which is this
            # wrapper while the block runs: carry the count over to K5b's
            counting.launches = real.launches
            out = real(q, k, v, *args, **kw)
            n, real.launches = (counting.launches - real.launches,
                                counting.launches)
            key = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                   q.shape[3], v.shape[3])
            if key in by_shape:
                by_shape[key].launches += n
            return out
        FA.flash_attention_bwd = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as FA
        FA.flash_attention_bwd = self.real


def drive_train_vlm(dev, counters, time_ms, call_ms, max_err, randn, card):
    """Phase 15: training of MLA (minicpm3-4b), ViT-632M and Whisper-medium,
    every attention gradient on K5b.  (a) ``k5b_case`` in fp32 at
    K5B_FP32's shapes and masks with each new (Dqk, Dv) pair and in bf16 at
    K5B_VLM's training shapes (planted faults, SDPA's backward and each of
    its fused backends alone); (b) the fp32 loss and every gradient leaf of
    each model at full width over VLM_GRAD's layers with K5/K5b and with
    their plain versions (``grad_check``); (c) each trained in bf16 at full
    width through ``launch.train.train`` (``train_counted``), batch 4, 5
    steps under remat: minicpm3-4b, ViT-632M and Whisper-medium whole, K5
    launched twice an attention a step (its forward and recompute: 124, 64
    and 144) and K5b once (62, 32 and 72), each of K5B_VLM's shapes
    counted on its own
    (``k5b_shapes``), no other kernel and no plain attention, each
    profiled, and its first two steps again with K5/K5b's plain versions.
    ``counters`` are main's launch counters (K1, K2, K5, K6, K8, K7).
    Returns (K5b's rows at K5B_VLM's shapes with their counted launches,
    K5's and K5b's launches on this phase's training paths)."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()

    def lap(what):
        print(f"phase 15: {what} in {time.perf_counter() - t0:.1f} s")

    # ---- 15(a): K5b at the new pairs and the training shapes -------------
    worst, sound, rows = 0.0, {}, {}
    cases = [(shape[:5] + pair, causal, window, torch.float32)
             for pair in K5B_PAIRS for shape in K5B_FP32
             for causal, window in K5B_MASKS]
    cases += [(shape, causal, 0, torch.bfloat16)
              for shape, causal, _ in K5B_VLM.values()]
    for shape, causal, window, dtype in cases:
        err, rel, row = k5b_case(shape, causal, window, dtype, time_ms,
                                 call_ms, max_err, randn, card,
                                 backends=True)
        worst = max(worst, err)
        sound[(shape, causal, window, dtype)] = max(rel.values())
        if row is not None:
            rows[shape] = row
    print(f"K5b at the new pairs {K5B_PAIRS}: {len(cases)} cases, "
          f"max_abs_err={worst:.3e}, worst relative Frobenius fp32 "
          f"{max(v for k, v in sound.items() if k[3] == torch.float32):.3e}"
          f", bf16 "
          f"{max(v for k, v in sound.items() if k[3] == torch.bfloat16):.3e}"
          f" (limits {K5B_REL['float32']}, {K5B_REL['bfloat16']})")
    lap("15(a), K5b")

    # ---- 15(b): fp32, TF32 off: the gradients against the plain versions --
    four = (flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd)
    full = {name: (vlm_config(name) if name != "whisper-medium"
                   else paper_config(name)) for name in VLM_TRAIN}
    for name, cut in VLM_GRAD.items():
        cfg32 = as_fp32(full[name], **cut)
        run = VLM_TRAIN[name]
        batch = TokenStream(cfg32, 2, run["seq"], 0,
                            device=dev).batch_at(0)
        n = k5_per_prefill(cfg32)
        r = 2 if cfg32.remat else 1   # K5's recompute under remat
        grad_check(cfg32, batch, dev, four, [r * n, n, 0, 0],
                   f"{name} ({', '.join(f'{k} {v}' for k, v in cut.items())})",
                   card)
        del batch
        torch.cuda.empty_cache()
    lap("15(a)-(b), with the fp32 gradients")

    # ---- 15(c): bf16 training at full width -------------------------------
    shapes = k5b_shapes()
    counted = counters + (flash_attention_bwd,) + tuple(
        shapes.counters.values())
    names = ("K1", "K2", "K5", "K6", "K8", "K7", "K5b") + tuple(
        f"K5b@{name}" for name in K5B_VLM)
    path = {"K5": 0, "K5b": 0}
    out = {}
    kernels = {"K5b": ("flash_bwd",), "K5": ("flash_bf16_kernel",)}
    for name, run in VLM_TRAIN.items():
        cfg = full[name]
        print(f"{name} trained at full width and depth ({cfg.num_layers} "
              f"layers, {T.count_params(cfg)} parameters: "
              f"{TRAIN_BYTES * T.count_params(cfg) / 1e9:.1f} GB of "
              f"parameters, gradients and moments at {TRAIN_BYTES} bytes a "
              f"parameter, updated in place, before activations; remat "
              f"{cfg.remat})")
        n = k5_per_prefill(cfg)
        want = dict.fromkeys(names, 0)
        want.update(K5=(2 if cfg.remat else 1) * n, K5b=n)
        for shape_name, (_, _, model) in K5B_VLM.items():
            if model == name:
                want[f"K5b@{shape_name}"] = (
                    cfg.encoder_layers if shape_name == "whisper_encoder"
                    else cfg.num_layers)
        what = f"{name} ({cfg.num_layers} layers" + (
            f" + {cfg.encoder_layers} encoder layers" * bool(
                cfg.encoder_layers)) + ")"
        with shapes:
            rec, losses, total = train_counted(cfg, run, what, counted,
                                               names, want, card,
                                               falling=False)
        for k in path:
            path[k] += total[k]
        for shape_name, (shape, causal, model) in K5B_VLM.items():
            if model == name:
                key = f"K5b@{shape_name}"
                out[shape_name] = {
                    "shape": list(shape), "dtype": "bfloat16",
                    "causal": causal, "window": 0, "model": model,
                    "launches_a_step": rec.launches[-1][names.index(key)],
                    "launches": total[key], **rows[shape]}
        step, params, opt, batch = rec.last
        B, S = run["batch"], run["seq"]
        profile_run(f"train step {what} (B={B}, S={S}",
                    lambda: step(params, opt, batch)[2]["loss"].item(), 1,
                    kernels, "step", card)
        del rec, step, params, opt, batch
        torch.cuda.empty_cache()
        # the first two steps again with K5/K5b's plain versions: the same
        # schedule and batches, so the same losses up to bf16's rounding
        before = [c.launches for c in counted]
        with plain_versions(), training_config(cfg, counted):
            plain = TR.train(cfg.name, smoke=False, steps=2, batch=B, seq=S,
                             log_every=2)
        n_plain = [c.launches - b for c, b in zip(counted, before)]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        if any(n_plain) or not (rel[0] <= 1e-2 and rel[1] <= 5e-2):
            raise AssertionError(f"train {what}: losses {losses[:2]} with "
                                 f"K5/K5b against {plain} with their plain "
                                 f"versions (limits 1e-2, 5e-2 relative), "
                                 f"launches {n_plain}")
        print(f"train {what}, first two steps with K5/K5b's plain versions "
              f"swapped in: losses {[round(l, 4) for l in plain]} against "
              f"{[round(l, 4) for l in losses[:2]]} (rel {rel[0]:.2e}, "
              f"{rel[1]:.2e}; limits 1e-2, 5e-2)")
        torch.cuda.empty_cache()
        lap(f"15(a)-(c), with {name}'s training")

    out["max_abs_err"] = worst
    out["rel_frobenius_worst"] = max(sound.values())
    return out, path["K5"], path["K5b"]



# ---------------------------------------------------------------------------
# Phase 16: the mesh — qwen3-moe-235b-a22b served over meshes of ranks
# ---------------------------------------------------------------------------

# qwen3-moe-235b-a22b (hf:Qwen/Qwen3-30B-A3B family) at full width over
# meshes of ranks that share the one card: 4 processes, a gloo group on
# CUDA tensors (NCCL refuses two ranks on one device).  Each mesh and its
# MoE form: (1, 4) moe_ffn_ep (32 experts a rank, the whole batch), (2, 2)
# moe_ffn_ep (64 experts a rank, a data block of 2 prompts, capacity
# counted over the block), (2, 2) moe_ffn_ep_resident (64 experts' halves
# of F a rank).
MESH_MODEL = "qwen3-moe-235b-a22b"
MESH_CASES = [((1, 4), "ep"), ((2, 2), "ep"), ((2, 2), "ep_resident")]
# (a) and (b), fp32 with TF32 off: 1 layer, batch 4 x 1024 prompt, 1
# decode step fed the one-card run's greedy token.  Cut from 2 layers and 4
# decode steps: every call over a mesh gathers every split leaf of every
# layer (at 2 layers 4.16 GB received at (1, 4) and 7.75 GB at (2, 2) in
# fp32, 0.37-0.48 GB/s over gloo on an H100's host).  Weights from seed
# 1.  (a)'s capacity factor is 8, not 16: at 16 the (2, 2) ep ranks would
# each add a 2.15 GB dispatch buffer to their stored blocks and one
# layer's gathered leaves (4.83 GB of experts; the 2.49 GB head), near the
# card's 80 GB with four CUDA contexts.  At 8 the one-card run checks that
# no expert's load passes its capacity, over the batch and over each data
# block, so nothing drops and the result is 16's (and any larger
# factor's).  (b) at the config's own 1.25, where assignments drop.
MESH_EXACT = {"layers": 1, "batch": 4, "prompt": 1024, "decode": 1,
              "capacity": 8.0, "seed": 1}
# (c), bf16, served by launch.serve.serve: depth 1 of 94 layers (cut from
# 4: with 2 a (2, 2) call took 12 s, at 0.33 GB/s of gathers).  A rank
# stores its TRAIN_RULES block of every leaf: at (1, 4) the embedding and
# head over model and a layer's experts over model, at (2, 2) the experts
# over model and their D over data too, and gathers one layer at a time
# as it runs it (at 4 layers 2.30 GB received a call at (1, 4), 6.51 GB at
# (2, 2); 1.25 GB of it the embedding and head).
# While a rank places its weights it draws one stacked expert leaf of all
# L layers in fp32 (3.22 L GB) and cuts its block.  The one card serves
# gen tokens; a mesh serves mesh_gen (cut from 16: each token gathers
# every layer's split leaves again), after a warm-up prefill (the first
# call pins gloo's host buffers: 16.0 s against 6.1 s warm at (1, 4)).
MESH_SERVE = {"layers": 1, "batch": 4, "prompt": 1024, "gen": 16,
              "mesh_gen": 2}
# The bars: fp32, phase 11's 1e-3 relative Frobenius over the
# last-position logits and the same argmax; bf16, 2e-2 (K5_REL's bf16
# bar).  In bf16 the expert-parallel path rounds each MoE output element
# more often than one card does: each weighted expert output, the rank's
# partial sum, then each add of gloo's ring (3 over 4 ranks), up to 2^-9
# each, where (a) reads ~1e-6 in fp32 from the order of the sums alone;
# through 4 layers' residual stream that comes to about 1e-2 of the
# logits on an H100 (PERF.md).
MESH_REL = {"float32": 1e-3, "bfloat16": 2e-2}
MESH_TIMEOUT_S = 900
# TP's compute split at full width: qwen3-8b (D 4096, 32 heads x 128 with
# 8 kv heads, d_ff 12288, vocabulary 151,936 padded to 152,064) over 2 of
# its 36 layers on (1, 4) under TP_RULES, weights from seed 0 as serve
# draws them: a rank stores a quarter of every dense leaf (its heads,
# channels and vocabulary block; the norms whole) and computes with it,
# so a forward reshards nothing.  The forward over a batch of 4 x 1024
# prompts in bf16 (K5 at (4, 8, KV 2, 1024, 128) a rank; its psums
# counted), the fp32 forward's last-position logits against one card's
# within TP_REL in relative Frobenius error (TF32 off; only the order of
# the row-parallel sums differs), and serve's prefill (K5 on the rank's
# heads) and 8 greedy tokens, decode computing on the same blocks against
# the cache split along the sequence (258 of the 1024 + 8 positions a
# rank; no weight resharded): the bf16 tokens against one card's
# reported, an fp32 serve of SPLIT_FP32_GEN tokens held equal to one
# card's on every rank, its prefill logits within TP_REL.
TP_MODEL = "qwen3-8b"
TP_RUN = {"shape": (1, 4), "layers": 2, "batch": 4, "prompt": 1024,
          "gen": 8}
TP_REL = 1e-5
# (e) the families whose decode mixers compute on TP's blocks against the
# cache split over model along the sequence, at full width over the same
# (1, 4) TP_RULES ranks, weights from seed 0 as serve draws them: each
# served in bf16 (timed, with no warm-up serve: the ranks' gloo buffers
# are pinned by the cases before; its tokens against one card's
# reported, not held) and in fp32 with TF32 off over SPLIT_FP32_GEN
# tokens (the last prefill logits within TP_REL of one card's, every
# rank's tokens equal to one card's).  Cut from 8 tokens and a warm-up
# each: the run took 1,056 s on an H100 with them (1,050 s is the
# aim).  minicpm3-4b over 2 of its 62 layers (40 heads, 10 a
# rank; the latent cache 256 positions a rank), Mamba-2 370M over 2 of 48
# (the SSD state's 32 heads, 8 a rank; a prompt of 4 ssm_chunk),
# RecurrentGemma-2B over one pattern group (rglru, rglru, attn) at a
# 4096-token prompt (the ring of W 2048, 512 slots a rank; its 10 heads
# do not divide over 4, so attention is computed whole), Whisper-medium
# over 2 decoder and 2 encoder layers (xk/xv's 1500 frames, 375 a rank;
# zero frames, serve's stub).
SPLIT_RUNS = {
    "minicpm3-4b": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
    "mamba2-370m": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
    "recurrentgemma-2b": {"layers": 3, "batch": 4, "prompt": 4096,
                          "gen": 4},
    "whisper-medium": {"layers": 2, "batch": 4, "prompt": 384, "gen": 4},
}
SPLIT_FP32_GEN = 4
# (f) DECODE_RULES over (2, 2) at full width, on the same 4 ranks: the
# weights 2-D resident (in-dim over data, out-dim over model: no leaf
# moves in serving), the residual stream split over data along d_model,
# every data rank the whole batch of 4 prompts against its block of the
# cache (its 2 rows, the sequence over model).  Each case as (d) and (e)
# configure it, so their one-card serves are the references: qwen3-8b
# over 2 of its 36 layers (K5 at (4, 16, KV 4) a rank), minicpm3-4b over
# 2 of 62 (its latents normed over their whole width, 40 heads 20 a rank;
# K5 at (4, 20, KV 20, 96/64)), Mamba-2 370M over 2 of 48 (the SSD block
# resident, its state cut by batch and heads).  bf16 timed (its tokens
# against one card's reported), fp32 with TF32 off checked (the last
# prefill logits within TP_REL, every rank's tokens equal to one card's).
DECODE2D_SHAPE = (2, 2)
DECODE2D_RUNS = {
    "qwen3-8b": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
    "minicpm3-4b": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
    "mamba2-370m": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
}

# (g) SEQPAR_RULES over (1, 4) at full width, on the same 4 ranks: the
# prefill's residual stream split over model along the sequence between
# blocks (256 of the 1024 prompt rows a rank; each block gathers the
# normed rows, its row-parallel sums reduce-scatters; the last logits from
# the last rank's row), a decode token whole.  Each case as (d) and (e)
# configure it, so their one-card serves are the references: qwen3-8b
# over 2 of its 36 layers, Mamba-2 370M over 2 of 48 (the SSD block
# computed whole, its output cut to the rank's rows).  bf16 timed, fp32
# (TF32 off) held: the last prefill logits within TP_REL, tokens equal.
SEQPAR_SHAPE = (1, 4)
SEQPAR_RUNS = {
    "qwen3-8b": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
    "mamba2-370m": {"layers": 2, "batch": 4, "prompt": 1024, "gen": 4},
}


def seqpar_prefill_collectives(cfg, model):
    """(reduce-scatters, all-gathers) of the sequence that a
    ``SEQPAR_RULES`` prefill of ``cfg`` issues over ``model`` ranks:
    the embedding's vocabulary sum; an attention layer's ``wo`` and
    ``w2`` sums, and its gathers of the normed rows for the cache's K/V,
    for attention and for the MLP; an SSD layer's one gather (computed
    whole, its output cut); the last rows' gather for the logits."""
    rs = int(cfg.padded_vocab % model == 0)
    ag = 1
    for j in range(cfg.num_layers):
        if cfg.block_pattern[j % len(cfg.block_pattern)] == "attn":
            rs, ag = rs + 2, ag + 3
        else:
            ag += 1
    return rs, ag


def split_config(name, layers, dtype=None):
    """A family of (e) at full width, checked as its phase checks it, cut
    to ``layers`` (Whisper's encoder to as many), in ``dtype`` where
    given."""
    import dataclasses
    if name == "minicpm3-4b":
        return vlm_config(name, layers, dtype)
    cfg = {"mamba2-370m": mamba_config, "recurrentgemma-2b": gemma_config,
           "whisper-medium": lambda: paper_config(name)}[name]()
    kw = {"encoder_layers": layers} if cfg.encoder_layers else {}
    return dataclasses.replace(cfg, num_layers=layers,
                               dtype=dtype or cfg.dtype, **kw)


def decode_reshards(cfg, shard):
    """The leaves a decode step over ``shard`` reshards: those whose
    compute block is not the block a rank stores (``transformer.
    placement``: only the leaves ``compute_defs`` keeps whole, and under
    FSDP the data split), in the layers and the embedding, positions,
    final norm and head it reads."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import transformer as T
    place = T.placement(cfg, shard)
    if place is None:
        return 0
    defs = T.param_defs(cfg)
    groups = cfg.num_layers // len(cfg.block_pattern)

    def moved(d, ls, k=1):
        return k * sum(C.moves(len(pd.shape), sp.storage, sp.compute,
                               shard.mesh)
                       for pd, sp in zip(T.tree_leaves(d),
                                         T.tree_leaves(ls)))
    top = ["embed", "final_norm",
           "embed" if cfg.tie_embeddings else "lm_head"] + [
               "pos_embed"] * (cfg.rope == "learned")
    return (moved(defs["blocks"], place.specs["blocks"], groups)
            + moved(defs["rem"], place.specs["rem"])
            + sum(moved(defs[k], place.specs[k]) for k in top))


def mesh_config(layers, dtype=None, **kw):
    """qwen3-moe-235b-a22b at full width over ``layers`` of its 94, in
    ``dtype`` where given, with ``kw`` replaced."""
    import dataclasses
    cfg = qwen_config(MESH_MODEL, layers)
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype, **kw)


class collectives_counted:
    """Within the block every ``dist.all_reduce`` and ``dist.all_gather``
    is counted: calls, bytes of the tensor each is given, and the host's
    seconds inside it between two synchronizes of the card (so the time is
    the collective's, not the card's queued work); the all-gathers also
    on their own (``gathers``: calls, bytes given, seconds), and the
    placement's reshards that move a weight's block (``reshards``: leaves
    and the bytes of the blocks given)."""

    def __init__(self, sync):
        self.sync, self.calls, self.nbytes, self.s = sync, 0, 0, 0.0
        self.gathers = [0, 0, 0.0]
        self.reshards = [0, 0]

    def snap(self):
        return ((self.calls, self.nbytes, self.s) + tuple(self.gathers)
                + tuple(self.reshards))

    def since(self, snap):
        return {"calls": self.calls - snap[0], "bytes": self.nbytes - snap[1],
                "host_ms": (self.s - snap[2]) * 1e3,
                "gather_calls": self.gathers[0] - snap[3],
                "gather_bytes": self.gathers[1] - snap[4],
                "gather_ms": (self.gathers[2] - snap[5]) * 1e3,
                "reduce_calls": (self.calls - snap[0]) - (
                    self.gathers[0] - snap[3]),
                "reduce_bytes": (self.nbytes - snap[1]) - (
                    self.gathers[1] - snap[4]),
                "reshards": self.reshards[0] - snap[6],
                "reshard_bytes": self.reshards[1] - snap[7]}

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.distributed import collectives as C
        self.real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
        self.real_reshard = real_reshard = C.reshard

        def reshard(x, src, dst, mesh):
            # a weight's stored block taken to another compute block
            if C.moves(x.dim(), src, dst, mesh):
                self.reshards[0] += 1
                self.reshards[1] += x.numel() * x.element_size()
            return real_reshard(x, src, dst, mesh)
        C.reshard = reshard

        def wrap(name, fn):
            def counted(*args, **kw):
                t = args[0] if name == "all_reduce" else args[1]
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.sync()
                dt = time.perf_counter() - t0
                self.s += dt
                self.calls += 1
                self.nbytes += t.numel() * t.element_size()
                if name == "all_gather":
                    self.gathers[0] += 1
                    self.gathers[1] += t.numel() * t.element_size()
                    self.gathers[2] += dt
                return out
            return counted

        for name, fn in self.real.items():
            setattr(dist, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from repro_torch.distributed import collectives as C
        for name, fn in self.real.items():
            setattr(dist, name, fn)
        C.reshard = self.real_reshard


def rank_bytes(cfg, mesh, batch_axes, batch, seq, kind="train", rules=None):
    """The dry run's count of what a rank holds on ``mesh`` for a ``kind``
    step of ``batch`` x ``seq`` tokens under ``rules`` (None:
    ``TRAIN_RULES``)
    (``launch.dryrun.cell_blocks``): ``params``, the bytes of its blocks of
    every parameter; ``moment``, of one fp32 AdamW moment (the reduced
    gradient's blocks), for a train step; ``arguments``, of the step's
    arguments (parameters, for a train step the AdamW state, and the
    batch); and ``whole_leaf``, the bytes the placement before the spec's
    held: every dense leaf whole, each expert leaf in the MoE layout's
    compute block for a batch split over ``batch_axes``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    blocks = DR.cell_blocks(cfg, ShapeConfig("rank", kind, seq, batch), mesh,
                            rules)
    out = {"params": DR.tree_nbytes(blocks["params"]),
           "arguments": DR.tree_nbytes(blocks)}
    if kind == "train":
        out["moment"] = DR.tree_nbytes(blocks["opt"].mu)
    layout = moe_ep.moe_layout(cfg, mesh, batch_axes)
    out["whole_leaf"] = sum(
        math.prod(SH.block_shape(pd.shape, SH.compute_spec(pd.axes, layout),
                                 mesh)) * T._dtype(pd, cfg).itemsize
        for pd in T.tree_leaves(T.param_defs(cfg)))
    return out


def tree_bytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def in_turns(place, dev, stats=None, keep=False):
    """``place`` (``transformer.place_params``) run by one rank after the
    other: ranks sharing a card draw their weights one at a time, each
    holding one whole fp32 leaf at a time, and hand back the cache before
    the next starts.  ``stats`` gets the bytes of the rank's tree and its
    peak while placing, and with ``keep`` the tree (``"tree"``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.tree import tree_leaves

    def run(*args, **kw):
        out = None
        for r in range(dist.get_world_size()):
            if r == dist.get_rank():
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                out = place(*args, **kw)
                if stats is not None:
                    stats["param_bytes"] = sum(t.numel() * t.element_size()
                                               for t in tree_leaves(out))
                    stats["place_peak_gb"] = (
                        torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else 0.0)
                    if keep:
                        stats["tree"] = out
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
            dist.barrier()
        return out
    return run


class k5_shapes:
    """Within the block, K5's launches outside autograd (``ops.attention``
    calls ``ops.flash_attention``) counted by shape (B, H, KV, Sq, Skv,
    D) in ``seen``."""

    def __enter__(self):
        from repro_torch.kernels import ops
        real = self.real = ops.flash_attention
        self.seen = {}

        def recording(q, k, v, *args, **kw):
            key = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                   q.shape[3])
            self.seen[key] = self.seen.get(key, 0) + 1
            return real(q, k, v, *args, **kw)
        ops.flash_attention = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.real


def forward_recorded(cfg, params, tok, dev, shard=None):
    """``transformer.forward`` of ``cfg`` over the prompts ``tok`` (over a
    mesh, ``shard``, the rank's batch block and its blocks of the
    weights), timed, with K5's launches by shape and the collectives
    (calls, bytes, host ms; the reshards' all-gathers apart; counted
    collectives synchronize the card), and the last position's logits
    gathered whole over the vocabulary and the batch (fp32, host)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if shard is not None:
        dist.barrier()
    with torch.no_grad(), k5_shapes() as k5, collectives_counted(sync) as c:
        sync()
        c0, t0 = c.snap(), time.perf_counter()
        logits = T.forward(cfg, params, tok, shard=shard)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        row = c.since(c0)
        last = T.gather_vocab(cfg, logits[:, -1:], shard)[:, 0].float()
    del logits
    if shard is not None:
        last = SV.gather_batch(last, shard.mesh, shard.batch_axes)
    return {"ms": ms, "k5": dict(k5.seen), "logits": last.cpu(), **row}


def serve_recorded(cfg, run, dev, mesh=None, rules=None, forward=False,
                   warm=True):
    """``launch.serve.serve`` of ``cfg`` (its registry name patched to
    ``cfg``) on one card, or over ``mesh`` from a rank under ``rules``
    (None: ``TRAIN_RULES``; its weights placed ``in_turns``, each rank's
    bytes held to the sum of its spec blocks),
    after a warm-up serve of at most 256 tokens and 2 (over a mesh 1: a
    prefill alone; every call there is bound by the layers' all-gathers)
    where ``warm``, with what the step functions saw: the prefill's
    last-position logits (the whole batch, fp32, on the host), K5's
    launches (the prefill's by shape too) and the collectives (calls,
    bytes, host ms; the all-gathers and the reshards apart) of the
    prefill and of each decode step, the bytes of the cache the decode
    steps hold, and the peak memory while serving; with ``forward``,
    then ``forward_recorded`` over the served prompts with the served
    weights."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as SV

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rec = {"decode": []}
    coll = collectives_counted(sync)
    steps, real_place = SV.ST, SV.T.place_params
    real_p, real_d = steps.make_prefill_step, steps.make_decode_step

    def recorded(make, what):
        def made(*args, **kw):
            step = make(*args, **kw)

            def call(*a):
                c0, k0 = coll.snap(), flash_attention.launches
                with k5_shapes() as k5:
                    out = step(*a)
                row = {"k5": flash_attention.launches - k0,
                       "k5_shapes": dict(k5.seen), **coll.since(c0)}
                if what == "prefill":
                    rec["prefill"] = row
                    rec["logits"] = out[0][:, -1].float()
                else:
                    rec["decode"].append(row)
                    rec["cache_bytes"] = tree_bytes(out[1])
                return out
            return call
        return made

    stats = {}
    rules = SH.resolve_rules(rules)
    steps.make_prefill_step = recorded(real_p, "prefill")
    steps.make_decode_step = recorded(real_d, "decode")
    if mesh is not None:
        SV.T.place_params = in_turns(real_place, dev, stats)
    try:
        with serving_config(cfg), coll:
            if warm:
                SV.serve(cfg.name, smoke=False, device=dev, mesh=mesh,
                         rules=rules, batch=run["batch"],
                         prompt=min(256, run["prompt"]),
                         gen=2 if mesh is None else 1)
            rec["decode"] = []
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            if forward and mesh is not None:
                SV.T.place_params = in_turns(real_place, dev, stats,
                                             keep=True)
            out = SV.serve(cfg.name, smoke=False, device=dev, mesh=mesh,
                           rules=rules, **run)
            logits = rec["logits"]
            if mesh is not None:
                baxes = SH.batch_axes(run["batch"], rules, mesh)
                logits = SV.gather_batch(logits, mesh, baxes)
                held = rank_bytes(cfg, mesh, baxes, run["batch"],
                                  run["prompt"], "prefill", rules)
                stats["spec_bytes"] = held["params"]
                stats["whole_leaf_bytes"] = held["whole_leaf"]
                if stats["param_bytes"] != stats["spec_bytes"]:
                    raise AssertionError(
                        f"phase 16(c): a rank holds {stats['param_bytes']} "
                        f"bytes of weights, its spec blocks "
                        f"{stats['spec_bytes']}")
    finally:
        steps.make_prefill_step, steps.make_decode_step = real_p, real_d
        SV.T.place_params = real_place
    fwd = None
    if forward:
        from repro_torch.data.pipeline import RequestStream
        tok = torch.from_numpy(RequestStream(
            cfg, run["batch"], run["prompt"], 0).requests_at(0)["tokens"])
        shard = None
        if mesh is None:
            params = SV.T.init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), device=dev)
        else:
            params = stats.pop("tree")
            shard = SH.make_act_sharder(mesh, baxes, rules)
            tok = SH.local_block(tok, SH.batch_spec(tuple(tok.shape), rules,
                                                    mesh), mesh)
        fwd = forward_recorded(cfg, params, tok.to(dev), dev, shard)
        if shard is not None:
            # the split leaves' bytes a rank holds and the whole leaves'
            from repro_torch.tree import tree_leaves
            split = [(t, pd) for t, pd, sp in zip(
                tree_leaves(params), tree_leaves(SV.T.param_defs(cfg)),
                tree_leaves(SV.T.param_block_specs(cfg, mesh, rules),
                            is_leaf=SH.is_spec)) if sp]
            fwd.update(
                placement_none=SV.T.placement(cfg, shard) is None,
                split_bytes=sum(t.numel() * t.element_size()
                                for t, _ in split),
                whole_split_bytes=sum(math.prod(pd.shape) * t.element_size()
                                      for t, pd in split))
        del params
        if cuda:
            torch.cuda.empty_cache()
    return {"generated": torch.from_numpy(out["generated"]),
            "forward": fwd,
            "prefill_ms": out["prefill_s"] * 1e3,
            "decode_ms": out["decode_s_per_token"] * 1e3,
            "logits": logits.cpu(), "prefill": rec["prefill"],
            "decode": rec["decode"], "cache_bytes": rec.get("cache_bytes"),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else 0.0, **stats}


def exact_reference(cfg, tok, n, dev, low):
    """(a) and (b) on one card: the gather path's prefill of ``tok`` (fp32,
    weights from ``MESH_EXACT``'s seed), ``n`` greedy decode steps (the
    tokens fed and each step's logits), each layer's most loaded expert
    over the batch and over each half (the (2, 2) meshes' data blocks),
    then the prefill at capacity factor ``low`` over the batch and over
    each half on its own.  Logits on the host, weights freed."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import decode as DE
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_EXACT["seed"]), device=dev)
    tok = tok.to(dev)
    B, S = tok.shape
    real, loads = L.moe_ffn, []

    def recording(x, gate_w, *args, num_experts, k, **kw):
        top = torch.topk(torch.softmax((x @ gate_w).float(), -1), k).indices
        half = top.shape[0] // 2
        loads.append([int(torch.bincount(t.flatten(), minlength=num_experts)
                          .max()) for t in (top, top[:half], top[half:])])
        return real(x, gate_w, *args, num_experts=num_experts, k=k, **kw)

    out = {}
    L.moe_ffn = recording
    try:
        with torch.no_grad():
            logits, cache = DE.prefill(cfg, params, tok)
    finally:
        L.moe_ffn = real
    out["loads"] = loads
    with torch.no_grad():
        out["prefill"] = logits[:, -1].float().cpu()
        cache = _grow_cache(cfg, cache, B, S + n)
        feed = []
        for i in range(n):
            feed.append(logits[:, -1].argmax(-1)[:, None].to(torch.int32))
            logits, cache = DE.decode_step(cfg, params, cache, feed[-1])
            out[f"decode{i}"] = logits[:, -1].float().cpu()
        out["feed"] = torch.cat(feed, dim=1).cpu()
        del cache
        cfg_low = dataclasses.replace(cfg, moe_capacity_factor=low)
        out["prefill_low"] = DE.prefill(cfg_low, params, tok)[0][:, -1] \
            .float().cpu()
        out["prefill_low_blocks"] = torch.cat(
            [DE.prefill(cfg_low, params, part)[0][:, -1].float().cpu()
             for part in tok.split(B // 2)])
    del params, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def exact_on_mesh(cfg, tok, feed, low, mesh, dev):
    """(a) and (b) on this rank: weights placed in turns from the seed the
    one-card run drew from, the prefill of the rank's block of ``tok``,
    decode steps fed the rank's block of ``feed``, then the prefill at
    capacity factor ``low``; every logits row gathered over the batch's
    blocks (fp32, host)."""
    import dataclasses

    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    rules = SH.TRAIN_RULES
    B, S = tok.shape
    baxes = SH.batch_axes(B, rules, mesh)
    params = in_turns(T.place_params, dev)(
        cfg, torch.Generator(device=dev).manual_seed(MESH_EXACT["seed"]),
        mesh, device=dev)
    spec = SH.batch_spec((B, S), rules, mesh)
    tl = SH.local_block(tok, spec, mesh).to(dev)
    fl = SH.local_block(feed, spec, mesh).to(dev)
    gather = lambda lg: SV.gather_batch(lg[:, -1].float(), mesh, baxes)
    kw = dict(mesh=mesh, batch_axes=baxes)
    out = {}
    with torch.no_grad():
        logits, cache = ST.make_prefill_step(cfg, **kw)(params, {"tokens": tl})
        out["prefill"] = gather(logits)
        cache = SV._grow_cache(cfg, cache, tl.shape[0], S + feed.shape[1],
                               shard=SH.make_act_sharder(mesh, baxes, rules),
                               seq=S)
        step = ST.make_decode_step(cfg, seq=S + feed.shape[1], **kw)
        for i in range(feed.shape[1]):
            logits, cache = step(params, cache, {"tokens": fl[:, i:i + 1]})
            out[f"decode{i}"] = gather(logits)
        del cache
        cfg_low = dataclasses.replace(cfg, moe_capacity_factor=low)
        out["prefill_low"] = gather(ST.make_prefill_step(cfg_low, **kw)(
            params, {"tokens": tl})[0])
    del params, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_on_mesh(tp, mesh, dev):
    """Phase 16's TP case on this rank (``TP_RULES`` over ``mesh``): the
    bf16 ``serve`` of ``tp["cfg"]`` and the forward over its prompts with
    the served weights (``serve_recorded``), the fp32 ``serve`` of
    ``SPLIT_FP32_GEN`` tokens, then the fp32 forward's last-position
    logits with the fp32 weights placed in turns from the same seed."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    rules = SH.TP_RULES
    run = {k: tp["run"][k] for k in ("batch", "prompt", "gen")}
    out = {"serve": serve_recorded(tp["cfg"], run, dev, mesh, rules,
                                   forward=True)}
    out["serve"]["cache_spec_bytes"] = cache_spec_bytes(tp["cfg"], mesh, run,
                                                        rules)
    empty_host_cache()
    out["serve32"] = serve_recorded(tp["cfg32"], dict(run, gen=SPLIT_FP32_GEN),
                                    dev, mesh, rules, warm=False)
    empty_host_cache()
    cfg32 = tp["cfg32"]
    B, S = run["batch"], run["prompt"]
    baxes = SH.batch_axes(B, rules, mesh)
    params = in_turns(T.place_params, dev)(
        cfg32, torch.Generator(device=dev).manual_seed(0), mesh, rules=rules,
        device=dev)
    tok = SH.local_block(tp["tokens"], SH.batch_spec((B, S), rules, mesh),
                         mesh).to(dev)
    out["fp32"] = forward_recorded(cfg32, params, tok, dev,
                                   SH.make_act_sharder(mesh, baxes, rules))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cache_spec_bytes(cfg, mesh, run, rules):
    """The bytes of a rank's blocks of the cache of ``run``'s capacity
    (prompt + gen) on ``mesh`` under ``rules``: the dry run's count
    (``launch.dryrun.cell_blocks``, the JAX package's spec)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun as DR
    return DR.tree_nbytes(DR.cell_blocks(
        cfg, ShapeConfig("rank", "decode", run["prompt"] + run["gen"],
                         run["batch"]), mesh, rules)["cache"])


def split_on_mesh(split, mesh, dev, rules=None):
    """(e) on this rank (``TP_RULES`` over ``mesh``; (f) ``DECODE_RULES``
    and (g) ``SEQPAR_RULES`` where ``rules`` says): for each family, the
    bf16 ``serve`` (timed) and the fp32 one (its ``fp32_run``), each with
    the bytes of the rank's cache beside its spec blocks'
    (``launch.dryrun.cell_blocks``), the reshards a decode step should
    make (``decode_reshards``) and the sequence's collectives
    (``seq_counted``: the prefill's, a token splitting none)."""
    import torch

    from repro_torch.distributed import sharding as SH
    rules = rules or SH.TP_RULES
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = []
    for case in split:
        row = {}
        for key in ("bf16", "fp32"):
            cfg, run = case[key], case[key + "_run"]
            with seq_counted(sync) as seqc:
                sv = serve_recorded(cfg, run, dev, mesh, rules, warm=False)
            sv["seq"] = seqc.rows
            empty_host_cache()
            baxes = SH.batch_axes(run["batch"], rules, mesh)
            sv["cache_spec_bytes"] = cache_spec_bytes(cfg, mesh, run, rules)
            sv["want_reshards"] = decode_reshards(
                cfg, SH.make_act_sharder(mesh, baxes, rules))
            row[key] = sv
        out.append(row)
    return out


def mesh_rank(rank, world, store_dir, job):
    """One rank of phase 16's meshes (started once by
    ``launch.mesh.run_ranks`` for all of ``job["cases"]``, so the ranks
    start once): on the card's one device, in a gloo group, for each mesh
    (a) and (b) (``exact_on_mesh``), then (c) (``serve_recorded``,
    ``mesh_gen`` tokens), then (d), (e), (f) (``DECODE_RULES`` over
    ``DECODE2D_SHAPE``) and (g) (``SEQPAR_RULES`` over ``SEQPAR_SHAPE``),
    timed, the pinned host cache emptied after each
    (four ranks' caches of every mesh's buffers and the parent passed the
    96 GiB of host memory of an H100 host); its results to
    ``job["out"]/rank<r>.pt``."""
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, job["src"])
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    M.init_group(store_dir, rank, world, "gloo", timeout_s=MESH_TIMEOUT_S)
    res = []
    for case in job["cases"]:
        t0 = time.perf_counter()
        mesh = M.make_mesh(case["shape"], ("data", "model"),
                           device=job["device"])
        row = {"exact": exact_on_mesh(case["exact_cfg"], job["tokens"],
                                      job["feed"], job["low"], mesh, dev)}
        empty_host_cache()
        row["serve"] = serve_recorded(case["serve_cfg"], job["serve_run"],
                                      dev, mesh, forward=True)
        row["host_gb"] = host_available_gb()
        empty_host_cache()
        dist.barrier()
        row["s"] = time.perf_counter() - t0
        res.append(row)
    t0 = time.perf_counter()
    tp = job["tp"]
    mesh = M.make_mesh(tp["run"]["shape"], ("data", "model"),
                       device=job["device"])
    row = tp_on_mesh(tp, mesh, dev)
    row["host_gb"] = host_available_gb()
    empty_host_cache()
    dist.barrier()
    row["s"] = time.perf_counter() - t0
    res.append(row)
    t0 = time.perf_counter()
    row = {"split": split_on_mesh(job["split"], mesh, dev)}
    dist.barrier()
    row["s"] = time.perf_counter() - t0
    res.append(row)
    t0 = time.perf_counter()
    from repro_torch.distributed import sharding as SH
    mesh = M.make_mesh(DECODE2D_SHAPE, ("data", "model"),
                       device=job["device"])
    row = {"split": split_on_mesh(job["decode2d"], mesh, dev,
                                  SH.DECODE_RULES)}
    dist.barrier()
    row["s"] = time.perf_counter() - t0
    res.append(row)
    t0 = time.perf_counter()
    mesh = M.make_mesh(SEQPAR_SHAPE, ("data", "model"), device=job["device"])
    row = {"split": split_on_mesh(job["seqpar"], mesh, dev,
                                  SH.SEQPAR_RULES)}
    dist.barrier()
    row["s"] = time.perf_counter() - t0
    res.append(row)
    torch.save(res, os.path.join(job["out"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def drive_mesh(dev, card):
    """Phase 16: qwen3-moe-235b-a22b at full width over (1, 4) ``ep``,
    (2, 2) ``ep`` and (2, 2) ``ep_resident`` meshes of 4 ranks sharing the
    card (``mesh_rank``; gloo; the kernels built here first).  (a) fp32,
    ``MESH_EXACT``: each mesh's prefill and decode logits against the
    one-card gather path on the same weights and tokens, nothing dropped;
    (b) at capacity factor 1.25, (1, 4) ``ep`` and (2, 2) resident against
    the one-card path over the batch, (2, 2) ``ep`` against it over each
    data block; (c) bf16 ``serve`` at ``MESH_SERVE`` (``mesh_gen`` tokens
    over a mesh): the (1, 4) ``ep`` mesh's first greedy tokens equal to
    the one-card ``serve``'s and its prefill logits within ``MESH_REL``,
    K5 once a layer in every rank's prefill, each rank's weight bytes
    equal to its ``TRAIN_RULES`` blocks (beside the whole-leaf placement's
    figure), and the times, gathers, collectives and memory of each mesh;
    then the forward over the served prompts with the served weights on
    each rank (TP's compute split: K5 at the rank's heads, the last
    position's logits within ``MESH_REL``'s bf16 bar of the served
    prefill's).  (d) TP at full width (``TP_RUN``): qwen3-8b over (1, 4)
    ``TP_RULES``, every rank's served tokens equal to one card's, the bf16
    forward with K5 at (4, 8, KV 2) a rank and no reshard, each rank's
    split leaves a quarter of the whole leaves' bytes, the fp32 forward's
    last-position logits within ``TP_REL`` of one card's, the served
    prefill's K5 at the rank's heads, no weight resharded in serving,
    each rank's cache its spec blocks' bytes (the sequence split over
    ``model``).  (e) the families of ``SPLIT_RUNS`` over the same ranks
    (``split_on_mesh``, ``check_split``).  Returns K5's launches in the
    meshes' served prefills and forwards, summed over ranks, and those
    at the TP ranks' shapes by (H, KV, Sq, Skv, D)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.data.pipeline import RequestStream
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    _build.build_all()
    root = Path(__file__).resolve().parent
    run_c = {k: MESH_SERVE[k] for k in ("batch", "prompt", "gen")}
    run_m = dict(run_c, gen=MESH_SERVE["mesh_gen"])
    B, S, n = MESH_EXACT["batch"], MESH_EXACT["prompt"], MESH_EXACT["decode"]
    cfg32 = mesh_config(MESH_EXACT["layers"], "float32",
                        moe_capacity_factor=MESH_EXACT["capacity"])
    low = qwen_config(MESH_MODEL).moe_capacity_factor
    tok = torch.from_numpy(RequestStream(cfg32, B, S, 0).requests_at(0)
                           ["tokens"])
    t0 = time.perf_counter()
    ref = exact_reference(cfg32, tok, n, dev, low)
    E, k = cfg32.num_experts, cfg32.experts_per_token
    cap = lambda T_: max(8, math.ceil(T_ * k * MESH_EXACT["capacity"] / E))
    over = [row for row in ref["loads"]
            if row[0] > cap(B * S) or max(row[1:]) > cap(B * S // 2)]
    if over:
        raise AssertionError(f"phase 16(a): an expert's load passes its "
                             f"capacity ({cap(B * S)} over the batch, "
                             f"{cap(B * S // 2)} over a data block): most "
                             f"loaded per layer {ref['loads']}")
    print(f"phase 16 one-card fp32 reference {cfg32.name} "
          f"({describe(cfg32)}; TF32 off, B={B}, S={S}, weights seed "
          f"{MESH_EXACT['seed']}): most loaded expert per layer over the "
          f"batch / each data block {ref['loads']}, capacity "
          f"{cap(B * S)} / {cap(B * S // 2)} at factor "
          f"{MESH_EXACT['capacity']}: nothing drops; {n} greedy decode "
          f"steps; prefills at factor {low} over the batch and over each "
          f"block; {time.perf_counter() - t0:.1f} s")
    # (d)'s one-card runs: the bf16 serve and forward, the fp32 forward
    cfg_tp = qwen_config(TP_MODEL, TP_RUN["layers"])
    cfg_tp32 = as_fp32(cfg_tp)
    run_tp = {k: TP_RUN[k] for k in ("batch", "prompt", "gen")}
    tok_tp = torch.from_numpy(RequestStream(cfg_tp, run_tp["batch"],
                                            run_tp["prompt"], 0)
                              .requests_at(0)["tokens"])
    t0 = time.perf_counter()
    one_tp = serve_recorded(cfg_tp, run_tp, dev, forward=True)
    one_tp32s = serve_recorded(cfg_tp32, dict(run_tp, gen=SPLIT_FP32_GEN),
                               dev, warm=False)
    params = T.init_params(cfg_tp32, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    one_tp32 = forward_recorded(cfg_tp32, params, tok_tp.to(dev), dev)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 16(d) one card {cfg_tp.name} ({describe(cfg_tp)}): serve "
          f"batch {run_tp['batch']}, prompt {run_tp['prompt']}, gen "
          f"{run_tp['gen']}: prefill_ms={one_tp['prefill_ms']:.3f} "
          f"decode_ms_per_token={one_tp['decode_ms']:.3f}; the bf16 "
          f"forward over the prompts {one_tp['forward']['ms']:.3f} ms, K5 "
          f"{one_tp['forward']['k5']}; the fp32 forward "
          f"{one_tp32['ms']:.3f} ms; {time.perf_counter() - t0:.1f} s; "
          f"card {card}")
    # (e)'s one-card runs: each family's bf16 and fp32 serves
    split, one_split = [], []
    for name, r in SPLIT_RUNS.items():
        run = {k: r[k] for k in ("batch", "prompt", "gen")}
        case = {"name": name, "bf16": split_config(name, r["layers"]),
                "bf16_run": run,
                "fp32": split_config(name, r["layers"], "float32"),
                "fp32_run": dict(run, gen=SPLIT_FP32_GEN)}
        t0 = time.perf_counter()
        one_split.append({k: serve_recorded(case[k], case[k + "_run"], dev,
                                            warm=False)
                          for k in ("bf16", "fp32")})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        o = one_split[-1]["bf16"]
        print(f"phase 16(e) one card {name} ({case['bf16'].num_layers} "
              f"layers at full width, bf16): serve batch {run['batch']}, "
              f"prompt {run['prompt']}, gen {run['gen']}: "
              f"prefill_ms={o['prefill_ms']:.3f} "
              f"decode_ms_per_token={o['decode_ms']:.3f}, K5 a prefill "
              f"{o['prefill']['k5_shapes']}; the fp32 serve of "
              f"{SPLIT_FP32_GEN} tokens too; "
              f"{time.perf_counter() - t0:.1f} s; card {card}")
        split.append(case)
    # (f)'s and (g)'s cases: (d)'s and (e)'s configurations, their
    # one-card serves the references
    def referenced(runs, what):
        cases, refs = [], []
        for name, r in runs.items():
            run = {k: r[k] for k in ("batch", "prompt", "gen")}
            if name == TP_MODEL:
                cfgs, one_ref = (cfg_tp, cfg_tp32), {"bf16": one_tp,
                                                     "fp32": one_tp32s}
                same = run == dict(run_tp, gen=run["gen"])
            else:
                i = list(SPLIT_RUNS).index(name)
                cfgs = (split[i]["bf16"], split[i]["fp32"])
                one_ref, same = one_split[i], run == split[i]["bf16_run"]
            if not (same and cfgs[0].num_layers == r["layers"]):
                raise AssertionError(f"phase 16{what} {name}: {r} is not "
                                     f"the run its one-card reference "
                                     f"served")
            cases.append({"name": name, "bf16": cfgs[0], "bf16_run": run,
                          "fp32": cfgs[1],
                          "fp32_run": dict(run, gen=SPLIT_FP32_GEN)})
            refs.append(one_ref)
        return cases, refs

    decode2d, one_decode2d = referenced(DECODE2D_RUNS, "(f)")
    seqpar, one_seqpar = referenced(SEQPAR_RUNS, "(g)")
    cfg16 = mesh_config(MESH_SERVE["layers"])
    one = serve_recorded(cfg16, run_c, dev)
    if one["prefill"]["k5"] != cfg16.num_layers:
        raise AssertionError(f"phase 16 one-card serve: K5 "
                             f"{one['prefill']['k5']} a prefill")
    print(f"phase 16 one-card serve {cfg16.name} ({describe(cfg16)}): batch "
          f"{run_c['batch']}, prompt {run_c['prompt']}, gen {run_c['gen']}: "
          f"prefill_ms={one['prefill_ms']:.3f} decode_ms_per_token="
          f"{one['decode_ms']:.3f}; K5 {one['prefill']['k5']} a prefill; "
          f"peak {one['peak_gb']:.2f} GB; first tokens "
          f"{one['generated'][:, 0].tolist()}; card {card}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    vocab = slice(0, cfg32.vocab_size)

    def held(got, want, bar, what):
        got, want = got[:, vocab], want[:, vocab]
        rel = ((got - want).norm() / want.norm()).item()
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        if not (torch.isfinite(got).all() and rel <= bar and same):
            raise AssertionError(f"phase 16 {what}: rel Frobenius err "
                                 f"{rel:.3e} (limit {bar}), same argmax "
                                 f"{same}")
        return rel

    k5_mesh, k5_tp = 0, {}

    def tp_launches(seen):
        for (b, h, kv, sq, skv, d), n in seen.items():
            key = (h, kv, sq, skv, d)
            k5_tp[key] = k5_tp.get(key, 0) + n

    world = math.prod(MESH_CASES[0][0])
    assert all(math.prod(shape) == world for shape, _ in MESH_CASES)
    out = root / "build" / "phase16"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    job = {"src": str(root / "src"), "device": str(dev), "tokens": tok,
           "feed": ref["feed"], "low": low, "serve_run": run_m,
           "out": str(out),
           "cases": [{"shape": shape,
                      "exact_cfg": dataclasses.replace(cfg32, moe_impl=impl),
                      "serve_cfg": dataclasses.replace(cfg16, moe_impl=impl)}
                     for shape, impl in MESH_CASES],
           "tp": {"run": TP_RUN, "cfg": cfg_tp, "cfg32": cfg_tp32,
                  "tokens": tok_tp},
           "split": split, "decode2d": decode2d, "seqpar": seqpar}
    host0 = host_available_gb()
    t0 = time.perf_counter()
    M.run_ranks(mesh_rank, world, job, timeout_s=MESH_TIMEOUT_S)
    print(f"phase 16 meshes: {len(MESH_CASES)} meshes of {world} ranks on "
          f"the one card (gloo), one start of the ranks: "
          f"{time.perf_counter() - t0:.1f} s; host memory available before "
          f"{host0:.1f} GB; card {card}")
    by_rank = [torch.load(out / f"rank{r}.pt") for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    for i, (shape, impl) in enumerate(MESH_CASES):
        name = f"({shape[0]}, {shape[1]}) {impl}"
        ranks = [r[i] for r in by_rank]
        wall = ranks[0]["s"]
        ex = ranks[0]["exact"]
        # (a): the one-card path, nothing dropped
        rel_a = [held(ex["prefill"], ref["prefill"], MESH_REL["float32"],
                      f"(a) {name} prefill")]
        rel_a += [held(ex[f"decode{i}"], ref[f"decode{i}"],
                       MESH_REL["float32"], f"(a) {name} decode step {i}")
                  for i in range(n)]
        # (b): capacity 1.25, against its counterpart
        blocks = shape[0] > 1 and impl == "ep"
        rel_b = held(ex["prefill_low"], ref["prefill_low_blocks" if blocks
                                            else "prefill_low"],
                     MESH_REL["float32"], f"(b) {name}")
        # (c): served in bf16
        sv = [r["serve"] for r in ranks]
        for r, s in enumerate(sv):
            if not torch.equal(s["generated"], sv[0]["generated"]):
                raise AssertionError(f"phase 16(c) {name}: rank {r}'s tokens "
                                     f"differ from rank 0's")
            if s["prefill"]["k5"] != cfg16.num_layers or any(
                    d["k5"] for d in s["decode"]):
                raise AssertionError(f"phase 16(c) {name} rank {r}: K5 "
                                     f"{s['prefill']['k5']} a prefill (want "
                                     f"{cfg16.num_layers}), decode "
                                     f"{[d['k5'] for d in s['decode']]}")
        gen_tok = sv[0]["generated"]
        if not (gen_tok.shape == (run_m["batch"], run_m["gen"])
                and ((0 <= gen_tok) & (gen_tok < cfg16.vocab_size)).all()):
            raise AssertionError(f"phase 16(c) {name}: generated "
                                 f"{tuple(gen_tok.shape)}")
        got, want = sv[0]["logits"][:, vocab], one["logits"][:, vocab]
        rel_c = ((got - want).norm() / want.norm()).item()
        first = torch.equal(gen_tok[:, 0], one["generated"][:, 0])
        agree = float((gen_tok == one["generated"][:, :run_m["gen"]])
                      .float().mean())
        if shape == (1, 4) and not (rel_c <= MESH_REL["bfloat16"] and first):
            raise AssertionError(f"phase 16(c) {name}: prefill logits rel "
                                 f"err {rel_c:.3e} (limit "
                                 f"{MESH_REL['bfloat16']}), first tokens "
                                 f"{gen_tok[:, 0].tolist()} vs one card "
                                 f"{one['generated'][:, 0].tolist()}")
        k5_mesh += sum(s["prefill"]["k5"] for s in sv)
        # the forward over the served prompts: TP's compute split
        want_k5 = {(run_m["batch"] // shape[0],
                    cfg16.num_heads // shape[1],
                    cfg16.num_kv_heads // shape[1], run_m["prompt"],
                    run_m["prompt"], cfg16.resolved_head_dim):
                   cfg16.num_layers}
        fw = [s["forward"] for s in sv]
        for r, f in enumerate(fw):
            lg = sv[r]["logits"][:, vocab]
            rel_f = ((f["logits"][:, vocab] - lg).norm() / lg.norm()).item()
            if f["k5"] != want_k5 or not rel_f <= MESH_REL["bfloat16"]:
                raise AssertionError(
                    f"phase 16(c) {name} rank {r}: the forward's K5 "
                    f"launches {f['k5']} (want {want_k5}), its last "
                    f"logits vs the served prefill's rel err {rel_f:.3e} "
                    f"(limit {MESH_REL['bfloat16']})")
            k5_mesh += sum(f["k5"].values())
            tp_launches(f["k5"])
        bar = (f" (limit {MESH_REL['bfloat16']})" if shape == (1, 4)
               else " (not held: capacity or F split apart from one card's)")
        pre = sv[0]["prefill"]
        dec = sv[0]["decode"][-1]
        print(f"phase 16 {name}, {math.prod(shape)} ranks on the one card "
              f"(gloo): (a) fp32 prefill and {n} decode step(s) vs one "
              f"card "
              f"rel Frobenius err max {max(rel_a):.3e} (limit "
              f"{MESH_REL['float32']}), same argmax; (b) at capacity factor "
              f"{low} vs the one-card path "
              f"{'over each data block' if blocks else 'over the batch'}: "
              f"{rel_b:.3e}, same argmax; (c) bf16 serve, batch "
              f"{run_m['batch']}, prompt {run_m['prompt']}, gen "
              f"{run_m['gen']}: prefill_ms per rank "
              f"{[round(s['prefill_ms'], 3) for s in sv]} "
              f"decode_ms_per_token {[round(s['decode_ms'], 3) for s in sv]}"
              f"; prefill logits vs one card rel err {rel_c:.3e}{bar}"
              f", first tokens {'equal' if first else 'differ'} "
              f"({gen_tok[:, 0].tolist()}), {agree:.3f} of all tokens equal; "
              f"K5 launches a prefill per rank "
              f"{[s['prefill']['k5'] for s in sv]} (one a layer), none in "
              f"decode; collectives a prefill {pre['calls']} "
              f"({pre['bytes']} bytes, host ms {pre['host_ms']:.3f}; of them "
              f"the reshards' all-gathers {pre['gather_calls']}, "
              f"{pre['gather_bytes']} bytes given, host ms "
              f"{pre['gather_ms']:.3f}), a decode step {dec['calls']} "
              f"({dec['bytes']} bytes, host ms {dec['host_ms']:.3f}; "
              f"all-gathers {dec['gather_calls']}, {dec['gather_bytes']} "
              f"bytes, host ms {dec['gather_ms']:.3f}); each rank's weights "
              f"{[s['param_bytes'] for s in sv]} bytes, equal to its "
              f"TRAIN_RULES spec blocks ({sv[0]['spec_bytes']} at rank 0; "
              f"the whole-leaf placement held {sv[0]['whole_leaf_bytes']}, "
              f"{sv[0]['whole_leaf_bytes'] / sv[0]['spec_bytes'] - 1:.1%} "
              f"more); peak placing / serving per rank "
              f"{[round(s['place_peak_gb'], 2) for s in sv]} / "
              f"{[round(s['peak_gb'], 2) for s in sv]} GB; host memory "
              f"available after the serve {ranks[0]['host_gb']:.1f} GB; "
              f"{wall:.1f} s on the ranks; card {card}")
        f = fw[0]
        print(f"phase 16(c) {name} forward over the served prompts (TP's "
              f"compute split: attention's heads split over model, the "
              f"head over the vocabulary): ms per rank "
              f"{[round(x['ms'], 3) for x in fw]} (counted collectives "
              f"synchronize the card); K5 a rank {f['k5']}; collectives "
              f"{f['calls']} ({f['bytes']} bytes, host ms "
              f"{f['host_ms']:.3f}; of them the reshards' all-gathers "
              f"{f['gather_calls']}, {f['gather_bytes']} bytes, host ms "
              f"{f['gather_ms']:.3f}); last logits within the bf16 bar of "
              f"the served prefill's; card {card}")

    # (d): TP's compute split at full width, qwen3-8b over (1, 4) TP_RULES
    tp = [r[len(MESH_CASES)] for r in by_rank]
    name = f"(d) {cfg_tp.name} ({TP_RUN['shape'][0]}, {TP_RUN['shape'][1]})"
    m = TP_RUN["shape"][1]
    want_k5 = {(run_tp["batch"], cfg_tp.num_heads // m,
                cfg_tp.num_kv_heads // m, run_tp["prompt"], run_tp["prompt"],
                cfg_tp.resolved_head_dim): cfg_tp.num_layers}
    tpv = slice(0, cfg_tp.vocab_size)
    rels = []
    for r, row in enumerate(tp):
        sv, fw, f32 = row["serve"], row["serve"]["forward"], row["fp32"]
        got, want = f32["logits"][:, tpv], one_tp32["logits"][:, tpv]
        rel = ((got - want).norm() / want.norm()).item()
        rels.append(rel)
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        problems = []
        s32 = row["serve32"]
        if not torch.equal(sv["generated"], tp[0]["serve"]["generated"]):
            problems.append("bf16 tokens differ from rank 0's")
        if not torch.equal(s32["generated"], one_tp32s["generated"]):
            problems.append(f"fp32 tokens {s32['generated'].tolist()} vs "
                            f"one card's {one_tp32s['generated'].tolist()}")
        want32 = one_tp32s["logits"][:, tpv]
        rel_s = ((s32["logits"][:, tpv] - want32).norm()
                 / want32.norm()).item()
        if not rel_s <= TP_REL:
            problems.append(f"fp32 served prefill logits rel err "
                            f"{rel_s:.3e} (limit {TP_REL})")
        if any(d["reshards"] for d in s32["decode"]):
            problems.append("fp32 decode steps reshard weights")
        if (fw["k5"] != want_k5 or f32["k5"] != want_k5
                or sv["prefill"]["k5_shapes"] != want_k5):
            problems.append(f"K5 {fw['k5']} (fp32 {f32['k5']}, the served "
                            f"prefill {sv['prefill']['k5_shapes']}), want "
                            f"{want_k5}")
        if any(d["reshards"] for d in sv["decode"]) or sv["prefill"][
                "reshards"]:
            problems.append(f"weights resharded: the prefill "
                            f"{sv['prefill']['reshards']}, the decode steps "
                            f"{[d['reshards'] for d in sv['decode']]}")
        if sv["cache_bytes"] != sv["cache_spec_bytes"]:
            problems.append(f"cache {sv['cache_bytes']} bytes, its spec "
                            f"blocks {sv['cache_spec_bytes']}")
        if not (fw["placement_none"] and fw["gather_calls"] == 0
                and f32["gather_calls"] == 0):
            problems.append(f"a dense block leaf resharded: placement None "
                            f"{fw['placement_none']}, all-gathers "
                            f"{fw['gather_calls']}, fp32 "
                            f"{f32['gather_calls']}")
        if fw["split_bytes"] * m != fw["whole_split_bytes"]:
            problems.append(f"split leaves {fw['split_bytes']} bytes of "
                            f"{fw['whole_split_bytes']}")
        if not (torch.isfinite(got).all() and rel <= TP_REL and same):
            problems.append(f"fp32 last logits rel err {rel:.3e} (limit "
                            f"{TP_REL}), same argmax {same}")
        if problems:
            raise AssertionError(f"phase 16{name} rank {r}: "
                                 + "; ".join(problems))
        k5_mesh += sum(fw["k5"].values()) + sum(f32["k5"].values()) + sv[
            "prefill"]["k5"]
        tp_launches(fw["k5"])
        tp_launches(f32["k5"])
        tp_launches(sv["prefill"]["k5_shapes"])
        tp_launches(s32["prefill"]["k5_shapes"])
        k5_mesh += s32["prefill"]["k5"]
    sv, fw, f32 = tp[0]["serve"], tp[0]["serve"]["forward"], tp[0]["fp32"]
    pre, dec = sv["prefill"], sv["decode"][-1]
    diff = (sv["generated"] != one_tp["generated"]).any(0).nonzero()
    first = "none" if not len(diff) else int(diff[0])
    s32 = tp[0]["serve32"]
    rel_s = ((s32["logits"][:, tpv] - one_tp32s["logits"][:, tpv]).norm()
             / one_tp32s["logits"][:, tpv].norm()).item()
    print(f"phase 16{name} TP_RULES, {m} ranks on the one card (gloo), "
          f"{describe(cfg_tp)}: serve batch {run_tp['batch']}, prompt "
          f"{run_tp['prompt']}, gen {run_tp['gen']}: bf16 tokens equal to "
          f"one card's {first == 'none'}, first step that differs {first} "
          f"(not held: the split softmax sums in fp32 where one card rounds "
          f"its weights to bf16); fp32 (TF32 off) serve of "
          f"{SPLIT_FP32_GEN} tokens equal to one card's on every rank, its "
          f"prefill logits rel err {rel_s:.3e} (limit {TP_REL}); "
          f"prefill_ms per rank "
          f"{[round(x['serve']['prefill_ms'], 3) for x in tp]} "
          f"(one card {one_tp['prefill_ms']:.3f}), decode_ms_per_token "
          f"{[round(x['serve']['decode_ms'], 3) for x in tp]} (one card "
          f"{one_tp['decode_ms']:.3f}); the prefill's collectives "
          f"{pre['calls']} ({pre['bytes']} bytes, host ms "
          f"{pre['host_ms']:.3f}; all-gathers {pre['gather_calls']}, "
          f"{pre['gather_bytes']} bytes: the cache's K/V heads and the "
          f"logits; K5 {pre['k5_shapes']} a rank); a decode step's "
          f"collectives: all-reduces {dec['reduce_calls']} "
          f"({dec['reduce_bytes']} bytes), all-gathers {dec['gather_calls']} "
          f"({dec['gather_bytes']} bytes), reshards {dec['reshards']}, host "
          f"ms {dec['host_ms']:.3f}; each rank's cache "
          f"{[x['serve']['cache_bytes'] for x in tp]} bytes, its spec blocks "
          f"{sv['cache_spec_bytes']}; the bf16 "
          f"forward over the prompts ms per rank "
          f"{[round(x['serve']['forward']['ms'], 3) for x in tp]} (one "
          f"card {one_tp['forward']['ms']:.3f}; counted collectives "
          f"synchronize the card), no placement and no all-gather, its "
          f"psums {fw['calls']} ({fw['bytes']} bytes, host ms "
          f"{fw['host_ms']:.3f}), K5 a rank {fw['k5']}; each rank's split "
          f"leaves {fw['split_bytes']} bytes, 1/{m} of the whole leaves' "
          f"{fw['whole_split_bytes']}, all its weights "
          f"{sv['param_bytes']} (its TP_RULES spec blocks); the fp32 "
          f"forward ms per rank {[round(x['fp32']['ms'], 3) for x in tp]} "
          f"(one card {one_tp32['ms']:.3f}), psums {f32['calls']} "
          f"({f32['bytes']} bytes), last-position logits vs one card rel "
          f"Frobenius err per rank {[f'{x:.3e}' for x in rels]} (limit "
          f"{TP_REL}), same argmax; peak serving per rank "
          f"{[round(x['serve']['peak_gb'], 2) for x in tp]} GB; "
          f"{tp[0]['s']:.1f} s on the ranks; card {card}")

    # (e): the families whose decode mixers compute on TP's blocks
    k5_mesh += check_split(split, one_split,
                           [r[len(MESH_CASES) + 1] for r in by_rank], card,
                           tp_launches)
    # (f): DECODE_RULES over (2, 2)
    k5_mesh += check_decode2d(decode2d, one_decode2d,
                              [r[len(MESH_CASES) + 2] for r in by_rank], card,
                              tp_launches)
    # (g): SEQPAR_RULES over (1, 4)
    k5_mesh += check_seqpar(seqpar, one_seqpar,
                            [r[len(MESH_CASES) + 3] for r in by_rank], card,
                            tp_launches)
    return k5_mesh, k5_tp


def check_split(split, one_split, ranks, card, launched):
    """(e)'s checks and lines: in fp32 every rank's last prefill logits
    within ``TP_REL`` of one card's (same argmax) and its tokens equal to
    one card's; in both dtypes every rank's tokens equal to rank 0's, its
    cache bytes its spec blocks', and each decode step resharding only
    what ``decode_reshards`` says (no leaf TP computes split); the bf16
    tokens against one card's reported.  Returns K5's launches in the
    ranks' prefills, and hands ``launched`` each prefill's by shape."""
    import torch
    k5 = 0
    for i, case in enumerate(split):
        name, cfg = case["name"], case["bf16"]
        rows = [r["split"][i] for r in ranks]
        vocab = slice(0, cfg.vocab_size)
        problems, rels = [], []
        for r, row in enumerate(rows):
            for key in ("bf16", "fp32"):
                sv, one = row[key], one_split[i][key]
                if not torch.equal(sv["generated"], rows[0][key]["generated"]):
                    problems.append(f"rank {r} {key} tokens differ from rank "
                                    f"0's")
                if sv["cache_bytes"] != sv["cache_spec_bytes"]:
                    problems.append(f"rank {r} {key} cache "
                                    f"{sv['cache_bytes']} bytes, its spec "
                                    f"blocks {sv['cache_spec_bytes']}")
                steps = [d["reshards"] for d in sv["decode"]]
                if any(n != sv["want_reshards"] for n in steps):
                    problems.append(f"rank {r} {key} decode reshards "
                                    f"{steps}, want {sv['want_reshards']}")
                k5 += sv["prefill"]["k5"]
                launched(sv["prefill"]["k5_shapes"])
            f32, one32 = row["fp32"], one_split[i]["fp32"]
            got, want = f32["logits"][:, vocab], one32["logits"][:, vocab]
            rel = ((got - want).norm() / want.norm()).item()
            rels.append(rel)
            if not (torch.isfinite(got).all() and rel <= TP_REL
                    and torch.equal(got.argmax(-1), want.argmax(-1))):
                problems.append(f"rank {r} fp32 prefill logits rel err "
                                f"{rel:.3e} (limit {TP_REL})")
            if not torch.equal(f32["generated"], one32["generated"]):
                problems.append(f"rank {r} fp32 tokens "
                                f"{f32['generated'].tolist()} vs one card's "
                                f"{one32['generated'].tolist()}")
        if problems:
            raise AssertionError(f"phase 16(e) {name}: " + "; ".join(problems))
        bf, one = rows[0]["bf16"], one_split[i]["bf16"]
        diff = (bf["generated"] != one["generated"]).any(0).nonzero()
        first = "none" if not len(diff) else int(diff[0])
        dec, pre = bf["decode"][-1], bf["prefill"]
        print(f"phase 16(e) {name} over (1, 4) TP_RULES, 4 ranks on the one "
              f"card (gloo), {cfg.num_layers} layers at full width: bf16 "
              f"serve batch {bf['generated'].shape[0]}, gen "
              f"{bf['generated'].shape[1]}: prefill_ms per rank "
              f"{[round(x['bf16']['prefill_ms'], 3) for x in rows]} (one "
              f"card {one['prefill_ms']:.3f}), decode_ms_per_token "
              f"{[round(x['bf16']['decode_ms'], 3) for x in rows]} (one card "
              f"{one['decode_ms']:.3f}); tokens equal to one card's "
              f"{first == 'none'}, first step that differs {first}; K5 a "
              f"prefill {pre['k5_shapes']}; the prefill's collectives "
              f"{pre['calls']} ({pre['bytes']} bytes; reshards "
              f"{pre['reshards']}); a decode step: all-reduces "
              f"{dec['reduce_calls']} ({dec['reduce_bytes']} bytes), "
              f"all-gathers {dec['gather_calls']} ({dec['gather_bytes']} "
              f"bytes), reshards {dec['reshards']} ({dec['reshard_bytes']} "
              f"bytes; what TP computes whole: {bf['want_reshards']}), host "
              f"ms {dec['host_ms']:.3f}; each rank's cache "
              f"{[x['bf16']['cache_bytes'] for x in rows]} bytes, its spec "
              f"blocks {bf['cache_spec_bytes']}; fp32 (TF32 off) last "
              f"prefill logits vs one card rel Frobenius err per rank "
              f"{[f'{x:.3e}' for x in rels]} (limit {TP_REL}), "
              f"{SPLIT_FP32_GEN} greedy tokens equal to one card's on every "
              f"rank; {ranks[0]['s']:.1f} s on the ranks for (e); card "
              f"{card}")
    return k5



def check_decode2d(cases, refs, ranks, card, launched):
    """(f)'s checks and lines (``DECODE_RULES`` over ``DECODE2D_SHAPE``):
    in fp32 every rank's last prefill logits within ``TP_REL`` of one
    card's (same argmax) and its tokens equal to one card's; in both
    dtypes every rank's tokens equal to rank 0's, its weight bytes (held
    in ``serve_recorded``) and cache bytes its spec blocks', no weight
    resharded in the prefill or a decode step, and K5 at the rank's heads
    over the whole batch, once a layer of the prefill; the bf16 tokens
    against one card's reported (the first step that differs).  Returns
    K5's launches in the ranks' prefills, and hands ``launched`` each
    prefill's by shape."""
    import torch
    data, model = DECODE2D_SHAPE
    k5 = 0
    for i, case in enumerate(cases):
        name, cfg = case["name"], case["bf16"]
        rows = [r["split"][i] for r in ranks]
        vocab = slice(0, cfg.vocab_size)
        run = case["bf16_run"]
        want_k5 = {} if cfg.family == "ssm" else {
            (run["batch"], cfg.num_heads // model,
             cfg.num_kv_heads // model, run["prompt"], run["prompt"],
             (cfg.nope_head_dim + cfg.rope_head_dim
              if cfg.attention == "mla" else cfg.resolved_head_dim)):
            cfg.num_layers}
        problems, rels = [], []
        for r, row in enumerate(rows):
            for key in ("bf16", "fp32"):
                sv = row[key]
                if not torch.equal(sv["generated"], rows[0][key]["generated"]):
                    problems.append(f"rank {r} {key} tokens differ from rank "
                                    f"0's")
                if sv["cache_bytes"] != sv["cache_spec_bytes"]:
                    problems.append(f"rank {r} {key} cache "
                                    f"{sv['cache_bytes']} bytes, its spec "
                                    f"blocks {sv['cache_spec_bytes']}")
                moved = [sv["prefill"]["reshards"]] + [
                    d["reshards"] for d in sv["decode"]]
                if any(moved) or sv["want_reshards"]:
                    problems.append(f"rank {r} {key} weights resharded: "
                                    f"the prefill, then each decode step "
                                    f"{moved}")
                if sv["prefill"]["k5_shapes"] != want_k5:
                    problems.append(f"rank {r} {key} K5 "
                                    f"{sv['prefill']['k5_shapes']}, want "
                                    f"{want_k5}")
                k5 += sv["prefill"]["k5"]
                launched(sv["prefill"]["k5_shapes"])
            f32, one32 = row["fp32"], refs[i]["fp32"]
            got, want = f32["logits"][:, vocab], one32["logits"][:, vocab]
            rel = ((got - want).norm() / want.norm()).item()
            rels.append(rel)
            if not (torch.isfinite(got).all() and rel <= TP_REL
                    and torch.equal(got.argmax(-1), want.argmax(-1))):
                problems.append(f"rank {r} fp32 prefill logits rel err "
                                f"{rel:.3e} (limit {TP_REL})")
            if not torch.equal(f32["generated"], one32["generated"]):
                problems.append(f"rank {r} fp32 tokens "
                                f"{f32['generated'].tolist()} vs one card's "
                                f"{one32['generated'].tolist()}")
        if problems:
            raise AssertionError(f"phase 16(f) {name}: " + "; ".join(problems))
        bf, one = rows[0]["bf16"], refs[i]["bf16"]
        n = bf["generated"].shape[1]
        diff = (bf["generated"] != one["generated"][:, :n]).any(0).nonzero()
        first = "none" if not len(diff) else int(diff[0])
        dec, pre = bf["decode"][-1], bf["prefill"]
        print(f"phase 16(f) {name} over ({data}, {model}) DECODE_RULES, "
              f"{data * model} ranks on the one card (gloo), "
              f"{cfg.num_layers} layers at full width: bf16 serve batch "
              f"{bf['generated'].shape[0]} (every rank the whole batch), "
              f"prompt {run['prompt']}, gen {n}: prefill_ms per rank "
              f"{[round(x['bf16']['prefill_ms'], 3) for x in rows]} (one "
              f"card {one['prefill_ms']:.3f}), decode_ms_per_token "
              f"{[round(x['bf16']['decode_ms'], 3) for x in rows]} (one card "
              f"{one['decode_ms']:.3f}); tokens equal to one card's "
              f"{first == 'none'}, first step that differs {first}; K5 a "
              f"prefill {pre['k5_shapes']}; the prefill's collectives: "
              f"all-reduces {pre['reduce_calls']} ({pre['reduce_bytes']} "
              f"bytes), all-gathers {pre['gather_calls']} "
              f"({pre['gather_bytes']} bytes), host ms {pre['host_ms']:.3f}; "
              f"a decode step: all-reduces {dec['reduce_calls']} "
              f"({dec['reduce_bytes']} bytes), all-gathers "
              f"{dec['gather_calls']} ({dec['gather_bytes']} bytes), host "
              f"ms {dec['host_ms']:.3f}; weight bytes resharded a token "
              f"{dec['reshard_bytes']} (the prefill {pre['reshard_bytes']}); "
              f"each rank's weights {[x['bf16']['param_bytes'] for x in rows]}"
              f" bytes, its DECODE_RULES spec blocks {bf['spec_bytes']}; "
              f"each rank's cache {[x['bf16']['cache_bytes'] for x in rows]} "
              f"bytes, its spec blocks {bf['cache_spec_bytes']}; fp32 (TF32 "
              f"off) last prefill logits vs one card rel Frobenius err per "
              f"rank {[f'{x:.3e}' for x in rels]} (limit {TP_REL}), "
              f"{SPLIT_FP32_GEN} greedy tokens equal to one card's on every "
              f"rank; {ranks[0]['s']:.1f} s on the ranks for (f); card "
              f"{card}")
    return k5

def check_seqpar(cases, refs, ranks, card, launched):
    """(g)'s checks and lines (``SEQPAR_RULES`` over ``SEQPAR_SHAPE``): in
    fp32 every rank's last prefill logits within ``TP_REL`` of one card's
    (same argmax) and its tokens equal to one card's; in both dtypes every
    rank's tokens equal to rank 0's, its cache bytes its spec blocks', a
    decode step resharding what ``decode_reshards`` says, the prefill's
    sequence collectives ``seqpar_prefill_collectives``' (the stream
    split) and K5 at the rank's heads over its rank's batch, once a
    layer; the bf16 tokens against one card's reported.  Returns K5's
    launches in the ranks' prefills, and hands ``launched`` each
    prefill's by shape."""
    import torch
    data, model = SEQPAR_SHAPE
    k5 = 0
    for i, case in enumerate(cases):
        name, cfg = case["name"], case["bf16"]
        rows = [r["split"][i] for r in ranks]
        vocab = slice(0, cfg.vocab_size)
        run = case["bf16_run"]
        rs, ag = seqpar_prefill_collectives(cfg, model)
        want_k5 = {} if cfg.family == "ssm" else {
            (run["batch"] // data, cfg.num_heads // model,
             cfg.num_kv_heads // model, run["prompt"], run["prompt"],
             cfg.resolved_head_dim): cfg.num_layers}
        problems, rels = [], []
        for r, row in enumerate(rows):
            for key in ("bf16", "fp32"):
                sv = row[key]
                if not torch.equal(sv["generated"], rows[0][key]["generated"]):
                    problems.append(f"rank {r} {key} tokens differ from rank "
                                    f"0's")
                if sv["cache_bytes"] != sv["cache_spec_bytes"]:
                    problems.append(f"rank {r} {key} cache "
                                    f"{sv['cache_bytes']} bytes, its spec "
                                    f"blocks {sv['cache_spec_bytes']}")
                steps = [d["reshards"] for d in sv["decode"]]
                if any(n != sv["want_reshards"] for n in steps):
                    problems.append(f"rank {r} {key} decode reshards "
                                    f"{steps}, want {sv['want_reshards']}")
                seq = (sv["seq"]["reduce-scatter"]["calls"],
                       sv["seq"]["all-gather"]["calls"])
                if seq != (rs, ag):
                    problems.append(f"rank {r} {key} the sequence's "
                                    f"reduce-scatters and all-gathers {seq}, "
                                    f"want {(rs, ag)}")
                if sv["prefill"]["k5_shapes"] != want_k5:
                    problems.append(f"rank {r} {key} K5 "
                                    f"{sv['prefill']['k5_shapes']}, want "
                                    f"{want_k5}")
                k5 += sv["prefill"]["k5"]
                launched(sv["prefill"]["k5_shapes"])
            f32, one32 = row["fp32"], refs[i]["fp32"]
            got, want = f32["logits"][:, vocab], one32["logits"][:, vocab]
            rel = ((got - want).norm() / want.norm()).item()
            rels.append(rel)
            if not (torch.isfinite(got).all() and rel <= TP_REL
                    and torch.equal(got.argmax(-1), want.argmax(-1))):
                problems.append(f"rank {r} fp32 prefill logits rel err "
                                f"{rel:.3e} (limit {TP_REL})")
            if not torch.equal(f32["generated"], one32["generated"]):
                problems.append(f"rank {r} fp32 tokens "
                                f"{f32['generated'].tolist()} vs one card's "
                                f"{one32['generated'].tolist()}")
        if problems:
            raise AssertionError(f"phase 16(g) {name}: " + "; ".join(problems))
        bf, one = rows[0]["bf16"], refs[i]["bf16"]
        n = bf["generated"].shape[1]
        diff = (bf["generated"] != one["generated"][:, :n]).any(0).nonzero()
        first = "none" if not len(diff) else int(diff[0])
        dec, pre, sq = bf["decode"][-1], bf["prefill"], bf["seq"]
        print(f"phase 16(g) {name} over ({data}, {model}) SEQPAR_RULES, "
              f"{data * model} ranks on the one card (gloo), "
              f"{cfg.num_layers} layers at full width: bf16 serve batch "
              f"{bf['generated'].shape[0]}, prompt {run['prompt']} "
              f"({run['prompt'] // model} rows a rank between blocks), gen "
              f"{n}: prefill_ms per rank "
              f"{[round(x['bf16']['prefill_ms'], 3) for x in rows]} (one "
              f"card {one['prefill_ms']:.3f}), decode_ms_per_token "
              f"{[round(x['bf16']['decode_ms'], 3) for x in rows]} (one card "
              f"{one['decode_ms']:.3f}); tokens equal to one card's "
              f"{first == 'none'}, first step that differs {first}; K5 a "
              f"prefill {pre['k5_shapes']}; the prefill's sequence "
              f"reduce-scatters {sq['reduce-scatter']['calls']} "
              f"({sq['reduce-scatter']['bytes']} bytes given, host ms "
              f"{sq['reduce-scatter']['host_ms']:.3f}; gloo: an fp32 "
              f"all-reduce and a cut) and all-gathers "
              f"{sq['all-gather']['calls']} ({sq['all-gather']['bytes']} "
              f"bytes, host ms {sq['all-gather']['host_ms']:.3f}), all its "
              f"collectives: all-reduces {pre['reduce_calls']} "
              f"({pre['reduce_bytes']} bytes), all-gathers "
              f"{pre['gather_calls']} ({pre['gather_bytes']} bytes), host "
              f"ms {pre['host_ms']:.3f}; a decode step: all-reduces "
              f"{dec['reduce_calls']} ({dec['reduce_bytes']} bytes), "
              f"all-gathers {dec['gather_calls']} ({dec['gather_bytes']} "
              f"bytes), reshards {dec['reshards']}, host ms "
              f"{dec['host_ms']:.3f}; each rank's cache "
              f"{[x['bf16']['cache_bytes'] for x in rows]} bytes, its spec "
              f"blocks {bf['cache_spec_bytes']}; fp32 (TF32 off) last "
              f"prefill logits vs one card rel Frobenius err per rank "
              f"{[f'{x:.3e}' for x in rels]} (limit {TP_REL}), "
              f"{SPLIT_FP32_GEN} greedy tokens equal to one card's on every "
              f"rank; {ranks[0]['s']:.1f} s on the ranks for (g); card "
              f"{card}")
    return k5

# ---------------------------------------------------------------------------
# Phase 17: training over a mesh — the gradient of qwen3-moe-235b-a22b over
# meshes of ranks, Mamba-2 370M trained over two
# ---------------------------------------------------------------------------

# (a) fp32, TF32 off: qwen3-moe-235b-a22b at full width over 1 of its 94
# layers, a (1, 4) ep mesh, a global batch of 2 x 256.  At capacity factor
# 16 an expert's C = ceil(T k 16 / E) = T slots (k 8, E 128): no
# assignment can drop, so the mesh's function is the one-card gather
# path's.  Memory, a rank: the 1,316,052,992 whole parameters (embedding
# and head 622,329,856 each, attention 71.4 M, the gate and norms) and 32
# of the 128 experts (603,979,776), 1.92 G in all: 7.68 GB of fp32 weights
# and 7.68 of fp32 gradients, ~17 GB with the activations; four ranks ~70
# GB.  The one-card reference (3.73 G parameters, 14.9 GB, its gradient
# too) runs first on rank 0 alone and waits on the host; rank 0 hands each
# rank its reference blocks over the group.
MESH_GRAD = {"layers": 1, "batch": 2, "seq": 256, "capacity": 16.0,
             "seed": 2}
MESH_GRAD_BAR = {"loss": 1e-5, "leaf": 1e-4}
# (d) fp32, TF32 off: TP's compute split under autograd, phase 16(d)'s
# qwen3-8b at full width over 2 of its 36 layers on (1, 4) under TP_RULES
# (a rank stores and computes a quarter of every dense leaf), a global
# batch of 2 x 256 on every rank, held to the one-card gradient at (a)'s
# bars.
TP_GRAD = {"layers": 2, "batch": 2, "seq": 256, "seed": 2}
# (e) the same gradient (one job, (d)'s reference) under SEQPAR_RULES over
# (1, 4) and (2, 2): the residual stream split over model along the
# sequence between blocks, 64 and 128 of the 256 rows a rank (at (2, 2)
# the batch over data, 1 x 256 a rank: K5 and K5b at (1, 16, KV 4, 256))
# (f) the same gradient under DECODE_RULES over (2, 2): the weights
# resident in their 2-D blocks (no dense leaf resharded), every rank the
# whole batch of 2 x 256, the residual stream split over data along the
# hidden dim (a layer's remat unit keeps B 2 x S 256 x D/2 2048 x 4 =
# 4,194,304 bytes a rank; K5 and K5b at (2, 16, KV 4, 256)).
# The cases in the job's order: the first pays the ranks' first gloo
# collectives on CUDA tensors (their pinned buffers), so (e)'s (1, 4) case
# runs before (d)'s, whose step then shows the split's own cost
TP_GRAD_CASES = [((1, 4), "SEQPAR_RULES"), ((1, 4), "TP_RULES"),
                 ((2, 2), "SEQPAR_RULES"), ((2, 2), "DECODE_RULES")]
# (b) bf16, int8 gradients: (2, 2) ep and ep_resident, a global batch of 4
# x 1024 (a data block of 2 x 1024 a rank), capacity factor 16 as in (a).
# A (2, 2) ep rank: 1.32 G whole and 64 experts (1.21 G): 5.06 GB of bf16
# weights, the bf16 gradient, then the reduced fp32 one (10.1 GB), and
# ~9 GB of activations at the backward's peak (the MoE's 2,048 slots an
# expert, the logits in fp32): ~19 GB, ~76 GB for four ranks.  Held to the
# one-card bf16 gradient: the loss, and each leaf of the reduced gradient
# where the step hands it to the int8 transform, within MESH_REL's bf16
# bar in relative Frobenius error (compared inside the step's call, the
# check's time and collectives taken out of the step's).  The transformed
# leaves' errors against one card's transformed leaves are printed, not
# held: a code one apart wherever an element sits near a rounding
# boundary makes them several
# times the bf16 gradients' (the codes themselves are K3's, held
# byte-equal to the plain version in phase 10 and below).
MESH_GRAD16 = {"layers": 1, "batch": 4, "seq": 1024, "capacity": 16.0,
               "seed": 2}
MESH_GRAD16_CASES = [((2, 2), "ep"), ((2, 2), "ep_resident")]
# (c) Mamba-2 370M at full width and depth, bf16, int8 gradients, through
# launch.train.train(mesh=) over a (2, 1) data mesh: a global batch of
# 8 x 1024, 4 x 1024 a rank, 5 steps of a 5-step schedule, seed 0, held to
# the one-card launcher's 5 steps (phase 12's bars for 5-step cells).
MESH_DP = {"shape": (2, 1), "batch": 8, "seq": 1024, "steps": 5}
MESH_DP_BARS = (1e-2, 5e-2)


def leaf_names(tree, prefix=""):
    """The '/'-joined dict keys and list indices of each leaf, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def leaf_digests(leaves, chunk=1 << 24):
    """An int64 a leaf from its bits and their positions (sums that wrap),
    computed on the leaves' device a chunk at a time: two ranks' trees
    with equal digests hold the same bytes, short of a collision."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in leaves:
        flat = t.detach().reshape(-1)
        bits = flat.view(ints[flat.element_size()])
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, bits.numel(), chunk):
            b = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=b.device,
                             dtype=torch.int64) % 1_000_003 + 1
            acc += (b * w).sum()
        out.append(acc)
    return torch.stack(out)


class reduce_counted:
    """Within the block every ``collectives.reduce_`` call (the gradient's
    reduction, the loss's, the norm's and the absmax's) is counted: calls,
    bytes of the tensor, and host seconds between two synchronizes of the
    card."""

    def __init__(self, sync):
        self.sync, self.calls, self.nbytes, self.s = sync, 0, 0, 0.0

    def row(self):
        return {"calls": self.calls, "bytes": self.nbytes,
                "host_ms": self.s * 1e3}

    def __enter__(self):
        from repro_torch.distributed import collectives as coll
        self.real = coll.reduce_

        def counted(t, mesh, axes, *args, **kw):
            live = coll.live_axes(mesh, axes)
            self.sync()
            t0 = time.perf_counter()
            out = self.real(t, mesh, axes, *args, **kw)
            self.sync()
            self.s += time.perf_counter() - t0
            self.calls += len(live)
            self.nbytes += len(live) * t.numel() * t.element_size()
            return out

        coll.reduce_ = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives as coll
        coll.reduce_ = self.real


class seq_counted:
    """Within the block the residual stream's sequence collectives
    (``SEQPAR_RULES``) are counted by kind: the reduce-scatters
    (``collectives._scatter_sum``: ``psum_scatter``'s forward and
    ``all_gather_dim``'s backward; on gloo an fp32 all-reduce and a cut)
    and the all-gathers (``collectives._gather_cat``: ``all_gather_dim``'s
    forward and ``psum_scatter``'s backward): calls, bytes of the tensor
    each is given, host seconds between two synchronizes of the card.
    Within a ``collectives_counted`` block (``within``) each kind also
    keeps that block's all-gather counts inside it (``inner_gathers``:
    calls, bytes, host ms), so that the block's other all-gathers can be
    told apart."""

    KINDS = {"reduce-scatter": "_scatter_sum", "all-gather": "_gather_cat"}

    def __init__(self, sync, within=None):
        self.sync, self.within = sync, within
        self.rows = {k: {"calls": 0, "bytes": 0, "host_ms": 0.0,
                         "inner_gathers": [0, 0, 0.0]} for k in self.KINDS}

    def __enter__(self):
        from repro_torch.distributed import collectives as coll
        self.real = {k: getattr(coll, n) for k, n in self.KINDS.items()}

        def wrap(kind, fn):
            def counted(t, *args, **kw):
                snap = None if self.within is None else self.within.snap()
                self.sync()
                t0 = time.perf_counter()
                out = fn(t, *args, **kw)
                self.sync()
                row = self.rows[kind]
                if snap is not None:
                    inner = self.within.since(snap)
                    for i, k in enumerate(("gather_calls", "gather_bytes",
                                           "gather_ms")):
                        row["inner_gathers"][i] += inner[k]
                row["host_ms"] += (time.perf_counter() - t0) * 1e3
                row["calls"] += 1
                row["bytes"] += t.numel() * t.element_size()
                return out
            return counted

        for kind, n in self.KINDS.items():
            setattr(coll, n, wrap(kind, self.real[kind]))
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives as coll
        for kind, n in self.KINDS.items():
            setattr(coll, n, self.real[kind])


class stream_recorded:
    """Within the block the bytes of every block's input on this rank
    (``transformer.apply_block``'s ``x``): the residual stream a layer's
    remat unit keeps for the backward (``seen``, the distinct sizes)."""

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.real, self.seen = T.apply_block, set()

        def recorded(cfg, kind, p, x, ctx):
            self.seen.add(x.numel() * x.element_size())
            return self.real(cfg, kind, p, x, ctx)

        T.apply_block = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        T.apply_block = self.real


def host_available_gb():
    """The host's available memory (``MemAvailable``), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def empty_host_cache():
    """Return the pinned host blocks that gloo's copies of CUDA tensors
    left in PyTorch's host cache (four ranks' caches and the reference on
    rank 0 passed the 96 GiB of host memory of an H100 host)."""
    import torch
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None and torch.cuda.is_available():
        fn()


def rank_coords(mesh, r):
    """Rank ``r``'s index along each axis of ``mesh``."""
    where = (mesh.mesh == r).nonzero()[0].tolist()
    return dict(zip(mesh.mesh_dim_names, where))


def held_to_reference(leaves, specs, ref, mesh, dev):
    """Each leaf's relative Frobenius error against the reference's.  Rank
    0 holds the whole reference leaves on the host and sends every other
    rank its block of each split leaf, in the reference's own dtype; a
    whole leaf is compared on rank 0, and held byte-equal across the ranks
    by digest.  Returns, on rank 0,
    each rank's errors by leaf (None for a whole leaf off rank 0), else
    None; and whether the whole leaves agreed."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = []
    dtypes = [[t.dtype for t in ref] if rank == 0 else None]
    dist.broadcast_object_list(dtypes, src=0)

    def rel(a, b, chunk=1 << 24):
        """A chunk at a time: the whole leaves leave little of the card."""
        a, b = a.reshape(-1), b.reshape(-1)
        num = den = 0.0
        for i in range(0, b.numel(), chunk):
            bi = b[i:i + chunk].double()
            num += (a[i:i + chunk].double() - bi).square_().sum().item()
            den += bi.square().sum().item()
        return math.sqrt(num / den)

    for j, (leaf, spec) in enumerate(zip(leaves, specs)):
        if not spec:
            mine.append(rel(leaf, ref[j].to(dev)) if rank == 0 else None)
            continue
        if rank == 0:
            for r in range(1, world):
                dist.send(SH.local_block(ref[j], spec, mesh, rank_coords(
                    mesh, r)).contiguous(), dst=r)
            want = SH.local_block(ref[j], spec, mesh).to(dev)
        else:
            want = torch.empty(leaf.shape, dtype=dtypes[0][j])
            dist.recv(want, src=0)
            want = want.to(dev)
        mine.append(rel(leaf, want))
        del want
    whole = [t for t, sp in zip(leaves, specs) if not sp]
    dig = leaf_digests(whole)
    digs = [torch.empty_like(dig) for _ in range(world)]
    dist.all_gather(digs, dig)
    same = all(torch.equal(d, digs[0]) for d in digs)
    rows = [None] * world
    dist.all_gather_object(rows, mine)
    return (rows if rank == 0 else None), same


def grad_on_mesh(job, dev):
    """Phase 17(a), (b), (d) or (e) on this rank: the one-card reference
    on rank 0 (its gradient leaves kept on the host), then for each case
    of ``job["cases"]``, (mesh shape, MoE form[, rules: ``TRAIN_RULES``
    where none]), the weights placed ``in_turns`` from the same seed
    (each rank its blocks under the rules, their bytes and the reduced
    gradient's held to the spec's), ``steps.make_grad_fn`` on the rank's
    block of the batch (launches, time, the reduction's collectives, the
    reshards' all-gathers, the sequence's collectives, the bytes of each
    block's input, peak memory), its leaves held to the
    reference's; with int8 also, in the same call, the reduced leaves
    before the transform to the reference's before it (that check's own
    time and collectives taken out of the step's); and where
    ``job["fault"]`` the same with ``collectives.psum``'s backward sum
    left out.  Rank 0 keeps the reference's leaves on the host in the
    model's dtype, and each rank empties the pinned host cache that gloo's
    copies of CUDA tensors fill after each call; the host's available
    memory is read after each call."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compression as GC
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    cfg, run = job["cfg"], job["run"]
    tcfg = TrainConfig(grad_compression=job["compression"])
    rank = dist.get_rank()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    peak = lambda: torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    counted = {"K5": FA.flash_attention, "K5b": FA.flash_attention_bwd,
               "K3": VE.quantize_int8, "K4": VE.dequantize_int8}
    B, S = run["batch"], run["seq"]
    batch = TokenStream(cfg, B, S, run["seed"], device=dev).batch_at(0)
    gen = lambda: torch.Generator(device=dev).manual_seed(run["seed"])
    out = {"cases": []}
    ref = None
    wire = GC.wire_transform
    ref_pre = None
    if rank == 0:
        t0 = time.perf_counter()
        params = T.init_params(cfg, gen(), device=dev)

        def keep(leaves, absmax=None):
            nonlocal ref_pre
            ref_pre = [g.cpu() for g in leaves]
            wire(leaves, absmax)

        GC.wire_transform = keep
        try:
            loss, grads = ST.make_grad_fn(cfg, tcfg)(params, batch)
        finally:
            GC.wire_transform = wire
        out["ref"] = {"loss": loss.item(),
                      "norm": adamw.global_norm(grads).item()}
        # in the model's dtype: the int8 run's transformed leaves (fp32)
        # are compared only for the printed errors, and rounded to bf16
        # they halve what rank 0 keeps on the host
        ref = [g.to(getattr(torch, cfg.dtype)).cpu()
               for g in tree_leaves(grads)]
        del params, grads, loss
        out["ref"]["s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    names = leaf_names(T.param_defs(cfg))
    for shape, impl, *case_rules in job["cases"]:
        rname = case_rules[0] if case_rules else "TRAIN_RULES"
        rules = getattr(SH, rname)
        cfg_m = dataclasses.replace(cfg, moe_impl=impl) if impl else cfg
        mesh = M.make_mesh(shape, ("data", "model"), device=dev.type)
        baxes = SH.batch_axes(B, rules, mesh)
        stats = {}
        params = in_turns(T.place_params, dev, stats)(
            cfg_m, gen(), mesh, rules=rules, device=dev)
        local = {k: SH.local_block(v, SH.batch_spec(tuple(v.shape),
                                                    rules, mesh),
                                   mesh) for k, v in batch.items()}
        grad_fn = ST.make_grad_fn(cfg_m, tcfg, mesh=mesh, batch_axes=baxes,
                                  rules=rules)
        specs = tree_leaves(T.param_block_specs(cfg_m, mesh, rules),
                            is_leaf=SH.is_spec)
        held = rank_bytes(cfg_m, mesh, baxes, B, S, rules=rules)
        stats["spec_bytes"], spec32 = held["params"], held["moment"]
        stats["whole_leaf_bytes"] = held["whole_leaf"]
        stats["dryrun_argument_bytes"] = held["arguments"]
        # a train step's arguments as this rank holds them: its parameter
        # and batch blocks and the AdamW state adamw.init builds on them,
        # freed before the step
        opt = adamw.init(params)
        stats["argument_bytes"] = tree_bytes((params, opt, local))
        stats["moment_bytes"] = tree_bytes(opt.mu)
        del opt
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
        int8 = job["compression"] == "int8"
        row = {}
        check = {"s": 0.0, "coll": None}

        def held_before_int8(leaves, absmax=None):
            # the reduced gradient where the step hands it to the int8
            # transform, held to one card's; timed and counted apart
            sync()
            t_in, c_in = time.perf_counter(), coll_all.snap()
            row["rels"], row["pre_equal"] = held_to_reference(
                leaves, specs, ref_pre, mesh, dev)
            sync()
            check["s"] = time.perf_counter() - t_in
            check["coll"] = coll_all.since(c_in)
            wire(leaves, absmax)

        before = {k: c.launches for k, c in counted.items()}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        if int8:
            GC.wire_transform = held_before_int8
        try:
            with reduce_counted(sync) as red, \
                    collectives_counted(sync) as coll_all, \
                    seq_counted(sync, coll_all) as seqc, \
                    stream_recorded() as stream:
                t0 = time.perf_counter()
                loss, grads = grad_fn(params, local)
                sync()
                ms = (time.perf_counter() - t0 - check["s"]) * 1e3
        finally:
            GC.wire_transform = wire
        minus = check["coll"] or dict.fromkeys(
            ("calls", "bytes", "host_ms", "gather_calls", "gather_bytes",
             "gather_ms"), 0)
        empty_host_cache()
        seq_inner = [sum(r["inner_gathers"][i] for r in seqc.rows.values())
                     for i in range(3)]
        gnorm = adamw.global_norm(grads, ST.norm_reduction(
            cfg_m, mesh, rules)).item()
        stats["grad_bytes"] = tree_bytes(grads)
        if (stats["param_bytes"], stats["grad_bytes"], stats["moment_bytes"],
                stats["argument_bytes"]) != (
                stats["spec_bytes"], spec32, spec32,
                stats["dryrun_argument_bytes"]):
            raise AssertionError(
                f"phase 17 {shape} {impl}: a rank holds "
                f"{stats['param_bytes']} bytes of weights, "
                f"{stats['grad_bytes']} of reduced gradient, "
                f"{stats['moment_bytes']} of an AdamW moment and "
                f"{stats['argument_bytes']} of a train step's arguments; "
                f"the dry run's blocks {stats['spec_bytes']}, {spec32}, "
                f"{spec32} and {stats['dryrun_argument_bytes']}")
        row.update({
            "shape": shape, "impl": impl or rname, "rules": rname,
            "loss": loss.item(), "stream_bytes": sorted(stream.seen),
            "seq": seqc.rows,
            "norm": gnorm, "ms": ms, "reduce": red.row(),
            "collectives": {"calls": coll_all.calls - minus["calls"],
                            "bytes": coll_all.nbytes - minus["bytes"],
                            "host_ms": coll_all.s * 1e3 - minus["host_ms"]},
            # the reshards' all-gathers: every all-gather but the
            # sequence's (SEQPAR_RULES)
            "gathers": {"calls": coll_all.gathers[0] - minus["gather_calls"]
                        - seq_inner[0],
                        "bytes": coll_all.gathers[1] - minus["gather_bytes"]
                        - seq_inner[1],
                        "host_ms": (coll_all.gathers[2] * 1e3
                                    - minus["gather_ms"] - seq_inner[2])},
            # the placement's reshards that move a weight's block
            "reshards": coll_all.reshards[0],
            "check_ms": check["s"] * 1e3, "host_gb": host_available_gb(),
            "launches": {k: c.launches - before[k]
                         for k, c in counted.items()},
            "peak_gb": peak(), "leaves": len(specs), "names": names,
            "specs": specs, **stats})
        leaves = tree_leaves(grads)
        del grads
        key = "wire_rels" if int8 else "rels"
        row[key], row["whole_equal"] = held_to_reference(
            leaves, specs, ref, mesh, dev)
        row["whole_equal"] = row["whole_equal"] and row.get("pre_equal",
                                                            True)
        del leaves, loss
        if cuda:
            torch.cuda.empty_cache()
        if job["fault"]:
            # planted: psum's backward without its all-reduce, so the
            # cotangent of each rank's partial output misses the other
            # ranks' share
            real = coll._Psum.backward
            coll._Psum.backward = staticmethod(
                lambda ctx, g: (g.contiguous().clone(), None))
            try:
                _, grads = grad_fn(params, local)
            finally:
                coll._Psum.backward = real
            leaves = tree_leaves(grads)
            del grads
            row["fault_rels"], _ = held_to_reference(leaves, specs, ref,
                                                     mesh, dev)
            del leaves
            empty_host_cache()
        del params
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
        out["cases"].append(row)
    return out


def train_on_mesh(job, dev):
    """Phase 17(c) on this rank: ``launch.train.train`` of Mamba-2 370M
    over the (2, 1) mesh (each rank its ``TRAIN_RULES`` blocks: FSDP over
    data), each step timed, its launches counted, the reduction's
    collectives and the reshards' all-gathers timed and every unsplit leaf
    of the parameters and the optimizer state compared across the ranks by
    digest after it; then the parameter and moment bytes held to the
    spec's, and the final parameters gathered whole onto rank 0 (host);
    checkpoints recorded, not written."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    run = job["run"]
    mesh = M.make_mesh(run["shape"], ("data", "model"), device=dev.type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counted = {"K8": SSD.ssd_scan, "K8b": SSD.ssd_scan_bwd,
               "K3": VE.quantize_int8, "K4": VE.dequantize_int8}
    rec = {"step_ms": [], "launches": [], "reduce": [], "gathers": [],
           "same": [], "saved": []}
    real = (TR.ST.make_train_step, TR.ckpt.save)
    last = {}

    def make_train_step(cfg, tcfg, **kw):
        step = real[0](cfg, tcfg, **kw)
        specs = tree_leaves(T.param_block_specs(cfg, mesh),
                            is_leaf=SH.is_spec)
        # the leaves no axis of more than one rank splits, in (params,
        # AdamWState(step, mu, nu))
        one = [not coll.live_axes(mesh, coll.split_axes(sp)) for sp in specs]
        whole = one + [True] + one * 2
        last["cfg"], last["specs"], last["split"] = cfg, specs, len(one) - sum(
            one)

        def timed(params, opt, batch):
            before = {k: c.launches for k, c in counted.items()}
            sync()
            with reduce_counted(sync) as red, \
                    collectives_counted(sync) as every:
                t0 = time.perf_counter()
                out = step(params, opt, batch)
                sync()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append({k: c.launches - before[k]
                                    for k, c in counted.items()})
            rec["reduce"].append(red.row())
            rec["gathers"].append({"calls": every.gathers[0],
                                   "bytes": every.gathers[1],
                                   "host_ms": every.gathers[2] * 1e3})
            dig = leaf_digests([t for t, w in zip(
                tree_leaves((out[0], out[1])), whole) if w])
            digs = [torch.empty_like(dig)
                    for _ in range(dist.get_world_size())]
            dist.all_gather(digs, dig)
            rec["same"].append(all(torch.equal(d, digs[0]) for d in digs))
            last["out"] = out
            return out
        return timed

    TR.ST.make_train_step = make_train_step
    TR.ckpt.save = lambda d, step, tree, **kw: rec["saved"].append(step)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        rec["losses"] = TR.train(MAMBA, smoke=False, steps=run["steps"],
                                 batch=run["batch"], seq=run["seq"], seed=0,
                                 device=dev, mesh=mesh, log_every=run["steps"],
                                 grad_compression="int8")
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        TR.ST.make_train_step, TR.ckpt.save = real
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    params, opt = last["out"][:2]
    rec["param_bytes"], rec["moment_bytes"] = (tree_bytes(params),
                                               tree_bytes((opt.mu, opt.nu)))
    held = rank_bytes(last["cfg"], mesh, ("data",), run["batch"],
                      run["seq"])
    rec["spec_bytes"], rec["whole_leaf_bytes"] = (held["params"],
                                                  held["whole_leaf"])
    rec["spec_moment_bytes"] = 2 * held["moment"]
    final = [coll.gather_block(t, sp, mesh) for t, sp in zip(
        tree_leaves(params), last["specs"])]
    rec["final"] = ([t.cpu() for t in final] if dist.get_rank() == 0
                    else None)
    rec["split"] = last["split"]
    return rec


def mesh_train_rank(rank, world, store_dir, job):
    """One rank of a phase 17 mesh (started by ``launch.mesh.run_ranks``):
    on the card's one device, in a gloo group, ``grad_on_mesh`` or
    ``train_on_mesh``; its results to ``job["out"]/rank<r>.pt``."""
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, job["src"])
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    M.init_group(store_dir, rank, world, "gloo", timeout_s=MESH_TIMEOUT_S)
    fn = train_on_mesh if job["kind"] == "train" else grad_on_mesh
    res = fn(job, dev)
    torch.save(res, os.path.join(job["out"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_mesh_job(job, world, dev):
    """``mesh_train_rank`` on ``world`` ranks on ``dev``; their results by
    rank."""
    import shutil

    import torch

    from repro_torch.launch import mesh as M
    out = Path(__file__).resolve().parent / "build" / "phase17"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    job = {"src": str(Path(__file__).resolve().parent / "src"),
           "device": str(dev), "out": str(out), **job}
    if dev.type == "cuda":        # the ranks share the card with this process
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    M.run_ranks(mesh_train_rank, world, job, timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    return ranks, wall


def _by_leaf(rels, n):
    """The worst of the ranks' relative errors for each of ``n`` leaves."""
    return [max(r[j] for r in rels if r[j] is not None) for j in range(n)]


def check_mesh_grads(ranks, bar, what, card):
    """The loss, each rank's leaves and (where planted) the fault of one
    ``grad_on_mesh`` job against its bars (``bar["leaf"]``: on each
    leaf's relative Frobenius error; with int8, the reduced gradient's
    before the transform, and the transformed leaves' errors printed);
    ``what`` labels the lines (a dict: by each case's rules); returns the
    case rows."""
    ref = ranks[0]["ref"]
    rows = []
    labels = what if isinstance(what, dict) else {}
    for i, row in enumerate(ranks[0]["cases"]):
        what = labels.get(row["rules"], what)
        name = f"({row['shape'][0]}, {row['shape'][1]}) {row['impl']}"
        rel = _by_leaf(row["rels"], row["leaves"])
        loss_rel = abs(row["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_rel = abs(row["norm"] - ref["norm"]) / ref["norm"]
        same_loss = all(r["cases"][i]["loss"] == row["loss"] for r in ranks)
        whole = all(r["cases"][i]["whole_equal"] for r in ranks)
        if not (loss_rel <= bar["loss"] and max(rel) <= bar["leaf"]
                and same_loss and whole and math.isfinite(row["loss"])):
            raise AssertionError(
                f"phase 17{what} {name}: loss {row['loss']} vs one card "
                f"{ref['loss']} (rel {loss_rel:.3e}, limit {bar['loss']}), "
                f"leaves' rel Frobenius errs "
                + ", ".join(f"{n} {r:.2e}" for n, r in
                            zip(row["names"], rel))
                + f" (limit {bar['leaf']}), every rank's loss equal "
                f"{same_loss}, unsplit leaves byte-equal across ranks {whole}")
        top = sorted(zip(rel, row["names"]), reverse=True)[:3]
        line = (f"phase 17{what} {name}: loss {row['loss']:.6f} vs one card "
                f"{ref['loss']:.6f} (rel {loss_rel:.3e}, limit "
                f"{bar['loss']}); grad norm rel {norm_rel:.3e}; "
                f"{row['leaves']} leaves, each rank's block"
                + (" of the reduced gradient before int8" if "wire_rels"
                   in row else "")
                + f" within {max(rel):.3e} in rel Frobenius err (limit "
                f"{bar['leaf']}; worst "
                + ", ".join(f"{n} {r:.2e}" for r, n in top)
                + "); unsplit leaves byte-equal on every rank")
        if "wire_rels" in row:
            wrel = _by_leaf(row["wire_rels"], row["leaves"])
            wtop = sorted(zip(wrel, row["names"]), reverse=True)[:3]
            line += ("; after the int8 transform (K3, K4) within "
                     f"{max(wrel):.3e} of one card's, rounded to the "
                     f"model's dtype (worst "
                     + ", ".join(f"{n} {r:.2e}" for r, n in wtop) + ")")
        if "fault_rels" in row:
            by_leaf = _by_leaf(row["fault_rels"], row["leaves"])
            hit = {n: v for n, v in zip(row["names"], by_leaf)
                   if n.endswith(("/wg", "/w1", "/w2", "/w3"))}
            if not (hit and min(hit.values()) > bar["leaf"]):
                raise AssertionError(f"phase 17{what} {name}: the planted "
                                     f"fault reads {hit}, not above "
                                     f"{bar['leaf']}")
            line += ("; planted fault (psum's backward sum left out): "
                     + ", ".join(f"{n.rsplit('/', 1)[1]} {v:.3e}"
                                 for n, v in hit.items())
                     + f", worst {max(by_leaf):.3e}, all above the bar")
        print(line + f"; card {card}")
        rows.append(row)
    return rows


def check_k3_given(dev, time_ms, n):
    """K3 given the row's absmax (the whole leaf's, larger than the
    block's own), at one (2, 2) rank's stored block of a stacked expert
    leaf (``n`` fp32 elements: its experts over model, their D over data):
    byte-equal to the plain version given the same,
    timed beside K3 finding its own and the plain version; the bound as
    phase 10's (each element read and its code written once)."""
    import torch

    from repro_torch.kernels import vector_engine as VE
    x = torch.randn(1, n, generator=torch.Generator(device=dev).manual_seed(
        17), device=dev) * 1e-3
    absmax = x.abs().amax(dim=-1) * 1.25
    q, s = VE.quantize_int8(x, absmax)
    wq, ws = VE.quantize_int8_plain(x, absmax)
    if not (torch.equal(q, wq) and torch.equal(s.view(torch.int32),
                                                ws.view(torch.int32))):
        raise AssertionError(f"K3 given absmax (1, {n}): not byte-equal to "
                             f"the plain version")
    # the library's one call for the same function: codes round(x / s)
    # at the scale s = absmax / 127, timed only
    scale = (absmax / 127).item()
    lq = torch.quantize_per_tensor(x, scale, 0, torch.qint8).int_repr()
    differ = (lq != q).sum().item()
    del q, s, wq, ws, lq
    out = {"shape": (1, n), "max_abs_err": 0.0,
           "ms": time_ms(lambda: VE.quantize_int8(x, absmax), reps=3),
           "own_ms": time_ms(lambda: VE.quantize_int8(x), reps=3),
           "plain_ms": time_ms(lambda: VE.quantize_int8_plain(x, absmax),
                               reps=2),
           "library_ms": time_ms(lambda: torch.quantize_per_tensor(
               x, scale, 0, torch.qint8), reps=3)}
    out["bound_ms"], out["bound_by"] = k3_bound(1, n, torch.float32,
                                                given=True)
    del x
    torch.cuda.empty_cache()
    print(f"K3 quantize_int8 given the absmax, (1, {n}) float32 (one (2, 2) "
          f"rank's stored block of a stacked expert leaf): byte-equal to "
          f"the "
          f"plain version given the same; ms={out['ms']:.4f} (finding its "
          f"own {out['own_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
          f"library_ms(torch.quantize_per_tensor)={out['library_ms']:.4f} "
          f"({differ} of its codes differ from K3's) "
          f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']})")
    return out


def held_line(row):
    """A ``grad_on_mesh`` row's bytes a rank against the dry run's blocks
    and the whole-leaf placement's, and the reshards' all-gathers."""
    g = row["gathers"]
    return (f"weights {row['param_bytes']} bytes a rank and the reduced "
            f"gradient {row['grad_bytes']} (fp32) and an AdamW moment "
            f"{row['moment_bytes']} (adamw.init on the rank's blocks), and "
            f"a train step's arguments {row['argument_bytes']}, equal to "
            f"the dry run's "
            f"{row['rules']} blocks (launch.dryrun.cell_blocks; "
            f"argument_bytes {row['dryrun_argument_bytes']}; the whole-leaf "
            f"placement held "
            f"{row['whole_leaf_bytes']} bytes of weights, "
            f"{row['whole_leaf_bytes'] / row['param_bytes'] - 1:.1%} more); "
            f"the reshards' all-gathers {g['calls']}, {g['bytes']} bytes "
            f"given, host ms {g['host_ms']:.3f}")


def argument_bytes(row):
    """(mesh, MoE form, a rank's train-step argument bytes, the dry
    run's) of a ``grad_on_mesh`` row, for phase 18(c)."""
    return (row["shape"], row["impl"], row["argument_bytes"],
            row["dryrun_argument_bytes"])


def mesh_grad_fp32(dev, card, total):
    """Phase 17(a): the fp32 gradient of qwen3-moe-235b-a22b over a (1, 4)
    ``ep`` mesh against the one-card gather path's, with a planted fault;
    K5's and K5b's launches added to ``total``."""
    g = MESH_GRAD
    cfg32 = mesh_config(g["layers"], "float32",
                        moe_capacity_factor=g["capacity"])
    ranks, wall = run_mesh_job({
        "kind": "grad", "cfg": cfg32, "run": g, "compression": "none",
        "cases": [((1, 4), "ep")], "fault": True}, 4, dev)
    (row,) = check_mesh_grads(ranks, MESH_GRAD_BAR, "(a)", card)
    total["argument_bytes"].append(argument_bytes(row))
    n = [r["cases"][0]["launches"] for r in ranks]
    # under remat each layer's forward runs again in the backward
    k5 = (2 if cfg32.remat else 1) * cfg32.num_layers
    if any(x["K5"] != k5 or x["K5b"] != cfg32.num_layers for x in n):
        raise AssertionError(f"phase 17(a): K5/K5b launches per rank {n} "
                             f"(want {k5}, {cfg32.num_layers})")
    for x in n:
        for k in ("K5", "K5b"):
            total[k] += x[k]
    print(f"phase 17(a) {cfg32.name} ({describe(cfg32)}; TF32 off) over "
          f"(1, 4) ep, 4 ranks on the one card: batch {g['batch']} x "
          f"{g['seq']} (the whole batch a rank), one-card reference "
          f"{ranks[0]['ref']['s']:.1f} s on rank 0; the mesh's gradient "
          f"step ms per rank {[round(r['cases'][0]['ms'], 3) for r in ranks]}"
          f"; its reduction {row['reduce']['calls']} all-reduces, "
          f"{row['reduce']['bytes']} bytes, host ms "
          f"{row['reduce']['host_ms']:.3f}; {held_line(row)}; K5 {k5} "
          f"(remat), K5b {cfg32.num_layers} a rank; peak per rank "
          f"{[round(r['cases'][0]['peak_gb'], 2) for r in ranks]} GB; "
          f"{wall:.1f} s with the ranks' start; card {card}")



def mesh_grad_tp(dev, card, total):
    """Phase 17(d), (e) and (f): the fp32 gradient of qwen3-8b at full
    width against one card's (one job, one reference), over a (1, 4) mesh
    under ``TP_RULES`` (TP's compute split under autograd), (e) over (1,
    4) and (2, 2) under ``SEQPAR_RULES`` (the residual stream split over
    ``model`` along the sequence between blocks: the bytes each layer's
    remat unit keeps held to B S / model D 4, beside (d)'s B S D 4) and
    (f) over (2, 2) under ``DECODE_RULES`` (every rank the whole batch, the
    stream split over ``data`` along the hidden dim: B S D / data 4 kept,
    and no weight block resharded), in ``TP_GRAD_CASES``' order; K5's and
    K5b's launches added to ``total`` (the (2, 2) cases' also under
    ``k5_shapes`` and ``k5b_shapes``, by the rank's (B, H, KV, Sq, Skv,
    D))."""
    g = TP_GRAD
    cfg32 = as_fp32(qwen_config(TP_MODEL, g["layers"]))
    ranks, wall = run_mesh_job({
        "kind": "grad", "cfg": cfg32, "run": g, "compression": "none",
        "cases": [(shape, None, rules) for shape, rules in TP_GRAD_CASES],
        "fault": False}, 4, dev)
    labels = {"TP_RULES": "(d)", "SEQPAR_RULES": "(e)",
              "DECODE_RULES": "(f)"}
    rows = check_mesh_grads(ranks, MESH_GRAD_BAR, labels, card)
    D, B, S = cfg32.d_model, g["batch"], g["seq"]
    k5 = (2 if cfg32.remat else 1) * cfg32.num_layers
    tp = [r["rules"] for r in rows].index("TP_RULES")
    for i, row in enumerate(rows):
        what = labels[row["rules"]]
        decode2d = row["rules"] == "DECODE_RULES"
        data, model = row["shape"]
        n = [r["cases"][i]["launches"] for r in ranks]
        if any(x["K5"] != k5 or x["K5b"] != cfg32.num_layers for x in n):
            raise AssertionError(f"phase 17{what} {row['shape']}: K5/K5b "
                                 f"launches per rank {n} (want {k5}, "
                                 f"{cfg32.num_layers})")
        for x in n:
            for k in ("K5", "K5b"):
                total[k] += x[k]
        # the stream a layer's remat unit keeps: the rank's batch block
        # of the sequence, its rows of it under SEQPAR_RULES; under
        # DECODE_RULES the whole batch and the rank's block of the hidden
        # dim
        rows_a = S // model if row["rules"] == "SEQPAR_RULES" else S
        b_rank = B if decode2d else B // data
        width = D // data if decode2d else D
        want = b_rank * rows_a * width * 4
        kept = [r["cases"][i]["stream_bytes"] for r in ranks]
        if any(k != [want] for k in kept):
            raise AssertionError(f"phase 17{what} {row['shape']}: a layer's "
                                 f"input bytes per rank {kept}, want "
                                 f"{want} (B {b_rank} x S {rows_a} x D "
                                 f"{width} x 4)")
        if decode2d and (row["reshards"] or row["gathers"]["calls"]):
            raise AssertionError(f"phase 17(f) {row['shape']}: weight "
                                 f"blocks resharded {row['reshards']}, "
                                 f"all-gathers {row['gathers']}: under "
                                 f"DECODE_RULES no dense leaf moves")
        c, sq = row["collectives"], row["seq"]
        if row["rules"] == "SEQPAR_RULES" and not (
                sq["reduce-scatter"]["calls"] and sq["all-gather"]["calls"]):
            raise AssertionError(f"phase 17(e) {row['shape']}: the "
                                 f"sequence's collectives {sq}")
        if (data, model) == (2, 2):
            key = (b_rank, cfg32.num_heads // 2, cfg32.num_kv_heads // 2, S,
                   S, cfg32.resolved_head_dim)
            for name, k in (("k5_shapes", "K5"), ("k5b_shapes", "K5b")):
                total[name][key] = total[name].get(key, 0) + sum(
                    x[k] for x in n)
        print(f"phase 17{what} {cfg32.name} ({describe(cfg32)}; TF32 off) "
              f"over ({data}, {model}) {row['rules']}, 4 ranks on the one "
              f"card: batch {B} x {S} ({b_rank} x {S} a rank, "
              f"{cfg32.num_heads // model} heads and "
              f"{cfg32.num_kv_heads // model} kv heads a rank); a layer "
              f"keeps {want} bytes of the stream a rank (B {b_rank} x S "
              f"{rows_a} x D {width} x 4, held)"
              + ("; no weight block resharded, no all-gather (held)"
                 if decode2d else "")
              + f"; the mesh's gradient step ms per "
              f"rank {[round(r['cases'][i]['ms'], 3) for r in ranks]} "
              f"(counted collectives synchronize the card); all its "
              f"collectives {c['calls']}, {c['bytes']} bytes, host ms "
              f"{c['host_ms']:.3f}, of them the sequence's reduce-scatters "
              f"{sq['reduce-scatter']['calls']} "
              f"({sq['reduce-scatter']['bytes']} bytes given, host ms "
              f"{sq['reduce-scatter']['host_ms']:.3f}; gloo: an fp32 "
              f"all-reduce and a cut) and all-gathers "
              f"{sq['all-gather']['calls']} ({sq['all-gather']['bytes']} "
              f"bytes, host ms {sq['all-gather']['host_ms']:.3f}); the "
              f"gradient's reduction {row['reduce']['calls']} all-reduces, "
              f"{row['reduce']['bytes']} bytes; {held_line(row)}; K5 {k5} "
              f"(remat), K5b {cfg32.num_layers} a rank; peak per rank "
              f"{[round(r['cases'][i]['peak_gb'], 2) for r in ranks]} GB "
              f"((d), (1, 4) TP_RULES: "
              f"{[round(r['cases'][tp]['peak_gb'], 2) for r in ranks]}); "
              f"one-card reference {ranks[0]['ref']['s']:.1f} s on rank 0; "
              f"{wall:.1f} s for (d) and (e) with the ranks' start; card "
              f"{card}")


def mesh_grad_bf16(dev, card, time_ms, total):
    """Phase 17(b): the bf16 int8 gradient over (2, 2) ``ep`` and
    ``ep_resident`` against one card's, then K3 given the absmax at a
    rank's expert block; the launches added to ``total``.  Returns K3's
    given-absmax entry."""
    from repro_torch.models import transformer as T
    g = MESH_GRAD16
    cfg16 = mesh_config(g["layers"], moe_capacity_factor=g["capacity"])
    n_leaves = len(T.tree_leaves(T.param_shapes(cfg16)))
    ranks, wall = run_mesh_job({
        "kind": "grad", "cfg": cfg16, "run": g, "compression": "int8",
        "cases": MESH_GRAD16_CASES, "fault": False}, 4, dev)
    bar = {"loss": MESH_REL["bfloat16"], "leaf": MESH_REL["bfloat16"]}
    rows = check_mesh_grads(ranks, bar, "(b)", card)
    want = {"K5": (2 if cfg16.remat else 1) * cfg16.num_layers,
            "K5b": cfg16.num_layers, "K3": n_leaves, "K4": n_leaves}
    given = 0
    for i, row in enumerate(rows):
        total["argument_bytes"].append(argument_bytes(row))
        name = f"({row['shape'][0]}, {row['shape'][1]}) {row['impl']}"
        # K3 takes the whole leaf's absmax where a leaf is split over an
        # axis of more than one rank (expert and dense leaves alike)
        sizes = dict(zip(("data", "model"), row["shape"]))
        split = sum(1 for sp in row["specs"] if any(
            sizes[a] > 1 for part in sp if part is not None
            for a in ((part,) if isinstance(part, str) else part)))
        given += len(ranks) * split
        n = [r["cases"][i]["launches"] for r in ranks]
        if any(x != want for x in n):
            raise AssertionError(f"phase 17(b) {name}: launches per rank {n}"
                                 f", want {want}")
        for x in n:
            for k, v in x.items():
                total[k] += v
        c = row["collectives"]
        print(f"phase 17(b) {name} ({describe(cfg16)}), int8 gradients: "
              f"batch {g['batch']} x {g['seq']} (a data block of "
              f"{g['batch'] // 2} a rank); gradient step ms per rank "
              f"{[round(r['cases'][i]['ms'], 3) for r in ranks]} (counted "
              f"collectives synchronize the card; the check before int8 "
              f"inside it, {row['check_ms']:.3f} ms on rank 0, taken out); "
              f"launches a rank K5 "
              f"{want['K5']} (remat), K5b {want['K5b']}, K3 {want['K3']} "
              f"({split} given the whole leaf's absmax), K4 {want['K4']} "
              f"(one a leaf the rank compresses); the gradient's reduction "
              f"alone {row['reduce']['calls']} all-reduces, "
              f"{row['reduce']['bytes']} bytes, host ms "
              f"{row['reduce']['host_ms']:.3f}; all the step's collectives "
              f"{c['calls']}, {c['bytes']} bytes, host ms "
              f"{c['host_ms']:.3f}; {held_line(row)}; peak placing / step "
              f"per rank "
              f"{[round(r['cases'][i]['place_peak_gb'], 2) for r in ranks]}"
              f" / {[round(r['cases'][i]['peak_gb'], 2) for r in ranks]} GB"
              f"; host memory available after the step "
              f"{row['host_gb']:.1f} GB"
              f"; card {card}")
    print(f"phase 17(b) one-card bf16 reference on rank 0: "
          f"{ranks[0]['ref']['s']:.1f} s; both meshes {wall:.1f} s with the "
          f"ranks' start; K3 given the whole leaf's absmax {given} times "
          f"(each rank's split leaves, dense and expert)")
    ep = MESH_GRAD16_CASES[0][0]
    k3_given = check_k3_given(dev, time_ms, cfg16.num_experts // ep[1]
                              * cfg16.d_model // ep[0] * cfg16.moe_d_ff)
    k3_given["mesh_launches"] = given
    return k3_given



def mesh_train_dp(dev, card, total):
    """Phase 17(c): Mamba-2 370M trained over a (2, 1) mesh through
    ``launch.train.train`` against the one-card launcher: the losses, the
    unsplit leaves byte-equal on both ranks, each rank's parameter and
    moment bytes equal to its spec blocks, and the final parameters,
    gathered from the blocks, held to one card's (``MESH_REL``'s bf16 bar
    over the whole tree in relative Frobenius error); the launches added
    to ``total``."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import vector_engine as VE
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    run = MESH_DP
    cfg = mamba_config()
    counted = (SSD.ssd_scan, SSD.ssd_scan_bwd, VE.quantize_int8,
               VE.dequantize_int8)
    with training_config(cfg, counted) as one:
        t0 = time.perf_counter()
        ref = TR.train(MAMBA, smoke=False, steps=run["steps"],
                       batch=run["batch"], seq=run["seq"], seed=0,
                       device=dev, log_every=run["steps"],
                       grad_compression="int8")
        one_s = time.perf_counter() - t0
    one_final = [t.detach().float().cpu() for t in T.tree_leaves(one.last[1])]
    del one.last
    world = math.prod(run["shape"])
    ranks, wall = run_mesh_job({"kind": "train", "run": run}, world, dev)
    n_leaves = len(T.tree_leaves(T.param_shapes(cfg)))
    # under remat each layer's forward (K8) runs again in the backward
    want = {"K8": (2 if cfg.remat else 1) * cfg.num_layers,
            "K8b": cfg.num_layers, "K3": n_leaves, "K4": n_leaves}
    losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:2], ref[:2])]
    for r, rec in enumerate(ranks):
        bad = [x for x in rec["launches"] if x != want]
        held = (rec["param_bytes"] == rec["spec_bytes"]
                and rec["moment_bytes"] == rec["spec_moment_bytes"])
        if (bad or rec["losses"] != losses or not all(rec["same"])
                or rec["saved"] != [run["steps"]] or not held):
            raise AssertionError(f"phase 17(c) rank {r}: launches "
                                 f"{rec['launches']} (want {want} a step), "
                                 f"losses {rec['losses']} vs rank 0's "
                                 f"{losses}, unsplit leaves byte-equal across "
                                 f"ranks after each step {rec['same']}, "
                                 f"checkpoints {rec['saved']}, bytes "
                                 f"{rec['param_bytes']} / "
                                 f"{rec['moment_bytes']} vs the spec's "
                                 f"{rec['spec_bytes']} / "
                                 f"{rec['spec_moment_bytes']}")
        for x in rec["launches"]:
            for k, v in x.items():
                total[k] += v
    if not (len(losses) == run["steps"] and all(map(math.isfinite, losses))
            and losses[-1] < losses[0] and rel[0] <= MESH_DP_BARS[0]
            and rel[1] <= MESH_DP_BARS[1]):
        raise AssertionError(f"phase 17(c): losses {losses} vs one card "
                             f"{ref} (first two rel {rel}, limits "
                             f"{MESH_DP_BARS})")
    B, S = run["batch"], run["seq"]
    r0 = ranks[0]
    names = leaf_names(T.param_defs(cfg))
    num = den = 0.0
    leaf_rel = []
    for got, want_t in zip(r0["final"], one_final):
        d = (got.float() - want_t).double().square().sum().item()
        w = want_t.double().square().sum().item()
        num, den = num + d, den + w
        leaf_rel.append(math.sqrt(d / w) if w else math.sqrt(d))
    tree_rel = math.sqrt(num / den)
    worst = sorted(zip(leaf_rel, names), reverse=True)[:3]
    if not tree_rel <= MESH_REL["bfloat16"]:
        raise AssertionError(f"phase 17(c): the gathered parameters after "
                             f"{run['steps']} steps are {tree_rel:.3e} from "
                             f"one card's (limit {MESH_REL['bfloat16']}); "
                             f"worst leaves {worst}")
    del r0["final"], one_final
    med = statistics.median(r0["step_ms"][2:])
    red = r0["reduce"][-1]
    gat = r0["gathers"][-1]
    print(f"phase 17(c) {MAMBA} ({cfg.num_layers} layers, {cfg.dtype}, "
          f"{T.count_params(cfg)} parameters) through launch.train.train("
          f"mesh=) over {run['shape']}, {world} ranks on the one card: global"
          f" batch {B} x {S} ({B // world} x {S} a rank), int8 gradients, "
          f"{run['steps']} steps: losses {[round(l, 4) for l in losses]} vs "
          f"one card {[round(l, 4) for l in ref]} (first two rel "
          f"{rel[0]:.2e}, {rel[1]:.2e}; limits {MESH_DP_BARS}); "
          f"{r0['split']} of {n_leaves} leaves stored split (FSDP over data),"
          f" the other leaves of the parameters and moments byte-equal on "
          f"both ranks after each step; the final parameters, gathered, "
          f"within {tree_rel:.3e} of one card's over the tree (limit "
          f"{MESH_REL['bfloat16']}; worst leaves "
          + ", ".join(f"{n} {v:.2e}" for v, n in worst)
          + f"); a rank's parameters {r0['param_bytes']} and moments "
          f"{r0['moment_bytes']} bytes, equal to its spec blocks (the "
          f"whole-leaf placement held {r0['whole_leaf_bytes']} bytes of "
          f"parameters); the reshards' all-gathers a step {gat['calls']}, "
          f"{gat['bytes']} bytes given, host ms per step "
          f"{[round(x['host_ms'], 3) for x in r0['gathers']]}; "
          f"step ms rank 0 {[round(t, 3) for t in r0['step_ms']]}"
          f", rank 1 {[round(t, 3) for t in ranks[1]['step_ms']]} (median of "
          f"steps 3-{run['steps']} {med:.3f}, {B * S / med * 1e3:.1f} "
          f"tokens/s over both); one card "
          f"{[round(t, 3) for t in one.step_ms]}; the reduction a step "
          f"{red['calls']} all-reduces, {red['bytes']} bytes, host ms per "
          f"step {[round(x['host_ms'], 3) for x in r0['reduce']]}; launches "
          f"a step per rank K8 {want['K8']} (remat), K8b {want['K8b']}, K3 "
          f"{want['K3']} ({r0['split']} given the whole leaf's absmax), K4 "
          f"{want['K4']}; peak per rank "
          f"{[round(x['peak_gb'], 2) for x in ranks]} GB; one card "
          f"{one_s:.1f} s, the mesh {wall:.1f} s with the ranks' start; "
          f"card {card}")


def drive_mesh_train(dev, card, time_ms):
    """Phase 17: training over a mesh of ranks sharing the card (gloo):
    ``mesh_grad_fp32``, ``mesh_grad_tp`` ((d) and (e)),
    ``mesh_grad_bf16``, ``mesh_train_dp``.  Returns the
    launches of K3, K4, K5, K5b, K8 and K8b in its mesh runs, summed over
    the ranks (each (a)/(b) case's ``argument_bytes`` under that key, and
    K5's and K5b's at (e)'s and (f)'s (2, 2) rank shapes, (B, H, KV, Sq,
    Skv, D), under ``k5_shapes`` and ``k5b_shapes``), and K3's
    given-absmax entry."""
    from repro_torch.kernels import _build
    _build.build_all()
    total = dict.fromkeys(("K3", "K4", "K5", "K5b", "K8", "K8b"), 0)
    total["argument_bytes"], total["k5_shapes"] = [], {}
    total["k5b_shapes"] = {}
    mesh_grad_fp32(dev, card, total)
    mesh_grad_tp(dev, card, total)
    k3_given = mesh_grad_bf16(dev, card, time_ms, total)
    mesh_train_dp(dev, card, total)
    return total, k3_given

# ---------------------------------------------------------------------------
# Phase 18: the fleet's ClusterSim and the dry run
# ---------------------------------------------------------------------------

# (b): the dry run's cells (arch, shape, rules), each a subprocess with the
# card hidden from it; qwen3-8b's train_4k under train and seqpar side by
# side (the residual stream split along the sequence between blocks)
DRYRUN_CELLS = [("qwen3-moe-235b-a22b", "train_4k", "train"),
                ("qwen3-8b", "prefill_32k", "train"),
                ("qwen3-8b", "train_4k", "train"),
                ("qwen3-8b", "train_4k", "seqpar")]
DRYRUN_TIMEOUT_S = 300
# (a): clocks a spin holds the stream before each timed K6 launch (~1 ms,
# several times the host's time to issue the events and the launch)
SPIN_CYCLES = 2_000_000


def start_dryruns(out_dir):
    """Phase 18(b), started: ``python -m repro_torch.launch.dryrun`` for
    each of DRYRUN_CELLS on the single-pod mesh under its rules, each in
    its own process with CUDA_VISIBLE_DEVICES empty, writing its record
    under ``out_dir``; returns the processes, which are killed at exit if
    still running (a phase before 18 failed)."""
    import atexit
    import os
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "single", "--rules", cell[2],
         "--out", str(out_dir), "--force"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cell in DRYRUN_CELLS]
    atexit.register(lambda: [p.kill() for _, p in procs if p.poll() is None])
    return procs


def finish_dryruns(procs, out_dir, card):
    """Phase 18(b): each dry run exits 0 with status ok, no kernel
    launched, no kernel library loaded or built (the build directory as it
    was) and CUDA never initialised; prints its roofline line, its peak,
    temporaries and collectives by kind.  A ``seqpar`` cell takes the
    ``train`` cell's argument bytes, fewer temporary bytes, and
    reduce-scatters."""
    from repro_torch.kernels import _build
    built = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    recs = {}
    for (arch, shape, rules), proc in procs:
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        path = out_dir / f"{arch}__{shape}__single__{rules}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode != 0 or rec.get("status") != "ok":
            raise AssertionError(f"phase 18(b) dry run {arch} {shape}: exit "
                                 f"{proc.returncode}, status "
                                 f"{rec.get('status')}: {out[-3000:]}")
        launched = {k: v for k, v in rec["kernel_launches"].items() if v}
        if (launched or rec["libraries_loaded"] or rec["cuda_initialized"]
                or rec["raw"]["real"]["card_tensor_ops"]):
            raise AssertionError(f"phase 18(b) dry run {arch} {shape}: "
                                 f"launches {launched}, libraries "
                                 f"{rec['libraries_loaded']}, CUDA "
                                 f"initialised {rec['cuda_initialized']}")
        t, m = rec["roofline"], rec["memory"]
        recs[arch, shape, rules] = rec
        coll = rec["raw"]["real"]["coll_detail"]
        print(f"phase 18(b) dry run {arch} {shape} single (16, 16) {rules} "
              f"rules, meta tensors over a fake group of 256 ranks, card "
              f"hidden: exit 0, status ok, no kernel launched, no library "
              f"loaded, CUDA not initialised; flops/chip "
              f"{t['flops_per_chip']:.4e} bytes/chip "
              f"{t['bytes_per_chip']:.4e} coll/chip "
              f"{t['coll_bytes_per_chip']:.4e}; roofline at the H100's "
              f"peaks (analytic, not measured): compute {t['compute_s']:.4f} "
              f"s memory {t['memory_s']:.4f} s collective "
              f"{t['collective_s']:.4f} s dominant {t['dominant']} useful "
              f"ratio {t['useful_ratio']:.3f} roofline fraction "
              f"{t['roofline_fraction']:.4f}; argument_bytes "
              f"{m['argument_bytes']} alias_bytes {m['alias_bytes']} "
              f"temp_bytes {m['temp_bytes']} peak_bytes {m['peak_bytes']} "
              f"({m['peak_bytes'] / 1e9:.2f} GB a rank); collectives by "
              f"kind (count, result bytes, traffic bytes) "
              + ", ".join(f"{k} ({int(v['count'])}, {v['result_bytes']:.4e}, "
                          f"{v['traffic_bytes']:.4e})"
                          for k, v in sorted(coll.items()))
              + f"; wall {rec['wall_s']:.1f} s")
    for (arch, shape, rules), rec in recs.items():
        train = recs.get((arch, shape, "train"))
        if rules != "seqpar" or train is None:
            continue
        m, tm = rec["memory"], train["memory"]
        if not (m["argument_bytes"] == tm["argument_bytes"]
                and m["temp_bytes"] < tm["temp_bytes"]
                and "reduce-scatter" in rec["raw"]["real"]["coll_detail"]):
            raise AssertionError(f"phase 18(b) {arch} {shape} seqpar: "
                                 f"argument bytes {m['argument_bytes']} "
                                 f"(train {tm['argument_bytes']}), temp "
                                 f"{m['temp_bytes']} (train "
                                 f"{tm['temp_bytes']}), collectives "
                                 f"{sorted(rec['raw']['real']['coll_detail'])}")
        print(f"phase 18(b) {arch} {shape} seqpar beside train: the same "
              f"argument bytes {m['argument_bytes']}; temp bytes "
              f"{m['temp_bytes']} vs {tm['temp_bytes']} "
              f"({(tm['temp_bytes'] - m['temp_bytes']) / 1e9:.2f} GB less), "
              f"peak {m['peak_bytes'] / 1e9:.2f} vs "
              f"{tm['peak_bytes'] / 1e9:.2f} GB a rank")
    if sorted(p.name for p in _build.BUILD_DIR.glob("*.so")) != built:
        raise AssertionError("phase 18(b): the build directory changed")


def drive_sim(dev, card):
    """Phase 18(a): phase 6's fleet (FLEET) through the façade,
    ``core.scheduler.ClusterSim.run_sharded``, run ``segmented, cuda, cuda,
    segmented``: each cuda run's trace and its queue, power and fault
    books and telemetry byte-identical to the first segmented run's, K6
    launched once for each of its solves; then one cuda run with each K6
    launch between two CUDA events, for K6's device time (the profiler
    sees no device time in this process after phases 16-17's ranks): a
    spin on the stream first holds it while the host issues the events
    and the launch, so they bracket the kernel alone.  Returns the
    launches a cuda run."""
    import numpy as np
    import torch

    from repro_torch.core import lindley as L
    from repro_torch.core.arrivals import make_arrivals
    from repro_torch.core.function import standard_pipeline
    from repro_torch.core.latency import LatencyModel
    from repro_torch.core.platforms import PLATFORMS
    from repro_torch.core.scheduler import ClusterSim
    from repro_torch.kernels import ops
    from repro_torch.kernels.lindley import lindley_scan

    pipes = [standard_pipeline(n)
             for n in ("asset_damage", "content_moderation")]
    lm = LatencyModel()
    svc = sum(lm.e2e(PLATFORMS["DSCS-Serverless"], p.workload, q=0.5)
              for p in pipes) / len(pipes)
    rate = FLEET["utilization"] * FLEET["n_dscs"] / svc
    duration = FLEET["requests"] / rate

    def run(backend):
        sim = ClusterSim(n_dscs=FLEET["n_dscs"], n_cpu=FLEET["n_cpu"],
                         hedge_budget_s=FLEET["hedge_budget_s"], seed=0)
        before = lindley_scan.launches
        t0 = time.perf_counter()
        tr = sim.run_sharded(pipes, arrivals=make_arrivals("poisson", rate),
                             duration_s=duration, n_shards=FLEET["n_shards"],
                             processes=1, backend=backend)
        torch.cuda.synchronize()
        return (sim, tr, time.perf_counter() - t0,
                lindley_scan.launches - before)

    def books(sim):
        return repr((sim.queue_stats(), sim.engine.power_stats(),
                     sim.fault_stats(), dict(sim.telemetry.counters)))

    solves = []
    real_solve = L.solve_segments

    def record_solve(seg, t, s, start, fin, *, backend):
        solves.append(t.size)
        return real_solve(seg, t, s, start, fin, backend=backend)

    L.solve_segments = record_solve
    try:
        runs = [run("segmented")]
    finally:
        L.solve_segments = real_solve
    want = sum(1 for n in solves if n)
    order = ("cuda", "cuda", "segmented")
    runs += [run(b) for b in order]
    base, base_tr = runs[0][0], runs[0][1]
    for (sim, tr, _, n), backend in zip(runs[1:], order):
        for col in ("arrival", "finish", "winner", "drive", "start",
                    "service", "hedged", "dscs_finish", "cpu_finish"):
            if getattr(tr, col).tobytes() != getattr(base_tr, col).tobytes():
                raise AssertionError(f"phase 18(a) ClusterSim {backend}: "
                                     f"column {col} differs from segmented")
        if tr.events != base_tr.events or books(sim) != books(base):
            raise AssertionError(f"phase 18(a) ClusterSim {backend}: books "
                                 f"differ from segmented")
        if n != (want if backend == "cuda" else 0) or not want:
            raise AssertionError(f"phase 18(a) ClusterSim {backend}: K6 "
                                 f"launched {n} times for {want} solves")
    lat = base_tr.latency[base_tr.completed]
    if not (np.isfinite(lat).all() and base_tr.n > 0.99 * FLEET["requests"]
            and base.engine.last_shard_stats["path"] == "partitioned"):
        raise AssertionError(f"phase 18(a): {lat.size} of {base_tr.n} "
                             f"requests completed")
    events = []
    launch = ops.lindley_scan_segments

    def timed(seg, t, s):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(SPIN_CYCLES)
        pair[0].record()
        out = launch(seg, t, s)
        pair[1].record()
        events.append(pair)
        return out

    ops.lindley_scan_segments = timed
    try:
        _, _, timed_wall, _ = run("cuda")
    finally:
        ops.lindley_scan_segments = launch
    k6_ms = sum(a.elapsed_time(b) for a, b in events)
    walls = [w for _, _, w, _ in runs]
    print(f"phase 18(a) ClusterSim.run_sharded poisson-1m-f1024: "
          f"{base_tr.n} requests, {FLEET['n_dscs']} DSCS + {FLEET['n_cpu']} "
          f"CPU, {FLEET['n_shards']} shards, processes=1; host wall s "
          f"segmented {walls[0]:.3f}, cuda {walls[1]:.3f}, cuda "
          f"{walls[2]:.3f}, segmented {walls[3]:.3f}; cuda traces, queue, "
          f"power and fault books and telemetry byte-identical to "
          f"segmented; K6 launches {want} per cuda run = its solves with a "
          f"non-empty input; K6 device ms over a cuda run's {len(events)} "
          f"launches (CUDA events around each, the stream held by a spin "
          f"while they are issued; wall {timed_wall * 1e3:.1f} ms): "
          f"{k6_ms:.4f}; card {card}")
    return want


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import executor as E
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.lindley import lindley_scan
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.systolic_matmul import (_ACTS, _lib, tile_plan,
                                                     systolic_matmul,
                                                     systolic_matmul_plain)
    from repro_torch.kernels.vector_engine import (fused_affine_act,
                                                   fused_affine_act_plain)
    from repro_torch.models import vision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (systolic_matmul, fused_affine_act, flash_attention)
    t_start = time.perf_counter()

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.splitlines() if "Used " in ln})
        spills = any("spill" in ln and not ln.strip().startswith("0 bytes")
                     and " 0 bytes spill stores, 0 bytes spill loads" not in ln
                     for ln in log.splitlines())
        print(f"  {name}: ptxas {', '.join(regs)}; spills: {spills}")
    for kernel, source in (("quantize_int8_kernel", "vector_engine"),
                           ("rglru_chunked_kernel", "rglru"),
                           ("rglru_bwd_chunked_kernel", "rglru"),
                           ("flash_bwd_bf16_kernel", "flash_attention"),
                           ("flash_tf32_kernel", "flash_attention"),
                           ("flash_bwd_dq_tf32_kernel", "flash_attention"),
                           ("flash_bwd_dkdv_tf32_kernel", "flash_attention")):
        for row in _build.ptxas_counts(logs.get(source, ""), kernel):
            print(f"  {kernel}{row['instance'][:24]}: ptxas "
                  f"{row['registers']} registers, {row['smem']} bytes shared "
                  f"memory, {row['spilled']} bytes spilled")
    bwd_ptxas = {name: [{k: row[k] for k in ("registers", "spilled")}
                        for row in _build.ptxas_counts(logs.get(src, ""), kernel)]
                 for name, kernel, src in (
                     ("flash_attention_bwd", "flash_bwd_bf16_kernel",
                      "flash_attention"),
                     ("rglru_scan_bwd", "rglru_bwd_chunked_kernel", "rglru"))}
    # the fp32 (3xTF32) kernels' instances: K5's, and K5b's two passes
    fp32_ptxas = {kernel: [{k: row[k] for k in ("instance", "registers",
                                                "spilled")}
                           for row in _build.ptxas_counts(
                               logs.get("flash_attention", ""), kernel)]
                  for kernel in ("flash_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                                 "flash_bwd_dkdv_tf32_kernel")}
    k1_regs = k1_ptxas(logs.get("systolic_matmul", ""))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k1_design(M, K, N, dtype):
        """K1's plan for a shape and its instance's ptxas counts."""
        esz = torch.tensor([], dtype=dtype).element_size()
        bm, bn, sl = tile_plan(M, K, N, sms, bk=128 // esz)
        name = str(dtype).split(".")[1]
        regs, spill = k1_regs.get((name, bm, bn), ("(not rebuilt)", "?"))
        smem = _lib().systolic_matmul_smem_bytes(bm, bn,
                                                 _build.dtype_code(dtype))
        kind = "3xtf32" if dtype == torch.float32 else "bf16"
        return (f"{kind}-wgmma tile {bm}x{bn} cluster {sl}; ptxas {regs} "
                f"registers, {spill} B spilled, {smem} B shared")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def events_ms(run, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def call_ms(fn, reps=20):
        """Per call as Python issues it: host launch cost included."""
        fn()
        return events_ms(fn, reps)

    def time_ms(fn, reps=10):
        """Device time per call: `reps` calls captured in one CUDA graph,
        replayed, so the host's launch cost drops out."""
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
        return events_ms(graph.replay, 5) / reps

    def max_err(got, want, rtol, atol, what):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite output")
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                                 f"rtol={rtol} atol={atol}, max err "
                                 f"{err.max().item():.3e}")
        return err.max().item()

    # ---- 3. kernels against their plain versions -------------------------
    # K1 tolerance as tests/test_kernels.py::test_systolic_matmul states it.
    def k1_tol(dtype, K):
        bf = dtype == torch.bfloat16
        return (0.05 if bf else 1e-4), (2e-2 if bf else 2e-4) * max(1, K // 64)

    for (M, K, N) in [(12544, 147, 64), (3136, 576, 64), (777, 300, 130)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = randn(M, K, dtype=dtype), randn(K, N, dtype=dtype), \
                randn(N, dtype=dtype)
            rtol, atol = k1_tol(dtype, K)
            err = 0.0
            for act in _ACTS:
                for bias in (None, b):
                    err = max(err, max_err(
                        systolic_matmul(x, w, bias, act=act),
                        systolic_matmul_plain(x, w, bias, act=act), rtol, atol,
                        f"K1 {M}x{K}x{N} {dtype} {act} bias={bias is not None}"))
            ms = time_ms(lambda: systolic_matmul(x, w))
            plain = time_ms(lambda: systolic_matmul_plain(x, w))
            lib = time_ms(lambda: torch.matmul(x, w))
            (bnd, by), fma = k1_bounds(M, K, N, dtype)
            fma = "" if fma is None else \
                f" bound_fma_ms={fma[0]:.4f} ({fma[1]})"
            print(f"K1 systolic_matmul M={M} K={K} N={N} {dtype}: 12 cases "
                  f"(6 acts x bias) max_abs_err={err:.3e} rtol={rtol} "
                  f"atol={atol:.0e}; ms={ms:.4f} (per Python call "
                  f"{call_ms(lambda: systolic_matmul(x, w)):.4f}) plain_ms={plain:.4f} "
                  f"library_ms(torch.matmul)={lib:.4f} bound_ms={bnd:.4f} "
                  f"({by}){fma}; {k1_design(M, K, N, dtype)}")

    k2_rows = {}
    for (M, N) in [(1, 150528), (256, 1024)]:
        x, s, b = randn(M, N), randn(N), randn(N)
        err = max(max_err(fused_affine_act(x, s, b, act=a),
                          fused_affine_act_plain(x, s, b, act=a), 1e-5, 1e-5,
                          f"K2 {M}x{N} {a}") for a in _ACTS)
        ms = time_ms(lambda: fused_affine_act(x, s, b))
        plain = time_ms(lambda: fused_affine_act_plain(x, s, b))
        lib = time_ms(lambda: torch.addcmul(b, x, s))
        bnd, by = k2_bound(M, N, torch.float32)
        # K2 and torch.addcmul in turns (K2, addcmul, addcmul, K2) x 5
        turns = {"kernel": [], "library": []}
        for _ in range(5):
            for who in ("kernel", "library", "library", "kernel"):
                turns[who].append(time_ms(
                    (lambda: fused_affine_act(x, s, b)) if who == "kernel"
                    else (lambda: torch.addcmul(b, x, s))))
        turns = {k: statistics.median(v) for k, v in turns.items()}
        k2_rows[(M, N)] = (err, ms, plain, lib, bnd, by, turns)
        print(f"K2 fused_affine_act M={M} N={N} float32: 6 acts "
              f"max_abs_err={err:.3e} rtol=1e-5 atol=1e-5; ms={ms:.4f} "
              f"(per Python call {call_ms(lambda: fused_affine_act(x, s, b)):.4f}) "
              f"plain_ms={plain:.4f} library_ms(torch.addcmul)={lib:.4f} "
              f"bound_ms={bnd:.4f} ({by}); in turns, medians of 10: K2 "
              f"{turns['kernel']:.4f}, torch.addcmul {turns['library']:.4f}")
    # K2 off the 16-byte vector: an N no multiple of 4, an x base one
    # element past a fresh allocation
    for (M, N, off) in [(1, 150527, 0), (1, 150528, 1), (256, 1023, 0)]:
        x = randn(M * N + off)[off:].view(M, N)
        s, b = randn(N), randn(N)
        err = max(max_err(fused_affine_act(x, s, b, act=a),
                          fused_affine_act_plain(x, s, b, act=a), 1e-5, 1e-5,
                          f"K2 {M}x{N} offset {off} {a}") for a in _ACTS)
        print(f"K2 fused_affine_act M={M} N={N} x at element offset {off} "
              f"float32: 6 acts max_abs_err={err:.3e} rtol=1e-5 atol=1e-5; "
              f"ms={time_ms(lambda: fused_affine_act(x, s, b)):.4f} "
              f"library_ms(torch.addcmul)="
              f"{time_ms(lambda: torch.addcmul(b, x, s)):.4f}")

    k5_rows = {}
    for (B, H, KV, Sq, Skv, D, causal, window) in [
            (1, 4, 4, 17, 17, 32, False, 0), (1, 4, 4, 122, 122, 32, False, 0),
            (2, 8, 2, 512, 512, 64, True, 128),
            (1, 2, 2, 128, 32, 64, False, 16)]:      # rows that see no key
        for dtype in (torch.float32, torch.bfloat16):
            k5_rows[(Sq, dtype)] = check_k5_case(
                (B, H, KV, Sq, Skv, D), causal, window, dtype, randn,
                time_ms, call_ms, max_err)

    def mark(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase}", flush=True)

    mark("K6 and K8 against their plain versions")
    k6_err = check_k6(dev, time_ms, call_ms)
    k8_err, k8_times = check_k8(dev, time_ms, call_ms, max_err)

    # ---- 4. the executor for every non-LM workload -----------------------
    mark("4, the executor")
    for wl in list(E._MODEL_BUILDERS) + ["credit_risk"]:
        ex = E.DSCSExecutor(wl)
        req = ex.make_request(torch.Generator().manual_seed(1))
        for c in counters:
            c.launches = 0
        rep = ex(req)
        torch.cuda.synchronize()
        n = [c.launches for c in counters]
        if not (rep.accelerated and rep.latency_breakdown["total"] > 0
                and rep.energy_breakdown["total"] > 0):
            raise AssertionError(f"{wl}: report {rep}")
        if wl == "credit_risk":
            if n != [0, 0, 0] or not torch.isfinite(rep.result).all():
                raise AssertionError(f"{wl}: launches {n}, result {rep.result}")
            print(f"executor {wl}: result {rep.result.flatten().tolist()} "
                  f"(no kernel on this path)")
            continue
        apply = E._MODEL_BUILDERS[wl][1]
        x = E._preprocess_vector_engine(req, use_kernel=False)
        got = apply(ex.params, x, use_kernel=True)
        want = apply(ex.params, x, use_kernel=False)
        rel = ((got - want).norm() / want.norm()).item()
        vit = wl == "remote_sensing"
        want_n = [0 if vit else n[0], 1, 4 if vit else 0]
        if n != want_n or n[0 if not vit else 2] == 0 or not rel <= 1e-4:
            raise AssertionError(f"{wl}: launches K1/K2/K5 {n} (want {want_n}),"
                                 f" f2 rel err {rel:.3e} (limit 1e-4)")
        if wl == "asset_damage" and n[0] != RESNET_LAUNCHES:
            raise AssertionError(f"{wl}: {n[0]} K1 launches, want 53")
        print(f"executor {wl} image {ex.image_size}: launches K1={n[0]} "
              f"K2={n[1]} K5={n[2]}; f2 kernel vs plain rel err {rel:.3e} "
              f"(limit 1e-4); out {tuple(got.shape)}")

    # ---- 5. the main path: full-width ResNet-50, the ViT, the LM requests -
    mark("5, the main path")
    resnet = E.DSCSExecutor("asset_damage", image_size=224)
    resnet.params = vision.resnet50_init(torch.Generator().manual_seed(0),
                                         width=1.0)
    vit = E.DSCSExecutor("remote_sensing", image_size=176)
    lms = [E.DSCSExecutor(wl) for wl in E._LM_WORKLOADS]
    served = [(ex, [ex.make_request(torch.Generator().manual_seed(100 + i))
                    for i in range(REQUESTS)]) for ex in (resnet, vit, *lms)]
    for ex, reqs in served:                       # one warm request each
        ex(reqs[0])
    torch.cuda.synchronize()

    # shapes K1 sees in one ResNet-50 request, recorded outside the counted run
    k1_shapes = []
    real = ops.matmul_padded

    def record(x, w, *a, **kw):
        k1_shapes.append((x.shape[0], x.shape[1], w.shape[1],
                          not w.is_contiguous()))
        return real(x, w, *a, **kw)

    ops.matmul_padded = record
    try:
        vision.resnet50_apply(resnet.params, E._preprocess_vector_engine(
            served[0][1][0], use_kernel=False), use_kernel=True)
    finally:
        ops.matmul_padded = real

    for c in counters:
        c.launches = 0
    reports, ms_per, after = {}, {}, {}
    for ex, reqs in served:
        name = ex.pipeline.name
        reports[name], ms_per[name] = [], []
        for r in reqs:
            t0 = time.perf_counter()
            rep = ex(r)
            torch.cuda.synchronize()
            ms_per[name].append((time.perf_counter() - t0) * 1e3)
            reports[name].append(rep)
        if name in ("asset_damage", "remote_sensing"):
            after[name] = [c.launches for c in counters]
    launches = [c.launches for c in counters]

    # K5 a request: one a ViT layer (4), one a reduced qwen3-8b layer (2)
    want = {"asset_damage": [RESNET_LAUNCHES * REQUESTS, REQUESTS, 0],
            "remote_sensing": [RESNET_LAUNCHES * REQUESTS, 2 * REQUESTS,
                               4 * REQUESTS]}
    want_all = [RESNET_LAUNCHES * REQUESTS, 2 * REQUESTS,
                (4 + 2 * len(lms)) * REQUESTS]
    if after != want or launches != want_all:
        raise AssertionError(f"main path launches K1/K2/K5: after ResNet-50 "
                             f"and the ViT {after} (want {want}), in all "
                             f"{launches} (want {want_all})")

    def plain_k5(q, k, v, *, causal, window, **pos):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     **pos)

    for ex, reqs in served:
        name = ex.pipeline.name
        lm = name in E._LM_WORKLOADS
        worst = 0.0
        for r, rep in zip(reqs, reports[name]):
            if lm:        # f2 with K5, and with its plain version swapped in
                got = ex._apply(ex.params, r)
                ops.flash_attention = plain_k5
                try:
                    want = ex._apply(ex.params, r)
                finally:
                    ops.flash_attention = flash_attention
                shape = (1, 32, ex._cfg.padded_vocab)
            else:
                apply = E._MODEL_BUILDERS[name][1]
                x = E._preprocess_vector_engine(r, use_kernel=False)
                got = apply(ex.params, x, use_kernel=True)
                want = apply(ex.params, x, use_kernel=False)
                shape = (1, 1000)
            rel = ((got - want).norm() / want.norm()).item()
            worst = max(worst, rel)
            if not (torch.isfinite(got).all() and rel <= 1e-3
                    and torch.equal(rep.result, want.argmax(-1))
                    and tuple(got.shape) == shape):
                raise AssertionError(
                    f"{name}: logits {tuple(got.shape)} rel err {rel:.3e} "
                    f"(limit 1e-3), class {rep.result.tolist()} vs plain "
                    f"{want.argmax(-1).tolist()}")
        ms = ms_per[name]
        what = ("(1, 32) int32 tokens, reduced qwen3-8b" if lm
                else f"image {ex.image_size}")
        print(f"main path {name} {what}: {REQUESTS} requests, "
              f"ms per request {[round(t, 3) for t in ms]} "
              f"(median {statistics.median(ms):.3f}); logits vs plain "
              f"path max rel err {worst:.3e} (limit 1e-3), same "
              f"{'tokens' if lm else 'class'}; card {card}")
    print(f"main path launches: K1={launches[0]} ({launches[0] // REQUESTS} "
          f"per ResNet-50 request) K2={launches[1]} K5={launches[2]} "
          f"(4 per ViT request, 2 per chatbot or translation request; "
          f"K1/K2 none on those)")

    # where one ResNet-50 request's device time goes: kernel events only
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in served[0][1][:2]:
            resnet(r)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 2e3
    if device_ms == 0:
        print("profile: device time not measured (the profiler saw none)")
    else:
        host_ms = statistics.median(ms_per["asset_damage"])
        top = "; ".join(
            f"{e.key[:40]} x{e.count // 2} {e.self_device_time_total / 2e3:.3f} ms"
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8])
        print(f"profile ResNet-50 request: device busy {device_ms:.3f} ms of "
              f"{host_ms:.3f} ms on the host clock (idle share "
              f"{1 - device_ms / host_ms:.3f}); kernels by device time: {top}")
        ops_ = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        host_top = "; ".join(
            f"{e.key[:32]} x{e.count // 2} {e.self_cpu_time_total / 2e3:.3f} ms"
            for e in sorted(ops_, key=lambda e: -e.self_cpu_time_total)[:8])
        print(f"profile ResNet-50 request (profiler on): host self time by "
              f"op: {host_top}")

    mark("6-7, the fleet")
    k6_entry = drive_fleet(dev, time_ms, call_ms)
    mark("8, Mamba-2 serving")
    k8_launches = drive_lm(dev, counters + (lindley_scan, ssd_scan))
    mark("9, RecurrentGemma-2B serving")
    k7_entry, k5_serving = drive_gemma(
        dev, counters + (lindley_scan, ssd_scan, rglru_scan), time_ms,
        call_ms, max_err, randn)
    torch.cuda.empty_cache()
    mark("10, Mamba-2 training")
    train_entries = drive_train(dev, counters + (lindley_scan, ssd_scan,
                                                 rglru_scan),
                                time_ms, call_ms, max_err, card)
    torch.cuda.empty_cache()
    mark("11, the Qwen decoders")
    k5_qwen = drive_qwen(dev, counters + (lindley_scan, ssd_scan, rglru_scan),
                         time_ms, call_ms, max_err, randn, card)
    torch.cuda.empty_cache()
    mark("12, training beyond Mamba-2")
    train12_entries, k5_train, k7_train = drive_train_hybrid(
        dev, counters + (lindley_scan, ssd_scan, rglru_scan), time_ms,
        call_ms, max_err, randn, card)
    for entry in train12_entries:       # ptxas of each template instance
        entry["ptxas"] = bwd_ptxas[entry["name"]]
        if entry["name"] == "flash_attention_bwd":
            entry["ptxas_fp32"] = (fp32_ptxas["flash_bwd_dq_tf32_kernel"]
                                   + fp32_ptxas["flash_bwd_dkdv_tf32_kernel"])
    torch.cuda.empty_cache()
    mark("13, Whisper and the paper's LMs")
    k5_paper = drive_paper(dev, counters + (lindley_scan, ssd_scan,
                                            rglru_scan),
                           time_ms, call_ms, max_err, randn, card)
    torch.cuda.empty_cache()
    mark("14, MLA and the vision frontend")
    k5_vlm = drive_vlm(dev, counters + (lindley_scan, ssd_scan, rglru_scan),
                       time_ms, call_ms, max_err, randn, card)
    torch.cuda.empty_cache()
    mark("15, training of MLA, ViT-632M and Whisper")
    k5b_vlm, k5_train15, k5b_train15 = drive_train_vlm(
        dev, counters + (lindley_scan, ssd_scan, rglru_scan), time_ms,
        call_ms, max_err, randn, card)
    k5_train += k5_train15
    k5b_entry = train12_entries[0]
    k5b_entry.update(launches=k5b_entry["launches"] + k5b_train15,
                     train12_launches=k5b_entry["launches"],
                     train15_launches=k5b_train15, mla_vit_whisper=k5b_vlm)
    torch.cuda.empty_cache()
    # the mesh phases' ranks take most of the host's memory: free what
    # this process no longer needs first
    gc.collect()
    empty_host_cache()
    # phase 18(b)'s dry runs need no card: started here, on the host's
    # spare cores beside phases 16-17, and read in phase 18
    dryrun_dir = tempfile.TemporaryDirectory()
    dryruns = start_dryruns(Path(dryrun_dir.name))
    mark("16, the mesh")
    k5_mesh, k5_tp = drive_mesh(dev, card)
    for row in k5_qwen["tp_ranks"] + k5_qwen["rank_shapes"]:
        b, h, kv, sq, skv, d = row["shape"][:6]
        row["launches"] = k5_tp.get((h, kv, sq, skv, d), 0)
    torch.cuda.empty_cache()
    gc.collect()
    empty_host_cache()
    mark("17, training over a mesh")
    mesh17, k3_given = drive_mesh_train(dev, card, time_ms)
    torch.cuda.empty_cache()
    k3_entry, k4_entry, k8b_entry = train_entries
    k3_entry.update(launches=k3_entry["launches"] + mesh17["K3"],
                    mesh_train_launches=mesh17["K3"], given_absmax=k3_given)
    k4_entry.update(launches=k4_entry["launches"] + mesh17["K4"],
                    mesh_train_launches=mesh17["K4"])
    k8b_entry.update(launches=k8b_entry["launches"] + mesh17["K8b"],
                     mesh_train_launches=mesh17["K8b"])
    k5b_entry.update(launches=k5b_entry["launches"] + mesh17["K5b"],
                     mesh_train_launches=mesh17["K5b"])
    for row in k5_qwen["rank_shapes"]:
        # phase 17's launches by the rank's whole shape, its batch included
        # ((e)'s and (f)'s (2, 2) ranks differ only there)
        row["launches"] += mesh17["k5_shapes"].get(tuple(row["shape"][:6]),
                                                   0)
        if "k5b" in row:
            row["k5b"]["launches"] = mesh17["k5b_shapes"].get(
                tuple(row["shape"][:6]), 0)
    k5b_entry["offsets"] = k5_qwen["offsets"]["k5b"]
    gc.collect()
    empty_host_cache()
    mark("18, ClusterSim and the dry run")
    with dryrun_dir:
        try:
            k6_entry["clustersim_launches"] = drive_sim(dev, card)
        finally:
            finish_dryruns(dryruns, Path(dryrun_dir.name), card)
    held = mesh17["argument_bytes"]
    if (not any(tuple(r[0]) == (2, 2) for r in held)
            or any(r[2] != r[3] for r in held)):
        raise AssertionError(f"phase 18(c): a rank's train-step argument "
                             f"bytes against the dry run's: {held}")
    print("phase 18(c) the dry run's argument_bytes (launch.dryrun."
          "cell_blocks) against a real rank's holdings in phase 17 (its "
          "placed weights, batch block and the AdamW state adamw.init "
          "builds on the card), qwen3-moe-235b-a22b at 1 layer: "
          + "; ".join(
              f"{shape} {impl} real {real} dry run {dry}"
              for shape, impl, real, dry in held) + ", equal")
    mark("the kernels line")

    # ---- the kernels line: K1 over one request's 53 shapes ---------------
    # Each distinct shape is checked and timed once, with w in the layout the
    # request hands over (K-major for the 3x3 and 7x7 convolutions), and
    # counted as often as the request runs it.
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "bound_fma_ms": 0.0, "err": 0.0, "bytes": 0.0, "operations": 0.0,
          "call_ms": 0.0}
    per_shape = []
    rtol, atol = k1_tol(torch.float32, 1)
    counts = {}
    for shape in k1_shapes:
        counts[shape] = counts.get(shape, 0) + 1
    for (M, K, N, kmajor), n in counts.items():
        x, w = randn(M, K), randn(K, N, std=math.sqrt(2.0 / K))
        if kmajor:
            w = w.t().contiguous().t()
        k1["err"] = max(k1["err"], max_err(
            systolic_matmul(x, w), systolic_matmul_plain(x, w), rtol,
            atol * max(1, K // 64), f"K1 request shape {(M, K, N)}"))
        ms = time_ms(lambda: systolic_matmul(x, w))
        lib = time_ms(lambda: torch.matmul(x, w))
        per_shape.append((M, K, N, kmajor, n, ms, lib))
        k1["ms"] += n * ms
        k1["library_ms"] += n * lib
        k1["call_ms"] += n * call_ms(lambda: systolic_matmul(x, w), reps=10)
        k1["plain_ms"] += n * time_ms(lambda: systolic_matmul_plain(x, w))
        (bnd, by), (fma, _) = k1_bounds(M, K, N, torch.float32)
        k1["bound_ms"] += n * bnd
        k1[by] += n * bnd
        k1["bound_fma_ms"] += n * fma
    k1_by = "bytes" if k1["bytes"] > k1["operations"] else "operations"
    shapes = "; ".join(
        f"({M}, {K}, {N}){' K-major w' if kmajor else ''} x{n} {ms:.4f} ms "
        f"torch.matmul {lib:.4f} "
        f"{k1_design(M, K, N, torch.float32).split(';')[0]}"
        for M, K, N, kmajor, n, ms, lib in per_shape)
    print(f"K1 over the {len(k1_shapes)} GEMMs of one ResNet-50 request "
          f"(float32, {len(counts)} distinct): ms={k1['ms']:.4f} (per Python "
          f"call {k1['call_ms']:.4f}) plain_ms={k1['plain_ms']:.4f} "
          f"library_ms={k1['library_ms']:.4f} bound_ms={k1['bound_ms']:.4f} "
          f"(3xTF32; {k1_by}: {k1['operations']:.4f} ms of it "
          f"operations-bound) bound_fma_ms={k1['bound_fma_ms']:.4f} "
          f"max_abs_err={k1['err']:.3e}; per shape (M, K, N) x count: "
          f"{shapes}")

    k2 = k2_rows[(1, 224 * 224 * 3)]
    k5 = k5_rows[(122, torch.float32)]
    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "systolic_matmul", "route": "cuda",
         "source": src + "systolic_matmul.cu",
         "replaces": "src/repro/kernels/systolic_matmul.py:92",
         "launches": launches[0], "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1_by, "library_ms": k1["library_ms"],
         "bound_fma_ms": k1["bound_fma_ms"]},
        {"name": "fused_affine_act", "route": "cuda",
         "source": src + "vector_engine.cu",
         "replaces": "src/repro/kernels/vector_engine.py:41",
         "launches": launches[1], "max_abs_err": k2[0], "ms": k2[1],
         "plain_ms": k2[2], "bound_ms": k2[4], "bound_by": k2[5],
         "library_ms": k2[3], "in_turns": k2[6]},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:86",
         "launches": launches[2] + k5_train + k5_mesh + mesh17["K5"],
         **{k: v for k, v in k5.items() if k != "library"},
         "main_path_launches": launches[2], "train_launches": k5_train,
         "mesh_launches": k5_mesh, "mesh_train_launches": mesh17["K5"],
         "serving": k5_serving, "qwen": k5_qwen, "paper": k5_paper,
         "mla_vlm": k5_vlm, "ptxas_fp32": fp32_ptxas["flash_tf32_kernel"]},
        {**k6_entry, "max_abs_err": k6_err},
        {"name": "ssd_scan", "route": "cuda", "source": src + "ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:87",
         "launches": k8_launches + mesh17["K8"],
         "mesh_train_launches": mesh17["K8"],
         "max_abs_err": k8_err, **{k: v for k, v in k8_times[
             torch.bfloat16].items() if k != "err"}, "library_ms": None},
        {**k7_entry, "launches": k7_entry["launches"] + k7_train,
         "serve_launches": k7_entry["launches"], "train_launches": k7_train},
        *train_entries,
        *train12_entries,
    ]
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
