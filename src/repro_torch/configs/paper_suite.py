"""The paper's own Table I DNNs as first-class ModelConfigs (the LM ones)
plus pointers to the vision implementations — so the paper's baseline suite
is runnable through the same train/serve/dry-run machinery as the assigned
architectures.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# BERT-Base (Conversational Chatbot, Table I): encoder-style usage is
# emulated with bidirectional = non-causal prefill.
BERT_BASE = ModelConfig(
    name="bert-base",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    head_dim=64,
    rope="learned",
    act="gelu",
    max_position=512,
    tie_embeddings=True,
)

# GPT-2 XL-and-a-half (Document Translation, Table I: "GPT-2 (1.5 billion)")
GPT2_1_5B = ModelConfig(
    name="gpt2-1.5b",
    family="dense",
    num_layers=48,
    d_model=1600,
    num_heads=25,
    num_kv_heads=25,
    d_ff=6400,
    vocab_size=50257,
    head_dim=64,
    rope="learned",
    act="gelu",
    max_position=1024,
    tie_embeddings=True,
)

# ViT-H-class backbone (Remote Sensing, Table I: "Vision Transformer 632M")
VIT_632M = ModelConfig(
    name="vit-632m",
    family="vlm",
    num_layers=32,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=1000,          # classification head
    head_dim=80,
    rope="learned",
    act="gelu",
    frontend="vision_patches",
    frontend_seq=256,
    max_position=1024,
    tie_embeddings=False,
)

PAPER_LM_SUITE = {c.name: c for c in (BERT_BASE, GPT2_1_5B, VIT_632M)}

# Vision/CNN members of Table I live in repro_torch.models.vision
# (resnet50/effnet/fcn/yolov3) and repro_torch.core.workloads carries the full
# 8-benchmark system-level suite.
