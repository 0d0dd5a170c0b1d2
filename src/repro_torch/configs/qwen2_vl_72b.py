"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (3-section t/h/w rotary), dynamic resolution.  Vision patch frontend
STUB: ``input_specs`` provides precomputed patch embeddings.  [arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_seq=1024,
    tie_embeddings=False,
)
