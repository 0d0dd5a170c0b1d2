"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    rope="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
