"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1.  Early fusion (vision frontend STUB).

[hf:meta-llama/Llama-4-Scout-17B-16E family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    rope="rope",
    rope_theta=500_000.0,
    tie_embeddings=False,
)
