"""minicpm3-4b [dense]: 62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448 — MLA.

Multi-head latent attention (DeepSeek-V2 style) with the MiniCPM3 projection
ranks.  [hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    head_dim=96,   # nope + rope
    rope="rope",
)
