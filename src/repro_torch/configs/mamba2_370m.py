"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality), chunked.  Sub-quadratic: runs long_500k.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,          # ssm heads = expand*d_model / ssm_head_dim
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    rope="none",
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_chunk=256,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)
