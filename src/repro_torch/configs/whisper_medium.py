"""whisper-medium [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865.

Encoder-decoder with a conv audio frontend (STUB: ``input_specs`` provides
1500 precomputed frame embeddings).  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    attention="gqa",
    rope="learned",
    act="gelu",
    encoder_layers=24,
    encoder_seq=1500,
    cross_attention=True,
    frontend="audio_frames",
    frontend_seq=1500,
    tie_embeddings=True,
    max_position=65536,
)
