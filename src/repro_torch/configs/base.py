"""Model / run configuration dataclasses.

One ``ModelConfig`` covers every assigned architecture family (dense, MoE,
hybrid RG-LRU, SSM, VLM, audio enc-dec) plus the paper's own benchmark
models.  Configs are pure data: the model code in ``repro_torch.models`` consumes
them, the launcher maps them onto meshes, and the smoke tests instantiate
``reduced()`` variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # --- attention flavour -------------------------------------------------
    attention: str = "gqa"            # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"                # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # >0 => local attention window
    # repeating block pattern; entries: "attn" | "rglru"
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width (0 => d_ff)
    moe_capacity_factor: float = 1.25
    moe_block_tokens: int = 8192      # scan MoE dispatch in token blocks (0 = off)
    moe_impl: str = "ep"              # gather | ep | ep_resident (see moe_ep.py)

    # --- MLA (multi-head latent attention; MiniCPM3/DeepSeek style) ---------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # --- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0              # whisper: 1500 precomputed frames
    cross_attention: bool = False

    # --- modality frontend (STUB: input_specs feeds precomputed embeddings) ---
    frontend: str = "none"            # none | audio_frames | vision_patches
    frontend_seq: int = 0             # length of precomputed frontend embeds

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu | gelu

    # --- numerics & lowering knobs -------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512             # q-chunk for blocked attention
    attn_unroll: bool = True          # unroll the q-chunk loop (exact HLO flops)
    max_position: int = 1 << 20

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab dim shards on any
        production mesh axis (Megatron-style embedding padding).  Logit
        columns >= vocab_size are masked to -inf in ``unembed``."""
        if self.vocab_size % 256 == 0:
            return self.vocab_size
        return ((self.vocab_size + 255) // 256) * 256

    # sub-quadratic? (controls long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            # attention blocks must all be windowed
            return self.sliding_window > 0
        return False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoder-bearing (none encoder-only)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(period, 2 if period == 1 else period),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            moe_d_ff=64 if self.num_experts else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            rope_head_dim=8 if self.rope_head_dim else 0,
            nope_head_dim=24 if self.nope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_chunk=32,
            ssm_head_dim=32 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            frontend_seq=16 if self.frontend_seq else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_chunk=32,
            max_position=4096,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""
    name: str                         # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                         # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    """End-to-end training-run configuration (launcher + optimizer)."""
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 300
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1             # gradient accumulation
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    grad_compression: str = "none"    # none | int8  (DP all-reduce compression)


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
