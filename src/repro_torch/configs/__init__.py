"""Architecture registry: ``--arch <id>`` resolves here.

Ten assigned architectures (each paired with the four LM shapes) plus the
paper's own benchmark-suite configs (see ``repro_torch.configs.paper_suite``).
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    TrainConfig,
    MeshConfig,
)

from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.minicpm3_4b import CONFIG as MINICPM3_4B
from repro_torch.configs.qwen15_110b import CONFIG as QWEN15_110B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.qwen15_4b import CONFIG as QWEN15_4B
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.qwen3_moe_235b import CONFIG as QWEN3_MOE_235B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M

ARCHS = {
    c.name: c
    for c in (
        WHISPER_MEDIUM,
        MINICPM3_4B,
        QWEN15_110B,
        QWEN3_8B,
        QWEN15_4B,
        LLAMA4_MAVERICK,
        QWEN3_MOE_235B,
        RECURRENTGEMMA_2B,
        QWEN2_VL_72B,
        MAMBA2_370M,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All (arch, shape) dry-run cells, with applicability flags."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES:
            skip = None
            if shape.name == "long_500k" and not arch.subquadratic:
                skip = "full attention (quadratic) — skipped per assignment rules"
            out.append((arch, shape, skip))
    return out


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME", "TrainConfig",
    "MeshConfig", "ARCHS", "get_arch", "cells",
]
