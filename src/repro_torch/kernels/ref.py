"""Plain PyTorch oracles of the ported kernels, under the JAX package's
``kernels/ref.py`` names.  Each is its kernel module's plain version."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (
    flash_attention_plain as attention_ref)
from repro_torch.kernels.lindley import lindley_scan_plain as lindley_ref
from repro_torch.kernels.systolic_matmul import (
    systolic_matmul_plain as matmul_ref)
from repro_torch.kernels.vector_engine import (
    fused_affine_act_plain as affine_act_ref)

__all__ = ["attention_ref", "matmul_ref", "affine_act_ref", "lindley_ref"]
