"""The DSA vector engine's fused affine pass on Hopper (K2).

``fused_affine_act`` launches ``csrc/vector_engine.cu``:
y = act(x * scale + bias) with per-column (N,) scale and bias, in fp32, cast
to ``out_dtype``.  It replaces the Pallas TPU kernel
``repro/kernels/vector_engine.py::fused_affine_act``; the TPU's
``quantize_int8`` and ``dequantize_int8`` are not ported yet.
``fused_affine_act_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.systolic_matmul import _ACT_CODES, _ACTS


def fused_affine_act_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, act: str = "none",
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    y = x.float() * scale.float() + bias.float()
    return _ACTS[act](y).to(out_dtype or x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("vector_engine")
    if lib.fused_affine_act.argtypes is None:
        lib.fused_affine_act.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.fused_affine_act.restype = ctypes.c_int
    return lib


def fused_affine_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, act: str = "none",
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, N); scale and bias (N,) broadcast per column; on the card."""
    M, N = x.shape
    if act not in _ACT_CODES:
        raise ValueError(f"fused_affine_act: unknown activation {act!r}")
    out_dtype = out_dtype or x.dtype
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda("fused_affine_act", x, scale, bias)
    if scale.shape != (N,) or bias.shape != (N,):
        raise ValueError(f"fused_affine_act: scale {tuple(scale.shape)} and "
                         f"bias {tuple(bias.shape)} are not ({N},)")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.fused_affine_act(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            M, N, _build.dtype_code(x.dtype), _build.dtype_code(out_dtype),
            _ACT_CODES[act], _build.stream_of(x))
    _build.check(lib, code, "fused_affine_act")
    fused_affine_act.launches += 1
    return out


fused_affine_act.launches = 0
