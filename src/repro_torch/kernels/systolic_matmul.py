"""The DSA systolic array's GEMM on Hopper (K1).

``systolic_matmul`` launches ``csrc/systolic_matmul.cu``: (M, K) @ (K, N)
[+ b] with an fp32 accumulator and the vector engine's activation fused
into the epilogue, cast to ``out_dtype``.  It replaces the Pallas TPU
kernel ``repro/kernels/systolic_matmul.py::systolic_matmul``; unlike that
kernel it masks ragged tiles, so any (M, K, N) is accepted.  Where the
output has too few 64x64 tiles to fill the card, K is split over more blocks
and a second kernel sums the slices (one logical launch, one count).
``systolic_matmul_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_ACTS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
_ACT_CODES = {name: i for i, name in enumerate(_ACTS)}  # csrc/common.cuh Act
_TILE = 64           # BM = BN of csrc/systolic_matmul.cu
_MIN_K_SLICE = 128   # K per slice, at least: 8 of the kernel's BK steps


def k_splits(M: int, N: int, K: int, sms: int) -> int:
    """How many K slices give about two blocks per SM."""
    tiles = -(-M // _TILE) * -(-N // _TILE)
    if tiles >= sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), K // _MIN_K_SLICE))


def systolic_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *,
                          act: str = "none",
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    acc = x.float() @ w.float()
    if b is not None:
        acc = acc + b.float()
    return _ACTS[act](acc).to(out_dtype or x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("systolic_matmul")
    if lib.systolic_matmul.argtypes is None:
        lib.systolic_matmul.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.systolic_matmul.restype = ctypes.c_int
    return lib


def systolic_matmul(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, act: str = "none",
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) [+ b (N,)] on the card; fp32 or bf16 inputs."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or x.dtype != w.dtype:
        raise ValueError(f"systolic_matmul: x {tuple(x.shape)} {x.dtype} and "
                         f"w {tuple(w.shape)} {w.dtype} do not chain")
    if act not in _ACT_CODES:
        raise ValueError(f"systolic_matmul: unknown activation {act!r}")
    out_dtype = out_dtype or x.dtype
    bias = None if b is None else b.to(torch.float32).contiguous()
    _build.require_cuda("systolic_matmul", x, w,
                        *([] if bias is None else [bias]))
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"systolic_matmul: bias {tuple(bias.shape)} is not ({N},)")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _lib()
    splits = k_splits(M, N, K, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    work = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    with torch.cuda.device(x.device):
        code = lib.systolic_matmul(
            x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), 0 if work is None else work.data_ptr(), M, N, K,
            splits, _build.dtype_code(x.dtype), _build.dtype_code(out_dtype),
            _ACT_CODES[act], _build.stream_of(x))
    _build.check(lib, code, "systolic_matmul")
    systolic_matmul.launches += 1
    return out


systolic_matmul.launches = 0
