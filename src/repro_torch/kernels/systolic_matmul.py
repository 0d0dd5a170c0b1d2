"""The DSA systolic array's GEMM on Hopper (K1).

``systolic_matmul`` launches ``csrc/systolic_matmul.cu``: (M, K) @ (K, N)
[+ b] with an fp32 accumulator and the vector engine's activation fused
into the epilogue, cast to ``out_dtype``.  fp32 runs on the tensor cores as
3xTF32 ``wgmma`` and bf16 as one bf16 ``wgmma``.  It replaces the Pallas TPU
kernel ``repro/kernels/systolic_matmul.py::systolic_matmul``; unlike that
kernel it masks ragged tiles, so any (M, K, N) is accepted.  ``tile_plan``
picks the output tile and, where the output has too few tiles to fill the
card, cuts K into slices that one thread-block cluster sums inside the same
launch (one launch, one count).  ``systolic_matmul_plain`` is the same
function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, shape_only

_ACTS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
_ACT_CODES = {name: i for i, name in enumerate(_ACTS)}  # csrc/common.cuh Act
_MIN_K_SLICE = 128   # K a slice, at least, where K is split
_MAX_SLICES = 8      # the portable thread-block cluster size
# (BM, BN): a k tile's cost in a block, relative to 64 x 32, fitted with
# tools/k1_ablate.py --sweep (every plan of the 20 ResNet-50 request shapes,
# on an H100); 128-wide tiles never won there and are not built.
_TILE_COST = {(64, 32): 1.0, (128, 32): 1.6, (64, 64): 2.0, (128, 64): 3.2}
_BLOCK_COST = 3.0     # a block's fixed cost, in the same units
_SHARE_COST = 0.2     # how much each block an SM adds to a block's time
_MAX_SPLIT_BLOCKS = 1.7   # a split plan's blocks an SM, at most: past it the
                          # clusters stop fitting on the card at once


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_plan(M: int, K: int, N: int, sms: int,
              bk: int = 32) -> Tuple[int, int, int]:
    """(BM, BN, k-slices) for an (M, K) @ (K, N) product on ``sms`` SMs.

    ``bk`` is the kernel's k tile (32 for fp32, 64 for bf16); a slice is a
    whole number of them, at least 128 of K where K is split, and the
    slices of a tile are one cluster of at most 8 blocks, and a split plan
    keeps to 1.7 blocks an SM.  A plan's cost is a block's time (a fixed
    cost plus its k tiles) stretched by the blocks that share an SM; among
    the plans with at least half a wave of blocks (where any has), the
    cheapest wins, then the one with fewer blocks.
    """
    plans = []
    for (bm, bn), tile_cost in _TILE_COST.items():
        tiles = _cdiv(M, bm) * _cdiv(N, bn)
        for s in range(1, _MAX_SLICES + 1):
            if s > 1 and K < _MIN_K_SLICE * s:
                break
            kc = _cdiv(_cdiv(K, s), bk) * bk
            if K and _cdiv(K, kc) != s:               # a slice would be empty
                continue
            blocks = tiles * s
            if s > 1 and blocks > _MAX_SPLIT_BLOCKS * sms:
                continue
            block = _BLOCK_COST + _cdiv(kc, 32) * tile_cost
            plans.append((block * (1 + _SHARE_COST * blocks / sms), blocks,
                          bm, bn, s))
    full = [p for p in plans if p[1] >= sms // 2]
    _, _, bm, bn, s = min(full or plans, key=lambda p: (p[0], p[1]))
    return bm, bn, s


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
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.systolic_matmul.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def systolic_matmul(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, act: str = "none",
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) [+ b (N,)] on the card; fp32 or bf16 inputs.

    x is contiguous; w is contiguous or K-major (the transpose of a
    contiguous (N, K) tensor), which the kernel stores with whole 16-byte
    chunks where a row-major w takes one store an element."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or x.dtype != w.dtype:
        raise ValueError(f"systolic_matmul: x {tuple(x.shape)} {x.dtype} and "
                         f"w {tuple(w.shape)} {w.dtype} do not chain")
    if act not in _ACT_CODES:
        raise ValueError(f"systolic_matmul: unknown activation {act!r}")
    if shape_only.is_fake(x, w, b):
        return torch.ops.repro_torch.systolic_matmul(x, w, b, act, out_dtype)
    out_dtype = out_dtype or x.dtype
    bias = None if b is None else b.to(torch.float32).contiguous()
    w_kmajor = not w.is_contiguous() and w.t().is_contiguous()
    _build.require_cuda("systolic_matmul", x, w.t() if w_kmajor else w,
                        *([] if bias is None else [bias]))
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"systolic_matmul: bias {tuple(bias.shape)} is not ({N},)")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _lib()
    bm, bn, slices = tile_plan(M, K, N, _sms(x.get_device()),
                               bk=128 // x.element_size())
    with torch.cuda.device(x.device):
        code = lib.systolic_matmul(
            x.data_ptr(), w.data_ptr(), int(w_kmajor),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
            bm, bn, slices,
            _build.dtype_code(x.dtype), _build.dtype_code(out_dtype),
            _ACT_CODES[act], _build.stream_of(x))
    _build.check(lib, code, "systolic_matmul")
    systolic_matmul.launches += 1
    return out


systolic_matmul.launches = 0
