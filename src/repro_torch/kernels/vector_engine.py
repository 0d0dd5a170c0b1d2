"""The DSA vector engine on Hopper: K2, K3 and K4.

Each wrapper launches its kernel in ``csrc/vector_engine.cu`` and has a
plain PyTorch version of the same function beside it:

- ``fused_affine_act`` (K2): y = act(x * scale + bias) with per-column (N,)
  scale and bias, in fp32, cast to ``out_dtype``; replaces
  ``repro/kernels/vector_engine.py::fused_affine_act``.
- ``quantize_int8`` (K3): per-row symmetric int8, x (M, N) float32 or
  bfloat16 -> (int8 (M, N), fp32 scales (M, 1)), the codes byte-equal to
  the plain version; replaces ``repro/kernels/vector_engine.py::
  quantize_int8``.  Given each row's absmax (a rank's block of a leaf
  split over a mesh takes the whole leaf's), it uses that one instead of
  its own, and skips the pass that finds it.
- ``dequantize_int8`` (K4): q * scale in fp32, cast to ``out_dtype``;
  replaces ``repro/kernels/vector_engine.py::dequantize_int8``.

Any M and N are taken: the TPU kernels' ``M % bm == 0`` has no counterpart,
the CUDA kernels mask the ragged edge.  K3 and K4 act on gradients, never
on a tensor that requires one.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, shape_only
from repro_torch.kernels.systolic_matmul import _ACT_CODES, _ACTS


def fused_affine_act_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, act: str = "none",
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    y = x.float() * scale.float() + bias.float()
    return _ACTS[act](y).to(out_dtype or x.dtype)


def quantize_int8_plain(x: torch.Tensor,
                        absmax: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, N) -> (int8 (M, N), fp32 row scales (M, 1)).  A NaN or Inf
    in a row makes its scale NaN or Inf and each of its codes 0 (a NaN
    quotient casts to 0, as XLA casts it), so the row dequantizes to NaN,
    as in JAX.  ``absmax``: the rows' (M,) or (M, 1) fp32 absmax, taken in
    place of x's own."""
    x32 = x.float()
    if absmax is None:
        absmax = x32.abs().amax(dim=-1, keepdim=True)
    else:
        absmax = _given_absmax(absmax, x.shape[0])
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one ulp off the IEEE quotient K3 and the CPU give
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.nan_to_num(torch.clamp(torch.round(x32 / scale), -127, 127),
                         nan=0.0).to(torch.int8)
    return q, scale


def _given_absmax(absmax: torch.Tensor, M: int) -> torch.Tensor:
    """A given absmax as an (M, 1) fp32 column."""
    if absmax.dtype != torch.float32 or absmax.numel() != M:
        raise ValueError(f"absmax {absmax.dtype} {tuple(absmax.shape)} for "
                         f"{M} rows: want {M} float32 values")
    return absmax.reshape(M, 1)


def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor, *,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    return (q.float() * scales).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("vector_engine")
    if lib.fused_affine_act.argtypes is None:
        lib.fused_affine_act.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.fused_affine_act.restype = ctypes.c_int
        lib.quantize_int8_plan.argtypes = ([ctypes.c_longlong] * 2
                                           + [ctypes.c_int] * 2
                                           + [ctypes.c_void_p])
        lib.quantize_int8_plan.restype = ctypes.c_int
        lib.quantize_int8.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_longlong] * 3
                                      + [ctypes.c_int, ctypes.c_void_p])
        lib.quantize_int8.restype = ctypes.c_int
        lib.dequantize_int8.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_longlong] * 2
                                        + [ctypes.c_int, ctypes.c_void_p])
        lib.dequantize_int8.restype = ctypes.c_int
    return lib


def fused_affine_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, act: str = "none",
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, N), at any base; scale and bias (N,) broadcast per column;
    on the card.  scale and bias go to the kernel as fp32 at a 16-byte
    aligned base (copied where they are not)."""
    M, N = x.shape
    if act not in _ACT_CODES:
        raise ValueError(f"fused_affine_act: unknown activation {act!r}")
    if shape_only.is_fake(x, scale, bias):
        return torch.ops.repro_torch.fused_affine_act(x, scale, bias, act,
                                                      out_dtype)
    out_dtype = out_dtype or x.dtype
    scale, bias = (v.to(torch.float32).contiguous() for v in (scale, bias))
    scale, bias = (v if v.data_ptr() % 16 == 0 else v.clone()
                   for v in (scale, bias))
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


def _rows(name: str, t: torch.Tensor) -> Tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{name} takes an (M, N) tensor, not "
                         f"{tuple(t.shape)}")
    return t.shape[0], t.shape[1]


def quantize_plan(M: int, N: int, dtype: torch.dtype,
                  aligned: bool = True) -> dict:
    """K3's launch at (M, N) as the library plans it on the current
    device: the ``grid`` (at most the ``resident`` blocks, launched
    cooperatively), the ``segs`` items a row, the ``threads`` a block and
    the ``stash_bytes`` of its share a block keeps in shared memory across
    the grid barrier.  ``aligned``: x's base is 16-byte aligned."""
    out = (ctypes.c_longlong * 5)()
    lib = _lib()
    err = lib.quantize_int8_plan(M, N, _build.dtype_code(dtype), int(aligned),
                                 out)
    _build.check(lib, err, "quantize_int8_plan")
    return dict(zip(("grid", "segs", "resident", "threads", "stash_bytes"),
                    out))


def quantize_int8(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, N) float32 or bfloat16 on the card -> (int8 (M, N), fp32
    scales (M, 1)), byte-equal to ``quantize_int8_plain`` (given the same
    ``absmax``).  One kernel launch a call (``launches`` counts them):
    absmax and codes in one cooperative grid, parted by a grid barrier;
    with ``absmax`` ((M,) or (M, 1) fp32 on the card) the codes alone, in
    an ordinary launch of the same grid."""
    M, N = _rows("quantize_int8", x)
    if M == 0 or N == 0:
        raise ValueError(f"quantize_int8: an empty row has no absmax "
                         f"({tuple(x.shape)})")
    if shape_only.is_fake(x, absmax):
        return torch.ops.repro_torch.quantize_int8(x, absmax)
    code = _build.dtype_code(x.dtype)
    if absmax is not None:
        absmax = _given_absmax(absmax, M).contiguous()
        _build.require_cuda("quantize_int8", x, absmax)
    else:
        _build.require_cuda("quantize_int8", x)
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        segs = quantize_plan(M, N, x.dtype, x.data_ptr() % 16 == 0)["segs"]
        part = (torch.empty((M * segs,), dtype=torch.int32, device=x.device)
                if absmax is None else None)
        lib = _lib()
        err = lib.quantize_int8(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(),
            None if part is None else part.data_ptr(),
            None if absmax is None else absmax.data_ptr(), M, N, segs, code,
            _build.stream_of(x))
    _build.check(lib, err, "quantize_int8")
    quantize_int8.launches += 1
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (M, N) int8 and scales (M, 1) fp32 on the card -> q * scale,
    cast to ``out_dtype`` (float32 or bfloat16)."""
    M, N = _rows("dequantize_int8", q)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8 takes int8 codes and float32 "
                        f"scales, not {q.dtype} and {scales.dtype}")
    if scales.numel() != M:
        raise ValueError(f"dequantize_int8: scales {tuple(scales.shape)} for "
                         f"{M} rows")
    code = _build.dtype_code(out_dtype)
    if shape_only.is_fake(q, scales):
        return torch.ops.repro_torch.dequantize_int8(q, scales, out_dtype)
    _build.require_cuda("dequantize_int8", q, scales)
    out = torch.empty((M, N), dtype=out_dtype, device=q.device)
    if M == 0 or N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.dequantize_int8(q.data_ptr(), scales.data_ptr(),
                                  out.data_ptr(), M, N, code,
                                  _build.stream_of(q))
    _build.check(lib, err, "dequantize_int8")
    dequantize_int8.launches += 1
    return out


quantize_int8.launches = 0
dequantize_int8.launches = 0
