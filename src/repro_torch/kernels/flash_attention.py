"""Blocked (flash) attention on Hopper (K5).

``flash_attention`` launches ``csrc/flash_attention.cu``: online-softmax
attention with fp32 m, l and accumulator, GQA (head h reads KV head
h // (H / KV)), causal masking and a sliding window, walking only the key
tiles the masks leave.  bf16 runs both products on the tensor cores
(``wgmma``), fp32 on the CUDA cores.  It replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; unlike that kernel it
needs no tile to divide Sq or Skv.
``flash_attention_plain`` is the same function as one dense masked softmax.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """q (B,H,Sq,D); k/v (B,KV,Skv,D) -- dense masked softmax."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, KV, Skv, D) -> (B, H, Sq, D), on the card."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Skv, D) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention: q, k and v differ in dtype")
    _build.require_cuda("flash_attention", q, k, v)
    # the kernel copies 16 bytes at a time: a view at an odd offset is copied
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
            Sq, Skv, D, 1.0 / math.sqrt(D), int(causal), int(window),
            _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
