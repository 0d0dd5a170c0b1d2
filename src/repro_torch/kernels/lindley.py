"""The fleet's batched FCFS Lindley scan on Hopper, in fp64 (K6).

``lindley_scan`` launches ``csrc/lindley.cu``: for R independent queues of
depth W (zero pad past each queue's length), the service starts
``max(t_d, m_d + prev_d)`` with ``prev_d = cumsum(s)_d - s_d`` and ``m_d``
the running max of ``t - prev``.  It replaces the Pallas TPU kernel
``repro/kernels/lindley.py::lindley_scan`` and, like it, performs the same
float64 operations in the same order as the numpy solver of
:mod:`repro_torch.core.lindley`, so its output is byte-equal to numpy's.
``lindley_scan_plain`` is the numpy solver's op sequence in plain PyTorch;
on the CPU it gives numpy's bytes too (``torch.cumsum`` on the card
re-associates, so on a CUDA tensor it is a time, not a reference).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def lindley_scan_plain(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(s, 1)
    p = c - s
    m = torch.cummax(t - p, 1).values
    return torch.maximum(t, m + p)


def _lib() -> ctypes.CDLL:
    lib = _build.load("lindley")
    if lib.lindley_scan.argtypes is None:
        lib.lindley_scan.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_longlong] * 2
                                     + [ctypes.c_void_p])
        lib.lindley_scan.restype = ctypes.c_int
    return lib


def lindley_scan(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t, s (R, W) float64 on the card -> service starts (R, W) float64."""
    _build.require_cuda("lindley_scan", t, s)
    if t.dtype != torch.float64 or s.dtype != torch.float64:
        raise TypeError(f"lindley_scan takes float64, not {t.dtype}/{s.dtype}")
    if t.dim() != 2 or t.shape != s.shape:
        raise ValueError(f"lindley_scan: t {tuple(t.shape)} and s "
                         f"{tuple(s.shape)} are not one (R, W) shape")
    R, W = t.shape
    out = torch.empty_like(t)
    if R == 0 or W == 0:
        return out
    lib = _lib()
    with torch.cuda.device(t.device):
        code = lib.lindley_scan(t.data_ptr(), s.data_ptr(), out.data_ptr(),
                                R, W, _build.stream_of(t))
    _build.check(lib, code, "lindley_scan")
    lindley_scan.launches += 1
    return out


lindley_scan.launches = 0
