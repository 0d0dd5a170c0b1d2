"""The fleet's FCFS Lindley scan on Hopper, in fp64 (K6).

``csrc/lindley.cu`` walks each queue in order: the service starts
``max(t_d, m_d + prev_d)`` with ``prev_d = cumsum(s)_d - s_d`` and ``m_d``
the running max of ``t - prev`` (numpy's maximum: the first operand on
ties, NaN propagated).  It replaces the Pallas TPU kernel
``repro/kernels/lindley.py::lindley_scan`` and, like it, gives the bytes of
the numpy solver of :mod:`repro_torch.core.lindley`: the cumsum is rounded
step by step in order, and the running max, which rounds nothing, is a
scan in numpy's order of operands.  Two wrappers launch the one kernel,
each launch counted on ``lindley_scan.launches``:

- ``lindley_scan(t, s)``: R queues of depth W, (R, W) -> (R, W), the JAX
  package's call (zeros past a queue's end are data like any other);
- ``lindley_scan_segments(seg, t, s)``: the flat layout of a solve, each
  queue a contiguous run ``[seg[j], seg[j + 1])`` of t and s (n,) -> (n,),
  one launch for every queue of the solve, with no buckets and no pads.

``lindley_scan_plain`` and ``lindley_scan_segments_plain`` are the numpy
solver's op sequence in plain PyTorch (the latter on the numpy solver's
power-of-two length buckets); on the CPU they give numpy's bytes too
(``torch.cumsum`` on the card re-associates, so on a CUDA tensor they are a
time, not a reference).  ``add_latency`` measures the step of the chain.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

TILE = 256          # csrc/lindley.cu: steps of a segment a tile
LANE_STEPS = 8      # csrc/lindley.cu: a scan lane's run of steps
_RESIDENT: Dict[int, int] = {}


def npmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's maximum, bit for bit: a on ties, a NaN operand itself (not
    ``torch.maximum``'s NaN, whose bits on the CPU are all ones)."""
    return torch.where((a >= b) | torch.isnan(a), a, b)


def running_max(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``maximum.accumulate`` along dim 1, NaN for NaN: the first
    NaN of a row is carried to its end (``torch.cummax`` carries the last
    one).  Of a +0 and a -0 it may keep the other zero, which the starts
    cannot show: m is only ever added to a ``c - s``, never a -0."""
    nan = torch.isnan(x)
    first = torch.gather(x, 1, nan.to(torch.uint8).argmax(1, keepdim=True))
    return torch.where(torch.cumsum(nan, 1) > 0, first,
                       torch.cummax(x, 1).values)


def lindley_scan_plain(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(s, 1)
    p = c - s
    m = running_max(t - p)
    return npmax(t, m + p)


def check_fenceposts(seg, n: int) -> None:
    """Raise unless ``seg`` (numpy or a CPU tensor) runs from 0 to ``n``
    and never falls: K6 does not check them on the card, and writes no
    element outside every segment."""
    seg = torch.as_tensor(seg)
    if (seg.dim() != 1 or seg.numel() < 1 or int(seg[0]) != 0
            or int(seg[-1]) != n or bool((seg[1:] < seg[:-1]).any())):
        raise ValueError(f"fenceposts must rise from 0 to n = {n}, got "
                         f"{seg.tolist()[:8]}... ({seg.numel()} of them)")


def lindley_scan_segments_plain(seg: torch.Tensor, t: torch.Tensor,
                                s: torch.Tensor) -> torch.Tensor:
    """The flat layout's starts through ``lindley_scan_plain``, one padded
    (rows, 2^b) block for each power-of-two length bucket, as the numpy
    solver cuts them (pads after each row's data never reach it)."""
    check_fenceposts(seg.cpu(), t.numel())
    lens = (seg[1:] - seg[:-1]).tolist()
    heads = seg[:-1].tolist()
    out = torch.empty_like(t)
    buckets: Dict[int, list] = {}
    for j, n in enumerate(lens):
        if n > 0:
            buckets.setdefault((n - 1).bit_length(), []).append(j)
    for b, rows in sorted(buckets.items()):
        rl = torch.tensor([lens[j] for j in rows])
        pos = torch.arange(1 << b)
        mask = pos[None, :] < rl[:, None]
        flat = (torch.tensor([heads[j] for j in rows])[:, None]
                + pos[None, :])[mask].to(t.device)
        mask = mask.to(t.device)
        T = torch.zeros(mask.shape, dtype=t.dtype, device=t.device)
        S = torch.zeros_like(T)
        T[mask] = t[flat]
        S[mask] = s[flat]
        out[flat] = lindley_scan_plain(T, S)[mask]
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("lindley")
    if lib.lindley_scan.argtypes is None:
        lib.lindley_scan.argtypes = ([ctypes.c_void_p] * 5
                                     + [ctypes.c_longlong] * 3
                                     + [ctypes.c_void_p])
        lib.lindley_scan.restype = ctypes.c_int
        lib.lindley_resident_blocks.argtypes = [ctypes.c_void_p]
        lib.lindley_resident_blocks.restype = ctypes.c_int
        lib.lindley_add_latency.argtypes = ([ctypes.c_void_p] * 2
                                            + [ctypes.c_longlong,
                                               ctypes.c_void_p])
        lib.lindley_add_latency.restype = ctypes.c_int
    return lib


def resident_blocks(device: torch.device) -> int:
    """The blocks of K6 that ``device`` holds at once."""
    idx = torch.device(device).index or 0
    if idx not in _RESIDENT:
        lib = _lib()
        out = ctypes.c_longlong(0)
        with torch.cuda.device(idx):
            code = lib.lindley_resident_blocks(ctypes.addressof(out))
        _build.check(lib, code, "lindley_resident_blocks")
        _RESIDENT[idx] = out.value
    return _RESIDENT[idx]


def _check(name: str, *tensors: torch.Tensor) -> None:
    _build.require_cuda(name, *tensors)
    if any(x.dtype != torch.float64 for x in tensors):
        raise TypeError(f"{name} takes float64, not "
                        f"{'/'.join(str(x.dtype) for x in tensors)}")


def _launch(t, s, out, seg: Optional[torch.Tensor],
            order: Optional[torch.Tensor], n_seg: int, width: int) -> None:
    lib = _lib()
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(t.device):
        code = lib.lindley_scan(t.data_ptr(), s.data_ptr(), out.data_ptr(),
                                ptr(seg), ptr(order), n_seg, t.numel(), width,
                                _build.stream_of(t))
    _build.check(lib, code, "lindley_scan")
    lindley_scan.launches += 1


def lindley_scan(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t, s (R, W) float64 on the card -> service starts (R, W) float64."""
    _check("lindley_scan", t, s)
    if t.dim() != 2 or t.shape != s.shape:
        raise ValueError(f"lindley_scan: t {tuple(t.shape)} and s "
                         f"{tuple(s.shape)} are not one (R, W) shape")
    R, W = t.shape
    out = torch.empty_like(t)
    if R and W:
        _launch(t, s, out, None, None, R, W)
    return out


lindley_scan.launches = 0


def lindley_scan_segments(seg: torch.Tensor, t: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """seg (n_seg + 1,) int64 fenceposts from 0 to n, t and s (n,) float64,
    all on the card -> the service starts (n,) float64, in one launch.
    Where the solve has more segments than the card holds at once, the
    blocks take them longest first.  The fenceposts are not checked here
    (that would wait for the card): check them on the host first, with
    :func:`check_fenceposts`, as the solver does."""
    _check("lindley_scan_segments", t, s)
    _build.require_cuda("lindley_scan_segments", seg)
    if seg.dtype != torch.int64 or seg.dim() != 1 or seg.numel() < 1:
        raise ValueError(f"lindley_scan_segments: seg must be (n_seg + 1,) "
                         f"int64, not {tuple(seg.shape)} {seg.dtype}")
    if t.dim() != 1 or t.shape != s.shape:
        raise ValueError(f"lindley_scan_segments: t {tuple(t.shape)} and s "
                         f"{tuple(s.shape)} are not one (n,) shape")
    out = torch.empty_like(t)
    n_seg = seg.numel() - 1
    if n_seg and t.numel():
        order = None
        if n_seg > resident_blocks(t.device):
            order = torch.argsort(seg[1:] - seg[:-1], descending=True,
                                  stable=True)
        _launch(t, s, out, seg, order, n_seg, 0)
    return out


def add_latency(device: torch.device, steps: int = 1 << 20) -> dict:
    """The step of K6's chain on ``device``: ``steps`` dependent fp64 adds
    on one thread -> {"clocks": SM clocks an add, "ns": ns an add}."""
    lib = _lib()
    s = torch.full((1,), 1e-3, dtype=torch.float64, device=device)
    out = torch.zeros(3, dtype=torch.float64, device=device)
    with torch.cuda.device(out.device):
        code = lib.lindley_add_latency(out.data_ptr(), s.data_ptr(), steps,
                                       _build.stream_of(out))
    _build.check(lib, code, "lindley_add_latency")
    _, clocks, ns = out.tolist()
    return {"clocks": clocks, "ns": ns}
