"""The RG-LRU recurrence on Hopper (K7).

``rglru_scan`` launches ``csrc/rglru.cu``: for x, gx, ga (B, S, W), the
channel decay ``log_a`` (W,) and the starting state h0 (B, W), RecurrentGemma's
gated linear recurrence ``h_t = a_t * h_{t-1} + b_t`` with

    log_a_t = -8 * sigmoid(ga_t) * softplus(log_a),  a_t = exp(log_a_t),
    b_t = sqrt(max(1 - exp(2 * log_a_t), 1e-12)) * sigmoid(gx_t) * x_t,

the state in fp32 and the sequence returned in x's dtype.  It replaces the
Pallas TPU kernel ``repro/kernels/rglru.py::rglru_scan`` and, unlike it,
needs no tile to divide S, W or B.  ``rglru_scan_plain`` is the same
function in plain PyTorch, a log-depth doubling scan with
``models/layers.py::rglru``'s combine: the CPU path of ``ops.rglru`` and the
reference on the card.

The kernel walks the time axis in windows of a cluster of blocks (its size
from ``launch_plan``), each block ``SUBCHUNKS`` sub-chunks of
``SUB_STEPS`` steps over ``CHANNELS`` channels;
``tests/test_torch_rglru_chunks.py`` holds a plain model of that
decomposition against the JAX package.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

C = -8.0
# The kernel's block (csrc/rglru.cu, checked against the library at load):
# channels, sub-chunks (a warp each) and steps a sub-chunk; and the most
# blocks a cluster spans along the time axis.
CHANNELS, SUBCHUNKS, SUB_STEPS = 32, 4, 8
MAX_CLUSTER = 8


def launch_plan(B: int, S: int, W: int) -> dict:
    """K7's plan at (B, S, W): the ``cluster`` of blocks that spans a
    window of the time axis, the ``windows`` a cluster walks one after
    another for each of the ``items`` (batch row, channel tile)."""
    span = SUBCHUNKS * SUB_STEPS
    cluster = max(1, min(MAX_CLUSTER, -(-S // span)))
    return {"cluster": cluster, "windows": -(-S // (cluster * span)),
            "items": B * -(-W // CHANNELS)}


def rglru_scan_plain(x: torch.Tensor, gx: torch.Tensor, ga: torch.Tensor,
                     log_a: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """x/gx/ga (B, S, W); log_a (W,); h0 (B, W) -> h sequence (B, S, W)."""
    # every step's (a, b) in fp32, as the TPU kernel computes them
    log_a_t = C * torch.sigmoid(ga.float()) * F.softplus(log_a.float())
    a = torch.exp(log_a_t)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a_t), min=1e-12))
    b = mult * torch.sigmoid(gx.float()) * x.float()
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], 1)
    d = 1
    while d < x.shape[1]:
        # combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) at distance d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b.to(x.dtype)


def launch_shape(B: int, S: int, W: int, dtype: torch.dtype) -> dict:
    """The launch the library makes at (B, S, W) on the current device:
    the ``grid`` (cluster, clusters), each cluster walking
    ``items / grid[1]`` items, the ``threads`` a block and its dynamic
    shared memory ``smem_bytes``."""
    out = (ctypes.c_int * 4)()
    lib = _lib()
    err = lib.rglru_launch_shape(B, S, W, launch_plan(B, S, W)["cluster"],
                                 _build.dtype_code(dtype), out)
    _build.check(lib, err, "rglru_launch_shape")
    return {"grid": (out[0], out[1]), "threads": out[2],
            "smem_bytes": out[3]}


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    if lib.rglru_scan.argtypes is None:
        shape, want = (ctypes.c_int * 3)(), (CHANNELS, SUBCHUNKS, SUB_STEPS)
        lib.rglru_block_shape(shape)
        if tuple(shape) != want:
            raise RuntimeError(f"rglru.cu's block {tuple(shape)} is not "
                               f"launch_plan's {want}")
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
        lib.rglru_launch_shape.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.rglru_launch_shape.restype = ctypes.c_int
    return lib


def rglru_scan(x: torch.Tensor, gx: torch.Tensor, ga: torch.Tensor,
               log_a: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The same function on the card: x, gx, ga float32 or bfloat16 (one
    dtype), log_a and h0 float32."""
    if x.dim() != 3:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, want (B, S, W)")
    B, S, W = x.shape
    if (gx.shape != x.shape or ga.shape != x.shape or log_a.shape != (W,)
            or h0.shape != (B, W)):
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, gx "
                         f"{tuple(gx.shape)}, ga {tuple(ga.shape)}, log_a "
                         f"{tuple(log_a.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match")
    if not x.dtype == gx.dtype == ga.dtype:
        raise TypeError(f"rglru_scan: x, gx and ga differ in dtype ({x.dtype},"
                        f" {gx.dtype}, {ga.dtype})")
    code = _build.dtype_code(x.dtype)
    for name, t in (("log_a", log_a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} must be float32, not "
                            f"{t.dtype}")
    _build.require_cuda("rglru_scan", x, gx, ga, log_a, h0)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.rglru_scan(x.data_ptr(), gx.data_ptr(), ga.data_ptr(),
                             log_a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                             B, S, W, launch_plan(B, S, W)["cluster"], code,
                             _build.stream_of(x))
    _build.check(lib, err, "rglru_scan")
    rglru_scan.launches += 1
    return y


rglru_scan.launches = 0
