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

``rglru_scan_bwd`` launches K7b, the scan's gradient: the reverse
recurrence g_t = dy_t + a_{t+1} g_{t+1} in fp32, as K7's chunked scan run
backward in time (the same block, plan and cluster; each item's windows
from the last to the first), giving dx, dgx, dga, dh0 and dlog_a (summed
over B and S in a fixed order: each thread's steps, the sub-chunks, the
ranks, the windows, the batch rows); ``tests/test_torch_rglru_bwd_chunks.py``
holds a plain model of that decomposition against the JAX package.  It reads the forward's fp32 states (``rglru_scan(...,
keep_states=True)``), as JAX's autodiff of ``models/layers.py::rglru``
keeps them.  The TPU side has no such kernel.  ``rglru_scan_bwd_plain`` is
the same gradient in fp32 PyTorch (the reverse recurrence as the forward's
doubling scan), and ``RGLRUScan`` the autograd function that runs K7 and
K7b on the card and the plain versions on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, shape_only

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


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a log-depth
    doubling scan with ``models/layers.py::rglru``'s combine."""
    d = 1
    while d < b.shape[1]:
        # combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) at distance d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rglru_scan_plain(x: torch.Tensor, gx: torch.Tensor, ga: torch.Tensor,
                     log_a: torch.Tensor, h0: torch.Tensor,
                     keep_states: bool = False):
    """x/gx/ga (B, S, W); log_a (W,); h0 (B, W) -> h sequence (B, S, W);
    with ``keep_states`` also the states in fp32."""
    # every step's (a, b) in fp32, as the TPU kernel computes them
    log_a_t = C * torch.sigmoid(ga.float()) * F.softplus(log_a.float())
    a = torch.exp(log_a_t)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a_t), min=1e-12))
    b = mult * torch.sigmoid(gx.float()) * x.float()
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], 1)
    h = _scan(a, b)
    return (h.to(x.dtype), h) if keep_states else h.to(x.dtype)


def rglru_scan_bwd_plain(x, gx, ga, log_a, h0, h32, dy):
    """The gradient of ``rglru_scan_plain`` in fp32 PyTorch, as K7b
    computes it: (dx, dgx, dga) in x's dtype, dlog_a (W,) and dh0 (B, W)
    in fp32, from the fp32 states ``h32`` (B, S, W) and the sequence's
    cotangent ``dy``.  The reverse recurrence g_t = dy_t + a_{t+1} g_{t+1}
    runs as ``_scan`` over the flipped time axis; the clip at 1e-12 passes
    no gradient where it holds, as JAX's ``jnp.clip`` does."""
    xf, la = x.float(), log_a.float()
    r, ig = torch.sigmoid(ga.float()), torch.sigmoid(gx.float())
    sp = F.softplus(la)
    log_a_t = C * r * sp
    a = torch.exp(log_a_t)
    e2 = torch.exp(2.0 * log_a_t)
    u = 1.0 - e2
    m = torch.sqrt(torch.clamp(u, min=1e-12))
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    g = _scan(a_next.flip(1), dy.float().flip(1)).flip(1)
    h_prev = torch.cat([h0.float()[:, None], h32[:, :-1]], 1)
    gi = g * ig
    dL = g * h_prev * a + torch.where(u > 1e-12, -gi * xf * e2 / m, 0.0)
    dx = gi * m
    dgx = gi * m * xf * (1.0 - ig)
    dga = dL * (C * sp) * r * (1.0 - r)
    dlog_a = C * torch.sigmoid(la) * (dL * r).sum((0, 1))
    dh0 = a[:, 0] * g[:, 0]
    return (dx.to(x.dtype), dgx.to(x.dtype), dga.to(x.dtype), dlog_a, dh0)


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
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
        lib.rglru_scan_bwd.argtypes = ([ctypes.c_void_p] * 13
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.rglru_scan_bwd.restype = ctypes.c_int
        lib.rglru_launch_shape.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.rglru_launch_shape.restype = ctypes.c_int
    return lib


def _check_args(kernel: str, x, gx, ga, log_a, h0) -> None:
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, want (B, S, W)")
    B, S, W = x.shape
    if (gx.shape != x.shape or ga.shape != x.shape or log_a.shape != (W,)
            or h0.shape != (B, W)):
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, gx "
                         f"{tuple(gx.shape)}, ga {tuple(ga.shape)}, log_a "
                         f"{tuple(log_a.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match")
    if not x.dtype == gx.dtype == ga.dtype:
        raise TypeError(f"{kernel}: x, gx and ga differ in dtype ({x.dtype},"
                        f" {gx.dtype}, {ga.dtype})")
    _build.dtype_code(x.dtype)
    for name, t in (("log_a", log_a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, not "
                            f"{t.dtype}")


def rglru_scan(x: torch.Tensor, gx: torch.Tensor, ga: torch.Tensor,
               log_a: torch.Tensor, h0: torch.Tensor,
               keep_states: bool = False):
    """The same function on the card: x, gx, ga float32 or bfloat16 (one
    dtype), log_a and h0 float32.  With ``keep_states`` also every state
    in fp32 (B, S, W), which ``rglru_scan_bwd`` reads."""
    _check_args("rglru_scan", x, gx, ga, log_a, h0)
    if shape_only.is_fake(x, gx, ga, log_a, h0):
        y, h32 = torch.ops.repro_torch.rglru_scan(x, gx, ga, log_a, h0,
                                                  keep_states)
        return (y, h32) if keep_states else y
    B, S, W = x.shape
    _build.require_cuda("rglru_scan", x, gx, ga, log_a, h0)
    y = torch.empty_like(x)
    h32 = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
           if keep_states else None)
    if x.numel() == 0:
        return (y, h32) if keep_states else y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.rglru_scan(x.data_ptr(), gx.data_ptr(), ga.data_ptr(),
                             log_a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                             None if h32 is None else h32.data_ptr(),
                             B, S, W, launch_plan(B, S, W)["cluster"],
                             _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(lib, err, "rglru_scan")
    rglru_scan.launches += 1
    return (y, h32) if keep_states else y


def rglru_scan_bwd(x, gx, ga, log_a, h0, h32, dy):
    """K7b on the card: (dx, dgx, dga, dlog_a, dh0), what
    ``rglru_scan_bwd_plain`` computes.  ``h32`` are the fp32 states
    ``rglru_scan(..., keep_states=True)`` returned for these inputs; dy has
    x's shape and dtype."""
    _check_args("rglru_scan_bwd", x, gx, ga, log_a, h0)
    B, S, W = x.shape
    if h32.shape != x.shape or h32.dtype != torch.float32:
        raise ValueError(f"rglru_scan_bwd: h32 {tuple(h32.shape)} "
                         f"{h32.dtype}, want {tuple(x.shape)} float32")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rglru_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"is not x's {tuple(x.shape)} {x.dtype}")
    if shape_only.is_fake(x, gx, ga, log_a, h0, h32, dy):
        return torch.ops.repro_torch.rglru_scan_bwd(x, gx, ga, log_a, h0, h32,
                                                    dy)
    _build.require_cuda("rglru_scan_bwd", x, gx, ga, log_a, h0, h32, dy)
    dx, dgx, dga = (torch.empty_like(x) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=x.device)
    dh0, dla = torch.empty((B, W), **f32), torch.empty((B, W), **f32)
    dlog_a = torch.empty((W,), **f32)
    if x.numel() == 0:
        return dx, dgx, dga, dlog_a.zero_(), dh0.zero_()
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.rglru_scan_bwd(
            x.data_ptr(), gx.data_ptr(), ga.data_ptr(), log_a.data_ptr(),
            h0.data_ptr(), h32.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgx.data_ptr(), dga.data_ptr(), dh0.data_ptr(), dla.data_ptr(),
            dlog_a.data_ptr(), B, S, W, launch_plan(B, S, W)["cluster"],
            _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(lib, err, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return dx, dgx, dga, dlog_a, dh0


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with its gradient: K7 forward (keeping the fp32
    states) and K7b backward on the card, ``rglru_scan_plain`` and
    ``rglru_scan_bwd_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, x, gx, ga, log_a, h0):
        if x.device.type == "cpu":
            y, h32 = rglru_scan_plain(x, gx, ga, log_a, h0, keep_states=True)
        else:
            y, h32 = rglru_scan(x, gx, ga, log_a, h0, keep_states=True)
        ctx.save_for_backward(x, gx, ga, log_a, h0, h32)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gx, ga, log_a, h0, h32 = ctx.saved_tensors
        bwd = (rglru_scan_bwd_plain if x.device.type == "cpu"
               else rglru_scan_bwd)
        return bwd(x, gx, ga, log_a, h0, h32, dy.contiguous())
