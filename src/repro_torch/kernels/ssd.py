"""The Mamba-2 SSD chunk scan on Hopper (K8) and its gradient (K8b).

``ssd_scan`` launches ``csrc/ssd.cu``: for x (B, S, H, P), dt (B, S, H), A
(H,) and B/C (B, S, G, N), the selective state-space recurrence of Mamba-2
computed chunk by chunk, with the (P, N) fp32 state carried across chunks
and B/C shared by the H/G heads of a group.  It returns y (B, S, H, P) in
x's dtype and the final state (B, H, P, N) in fp32.  It replaces the Pallas
TPU kernel ``repro/kernels/ssd.py::ssd_scan`` and, like
``repro/models/layers.py::ssd_chunked``, also takes a starting state
``h0``.  ``ssd_scan_plain`` is the same function in plain PyTorch, chunked
as the TPU kernel is: the CPU path of ``ops.ssd`` and the reference on the
card.

``ssd_scan_bwd`` launches K8b, the gradient of that function with respect
to x, dt, A, B, C and h0, given dy and the final state's gradient.  The
JAX package has no kernel for it (it differentiates ``ssd_chunked``);
``ssd_scan_bwd_plain`` is ``torch.autograd.grad`` through
``ssd_scan_plain``.  ``SSDScan`` ties the two directions into one
``torch.autograd.Function``: K8 and K8b on the card, where K8 keeps the
state entering each of its 64-row chunks for K8b (fp32, B * H * ceil(S /
64) * P * N * 4 bytes: 134 MB a layer at (8, 1024, 32, 64, 128)), and the
plain versions on the CPU.

Both kernels spread the chunks of one (batch row, head) over a
thread-block cluster of up to 8 blocks and run their products on the
tensor cores (``csrc/ssd.cu``'s note); ``launch_shape`` gives the grid.
K8b sums dB and dC over the heads a block takes (2 in bf16, 1 in fp32), so
its partials are (B, S, H / heads, N) a P tile, which the wrapper sums in
a fixed order.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 128                 # N the CUDA kernel's register tiles cover
KERNEL_CHUNK = 64               # rows of the chunks the CUDA kernels walk
P_TILE = 64                     # columns of P one CUDA block holds


def _chunk(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"ssd: sequence length {S} is not a multiple of the "
                         f"chunk {Q} (chunk={chunk})")
    return Q


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N); h0 (B,H,P,N) or None.

    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    Q = _chunk(S, chunk)
    rep = H // Bm.shape[2]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)           # (B,S,H,N)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros(Bsz, H, P, N, device=x.device) if h0 is None
             else h0.float())
    upper = ~torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bc, Cc = Bh[:, c0:c0 + Q], Ch[:, c0:c0 + Q]
        cum = torch.cumsum(dtc * Af, dim=1)                 # (B,Q,H)
        seg = cum[:, -1]                                    # (B,H)
        # exp(cum_i - cum_j) for i >= j; -inf above the diagonal gives 0
        Li = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            upper[None, :, :, None], float("-inf"))
        W = (torch.einsum("bqhn,bkhn->bqkh", Cc, Bc) * torch.exp(Li)
             * dtc[:, None, :, :])
        y = torch.einsum("bqkh,bkhp->bqhp", W, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqhn,bhpn->bqhp", Cc, state)
        w = dtc * torch.exp(seg[:, None, :] - cum)          # (B,Q,H)
        state = torch.exp(seg)[..., None, None] * state + torch.einsum(
            "bqhp,bqhn->bhpn", xc * w[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dstate: Optional[torch.Tensor], *, chunk: int = 128
                       ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dBm, dCm, dh0): ``torch.autograd.grad`` of
    ``ssd_scan_plain``'s (y, final state) with cotangents (dy, dstate);
    h0 None is zeros, dstate None adds nothing.  Each gradient has its
    input's dtype (dh0 fp32)."""
    with torch.enable_grad():
        h = (torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[3],
                         device=x.device) if h0 is None else h0)
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm, h)]
        y, hf = ssd_scan_plain(*ins[:5], chunk=chunk, h0=ins[5])
        outs, cots = [y], [dy]
        if dstate is not None:
            outs.append(hf)
            cots.append(dstate)
        return torch.autograd.grad(outs, ins, cots)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_launch_shape.argtypes = ([ctypes.c_int] * 8
                                         + [ctypes.POINTER(ctypes.c_int)])
        lib.ssd_launch_shape.restype = ctypes.c_int
        lib.ssd_scan.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan_bwd.argtypes = ([ctypes.c_void_p] * 14
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ssd_scan_bwd.restype = ctypes.c_int
    return lib


def launch_shape(B: int, S: int, H: int, P: int, G: int, N: int,
                 dtype: torch.dtype, backward: bool = False) -> dict:
    """K8's (or, with ``backward``, K8b's) launch at these sizes, as the
    library computes it: ``grid`` (x, y, z), the ``cluster`` of blocks
    along y that share one (batch row, head) or (batch row, heads), the
    ``blocks``, each block's dynamic shared memory ``smem_bytes`` and K8b's
    ``heads_per_block``."""
    out = (ctypes.c_int * 5)()
    lib = _lib()
    err = lib.ssd_launch_shape(B, S, H, P, G, N, _build.dtype_code(dtype),
                               int(backward), out)
    _build.check(lib, err, "ssd_launch_shape")
    grid = tuple(out[:3])
    return {"grid": grid, "cluster": grid[1],
            "blocks": grid[0] * grid[1] * grid[2], "smem_bytes": out[3],
            "heads_per_block": out[4]}


def _check_args(name, x, dt, A, Bm, Cm, h0, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}: want "
                         f"(B,S,H,P), (B,S,H), (H,), (B,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape[:2] != (Bsz, S)
            or Cm.shape != Bm.shape or H % G
            or (h0 is not None and h0.shape != (Bsz, H, P, N))):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)} do not "
                         f"match")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"{name}: state width {N} not in 1..{MAX_STATE}")
    if not x.dtype == Bm.dtype == Cm.dtype:
        raise TypeError(f"{name}: x, Bm and Cm differ in dtype ({x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype})")
    _build.dtype_code(x.dtype)
    for arg, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, not {t.dtype}")
    _chunk(S, chunk)
    _build.require_cuda(name, x, dt, A, Bm, Cm,
                        *(() if h0 is None else (h0,)))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None, keep_states: bool = False
             ) -> Tuple[torch.Tensor, ...]:
    """The same function on the card: x, Bm, Cm float32 or bfloat16 (one
    dtype), dt, A and h0 float32.  The kernel walks its own 64-row chunks;
    ``chunk`` is checked (S a multiple of min(chunk, S)) as the JAX code
    asserts it, since chunking does not change the function.  With
    ``keep_states`` it also returns the fp32 state entering each of its
    chunks, (B, H, ceil(S / 64), P, N), which ``ssd_scan_bwd`` reads."""
    _check_args("ssd_scan", x, dt, A, Bm, Cm, h0, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    states = (torch.empty((Bsz, H, -(-S // KERNEL_CHUNK), P, N),
                          dtype=torch.float32, device=x.device)
              if keep_states else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           Bm.data_ptr(), Cm.data_ptr(),
                           None if h0 is None else h0.data_ptr(),
                           y.data_ptr(), state.data_ptr(),
                           None if states is None else states.data_ptr(),
                           Bsz, S, H, P, G, N, _build.dtype_code(x.dtype),
                           _build.stream_of(x))
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return (y, state, states) if keep_states else (y, state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor], dy: torch.Tensor,
                 dstate: Optional[torch.Tensor], *, states: torch.Tensor,
                 chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """K8b on the card: (dx, ddt, dA, dBm, dCm, dh0), what
    ``ssd_scan_bwd_plain`` computes, each in its input's dtype (dh0 fp32).
    ``states`` are the chunk states ``ssd_scan(..., keep_states=True)``
    returned for these inputs (h0 is their first).  dy has x's dtype;
    dstate (fp32) None adds nothing."""
    _check_args("ssd_scan_bwd", x, dt, A, Bm, Cm, h0, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} is "
                         f"not x's {tuple(x.shape)} {x.dtype}")
    if dstate is not None and (dstate.shape != (Bsz, H, P, N)
                               or dstate.dtype != torch.float32):
        raise ValueError(f"ssd_scan_bwd: dstate {tuple(dstate.shape)} "
                         f"{dstate.dtype}, want {(Bsz, H, P, N)} float32")
    if states.shape != (Bsz, H, -(-S // KERNEL_CHUNK), P, N):
        raise ValueError(f"ssd_scan_bwd: states {tuple(states.shape)} are "
                         f"not these inputs' chunk states")
    _build.require_cuda("ssd_scan_bwd", dy, states,
                        *(() if dstate is None else (dstate,)))
    npt = -(-P // P_TILE)
    nc = -(-S // KERNEL_CHUNK)
    hbg = -(-(H // G) // launch_shape(Bsz, S, H, P, G, N, x.dtype,
                                      backward=True)["heads_per_block"])
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt_p = torch.empty((npt, Bsz, S, H), **f32)
    dA_p = torch.empty((npt, Bsz, nc, H), **f32)
    dB_p = torch.empty((npt, Bsz, S, G * hbg, N), **f32)
    dC_p = torch.empty((npt, Bsz, S, G * hbg, N), **f32)
    dh0 = torch.empty((Bsz, H, P, N), **f32)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
            ddt_p.data_ptr(), dA_p.data_ptr(), dB_p.data_ptr(),
            dC_p.data_ptr(), dh0.data_ptr(), Bsz, S, H, P, G, N,
            _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(lib, err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1

    def per_group(t):   # (npt, B, S, G * hbg, N) -> (B, S, G, N), in fp32
        return t.view(npt, Bsz, S, G, hbg, N).sum((0, 4)).to(Bm.dtype)

    return (dx, ddt_p[0] if npt == 1 else ddt_p.sum(0), dA_p.sum((0, 1, 2)),
            per_group(dB_p), per_group(dC_p), dh0)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient: K8 forward and K8b backward on the
    card, ``ssd_scan_plain`` and ``ssd_scan_bwd_plain`` on the CPU.
    Returns (y, final state) as ``ssd_scan`` does."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            y, state = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
            states = None
        else:
            y, state, states = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                        keep_states=True)
        ctx.has_h0 = h0 is not None
        ctx.has_states = states is not None
        ctx.save_for_backward(x, dt, A, Bm, Cm,
                              *((h0,) if ctx.has_h0 else ()),
                              *((states,) if ctx.has_states else ()))
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = list(ctx.saved_tensors)
        x, dt, A, Bm, Cm = saved[:5]
        h0 = saved[5] if ctx.has_h0 else None
        states = saved[-1] if ctx.has_states else None
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cpu":
            grads = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate,
                                       chunk=ctx.chunk)
        else:
            grads = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy.contiguous(),
                                 None if dstate is None
                                 else dstate.contiguous(),
                                 chunk=ctx.chunk, states=states)
        dx, ddt, dA, dB, dC, dh0 = grads
        return dx, ddt, dA, dB, dC, (dh0 if ctx.has_h0 else None), None
