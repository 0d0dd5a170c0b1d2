"""The Mamba-2 SSD chunk scan on Hopper (K8).

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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 128                 # N the CUDA kernel's register tiles cover


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
        lib.ssd_scan.restype = ctypes.c_int
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function on the card: x, Bm, Cm float32 or bfloat16 (one
    dtype), dt, A and h0 float32.  The kernel walks its own 64-row chunks;
    ``chunk`` is checked (S a multiple of min(chunk, S)) as the JAX code
    asserts it, since chunking does not change the function."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}: want "
                         f"(B,S,H,P), (B,S,H), (H,), (B,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape[:2] != (Bsz, S)
            or Cm.shape != Bm.shape or H % G
            or (h0 is not None and h0.shape != (Bsz, H, P, N))):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)} do not "
                         f"match")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state width {N} not in 1..{MAX_STATE}")
    if not x.dtype == Bm.dtype == Cm.dtype:
        raise TypeError(f"ssd_scan: x, Bm and Cm differ in dtype ({x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype})")
    code = _build.dtype_code(x.dtype)
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, not {t.dtype}")
    _chunk(S, chunk)
    _build.require_cuda("ssd_scan", x, dt, A, Bm, Cm,
                        *(() if h0 is None else (h0,)))
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           Bm.data_ptr(), Cm.data_ptr(),
                           None if h0 is None else h0.data_ptr(),
                           y.data_ptr(), state.data_ptr(), Bsz, S, H, P, G, N,
                           code, _build.stream_of(x))
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
