"""Building blocks of the JAX package's ``models/layers.py``.

The vision models use ``rms_norm`` and ``act_fn``; the Mamba-2 blocks add
``causal_conv1d``, ``ssd_chunked`` (the SSD chunk scan, K8 on the card
through ``ops.ssd``) and ``ssd_step`` (one decode token, plain PyTorch: the
JAX package has no kernel for it).  RoPE, blocked attention, MoE and the
RG-LRU come with the slices that need them (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD forward.

    x  (B, S, H, P)   input heads
    dt (B, S, H)      softplus'd step sizes (>0), fp32
    A  (H,)           negative state decay, fp32
    Bm (B, S, G, N), Cm (B, S, G, N)  input/output projections (G groups)
    h0 (B, H, P, N)   starting state, fp32 (zeros if None)
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) fp32).
    """
    return ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)


def ssd_step(xt, dtt, A, Bt, Ct, h_prev):
    """Single-token SSD state update for decode.

    xt (B,H,P), dtt (B,H), Bt/Ct (B,G,N), h_prev (B,H,P,N) fp32.
    """
    rep = xt.shape[1] // Bt.shape[1]
    dtf = dtt.float()
    dA = torch.exp(dtf * A.float()[None, :])                    # (B,H)
    Bh = Bt.float().repeat_interleave(rep, dim=1)               # (B,H,N)
    Ch = Ct.float().repeat_interleave(rep, dim=1)
    h = h_prev * dA[..., None, None] + (
        dtf[..., None, None] * xt.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    return y.to(xt.dtype), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv via explicit shifts (width K small).

    x (B, S, C), w (K, C).  Returns (y, new_state (B, K-1, C))."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state
