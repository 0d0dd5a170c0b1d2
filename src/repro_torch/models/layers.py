"""Building blocks of the JAX package's ``models/layers.py``.

The vision models use ``rms_norm`` and ``act_fn``; the Mamba-2 blocks add
``causal_conv1d``, ``ssd_chunked`` (the SSD chunk scan, K8 on the card
through ``ops.ssd``) and ``ssd_step`` (one decode token, plain PyTorch: the
JAX package has no kernel for it).  RecurrentGemma adds RoPE
(``rope_angles``, ``apply_rope``), ``blocked_attention`` (K5 on the card
through ``ops.attention``, K5b for its gradient; the JAX package calls its
pure-JAX version the analogue of that kernel), ``_attn_block`` (plain, for
decode), ``rglru`` (K7 on the card through ``ops.rglru``, K7b for its
gradient) and ``rglru_step`` (plain).  The MoE
decoders add ``moe_ffn``, plain PyTorch as the JAX package has it (no
Pallas kernel): the expert products are batched matrix products.
qwen2-vl adds M-RoPE (``mrope_angles``: the frequency bands split over the
t/h/w position channels), and MLA (minicpm3-4b) a value head dim of its own
in ``blocked_attention``.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections=(1, 1, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE: positions (B, S, 3) (t/h/w ids) -> cos/sin (B, S,
    head_dim//2), fp32; frequency band i takes the position channel of the
    section it falls in, the bands split over the three sections in
    proportion to ``sections``."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    total = sum(sections)
    band = torch.zeros(half, dtype=torch.long)
    prev = acc = 0
    for i, sec in enumerate(sections):
        acc += sec
        bound = (half * acc) // total
        band[prev:bound] = i
        prev = bound
    # pick the position channel (t/h/w) for each frequency band
    pos = positions.float()[..., band.to(positions.device)]    # (B, S, half)
    ang = pos * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh); cos/sin (B, S, Dh//2) -> rotate-half RoPE."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_block(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                q_start, kv_start: int, causal: bool, window: int,
                kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """One query block attending to a K/V span, in plain PyTorch.

    qc (B, C, H, Dh); k/v (B, Skv, KV, Dv).  GQA via head grouping.
    ``q_start`` may be a 0-d tensor (the position of qc in the sequence);
    ``kv_len`` optionally masks the valid KV prefix (decode with a
    preallocated cache), as an int or a 0-d tensor shared by the batch.
    """
    B, C, H, Dh = qc.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = qc.reshape(B, C, KV, G, Dh)
    scores = torch.einsum("bckgd,bskd->bkgcs", qg, k).float()
    scores = scores / math.sqrt(Dh)
    qpos = q_start + torch.arange(C, device=qc.device)           # (C,)
    kpos = kv_start + torch.arange(Skv, device=qc.device)        # (Skv,)
    mask = torch.ones((C, Skv), dtype=torch.bool, device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", w.to(v.dtype), v)
    return out.reshape(B, C, H, v.shape[-1])


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, chunk: int = 512,
                      unroll: bool = True, q_offset: int = 0,
                      kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, Dh) over k (B, Skv, KV, Dh) and v (B,
    Skv, KV, Dv) -> (B, Sq, H, Dv), causal and windowed as asked, through
    ``ops.attention`` (K5 on the card, its plain version on the CPU; K5b
    under autograd).  ``q_offset`` (an int >= 0) puts query row i at
    position i + q_offset; ``kv_len`` (None, an int or a 0-d integer
    tensor, shared by the batch) keeps the keys below it: JAX's
    ``_attn_block`` mask.  A row that sees no key takes the mean of all
    Skv values, as JAX's softmax of a row all at the mask value gives it.

    The JAX package's version loops over query chunks; ``chunk`` and
    ``unroll`` only shape that loop, so they are accepted and unused here,
    like the TPU tile sizes.
    """
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window,
                      q_offset=q_offset, kv_len=kv_len)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# MoE with capacity-based sort-free dispatch (gather/scatter, no one-hot GEMM)
# ---------------------------------------------------------------------------

def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, *, num_experts: int, k: int,
            capacity_factor: float, act: str = "silu", block_tokens: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE FFN.  x (T, D) -> (T, D), plus the aux load-balance loss.

    Each token's top-k experts by softmax probability, their weights
    renormalised to sum to 1; each expert holds C = max(8, ceil(Tb k cf /
    E)) slots, filled in token order, and an assignment past them is
    dropped (it scatters into the overflow row E*C and gathers zeros back).
    ``block_tokens`` > 0 runs the tokens in sequential blocks (a Python
    loop where the JAX package scans) and averages their aux losses.
    """
    T_, D = x.shape
    E = num_experts
    f = act_fn(act)

    def one_block(xb):
        Tb = xb.shape[0]
        C = max(8, int(math.ceil(Tb * k * capacity_factor / E)))
        probs = torch.softmax((xb @ gate_w).float(), dim=-1)
        topv, topi = torch.topk(probs, k, dim=-1)               # (Tb, k)
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        flat_e = topi.reshape(-1)                               # (Tb*k,)
        oh = F.one_hot(flat_e, E)
        pos_in_e = ((oh.cumsum(0) - 1) * oh).sum(-1)            # (Tb*k,)
        slot = torch.where(pos_in_e < C, flat_e * C + pos_in_e, E * C)
        # dispatch: token rows into their slots; the overflow row E*C takes
        # every dropped assignment, in no defined order on the card, and is
        # never read
        tok_idx = torch.arange(Tb, device=xb.device).repeat_interleave(k)
        buf = torch.zeros((E * C + 1, D), dtype=xb.dtype, device=xb.device)
        buf[slot] = xb[tok_idx]
        xe = buf[:E * C].reshape(E, C, D)
        h = f(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
        ye = torch.bmm(h, w2).reshape(E * C, D)
        yflat = torch.cat([ye, ye.new_zeros((1, D))])
        yk = yflat[slot].reshape(Tb, k, D)
        out = torch.einsum("tkd,tk->td", yk, topv.to(yk.dtype))
        # aux: load-balance loss (Switch-style)
        ce = torch.bincount(flat_e, minlength=E).float() / (Tb * k)
        aux = E * (probs.mean(dim=0) * ce).sum()
        return out, aux

    if block_tokens and T_ > block_tokens and T_ % block_tokens == 0:
        outs, auxs = zip(*(one_block(xb)
                           for xb in x.split(block_tokens, dim=0)))
        return torch.cat(outs), torch.stack(auxs).mean()
    return one_block(x)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

def rglru(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
          log_a: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-Gated Linear Recurrent Unit, through ``ops.rglru`` (K7 on the
    card).

    x, gate_x, gate_a: (B, S, W).  log_a: (W,) learnable (Lambda).
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(c * softplus(Lambda) * r_t),  c = -8;  h_{-1} = h0 or zeros.
    Returns (h_seq (B,S,W), h_last (B,W)), both in x's dtype.
    """
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                         device=x.device)
    seq = ops.rglru(x, gate_x, gate_a, log_a.float(), h0.float())
    return seq, seq[:, -1]


def rglru_step(xt, gxt, gat, log_a, h_prev):
    """Single-token RG-LRU update for decode.  xt (B, W); returns xt's
    dtype."""
    c = -8.0
    r = torch.sigmoid(gat.float())
    i = torch.sigmoid(gxt.float())
    log_a_t = c * r * F.softplus(log_a.float())
    a = torch.exp(log_a_t)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a_t), min=1e-12))
    h = a * h_prev.float() + mult * i * xt.float()
    return h.to(xt.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

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
