"""Public wrappers of the ported kernels, with the names, argument order and
defaults of the JAX package's ``kernels/ops.py``.

A CPU tensor takes the kernel's plain PyTorch version; any other tensor
launches the hand-written CUDA kernel, which raises where it cannot run.
The TPU tile sizes (``bm``/``bn``/``bk``, ``bq``/``bk``) are accepted for
call compatibility and unused: the CUDA kernels pick their own tiles and
mask ragged edges.  ``interpret`` has no counterpart, and neither has the
x64 context of the JAX package's ``lindley``: float64 is explicit here.
``rglru`` keeps the TPU kernel's arguments, ``h0`` included.
``ssd`` takes a trailing ``h0`` (the starting state, zeros if None), which
the TPU kernel lacks and ``models.layers.ssd_chunked`` passes on; its
``chunk`` is checked as the JAX code checks it (the kernel walks its own
chunks, which does not change the function).

Gradients.  ``ssd``, ``attention`` and ``rglru`` are differentiable
everywhere: when grad mode is on and an input requires grad they go through
``SSDScan`` (K8 forward, K8b backward), ``FlashAttention`` (K5, K5b) and
``RGLRUScan`` (K7, K7b) on the card, and the same functions over the plain
versions on the CPU.  The other kernels have no backward yet, so on the
card ``matmul``, ``affine_act``, ``lindley`` and ``lindley_segments`` raise
``NotImplementedError`` where autograd would need one, rather than return a
tensor cut off from the graph; on the CPU their plain versions are
differentiable.  ``quantize`` and ``dequantize`` act on gradients and need
none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lindley import (check_fenceposts, lindley_scan,
                                         lindley_scan_plain,
                                         lindley_scan_segments,
                                         lindley_scan_segments_plain)
from repro_torch.kernels.rglru import (RGLRUScan, rglru_scan,
                                       rglru_scan_plain)
from repro_torch.kernels.ssd import SSDScan, ssd_scan, ssd_scan_plain
from repro_torch.kernels.systolic_matmul import (systolic_matmul,
                                                 systolic_matmul_plain)
from repro_torch.kernels.vector_engine import (dequantize_int8,
                                               dequantize_int8_plain,
                                               fused_affine_act,
                                               fused_affine_act_plain,
                                               quantize_int8,
                                               quantize_int8_plain)

# The slice of the port that brings each kernel's backward (ROADMAP.md).
_BACKWARD_SLICE = {
    "matmul": "a later slice (no training path runs K1 yet)",
    "affine_act": "a later slice (no training path runs K2 yet)",
    "lindley": "none planned (the fleet simulator is not trained)",
}


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(op: str, *tensors) -> None:
    """Raise if autograd would need the backward of a kernel that has none."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"ops.{op}: the CUDA kernel has no backward yet, and an input "
            f"requires grad; the backward comes with "
            f"{_BACKWARD_SLICE[op]} (ROADMAP.md).  Run under "
            f"torch.no_grad() or on the CPU.")


def matmul(x, w, b=None, *, act="none", bm=128, bn=128, bk=128,
           out_dtype=None):
    if x.device.type == "cpu":
        return systolic_matmul_plain(x, w, b, act=act, out_dtype=out_dtype)
    _refuse_grad("matmul", x, w, b)
    if not w.t().is_contiguous():     # K1 takes w row-major or K-major
        w = w.contiguous()
    return systolic_matmul(x.contiguous(), w, b, act=act,
                           out_dtype=out_dtype)


def matmul_padded(x, w, b=None, *, act="none", bm=128, bn=128, bk=128,
                  out_dtype=None):
    """``matmul`` for arbitrary shapes.  The TPU version zero-pads (M, K, N)
    to tile multiples; the CUDA kernel masks its ragged tiles instead, so
    this is ``matmul`` with the same (M, N) result."""
    return matmul(x, w, b, act=act, out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=0, bq=128, bk=128,
              q_offset=0, kv_len=None):
    """q (B,H,Sq,D), k (B,KV,Skv,D), v (B,KV,Skv,Dv) -> (B,H,Sq,Dv); query
    row i at position i + ``q_offset``, the keys below ``kv_len`` (None,
    an int or a 0-d integer tensor) valid."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, q_offset,
                                    kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, q_offset=q_offset,
                           kv_len=kv_len)


def affine_act(x, scale, bias, *, act="none", out_dtype=None):
    if x.device.type == "cpu":
        return fused_affine_act_plain(x, scale, bias, act=act,
                                      out_dtype=out_dtype)
    _refuse_grad("affine_act", x, scale, bias)
    return fused_affine_act(x.contiguous(), scale, bias, act=act,
                            out_dtype=out_dtype)


def lindley(t, s, *, br=128, bd=128):
    """Batched FCFS service starts in float64: t, s (R, W) -> (R, W)."""
    if t.device.type == "cpu":
        return lindley_scan_plain(t, s)
    _refuse_grad("lindley", t, s)
    return lindley_scan(t.contiguous(), s.contiguous())


def lindley_segments(seg, t, s):
    """``lindley`` over the flat layout of a solve, one launch for all its
    queues: seg (n_seg + 1,) int64 fenceposts from 0 to n, t and s (n,)
    float64 -> the starts (n,).  The JAX package has no counterpart: its
    solver calls ``lindley`` once for each length bucket.  On the card the
    fenceposts are not checked: check them first (``check_fenceposts``)."""
    if t.device.type == "cpu":
        return lindley_scan_segments_plain(seg, t, s)
    _refuse_grad("lindley", t, s)
    return lindley_scan_segments(seg.contiguous(), t.contiguous(),
                                 s.contiguous())


def rglru(x, gx, ga, log_a, h0):
    """RG-LRU: x/gx/ga (B,S,W), log_a (W,), h0 (B,W) -> (B,S,W), x's dtype."""
    if _needs_grad(x, gx, ga, log_a, h0):
        return RGLRUScan.apply(x.contiguous(), gx.contiguous(),
                               ga.contiguous(), log_a.contiguous(),
                               h0.contiguous())
    if x.device.type == "cpu":
        return rglru_scan_plain(x, gx, ga, log_a, h0)
    return rglru_scan(x.contiguous(), gx.contiguous(), ga.contiguous(),
                      log_a.contiguous(), h0.contiguous())


def quantize(x, absmax=None):
    """Per-row symmetric int8: x (M, N) -> (int8 (M, N), fp32 (M, 1));
    ``absmax``: the rows' (M,) fp32 absmax, given (a split leaf's whole
    absmax), else x's own."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, absmax)
    return quantize_int8(x.contiguous(), absmax)


def dequantize(q, scales, *, out_dtype=None):
    out_dtype = out_dtype or torch.float32
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, scales, out_dtype=out_dtype)
    return dequantize_int8(q.contiguous(), scales.contiguous(),
                           out_dtype=out_dtype)


def ssd(x, dt, A, Bm, Cm, *, chunk=128, h0=None):
    """Mamba-2 SSD: (y (B,S,H,P), final state (B,H,P,N) fp32)."""
    if _needs_grad(x, dt, A, Bm, Cm, h0):
        contig = lambda t: None if t is None else t.contiguous()
        return SSDScan.apply(*map(contig, (x, dt, A, Bm, Cm, h0)), chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                    Bm.contiguous(), Cm.contiguous(), chunk=chunk,
                    h0=None if h0 is None else h0.contiguous())
