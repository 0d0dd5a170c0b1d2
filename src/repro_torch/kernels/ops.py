"""Public wrappers of the ported kernels, with the names, argument order and
defaults of the JAX package's ``kernels/ops.py``.

A CPU tensor takes the kernel's plain PyTorch version; any other tensor
launches the hand-written CUDA kernel, which raises where it cannot run.
The TPU tile sizes (``bm``/``bn``/``bk``, ``bq``/``bk``) are accepted for
call compatibility and unused: the CUDA kernels pick their own tiles and
mask ragged edges.  ``interpret`` has no counterpart, and neither has the
x64 context of the JAX package's ``lindley``: float64 is explicit here.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lindley import lindley_scan, lindley_scan_plain
from repro_torch.kernels.systolic_matmul import (systolic_matmul,
                                                 systolic_matmul_plain)
from repro_torch.kernels.vector_engine import (fused_affine_act,
                                               fused_affine_act_plain)


def matmul(x, w, b=None, *, act="none", bm=128, bn=128, bk=128,
           out_dtype=None):
    if x.device.type == "cpu":
        return systolic_matmul_plain(x, w, b, act=act, out_dtype=out_dtype)
    return systolic_matmul(x.contiguous(), w.contiguous(), b, act=act,
                           out_dtype=out_dtype)


def matmul_padded(x, w, b=None, *, act="none", bm=128, bn=128, bk=128,
                  out_dtype=None):
    """``matmul`` for arbitrary shapes.  The TPU version zero-pads (M, K, N)
    to tile multiples; the CUDA kernel masks its ragged tiles instead, so
    this is ``matmul`` with the same (M, N) result."""
    return matmul(x, w, b, act=act, out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=0, bq=128, bk=128):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


def affine_act(x, scale, bias, *, act="none", out_dtype=None):
    if x.device.type == "cpu":
        return fused_affine_act_plain(x, scale, bias, act=act,
                                      out_dtype=out_dtype)
    return fused_affine_act(x.contiguous(), scale, bias, act=act,
                            out_dtype=out_dtype)


def lindley(t, s, *, br=128, bd=128):
    """Batched FCFS service starts in float64: t, s (R, W) -> (R, W)."""
    if t.device.type == "cpu":
        return lindley_scan_plain(t, s)
    return lindley_scan(t.contiguous(), s.contiguous())
