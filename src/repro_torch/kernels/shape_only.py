"""Shape-only forms of the hand-written kernels, for the dry run.

Each launch function of K1-K5, K5b, K7, K7b, K8 and K8b hands a fake tensor
(``torch._subclasses.FakeTensor``) or a ``meta`` tensor to its operator
here, ``torch.ops.repro_torch.<launch function>``, after its own shape
checks.  The operator's fake kernel gives the outputs' shapes and dtypes
and does nothing else: it builds and loads no library and runs no plain
version.  ``torch.utils.flop_counter`` counts each at the operations of
its work count in ``analysis.roofline`` (an FMA as two, the count
``chip_smoke.py`` holds the kernel's time against), and a dispatch mode
sees its inputs and outputs as one operator's, as it sees the kernel.

A real tensor never takes this route: on the card the launch function
launches the kernel, on the CPU the ops wrappers take the plain version.
The operators have no kernel for real tensors.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import roofline as RL

_LIB = torch.library.Library("repro_torch", "DEF")


def is_fake(*tensors) -> bool:
    """Some tensor of ``tensors`` (None skipped) is fake or on ``meta``."""
    return any(isinstance(t, FakeTensor) or t.is_meta
               for t in tensors if t is not None)


def _none(t: torch.Tensor) -> torch.Tensor:
    """The empty stand-in of an output the call did not ask for."""
    return t.new_empty((0,))


def _define(name: str, schema: str, fake, flops):
    """``repro_torch::name``: ``fake`` gives its outputs' shapes, ``flops``
    its operations from the argument shapes."""
    _LIB.define(name + schema)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    register_flop_formula(getattr(torch.ops.repro_torch, name))(
        lambda *a, out_shape=None, **kw: flops(*a))


# ---- K1, K2, K3, K4 --------------------------------------------------------
_define("systolic_matmul",
        "(Tensor x, Tensor w, Tensor? b, str act, ScalarType? out_dtype)"
        " -> Tensor",
        lambda x, w, b, act, od: x.new_empty((x.shape[0], w.shape[1]),
                                             dtype=od or x.dtype),
        lambda x, w, b, act, od: RL.k1_work(x[0], x[1], w[1],
                                            torch.float32)[1])
_define("fused_affine_act",
        "(Tensor x, Tensor scale, Tensor bias, str act, ScalarType? "
        "out_dtype) -> Tensor",
        lambda x, s, b, act, od: x.new_empty(x.shape, dtype=od or x.dtype),
        lambda x, s, b, act, od: RL.k2_work(x[0], x[1], torch.float32)[1])
_define("quantize_int8", "(Tensor x, Tensor? absmax) -> (Tensor, Tensor)",
        lambda x, absmax: (x.new_empty(x.shape, dtype=torch.int8),
                           x.new_empty((x.shape[0], 1), dtype=torch.float32)),
        lambda x, absmax: RL.k3_work(x[0], x[1], torch.float32,
                                     absmax is not None)[1])
_define("dequantize_int8",
        "(Tensor q, Tensor scales, ScalarType out_dtype) -> Tensor",
        lambda q, s, od: q.new_empty(q.shape, dtype=od),
        lambda q, s, od: RL.k4_work(q[0], q[1])[1])


# ---- K5, K5b ---------------------------------------------------------------
# q_offset places the queries, kv_len (in [0, Skv]) bounds the keys
def _k5_fake(q, k, v, causal, window, return_lse, q_offset, kv_len):
    B, H, Sq, _ = q.shape
    lse = (q.new_empty((B, H, Sq), dtype=torch.float32) if return_lse
           else _none(q))
    return q.new_empty((B, H, Sq, v.shape[-1])), lse


def _k5_ops(work, q, k, v, causal, window, q_offset, kv_len):
    B, H, Sq, D = q
    return work(B, H, k[1], Sq, k[2], D, causal, window, torch.float32,
                v[-1], q_offset, kv_len)[1]


_define("flash_attention",
        "(Tensor q, Tensor k, Tensor v, bool causal, int window, "
        "bool return_lse, int q_offset, int kv_len) -> (Tensor, Tensor)",
        _k5_fake,
        lambda q, k, v, causal, window, lse, q_offset, kv_len: _k5_ops(
            RL.k5_work, q, k, v, causal, window, q_offset, kv_len))
_define("flash_attention_bwd",
        "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor dout, "
        "bool causal, int window, int q_offset, int kv_len) -> "
        "(Tensor, Tensor, Tensor)",
        lambda q, k, v, o, lse, do, causal, window, q_offset, kv_len: (
            q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)),
        lambda q, k, v, o, lse, do, causal, window, q_offset, kv_len:
        _k5_ops(RL.k5b_work, q, k, v, causal, window, q_offset, kv_len))


# ---- K7, K7b ---------------------------------------------------------------
_define("rglru_scan",
        "(Tensor x, Tensor gx, Tensor ga, Tensor log_a, Tensor h0, "
        "bool keep_states) -> (Tensor, Tensor)",
        lambda x, gx, ga, log_a, h0, keep: (
            x.new_empty(x.shape),
            x.new_empty(x.shape, dtype=torch.float32) if keep
            else _none(x)),
        lambda x, gx, ga, log_a, h0, keep: RL.k7_work(*x, torch.float32)[1])
_define("rglru_scan_bwd",
        "(Tensor x, Tensor gx, Tensor ga, Tensor log_a, Tensor h0, "
        "Tensor h32, Tensor dy) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
        lambda x, gx, ga, log_a, h0, h32, dy: (
            x.new_empty(x.shape), x.new_empty(x.shape), x.new_empty(x.shape),
            log_a.new_empty(log_a.shape, dtype=torch.float32),
            h0.new_empty(h0.shape, dtype=torch.float32)),
        lambda x, *rest: RL.k7b_work(*x, torch.float32)[1])


# ---- K8, K8b ---------------------------------------------------------------
def _k8_fake(x, dt, A, Bm, Cm, chunk, h0, keep_states):
    B, S, H, P = x.shape
    N = Bm.shape[3]
    f32 = torch.float32
    states = (x.new_empty((B, H, -(-S // RL.K8_CHUNK), P, N), dtype=f32)
              if keep_states else _none(x))
    return x.new_empty(x.shape), x.new_empty((B, H, P, N), dtype=f32), states


def _k8_ops(work, x, Bm):
    B, S, H, P = x
    return work(B, S, H, P, Bm[2], Bm[3], torch.float32)[1]


_define("ssd_scan",
        "(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, int chunk, "
        "Tensor? h0, bool keep_states) -> (Tensor, Tensor, Tensor)",
        _k8_fake,
        lambda x, dt, A, Bm, *rest: _k8_ops(RL.k8_work, x, Bm))
_define("ssd_scan_bwd",
        "(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, Tensor? h0, "
        "Tensor dy, Tensor? dstate, Tensor states, int chunk) -> (Tensor, "
        "Tensor, Tensor, Tensor, Tensor, Tensor)",
        lambda x, dt, A, Bm, Cm, h0, dy, dstate, states, chunk: (
            x.new_empty(x.shape), dt.new_empty(dt.shape, dtype=torch.float32),
            A.new_empty(A.shape, dtype=torch.float32),
            Bm.new_empty(Bm.shape), Cm.new_empty(Cm.shape),
            x.new_empty((x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]),
                        dtype=torch.float32)),
        lambda x, dt, A, Bm, *rest: _k8_ops(RL.k8b_work, x, Bm))
