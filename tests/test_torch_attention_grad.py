"""The gradient of the port's flash attention (K5b's plain version,
``FlashAttention``) against the JAX package, on the CPU.

The JAX package has no kernel for this gradient: it differentiates
``repro.models.layers.blocked_attention`` by autodiff.  So the same numpy
inputs and output cotangent go through ``jax.vjp`` of that function (which
takes (B, S, H, D); the port's kernels take (B, H, S, D)) and through
``flash_attention_bwd_plain``, fed the plain forward's output and
log-sum-exp, as K5b is fed K5's.  Both sides are fp32 on one CPU and differ
only in the order of fp32 sums, hence rtol 1e-4, atol 1e-5.  Shapes are
``tests/test_kernels.py``'s attention shapes plus a GQA 2:1 one with
Sq != Skv, causal or not, with and without a window that bites, at square
head dims and at the (Dqk, Dv) pairs of ``HEAD_DIM_PAIRS``; then rows
that see no key (Sq past Skv + window - 1), whose queries get no gradient
and whose dO reaches every value row at 1 / Skv.  ``ops.attention`` goes
through ``FlashAttention`` whenever autograd needs it; on the CPU its two
directions are the plain versions, so its gradients are autograd's through
``flash_attention_plain``.  The CUDA kernel K5b is held to
``flash_attention_bwd_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here only its argument checks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

RTOL, ATOL = 1e-4, 1e-5
# tests/test_kernels.py::test_flash_attention's shapes (B, H, KV, Sq, Skv, D):
# GQA 4:1 twice (Sq < Skv once), MHA with Sq > Skv; and GQA 2:1
SHAPES = [(2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 128, 32),
          (2, 4, 4, 128, 64, 64), (1, 4, 2, 96, 80, 32)]
MASKS = [(True, 0), (False, 0), (True, 48), (False, 20)]
# (Dqk, Dv) pairs K5b takes beside the square dims: the reduced MLA's, MLA's
# (minicpm3-4b) and ViT-632M's; shapes (B, H, KV, Sq, Skv), GQA 2:1 with
# Sq != Skv and a ragged last tile
PAIR_SHAPES = [(1, 4, 2, 96, 80), (2, 2, 2, 70, 70)]
PAIRS = [(32, 16), (96, 64), (80, 80)]


def _inputs(b, h, kv, sq, skv, d, seed=0, dv=None):
    dv = dv or d
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, kv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, kv, skv, dv), dtype=np.float32)
    do = rng.standard_normal((b, h, sq, dv), dtype=np.float32)
    return q, k, v, do


def _bshd(a):      # (B, H, S, D) <-> (B, S, H, D)
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2))


def _jax_vjp(q, k, v, do, causal, window):
    """(o, dq, dk, dv) of blocked_attention, in the port's layout."""
    def f(q, k, v):
        return JL.blocked_attention(q, k, v, causal=causal, window=window)
    out, vjp = jax.vjp(f, *(jnp.asarray(_bshd(t)) for t in (q, k, v)))
    grads = vjp(jnp.asarray(_bshd(do)))
    return tuple(_bshd(t) for t in (out, *grads))


def _port(q, k, v, do, causal, window):
    """(o, lse, dq, dk, dv) of the plain forward and K5b's plain version."""
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    grads = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                      window=window)
    return (o, lse, *grads)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("b,h,kv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_bwd_plain_matches_jax_vjp(b, h, kv, sq, skv, d, causal,
                                             window):
    q, k, v, do = _inputs(b, h, kv, sq, skv, d)
    want = _jax_vjp(q, k, v, do, causal, window)
    o, lse, *got = _port(q, k, v, do, causal, window)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _close(o, want[0], msg="o")
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want[1:]):
        assert gg.dtype == torch.float32 and gg.shape == ww.shape
        _close(gg, ww, msg=name)


@pytest.mark.parametrize("b,h,kv,sq,skv", PAIR_SHAPES)
@pytest.mark.parametrize("d,dv", PAIRS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_bwd_plain_matches_jax_vjp_at_head_dim_pairs(
        b, h, kv, sq, skv, d, dv, causal, window):
    """A value head dim of its own (dO, O and dV of Dv columns; S, dQ and
    dK over Dqk, scaled by 1 / sqrt(Dqk)), causal or not, windowed."""
    q, k, v, do = _inputs(b, h, kv, sq, skv, d, seed=4, dv=dv)
    want = _jax_vjp(q, k, v, do, causal, window)
    o, lse, *got = _port(q, k, v, do, causal, window)
    assert o.shape == (b, h, sq, dv)
    _close(o, want[0], msg="o")
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want[1:]):
        assert gg.dtype == torch.float32 and gg.shape == ww.shape
        _close(gg, ww, msg=name)


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window", [
    (1, 2, 2, 128, 32, 32, False, 16), (1, 4, 1, 96, 40, 32, True, 24)])
def test_wholly_masked_rows_match_jax_vjp(b, h, kv, sq, skv, d, causal,
                                          window):
    """Rows at or past Skv + window - 1 see no key: both packages give them
    the mean of V, so their dO reaches every value row at 1 / Skv, and no
    gradient reaches their queries (their scores are the mask value)."""
    q, k, v, do = _inputs(b, h, kv, sq, skv, d, seed=1)
    want = _jax_vjp(q, k, v, do, causal, window)
    o, lse, dq, dk, dv = _port(q, k, v, do, causal, window)
    dead = slice(skv + window - 1, None)
    assert bool((lse[:, :, dead] == -1e30).all())
    assert bool((lse[:, :, :skv + window - 1] > -1e29).all())
    assert not dq[:, :, dead].any()
    for name, gg, ww in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        assert torch.isfinite(gg).all(), name
        _close(gg, ww, msg=name)


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window", [
    (2, 8, 2, 128, 128, 64, True, 0), (1, 4, 2, 96, 80, 32, False, 20),
    (1, 2, 2, 128, 32, 32, False, 16)])
def test_flash_attention_function_is_autograd_through_plain(
        b, h, kv, sq, skv, d, causal, window):
    """On the CPU, ``ops.attention`` under grad is ``FlashAttention`` over
    the plain versions: its gradients are those of autograd through
    ``flash_attention_plain``."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(b, h, kv, sq, skv, d, seed=2))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*ins, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want_o = flash_attention_plain(*ref, causal=causal, window=window)
    want = torch.autograd.grad(want_o, ref, do)
    torch.testing.assert_close(out, want_o, rtol=0, atol=0)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=RTOL, atol=ATOL)
    direct = torch.autograd.grad(
        FlashAttention.apply(*ins, causal, window), ins, do)
    for gg, ww in zip(direct, got):
        assert torch.equal(gg, ww)


def test_attention_without_grad_keeps_no_graph():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 16, 16, 16))
    out = ops.attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        assert ops.attention(q.requires_grad_(), k, v).grad_fn is None


def test_bf16_inputs_give_bf16_gradients():
    """bf16 q, k, v: the gradients come back in bf16, within K5's bf16 bar
    of the fp32 gradients of the same (bf16-rounded) inputs."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(1, 4, 2, 64, 64, 32, seed=3))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.attention(*ins, causal=True, window=24),
                              ins, do)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.attention(*ref, causal=True, window=24),
                               ref, do.float())
    for gg, ww in zip(got, want):
        assert gg.dtype == torch.bfloat16
        torch.testing.assert_close(gg.float(), ww, rtol=0.05, atol=0.03)


def test_flash_attention_bwd_refuses_cpu_tensors_and_bad_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 16, 16, 32))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :1], do)
    with pytest.raises(ValueError, match="do "):
        flash_attention_bwd(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="o "):
        flash_attention_bwd(q, k, v, o[:, :, :8], lse, do)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, k[:, :, :8], v, o, lse, do)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(*(t[..., :24] for t in (q, k, v, o)), lse,
                            do[..., :24])
    assert flash_attention_bwd.launches == before
