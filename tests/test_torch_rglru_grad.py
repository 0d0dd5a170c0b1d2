"""The gradient of the port's RG-LRU scan (K7b's plain version,
``RGLRUScan``) against the JAX package, on the CPU.

The JAX package has no kernel for this gradient: it differentiates
``repro.models.layers.rglru`` by autodiff.  So the same numpy inputs and
cotangents, on both of its outputs (the sequence ``h_seq`` and the last
state ``h_last``), go through ``jax.vjp`` of that function and through
``rglru_scan_bwd_plain`` (``h_last``'s cotangent added to the last step's,
as the port takes ``h_last`` from the sequence), fed the plain forward's
fp32 states as K7b is fed K7's.  Both sides are fp32 on one CPU and differ
only in the order of fp32 operations (two scans of different shape), hence
rtol 1e-4, atol 1e-5 (``dlog_a``, a sum over B x S terms, at rtol 1e-4 of
its size).  Cases: S from 1 to 256, with and without h0, and one where
softplus(log_a) ~ 1e-13, so that 1 - exp(2 log_a_t) rounds to 0 and the
clip at 1e-12 holds and passes no gradient, as ``jnp.clip`` does.
``ops.rglru`` goes through ``RGLRUScan`` whenever autograd needs it; on the
CPU its gradients are autograd's through ``rglru_scan_plain``.  The CUDA
kernel K7b is held to ``rglru_scan_bwd_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here only its argument
checks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.rglru import (RGLRUScan, rglru_scan,
                                       rglru_scan_bwd, rglru_scan_bwd_plain,
                                       rglru_scan_plain)
from repro_torch.models import layers as L

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(2, 1, 16), (2, 7, 24), (1, 64, 32), (3, 77, 40), (2, 256, 16)]
NAMES = ("dx", "dgx", "dga", "dlog_a", "dh0")


def _inputs(b, s, w, seed=0, log_a_shift=0.0):
    """tests/test_kernels.py::test_rglru_kernel's distributions, h0 and the
    two cotangents, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32) * 0.2
    gx = rng.standard_normal((b, s, w), dtype=np.float32)
    ga = rng.standard_normal((b, s, w), dtype=np.float32)
    la = rng.standard_normal(w, dtype=np.float32) + np.float32(log_a_shift)
    h0 = rng.standard_normal((b, w), dtype=np.float32) * 0.1
    dseq = rng.standard_normal((b, s, w), dtype=np.float32)
    dlast = rng.standard_normal((b, w), dtype=np.float32)
    return (x, gx, ga, la, h0), dseq, dlast


def _jax_vjp(args, dseq, dlast, with_h0):
    """(h_seq, dx, dgx, dga, dlog_a[, dh0]) of layers.rglru, jitted (one
    compile, where eager dispatch compiles each primitive of the scan)."""
    def run(cot, *a):
        out, vjp = jax.vjp(lambda *b: JL.rglru(*b), *a)
        return (out[0], *vjp(cot))

    a = args if with_h0 else args[:4]
    cot = (jnp.asarray(dseq), jnp.asarray(dlast))
    return jax.jit(run)(cot, *map(jnp.asarray, a))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _check(args, dseq, dlast, with_h0):
    want = _jax_vjp(args, dseq, dlast, with_h0)
    x, gx, ga, la, h0 = map(torch.from_numpy, args)
    if not with_h0:
        h0 = torch.zeros_like(h0)
    y, h32 = rglru_scan_plain(x, gx, ga, la, h0, keep_states=True)
    assert h32.dtype == torch.float32 and torch.equal(y, h32)
    _close(y, want[0], msg="h_seq")
    dy = torch.from_numpy(dseq).clone()
    dy[:, -1] += torch.from_numpy(dlast)
    got = rglru_scan_bwd_plain(x, gx, ga, la, h0, h32, dy)
    for name, gg, ww in zip(NAMES, got, want[1:]):
        assert gg.dtype == torch.float32 and gg.shape == ww.shape, name
        atol = ATOL * max(1.0, float(np.abs(ww).max())) \
            if name == "dlog_a" else ATOL
        _close(gg, ww, atol=atol, msg=name)
    return got


@pytest.mark.parametrize("b,s,w", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_plain_matches_jax_vjp(b, s, w, with_h0):
    args, dseq, dlast = _inputs(b, s, w)
    _check(args, dseq, dlast, with_h0)


def test_rglru_bwd_plain_where_the_clip_holds():
    """softplus(log_a - 30) ~ 1e-13: the clip holds on every step, and its
    derivative is 0 there in both packages; dlog_a then comes only through
    a_t."""
    args, dseq, dlast = _inputs(2, 64, 24, seed=4, log_a_shift=-30.0)
    la = torch.from_numpy(args[3])
    u = 1.0 - torch.exp(2.0 * -8.0 * torch.nn.functional.softplus(la))
    assert bool((u < 1e-12).all())
    _check(args, dseq, dlast, with_h0=True)


@pytest.mark.parametrize("b,s,w", [(2, 7, 24), (3, 77, 40)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_layers_rglru_under_grad_matches_jax_vjp(b, s, w, with_h0):
    """The port's ``layers.rglru`` (through ``ops.rglru``, ``RGLRUScan``)
    under autograd, both outputs' cotangents, against ``jax.vjp``."""
    args, dseq, dlast = _inputs(b, s, w, seed=5)
    want = _jax_vjp(args, dseq, dlast, with_h0)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    seq, last = L.rglru(*ins[:4], ins[4] if with_h0 else None)
    assert type(seq.grad_fn).__name__ == "RGLRUScanBackward"
    leaves = ins if with_h0 else ins[:4]
    got = torch.autograd.grad((seq, last), leaves,
                              (torch.from_numpy(dseq),
                               torch.from_numpy(dlast)))
    for name, gg, ww in zip(NAMES, got, want[1:]):
        atol = ATOL * max(1.0, float(np.abs(ww).max())) \
            if name == "dlog_a" else ATOL
        _close(gg, ww, atol=atol, msg=name)


@pytest.mark.parametrize("b,s,w", [(2, 1, 16), (3, 77, 40)])
def test_rglru_function_is_autograd_through_plain(b, s, w):
    """On the CPU, ``ops.rglru`` under grad is ``RGLRUScan`` over the plain
    versions: its gradients are those of autograd through
    ``rglru_scan_plain``."""
    args, dseq, _ = _inputs(b, s, w, seed=6)
    dy = torch.from_numpy(dseq)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ops.rglru(*ins)
    assert type(out.grad_fn).__name__ == "RGLRUScanBackward"
    got = torch.autograd.grad(out, ins, dy)
    ref = [torch.from_numpy(a).requires_grad_() for a in args]
    want_y = rglru_scan_plain(*ref)
    want = torch.autograd.grad(want_y, ref, dy)
    assert torch.equal(out, want_y)
    for name, gg, ww in zip(NAMES, got, want):
        torch.testing.assert_close(gg, ww, rtol=RTOL, atol=ATOL, msg=name)
    direct = torch.autograd.grad(RGLRUScan.apply(*ins), ins, dy)
    for gg, ww in zip(direct, got):
        assert torch.equal(gg, ww)


def test_bf16_inputs_give_bf16_gradients():
    """bf16 x, gx, ga (log_a and h0 fp32, as ``layers.rglru`` hands them
    over): dx, dgx and dga come back in bf16 within a bf16 rounding of the
    fp32 gradients of the same inputs; dlog_a and dh0 stay fp32."""
    args, dseq, _ = _inputs(2, 33, 24, seed=7)
    x, gx, ga = (torch.from_numpy(a).bfloat16() for a in args[:3])
    la, h0 = (torch.from_numpy(a) for a in args[3:])
    dy = torch.from_numpy(dseq).bfloat16()
    ins = [t.clone().requires_grad_() for t in (x, gx, ga, la, h0)]
    got = torch.autograd.grad(ops.rglru(*ins), ins, dy)
    ref = [t.float().requires_grad_() for t in (x, gx, ga, la, h0)]
    want = torch.autograd.grad(ops.rglru(*ref), ref, dy.float())
    for name, gg, ww in zip(NAMES, got, want):
        assert gg.dtype == (torch.float32 if name in ("dlog_a", "dh0")
                            else torch.bfloat16), name
        torch.testing.assert_close(gg.float(), ww, rtol=1e-2, atol=1e-2,
                                   msg=name)


def test_rglru_scan_bwd_refuses_cpu_tensors_and_bad_shapes():
    args, dseq, _ = _inputs(2, 16, 8)
    x, gx, ga, la, h0 = map(torch.from_numpy, args)
    _, h32 = rglru_scan_plain(x, gx, ga, la, h0, keep_states=True)
    dy = torch.from_numpy(dseq)
    before = rglru_scan_bwd.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32, dy)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        rglru_scan(x, gx, ga, la, h0, keep_states=True)
    with pytest.raises(ValueError, match="h32"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32[:, :8], dy)
    with pytest.raises(ValueError, match="dy"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32, dy.bfloat16())
    with pytest.raises(ValueError, match="do not match"):
        rglru_scan_bwd(x, gx[:, :8], ga, la, h0, h32, dy)
    with pytest.raises(TypeError, match="log_a must be float32"):
        rglru_scan_bwd(x, gx, ga, la.bfloat16(), h0, h32, dy)
    assert rglru_scan_bwd.launches == before
