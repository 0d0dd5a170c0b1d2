"""The port's SSD scan (K8's plain version) and Mamba-2 layers against the
JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.ops.ssd`` (the Pallas
kernel in interpret mode), ``repro.models.layers.ssd_chunked`` (the
associative-scan oracle) and the port's ``ops.ssd`` on CPU tensors, which
is ``ssd_scan_plain``: chunked, with the state carried across chunks.  Both
sides are fp32 on one CPU, so the tolerances are tighter than
``tests/test_kernels.py::test_ssd_kernel``'s 1e-3.  The CUDA kernel itself
is held to ``ssd_scan_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here only its argument checks run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import layers as L

# fp32 on both sides: the two chunk algorithms differ only in the order of
# their fp32 sums (sequential carry against an associative scan)
RTOL, ATOL = 1e-5, 1e-5
# tests/test_kernels.py::test_ssd_kernel's three shapes
SHAPES = [(2, 128, 4, 32, 2, 16, 32), (1, 256, 2, 16, 1, 8, 64),
          (2, 64, 4, 16, 4, 16, 64)]


def _inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.4
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.4).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    return x, dt, A, Bm, Cm


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ssd_matches_jax_kernel_and_oracle(b, s, h, p, g, n, chunk):
    args = _inputs(b, s, h, p, g, n)
    y, hf = ops.ssd(*_port(*args), chunk=chunk)
    yk, hk = jops.ssd(*map(jnp.asarray, args), chunk=chunk)
    yr, hr = JL.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    _close(y, yk)
    _close(hf, hk)
    _close(y, yr)
    _close(hf, hr)
    yref, href = ref.ssd_ref(*_port(*args), chunk=chunk)
    assert torch.equal(yref, y) and torch.equal(href, hf)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ssd_with_h0_matches_jax(b, s, h, p, g, n, chunk):
    args = _inputs(b, s, h, p, g, n, seed=1)
    h0 = np.random.default_rng(2).standard_normal((b, h, p, n),
                                                  dtype=np.float32)
    y, hf = ops.ssd(*_port(*args), chunk=chunk, h0=torch.from_numpy(h0))
    yr, hr = JL.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                            h0=jnp.asarray(h0))
    _close(y, yr)
    _close(hf, hr)


@pytest.mark.parametrize("s,chunk", [(16, 32), (48, 256), (1, 8)])
def test_ssd_sequence_shorter_than_chunk(s, chunk):
    args = _inputs(2, s, 4, 16, 2, 8, seed=s)
    y, hf = ops.ssd(*_port(*args), chunk=chunk)
    yk, hk = jops.ssd(*map(jnp.asarray, args), chunk=chunk)
    yr, hr = JL.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    for got, want in ((y, yk), (hf, hk), (y, yr), (hf, hr)):
        _close(got, want)


def test_ssd_keeps_bf16_input_dtype():
    """y comes back in x's dtype and the state in fp32, as in JAX."""
    x, dt, A, Bm, Cm = _port(*_inputs(1, 64, 2, 16, 1, 8))
    y, hf = ops.ssd(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                    chunk=32)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    y32, h32 = ops.ssd(x.bfloat16().float(), dt, A, Bm.bfloat16().float(),
                       Cm.bfloat16().float(), chunk=32)
    assert torch.equal(y, y32.bfloat16()) and torch.equal(hf, h32)


def test_ssd_rejects_a_ragged_chunk():
    args = _port(*_inputs(1, 96, 2, 16, 1, 8))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd(*args, chunk=64)


def test_ssd_scan_refuses_cpu_tensors_and_bad_arguments():
    x, dt, A, Bm, Cm = _port(*_inputs(1, 64, 4, 16, 2, 8))
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(TypeError, match="differ in dtype"):
        ssd_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="dt must be float32"):
        ssd_scan(x, dt.double(), A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, dt, A[:3], Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=32, h0=torch.zeros(1, 4, 16, 9))
    wide = torch.zeros(1, 64, 2, 129)
    with pytest.raises(ValueError, match="state width 129"):
        ssd_scan(x, dt, A, wide, wide, chunk=32)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32) * 0.1
    st = (rng.standard_normal((2, 3, 24), dtype=np.float32)
          if with_state else None)
    y, new = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             None if st is None else torch.from_numpy(st))
    yj, newj = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    _close(y, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(new.numpy(), np.asarray(newj))


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_matches_jax(g):
    rng = np.random.default_rng(4)
    b, h, p, n = 3, 4, 8, 16
    xt = rng.standard_normal((b, h, p), dtype=np.float32)
    dtt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bt = rng.standard_normal((b, g, n), dtype=np.float32)
    Ct = rng.standard_normal((b, g, n), dtype=np.float32)
    hp = rng.standard_normal((b, h, p, n), dtype=np.float32)
    y, hn = L.ssd_step(*_port(xt, dtt, A, Bt, Ct, hp))
    yj, hj = JL.ssd_step(*map(jnp.asarray, (xt, dtt, A, Bt, Ct, hp)))
    _close(y, yj, rtol=1e-6, atol=1e-6)
    _close(hn, hj, rtol=1e-6, atol=1e-6)


def test_ssd_step_continues_ssd_chunked():
    """One decode step from the chunked scan's final state equals the scan
    over one more token (the identity decode == forward rests on)."""
    x, dt, A, Bm, Cm = _port(*_inputs(2, 33, 4, 8, 2, 16, seed=5))
    y_all, h_all = L.ssd_chunked(x, dt, A, Bm, Cm, chunk=33)
    _, h32 = L.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32],
                           chunk=16)
    y_t, h_t = L.ssd_step(x[:, 32], dt[:, 32], A, Bm[:, 32], Cm[:, 32], h32)
    torch.testing.assert_close(y_t, y_all[:, 32], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(h_t, h_all, rtol=RTOL, atol=ATOL)
