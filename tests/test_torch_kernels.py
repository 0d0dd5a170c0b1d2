"""The port's kernel wrappers (K1 systolic matmul, K2 fused affine, K5 flash
attention) against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in interpret
mode, as it runs off-TPU) and ``repro_torch.kernels.ops`` (on a CPU tensor:
the kernel's plain PyTorch version).  Tolerances are those of
tests/test_kernels.py.  The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.systolic_matmul import (_ACTS, systolic_matmul,
                                                 tile_plan)
from repro_torch.kernels.vector_engine import fused_affine_act
from test_torch_cuda import (REQUEST_SHAPES, rel_frobenius, tf32_product,
                             tf32_split)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str = "float32"):
    """One numpy array as a JAX array and a CPU tensor of the same dtype."""
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got: torch.Tensor, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-4


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (64, 128, 256), (8, 16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
def test_matmul_matches_jax(m, k, n, dtype, act):
    rng = np.random.default_rng(7)
    (jx, tx), (jw, tw), (jb, tb) = (
        _both(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((m, k), (k, n), (n,)))
    want = jops.matmul(jx, jw, jb, act=act, bm=min(64, m), bn=min(64, n),
                       bk=min(64, k))
    got = ops.matmul(tx, tw, tb, act=act, bm=min(64, m), bn=min(64, n),
                     bk=min(64, k))
    assert got.dtype == _DTYPES[dtype][1] and got.shape == (m, n)
    _close(got, want, rtol=0.05 if dtype == "bfloat16" else 1e-4,
           atol=_tol(dtype) * max(1, k // 64))


@pytest.mark.parametrize("act", ["silu", "tanh", "sigmoid"])
def test_matmul_epilogue_acts_match_jax(act):
    rng = np.random.default_rng(8)
    (jx, tx), (jw, tw), (jb, tb) = (
        _both(rng.standard_normal(s, dtype=np.float32))
        for s in ((64, 128), (128, 64), (64,)))
    _close(ops.matmul(tx, tw, tb, act=act),
           jops.matmul(jx, jw, jb, act=act, bm=64, bn=64, bk=64),
           rtol=1e-4, atol=4e-4)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_matmul_padded_arbitrary_shapes_match_jax(out):
    rng = np.random.default_rng(9)
    (jx, tx), (jw, tw) = (_both(rng.standard_normal(s, dtype=np.float32))
                          for s in ((37, 147), (147, 53)))
    jd, td = _DTYPES[out]
    want = jops.matmul_padded(jx, jw, out_dtype=jd)
    got = ops.matmul_padded(tx, tw, out_dtype=td)
    assert got.shape == tuple(want.shape) and got.dtype == td
    _close(got, want, rtol=1e-2 if out == "bfloat16" else 1e-4, atol=1e-3)


@pytest.mark.parametrize("b,h,kv,sq,skv,d", [
    (2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 128, 32), (2, 4, 4, 128, 64, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_attention_matches_jax(b, h, kv, sq, skv, d, causal, window):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s, dtype=np.float32))
        for s in ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))
    want = jops.attention(jq, jk, jv, causal=causal, window=window, bq=32,
                          bk=32)
    got = ops.attention(tq, tk, tv, causal=causal, window=window, bq=32,
                        bk=32)
    _close(got, want, rtol=1e-3, atol=2e-4)


def test_attention_fully_masked_rows_match_jax():
    """Non-causal with a window and Sq > Skv + window: the rows past
    Skv + window - 1 see no key.  Both packages give such a row the mean of
    V over all Skv keys (every score the finite NEG_INF), not 0."""
    rng = np.random.default_rng(10)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s, dtype=np.float32))
        for s in ((1, 2, 128, 32), (1, 2, 32, 32), (1, 2, 32, 32)))
    want = jops.attention(jq, jk, jv, causal=False, window=16, bq=32, bk=32)
    got = ops.attention(tq, tk, tv, causal=False, window=16, bq=32, bk=32)
    _close(got, want, rtol=1e-3, atol=2e-4)
    masked = got[:, :, 32 + 16 - 1:]
    _close(masked, np.broadcast_to(np.asarray(jv).mean(axis=2, keepdims=True),
                                   masked.shape), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dtype_matches_jax(dtype):
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal((1, 2, 64, 32), dtype=np.float32), dtype)
        for _ in range(3))
    got = ops.attention(tq, tk, tv, bq=32, bk=32)
    assert got.dtype == _DTYPES[dtype][1]
    _close(got, jops.attention(jq, jk, jv, bq=32, bk=32), rtol=0.05,
           atol=0.03)


@pytest.mark.parametrize("m,n", [(256, 256), (64, 384), (8, 128),
                                 (1, 32 * 32 * 3)])
@pytest.mark.parametrize("act", list(_ACTS))
def test_affine_act_matches_jax(m, n, act):
    rng = np.random.default_rng(5)
    (jx, tx), (js, ts), (jb, tb) = (
        _both(rng.standard_normal(s, dtype=np.float32))
        for s in ((m, n), (n,), (n,)))
    _close(ops.affine_act(tx, ts, tb, act=act),
           jops.affine_act(jx, js, jb, act=act), rtol=1e-5, atol=1e-5)


def test_refs_match_jax_refs():
    rng = np.random.default_rng(6)
    (jx, tx), (jw, tw), (jb, tb) = (
        _both(rng.standard_normal(s, dtype=np.float32))
        for s in ((16, 24), (24, 8), (8,)))
    _close(ref.matmul_ref(tx, tw, tb, act="gelu"),
           jref.matmul_ref(jx, jw, jb, act="gelu"), rtol=1e-5, atol=1e-5)
    _close(ref.affine_act_ref(tx, tb[:1].expand(24), tw[:, 0],
                              act="sigmoid"),
           jref.affine_act_ref(jx, jnp.broadcast_to(jb[:1], (24,)), jw[:, 0],
                               act="sigmoid"), rtol=1e-6, atol=1e-6)
    (jq, tq), (jk, tk) = (_both(rng.standard_normal(s, dtype=np.float32))
                          for s in ((1, 4, 9, 16), (1, 2, 9, 16)))
    _close(ref.attention_ref(tq, tk, tk, causal=True, window=3),
           jref.attention_ref(jq, jk, jk, causal=True, window=3),
           rtol=1e-5, atol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA launchers never fall back: a CPU tensor is an error, raised
    before any build, and the launch counters stay put."""
    x = torch.ones((4, 4))
    counts = (systolic_matmul.launches, fused_affine_act.launches,
              flash_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        systolic_matmul(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_affine_act(x, x[0], x[0])
    q = torch.ones((1, 1, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    ops.matmul(x, x)
    assert (systolic_matmul.launches, fused_affine_act.launches,
            flash_attention.launches) == counts


def test_cuda_wrappers_validate_shapes():
    with pytest.raises(ValueError, match="do not chain"):
        systolic_matmul(torch.ones((4, 3)), torch.ones((4, 3)))
    with pytest.raises(ValueError, match="activation"):
        systolic_matmul(torch.ones((4, 3)), torch.ones((3, 3)), act="elu")
    q = torch.ones((1, 3, 4, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.ones((1, 1, 4, 24)),) * 3)


@pytest.mark.parametrize("m,k,n", REQUEST_SHAPES)
def test_tile_plan_fills_the_card(m, k, n):
    """K1's picker on 132 SMs: a cluster of at most 8 k-slices, at least 128
    of K a slice where K is split, and at least half a wave of blocks where
    the shape allows one."""
    bm, bn, s = tile_plan(m, k, n, sms=132)
    assert bm in (64, 128) and bn in (32, 64, 128) and 1 <= s <= 8
    if s > 1:
        assert -(-k // s) >= 128
    most = max(-(-m // tm) * -(-n // tn) for tm in (64, 128)
               for tn in (32, 64, 128)) * max(1, min(8, k // 128))
    if most >= 66:
        assert -(-m // bm) * -(-n // bn) * s >= 66


def test_3xtf32_emulation_is_fp32_accurate():
    """K1's arithmetic in plain PyTorch at (196, 2304, 256), N(0, 1): three
    TF32 products (low 13 mantissa bits cleared) are within 1e-5 of fp64,
    one is not within 1e-4; the split loses nothing of a finite value
    beyond lo's own truncation."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((196, 2304), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((2304, 256), dtype=np.float32))
    exact = x.double() @ w.double()
    assert rel_frobenius(tf32_product(x, w, 3), exact) < 1e-5
    assert rel_frobenius(tf32_product(x, w, 1), exact) > 1e-4
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 8191).any()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= x.double().abs() * 2.0 ** -21).all()
