"""The port's RG-LRU scan (K7's plain version) and RecurrentGemma layers
against the JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.ops.rglru`` (the Pallas
kernel in interpret mode), ``repro.kernels.ref.rglru_ref`` and
``repro.models.layers.rglru`` (the associative-scan oracle), and through the
port's ``ops.rglru`` on CPU tensors, which is ``rglru_scan_plain``: a
doubling scan with the same combine.  Both sides are fp32 on one CPU and
differ only in the order of their fp32 products, so the tolerance is
``tests/test_kernels.py::test_rglru_kernel``'s 1e-4.  RoPE, the attention
blocks and the decode steps are held to the JAX package the same way.  The
CUDA kernel itself is held to ``rglru_scan_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here only its argument
checks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode as JDE
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models import decode as DE
from repro_torch.models import layers as L

RTOL, ATOL = 1e-4, 1e-4         # tests/test_kernels.py::test_rglru_kernel
# tests/test_kernels.py::test_rglru_kernel's shapes (B, S, W)
SHAPES = [(2, 64, 128), (4, 128, 256), (1, 32, 128)]


def _inputs(b, s, w, seed=0):
    """test_rglru_kernel's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32) * 0.2
    gx = rng.standard_normal((b, s, w), dtype=np.float32)
    ga = rng.standard_normal((b, s, w), dtype=np.float32)
    la = rng.standard_normal(w, dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32) * 0.1
    return x, gx, ga, la, h0


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ---- K7's plain version -----------------------------------------------------

@pytest.mark.parametrize("b,s,w", SHAPES)
def test_rglru_matches_jax_kernel_and_oracle(b, s, w):
    args = _inputs(b, s, w)
    got = ops.rglru(*_port(*args))
    kernel = jops.rglru(*map(jnp.asarray, args), interpret=True)
    oracle = jref.rglru_ref(*map(jnp.asarray, args))
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    _close(got, kernel)
    _close(got, oracle)
    assert torch.equal(ref.rglru_ref(*_port(*args)), got)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(2, 64, 128), (3, 77, 200), (1, 1, 5)])
def test_rglru_layer_matches_jax(b, s, w, with_h0):
    """layers.rglru with and without h0, at ragged S, W and B: no tile has
    to divide them."""
    x, gx, ga, la, h0 = _inputs(b, s, w, seed=s)
    h0 = h0 if with_h0 else None
    seq, last = L.rglru(*_port(x, gx, ga, la),
                        None if h0 is None else torch.from_numpy(h0))
    jseq, jlast = JL.rglru(*map(jnp.asarray, (x, gx, ga, la)),
                           None if h0 is None else jnp.asarray(h0))
    assert seq.shape == (b, s, w) and last.shape == (b, w)
    _close(seq, jseq)
    _close(last, jlast)


def test_rglru_keeps_bf16_and_carries_fp32_state():
    """The sequence comes back in x's dtype; the state inside is fp32, so
    a bf16 scan is the fp32 scan of the same inputs rounded once."""
    x, gx, ga, la, h0 = _port(*_inputs(2, 40, 24))
    xb, gxb, gab = x.bfloat16(), gx.bfloat16(), ga.bfloat16()
    got = ops.rglru(xb, gxb, gab, la, h0)
    assert got.dtype == torch.bfloat16
    want = ops.rglru(xb.float(), gxb.float(), gab.float(), la, h0)
    assert torch.equal(got, want.bfloat16())
    seq, last = L.rglru(xb, gxb, gab, la)
    jseq, jlast = JL.rglru(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                             for t in (xb, gxb, gab)), jnp.asarray(la.numpy()))
    assert seq.dtype == last.dtype == torch.bfloat16
    assert jseq.dtype == jlast.dtype == jnp.bfloat16
    _close(seq, jseq, rtol=1e-2, atol=1e-2)
    assert torch.equal(last, seq[:, -1])


def test_rglru_scan_refuses_cpu_tensors_and_bad_arguments():
    x, gx, ga, la, h0 = _port(*_inputs(2, 16, 8))
    before = rglru_scan.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        rglru_scan(x, gx, ga, la, h0)
    with pytest.raises(ValueError, match="do not match"):
        rglru_scan(x, gx, ga, la[:7], h0)
    with pytest.raises(ValueError, match="do not match"):
        rglru_scan(x, gx, ga, la, h0[:1])
    with pytest.raises(ValueError, match="want \\(B, S, W\\)"):
        rglru_scan(x[0], gx[0], ga[0], la, h0)
    with pytest.raises(TypeError, match="differ in dtype"):
        rglru_scan(x.bfloat16(), gx, ga, la, h0)
    with pytest.raises(TypeError, match="log_a must be float32"):
        rglru_scan(x, gx, ga, la.bfloat16(), h0)
    with pytest.raises(TypeError, match="h0 must be float32"):
        rglru_scan(x, gx, ga, la, h0.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan(x.half(), gx.half(), ga.half(), la, h0)
    assert rglru_scan.launches == before


def test_rglru_step_matches_jax():
    x, gx, ga, la, h0 = _inputs(3, 1, 40, seed=4)
    for dt in (np.float32, jnp.bfloat16):
        args = [a[:, 0].astype(dt) for a in (x, gx, ga)]
        got = L.rglru_step(*(torch.from_numpy(np.asarray(a, np.float32))
                             .to(torch.float32 if dt is np.float32
                                 else torch.bfloat16) for a in args),
                           torch.from_numpy(la), torch.from_numpy(h0))
        want = JL.rglru_step(*map(jnp.asarray, args), jnp.asarray(la),
                             jnp.asarray(h0))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        _close(got, want, rtol=1e-6 if dt is np.float32 else 1e-2,
               atol=1e-6 if dt is np.float32 else 1e-2)


def test_rglru_step_continues_rglru():
    """One decode step from the scan's last state equals the scan over one
    more token (the identity decode == forward rests on)."""
    x, gx, ga, la, h0 = _port(*_inputs(2, 33, 16, seed=5))
    seq, _ = L.rglru(x, gx, ga, la, h0)
    _, last = L.rglru(x[:, :32], gx[:, :32], ga[:, :32], la, h0)
    step = L.rglru_step(x[:, 32], gx[:, 32], ga[:, 32], la, last)
    torch.testing.assert_close(step, seq[:, 32], rtol=1e-5, atol=1e-6)


# ---- RoPE and attention -----------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(6)
    pos = np.broadcast_to(np.arange(70, dtype=np.int32) * 37, (2, 70))
    cos, sin = L.rope_angles(torch.from_numpy(pos.copy()), 32, theta)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 32, theta)
    _close(cos, jcos, rtol=1e-5, atol=1e-5)
    _close(sin, jsin, rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 70, 3, 32), dtype=np.float32)
    got = L.apply_rope(torch.from_numpy(x), cos, sin)
    want = JL.apply_rope(jnp.asarray(x), jcos, jsin)
    _close(got, want, rtol=1e-5, atol=1e-5)


def _qkv(b, sq, skv, h, kv, d, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kv, d), dtype=np.float32),
            rng.standard_normal((b, skv, kv, d), dtype=np.float32))


@pytest.mark.parametrize("s,chunk,window", [(96, 32, 40), (96, 32, 0),
                                            (50, 32, 16), (64, 16, 8)])
def test_blocked_attention_matches_jax(s, chunk, window):
    """Windows smaller than S; S a multiple of the chunk takes the JAX
    package's unrolled chunk loop, with its windowed K/V slices."""
    q, k, v = _qkv(2, s, s, 4, 1, 16)
    got = L.blocked_attention(*_port(q, k, v), causal=True, window=window,
                              chunk=chunk)
    want = JL.blocked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                window=window, chunk=chunk)
    assert got.shape == (2, s, 4, 16)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_attn_block_with_q_start_and_kv_len_matches_jax(window):
    q, k, v = _qkv(2, 1, 24, 4, 2, 16, seed=8)
    pos = 13
    got = L._attn_block(*_port(q, k, v), q_start=torch.tensor(pos), kv_start=0,
                        causal=True, window=window,
                        kv_len=torch.tensor(pos + 1))
    want = JL._attn_block(*map(jnp.asarray, (q, k, v)), q_start=pos,
                          kv_start=0, causal=True, window=window,
                          kv_len=pos + 1)
    _close(got, want, rtol=1e-5, atol=1e-5)
    # blocked_attention takes q_offset / kv_len through ops.attention (the
    # plain version on the CPU)
    got2 = L.blocked_attention(*_port(q, k, v), window=window, q_offset=pos,
                               kv_len=torch.tensor(pos + 1))
    torch.testing.assert_close(got2, got)


def test_ring_attend_matches_jax():
    q, kc, vc = _qkv(2, 1, 16, 4, 1, 32, seed=9)
    pos = 37
    kpos = np.roll(np.arange(pos - 15, pos + 1, dtype=np.int32), 5)
    kpos[3] = -1                                   # an empty slot
    got = DE._ring_attend(*_port(q, kc, vc), torch.from_numpy(kpos),
                          torch.tensor(pos, dtype=torch.int32), 16)
    want = JDE._ring_attend(*map(jnp.asarray, (q, kc, vc)),
                            jnp.asarray(kpos), jnp.int32(pos), 16)
    _close(got, want, rtol=1e-5, atol=1e-5)
