"""Attention with the queries shifted (``q_offset``) and the keys cut to a
valid prefix (``kv_len``), against the JAX package, on the CPU.

``layers.blocked_attention`` takes both keywords through ``ops.attention``
on every device (K5, and K5b under autograd, on the card; their plain
versions on the CPU).  The mask is JAX's ``_attn_block``'s: a query at row
i sits at position i + q_offset, and a pair attends where ``kpos <= qpos``
(causal), ``qpos - kpos < window`` (a window) and ``kpos < kv_len``.  A row
that sees no key (no key below kv_len, or with a window every such key a
window or more back) takes the mean of all Skv values, as JAX's softmax of
a row all at the mask value gives it.

The forward is held to JAX's ``blocked_attention`` with ``unroll`` true and
false, at a ``chunk`` that divides Sq (JAX's chunk loop) and at one that
does not (one block), causal, windowed and non-causal, GQA and MHA, with
``kv_len`` an int or a 0-d tensor, at 1e-5 in fp32.  Where JAX's chunk loop
slices K/V to a span (a window; causal attention at q_offset 0) a row that
sees no key averages the span's values, not all Skv, and a non-causal
window drops the keys past the chunk: the rows that see no key, and the
non-causal window, are held where JAX takes every key (one block, or a
loop whose span is Skv).  The gradient through ``FlashAttention``'s plain
path (K5b's plain version) is held to ``jax.vjp`` of JAX's function at
``tests/test_torch_attention_grad.py``'s bars.  ``bwd_query_tiles``, the
query tiles K5b's dK/dV pass walks for a key tile, is held to a numpy
model of the shifted mask: every row that reaches the key tile (a kept
pair, or a row that sees no key and so weighs every key) lies in a walked
tile, and the first and last walked tiles hold such a row.  The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (BWD_TILE, FlashAttention,
                                                 bwd_plan, bwd_query_tiles,
                                                 kv_len_value)
from repro_torch.models import layers as L

# name: (B, H, KV, Sq, Skv, D, causal, window, q_offset, kv_len, chunk);
# kv_len a tuple (v,) is passed as a 0-d int64 tensor
CASES = {
    "causal-offset-chunked": (2, 4, 2, 48, 80, 16, True, 0, 32, 70, 16),
    "causal-offset-one-block": (2, 4, 2, 48, 80, 16, True, 0, 32, (70,), 20),
    "window-chunked": (2, 4, 2, 48, 96, 16, True, 24, 40, 90, 16),
    "window-dead-rows": (2, 4, 2, 48, 96, 16, True, 24, 40, (60,), 20),
    "noncausal-chunked": (2, 4, 4, 32, 64, 16, False, 0, 0, 30, 16),
    "noncausal-dead-rows-chunked": (1, 4, 2, 32, 64, 16, False, 0, 5, 0,
                                    16),
    "noncausal-window": (2, 4, 2, 40, 64, 16, False, 12, 20, 50, 64),
    "causal-no-key": (1, 4, 1, 40, 40, 16, True, 0, 3, (0,), 16),
    "causal-offset-gqa4-chunked": (1, 8, 2, 64, 128, 32, True, 0, 64, None,
                                   32),
}
RTOL = ATOL = 1e-5
# tests/test_torch_attention_grad.py's bars for the gradient (fp32 sums in
# other orders)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _inputs(B, H, KV, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, KV, D), dtype=np.float32)
    do = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, do


def _kv_len(kv_len, port):
    """The case's kv_len for the port (a tuple: a 0-d tensor) or JAX."""
    if isinstance(kv_len, tuple):
        return (torch.tensor(kv_len[0], dtype=torch.int64) if port
                else jnp.asarray(kv_len[0]))
    return kv_len


def _dead_rows(Sq, Skv, causal, window, q_offset, kv_len):
    """The rows that see no key, from the mask itself."""
    kvl = kv_len_value(kv_len[0] if isinstance(kv_len, tuple) else kv_len,
                       Skv)
    return int((~_reach_mask(Sq, Skv, causal, window, q_offset, kvl,
                             dead=False).any(1)).sum())


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_blocked_attention_with_offsets_matches_jax(name, unroll):
    B, H, KV, Sq, Skv, D, causal, window, off, kv_len, chunk = CASES[name]
    q, k, v, _ = _inputs(B, H, KV, Sq, Skv, D)
    got = L.blocked_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window, chunk=chunk,
                              unroll=unroll, q_offset=off,
                              kv_len=_kv_len(kv_len, True))
    want = JL.blocked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, chunk=chunk, unroll=unroll,
                                q_offset=off, kv_len=_kv_len(kv_len, False))
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_the_cases_reach_what_they_name():
    """The dead-row cases hold rows that see no key, the others none; the
    chunked cases take JAX's chunk loop, the others its one block."""
    for name, (B, H, KV, Sq, Skv, D, causal, window, off, kv_len,
               chunk) in CASES.items():
        dead = _dead_rows(Sq, Skv, causal, window, off, kv_len)
        assert (dead > 0) == ("dead" in name or "no-key" in name), name
        assert (Sq % chunk == 0 and Sq > chunk) == ("chunked" in name), name


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_through_flash_attention_matches_jax_vjp(name):
    """dq, dk, dv of ``blocked_attention`` under autograd (the plain
    ``FlashAttention``: K5b's plain version fed the forward's lse) against
    ``jax.vjp`` of JAX's ``blocked_attention`` in one block (Sq <= its
    chunk), the same output cotangent."""
    B, H, KV, Sq, Skv, D, causal, window, off, kv_len, _ = CASES[name]
    q, k, v, do = _inputs(B, H, KV, Sq, Skv, D, seed=3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.blocked_attention(qt, kt, vt, causal=causal, window=window,
                              q_offset=off, kv_len=_kv_len(kv_len, True))
    assert "FlashAttention" in type(
        out.grad_fn.next_functions[0][0]).__name__
    out.backward(torch.from_numpy(do))

    def f(q, k, v):
        return JL.blocked_attention(q, k, v, causal=causal, window=window,
                                    chunk=512, q_offset=off,
                                    kv_len=_kv_len(kv_len, False))

    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for got, w in zip((qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_flash_attention_function_takes_a_kv_len_tensor():
    """``FlashAttention.apply`` with a 0-d tensor ``kv_len`` equals the
    same with the int, forward and backward."""
    B, H, KV, Sq, Skv, D = 1, 4, 2, 24, 40, 16
    q, k, v, do = _inputs(B, H, KV, Sq, Skv, D, seed=5)
    grads = []
    for kv_len in (17, torch.tensor(17)):
        qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).contiguous()
                      .requires_grad_() for a in (q, k, v))
        o = FlashAttention.apply(qt, kt, vt, True, 8, 9, kv_len)
        o.backward(torch.from_numpy(do).transpose(1, 2))
        grads.append((o.detach(), qt.grad, kt.grad, vt.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _reach_mask(Sq, Skv, causal, window, q_offset, kvl, dead=True):
    """(Sq, Skv): the pairs kept by the shifted mask; with ``dead`` also
    every key of a row that keeps none (it weighs every key)."""
    qa = np.arange(Sq)[:, None] + q_offset
    kj = np.arange(Skv)[None, :]
    keep = (kj < kvl) & (qa >= 0)
    if causal:
        keep = keep & (kj <= qa)
    if window:
        keep = keep & (qa - kj < window)
    if dead:
        keep = keep | ~keep.any(1, keepdims=True)
    return keep


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 16), (True, 100),
                                           (False, 16), (False, 100)])
def test_bwd_query_tiles_cover_the_rows_the_shifted_mask_reaches(causal,
                                                                 window):
    for Sq, Skv, off, kv_len, rows in itertools.product(
            (64, 100, 200), (64, 150, 300), (0, 5, 64, 130),
            (None, 0, 1, 50, 299), (64, 128)):
        kvl = kv_len_value(kv_len, Skv)
        reach = _reach_mask(Sq, Skv, causal, window, off, kvl)
        for kt in range(-(-Skv // rows)):
            tiles = bwd_query_tiles(kt, Sq, Skv, causal, window, rows, off,
                                    kvl)
            hit = np.nonzero(reach[:, kt * rows:(kt + 1) * rows].any(1))[0]
            at = (Sq, Skv, off, kv_len, rows, kt)
            if not len(hit):
                assert len(tiles) == 0, at
                continue
            assert set(hit // BWD_TILE) <= set(tiles), at
            assert tiles[0] == hit[0] // BWD_TILE, at
            assert tiles[-1] == hit[-1] // BWD_TILE, at


def test_unshifted_query_tiles_are_the_old_ones():
    """``q_offset`` 0 and every key valid walk the tiles of the unshifted
    rule: causal rows from the key tile's first key, with a window those
    before its last key + window, every row to Sq once some row sees no
    key (Sq >= Skv + window)."""
    for Sq, Skv, causal, window, rows in itertools.product(
            (64, 130, 300), (64, 130, 300), (True, False), (0, 16, 100),
            (64, 128)):
        for kt in range(-(-Skv // rows)):
            k0 = kt * rows
            lo = k0 if causal else 0
            hi = (min(Sq, k0 + rows - 1 + window)
                  if window and Sq < Skv + window else Sq)
            want = (range(0) if hi <= lo else
                    range(lo // BWD_TILE, -(-hi // BWD_TILE)))
            for kv_len in (None, Skv, Skv + 7):
                assert bwd_query_tiles(
                    kt, Sq, Skv, causal, window, rows, 0,
                    kv_len_value(kv_len, Skv)) == want


def test_bwd_plan_takes_the_offsets():
    """The plan lists each key tile's walked query tiles from the shifted
    rule; key tiles wholly past the valid prefix walk none (no row there
    sees no key), and with no valid key every tile walks every row."""
    B, H, KV, Sq, Skv, D = 2, 8, 2, 256, 1024, 128
    plan = bwd_plan(B, H, KV, Sq, Skv, D, True, 0, q_offset=768,
                    kv_len=900)
    rows = plan["key_rows"]
    for kt, tiles in enumerate(plan["query_tiles"]):
        assert tiles == tuple(bwd_query_tiles(kt, Sq, Skv, True, 0, rows,
                                              768, 900))
        assert (len(tiles) == 0) == (kt * rows >= 900)
    dead = bwd_plan(B, H, KV, Sq, Skv, D, True, 0, q_offset=768, kv_len=0)
    assert all(t == tuple(range(Sq // BWD_TILE))
               for t in dead["query_tiles"])
