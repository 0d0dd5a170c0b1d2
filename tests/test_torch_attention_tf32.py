"""A plain model of K5 and K5b's fp32 arithmetic (3xTF32 on the tensor
cores) against the JAX package, on the CPU.

In fp32 every product of K5 and K5b (``csrc/flash_attention.cu``) runs as
three TF32 products: an operand a splits into ah, a with its low 13
mantissa bits cleared (TF32 by truncation), and al, a - ah cleared the
same way (``mma.cuh::split_tf32``; inf and NaN keep ah and take al = 0),
and a.b is al.bh + ah.bl + ah.bh.  P (and dS, P^T, dS^T) stay in
registers as the next product's operand with the keys (or query rows)
relabelled inside each 8-step: k index t + 4i is key 2t + i, for both
operands.  The forward walks the key tiles of ``tile_range`` in launch
order with the online softmax in fp32 (ex2 with log2(e) / sqrt(D) folded
in, m in the scores' units, NEG_INF for a masked pair, -inf past Skv); the
backward runs its dQ pass over the key tiles and its dK/dV pass over
``bwd_plan(..., fp32=True)``'s ranks, heads and query tiles, the ranks'
partials summed in rank order.

``forward_model`` and ``backward_model`` below model that arithmetic in
plain PyTorch: the split, the key relabelling, the online softmax over the
kernels' key tiles in launch order (``TfFwd``'s four-warp tiles and
``TfBwd``'s in the source) and the plan's rank-order sums.  They do not
model the tensor cores' accumulation: each product is ah.bh + (al.bh +
ah.bl) in fp32 matmuls, with neither the truncation of each m16n8k8
partial sum nor the kernels' order of sums (large terms from zero over two
k8 steps or a tile, small terms in sums of their own).  A kernel that
summed in another order could pass here; only the card tests and
``chip_smoke.py`` hold the kernels' summation order.  Inputs are made with
numpy from a seed; the
model is held to ``repro.models.layers.blocked_attention`` (fp32, one
block) and to ``jax.vjp`` of it within a relative Frobenius error of
1e-5 for o, dq, dk and dv: causal, a window, ``q_offset`` and ``kv_len``,
GQA, rows that see no key, and every pair of ``HEAD_DIM_PAIRS``.  At the
shapes with a head dim of 64 or more and 128 keys or more, the same model
with one TF32 product (ah.bh, the lo terms dropped) reads above
``chip_smoke.py``'s fp32 bar of 1e-4: that bar sees a kernel that drops
them.  The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (HEAD_DIM_PAIRS, NEG_INF,
                                                 bwd_plan, bwd_rows,
                                                 bwd_tile)

LOG2E = 1.4426950408889634
BAR = 1e-5          # the 3xTF32 model against JAX
K5_REL = 1e-4       # chip_smoke.py's K5_REL / K5B_REL in fp32
# k index t + 4i of an 8-step is key 2t + i
RELABEL = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32_split(a):
    """(hi, lo) as the kernels split a: hi truncated to TF32, lo the
    remainder truncated again; inf and NaN keep hi and take lo = 0."""
    hi = (a.view(torch.int32) & -8192).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & -8192).view(torch.float32)
    finite = torch.isfinite(a)
    return torch.where(finite, hi, a), torch.where(finite, lo, 0.0)


def product(a, b, terms):
    """a @ b from TF32 operands: al.bh + ah.bl + ah.bh (3), or ah.bh (1)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if terms == 1:
        return ah @ bh
    return ah @ bh + (al @ bh + ah @ bl)


def relabelled(n):
    """Index of n keys (a multiple of 8) in the kernels' k order."""
    return (torch.arange(n).reshape(-1, 8)[:, RELABEL]).reshape(-1)


def fwd_tiles(D):
    """K5's fp32 tiles at four warps: (query rows, keys) a block
    (``TfFwd``)."""
    return 64, 32 if D <= 64 or D == 128 else (16 if D < 128 else 8)


def keep_mask(qpos, kpos, causal, window, kvl):
    keep = kpos[None, :] < kvl
    if causal:
        keep = keep & (kpos[None, :] <= qpos[:, None])
    if window:
        keep = keep & (qpos[:, None] - kpos[None, :] < window)
    return keep


def tile_range(q0, bq, Sq, Skv, causal, window, q_off, kvl):
    """csrc/flash_attention.cu's tile_range: the keys [k_lo, k_hi) a query
    tile walks, and whether it holds a row that sees no key."""
    q_last = min(q0 + bq, Sq) - 1 + q_off
    full = kvl <= 0 or bool(window and q_last >= kvl + window - 1)
    k_lo = max(0, q0 + q_off - window + 1) if window and not full else 0
    k_hi = Skv if full else (min(kvl, q_last + 1) if causal else kvl)
    return k_lo, k_hi


def padded(t, lo, n):
    """Rows [lo, lo + n) of t along dim -2, zeros past its end."""
    part = t[..., lo:lo + n, :]
    if part.shape[-2] < n:
        pad = torch.zeros(*part.shape[:-2], n - part.shape[-2],
                          part.shape[-1])
        part = torch.cat([part, pad], -2)
    return part


def forward_model(q, k, v, causal, window, q_off=0, kv_len=None, terms=3):
    """K5's fp32 forward: (o, lse), q (B, H, Sq, D), k and v (B, KV, Skv,
    D or Dv)."""
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    kvl = Skv if kv_len is None else max(0, min(kv_len, Skv))
    scale = np.float32(1.0 / math.sqrt(D))
    c = np.float32(scale * np.float32(LOG2E))
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    bq, bk = fwd_tiles(D)
    idx = relabelled(bk)
    o = torch.zeros(B, H, Sq, Dv)
    lse = torch.zeros(B, H, Sq)
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        qpos = torch.arange(q0, q0 + n) + q_off
        k_lo, k_hi = tile_range(q0, bq, Sq, Skv, causal, window, q_off, kvl)
        m = torch.full((B, H, n), NEG_INF)
        l = torch.zeros(B, H, n)
        acc = torch.zeros(B, H, n, Dv)
        for j in range(k_lo // bk, -(-k_hi // bk)):
            kpos = torch.arange(j * bk, (j + 1) * bk)
            s = product(q[:, :, q0:q0 + n], padded(kk, j * bk, bk)
                        .transpose(-1, -2), terms)
            s = torch.where(keep_mask(qpos, kpos, causal, window, kvl), s,
                            torch.tensor(NEG_INF))
            s = torch.where(kpos < Skv, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2((s - m_new[..., None]) * c)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + product(
                p[..., idx], padded(vv, j * bk, bk)[..., idx, :], terms)
            m = m_new
        o[:, :, q0:q0 + n] = acc / l.clamp_min(1e-30)[..., None]
        lse[:, :, q0:q0 + n] = torch.where(m == NEG_INF,
                                           torch.tensor(NEG_INF),
                                           m * scale + torch.log(l))
    return o, lse


def pair_grads(s, dp, lse, delta, qi, kj, causal, window, q_off, kvl, Sq,
               Skv, scale):
    """P and dS of a block of pairs (csrc's pair_grads): P = 2^(s c - lse
    log2 e) where kept, 1 / Skv on every key of a row that saw no key; dS
    = P (dP - Delta) scale where kept and the row saw a key, else 0.  The
    query rows ``qi`` and keys ``kj`` broadcast to the block (either
    way round)."""
    c = np.float32(scale * np.float32(LOG2E))
    dead = lse == NEG_INF
    l2 = torch.where(dead, torch.tensor(-math.inf), lse * np.float32(LOG2E))
    valid = (qi < Sq) & (kj < Skv)
    keep = valid & (kj < kvl)
    if causal:
        keep = keep & (kj <= qi + q_off)
    if window:
        keep = keep & (qi + q_off - kj < window)
    p = torch.where(keep, torch.exp2(s * c - l2), 0.0)
    p = torch.where(dead & valid, 1.0 / Skv, p)
    ds = torch.where(keep & ~dead, p * (dp - delta) * scale, 0.0)
    return p, ds


def backward_model(q, k, v, o, lse, do, causal, window, q_off=0,
                   kv_len=None, terms=3):
    """K5b's fp32 backward: (dq, dk, dv) from the forward's o and lse."""
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    kvl = Skv if kv_len is None else max(0, min(kv_len, Skv))
    scale = np.float32(1.0 / math.sqrt(D))
    delta = (do * o).sum(-1)
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    # the dQ pass: own query rows, key tiles in order
    qrows, bt = (64, 16) if D <= 128 else (32, 8)       # TfBwd::QROWS, BTQ
    idx = relabelled(bt)
    dq = torch.zeros_like(q)
    for q0 in range(0, Sq, qrows):
        n = min(qrows, Sq - q0)
        rows = torch.arange(q0, q0 + n)
        k_lo, k_hi = tile_range(q0, qrows, Sq, Skv, causal, window, q_off,
                                kvl)
        for j in range(k_lo // bt, -(-k_hi // bt)):
            cols = torch.arange(j * bt, (j + 1) * bt)
            kt = padded(kk, j * bt, bt)
            s = product(q[:, :, q0:q0 + n], kt.transpose(-1, -2), terms)
            dp = product(do[:, :, q0:q0 + n],
                         padded(vv, j * bt, bt).transpose(-1, -2), terms)
            _, ds = pair_grads(s, dp, lse[:, :, q0:q0 + n, None],
                               delta[:, :, q0:q0 + n, None], rows[:, None],
                               cols[None, :], causal, window, q_off, kvl, Sq,
                               Skv, scale)
            dq[:, :, q0:q0 + n] += product(ds[..., idx], kt[..., idx, :],
                                           terms)
    # the dK/dV pass: the fp32 plan's key tiles, ranks, heads, query tiles
    plan = bwd_plan(B, H, KV, Sq, Skv, D, causal, window, q_offset=q_off,
                    kv_len=kv_len, fp32=True)
    rows_k, tq = plan["key_rows"], plan["query_rows"]
    assert (rows_k, tq) == (bwd_rows(D, True), bwd_tile(True))
    idx = relabelled(tq)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt in plan["key_tiles"]:
        k0 = kt * rows_k
        keys = torch.arange(k0, k0 + rows_k)
        kown, vown = padded(k, k0, rows_k), padded(v, k0, rows_k)
        parts = []
        for heads in plan["heads"]:
            pk = torch.zeros(B, KV, rows_k, D)
            pv = torch.zeros(B, KV, rows_k, Dv)
            for g in heads:
                hs = torch.arange(KV) * G + g
                for qt in plan["query_tiles"][kt]:
                    qq = torch.arange(qt * tq, (qt + 1) * tq)
                    qg = padded(q[:, hs], qt * tq, tq)
                    dog = padded(do[:, hs], qt * tq, tq)
                    lq = padded(lse[:, hs, :, None], qt * tq, tq)[..., 0]
                    dl = padded(delta[:, hs, :, None], qt * tq, tq)[..., 0]
                    sT = product(kown, qg.transpose(-1, -2), terms)
                    dpT = product(vown, dog.transpose(-1, -2), terms)
                    pT, dsT = pair_grads(sT, dpT, lq[..., None, :],
                                         dl[..., None, :], qq[None, :],
                                         keys[:, None], causal, window,
                                         q_off, kvl, Sq, Skv, scale)
                    pv += product(pT[..., idx], dog[..., idx, :], terms)
                    pk += product(dsT[..., idx], qg[..., idx, :], terms)
            parts.append((pk, pv))
        sk, sv = parts[0]
        for pk, pv in parts[1:]:
            sk, sv = sk + pk, sv + pv
        n = min(rows_k, Skv - k0)
        dk[:, :, k0:k0 + n], dv[:, :, k0:k0 + n] = sk[:, :, :n], sv[:, :, :n]
    return dq, dk, dv


def rel(got, want):
    """||got - want|| / ||want||, the norm floored at an rms of 1e-2 (as
    chip_smoke.py's rel_frobenius: a gradient that is all zeros)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-2 * math.sqrt(want.size)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  floor))


def _bshd(a):      # (B, H, S, D) <-> (B, S, H, D)
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2))


def jax_reference(q, k, v, do, causal, window, q_off, kv_len):
    """(o, dq, dk, dv) of blocked_attention in one block, the port's
    layout."""
    def f(q, k, v):
        return JL.blocked_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, kv_len=kv_len)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)
    return tuple(_bshd(t) for t in fwd_bwd(
        *(jnp.asarray(_bshd(t)) for t in (q, k, v, do))))


# name: (B, H, KV, Sq, Skv, D, Dv, causal, window, q_offset, kv_len)
CASES = {
    "causal-mha-64": (1, 2, 2, 130, 130, 64, 64, True, 0, 0, None),
    "window-gqa-128": (1, 4, 2, 150, 150, 128, 128, True, 48, 0, None),
    "cross-noncausal-64": (1, 2, 1, 40, 150, 64, 64, False, 0, 0, None),
    "offset-kv-len-32": (2, 4, 2, 48, 100, 32, 32, True, 0, 40, 90),
    "dead-rows-16": (1, 2, 2, 40, 40, 16, 16, True, 8, 0, 20),
    "noncausal-dead-rows-32": (1, 2, 1, 24, 64, 32, 32, False, 0, 5, 0),
}
for _d, _dv in HEAD_DIM_PAIRS:
    CASES[f"pair-{_d}-{_dv}"] = (1, 4, 2, 40, 70, _d, _dv, True, 0, 0, None)


def _inputs(B, H, KV, Sq, Skv, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), dtype=np.float32),
            rng.standard_normal((B, KV, Skv, D), dtype=np.float32),
            rng.standard_normal((B, KV, Skv, Dv), dtype=np.float32),
            rng.standard_normal((B, H, Sq, Dv), dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's inputs and JAX's (o, dq, dk, dv), once a case."""
    B, H, KV, Sq, Skv, D, Dv, causal, window, off, kv_len = CASES[name]
    q, k, v, do = _inputs(B, H, KV, Sq, Skv, D, Dv, seed=len(name))
    return (q, k, v, do), jax_reference(q, k, v, do, causal, window, off,
                                        kv_len)


def _run(name, terms):
    *_, causal, window, off, kv_len = CASES[name]
    (q, k, v, do), want = _case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = forward_model(tq, tk, tv, causal, window, off, kv_len, terms)
    # the backward is fed the forward's o and lse, as K5b is fed K5's
    got = (o,) + backward_model(tq, tk, tv, o, lse, tdo, causal, window,
                                off, kv_len, terms)
    return {n: rel(g.numpy(), w) for n, g, w in
            zip(("o", "dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_model_matches_jax(name):
    errs = _run(name, 3)
    assert max(errs.values()) <= BAR, errs


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[5] >= 64 and c[4] >= 128])
def test_1xtf32_model_reads_above_the_fp32_bar(name):
    """One TF32 product (the lo terms dropped) reads above the card's fp32
    bar in every output: the bar sees such a kernel."""
    errs = _run(name, 1)
    assert min(errs.values()) > K5_REL, errs


def test_the_cases_reach_what_they_name():
    """The dead-row cases hold rows that see no key; the 1xTF32 cases
    exist; every head-dim pair is a case."""
    for name, (B, H, KV, Sq, Skv, D, Dv, causal, window, off,
               kv_len) in CASES.items():
        kvl = Skv if kv_len is None else kv_len
        keep = keep_mask(torch.arange(Sq) + off, torch.arange(Skv), causal,
                         window, kvl)
        assert bool((~keep.any(1)).any()) == ("dead" in name), name
    assert sum(c[5] >= 64 and c[4] >= 128 for c in CASES.values()) >= 2
    assert {(c[5], c[6]) for c in CASES.values()} >= set(HEAD_DIM_PAIRS)


def test_tf32_split_is_the_kernels():
    """hi keeps the top 10 mantissa bits, lo the next ones truncated; hi +
    lo is within 2^-21 of a; inf and NaN keep hi and take lo = 0."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32))
    hi, lo = tf32_split(a)
    assert not (hi.view(torch.int32) & 8191).any()
    assert not (lo.view(torch.int32) & 8191).any()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()
    assert (hi.abs() <= a.abs()).all() and (torch.sign(lo) * torch.sign(a)
                                            >= 0).all()
    odd = torch.tensor([math.inf, -math.inf, math.nan])
    hi, lo = tf32_split(odd)
    assert torch.equal(hi[:2], odd[:2]) and hi[2].isnan()
    assert not lo.any()


def test_roofline_prices_the_3xtf32_route():
    """K5 and K5b in fp32 are bound by the work as the kernels do it, three
    TF32 products at 495 TFLOP/s, with the FMA pipes' bound of the same
    products beside it; bf16 keeps one bound."""
    from repro_torch.analysis import roofline as RL
    (ms, by), (fma, fby) = RL.k5b_bounds(2, 16, 4, 256, 256, 128, True, 0,
                                         torch.float32)
    assert (round(ms, 6), by) == (0.008166, "operations")
    assert (round(fma, 6), fby) == (0.020111, "operations")
    (ms, by), (fma, fby) = RL.k5_bounds(4, 20, 20, 1024, 1024, 128, True, 0,
                                        torch.float32)
    assert (round(ms, 6), by) == (0.130278, "operations")
    assert (round(fma, 6), fby) == (0.320833, "operations")
    one, none = RL.k5_bounds(4, 20, 20, 1024, 1024, 128, True, 0,
                             torch.bfloat16)
    assert none is None and one == RL.bound(*RL.k5_work(
        4, 20, 20, 1024, 1024, 128, True, 0, torch.bfloat16), torch.bfloat16)
