"""A plain model of K5b's head split against the JAX package, on the CPU.

K5b's bf16 dK/dV pass (``csrc/flash_attention.cu``) gives each (batch row,
KV head, key tile) a thread-block cluster of R ranks (a key tile is 128
keys up to head dim 128, 64 at 256): rank r walks the query heads r, r +
R, ... of the KV head's G and, for each, the 64-row query tiles the masks
leave, accumulating its partial dK and dV; the partials are then summed
over the ranks in rank order.  ``bwd_plan`` (``kernels/flash_attention.py``)
gives R, the heads of each rank, the key tiles in launch order and the
query tiles of each.  ``split_model`` below
is that decomposition in plain PyTorch, partial for partial, fed the plain
forward's output and log-sum-exp as K5b is fed K5's, and held to
``jax.vjp`` of ``repro.models.layers.blocked_attention`` at G = 1, 2, 4,
10 and 16, with clusters that divide G and clusters that do not, at
``tests/test_torch_attention_grad.py``'s tolerances (rtol 1e-4, atol
1e-5: both sides fp32, differing only in the order of the sums).  The
plan is checked to cover every (query head, key tile) once, and every pair
the masks leave.  The fp32 kernels' plan (``bwd_plan(..., fp32=True)``:
64 own keys, 16 at head dim 256, query tiles of 16 rows) gets the same
two checks.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (BWD_TILE, MAX_CLUSTER,
                                                 NEG_INF, _mask, bwd_plan,
                                                 bwd_rows, bwd_tile,
                                                 flash_attention_plain)

RTOL, ATOL = 1e-4, 1e-5         # tests/test_torch_attention_grad.py


def split_model(q, k, v, o, lse, do, *, causal, window, plan):
    """(dQ, dK, dV) through K5b's decomposition: dK and dV of each key tile
    summed per rank over its heads and their query tiles, in order, then
    over the ranks in rank order; dQ its own pass.  fp32."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, Sq, D)
    dog = do.reshape(B, KV, G, Sq, D)
    mask = _mask(Sq, Skv, causal, window, q.device)
    dead = lse.reshape(B, KV, G, Sq, 1) == NEG_INF
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    p = torch.where(dead, 1.0 / Skv, p)
    delta = (dog * o.reshape(B, KV, G, Sq, D)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v)
    ds = torch.where(mask & ~dead, p * (dp - delta), 0.0) * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    rows, T = plan["key_rows"], plan["query_rows"]
    for kt in plan["key_tiles"]:
        ks = slice(kt * rows, min(Skv, (kt + 1) * rows))
        parts = []
        for heads in plan["heads"]:
            pk, pv = torch.zeros_like(dk[:, :, ks]), torch.zeros_like(dv[:, :, ks])
            for g in heads:
                for qt in plan["query_tiles"][kt]:
                    qs = slice(qt * T, min(Sq, (qt + 1) * T))
                    pv = pv + torch.einsum("bkqs,bkqd->bksd",
                                           p[:, :, g, qs, ks], dog[:, :, g, qs])
                    pk = pk + torch.einsum("bkqs,bkqd->bksd",
                                           ds[:, :, g, qs, ks], qg[:, :, g, qs])
            parts.append((pk, pv))
        dk[:, :, ks], dv[:, :, ks] = parts[0]
        for pk, pv in parts[1:]:
            dk[:, :, ks] += pk
            dv[:, :, ks] += pv
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k).reshape(B, H, Sq, D)
    return dq, dk, dv


def _inputs(b, h, kv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, kv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, kv, skv, d), dtype=np.float32)
    do = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    return q, k, v, do


def _bshd(a):      # (B, H, S, D) <-> (B, S, H, D)
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2))


def _jax_vjp(q, k, v, do, causal, window):
    """(dq, dk, dv) of blocked_attention, in the port's layout."""
    def f(q, k, v):
        return JL.blocked_attention(q, k, v, causal=causal, window=window)
    _, vjp = jax.vjp(f, *(jnp.asarray(_bshd(t)) for t in (q, k, v)))
    return tuple(_bshd(t) for t in vjp(jnp.asarray(_bshd(do))))


# (B, H, KV, Sq, Skv, D), causal, window, the cluster (0: the plan's own):
# G = 1, 2, 4, 10 (RecurrentGemma-2B's heads a KV head) and 16; clusters
# that divide G and clusters that do not; Sq and Skv off the 64-row tile,
# Sq != Skv; a window that bites, rows that see no key (Sq past Skv + window
# - 1) and no masking at all
CASES = [
    ((1, 2, 2, 130, 130, 32), True, 0, 1),
    ((2, 4, 2, 100, 140, 32), False, 40, 2),
    ((1, 8, 2, 150, 150, 16), True, 48, 3),
    ((1, 8, 2, 150, 150, 16), True, 48, 4),
    ((1, 10, 1, 200, 200, 32), True, 0, 3),
    ((1, 10, 1, 200, 200, 32), True, 0, 4),
    ((1, 10, 1, 200, 200, 32), True, 0, 0),
    ((2, 10, 1, 160, 70, 16), False, 30, 7),
    ((1, 16, 1, 96, 96, 16), True, 0, 5),
    ((1, 16, 1, 96, 96, 16), False, 0, 0),
]


@pytest.mark.parametrize("shape,causal,window,cluster", CASES)
def test_split_model_matches_jax_vjp(shape, causal, window, cluster):
    _split_model_case(shape, causal, window, cluster, fp32=False)


# The fp32 kernels' plan (64 own keys, 16 at head dim 256; query tiles of
# 16 rows) at the same splits, and at head dims 128 and 256
FP32_CASES = CASES[::2] + [((1, 8, 2, 100, 90, 128), True, 0, 3),
                           ((1, 4, 1, 70, 70, 256), False, 20, 0)]


@pytest.mark.parametrize("shape,causal,window,cluster", FP32_CASES)
def test_fp32_split_model_matches_jax_vjp(shape, causal, window, cluster):
    _split_model_case(shape, causal, window, cluster, fp32=True)


def _split_model_case(shape, causal, window, cluster, fp32):
    q, k, v, do = _inputs(*shape)
    B, H, KV, Sq, Skv, D = shape
    plan = bwd_plan(B, H, KV, Sq, Skv, D, causal, window, cluster=cluster,
                    fp32=fp32)
    assert plan["query_rows"] == (bwd_tile(True) if fp32 else BWD_TILE)
    G = H // KV
    assert plan["cluster"] == (cluster or plan["cluster"])
    assert 1 <= plan["cluster"] <= min(MAX_CLUSTER, G)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    got = split_model(tq, tk, tv, o, lse, tdo, causal=causal, window=window,
                      plan=plan)
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert gg.shape == ww.shape, name
        np.testing.assert_allclose(gg.numpy(), ww, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


PLAN_SHAPES = [
    ((4, 10, 1, 1024, 1024, 256), True, 2048),
    ((1, 10, 1, 4096, 4096, 256), True, 2048),
    ((4, 32, 8, 1024, 1024, 128), True, 0),
    ((1, 10, 1, 200, 200, 32), True, 0),
    ((2, 10, 1, 160, 70, 16), False, 30),
    ((1, 4, 2, 300, 40, 64), True, 30),
    ((1, 16, 1, 96, 96, 16), False, 0)]


@pytest.mark.parametrize("shape,causal,window", PLAN_SHAPES)
@pytest.mark.parametrize("cluster", [0, 3])
def test_plan_covers_every_head_and_key_tile_once(shape, causal, window,
                                                  cluster):
    """Each key tile once in the launch order (the heaviest first), each
    query head once a key tile (over the ranks), and the key tile's query
    tiles every one that holds a pair the masks leave or a row that sees
    no key."""
    _plan_covers(shape, causal, window, cluster, fp32=False)


@pytest.mark.parametrize("shape,causal,window", PLAN_SHAPES)
@pytest.mark.parametrize("cluster", [0, 3])
def test_fp32_plan_covers_every_head_and_key_tile_once(shape, causal,
                                                       window, cluster):
    """The same of the fp32 kernels' plan, with their key and query
    tiles."""
    _plan_covers(shape, causal, window, cluster, fp32=True)


def _plan_covers(shape, causal, window, cluster, fp32):
    B, H, KV, Sq, Skv, D = shape
    G = H // KV
    plan = bwd_plan(B, H, KV, Sq, Skv, D, causal, window, cluster=cluster,
                    fp32=fp32)
    rows, T = plan["key_rows"], plan["query_rows"]
    assert rows == bwd_rows(D, fp32)
    assert T == bwd_tile(fp32)
    nk = -(-Skv // rows)
    assert sorted(plan["key_tiles"]) == list(range(nk))
    walks = [len(plan["query_tiles"][kt]) for kt in plan["key_tiles"]]
    assert walks == sorted(walks, reverse=True)
    heads = [g for rank in plan["heads"] for g in rank]
    assert sorted(heads) == list(range(G))
    assert len(plan["heads"]) == plan["cluster"]
    mask = _mask(Sq, Skv, causal, window, "cpu").numpy()
    dead = ~mask.any(1)
    for kt in range(nk):
        ks = slice(kt * rows, (kt + 1) * rows)
        need = {qt for qt in range(-(-Sq // T))
                if (mask[qt * T:(qt + 1) * T, ks].any()
                    or dead[qt * T:(qt + 1) * T].any())}
        assert need <= set(plan["query_tiles"][kt]), kt
