"""Decode's step functions on a cache split along the sequence, on the CPU.

Four ranks along ``model`` are threads of one process: each holds its
block of the cache (``sharding.local_block`` under
``sharding.cache_specs``) and calls the step with the same token, and the
all-reduces of ``decode._combine`` meet at a barrier (``collectives.
reduce_`` patched; the weights are whole, so nothing else crosses ranks).
Each rank's output must be the one-card step's on the whole cache within
1e-5 (fp32), and its block of the cache after the step the block of the
one-card cache: the log-sum-exp combine against ``layers._attn_block``
over the whole cache, GQA and MLA steps whose ``pos`` crosses from one
rank's block into the next (the row written by its owner alone, the
others writing their old row back), the ring's slot written by the rank
that holds it, and a sequence that does not divide over ``model``, which
stays whole on every rank (no block, the one-card step).
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as SH
from repro_torch.models import decode as DE
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

N = 4
B = 2


class _Ranks:
    """N threads standing for the ranks along ``model``: a fake mesh that
    answers each thread's coordinates, and ``reduce_`` over the threads."""

    def __init__(self):
        self.local = threading.local()
        self.barrier = threading.Barrier(N)
        self.slots = [None] * N
        self.shape = {"data": 1, "model": N}
        self.mesh_dim_names = ("data", "model")

    def get_local_rank(self, name):
        return self.local.rank if name == "model" else 0

    def reduce_(self, t, mesh, axes, op=dist.ReduceOp.SUM):
        assert tuple(axes) == ("model",)
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        stacked = torch.stack(self.slots)
        out = stacked.amax(0) if op == dist.ReduceOp.MAX else stacked.sum(0)
        self.barrier.wait()
        return t.copy_(out)

    def run(self, fn):
        """``fn(rank)`` on every rank at once; their results in order."""
        out, errors = [None] * N, []

        def one(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def ranks(monkeypatch):
    r = _Ranks()
    monkeypatch.setattr(coll, "reduce_", r.reduce_)
    return r


def _layer(arch, **over):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    key = next(k for k in params["blocks"] if k.endswith("attn"))
    return cfg, key, T.group_params(params["blocks"], 0)[key]


def _filled(cfg, key, seq, seed):
    """A whole cache of the layer ``key`` of ``seq`` positions, drawn."""
    g = torch.Generator().manual_seed(seed)
    cache = DE.init_cache(cfg, B, seq, device="cpu")["blocks"]
    return tree_map(lambda t: t if t.dtype == torch.int32 else torch.randn(
        t.shape, generator=g), T.group_params(cache, 0)[key])


def _step(cfg, key, p, cache, pos, ctx_shard=None, blocks=None, seed=1):
    x = torch.randn((B, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    ctx = T.rope_ctx(cfg, T.default_positions(cfg, pos.expand(B, 1)))
    ctx.shard = ctx_shard
    fn = DE.mla_step if cfg.attention == "mla" else DE.attn_step
    return fn(cfg, p["attn"], x, cache, pos, ctx, blocks)


def _split(ranks, cfg, key, whole, seq):
    """Each rank's block of ``whole`` and its ``layer_blocks``."""
    specs = SH.cache_specs(cfg, ranks, B, seq, SH.TP_RULES)["blocks"][key]
    specs = {n: SH.P(*sp[1:]) for n, sp in specs.items()}

    def block(r):
        ranks.local.rank = r
        at = SH.mesh_coords(ranks)
        cache = {n: SH.local_block(t, specs[n], ranks, at).clone()
                 for n, t in whole.items()}
        return cache, DE.layer_blocks(specs, ranks)
    return [block(r) for r in range(N)], specs


def test_combine_is_attention_over_the_whole_cache(ranks):
    """``_attend`` over the ranks' blocks equals ``_attn_block`` over the
    whole cache, positions past ``pos`` masked."""
    g = torch.Generator().manual_seed(3)
    S, H, KV, D = 32, 4, 2, 16
    q = torch.randn((B, 1, H, D), generator=g)
    k, v = (torch.randn((B, S, KV, D), generator=g) for _ in range(2))
    pos = torch.tensor(21)
    want = L._attn_block(q, k, v, q_start=pos, kv_start=0, causal=True,
                         window=0, kv_len=pos + 1)
    shard = SH.ActSharder(ranks, (), SH.TP_RULES)
    ctx = T.Ctx(cfg=None, shard=shard)

    def rank(r):
        blk = DE.Block(r, N, ("model",))
        kp = blk.lo(S // N) + torch.arange(S // N)
        return DE._attend(q, k[:, kp], v[:, kp], kp <= pos, blk, ctx)
    for got in ranks.run(rank):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "minicpm3-4b"])
def test_a_step_across_the_blocks_is_the_one_card_step(ranks, arch):
    """pos 7 then 8 with blocks of 8: the first row lands in rank 0's
    block, the second in rank 1's; every rank's output and block equal
    the one-card step's."""
    cfg, key, p = _layer(arch)
    S = 32
    whole = _filled(cfg, key, S, 5)
    blocks, _ = _split(ranks, cfg, key, whole, S)
    shard = SH.ActSharder(ranks, (), SH.TP_RULES)
    for step, at in enumerate((7, 8)):
        pos = torch.tensor(at, dtype=torch.int32)
        want = _step(cfg, key, p, whole, pos, seed=step)

        def rank(r):
            cache, blk = blocks[r]
            return _step(cfg, key, p, cache, pos, shard, blk, seed=step)
        got = ranks.run(rank)
        for r, out in enumerate(got):
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
            for n, t in blocks[r][0].items():
                size = t.shape[1]
                np.testing.assert_array_equal(
                    t, whole[n][:, r * size:(r + 1) * size], err_msg=n)


def test_the_ring_slot_is_written_by_its_owner(ranks):
    """A ring of W 64 over 4 ranks (16 slots each) holding positions 96 to
    159, at pos 173: slot 45 is rank 2's; the ring's ``kpos`` is whole and
    equal on every rank."""
    cfg, key, p = _layer("recurrentgemma-2b")
    W = cfg.sliding_window
    S = W + 96                             # past the window: a ring
    whole = _filled(cfg, key, S, 9)
    assert "kpos" in whole and whole["k"].shape[1] == W
    whole["kpos"].copy_(torch.roll(torch.arange(S - W, S, dtype=torch.int32),
                                   (S - W) % W))
    blocks, specs = _split(ranks, cfg, key, whole, S)
    assert specs["kpos"] == SH.P() and specs["k"][1] == "model"
    shard = SH.ActSharder(ranks, (), SH.TP_RULES)
    pos = torch.tensor(S + 13, dtype=torch.int32)
    want = _step(cfg, key, p, whole, pos)
    got = ranks.run(lambda r: _step(cfg, key, p, blocks[r][0], pos, shard,
                                    blocks[r][1]))
    slot = int(pos) % W
    for r, out in enumerate(got):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(blocks[r][0]["kpos"], whole["kpos"])
        size = W // N
        np.testing.assert_array_equal(
            blocks[r][0]["k"], whole["k"][:, r * size:(r + 1) * size])
    assert int(whole["kpos"][slot]) == int(pos) and slot // (W // N) == 2


def test_a_sequence_that_does_not_divide_stays_whole(ranks):
    """30 positions over 4 ranks: the spec leaves the sequence whole, no
    rank has a block of it, and each runs the one-card step on the whole
    cache."""
    cfg, key, p = _layer("qwen3-8b")
    S = 30
    assert S % N
    whole = _filled(cfg, key, S, 11)
    blocks, specs = _split(ranks, cfg, key, whole, S)
    assert all(len(sp) < 3 or sp[1] is None for sp in specs.values())
    assert all(blk == {} for _, blk in blocks)
    shard = SH.ActSharder(ranks, (), SH.TP_RULES)
    pos = torch.tensor(17, dtype=torch.int32)
    want = _step(cfg, key, p, whole, pos)
    for out in ranks.run(lambda r: _step(cfg, key, p, blocks[r][0], pos,
                                         shard, blocks[r][1])):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    assert math.prod(blocks[0][0]["k"].shape) == math.prod(whole["k"].shape)
