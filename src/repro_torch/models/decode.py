"""The JAX package's ``models/decode.py`` serving path for the ``ssd``,
``rglru`` and ``attn`` (GQA or MLA) block kinds, Whisper's cross-attention,
M-RoPE and the ``vision_patches`` frontend: cache construction, prefill and
single-token decode.

The cache mirrors the parameter layout: a pattern group's leaves are
stacked ``(groups, ...)`` under ``blocks["b{j}_{kind}"]``, remainders are
a list under ``rem``, and ``pos`` is a 0-d int32 tensor shared by the
batch.  Per block kind:

  attn   : full K/V (B, S, KV, Dh), written at ``pos``
  attn+sw: ring buffer (B, W, KV, Dh) + slot->position map ``kpos`` (W,)
           int32, -1 for an empty slot, when the sequence outgrows the
           sliding window W
  mla    : the normed latent ``lat`` (B, S, kv_lora_rank) + the roped
           shared key ``kr`` (B, S, rope_head_dim); decode attends in
           latent space (``mla_step``, the absorbed form)
  rglru  : recurrent state ``h`` (B, W) fp32 + conv tail ``conv`` (B, 3, W)
  ssd    : SSM state ``h`` (B, H, P, N) fp32 + conv tail
  cross  : the encoder's K/V ``xk``/``xv`` (B, encoder_seq, KV, Dh),
           computed once at prefill (Whisper)

Unlike the JAX package, ``decode_step`` writes into the cache it is given:
the new K/V (or latent) row at ``pos`` (``pos % W`` in the ring) with
``index_copy_`` on the 0-d ``pos`` tensor, so no step reads ``pos`` back to
the host.

Over a mesh (``shard``) each rank holds its block of every cache leaf
under the JAX package's spec (``sharding.cache_specs``, the cache part of
``launch.steps.shardings_for``): its batch block over ``pod``/``data``,
the sequence of every K/V, latent, ring and cross-attention leaf over
``model`` where it divides (``cache_seq``; whole otherwise), the SSD
state's heads over ``model``; the RG-LRU state, the conv tails and the
ring's ``kpos`` whole.  The mixers compute on TP's blocks
(``transformer.compute_defs``, as ``forward``): a token's q, K/V or
latent row is assembled over ``model`` (one row, so small), each rank
scores its sequence block of the cache, and the ranks' partial softmaxes
are combined over ``model`` in fp32 (the max, then the sum and the
weighted values: ``_combine``) before ``wo`` takes its rows.  The new
row at ``pos`` is written by the rank whose block holds it: every rank
writes at its clamped index, the others their old row back
(``_write_row``), so no step reads ``pos`` on the host.  The SSD block
steps its heads of the state and gathers ``y`` before the gated norm;
the RG-LRU steps its channels and gathers the new state whole.
``prefill`` fills the rank's blocks: K/V gathered over the heads, then
cut to the rank's sequence block (the ring rolled first); MLA's latents
computed for the rank's rows.  Both return the last position's logits
gathered whole over ``model`` (``transformer.gather_vocab``).  Under
``DECODE_RULES`` the token batch is split over ``pod`` alone while the
cache keeps its ``data`` split by batch: every ``data`` rank computes a
token's q, K/V or latent row for the whole batch (the weights resident,
``transformer._cols``), takes its batch rows of them for its cache
(``layer_blocks``' ``"rows"``), scores its ``(cache_batch, cache_seq)``
block, and gathers the attention output over those rows before ``wo``;
the SSD and RG-LRU steps step the rank's rows the same way, and the
prefill cuts every leaf to them.  Under ``SEQPAR_RULES`` the prefill's
residual stream is the rank's rows of the prompt between blocks
(``transformer.seq_split``): each block gathers its normed rows whole,
so the cache's leaves are written as before, and the last position's
row is gathered from the rank that holds it; a decode token splits no
sequence and runs as under ``TRAIN_RULES``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Pytree = Any


# ---------------------------------------------------------------------------
# cache shape definitions
# ---------------------------------------------------------------------------

def _use_ring(cfg: ModelConfig, seq: int) -> bool:
    return cfg.sliding_window > 0 and seq > cfg.sliding_window


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class LeafShape:
    """A cache leaf's shape and dtype with no tensor behind it
    (``cache_shapes(..., make=LeafShape)``): the specs and a rank's blocks
    are worked out from it without a whole-cache ``meta`` tensor, which
    the dry run would count as memory."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def layer_cache_def(cfg: ModelConfig, kind: str, batch: int, seq: int,
                    make=_meta) -> Dict[str, Any]:
    """Shape and dtype of one layer's cache, as ``meta`` tensors (or what
    ``make(shape, dtype)`` gives)."""
    dt = getattr(torch, cfg.dtype)
    Dh = cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    out: Dict[str, torch.Tensor] = {}
    if kind == "attn":
        if cfg.attention == "mla":
            out["lat"] = make((batch, seq, cfg.kv_lora_rank), dt)
            out["kr"] = make((batch, seq, cfg.rope_head_dim), dt)
        elif _use_ring(cfg, seq):
            W = cfg.sliding_window
            out["k"] = make((batch, W, KV, Dh), dt)
            out["v"] = make((batch, W, KV, Dh), dt)
            out["kpos"] = make((W,), torch.int32)
        else:
            out["k"] = make((batch, seq, KV, Dh), dt)
            out["v"] = make((batch, seq, KV, Dh), dt)
    elif kind == "rglru":
        W = cfg.d_model
        out["h"] = make((batch, W), torch.float32)
        out["conv"] = make((batch, 3, W), dt)
    elif kind == "ssd":
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        conv_ch = din + 2 * cfg.ssm_ngroups * cfg.ssm_state
        out["h"] = make((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                        torch.float32)
        out["conv"] = make((batch, cfg.ssm_conv - 1, conv_ch), dt)
    else:
        raise ValueError(kind)
    if cfg.cross_attention:
        out["xk"] = make((batch, cfg.encoder_seq, KV, Dh), dt)
        out["xv"] = make((batch, cfg.encoder_seq, KV, Dh), dt)
    return out


def cache_shapes(cfg: ModelConfig, batch: int, seq: int,
                 make=_meta) -> Pytree:
    """The cache tree as ``meta`` tensors (no storage), or as what
    ``make(shape, dtype)`` gives (``LeafShape``)."""
    period = len(cfg.block_pattern)
    groups, rem = divmod(cfg.num_layers, period)
    group_tree = {f"b{j}_{kind}": layer_cache_def(cfg, kind, batch, seq,
                                                  make)
                  for j, kind in enumerate(cfg.block_pattern)}
    stacked = T.tree_map(lambda s: make((groups,) + tuple(s.shape),
                                        s.dtype), group_tree) if groups else {}
    return {
        "blocks": stacked,
        "rem": [layer_cache_def(cfg, cfg.block_pattern[j % period], batch, seq,
                                make) for j in range(rem)],
        "pos": make((), torch.int32),
    }


def layer_cache_axes(cfg: ModelConfig, kind: str, batch: int,
                     seq: int) -> Dict[str, tuple]:
    """Logical sharding axes mirroring ``layer_cache_def`` leaf for leaf."""
    out: Dict[str, tuple] = {}
    if kind == "attn":
        if cfg.attention == "mla":
            out["lat"] = ("cache_batch", "cache_seq", None)
            out["kr"] = ("cache_batch", "cache_seq", None)
        elif _use_ring(cfg, seq):
            out["k"] = ("cache_batch", "cache_seq", None, None)  # ring W/model
            out["v"] = ("cache_batch", "cache_seq", None, None)
            out["kpos"] = (None,)
        else:
            out["k"] = ("cache_batch", "cache_seq", None, None)
            out["v"] = ("cache_batch", "cache_seq", None, None)
    elif kind == "rglru":
        out["h"] = ("cache_batch", None)
        out["conv"] = ("cache_batch", None, None)
    elif kind == "ssd":
        out["h"] = ("cache_batch", "heads", None, None)
        out["conv"] = ("cache_batch", None, None)
    if cfg.cross_attention:
        out["xk"] = ("cache_batch", "cache_seq", None, None)
        out["xv"] = ("cache_batch", "cache_seq", None, None)
    return out


def cache_logical_axes(cfg: ModelConfig, batch: int, seq: int) -> Pytree:
    """The cache tree's logical axes (a tuple a leaf; walk with
    ``is_leaf=sharding.is_axes``)."""
    period = len(cfg.block_pattern)
    groups, rem = divmod(cfg.num_layers, period)
    group_tree = {f"b{j}_{kind}": layer_cache_axes(cfg, kind, batch, seq)
                  for j, kind in enumerate(cfg.block_pattern)}
    stacked = T.tree_map(lambda ax: ("layer",) + ax, group_tree,
                         is_leaf=SH.is_axes) if groups else {}
    return {
        "blocks": stacked,
        "rem": [layer_cache_axes(cfg, cfg.block_pattern[j % period], batch,
                                 seq) for j in range(rem)],
        "pos": (None,),   # scalar; zip-trimmed to P()
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None, *,
               specs=None, mesh=None) -> Pytree:
    """A zero cache on ``device`` (None: the card); a ring's ``kpos`` is -1
    (no slot filled).  With ``specs`` (``sharding.cache_specs`` of the
    whole ``batch`` and ``seq`` on ``mesh``) each leaf is this rank's
    block."""
    dev = resolve(device)

    def mk(s: LeafShape, spec=None) -> torch.Tensor:
        fill = -1 if s.dtype == torch.int32 and len(s.shape) == 1 else 0
        shape = s.shape if spec is None else SH.block_shape(s.shape, spec,
                                                            mesh)
        return torch.full(shape, fill, dtype=s.dtype, device=dev)

    shapes = cache_shapes(cfg, batch, seq, make=LeafShape)
    if specs is None:
        return T.tree_map(mk, shapes)
    return T.tree_map(mk, shapes, specs)


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's block of a cache leaf along its dim 1 (the sequence,
    the ring's slots, or the SSD state's heads): its index among the
    ``n`` blocks over the mesh ``axes``."""
    index: int
    n: int
    axes: Tuple[str, ...]

    def lo(self, size: int) -> int:
        """The first position of the block, of ``size`` positions."""
        return self.index * size


def _axes(part) -> Tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part)


def layer_blocks(specs, mesh, batch_axes: Tuple[str, ...] = ()
                 ) -> Dict[str, Block]:
    """The ``Block`` of each of a layer's cache leaves that is split on
    dim 1 under ``specs`` (a dict of ``P``), from the rank's coordinates
    on ``mesh``, and under ``"rows"`` the rank's block of the token batch
    that its cache holds: the batch axes of the cache's spec past
    ``batch_axes``, those the tokens are split over (``DECODE_RULES``:
    the tokens over ``pod`` alone, the cache over ``pod`` and ``data``);
    none where ``specs`` is None (one card)."""
    if specs is None:
        return {}
    coords = SH.mesh_coords(mesh)
    out = {}
    for name, spec in specs.items():
        part = spec[1] if len(spec) > 1 else None
        if part is not None:
            i, n = SH.block_index(part, mesh, coords)
            out[name] = Block(i, n, _axes(part))
        if len(spec[:1]) and spec[0] is not None and "rows" not in out:
            axes = _axes(spec[0])
            nb = len(batch_axes)
            assert axes[:nb] == tuple(batch_axes), (axes, batch_axes)
            extra = coll.live_axes(mesh, axes[nb:])
            if extra:
                out["rows"] = Block(*SH.block_index(extra, mesh, coords),
                                    extra)
    return out


def _layer_blocks(specs, shard) -> Dict[str, Block]:
    """``layer_blocks`` of a layer's cache ``specs`` over ``shard`` (a
    ``sharding.ActSharder``; none on one card)."""
    return ({} if shard is None else
            layer_blocks(specs, shard.mesh, shard.batch_axes))


def _rows(t: torch.Tensor, rows: Optional[Block]) -> torch.Tensor:
    """The rank's ``rows`` (``layer_blocks``) of ``t``'s batch dim 0;
    ``t`` where None."""
    if rows is None:
        return t
    size = t.shape[0] // rows.n
    return t.narrow(0, rows.lo(size), size)


def _all_rows(t: torch.Tensor, rows: Optional[Block], ctx) -> torch.Tensor:
    """``t``, the rank's ``rows`` of the batch, gathered whole over their
    axes; ``t`` where None."""
    if rows is None:
        return t
    part = rows.axes[0] if len(rows.axes) == 1 else rows.axes
    return coll.gather_block(t, SH.P(part), ctx.shard.mesh)


def _write_row(c: torch.Tensor, at, row: torch.Tensor,
               blk: Optional[Block]) -> None:
    """``row`` (B, 1, ...) into ``c`` at ``at`` (a 0-d tensor) along dim 1.
    ``c`` a rank's ``blk`` of the whole: the rank writes at the clamped
    local index, ``row`` where its block holds ``at`` and the old row
    back elsewhere, so no rank reads ``at`` on the host."""
    if blk is None:
        c.index_copy_(1, at.reshape(1).long(), row)
        return
    size = c.shape[1]
    local = at.reshape(1).long() - blk.lo(size)
    idx = local.clamp(0, size - 1)
    inside = ((local >= 0) & (local < size)).reshape(
        (1,) * row.dim())
    c.index_copy_(1, idx, torch.where(inside, row.to(c.dtype),
                                      c.index_select(1, idx)))


def _combine(s: torch.Tensor, values, blk: Block, mesh) -> torch.Tensor:
    """The softmax over the ranks' sequence blocks of the fp32 scores
    ``s`` (..., S: this rank's block, masked positions at -1e30) applied
    to the values: ``values(p)`` gives the rank's weighted sum (..., D) of
    its block's values for weights ``p``.  The max is reduced over
    ``blk.axes`` first, then the sums of the weights and of the weighted
    values in one fp32 all-reduce: (..., D)."""
    m = s.amax(dim=-1, keepdim=True)
    coll.reduce_(m, mesh, blk.axes, dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    acc = values(p)
    flat = torch.cat([acc.reshape(-1), p.sum(dim=-1).reshape(-1)])
    coll.reduce_(flat, mesh, blk.axes)
    n = acc.numel()
    return flat[:n].reshape(acc.shape) / flat[n:].reshape(acc.shape[:-1]
                                                          + (1,))


def _whole_heads(t: torch.Tensor, heads: int, ctx) -> torch.Tensor:
    """``t`` (B, S, h, D), the rank's block of ``heads`` heads over
    ``model`` where h < heads, gathered whole; else ``t``."""
    if t.shape[2] == heads:
        return t
    return coll.gather_block(t, SH.P(None, None, "model"), ctx.shard.mesh)


def _rank_heads(o: torch.Tensor, heads: int, ctx) -> torch.Tensor:
    """This rank's ``heads`` of ``o`` (B, S, H, D), those of its block of
    ``wo``'s rows over ``model``; ``o`` where it computes all of them."""
    if heads == o.shape[2]:
        return o
    lo = T._model_index(ctx) * heads
    return o[:, :, lo:lo + heads]


def _attend(q, k, v, ok, blk: Optional[Block], ctx) -> torch.Tensor:
    """q (B, 1, H, Dh) over k (B, S, KV, Dh) and v (B, S, KV, Dv), the
    positions ``ok`` (S,) may see; where ``blk`` is given, k and v are the
    rank's sequence block and the softmax is taken over every rank's
    (``_combine``).  -> (B, 1, H, Dv) in v's dtype."""
    B, C, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, C, KV, H // KV, Dh)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, k).float() / math.sqrt(Dh)
    s = s.masked_fill(~ok, -1e30)
    if blk is None:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgcs,bskd->bckgd", w.to(v.dtype), v)
        return o.reshape(B, C, H, v.shape[-1])
    o = _combine(s, lambda p: torch.einsum("bkgcs,bskd->bkgcd", p,
                                           v.float()),
                 blk, ctx.shard.mesh)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, v.shape[-1]).to(
        v.dtype)


# ---------------------------------------------------------------------------
# single-token block steps
# ---------------------------------------------------------------------------

def _ring_attend(q, kc, vc, kpos, pos, window, blk=None, ctx=None):
    """q (B,1,H,Dh) vs ring cache (B,W,KV,Dh); kpos (W,) slot->abs position.
    Over a mesh (``blk``) the rank's block of the slots and of ``kpos``."""
    ok = (kpos >= 0) & (kpos <= pos) & ((pos - kpos) < window)
    return _attend(q, kc, vc, ok, blk, ctx)


def attn_step(cfg: ModelConfig, p, x, cache, pos, ctx, blocks=None):
    """One token of GQA attention; writes its K/V (and ring slot) into
    ``cache`` in place.  K is qk-normed and rotated before it is cached.
    Over a mesh q, k and v come from the blocks' heads and are gathered
    whole, the row is written by the rank whose ``blocks["k"]`` holds it,
    each rank scores its sequence block and the softmax is combined over
    ``model``; ``wo`` row-parallel on the rank's heads."""
    Dh = cfg.resolved_head_dim
    h = T._rms_norm(x, p["ln"], cfg.norm_eps, ctx)
    oq, okv = T._attn_outs(cfg, ctx, Dh, Dh)
    q, k, v = T._cols(h, [p["wq"], p["wk"], p["wv"]], ctx, cfg.d_model,
                      [p.get("bq"), p.get("bk"), p.get("bv")], [oq, okv, okv])
    H, KV = q.shape[-1] // Dh, k.shape[-1] // Dh
    q, k, v = T._heads(q, H, Dh), T._heads(k, KV, Dh), T._heads(v, KV, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qn"], cfg.norm_eps)
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope in ("rope", "mrope"):
        q = L.apply_rope(q, ctx.cos, ctx.sin)
        k = L.apply_rope(k, ctx.cos, ctx.sin)
    blocks = blocks or {}
    rows = blocks.get("rows")
    q = _rows(_whole_heads(q, cfg.num_heads, ctx), rows)
    k = _rows(_whole_heads(k, cfg.num_kv_heads, ctx), rows)
    v = _rows(_whole_heads(v, cfg.num_kv_heads, ctx), rows)
    blk = blocks.get("k")
    W = cfg.sliding_window
    ring = "kpos" in cache                    # ring buffer (long-context local)
    at = pos % W if ring else pos
    _write_row(cache["k"], at, k, blk)
    _write_row(cache["v"], at, v, blk)
    S = cache["k"].shape[1]
    lo = 0 if blk is None else blk.lo(S)
    if ring:
        cache["kpos"].index_copy_(0, at.reshape(1).long(), pos.reshape(1))
        o = _ring_attend(q, cache["k"], cache["v"], cache["kpos"][lo:lo + S],
                         pos, W, blk, ctx)
    elif blk is None:
        # the plain block, as the JAX package's decode attends
        o = L._attn_block(q, cache["k"], cache["v"], q_start=pos, kv_start=0,
                          causal=True, window=W if cfg.family == "hybrid"
                          else 0, kv_len=pos + 1)
    else:
        kp = lo + torch.arange(S, device=x.device)
        ok = kp <= pos
        if cfg.family == "hybrid" and W:
            ok &= (pos - kp) < W
        o = _attend(q, cache["k"], cache["v"], ok, blk, ctx)
    o = _rank_heads(_all_rows(o, rows, ctx), H, ctx)
    return x + T._row_parallel(o.reshape(x.shape[0], 1, H * Dh), p["wo"],
                               ctx, H < cfg.num_heads)


def mla_step(cfg: ModelConfig, p, x, cache, pos, ctx, blocks=None):
    """One token of MLA in the absorbed form: writes its latent and rope
    key into ``cache`` in place, folds ``wk_b`` into q, takes the scores and
    the context in latent space over positions 0..pos, then ``wv_b``.  Plain
    einsums, as the JAX package decodes every attention plainly.  Over a
    mesh q is folded through the rank's heads of ``wk_b`` and gathered
    whole, each rank scores its block of ``lat``/``kr`` and the softmax is
    combined over ``model``; ``wv_b`` and ``wo`` on the rank's heads.
    Under ``DECODE_RULES`` ``wk_b`` and ``wv_b`` stay resident, their
    latent rows over ``data`` and their flat columns over ``model``
    (``_absorb_q``, ``_absorb_o``), and the rank scores its batch rows
    of the cache, the context gathered over them before ``wv_b``."""
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    B = x.shape[0]
    h = T._rms_norm(x, p["ln"], cfg.norm_eps, ctx)
    cq = L.rms_norm(T.mla_q_latent(cfg, p, h, ctx), p["q_ln"], cfg.norm_eps)
    oq, _ = T._attn_outs(cfg, ctx, dn + dr, 0)
    (q,) = T._cols(cq, [p["wq_b"]], ctx, cfg.q_lora_rank, outs=[oq])
    H = q.shape[-1] // (dn + dr)
    q = T._heads(q, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, ctx.cos_r, ctx.sin_r)
    lat_t, kr_t = T.mla_latent(cfg, p, h, ctx)
    blocks = blocks or {}
    blk, rows = blocks.get("lat"), blocks.get("rows")
    _write_row(cache["lat"], pos, _rows(lat_t, rows), blk)
    _write_row(cache["kr"], pos, _rows(kr_t, rows), blk)
    lat, kr = cache["lat"], cache["kr"]
    resident = ctx.shard is not None and SH.resident(ctx.shard.rules)
    if resident:
        q_lat = _absorb_q(cfg, q_nope, p["wk_b"], ctx)
    else:
        wk = p["wk_b"].reshape(r, H, dn)
        # absorb wk into q: q_lat (B,1,H,r)
        q_lat = torch.einsum("bchn,rhn->bchr", q_nope, wk.to(q_nope.dtype))
        q_lat = _whole_heads(q_lat, cfg.num_heads, ctx)
    q_lat = _rows(q_lat, rows)
    q_rope = _rows(_whole_heads(q_rope, cfg.num_heads, ctx), rows)
    s = (torch.einsum("bchr,bsr->bhcs", q_lat, lat)
         + torch.einsum("bchp,bsp->bhcs", q_rope, kr)).float()
    s = s / math.sqrt(dn + dr)
    S = lat.shape[1]
    lo = 0 if blk is None else blk.lo(S)
    valid = lo + torch.arange(S, device=x.device) <= pos
    s = s.masked_fill(~valid, -1e30)
    if blk is None:
        w = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhcs,bsr->bchr", w.to(lat.dtype), lat)
    else:
        ctx_lat = _combine(s, lambda p_: torch.einsum(
            "bhcs,bsr->bhcr", p_, lat.float()), blk, ctx.shard.mesh)
        ctx_lat = ctx_lat.transpose(1, 2).to(lat.dtype)
    ctx_lat = _all_rows(ctx_lat, rows, ctx)
    if resident:
        o = _absorb_o(cfg, ctx_lat, p["wv_b"], ctx)
        return x + T._row_parallel(o, p["wo"], ctx,
                                   o.shape[-1] < cfg.num_heads * dv)
    ctx_lat = _rank_heads(ctx_lat, H, ctx)
    wv = p["wv_b"].reshape(r, H, dv)
    o = torch.einsum("bchr,rhv->bchv", ctx_lat, wv.to(ctx_lat.dtype))
    return x + T._row_parallel(o.reshape(B, 1, H * dv), p["wo"], ctx,
                               H < cfg.num_heads)


def _block_start(size: int, width: int, rule: str, ctx):
    """(the first index, the axes) of this rank's block of ``size`` along
    a weight's dim of ``width`` split over ``rule``'s axes (``tp``: a
    flat block of heads x head dim; ``fsdp``: latent rows); (0, ()) where
    the rank holds the whole dim."""
    if size == width:
        return 0, ()
    mesh = ctx.shard.mesh
    axes = SH._fit_axes(width, ctx.shard.rules[rule], mesh)
    return T._axes_block(axes, mesh)[0] * size, axes


def _absorb_q(cfg: ModelConfig, q_nope, wk_b, ctx):
    """q_lat (B, 1, H, r) whole, ``q_nope`` folded through this rank's
    resident block of ``wk_b`` (its latent rows over ``data``, a flat block
    of its heads' nope columns over ``model``, which need not hold whole
    heads): the rank's columns of q (``q_nope`` the rank's heads or all
    of them) contracted within each head they touch in fp32, the partial
    heads summed over ``model``, the latent rows gathered over ``data``,
    rounded once to q's dtype."""
    dn, H = cfg.nope_head_dim, cfg.num_heads
    mesh = ctx.shard.mesh
    B, C, Hq, _ = q_nope.shape
    width = wk_b.shape[-1]
    lo, axes = _block_start(width, H * dn, "tp", ctx)
    off = 0 if Hq == H else lo               # q's first flat column
    qf = q_nope.reshape(B, C, Hq * dn)[..., lo - off:lo - off + width]
    h0 = lo // dn
    ht = (lo + width - 1) // dn - h0 + 1
    head = (lo + torch.arange(width, device=qf.device)) // dn - h0
    mask = F.one_hot(head, ht).T.float()                        # (ht, w)
    part = (qf.float()[:, :, None, :] * mask) @ wk_b.float().T  # (B,C,ht,r')
    q_lat = part.new_zeros((B, C, H, wk_b.shape[0]))
    q_lat[:, :, h0:h0 + ht] = part
    q_lat = T._psum(q_lat, mesh, axes)
    _, raxes = _block_start(wk_b.shape[0], cfg.kv_lora_rank, "fsdp", ctx)
    if raxes:
        q_lat = T._gather_last(q_lat, raxes, mesh)
    return q_lat.to(q_nope.dtype)


def _absorb_o(cfg: ModelConfig, ctx_lat, wv_b, ctx):
    """(B, 1, w): the context ``ctx_lat`` (B, 1, H, r, every head and
    latent row) through this rank's resident block of ``wv_b``: its flat
    block of w value columns (heads x v_head_dim over ``model``, the rows
    of ``wo`` the rank holds), each contracted over the rank's latent rows
    in fp32 and summed over ``data``, rounded once."""
    dv = cfg.v_head_dim
    width = wv_b.shape[-1]
    lo, _ = _block_start(width, cfg.num_heads * dv, "tp", ctx)
    r0, raxes = _block_start(wv_b.shape[0], cfg.kv_lora_rank, "fsdp", ctx)
    head = (lo + torch.arange(width, device=ctx_lat.device)) // dv
    sel = ctx_lat[:, :, head, r0:r0 + wv_b.shape[0]].float()   # (B,1,w,r')
    o = torch.einsum("bcwr,rw->bcw", sel, wv_b.float())
    return T._psum(o, ctx.shard.mesh, raxes).to(ctx_lat.dtype)


def cross_step(cfg: ModelConfig, p, x, cache, ctx, blocks=None):
    """One token's cross-attention over the encoder's cached K/V: the plain
    ``_attn_block``, as the JAX package's decode has it.  Over a mesh q is
    gathered whole over the heads, each rank scores its block of
    ``xk``/``xv`` and the softmax is combined over ``model``; ``wo``
    row-parallel on the rank's heads."""
    Dh = cfg.resolved_head_dim
    h = T._rms_norm(x, p["ln"], cfg.norm_eps, ctx)
    oq, _ = T._attn_outs(cfg, ctx, Dh, Dh)
    (q,) = T._cols(h, [p["wq"]], ctx, cfg.d_model, outs=[oq])
    H = q.shape[-1] // Dh
    blocks = blocks or {}
    rows = blocks.get("rows")
    q = _rows(_whole_heads(T._heads(q, H, Dh), cfg.num_heads, ctx), rows)
    blk = blocks.get("xk")
    if blk is None:
        o = L._attn_block(q, cache["xk"], cache["xv"], q_start=0,
                          kv_start=0, causal=False, window=0, kv_len=None)
    else:
        ok = torch.ones(cache["xk"].shape[1], dtype=torch.bool,
                        device=x.device)
        o = _attend(q, cache["xk"], cache["xv"], ok, blk, ctx)
    o = _rank_heads(_all_rows(o, rows, ctx), H, ctx)
    return x + T._row_parallel(o.reshape(x.shape[0], 1, H * Dh), p["wo"],
                               ctx, H < cfg.num_heads)


def rglru_step_block(cfg: ModelConfig, p, x, cache, ctx, blocks=None):
    """One token through an RG-LRU mixer; returns (x, new h and conv).  The
    new state is ``rglru_step``'s, in x's dtype, stored as fp32: in bf16
    the carried state is rounded to bf16 every token, as in the JAX
    package.  Over ``model`` (``wx``'s block narrower than the width) a
    rank steps its channels of the whole state, its gates' rows summed
    over ``model`` as ``transformer.rglru_forward`` sums them, ``wo``
    row-parallel; the new state and conv tail are gathered whole.  Where
    the cache holds the rank's batch rows (``blocks["rows"]``,
    ``DECODE_RULES``), the rank steps those rows and gathers their output
    over them before ``wo``."""
    h = T._rms_norm(x, p["ln"], cfg.norm_eps, ctx)
    gy, xb = T._cols(h, [p["wy"], p["wx"]], ctx, cfg.d_model)
    rows = (blocks or {}).get("rows")
    gate = _rows(L.act_fn("gelu")(gy)[:, 0], rows)
    xb_t = _rows(xb[:, 0], rows)                                # (B,Wl)
    Wl, W = xb_t.shape[-1], p["wga"].shape[-1]
    lo = 0 if Wl == W else T._model_index(ctx) * Wl
    cut = slice(lo, lo + Wl)
    hist = torch.cat([cache["conv"][..., cut].to(x.dtype), xb_t[:, None]],
                     dim=1)
    w = p["conv_w"]
    conv = sum(hist[:, i] * w[i][None, :] for i in range(w.shape[0]))
    if Wl == W:
        ga = conv @ p["wga"].to(x.dtype) + p["bga"].to(x.dtype)
        gx = conv @ p["wgx"].to(x.dtype) + p["bgx"].to(x.dtype)
        log_a = p["log_a"]
    else:
        g = T._row_parallel(conv, torch.cat([p["wga"], p["wgx"]], dim=1),
                            ctx, True)
        ga = g[..., cut] + p["bga"][cut].to(g.dtype)
        gx = g[..., W:][..., cut] + p["bgx"][cut].to(g.dtype)
        log_a = p["log_a"][cut]
    hn = L.rglru_step(conv, gx, ga, log_a, cache["h"][:, cut])
    y = T._row_parallel(_all_rows(hn.to(x.dtype) * gate, rows, ctx)[:, None],
                        p["wo"], ctx, Wl < W)
    hn, tail = hn.float(), hist[:, 1:]
    if Wl < W:
        mesh = ctx.shard.mesh
        hn = coll.gather_block(hn, SH.P(None, "model"), mesh)
        tail = coll.gather_block(tail, SH.P(None, None, "model"), mesh)
    return x + y, {"h": hn, "conv": tail}


def ssd_step_block(cfg: ModelConfig, p, x, cache, ctx, blocks=None):
    """One token through a Mamba-2 mixer; returns (x, new h and conv).
    Over a mesh whose ``blocks["h"]`` splits the state's heads, the rank
    computes the whole ``zxbcdt`` and conv (the SSD block is computed
    whole, ``transformer.compute_defs``), steps its heads, and gathers
    ``y`` over ``model`` before the gated norm over the whole width.
    Under ``DECODE_RULES`` the block stays resident: ``in_proj``'s
    output row and the conv of the rank's ``conv_w`` channels are
    gathered over ``model``, the rank steps its batch rows
    (``blocks["rows"]``) and heads, and the normed rows are gathered
    before ``out_proj``, row-parallel."""
    D = cfg.d_model
    din = cfg.ssm_expand * D
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = din // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = T._rms_norm(x, p["ln"], cfg.norm_eps, ctx)
    (zxbcdt,) = T._cols(h, [p["in_proj"]], ctx, D,
                        outs=[2 * din + 2 * G * N + H])
    blocks = blocks or {}
    rows = blocks.get("rows")
    zxbcdt = _rows(zxbcdt[:, 0], rows)                          # (B, ...)
    z, xs, BC, dt = torch.split(zxbcdt, [din, din, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xs, BC], dim=-1)
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in[:, None]], dim=1)
    w = p["conv_w"]
    taps, axes = hist, ()
    if w.shape[-1] < hist.shape[-1]:
        # the rank's channels of the resident conv_w, gathered after
        mesh = ctx.shard.mesh
        axes = SH._fit_axes(hist.shape[-1], ctx.shard.rules["tp"], mesh)
        taps = T._narrow(hist, -1, w.shape[-1], axes, mesh)
    conv = sum(taps[:, i] * w[i][None, :] for i in range(w.shape[0]))
    if axes:
        conv = T._gather_last(conv, axes, ctx.shard.mesh)
    conv = F.silu(conv)
    xs, Bm, Cm = torch.split(conv, [din, G * N, G * N], dim=-1)
    xt = xs.reshape(-1, H, P)
    Bt = Bm.reshape(-1, G, N)
    Ct = Cm.reshape(-1, G, N)
    dtt = F.softplus(dt.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["a_log"].float())
    d_skip = p["d_skip"]
    blk = blocks.get("h")
    if blk is not None:
        # the rank's heads, B and C taken per head
        Hl = cache["h"].shape[1]
        heads = slice(blk.lo(Hl), blk.lo(Hl) + Hl)
        Bt = Bt.repeat_interleave(H // G, dim=1)[:, heads]
        Ct = Ct.repeat_interleave(H // G, dim=1)[:, heads]
        xt, dtt, A, d_skip = xt[:, heads], dtt[:, heads], A[heads], \
            d_skip[heads]
    y, hn = L.ssd_step(xt, dtt, A, Bt, Ct, cache["h"])
    y = y + xt * d_skip.to(x.dtype)[None, :, None]
    if blk is not None:
        y = coll.gather_block(y, SH.P(None, "model"), ctx.shard.mesh)
    y = L.rms_norm(y.reshape(-1, din) * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = T._row_parallel(_all_rows(y, rows, ctx)[:, None], p["out_proj"],
                          ctx, False)
    return x + out, {"h": hn, "conv": hist[:, 1:]}


def block_step(cfg: ModelConfig, kind: str, p, x, cache, pos, ctx,
               blocks=None):
    """One token through one block; writes the block's new state into
    ``cache`` (its tensors, in place) and returns (x, cache).  ``blocks``:
    ``layer_blocks`` of the layer's cache over a mesh."""
    if kind == "attn":
        step = mla_step if cfg.attention == "mla" else attn_step
        x = step(cfg, p["attn"], x, cache, pos, ctx, blocks)
    else:
        if kind == "rglru":
            x, new = rglru_step_block(cfg, p["rec"], x, cache, ctx, blocks)
        elif kind == "ssd":
            x, new = ssd_step_block(cfg, p["ssd"], x, cache, ctx, blocks)
        else:
            raise ValueError(kind)
        cache["h"].copy_(new["h"])
        cache["conv"].copy_(new["conv"])
    if "xattn" in p and "xk" in cache:
        x = cross_step(cfg, p["xattn"], x, cache, ctx, blocks)
    if "ffn" in p:
        x = T.ffn_forward(cfg, p["ffn"], x, ctx)
    return x, cache


# ---------------------------------------------------------------------------
# decode step (one new token for the whole batch)
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache, tokens, *, shard=None,
                specs=None) -> Tuple[torch.Tensor, Pytree]:
    """tokens (B, 1) at position cache['pos'] -> (logits (B,1,V), cache).

    The cache is updated in place (the JAX package returns a new tree):
    every layer's state, conv tail and K/V row, and ``pos``, which advances
    by one.  The returned cache is the one passed in.  ``shard``: a
    mesh's ``sharding.ActSharder``, as ``T.forward`` takes it, each
    layer's blocks resharded to TP's compute blocks as the loop runs it
    (``_layers``); ``specs``: then the cache's (``sharding.cache_specs``
    of the whole batch and the cache's whole sequence), of which ``cache``
    holds this rank's blocks.  One token splits no sequence: the residual
    stream stays whole under ``SEQPAR_RULES`` too (``T.seq_split`` gives
    (), as JAX's ``"act"`` constraint finds no axis that divides 1)."""
    pos = cache["pos"]
    B = tokens.shape[0]
    place = T.placement(cfg, shard)
    x = T.embed_tokens(cfg, params, tokens, place, shard)
    if cfg.rope == "learned":
        # clamped as JAX's gather clamps, so no step reads pos on the host
        at = pos.reshape(1).clamp(max=cfg.max_position - 1).long()
        x = x + T._to_hidden(T.computed(params["pos_embed"], place,
                                        "pos_embed").index_select(0, at).to(
            x.dtype)[None], T.Ctx(cfg=cfg, shard=shard))
    ctx = T.rope_ctx(cfg, T.default_positions(cfg, pos.expand(B, 1)))
    ctx.shard, ctx.place = shard, place
    for kind, lp, path, lc, ls in _layers(cfg, params, cache, specs):
        x, _ = block_step(cfg, kind, T.computed(lp, place, *path), x, lc,
                          pos, ctx, _layer_blocks(ls, shard))
    pos.add_(1)
    return T.gather_vocab(cfg, T.unembed(cfg, params, x, place, shard),
                          shard), cache


def _layers(cfg: ModelConfig, params, cache, specs=None):
    """(kind, the layer's stored leaves, their path in the parameters, its
    cache entry, its cache specs or None) of every layer in order.  The
    loops reshard a layer's leaves as they call its block (``T.computed``),
    so its gathered leaves are a temporary: a rank holds one layer's at a
    time."""
    pattern = cfg.block_pattern
    blocks = params["blocks"]
    for g in range(T.num_groups(blocks)):
        gp, gc = T.group_params(blocks, g), T.group_params(cache["blocks"], g)
        for j, kind in enumerate(pattern):
            key = f"b{j}_{kind}"
            ls = None if specs is None else {
                n: SH.P(*sp[1:]) for n, sp in specs["blocks"][key].items()}
            yield kind, gp[key], ("blocks", key), gc[key], ls
    for j, (lp, lc) in enumerate(zip(params["rem"], cache["rem"])):
        ls = None if specs is None else specs["rem"][j]
        yield pattern[j % len(pattern)], lp, ("rem", j), lc, ls


# ---------------------------------------------------------------------------
# prefill (build the cache for a whole prompt)
# ---------------------------------------------------------------------------

def _attn_prefill_kv(cfg, p, h, ctx):
    """The prompt's K (qk-normed, rotated) and V for the cache, of the
    block's kv heads."""
    Dh = cfg.resolved_head_dim
    _, okv = T._attn_outs(cfg, ctx, Dh, Dh)
    k, v = T._cols(h, [p["wk"], p["wv"]], ctx, cfg.d_model,
                   [p.get("bk"), p.get("bv")], [okv, okv])
    k, v = T._heads(k, k.shape[-1] // Dh, Dh), T._heads(v, v.shape[-1] // Dh,
                                                         Dh)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope in ("rope", "mrope"):
        k = L.apply_rope(k, ctx.cos, ctx.sin)
    return k, v


def _cut(t: torch.Tensor, blk: Optional[Block]) -> torch.Tensor:
    """The rank's ``blk`` of ``t``'s whole dim 1 (``t`` where None)."""
    if blk is None:
        return t
    size = t.shape[1] // blk.n
    return t.narrow(1, blk.lo(size), size)


def block_prefill(cfg: ModelConfig, kind: str, p, x, ctx: T.Ctx,
                  blocks=None):
    """Forward one block over the full prompt, returning its cache entry:
    over a mesh the rank's ``blocks`` (``layer_blocks``) of each leaf, its
    batch ``rows`` among them (``DECODE_RULES``: each leaf computed for
    the whole token batch, then cut).  Under ``SEQPAR_RULES`` ``x`` is
    the rank's rows of the prompt (``ctx.seq``) and so is the block's
    output; the cache's leaves come from the normed rows gathered
    whole."""
    blocks = blocks or {}
    cache: Dict[str, torch.Tensor] = {}
    if kind == "attn" and cfg.attention == "mla":
        h = T._seq_gather(T._rms_norm(x, p["attn"]["ln"], cfg.norm_eps, ctx),
                          ctx)
        blk, rows = blocks.get("lat"), ctx
        if blk is not None:
            # the latents of the rank's rows: their norm is over r alone
            h = _cut(h, blk)
            rows = dataclasses.replace(ctx, cos_r=_cut(ctx.cos_r, blk),
                                       sin_r=_cut(ctx.sin_r, blk))
        cache["lat"], cache["kr"] = T.mla_latent(cfg, p["attn"], h, rows)
        x = T.mla_forward(cfg, p["attn"], x, ctx)
    elif kind == "attn":
        h = T._seq_gather(T._rms_norm(x, p["attn"]["ln"], cfg.norm_eps, ctx),
                          ctx)
        S = h.shape[1]
        k, v = _attn_prefill_kv(cfg, p["attn"], h, ctx)
        k = _whole_heads(k, cfg.num_kv_heads, ctx)
        v = _whole_heads(v, cfg.num_kv_heads, ctx)
        blk = blocks.get("k")
        if _use_ring(cfg, S):
            W = cfg.sliding_window
            shift = (S - W) % W          # align slots to p % W
            cache["k"] = _cut(torch.roll(k[:, S - W:], shift, dims=1), blk)
            cache["v"] = _cut(torch.roll(v[:, S - W:], shift, dims=1), blk)
            cache["kpos"] = torch.roll(
                torch.arange(S - W, S, dtype=torch.int32, device=x.device),
                shift)
        else:
            cache["k"], cache["v"] = _cut(k, blk), _cut(v, blk)
        window = cfg.sliding_window if cfg.family == "hybrid" else 0
        x = T.attn_forward(cfg, p["attn"], x, ctx, window=window)
    elif kind == "rglru":
        x, (hl, conv) = T.rglru_forward(cfg, p["rec"], x, ctx)
        if hl.shape[-1] < cfg.d_model:
            # the rank's channels: the state is whole on every rank
            mesh = ctx.shard.mesh
            hl = coll.gather_block(hl, SH.P(None, "model"), mesh)
            conv = coll.gather_block(conv, SH.P(None, None, "model"), mesh)
        # the last state in x's dtype, as the JAX package keeps it
        cache["h"], cache["conv"] = hl.float(), conv
    elif kind == "ssd":
        x, (hl, conv) = T.ssd_forward(cfg, p["ssd"], x, ctx)
        cache["h"], cache["conv"] = _cut(hl, blocks.get("h")), conv
    else:
        raise ValueError(kind)
    if "xattn" in p and ctx.enc_out is not None:
        # the encoder's K/V once, into the cache; the prompt attends to them
        # through K5 (non-causal), on the block's kv heads
        xp = p["xattn"]
        xk, xv = T.cross_kv(cfg, xp, ctx)
        blk = blocks.get("xk")
        cache["xk"] = _cut(_whole_heads(xk, cfg.num_kv_heads, ctx), blk)
        cache["xv"] = _cut(_whole_heads(xv, cfg.num_kv_heads, ctx), blk)
        x = T.attn_forward(cfg, xp, x, ctx, kv_override=(xk, xv), cross=True)
    if "ffn" in p:
        x = T.ffn_forward(cfg, p["ffn"], x, ctx)
    rows = blocks.get("rows")
    return x, {k: t if t.dim() < 2 else _rows(t, rows)
               for k, t in cache.items()}


def prefill(cfg: ModelConfig, params, tokens, *, encoder_frames=None,
            frontend_embeds=None, shard=None, specs=None):
    """Run the prompt, returning (logits_last (B,1,V), cache).  With
    ``encoder_frames`` the encoder runs first and each block's ``xk``/``xv``
    hold its K/V; without them they stay zero and decode's cross-attention
    adds nothing, as the JAX package's cache, which then has no such
    leaves, gives it.  ``frontend_embeds`` (B, F, D), the patch embeddings,
    replace the prompt's first F positions (``T.splice_frontend``); the
    rotary positions are 0..S-1, on all three channels for M-RoPE.
    ``shard``: a mesh's ``sharding.ActSharder``, as ``T.forward`` takes
    it; each layer resharded as the loop runs it (``_layers``), the
    residual stream the rank's rows of the prompt between blocks where
    the rules split it (``SEQPAR_RULES``, ``T.seq_split``).
    ``specs``: then the specs of the whole prompts' cache
    (``sharding.cache_specs``), of which the cache returned holds this
    rank's blocks.  The last position's logits are every rank's: over a
    split stream its row, which the last rank along the split holds, is
    gathered first."""
    B, S = tokens.shape
    place = T.placement(cfg, shard)
    seq = T.seq_split(shard, S)
    x = T.splice_frontend(cfg, params, T.embed_tokens(cfg, params, tokens,
                                                      place, shard, seq),
                          frontend_embeds, place, shard, seq)
    x = T.add_positions(cfg, params, x, place, shard, seq)
    ctx = T.rope_ctx(cfg, T.default_positions(
        cfg, torch.arange(S, device=tokens.device)[None].expand(B, S)))
    ctx.shard, ctx.place, ctx.seq = shard, place, seq
    ctx = T.encoder_ctx(cfg, params, ctx, encoder_frames, x.dtype)
    if specs is None:
        cache = init_cache(cfg, B, S, device=tokens.device)
    else:
        Bg = B * math.prod(SH.mesh_shape(shard.mesh)[a]
                           for a in shard.batch_axes)
        cache = init_cache(cfg, Bg, S, device=tokens.device, specs=specs,
                           mesh=shard.mesh)
    cache["pos"].fill_(S)
    for kind, lp, path, lc, ls in _layers(cfg, params, cache, specs):
        x, c = block_prefill(cfg, kind, T.computed(lp, place, *path), x, ctx,
                             _layer_blocks(ls, shard))
        for name, t in c.items():
            lc[name].copy_(t)
    # each rank's last row gathered: the last of them is position S - 1
    last = T._seq_gather(x[:, -1:], ctx)[:, -1:]
    logits = T.unembed(cfg, params, last, place, shard)
    return T.gather_vocab(cfg, logits, shard), cache
