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

Over a mesh (``shard``) the mixers keep their blocks whole
(``transformer.placement(..., mixers=False)``): the cache splits no head
(the JAX package's cache splits its sequence over ``model``,
``cache_seq``, which is not ported), so attention, MLA's absorbed step,
the RG-LRU, the SSD block and cross-attention run as on one card.  The
FFN, the embedding and the head take TP's compute split, and both
``prefill`` and ``decode_step`` return the last position's logits gathered
whole over ``model`` (``transformer.gather_vocab``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
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


def layer_cache_def(cfg: ModelConfig, kind: str, batch: int,
                    seq: int) -> Dict[str, torch.Tensor]:
    """Shape and dtype of one layer's cache, as ``meta`` tensors."""
    dt = getattr(torch, cfg.dtype)
    Dh = cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    out: Dict[str, torch.Tensor] = {}
    if kind == "attn":
        if cfg.attention == "mla":
            out["lat"] = _meta((batch, seq, cfg.kv_lora_rank), dt)
            out["kr"] = _meta((batch, seq, cfg.rope_head_dim), dt)
        elif _use_ring(cfg, seq):
            W = cfg.sliding_window
            out["k"] = _meta((batch, W, KV, Dh), dt)
            out["v"] = _meta((batch, W, KV, Dh), dt)
            out["kpos"] = _meta((W,), torch.int32)
        else:
            out["k"] = _meta((batch, seq, KV, Dh), dt)
            out["v"] = _meta((batch, seq, KV, Dh), dt)
    elif kind == "rglru":
        W = cfg.d_model
        out["h"] = _meta((batch, W), torch.float32)
        out["conv"] = _meta((batch, 3, W), dt)
    elif kind == "ssd":
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        conv_ch = din + 2 * cfg.ssm_ngroups * cfg.ssm_state
        out["h"] = _meta((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                         torch.float32)
        out["conv"] = _meta((batch, cfg.ssm_conv - 1, conv_ch), dt)
    else:
        raise ValueError(kind)
    if cfg.cross_attention:
        out["xk"] = _meta((batch, cfg.encoder_seq, KV, Dh), dt)
        out["xv"] = _meta((batch, cfg.encoder_seq, KV, Dh), dt)
    return out


def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> Pytree:
    """The cache tree as ``meta`` tensors (no storage)."""
    period = len(cfg.block_pattern)
    groups, rem = divmod(cfg.num_layers, period)
    group_tree = {f"b{j}_{kind}": layer_cache_def(cfg, kind, batch, seq)
                  for j, kind in enumerate(cfg.block_pattern)}
    stacked = T.tree_map(lambda s: _meta((groups,) + tuple(s.shape),
                                         s.dtype), group_tree) if groups else {}
    return {
        "blocks": stacked,
        "rem": [layer_cache_def(cfg, cfg.block_pattern[j % period], batch, seq)
                for j in range(rem)],
        "pos": _meta((), torch.int32),
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


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Pytree:
    """A zero cache on ``device`` (None: the card); a ring's ``kpos`` is -1
    (no slot filled)."""
    dev = resolve(device)

    def mk(s: torch.Tensor) -> torch.Tensor:
        fill = -1 if s.dtype == torch.int32 and s.dim() == 1 else 0
        return torch.full(s.shape, fill, dtype=s.dtype, device=dev)

    return T.tree_map(mk, cache_shapes(cfg, batch, seq))


# ---------------------------------------------------------------------------
# single-token block steps
# ---------------------------------------------------------------------------

def _ring_attend(q, kc, vc, kpos, pos, window):
    """q (B,1,H,Dh) vs ring cache (B,W,KV,Dh); kpos (W,) slot->abs position."""
    B, _, H, Dh = q.shape
    KV = kc.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, Dh)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, kc).float() / math.sqrt(Dh)
    ok = (kpos >= 0) & (kpos <= pos) & ((pos - kpos) < window)
    s = s.masked_fill(~ok, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgcs,bskd->bckgd", w.to(vc.dtype), vc)
    return o.reshape(B, 1, H, vc.shape[-1])


def attn_step(cfg: ModelConfig, p, x, cache, pos, ctx):
    """One token of GQA attention; writes its K/V (and ring slot) into
    ``cache`` in place.  K is qk-normed and rotated before it is cached."""
    Dh = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = T._heads(T._proj(h, p["wq"], p.get("bq")), H, Dh)
    k = T._heads(T._proj(h, p["wk"], p.get("bk")), KV, Dh)
    v = T._heads(T._proj(h, p["wv"], p.get("bv")), KV, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qn"], cfg.norm_eps)
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope in ("rope", "mrope"):
        q = L.apply_rope(q, ctx.cos, ctx.sin)
        k = L.apply_rope(k, ctx.cos, ctx.sin)
    window = cfg.sliding_window if cfg.family == "hybrid" else 0
    if "kpos" in cache:                       # ring buffer (long-context local)
        W = cfg.sliding_window
        slot = (pos % W).reshape(1).long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        cache["kpos"].index_copy_(0, slot, pos.reshape(1))
        o = _ring_attend(q, cache["k"], cache["v"], cache["kpos"], pos, W)
    else:
        at = pos.reshape(1).long()
        cache["k"].index_copy_(1, at, k)
        cache["v"].index_copy_(1, at, v)
        o = L._attn_block(q, cache["k"], cache["v"], q_start=pos, kv_start=0,
                          causal=True, window=window, kv_len=pos + 1)
    return x + T._proj(o.reshape(x.shape[0], 1, H * Dh), p["wo"])


def mla_step(cfg: ModelConfig, p, x, cache, pos, ctx):
    """One token of MLA in the absorbed form: writes its latent and rope
    key into ``cache`` in place, folds ``wk_b`` into q, takes the scores and
    the context in latent space over positions 0..pos, then ``wv_b``.  Plain
    einsums, as the JAX package decodes every attention plainly."""
    H = cfg.num_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    B = x.shape[0]
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    cq = L.rms_norm(T._proj(h, p["wq_a"]), p["q_ln"], cfg.norm_eps)
    q = T._heads(T._proj(cq, p["wq_b"]), H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, ctx.cos_r, ctx.sin_r)
    lat_t, kr_t = T.mla_latent(cfg, p, h, ctx)
    at = pos.reshape(1).long()
    cache["lat"].index_copy_(1, at, lat_t)
    cache["kr"].index_copy_(1, at, kr_t)
    lat, kr = cache["lat"], cache["kr"]
    wk = p["wk_b"].reshape(r, H, dn)
    wv = p["wv_b"].reshape(r, H, dv)
    # absorb wk into q: q_lat (B,1,H,r)
    q_lat = torch.einsum("bchn,rhn->bchr", q_nope, wk.to(q_nope.dtype))
    s = (torch.einsum("bchr,bsr->bhcs", q_lat, lat)
         + torch.einsum("bchp,bsp->bhcs", q_rope, kr)).float()
    s = s / math.sqrt(dn + dr)
    valid = torch.arange(lat.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, -1e30)
    w = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhcs,bsr->bchr", w.to(lat.dtype), lat)
    o = torch.einsum("bchr,rhv->bchv", ctx_lat, wv.to(ctx_lat.dtype))
    return x + T._proj(o.reshape(B, 1, H * dv), p["wo"])


def cross_step(cfg: ModelConfig, p, x, cache, ctx):
    """One token's cross-attention over the encoder's cached K/V: the plain
    ``_attn_block``, as the JAX package's decode has it."""
    Dh = cfg.resolved_head_dim
    H = cfg.num_heads
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = T._heads(T._proj(h, p["wq"]), H, Dh)
    o = L._attn_block(q, cache["xk"], cache["xv"], q_start=0, kv_start=0,
                      causal=False, window=0, kv_len=None)
    return x + T._proj(o.reshape(x.shape[0], 1, H * Dh), p["wo"])


def rglru_step_block(cfg: ModelConfig, p, x, cache, ctx):
    """One token through an RG-LRU mixer; returns (x, new h and conv).  The
    new state is ``rglru_step``'s, in x's dtype, stored as fp32: in bf16
    the carried state is rounded to bf16 every token, as in the JAX
    package."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    gate = L.act_fn("gelu")(T._proj(h, p["wy"]))[:, 0]
    xb_t = T._proj(h, p["wx"])[:, 0]                            # (B,W)
    hist = torch.cat([cache["conv"].to(x.dtype), xb_t[:, None]], dim=1)
    w = p["conv_w"]
    conv = sum(hist[:, i] * w[i][None, :] for i in range(w.shape[0]))
    ga = conv @ p["wga"].to(x.dtype) + p["bga"].to(x.dtype)
    gx = conv @ p["wgx"].to(x.dtype) + p["bgx"].to(x.dtype)
    hn = L.rglru_step(conv, gx, ga, p["log_a"], cache["h"])
    y = T._proj((hn.to(x.dtype) * gate)[:, None], p["wo"])
    return x + y, {"h": hn.float(), "conv": hist[:, 1:]}


def ssd_step_block(cfg: ModelConfig, p, x, cache, ctx):
    D = cfg.d_model
    din = cfg.ssm_expand * D
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = din // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = T._proj(h, p["in_proj"])[:, 0]                     # (B, ...)
    z, xs, BC, dt = torch.split(zxbcdt, [din, din, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xs, BC], dim=-1)
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in[:, None]], dim=1)
    w = p["conv_w"]
    conv = F.silu(sum(hist[:, i] * w[i][None, :] for i in range(w.shape[0])))
    xs, Bm, Cm = torch.split(conv, [din, G * N, G * N], dim=-1)
    xt = xs.reshape(-1, H, P)
    Bt = Bm.reshape(-1, G, N)
    Ct = Cm.reshape(-1, G, N)
    dtt = F.softplus(dt.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["a_log"].float())
    y, hn = L.ssd_step(xt, dtt, A, Bt, Ct, cache["h"])
    y = y + xt * p["d_skip"].to(x.dtype)[None, :, None]
    y = L.rms_norm(y.reshape(-1, din) * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = T._proj(y[:, None], p["out_proj"])
    return x + out, {"h": hn, "conv": hist[:, 1:]}


def block_step(cfg: ModelConfig, kind: str, p, x, cache, pos, ctx):
    """One token through one block; writes the block's new state into
    ``cache`` (its tensors, in place) and returns (x, cache)."""
    if kind == "attn":
        step = mla_step if cfg.attention == "mla" else attn_step
        x = step(cfg, p["attn"], x, cache, pos, ctx)
    else:
        if kind == "rglru":
            x, new = rglru_step_block(cfg, p["rec"], x, cache, ctx)
        elif kind == "ssd":
            x, new = ssd_step_block(cfg, p["ssd"], x, cache, ctx)
        else:
            raise ValueError(kind)
        cache["h"].copy_(new["h"])
        cache["conv"].copy_(new["conv"])
    if "xattn" in p and "xk" in cache:
        x = cross_step(cfg, p["xattn"], x, cache, ctx)
    if "ffn" in p:
        x = T.ffn_forward(cfg, p["ffn"], x, ctx)
    return x, cache


# ---------------------------------------------------------------------------
# decode step (one new token for the whole batch)
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                shard=None) -> Tuple[torch.Tensor, Pytree]:
    """tokens (B, 1) at position cache['pos'] -> (logits (B,1,V), cache).

    The cache is updated in place (the JAX package returns a new tree):
    every layer's state, conv tail and K/V row, and ``pos``, which advances
    by one.  The returned cache is the one passed in.  ``shard``: a
    mesh's ``sharding.ActSharder``, as ``T.forward`` takes it; each
    layer's blocks are resharded as the loop runs it (``_layers``), so a
    token gathers every split leaf once."""
    pos = cache["pos"]
    B = tokens.shape[0]
    place = T.placement(cfg, shard, mixers=False)
    x = T.embed_tokens(cfg, params, tokens, place, shard)
    if cfg.rope == "learned":
        # clamped as JAX's gather clamps, so no step reads pos on the host
        at = pos.reshape(1).clamp(max=cfg.max_position - 1).long()
        x = x + T.computed(params["pos_embed"], place,
                           "pos_embed").index_select(0, at).to(x.dtype)[None]
    ctx = T.rope_ctx(cfg, T.default_positions(cfg, pos.expand(B, 1)))
    ctx.shard, ctx.place = shard, place
    for kind, lp, path, lc in _layers(cfg, params, cache):
        x, _ = block_step(cfg, kind, T.computed(lp, place, *path), x, lc,
                          pos, ctx)
    pos.add_(1)
    return T.gather_vocab(cfg, T.unembed(cfg, params, x, place, shard),
                          shard), cache


def _layers(cfg: ModelConfig, params, cache):
    """(kind, the layer's stored leaves, their path in the parameters, its
    cache entry) of every layer in order.  The loops reshard a layer's
    leaves as they call its block (``T.computed``), so its gathered leaves
    are a temporary: a rank holds one layer's at a time."""
    pattern = cfg.block_pattern
    blocks = params["blocks"]
    for g in range(T.num_groups(blocks)):
        gp, gc = T.group_params(blocks, g), T.group_params(cache["blocks"], g)
        for j, kind in enumerate(pattern):
            key = f"b{j}_{kind}"
            yield kind, gp[key], ("blocks", key), gc[key]
    for j, (lp, lc) in enumerate(zip(params["rem"], cache["rem"])):
        yield pattern[j % len(pattern)], lp, ("rem", j), lc


# ---------------------------------------------------------------------------
# prefill (build the cache for a whole prompt)
# ---------------------------------------------------------------------------

def _attn_prefill_kv(cfg, p, h, ctx):
    Dh = cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    k = T._heads(T._proj(h, p["wk"], p.get("bk")), KV, Dh)
    v = T._heads(T._proj(h, p["wv"], p.get("bv")), KV, Dh)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope in ("rope", "mrope"):
        k = L.apply_rope(k, ctx.cos, ctx.sin)
    return k, v


def block_prefill(cfg: ModelConfig, kind: str, p, x, ctx: T.Ctx):
    """Forward one block over the full prompt, returning its cache entry."""
    S = x.shape[1]
    cache: Dict[str, torch.Tensor] = {}
    if kind == "attn" and cfg.attention == "mla":
        h = L.rms_norm(x, p["attn"]["ln"], cfg.norm_eps)
        cache["lat"], cache["kr"] = T.mla_latent(cfg, p["attn"], h, ctx)
        x = T.mla_forward(cfg, p["attn"], x, ctx)
    elif kind == "attn":
        h = L.rms_norm(x, p["attn"]["ln"], cfg.norm_eps)
        k, v = _attn_prefill_kv(cfg, p["attn"], h, ctx)
        if _use_ring(cfg, S):
            W = cfg.sliding_window
            shift = (S - W) % W          # align slots to p % W
            cache["k"] = torch.roll(k[:, S - W:], shift, dims=1)
            cache["v"] = torch.roll(v[:, S - W:], shift, dims=1)
            cache["kpos"] = torch.roll(
                torch.arange(S - W, S, dtype=torch.int32, device=x.device),
                shift)
        else:
            cache["k"], cache["v"] = k, v
        window = cfg.sliding_window if cfg.family == "hybrid" else 0
        x = T.attn_forward(cfg, p["attn"], x, ctx, window=window)
    elif kind == "rglru":
        x, (hl, conv) = T.rglru_forward(cfg, p["rec"], x, ctx)
        # the last state in x's dtype, as the JAX package keeps it
        cache["h"], cache["conv"] = hl.float(), conv
    elif kind == "ssd":
        x, (hl, conv) = T.ssd_forward(cfg, p["ssd"], x, ctx)
        cache["h"], cache["conv"] = hl, conv
    else:
        raise ValueError(kind)
    if "xattn" in p and ctx.enc_out is not None:
        # the encoder's K/V once, into the cache; the prompt attends to them
        # through K5 (non-causal)
        xp = p["xattn"]
        cache["xk"], cache["xv"] = T.cross_kv(cfg, xp, ctx)
        x = T.attn_forward(cfg, xp, x, ctx,
                           kv_override=(cache["xk"], cache["xv"]), cross=True)
    if "ffn" in p:
        x = T.ffn_forward(cfg, p["ffn"], x, ctx)
    return x, cache


def prefill(cfg: ModelConfig, params, tokens, *, encoder_frames=None,
            frontend_embeds=None, shard=None):
    """Run the prompt, returning (logits_last (B,1,V), cache).  With
    ``encoder_frames`` the encoder runs first and each block's ``xk``/``xv``
    hold its K/V; without them they stay zero and decode's cross-attention
    adds nothing, as the JAX package's cache, which then has no such
    leaves, gives it.  ``frontend_embeds`` (B, F, D), the patch embeddings,
    replace the prompt's first F positions (``T.splice_frontend``); the
    rotary positions are 0..S-1, on all three channels for M-RoPE.
    ``shard``: a mesh's ``sharding.ActSharder``, as ``T.forward`` takes
    it; each layer resharded as the loop runs it (``_layers``)."""
    B, S = tokens.shape
    place = T.placement(cfg, shard, mixers=False)
    x = T.splice_frontend(cfg, params, T.embed_tokens(cfg, params, tokens,
                                                      place, shard),
                          frontend_embeds, place)
    x = T.add_positions(cfg, params, x, place)
    ctx = T.rope_ctx(cfg, T.default_positions(
        cfg, torch.arange(S, device=tokens.device)[None].expand(B, S)))
    ctx.shard, ctx.place = shard, place
    ctx = T.encoder_ctx(cfg, params, ctx, encoder_frames, x.dtype)
    cache = init_cache(cfg, B, S, device=tokens.device)
    cache["pos"].fill_(S)
    for kind, lp, path, lc in _layers(cfg, params, cache):
        x, c = block_prefill(cfg, kind, T.computed(lp, place, *path), x, ctx)
        for name, t in c.items():
            lc[name].copy_(t)
    logits = T.unembed(cfg, params, x[:, -1:], place, shard)
    return T.gather_vocab(cfg, logits, shard), cache
