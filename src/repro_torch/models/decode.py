"""The JAX package's ``models/decode.py`` serving path for the ``ssd``
block kind: cache construction, prefill and single-token decode.

The cache mirrors the parameter layout: a pattern group's leaves are
stacked ``(groups, ...)`` under ``blocks["b{j}_{kind}"]``, remainders are
a list under ``rem``, and ``pos`` is a 0-d int32 tensor shared by the
batch.  An ``ssd`` layer keeps its SSM state ``h`` (B, H, P, N) in fp32 and
the conv tail ``conv`` (B, K-1, din + 2GN) in the model's dtype.  Unlike
the JAX package, ``decode_step`` writes the new state into the cache it is
given.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Pytree = Any


# ---------------------------------------------------------------------------
# cache shape definitions
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def layer_cache_def(cfg: ModelConfig, kind: str, batch: int,
                    seq: int) -> Dict[str, torch.Tensor]:
    """Shape and dtype of one layer's cache, as ``meta`` tensors (an
    ``ssd`` layer's does not depend on ``seq``)."""
    T.check_kind(kind)
    din = cfg.ssm_expand * cfg.d_model
    H = din // cfg.ssm_head_dim
    conv_ch = din + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "h": _meta((batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "conv": _meta((batch, cfg.ssm_conv - 1, conv_ch),
                      getattr(torch, cfg.dtype)),
    }


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


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Pytree:
    """A zero cache on ``device`` (None: the card)."""
    dev = resolve(device)
    return T.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=dev),
                      cache_shapes(cfg, batch, seq))


# ---------------------------------------------------------------------------
# single-token block steps
# ---------------------------------------------------------------------------

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
    T.check_kind(kind)
    x, new = ssd_step_block(cfg, p["ssd"], x, cache, ctx)
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    return x, cache


# ---------------------------------------------------------------------------
# decode step (one new token for the whole batch)
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache, tokens
                ) -> Tuple[torch.Tensor, Pytree]:
    """tokens (B, 1) at position cache['pos'] -> (logits (B,1,V), cache).

    The cache is updated in place (the JAX package returns a new tree):
    every layer's state and conv tail, and ``pos``, which advances by one.
    The returned cache is the one passed in."""
    pos = cache["pos"]
    x = T.embed_tokens(cfg, params, tokens)
    ctx = T.Ctx(cfg=cfg)
    pattern = cfg.block_pattern
    blocks = params["blocks"]
    for g in range(T.num_groups(blocks)):
        gp, gc = T.group_params(blocks, g), T.group_params(cache["blocks"], g)
        for j, kind in enumerate(pattern):
            key = f"b{j}_{kind}"
            x, _ = block_step(cfg, kind, gp[key], x, gc[key], pos, ctx)
    for j, (lp, lc) in enumerate(zip(params["rem"], cache["rem"])):
        x, _ = block_step(cfg, pattern[j % len(pattern)], lp, x, lc, pos, ctx)
    pos.add_(1)
    return T.unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# prefill (build the cache for a whole prompt)
# ---------------------------------------------------------------------------

def block_prefill(cfg: ModelConfig, kind: str, p, x, ctx: T.Ctx):
    """Forward one block over the full prompt, returning its cache entry."""
    T.check_kind(kind)
    x, (hl, conv) = T.ssd_forward(cfg, p["ssd"], x, ctx)
    return x, {"h": hl, "conv": conv}


def prefill(cfg: ModelConfig, params, tokens):
    """Run the prompt, returning (logits_last (B,1,V), cache)."""
    B, S = tokens.shape
    x = T.embed_tokens(cfg, params, tokens)
    ctx = T.Ctx(cfg=cfg)
    pattern = cfg.block_pattern
    cache = init_cache(cfg, B, S, device=tokens.device)
    cache["pos"].fill_(S)
    blocks = params["blocks"]
    for g in range(T.num_groups(blocks)):
        gp, gc = T.group_params(blocks, g), T.group_params(cache["blocks"], g)
        for j, kind in enumerate(pattern):
            key = f"b{j}_{kind}"
            x, c = block_prefill(cfg, kind, gp[key], x, ctx)
            for name, t in c.items():
                gc[key][name].copy_(t)
    for j, (lp, lc) in enumerate(zip(params["rem"], cache["rem"])):
        x, c = block_prefill(cfg, pattern[j % len(pattern)], lp, x, ctx)
        for name, t in c.items():
            lc[name].copy_(t)
    logits = T.unembed(cfg, params, x[:, -1:])
    return logits, cache
