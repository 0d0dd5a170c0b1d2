"""The JAX package's ``models/transformer.py`` for the Mamba-2 (``ssd``)
block kind.

Parameters keep the JAX tree: each block pattern group's leaves are stacked
``(groups, ...)`` under ``blocks["b{j}_{kind}"]``, pattern remainders are a
list under ``rem``, so ``repro_torch.convert.params_from_jax`` carries a
JAX tree across leaf for leaf.  A Python loop over the stacked groups takes
the place of ``lax.scan``; ``remat``, ``scan_layers`` and activation
sharding have no counterpart on one card.  Attention, RG-LRU, MoE, MLA,
encoder and frontend blocks raise ``NotImplementedError``: they come with
later slices of the port (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L

Pytree = Any

# The block kinds this slice runs, and where the others come from.
_LATER = {"attn": "the dense GQA slice", "rglru": "the RecurrentGemma-2B slice"}


def unsupported(what: str, slice_: str):
    return NotImplementedError(
        f"the port's LM stack runs the Mamba-2 'ssd' block only; {what} comes "
        f"with {slice_} (ROADMAP.md, queue 1)")


def check_kind(kind: str) -> None:
    if kind != "ssd":
        raise unsupported(f"block kind {kind!r}",
                          _LATER.get(kind, "a later slice"))


# ---------------------------------------------------------------------------
# param descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names (or None)
    init: str = "normal"                     # normal | zeros | ones | ssm_a | dtbias
    scale: float = 0.02

    def with_stack(self, n: int) -> "PDef":
        return PDef((n,) + self.shape, ("layer",) + self.axes, self.init,
                    self.scale)


def _dense(din, dout, ax_in="fsdp", ax_out="tp", scale=0.02):
    return PDef((din, dout), (ax_in, ax_out), "normal", scale)


def _norm(d):
    return PDef((d,), (None,), "zeros")


def ssd_defs(cfg: ModelConfig) -> Dict[str, PDef]:
    D = cfg.d_model
    din = cfg.ssm_expand * D
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = din // cfg.ssm_head_dim
    conv_ch = din + 2 * G * N
    return {
        "ln": _norm(D),
        "in_proj": _dense(D, 2 * din + 2 * G * N + H),
        "conv_w": PDef((cfg.ssm_conv, conv_ch), (None, "tp"), "normal", 0.1),
        "a_log": PDef((H,), (None,), "ssm_a"),
        "d_skip": PDef((H,), (None,), "ones"),
        "dt_bias": PDef((H,), (None,), "dtbias"),
        "out_ln": _norm(din),
        "out_proj": _dense(din, D, ax_in="tp", ax_out="fsdp",
                           scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def block_defs(cfg: ModelConfig, kind: str,
               decoder: bool = True) -> Dict[str, Any]:
    """One block: the SSD mixer (Mamba-2 blocks have no FFN, d_ff = 0)."""
    check_kind(kind)
    if decoder and cfg.cross_attention:
        raise unsupported("cross-attention", "the Whisper slice")
    return {"ssd": ssd_defs(cfg)}


# ---------------------------------------------------------------------------
# whole-model param definitions
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``jax.tree.map`` over the dicts and lists of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param_defs(cfg: ModelConfig) -> Pytree:
    D = cfg.d_model
    period = len(cfg.block_pattern)
    groups, rem = divmod(cfg.num_layers, period)
    if cfg.encoder_layers:
        raise unsupported("the encoder", "the Whisper slice")
    if cfg.frontend != "none":
        raise unsupported(f"the {cfg.frontend} frontend", "a later slice")
    if cfg.rope == "learned":
        raise unsupported("learned positions", "the Whisper slice")
    if cfg.num_experts:
        raise unsupported("MoE", "the dense GQA slice")

    Vp = cfg.padded_vocab      # Megatron-style padding, as the JAX tree has it
    defs: Dict[str, Any] = {
        "embed": PDef((Vp, D), ("vocab", None), "normal", 1.0 / math.sqrt(D)),
        "final_norm": _norm(D),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((D, Vp), (None, "vocab"), "normal")
    group_tree = {f"b{j}_{kind}": block_defs(cfg, kind)
                  for j, kind in enumerate(cfg.block_pattern)}
    defs["blocks"] = (tree_map(lambda pd: pd.with_stack(groups), group_tree)
                      if groups else {})
    defs["rem"] = [block_defs(cfg, cfg.block_pattern[j % period])
                   for j in range(rem)]
    return defs


def _dtype(pd: PDef, cfg: ModelConfig) -> torch.dtype:
    if pd.init in ("ssm_a", "dtbias"):
        return torch.float32
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Pytree:
    """Random parameters with the JAX package's initialisers, drawn from
    ``generator`` on its own device and put on ``device`` (None: the
    card).  The numbers differ from ``jax.random``'s; tests carry JAX
    trees across with ``params_from_jax`` instead."""
    dev = resolve(device)
    gdev = generator.device

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=gdev).uniform_(lo, hi,
                                                        generator=generator)

    def mk(pd: PDef):
        dtype = _dtype(pd, cfg)
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ssm_a":
            t = torch.log(uniform(pd.shape, 1.0, 16.0))
        elif pd.init == "dtbias":
            t = torch.log(torch.expm1(uniform(pd.shape, 1e-3, 0.1)))  # inv-softplus
        else:
            t = torch.randn(pd.shape, generator=generator, device=gdev) * pd.scale
        return t.to(dev, dtype)

    return tree_map(mk, param_defs(cfg))


def param_shapes(cfg: ModelConfig) -> Pytree:
    """Shape and dtype of every parameter as tensors on the ``meta`` device
    (no storage), the counterpart of the JAX package's ShapeDtypeStructs."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=_dtype(pd, cfg),
                                           device="meta"), param_defs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(pd.shape) for pd in tree_leaves(param_defs(cfg))))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """Per-call context shared across layers."""
    cfg: ModelConfig


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def ssd_forward(cfg: ModelConfig, p, x, ctx: Ctx, h0=None, conv0=None):
    D = cfg.d_model
    din = cfg.ssm_expand * D
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = din // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = _proj(h, p["in_proj"])
    z, xs, BC, dt = torch.split(zxbcdt, [din, din, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xs, BC], dim=-1)
    conv_out, conv_state = L.causal_conv1d(conv_in, p["conv_w"], conv0)
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = torch.split(conv_out, [din, G * N, G * N], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    xh = xs.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    y, h_last = L.ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, h0=h0)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, din)
    y = L.rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    return x + _proj(y, p["out_proj"]), (h_last, conv_state)


def apply_block(cfg: ModelConfig, kind: str, p, x, ctx: Ctx):
    check_kind(kind)
    x, _ = ssd_forward(cfg, p["ssd"], x, ctx)
    return x


def group_params(blocks: Pytree, g: int) -> Pytree:
    """Layer group ``g`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[g], blocks)


def num_groups(blocks: Pytree) -> int:
    return tree_leaves(blocks)[0].shape[0] if blocks else 0


def run_decoder_blocks(cfg: ModelConfig, params, x, ctx: Ctx):
    pattern = cfg.block_pattern
    blocks = params["blocks"]
    for g in range(num_groups(blocks)):
        gp = group_params(blocks, g)
        for j, kind in enumerate(pattern):
            x = apply_block(cfg, kind, gp[f"b{j}_{kind}"], x, ctx)
    for j, lp in enumerate(params["rem"]):
        x = apply_block(cfg, pattern[j % len(pattern)], lp, x, ctx)
    return x


def embed_tokens(cfg: ModelConfig, params, tokens):
    return params["embed"][tokens]


def unembed(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask the padding columns with an additive bias
        cols = torch.arange(cfg.padded_vocab, device=logits.device)
        pad_mask = torch.where(cols < cfg.vocab_size, 0.0, -1e30).to(
            logits.dtype)
        logits = logits + pad_mask[None, None, :]
    return logits


def forward(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    """Full forward over a token block -> logits (B, S, padded vocab)."""
    x = embed_tokens(cfg, params, tokens)
    x = run_decoder_blocks(cfg, params, x, Ctx(cfg=cfg))
    return unembed(cfg, params, x)
