"""The JAX package's ``models/transformer.py`` for the Mamba-2 (``ssd``),
RG-LRU (``rglru``) and attention (``attn``: GQA, or MLA) block kinds, with
the dense MLP or the top-k MoE FFN: the blocks of Mamba-2 370M,
RecurrentGemma-2B, the dense Qwen decoders (qk-norm, QKV bias), the MoE
decoders (Qwen3-MoE, Llama 4 Maverick), MiniCPM3-4B (MLA: latent q and kv
projections, q/k head dim nope + rope against a value head dim of its own),
Whisper's encoder-decoder (the bidirectional ``encode``, cross-attention
over its output, learned positions), qwen2-vl (M-RoPE over (B, S, 3) t/h/w
positions, and the ``vision_patches`` frontend: precomputed patch
embeddings, projected by ``patch_proj``, replace the prompt's leading
positions) and the paper's own BERT-base, GPT-2 1.5B and ViT-632M (learned
positions, gelu; the ViT through the patch frontend).

Parameters keep the JAX tree: each block pattern group's leaves are
stacked ``(groups, ...)`` under ``blocks["b{j}_{kind}"]``, pattern
remainders are a list under ``rem``, so
``repro_torch.convert.params_from_jax`` carries a JAX tree across leaf for
leaf.  A Python loop over the stacked groups takes the place of
``lax.scan`` (``scan_layers`` has no counterpart).  Over a mesh of ranks
(``launch.mesh``) every rank runs the model on its own batch block, which
already is the layout the JAX package's activation constraints ask for,
and holds only its block of every parameter under the rules' spec
(``place_params``: FSDP over data, TP and the vocabulary over model,
experts over model).  ``shard`` (``forward``'s keyword, carried on
``Ctx`` as in the JAX package; a ``sharding.ActSharder``) gives the mesh,
the batch's axes and the rules; from them ``placement`` reshards each
layer's blocks, where a loop takes the layer, to the blocks it computes
with (``collectives.reshard``), and the blocks compute with what they are
given, their head and channel counts read from its shapes.  That is TP's
compute split, the products XLA's partitioner makes of the JAX package's
layout (the residual stream whole over ``model``, the logits split over
the vocabulary): a rank along ``model`` computes attention's, MLA's, the
MLP's and the RG-LRU's columns of its stored block less its FSDP split
(``compute_defs``: the q side by heads, K/V where the kv heads divide
too), and each row-parallel product (``wo``, ``w2``, the RG-LRU's gates
and ``wo``) is summed over ``model`` (``collectives.psum``, in fp32); the
embedding and the head are split over the vocabulary (the lookup summed
over ``model``, the loss ``softmax_xent`` taken over the ranks' blocks).
The SSD block, MLA's latent projections, ``patch_proj``, the positions,
the norms and an attention whose heads do not divide over ``model`` are
computed whole; expert leaves take the in_specs of the JAX package's
expert-parallel path (``distributed.moe_ep``, taken with a ``model`` axis
larger than 1; else the gather path).  The leaves outside the blocks (the
embedding, the head, the patch projection, the positions, the encoder's)
are resharded where they are used.  Under ``DECODE_RULES``
(``sharding.resident``) no dense leaf moves: the residual stream is the
rank's ``d_model / data`` block (``ActSharder.hidden_axes``), a
column-parallel product multiplies it by the stored block and sums the
partials over ``data`` in fp32 (``_cols``; the outputs of leaves
``compute_defs`` keeps whole gathered over ``model``, a one-token row at
decode), a row-parallel one ends on the rank's block, the norms sum
their squares over ``data`` (``_rms_norm``), the embedding gives and the
head contracts the rank's columns, and the MoE FFN gathers the whole
width its in_specs take.  It trains as it serves: every one of those
sums and gathers carries the gradient as JAX's transpose does (a
``psum``'s backward an all-reduce, a gather's, ``_gather_last``, a
reduce-scatter in fp32), so the training step's loss × 1 / ranks gives
each rank its share of the global mean's gradient.  Under
``SEQPAR_RULES`` (``seq_split``: the JAX package's ``act_seq``) the
residual stream between blocks is the rank's rows of the sequence over
``model``: the embedding's sum a reduce-scatter, each block's norm on
the rank's rows, then the normed rows gathered whole for the products
that need every token (``_seq_gather``; attention, the RG-LRU's conv
and scan, MoE routing), each row-parallel product that joins the stream
ending in a reduce-scatter (``_psum_rows``) and a part computed whole
cut to the rank's rows; the gathers' backward sums over ``model`` in fp32, the
reduce-scatters' gathers, so each layer's remat unit keeps a rank's
``S / model`` rows.  Whisper's encoder stays whole.  Under
``cfg.remat`` (the JAX package's ``jax.checkpoint`` of each group and
``rem`` layer, and of each encoder block) each of them runs under
``torch.utils.checkpoint`` when a gradient is taken, on one card and over
a mesh alike: the backward keeps only each one's input and runs its
forward again, on a mesh its reshard included, so a rank keeps at most
one layer's gathered weights.  The head and the patch projection run
under it only on a mesh, where it drops a gathered leaf (the JAX package
checkpoints neither).
Whisper's ``audio_frames`` and the ``vision_patches`` frontends are stubs
in both packages: the caller hands ``forward`` the frame or patch
embeddings.  ``softmax_xent`` is the training loss.  ``forward``
differentiates everywhere: on the card the attention blocks' gradient
(GQA, MLA at its (96, 64) head dims, the ViT's 80, Whisper's encoder and
cross-attention) runs K5b and the RG-LRU blocks' K7b (through
``ops.attention``, ``ops.rglru``), so every family trains with no plain
attention or scan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import moe_ep
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


# ---------------------------------------------------------------------------
# param descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names (or None)
    init: str = "normal"                     # normal | zeros | ones | lru | ssm_a | dtbias
    scale: float = 0.02

    def with_stack(self, n: int) -> "PDef":
        return PDef((n,) + self.shape, ("layer",) + self.axes, self.init,
                    self.scale)


def _dense(din, dout, ax_in="fsdp", ax_out="tp", scale=0.02):
    return PDef((din, dout), (ax_in, ax_out), "normal", scale)


def _norm(d):
    return PDef((d,), (None,), "zeros")


def attn_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, PDef]:
    """GQA attention, with the QKV bias and qk-norm scales where the
    config has them; cross-attention (``cross``) has neither.  MLA: the
    latent q projection (``wq_a``, its norm ``q_ln``, ``wq_b`` to the heads'
    nope + rope dims), the latent kv projection (``wkv_a`` to the latent
    and the shared rope key, its norm ``kv_ln``), ``wk_b`` and ``wv_b`` from
    the latent to the heads' nope keys and values, ``wo``."""
    D = cfg.d_model
    Dh = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    wo_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    if cfg.attention == "mla" and not cross:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        return {
            "ln": _norm(D),
            "wq_a": _dense(D, qr), "q_ln": _norm(qr),
            "wq_b": _dense(qr, H * (dn + dr)),
            "wkv_a": _dense(D, kvr + dr, ax_out=None), "kv_ln": _norm(kvr),
            "wk_b": _dense(kvr, H * dn),
            "wv_b": _dense(kvr, H * dv),
            "wo": _dense(H * dv, D, ax_in="tp", ax_out="fsdp",
                         scale=wo_scale),
        }
    out = {
        "ln": _norm(D),
        "wq": _dense(D, H * Dh),
        "wk": _dense(D, KV * Dh),
        "wv": _dense(D, KV * Dh),
        "wo": _dense(H * Dh, D, ax_in="tp", ax_out="fsdp", scale=wo_scale),
    }
    if cfg.qkv_bias and not cross:
        out.update(bq=PDef((H * Dh,), ("tp",), "zeros"),
                   bk=PDef((KV * Dh,), ("tp",), "zeros"),
                   bv=PDef((KV * Dh,), ("tp",), "zeros"))
    if cfg.qk_norm and not cross:
        out.update(qn=_norm(Dh), kn=_norm(Dh))
    return out


def mlp_defs(cfg: ModelConfig) -> Dict[str, PDef]:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln": _norm(D),
        "w1": _dense(D, F_),
        "w3": _dense(D, F_),
        "w2": _dense(F_, D, ax_in="tp", ax_out="fsdp",
                     scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def moe_defs(cfg: ModelConfig) -> Dict[str, PDef]:
    D = cfg.d_model
    E, Fe = cfg.num_experts, (cfg.moe_d_ff or cfg.d_ff)
    return {
        "ln": _norm(D),
        "wg": PDef((D, E), (None, None), "normal"),
        "w1": PDef((E, D, Fe), ("expert", "fsdp", None), "normal"),
        "w3": PDef((E, D, Fe), ("expert", "fsdp", None), "normal"),
        "w2": PDef((E, Fe, D), ("expert", None, "fsdp"), "normal",
                   0.02 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def rglru_defs(cfg: ModelConfig) -> Dict[str, PDef]:
    D = cfg.d_model
    W = D  # lru width = d_model (RecurrentGemma-2B)
    return {
        "ln": _norm(D),
        "wx": _dense(D, W),
        "wy": _dense(D, W),
        "conv_w": PDef((4, W), (None, "tp"), "normal", 0.1),
        "wga": _dense(W, W, ax_in="tp", ax_out=None),
        "bga": PDef((W,), (None,), "zeros"),
        "wgx": _dense(W, W, ax_in="tp", ax_out=None),
        "bgx": PDef((W,), (None,), "zeros"),
        "log_a": PDef((W,), (None,), "lru"),
        "wo": _dense(W, D, ax_in="tp", ax_out="fsdp",
                     scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


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


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """One decoder block = mixer (+ cross-attn) (+ FFN); the encoder's
    blocks are built in ``param_defs``."""
    d: Dict[str, Any] = {}
    if kind == "attn":
        d["attn"] = attn_defs(cfg)
    elif kind == "rglru":
        d["rec"] = rglru_defs(cfg)
    elif kind == "ssd":
        d["ssd"] = ssd_defs(cfg)
    else:
        raise ValueError(kind)
    if cfg.cross_attention:
        d["xattn"] = attn_defs(cfg, cross=True)
    if kind != "ssd":  # mamba2 blocks have no separate FFN (d_ff = 0)
        d["ffn"] = moe_defs(cfg) if cfg.num_experts else mlp_defs(cfg)
    return d


# ---------------------------------------------------------------------------
# whole-model param definitions
# ---------------------------------------------------------------------------

def _stack_tree(tree: Pytree, n: int) -> Pytree:
    return tree_map(lambda pd: pd.with_stack(n), tree)


def param_defs(cfg: ModelConfig) -> Pytree:
    D = cfg.d_model
    period = len(cfg.block_pattern)
    groups, rem = divmod(cfg.num_layers, period)

    Vp = cfg.padded_vocab      # Megatron-style padding, as the JAX tree has it
    defs: Dict[str, Any] = {
        "embed": PDef((Vp, D), ("vocab", None), "normal", 1.0 / math.sqrt(D)),
        "final_norm": _norm(D),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((D, Vp), (None, "vocab"), "normal")
    if cfg.rope == "learned":
        defs["pos_embed"] = PDef((cfg.max_position, D), (None, None), "normal",
                                 0.01)
    group_tree = {f"b{j}_{kind}": block_defs(cfg, kind)
                  for j, kind in enumerate(cfg.block_pattern)}
    defs["blocks"] = _stack_tree(group_tree, groups) if groups else {}
    defs["rem"] = [block_defs(cfg, cfg.block_pattern[j % period])
                   for j in range(rem)]
    if cfg.encoder_layers:
        enc_block = {"attn": attn_defs(cfg), "ffn": mlp_defs(cfg)}
        defs["encoder"] = {
            "blocks": _stack_tree(enc_block, cfg.encoder_layers),
            "final_norm": _norm(D),
            "pos_embed": PDef((cfg.encoder_seq, D), (None, None), "normal",
                              0.01),
        }
    if cfg.frontend == "vision_patches":
        # early-fusion projection of the precomputed patch embeddings
        defs["patch_proj"] = _dense(D, D)
    return defs


def _dtype(pd: PDef, cfg: ModelConfig) -> torch.dtype:
    if pd.init in ("lru", "ssm_a", "dtbias"):
        return torch.float32
    return getattr(torch, cfg.dtype)


def _draw(pd: PDef, cfg: ModelConfig, generator: torch.Generator,
          dev: torch.device, cut: Optional[Callable] = None) -> torch.Tensor:
    """One leaf as ``init_params`` draws it from ``generator``; ``cut``
    takes a block of the fp32 draw (a view) before it is cast and copied
    to ``dev``."""
    dtype = _dtype(pd, cfg)
    gdev = generator.device

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=gdev).uniform_(lo, hi,
                                                        generator=generator)

    if pd.init in ("zeros", "ones"):
        shape = pd.shape if cut is None else cut(
            torch.empty(pd.shape, device="meta")).shape
        fill = torch.zeros if pd.init == "zeros" else torch.ones
        return fill(shape, dtype=dtype, device=dev)
    if pd.init == "lru":
        # a in (0.9, 0.999): softplus(lam) = -ln(a) / 8
        t = torch.log(torch.expm1(-torch.log(uniform(pd.shape, 0.9, 0.999))
                                  / 8.0))
    elif pd.init == "ssm_a":
        t = torch.log(uniform(pd.shape, 1.0, 16.0))
    elif pd.init == "dtbias":
        t = torch.log(torch.expm1(uniform(pd.shape, 1e-3, 0.1)))  # inv-softplus
    else:
        # scaled in place: one fp32 copy of a leaf at a time (an MoE
        # layer group's experts are billions of elements)
        t = torch.randn(pd.shape, generator=generator,
                        device=gdev).mul_(pd.scale)
    if cut is None:
        return t.to(dev, dtype)
    block = cut(t)
    return torch.empty(block.shape, dtype=dtype, device=dev).copy_(block)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Pytree:
    """Random parameters with the JAX package's initialisers, drawn from
    ``generator`` on its own device and put on ``device`` (None: the
    card).  The numbers differ from ``jax.random``'s; tests carry JAX
    trees across with ``params_from_jax`` instead."""
    dev = resolve(device)
    return tree_map(lambda pd: _draw(pd, cfg, generator, dev),
                    param_defs(cfg))


def param_block_specs(cfg: ModelConfig, mesh, rules=None) -> Pytree:
    """The spec of the block of each leaf that a rank stores on ``mesh``
    under ``rules`` (None: ``TRAIN_RULES``): the JAX package's
    ``param_spec_tree`` (``P()`` for a whole leaf).  The AdamW moments and
    the reduced gradient take the same blocks."""
    rules = SH.resolve_rules(rules)
    return tree_map(lambda pd: SH.spec_for(pd.shape, pd.axes, rules, mesh),
                    param_defs(cfg))


def place_params(cfg: ModelConfig, source, mesh, *, rules=None,
                 device=None) -> Pytree:
    """This rank's parameters on ``mesh``, the counterpart of the JAX
    package's ``jit(init_params, out_shardings=...)``: the rank's block of
    each leaf under ``param_block_specs`` of ``rules``, on ``device``
    (None: the card).  ``source`` is a whole tree (on the CPU or the
    card), or a ``torch.Generator`` drawn from leaf by leaf exactly as
    ``init_params`` draws, each block cut from its fp32 draw, so the rank
    never holds more than one whole leaf."""
    dev = resolve(device)
    specs = param_block_specs(cfg, mesh, rules)
    coords = SH.mesh_coords(mesh)

    def cutter(spec):
        if not spec:
            return None
        return lambda t: SH.local_block(t, spec, mesh, coords)

    defs = param_defs(cfg)
    if isinstance(source, torch.Generator):
        return tree_map(lambda pd, sp: _draw(pd, cfg, source, dev,
                                             cutter(sp)), defs, specs)

    def keep(t, sp):
        cut = cutter(sp)
        if cut is None:
            return t.to(dev)
        block = cut(t)
        return torch.empty(block.shape, dtype=t.dtype,
                           device=dev).copy_(block)

    return tree_map(keep, source, specs)


def head_split(cfg: ModelConfig, mesh, rules) -> Tuple[bool, bool]:
    """(the q heads split over ``tp``'s ranks, the kv heads too), as
    ``compute_defs`` decides: q where its heads divide and the kv heads
    divide or divide the ranks, K/V where theirs divide as well."""
    shape = SH.mesh_shape(mesh)
    n = math.prod(shape.get(a, 1) for a in rules.get("tp", ()))
    H, KV = cfg.num_heads, cfg.num_kv_heads
    kv_heads = KV % n == 0
    heads = H % n == 0 and (kv_heads or n % KV == 0)
    return heads, heads and kv_heads


def compute_defs(cfg: ModelConfig, mesh, rules) -> Pytree:
    """``param_defs`` with each leaf's logical axes as a layer computes
    with it on ``mesh`` under ``rules`` (``sharding.leaf_specs``'
    ``compute_axes``): ``tp`` kept where the split follows the heads or
    channels, dropped (the leaf whole) for the SSD block (``in_proj``'s
    flat split would cut across its z | x | B | C | dt segments), MLA's
    ``wq_a`` (its latent is normed over the whole width), ``patch_proj``
    (its output joins the residual stream), an attention block whose q
    heads do not divide over ``tp``'s n ranks (or whose kv heads neither
    divide over them nor divide n: a rank's q heads would straddle two kv
    groups), K/V and their biases where the kv heads do not divide (each
    rank then reads the one kv head of its q heads).  Decode takes the
    same blocks: its cache is split along the sequence, not the heads
    (``decode``)."""
    heads, kv_heads = head_split(cfg, mesh, rules)

    def whole(pd):
        return PDef(pd.shape, tuple(None if a == "tp" else a
                                    for a in pd.axes), pd.init, pd.scale)

    def attn(d, split):
        return {k: whole(pd) if not split or k == "wq_a" or (
            not kv_heads and k in ("wk", "wv", "bk", "bv")) else pd
            for k, pd in d.items()}

    def block(d):
        out = {}
        for name, sub in d.items():
            if name in ("attn", "xattn"):
                out[name] = attn(sub, heads)
            elif name == "ssd":
                out[name] = tree_map(whole, sub)
            else:
                out[name] = sub
        return out

    defs = param_defs(cfg)
    out = dict(defs, blocks={k: block(v) for k, v in defs["blocks"].items()},
               rem=[block(v) for v in defs["rem"]])
    if "encoder" in defs:
        out["encoder"] = dict(defs["encoder"],
                              blocks=block(defs["encoder"]["blocks"]))
    if "patch_proj" in defs:
        out["patch_proj"] = whole(defs["patch_proj"])
    return out


@dataclass(frozen=True)
class Placement:
    """A mesh's two layouts of the parameters (``param_defs``' structure,
    a ``sharding.LeafSpecs`` a leaf): the block each rank stores and the
    block a layer computes with."""
    mesh: Any
    specs: Pytree

    def compute(self, tree: Pytree, *path) -> Pytree:
        """``tree``, the stored blocks of the subtree at ``path`` of the
        parameters, resharded to their compute blocks.  Under a ``blocks``
        key ``tree`` is a layer group's slice of stacked leaves, whose
        specs lose the layer dim (never split: ``layer`` maps to no
        axis)."""
        specs = self.specs
        for k in path:
            specs = specs[k]
        stacked = "blocks" in path

        def one(t, ls):
            src, dst = ls.storage, ls.compute
            if stacked:
                src, dst = SH.P(*src[1:]), SH.P(*dst[1:])
            return coll.reshard(t, src, dst, self.mesh)
        return tree_map(one, tree, specs)


def placement(cfg: ModelConfig, shard) -> Optional[Placement]:
    """The ``Placement`` of a mesh's ``sharding.ActSharder``: storage under
    its rules, compute by ``compute_defs`` and in the MoE layout of its
    batch's axes (the forward's, prefill's and decode's alike); None on
    one card, and on a mesh where every stored block is its compute block
    (``TP_RULES`` on a dense model whose heads divide over ``model``;
    ``DECODE_RULES`` on any dense model: its weights stay resident)."""
    if shard is None:
        return None
    layout = moe_ep.moe_layout(cfg, shard.mesh, shard.batch_axes)
    defs = param_defs(cfg)
    cdefs = compute_defs(cfg, shard.mesh, shard.rules)
    specs = tree_map(lambda pd, cd: SH.leaf_specs(
        pd.shape, pd.axes, shard.rules, shard.mesh, layout, cd.axes), defs,
        cdefs)
    if not any(coll.moves(len(pd.shape), ls.storage, ls.compute, shard.mesh)
               for pd, ls in zip(tree_leaves(defs), tree_leaves(specs))):
        return None
    return Placement(shard.mesh, specs)


def computed(tree: Pytree, place: Optional[Placement], *path) -> Pytree:
    """``tree``, the parameters' subtree (or leaf) at ``path``, as a layer
    computes with it: on a mesh (``place``) its stored blocks resharded
    (``Placement.compute``), a temporary that the caller drops after the
    layer, on one card ``tree`` itself."""
    return tree if place is None else place.compute(tree, *path)


def _remat(on: bool, fn: Callable, *args):
    """``fn(*args)``; under ``torch.utils.checkpoint`` where ``on`` and a
    gradient is taken (grad mode on, an input that needs one), so that
    the backward keeps only ``args`` and runs ``fn`` again (the JAX
    package's ``jax.checkpoint``), what ``fn`` gathers included."""
    if on and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(args)):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def param_shapes(cfg: ModelConfig) -> Pytree:
    """Shape and dtype of every parameter as tensors on the ``meta`` device
    (no storage), the counterpart of the JAX package's ShapeDtypeStructs."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=_dtype(pd, cfg),
                                           device="meta"), param_defs(cfg))


def param_logical_axes(cfg: ModelConfig) -> Pytree:
    """The logical axis names of every parameter (a tuple a leaf; walk
    with ``is_leaf=sharding.is_axes``)."""
    return tree_map(lambda pd: pd.axes, param_defs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(pd.shape) for pd in tree_leaves(param_defs(cfg))))


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """Per-call context shared across layers: the RoPE (or M-RoPE) angles
    (B, S, half), MLA's over its rope dims (``cos_r``, ``sin_r``), the
    encoder's output (B, encoder_seq, D) that cross-attention reads, and
    over a mesh ``shard``, its mesh, batch axes and rules
    (``sharding.make_act_sharder``), ``place``, the ``placement`` of
    the parameters it gives, and ``seq``, the axes the residual stream's
    sequence splits over between blocks (``seq_split``; () where each
    rank holds the whole of it)."""
    cfg: ModelConfig
    cos: Optional[torch.Tensor] = None
    sin: Optional[torch.Tensor] = None
    cos_r: Optional[torch.Tensor] = None
    sin_r: Optional[torch.Tensor] = None
    enc_out: Optional[torch.Tensor] = None
    shard: Optional[SH.ActSharder] = None
    place: Optional[Placement] = None
    seq: Tuple[str, ...] = ()


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _heads(x, n, d):
    return x.reshape(x.shape[0], x.shape[1], n, d)


def _model_index(ctx: Ctx) -> int:
    """This rank's index along ``model``."""
    return ctx.shard.mesh.get_local_rank("model")


def _axes_block(axes: Tuple[str, ...], mesh) -> Tuple[int, int]:
    """(this rank's index, the number of blocks) along ``axes``, the
    first the major."""
    return SH.block_index(axes, mesh, {a: mesh.get_local_rank(a)
                                       for a in axes})


def _narrow(t: torch.Tensor, dim: int, size: int, axes, mesh):
    """This rank's block of ``size`` along ``dim`` of ``t`` over ``axes``."""
    i, _ = _axes_block(axes, mesh)
    return t.narrow(dim, i * size, size)


def _psum(y: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``y`` summed over the ranks of each axis of ``axes`` in turn
    (``collectives.psum``)."""
    for a in coll.live_axes(mesh, axes):
        y = coll.psum(y, mesh, a)
    return y


def _gather_last(y: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``y``, this rank's block of its last dim over ``axes`` (the first
    the major), gathered whole: one ``collectives.all_gather_dim`` an
    axis, the minor first, so that its backward reduce-scatters the
    cotangent over them in fp32 (JAX's transpose of the gather)."""
    for a in reversed(tuple(axes)):
        y = coll.all_gather_dim(y, mesh, a, y.dim() - 1)
    return y


def _hidden_axes(ctx: Ctx, width: int) -> Tuple[str, ...]:
    """The axes a ``width``-wide residual stream splits over on
    ``ctx``'s mesh (``ActSharder.hidden_axes``; () on one card)."""
    return () if ctx.shard is None else ctx.shard.hidden_axes(width)


def seq_split(shard, seq_len: int) -> Tuple[str, ...]:
    """The axes of more than one rank that the residual stream's sequence
    of ``seq_len`` tokens splits over between blocks on ``shard``'s mesh
    (``ActSharder.seq_axes``: ``SEQPAR_RULES``' ``act_seq``); () on one
    card and wherever the stream stays whole."""
    if shard is None:
        return ()
    return coll.live_axes(shard.mesh, shard.seq_axes(seq_len))


def _seq_ranks(seq, shard) -> int:
    """The number of blocks a sequence split over ``seq`` has."""
    return math.prod(SH.mesh_shape(shard.mesh)[a] for a in seq) if seq else 1


def _seq_lo(rows: int, seq, shard) -> int:
    """The first position of this rank's ``rows`` of a sequence split
    over ``seq``; 0 where it is whole."""
    return _axes_block(seq, shard.mesh)[0] * rows if seq else 0


def _seq_cut(t: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """This rank's rows of ``t``'s whole sequence (dim 1) where the stream
    splits (``ctx.seq``); ``t`` elsewhere."""
    if not ctx.seq:
        return t
    return _narrow(t, 1, t.shape[1] // _seq_ranks(ctx.seq, ctx.shard),
                   ctx.seq, ctx.shard.mesh)


def _seq_gather(t: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``t``, this rank's rows of the sequence (dim 1), gathered whole over
    ``ctx.seq`` (``collectives.all_gather_dim``, the minor axis first; its
    backward sums the cotangent over them in fp32); ``t`` where the stream
    is whole."""
    for a in reversed(ctx.seq):
        t = coll.all_gather_dim(t, ctx.shard.mesh, a, 1)
    return t


def _psum_rows(y: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The partials ``y`` (B, S, ...) summed over ``model``: where the
    stream splits over ``model`` alone, a reduce-scatter to this rank's
    rows (``collectives.psum_scatter``, in fp32, its backward an
    all-gather), else ``collectives.psum``, then the rank's rows where
    the stream splits."""
    mesh = ctx.shard.mesh
    if ctx.seq == ("model",):
        return coll.psum_scatter(y, mesh, "model", 1)
    return _seq_cut(coll.psum(y, mesh, "model"), ctx)


def _rms_norm(x, scale, eps: float, ctx: Ctx):
    """``layers.rms_norm``; where ``x`` is this rank's block of the
    residual stream's hidden dim (``DECODE_RULES``' ``act_hidden``), the
    mean of squares is taken over the whole width: the blocks' sums of
    squares summed over ``act_hidden``'s axes in fp32, and the rank's
    block of ``scale`` applied."""
    width = scale.shape[-1]
    if x.shape[-1] == width:
        return L.rms_norm(x, scale, eps)
    axes, mesh = _hidden_axes(ctx, width), ctx.shard.mesh
    x32 = x.float()
    var = _psum(x32.square().sum(dim=-1, keepdim=True), mesh, axes) / width
    w = _narrow(scale, -1, x.shape[-1], axes, mesh)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def _cols(a, ws, ctx: Ctx, width: int, bs=None, outs=None):
    """``[a @ w (+ b) for w, b in zip(ws, bs)]``, column-parallel products
    over an in-dim of ``width``.  Where it is split (``DECODE_RULES``: the
    weights 2-D resident, their ``fsdp`` in-dim over data; ``a`` the
    rank's block of the residual stream), the rank multiplies its block
    of ``a`` by its block of each weight (the one of the two that is
    whole narrowed to the other), the partials of every product are
    summed over those axes in one fp32 all-reduce and rounded once to
    ``a``'s dtype, as one card's GEMM accumulates its contraction, and
    the bias is added after the sum.  An output narrower than its
    ``outs`` width (a leaf ``compute_defs`` keeps whole over ``model``,
    stored split) is then gathered over ``model``: a one-token row at
    decode.  Elsewhere ``_proj`` of each, as one card computes it."""
    bs = bs or [None] * len(ws)
    outs = outs or [None] * len(ws)
    if a.shape[-1] == width and all(w.shape[0] == width for w in ws):
        ys = [_proj(a, w, b) for w, b in zip(ws, bs)]
    else:
        sh = ctx.shard
        mesh = sh.mesh
        axes = (sh.hidden_axes(width) if a.shape[-1] < width else
                SH._fit_axes(width, sh.rules["fsdp"], mesh))
        size = width // math.prod(SH.mesh_shape(mesh)[x] for x in axes)
        if a.shape[-1] == width:
            a = _narrow(a, -1, size, axes, mesh)
        parts = [a.float() @ (w if w.shape[0] == size else
                              _narrow(w, 0, size, axes, mesh)).float()
                 for w in ws]
        n = [p.shape[-1] for p in parts]
        y = _psum(torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0],
                  mesh, axes).to(a.dtype)
        ys = [yi if b is None else yi + b.to(yi.dtype)
              for yi, b in zip(y.split(n, dim=-1), bs)]
    return [y if out is None or y.shape[-1] == out else
            _gather_last(y, SH._fit_axes(out, ctx.shard.rules["tp"],
                                         ctx.shard.mesh), ctx.shard.mesh)
            for y, out in zip(ys, outs)]


def _to_hidden(x, ctx: Ctx):
    """``x`` (..., D), a whole row of the residual stream, cut to this
    rank's block of its hidden dim where the stream splits
    (``_hidden_axes``); ``x`` itself elsewhere."""
    axes = _hidden_axes(ctx, x.shape[-1])
    if not axes:
        return x
    mesh = ctx.shard.mesh
    n = math.prod(SH.mesh_shape(mesh)[a] for a in axes)
    return _narrow(x, -1, x.shape[-1] // n, axes, mesh)


def _attn_outs(cfg: ModelConfig, ctx: Ctx, qdim: int, kvdim: int):
    """The widths ``_cols`` is to give the q and the K/V products at: the
    whole flat width where ``head_split`` keeps those heads whole, None
    (the computed block) where they split, None on one card."""
    if ctx.shard is None:
        return None, None
    heads, kv_heads = head_split(cfg, ctx.shard.mesh, ctx.shard.rules)
    return (None if heads else cfg.num_heads * qdim,
            None if kv_heads else cfg.num_kv_heads * kvdim)


def _conv(x, w, state, ctx: Ctx):
    """``layers.causal_conv1d``; where ``w`` is this rank's block of the
    channels and ``x`` whole (``DECODE_RULES``: the SSD block's
    ``conv_w`` resident, its channels over ``model``), the rank's
    channels convolved and the output and new state gathered whole."""
    if w.shape[-1] == x.shape[-1]:
        return L.causal_conv1d(x, w, state)
    mesh, c = ctx.shard.mesh, w.shape[-1]
    axes = SH._fit_axes(x.shape[-1], ctx.shard.rules["tp"], mesh)
    y, st = L.causal_conv1d(
        _narrow(x, -1, c, axes, mesh), w,
        None if state is None else _narrow(state, -1, c, axes, mesh))
    return _gather_last(y, axes, mesh), _gather_last(st, axes, mesh)


def _row_parallel(a, w, ctx: Ctx, split: bool, stream: bool = True):
    """``a @ w``; where ``split``, ``w`` is this rank's block of rows (the
    contraction dim split over ``model``, ``a`` the matching columns) and
    the ranks' partial products are summed over ``model``
    (``collectives.psum``, whose backward all-reduces the cotangent: a
    replicated activation's cotangent is a set of partials that sum to the
    true one over the ranks, as the training step's loss × 1/ranks has it).
    The partials are taken and summed in fp32 and rounded once to ``a``'s
    dtype, as one card's GEMM accumulates its whole contraction.  A
    stored block of rows narrower than ``a`` (``DECODE_RULES``: a leaf
    ``compute_defs`` keeps whole, resident) takes the rank's columns of
    ``a`` and is summed the same way; ``w``'s columns are then the rank's
    block of the residual stream.  Where the product joins the residual
    stream (``stream``) and the stream splits along the sequence
    (``ctx.seq``, ``SEQPAR_RULES``), the output is the rank's rows: the
    sum a reduce-scatter (``_psum_rows``), a product computed whole cut.
    A sum that feeds a scan (the RG-LRU's gates) passes ``stream=False``
    and stays whole."""
    if w.shape[0] < a.shape[-1]:
        mesh = ctx.shard.mesh
        a = _narrow(a, -1, w.shape[0], SH._fit_axes(
            a.shape[-1], ctx.shard.rules["tp"], mesh), mesh)
        split = True
    if not split:
        y = _proj(a, w)
        return _seq_cut(y, ctx) if stream else y
    y = a.float() @ w.float()
    if stream:
        return _psum_rows(y, ctx).to(a.dtype)
    return coll.psum(y, ctx.shard.mesh, "model").to(a.dtype)


def _rank_kv(cfg: ModelConfig, k, v, heads: int, ctx: Ctx):
    """The kv head this rank's ``heads`` q heads read, where q is split
    over ``model`` and K/V were computed whole (their heads do not divide
    over it: RecurrentGemma's one, qwen3-8b's 8 over 16 ranks; the q heads
    of a rank then lie in one kv group, ``compute_defs``)."""
    if heads == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k, v
    kv = _model_index(ctx) * heads // (cfg.num_heads // cfg.num_kv_heads)
    return k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]


def _rope_ctx(cfg: ModelConfig, positions, head_dim):
    if cfg.rope == "mrope":
        return L.mrope_angles(positions, head_dim, cfg.rope_theta,
                              sections=(1, 1, 1))
    return L.rope_angles(positions, head_dim, cfg.rope_theta)


# --- GQA attention block -------------------------------------------------------

def attn_forward(cfg: ModelConfig, p, x, ctx: Ctx, *, window=0,
                 kv_override=None, cross=False):
    """Causal GQA attention over the whole block, windowed if ``window``:
    projections (with the QKV bias), then the qk-norm over the head dim,
    then RoPE, in the JAX package's order.  ``kv_override``: (k, v) for
    cross-attention (``cross``), which is non-causal, with no qk-norm and
    no RoPE.  The heads are the blocks': over ``model`` a rank's q heads
    (and kv heads where they divide), ``wo`` row-parallel.  Where ``x`` is
    the rank's rows of the sequence (``ctx.seq``), the normed rows are
    gathered whole first and ``wo`` ends on the rank's rows."""
    Dh = cfg.resolved_head_dim
    h = _seq_gather(_rms_norm(x, p["ln"], cfg.norm_eps, ctx), ctx)
    oq, okv = _attn_outs(cfg, ctx, Dh, Dh)
    if kv_override is None:
        q, k, v = _cols(h, [p["wq"], p["wk"], p["wv"]], ctx, cfg.d_model,
                        [p.get("bq"), p.get("bk"), p.get("bv")],
                        [oq, okv, okv])
        k = _heads(k, k.shape[-1] // Dh, Dh)
        v = _heads(v, v.shape[-1] // Dh, Dh)
    else:
        (q,) = _cols(h, [p["wq"]], ctx, cfg.d_model, [p.get("bq")], [oq])
        k, v = kv_override
    H = q.shape[-1] // Dh
    q = _heads(q, H, Dh)
    k, v = _rank_kv(cfg, k, v, H, ctx)
    if cfg.qk_norm and not cross:
        q = L.rms_norm(q, p["qn"], cfg.norm_eps)
        if kv_override is None:
            k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope in ("rope", "mrope") and not cross:
        q = L.apply_rope(q, ctx.cos, ctx.sin)
        if kv_override is None:
            k = L.apply_rope(k, ctx.cos, ctx.sin)
    o = L.blocked_attention(q, k, v, causal=not cross, window=window,
                            chunk=cfg.attn_chunk, unroll=cfg.attn_unroll)
    o = o.reshape(h.shape[0], h.shape[1], H * v.shape[-1])
    return x + _row_parallel(o, p["wo"], ctx, H < cfg.num_heads)


# --- MLA attention block ---------------------------------------------------------

def mla_latent(cfg: ModelConfig, p, h, ctx: Ctx):
    """The normed kv latent (B, S, r) and the roped key its heads share
    (B, S, dr) of the normed block input ``h``: what the MLA cache holds."""
    r = cfg.kv_lora_rank
    (kv,) = _cols(h, [p["wkv_a"]], ctx, cfg.d_model)
    lat = L.rms_norm(kv[..., :r], p["kv_ln"], cfg.norm_eps)
    kr = L.apply_rope(kv[..., r:][:, :, None, :], ctx.cos_r, ctx.sin_r)
    return lat, kr[:, :, 0]


def mla_q_latent(cfg: ModelConfig, p, h, ctx: Ctx):
    """The q latent (B, S, q_lora_rank) of the normed block input ``h``,
    before its norm: ``wq_a`` is computed whole (``compute_defs``; stored
    resident under ``DECODE_RULES``, its output gathered over
    ``model``)."""
    (cq,) = _cols(h, [p["wq_a"]], ctx, cfg.d_model, outs=[cfg.q_lora_rank])
    return cq


def mla_forward(cfg: ModelConfig, p, x, ctx: Ctx):
    """Multi-head latent attention over the whole block, causal: q from the
    normed q latent, the heads' nope keys and values from the normed kv
    latent, one rope key shared by the heads; each head attends with q/k
    head dim nope + rope and v head dim ``v_head_dim`` (K5 on the card, at
    minicpm3-4b's (96, 64); under autograd K5b at the same pair).  The
    gradient flows through the latents' norms and the rope key, which
    ``expand`` shares over the heads (its gradient the sum over them).
    Over ``model`` a rank takes its heads of ``wq_b``, ``wk_b``, ``wv_b``
    and ``wo``; the latents are computed whole (over a sequence split
    along ``ctx.seq``, from the gathered rows)."""
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = _seq_gather(_rms_norm(x, p["ln"], cfg.norm_eps, ctx), ctx)
    oq, _ = _attn_outs(cfg, ctx, dn + dr, 0)
    cq = L.rms_norm(mla_q_latent(cfg, p, h, ctx), p["q_ln"], cfg.norm_eps)
    (q,) = _cols(cq, [p["wq_b"]], ctx, cfg.q_lora_rank, outs=[oq])
    H = q.shape[-1] // (dn + dr)
    q = _heads(q, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = L.apply_rope(q[..., dn:], ctx.cos_r, ctx.sin_r)
    lat, k_rope = mla_latent(cfg, p, h, ctx)
    ok, ov = _attn_outs(cfg, ctx, dn, dv)
    k_nope, v = _cols(lat, [p["wk_b"], p["wv_b"]], ctx, cfg.kv_lora_rank,
                      outs=[ok, ov])
    k_nope, v = _heads(k_nope, H, dn), _heads(v, H, dv)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope[:, :, None].expand(*k_nope.shape[:3], dr)],
                   dim=-1)
    o = L.blocked_attention(qf, kf, v, causal=True, chunk=cfg.attn_chunk,
                            unroll=cfg.attn_unroll)
    o = o.reshape(h.shape[0], h.shape[1], H * dv)
    return x + _row_parallel(o, p["wo"], ctx, H < cfg.num_heads)


# --- FFN -------------------------------------------------------------------------

def ffn_forward(cfg: ModelConfig, p, x, ctx: Ctx):
    """The dense gated MLP, or the top-k MoE FFN: over a mesh whose
    ``model`` axis is larger than 1 the expert-parallel path (``moe_ep``,
    under the JAX package's conditions: ``moe_ep.moe_layout``), else over
    the flattened tokens (the gather path), in token blocks of
    ``moe_block_tokens`` (halved until it divides B*S) past twice that
    many tokens.  Over a hidden-split stream (``DECODE_RULES``) the MoE
    takes the normed rows whole and cuts its output back to the rank's
    block; the MLP's ``w1``/``w3`` are column-parallel (``_cols``).  Over
    a sequence split along ``ctx.seq`` the normed rows are gathered whole
    (routing and capacity see every token, as one card's), the MoE's
    output cut to the rank's rows and ``w2``'s sum a reduce-scatter."""
    h = _seq_gather(_rms_norm(x, p["ln"], cfg.norm_eps, ctx), ctx)
    if cfg.num_experts:
        if h.shape[-1] < cfg.d_model:
            # the experts' in_specs take whole-width rows: the rank's
            # block of the stream gathered, the output cut back to it
            h = _gather_last(h, _hidden_axes(ctx, cfg.d_model),
                             ctx.shard.mesh)
        B, S, D = h.shape
        sh = ctx.shard
        layout = (moe_ep.moe_layout(cfg, sh.mesh, sh.batch_axes)
                  if sh is not None else None)
        if layout is not None:
            fn = (moe_ep.moe_ffn_ep_resident if layout == "ep_resident"
                  else moe_ep.moe_ffn_ep)
            y, _ = fn(h, p["wg"], p["w1"], p["w3"], p["w2"],
                      num_experts=cfg.num_experts,
                      d_ff=cfg.moe_d_ff or cfg.d_ff, k=cfg.experts_per_token,
                      capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
                      mesh=sh.mesh, batch_axes=sh.batch_axes)
            return x + _seq_cut(_to_hidden(y, ctx), ctx)
        bt = 0
        if cfg.moe_block_tokens and B * S > 2 * cfg.moe_block_tokens:
            bt = cfg.moe_block_tokens
            while (B * S) % bt:
                bt //= 2
        y, _ = L.moe_ffn(
            h.reshape(B * S, D), p["wg"].to(h.dtype), p["w1"], p["w3"],
            p["w2"], num_experts=cfg.num_experts, k=cfg.experts_per_token,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
            block_tokens=bt)
        return x + _seq_cut(_to_hidden(y.reshape(B, S, D), ctx), ctx)
    a1, a3 = _cols(h, [p["w1"], p["w3"]], ctx, cfg.d_model)
    y = _row_parallel(L.act_fn(cfg.act)(a1) * a3, p["w2"], ctx,
                      p["w2"].shape[0] < cfg.d_ff)
    return x + y


# --- RG-LRU block --------------------------------------------------------------

def rglru_forward(cfg: ModelConfig, p, x, ctx: Ctx, h0=None, conv0=None):
    """The RG-LRU block.  Over ``model`` a rank holds its channels of
    ``wx``, ``wy``, ``conv_w`` and the rows of ``wga``, ``wgx`` and ``wo``:
    the gates are computed as JAX's partitioner does, the rank's rows'
    products summed over ``model`` (one ``psum`` for both) with the biases
    added after the sum, then cut to the rank's channels, ``log_a`` with
    them; ``wo`` is row-parallel.  Over a sequence split along
    ``ctx.seq`` the normed rows are gathered whole (the conv and the scan
    need every token), the gates' sum stays whole and ``wo``'s ends on
    the rank's rows."""
    h = _seq_gather(_rms_norm(x, p["ln"], cfg.norm_eps, ctx), ctx)
    gy, xb = _cols(h, [p["wy"], p["wx"]], ctx, cfg.d_model)
    gate = L.act_fn("gelu")(gy)
    xb, conv_state = L.causal_conv1d(xb, p["conv_w"], conv0)
    Wl, W = xb.shape[-1], p["wga"].shape[-1]
    if Wl == W:
        ga = _proj(xb, p["wga"], p["bga"])
        gx = _proj(xb, p["wgx"], p["bgx"])
        log_a = p["log_a"]
    else:
        g = _row_parallel(xb, torch.cat([p["wga"], p["wgx"]], dim=1), ctx,
                          True, stream=False)
        lo = _model_index(ctx) * Wl
        cut = slice(lo, lo + Wl)
        ga = g[..., cut] + p["bga"][cut].to(g.dtype)
        gx = g[..., W:][..., cut] + p["bgx"][cut].to(g.dtype)
        log_a = p["log_a"][cut]
    seq, h_last = L.rglru(xb, gx, ga, log_a, h0)
    y = _row_parallel(seq * gate, p["wo"], ctx, Wl < W)
    return x + y, (h_last, conv_state)


# --- Mamba-2 SSD block -----------------------------------------------------------

def ssd_forward(cfg: ModelConfig, p, x, ctx: Ctx, h0=None, conv0=None):
    """The Mamba-2 block, computed whole on every rank; over a sequence
    split along ``ctx.seq`` from the gathered normed rows, its output cut
    to the rank's rows."""
    D = cfg.d_model
    din = cfg.ssm_expand * D
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = din // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = _seq_gather(_rms_norm(x, p["ln"], cfg.norm_eps, ctx), ctx)
    (zxbcdt,) = _cols(h, [p["in_proj"]], ctx, D,
                      outs=[2 * din + 2 * G * N + H])
    z, xs, BC, dt = torch.split(zxbcdt, [din, din, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xs, BC], dim=-1)
    conv_out, conv_state = _conv(conv_in, p["conv_w"], conv0, ctx)
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = torch.split(conv_out, [din, G * N, G * N], dim=-1)
    Bsz, S = h.shape[0], h.shape[1]
    xh = xs.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    y, h_last = L.ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, h0=h0)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, din)
    y = L.rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = _row_parallel(y, p["out_proj"], ctx, False)
    return x + out, (h_last, conv_state)


# ---------------------------------------------------------------------------
# full forward (prefill, no cache)
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: str, p, x, ctx: Ctx):
    if kind == "attn":
        if cfg.attention == "mla":
            x = mla_forward(cfg, p["attn"], x, ctx)
        else:
            window = cfg.sliding_window if cfg.family == "hybrid" else 0
            x = attn_forward(cfg, p["attn"], x, ctx, window=window)
    elif kind == "rglru":
        x, _ = rglru_forward(cfg, p["rec"], x, ctx)
    elif kind == "ssd":
        x, _ = ssd_forward(cfg, p["ssd"], x, ctx)
    if "xattn" in p and ctx.enc_out is not None:
        xp = p["xattn"]
        x = attn_forward(cfg, xp, x, ctx, kv_override=cross_kv(cfg, xp, ctx),
                         cross=True)
    if "ffn" in p:
        x = ffn_forward(cfg, p["ffn"], x, ctx)
    return x


def cross_kv(cfg: ModelConfig, xp, ctx: Ctx):
    """Cross-attention's K and V (B, encoder_seq, KV, Dh), from the
    encoder's output under the block's ``xattn`` norm; KV the block's kv
    heads (over ``model`` a rank's, where they divide)."""
    Dh = cfg.resolved_head_dim
    hk = _rms_norm(ctx.enc_out, xp["ln"], cfg.norm_eps, ctx)
    _, okv = _attn_outs(cfg, ctx, Dh, Dh)
    k, v = _cols(hk, [xp["wk"], xp["wv"]], ctx, cfg.d_model,
                 outs=[okv, okv])
    return _heads(k, k.shape[-1] // Dh, Dh), _heads(v, v.shape[-1] // Dh, Dh)


def group_params(blocks: Pytree, g: int) -> Pytree:
    """Layer group ``g`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[g], blocks)


def num_groups(blocks: Pytree) -> int:
    return tree_leaves(blocks)[0].shape[0] if blocks else 0


def run_decoder_blocks(cfg: ModelConfig, params, x, ctx: Ctx):
    """Every layer in order; on a mesh each block's stored blocks
    resharded as it runs (``computed``), each group and ``rem`` layer
    under remat where ``cfg.remat`` (the JAX package's ``jax.checkpoint``
    of ``group_fn`` and ``rem_fn``)."""
    pattern = cfg.block_pattern
    place = ctx.place

    def group(gp, x):
        for j, kind in enumerate(pattern):
            key = f"b{j}_{kind}"
            x = apply_block(cfg, kind, computed(gp[key], place, "blocks",
                                                key), x, ctx)
        return x

    blocks = params["blocks"]
    for g in range(num_groups(blocks)):
        x = _remat(cfg.remat, group, group_params(blocks, g), x)
    for j, lp in enumerate(params["rem"]):
        kind = pattern[j % len(pattern)]
        x = _remat(cfg.remat, lambda p, x, kind=kind, j=j: apply_block(
            cfg, kind, computed(p, place, "rem", j), x, ctx), lp, x)
    return x


def encode(cfg: ModelConfig, params, frames, shard=None):
    """Whisper-style bidirectional encoder over precomputed frame
    embeddings (B, S_enc, D): each block non-causal attention (K5 on the
    card) and the FFN (``run_encoder_blocks``), then the final norm."""
    enc = params["encoder"]
    place = placement(cfg, shard)
    ctx = Ctx(cfg=cfg, shard=shard, place=place)
    pos = computed(enc["pos_embed"], place, "encoder", "pos_embed")
    x = _to_hidden(frames + pos[None, : frames.shape[1]].to(frames.dtype),
                   ctx)
    x = run_encoder_blocks(cfg, enc["blocks"], x, ctx)
    return _rms_norm(x, computed(enc["final_norm"], place, "encoder",
                             "final_norm"), cfg.norm_eps, ctx)


def run_encoder_blocks(cfg: ModelConfig, blocks, x, ctx: Ctx):
    """Every encoder block in order (the stacked ``blocks``), each on a
    mesh resharded as it runs and under remat where ``cfg.remat`` (the
    JAX package's ``jax.checkpoint`` of ``block``); over ``model`` a rank
    computes its heads, ``wo`` row-parallel."""
    place = ctx.place
    Dh = cfg.resolved_head_dim
    oq, okv = _attn_outs(cfg, ctx, Dh, Dh)

    def block(bp, x):
        bp = computed(bp, place, "encoder", "blocks")
        a = bp["attn"]
        h = _rms_norm(x, a["ln"], cfg.norm_eps, ctx)
        q, k, v = _cols(h, [a["wq"], a["wk"], a["wv"]], ctx, cfg.d_model,
                        outs=[oq, okv, okv])
        H, KV = q.shape[-1] // Dh, k.shape[-1] // Dh
        q = _heads(q, H, Dh)
        k, v = _rank_kv(cfg, _heads(k, KV, Dh), _heads(v, KV, Dh), H, ctx)
        o = L.blocked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk,
                                unroll=cfg.attn_unroll)
        o = o.reshape(x.shape[0], x.shape[1], H * Dh)
        x = x + _row_parallel(o, a["wo"], ctx, H < cfg.num_heads)
        return ffn_forward(cfg, bp["ffn"], x, ctx)

    for g in range(num_groups(blocks)):
        x = _remat(cfg.remat, block, group_params(blocks, g), x)
    return x


class _TokenRows(torch.autograd.Function):
    """``table[tokens]``, whose gradient sums the rows of a repeated token
    in fp32 and rounds once to the table's dtype.  Indexing's own backward
    accumulates in the table's dtype: in bf16 a token seen N times takes
    up to N roundings, and the frequent tokens of a Zipf stream are seen
    hundreds of times a batch (on an H100, qwen3-moe's bf16 embedding
    gradient at 4 x 1024 tokens moved 16% between one card and a mesh
    that split the batch over two ranks, the rest of the tree 0.2%).  The
    fp32 sums are held for the batch's distinct tokens only, not the whole
    table."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        rows, inv = torch.unique(tokens.reshape(-1).long(),
                                 return_inverse=True)
        acc = g.new_zeros((rows.numel(), ctx.shape[-1]), dtype=torch.float32)
        acc.index_put_((inv,), g.reshape(-1, ctx.shape[-1]).float(),
                       accumulate=True)
        out = g.new_zeros(ctx.shape, dtype=ctx.dtype)
        out[rows] = acc.to(ctx.dtype)
        return out, None


def vocab_split(cfg: ModelConfig, width: int, shard
                ) -> Optional[Tuple[Any, int]]:
    """(the mesh, the first vocabulary id of this rank's block) where a
    rank computes a block of ``width`` of the padded vocabulary (the
    embedding's rows, the head's and the logits' columns) over ``model``;
    None where it computes them whole."""
    if shard is None or width == cfg.padded_vocab:
        return None
    return shard.mesh, shard.mesh.get_local_rank("model") * width


def embed_tokens(cfg: ModelConfig, params, tokens, place=None, shard=None,
                 seq: Tuple[str, ...] = ()):
    """The token rows of the embedding; on a mesh (``place``) of the
    table's compute block.  The gathered table is no input of a saved
    tensor (``_TokenRows`` keeps the tokens), so nothing of it is kept for
    the backward.  Split over the vocabulary (``shard``, ``vocab_split``),
    a rank looks up the tokens in its own rows, zeros for the others, and
    the ranks' rows are summed over ``model``: one of them is not zero.
    Where the residual stream splits over its hidden dim (``DECODE_RULES``)
    the rows are the rank's block of their columns, cut before the
    sum.  Where it splits along the sequence (``seq``, ``seq_split``) the
    rank's rows come back: a whole table looks up the rank's tokens
    alone, a split one sums its partial rows by a reduce-scatter."""
    table = computed(params["embed"], place, "embed")
    split = vocab_split(cfg, table.shape[0], shard)
    hid = Ctx(cfg=cfg, shard=shard, seq=seq)
    if split is None:
        x = _to_hidden(_TokenRows.apply(table, _seq_cut(tokens, hid)), hid)
    else:
        _, lo = split
        local = tokens.long() - lo
        mine = (local >= 0) & (local < table.shape[0])
        x = _TokenRows.apply(table, torch.where(mine, local, 0))
        x = _psum_rows(_to_hidden(torch.where(mine[..., None], x, 0), hid),
                       hid)
    if cfg.family == "hybrid":                       # gemma-style embed scale
        # the scale rounded to the model's dtype first (bf16: 50.5, not
        # 50.596 at d_model 2560), as the JAX package does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(cfg: ModelConfig, params, x, place=None, shard=None,
            seq: Tuple[str, ...] = ()):
    """The final norm and the head (the embedding's transpose where tied);
    on a mesh (``place``) the head's compute block, under remat where
    ``cfg.remat``: split over the vocabulary (``shard``, ``vocab_split``),
    the rank's columns of the logits (column-parallel), the padding mask
    on its own.  Where the stream splits over its hidden dim
    (``DECODE_RULES``) the rank's block of it is contracted against its
    rows of the head, summed over ``data`` (``_cols``).  Where ``x`` is
    the rank's rows of the sequence (``seq``), they are normed, then
    gathered whole: the logits split the vocabulary, not the sequence
    (the JAX package's ``"logits"`` layout)."""
    key = "embed" if cfg.tie_embeddings else "lm_head"

    def run(head, norm, x):
        head = computed(head, place, key)
        ctx = Ctx(cfg=cfg, shard=shard, seq=seq)
        x = _seq_gather(_rms_norm(x, computed(norm, place, "final_norm"),
                                  cfg.norm_eps, ctx), ctx)
        w = head.T if cfg.tie_embeddings else head
        (logits,) = _cols(x, [w], ctx, cfg.d_model)
        if cfg.padded_vocab != cfg.vocab_size:
            # mask the padding columns with an additive bias
            split = vocab_split(cfg, w.shape[-1], shard)
            lo = 0 if split is None else split[1]
            cols = torch.arange(lo, lo + w.shape[-1], device=logits.device)
            pad_mask = torch.where(cols < cfg.vocab_size, 0.0, -1e30).to(
                logits.dtype)
            logits = logits + pad_mask[None, None, :]
        return logits

    return _remat(cfg.remat and place is not None, run, params[key],
                  params["final_norm"], x)


def default_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """The rotary positions of tokens at ``pos`` (B, S): those, or for
    M-RoPE the same position on all three t/h/w channels (B, S, 3), as the
    JAX package sets them where the caller gives none."""
    return pos[..., None].expand(*pos.shape, 3) if cfg.rope == "mrope" else pos


def rope_ctx(cfg: ModelConfig, positions) -> Ctx:
    """The context of a block of tokens at ``positions`` (B, S), or (B, S,
    3) for M-RoPE; MLA rotates only its rope dims (``cos_r``, ``sin_r``)."""
    ctx = Ctx(cfg=cfg)
    if cfg.rope in ("rope", "mrope"):
        if cfg.attention == "mla":
            ctx.cos_r, ctx.sin_r = _rope_ctx(cfg, positions,
                                             cfg.rope_head_dim)
        else:
            ctx.cos, ctx.sin = _rope_ctx(cfg, positions,
                                         cfg.resolved_head_dim)
    return ctx


def splice_frontend(cfg: ModelConfig, params, x, frontend_embeds,
                    place=None, shard=None, seq: Tuple[str, ...] = ()):
    """Early fusion: the patch embeddings (B, F, D), projected by
    ``patch_proj`` (on a mesh, ``place``, gathered, under remat where
    ``cfg.remat``), replace the first F of x's S positions, where the config
    has the ``vision_patches`` frontend and the caller gives them (over a
    hidden-split stream, ``shard``, the rank's block of their columns: the
    resident ``patch_proj``'s output gathered over ``model``, then cut;
    where ``x`` is the rank's rows of the sequence, ``seq``, those of its
    rows that lie among the first F).  F > S
    is refused (the JAX package's concatenation would return F positions
    where S were asked)."""
    if cfg.frontend != "vision_patches" or frontend_embeds is None:
        return x
    ctx = Ctx(cfg=cfg, shard=shard, seq=seq)
    rows = x.shape[1]
    F_, S = frontend_embeds.shape[1], rows * _seq_ranks(seq, shard)
    if F_ > S:
        raise ValueError(f"{cfg.name}: {F_} frontend positions, past the "
                         f"{S}-token prompt they would replace")
    pe = _remat(cfg.remat and place is not None,
                lambda w, fe: _cols(fe.to(x.dtype), [computed(
                    w, place, "patch_proj")], ctx, cfg.d_model,
                    outs=[cfg.d_model])[0],
                params["patch_proj"], frontend_embeds)
    lo = _seq_lo(rows, seq, shard)
    n = min(max(F_ - lo, 0), rows)
    return torch.cat([_to_hidden(pe[:, lo:lo + n], ctx), x[:, n:]], dim=1)


def add_positions(cfg: ModelConfig, params, x, place=None, shard=None,
                  seq: Tuple[str, ...] = ()):
    """x (B, S, D) plus the learned positions 0..S-1, where the config
    has them (on a mesh, ``place``, resharded; over a hidden-split stream,
    ``shard``, the rank's block of their columns; where ``x`` is the
    rank's rows of the sequence, ``seq``, the positions of those rows).
    A block longer than ``max_position`` is refused here (JAX's gather
    would clamp the index; a card's would fault)."""
    if cfg.rope != "learned":
        return x
    rows = x.shape[1]
    S = rows * _seq_ranks(seq, shard)
    if S > cfg.max_position:
        raise ValueError(f"{cfg.name}: {S} tokens, past the {cfg.max_position}"
                         f" learned positions")
    lo = _seq_lo(rows, seq, shard)
    return x + _to_hidden(computed(params["pos_embed"], place, "pos_embed")[
        lo:lo + rows].to(x.dtype), Ctx(cfg=cfg, shard=shard))


def encoder_ctx(cfg: ModelConfig, params, ctx: Ctx, encoder_frames, dtype):
    """Set ``ctx.enc_out`` from ``encoder_frames`` (None: no
    cross-attention), as the JAX package's forward and prefill do; with
    cross-attention and no encoder the frames pass through.  The frames
    are cast to the model's ``dtype`` first, so a bf16 Whisper takes
    ``TokenStream``'s fp32 frames (the JAX package raises on them)."""
    if encoder_frames is not None and (cfg.encoder_layers
                                       or cfg.cross_attention):
        frames = encoder_frames.to(dtype)
        ctx.enc_out = (encode(cfg, params, frames, ctx.shard)
                       if cfg.encoder_layers else frames)
    return ctx


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            frontend_embeds=None, encoder_frames=None,
            shard=None) -> torch.Tensor:
    """Full forward over a token block -> logits (B, S, padded vocab).
    ``positions``: the rotary positions, (B, S), or (B, S, 3) t/h/w for
    M-RoPE (None: 0..S-1 on every channel); ``frontend_embeds`` (B, F, D)
    the patch embeddings that replace the first F positions;
    ``encoder_frames`` (B, encoder_seq, D) feed the encoder and
    cross-attention; ``shard`` a mesh's ``sharding.ActSharder``, where the
    logits are the rank's block of the vocabulary (the JAX package's
    ``"logits"`` layout; ``vocab_split``) wherever it splits over
    ``model``.  Under ``SEQPAR_RULES`` the residual stream is the rank's
    rows of the sequence from the embedding to the final norm
    (``seq_split``; the JAX package's ``shard(x, "act")`` after the
    positions and at the end of every block): each layer's remat unit
    keeps those rows alone."""
    B, S = tokens.shape
    place = placement(cfg, shard)
    seq = seq_split(shard, S)
    x = splice_frontend(cfg, params,
                        embed_tokens(cfg, params, tokens, place, shard, seq),
                        frontend_embeds, place, shard, seq)
    x = add_positions(cfg, params, x, place, shard, seq)
    if positions is None:
        positions = default_positions(
            cfg, torch.arange(S, device=tokens.device)[None].expand(B, S))
    ctx = rope_ctx(cfg, positions)
    ctx.shard, ctx.place, ctx.seq = shard, place, seq
    ctx = encoder_ctx(cfg, params, ctx, encoder_frames, x.dtype)
    x = run_decoder_blocks(cfg, params, x, ctx)
    return unembed(cfg, params, x, place, shard, seq)


def gather_vocab(cfg: ModelConfig, logits: torch.Tensor, shard
                 ) -> torch.Tensor:
    """``logits`` (B, S, block) whole over the vocabulary: the ranks'
    blocks gathered over ``model`` where ``vocab_split`` says they are
    split (no gradient), else ``logits`` itself."""
    split = vocab_split(cfg, logits.shape[-1], shard)
    if split is None:
        return logits
    return coll.gather_block(logits, SH.P(None, None, "model"), split[0])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: Optional[Tuple[Any, int]] = None) -> torch.Tensor:
    """Mean cross-entropy in fp32, as the JAX package computes it: the max
    is detached (``stop_gradient``), and the label's logit is taken with
    ``gather``, the same number as JAX's one-hot sum, which adds only
    zeros to it.  ``vocab`` (``vocab_split``: the mesh and the first id of
    the rank's block) takes it over the logits' vocabulary blocks: the max
    by an all-reduce MAX over ``model``, the sum of exponentials by
    ``psum``, the label's logit by a gather from the rank that holds it,
    zero elsewhere, and ``psum``."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    if vocab is None:
        lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(dim=-1))
        lab = lg.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - lab).mean()
    mesh, lo = vocab
    m = coll.reduce_(m.contiguous(), mesh, ("model",), dist.ReduceOp.MAX)
    lse = m[..., 0] + torch.log(coll.psum(torch.exp(lg - m).sum(dim=-1),
                                          mesh, "model"))
    local = labels.long() - lo
    mine = (local >= 0) & (local < lg.shape[-1])
    lab = lg.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    lab = coll.psum(torch.where(mine, lab, 0.0), mesh, "model")
    return (lse - lab).mean()
