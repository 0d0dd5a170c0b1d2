"""The step functions of the JAX package's ``launch/steps.py``:
``loss_fn``, ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, and ``shardings_for``, the spec trees of a cell.

Without a mesh a step runs on one card.  With one (``launch.mesh``), every
rank calls the step on its own blocks: the batch's and cache's block along
``batch_axes`` (the axes ``sharding.batch_axes`` gives the whole batch
under the caller's rules), and its block of every parameter under
``rules`` (``transformer.place_params``; ``TRAIN_RULES`` where None,
``TP_RULES`` and ``SEQPAR_RULES`` too, the last keeping the residual
stream split over ``model`` along the sequence between blocks:
``transformer.seq_split``).  Under ``DECODE_RULES`` every step runs: the
token batch over ``pod`` alone, every ``data`` rank the whole of it, the
weights resident, the residual stream split over ``data`` along the
hidden dim (the cache of the prefill and decode steps over ``pod`` and
``data``).  The ``sharding.ActSharder`` of the mesh, those
axes and the rules lets the model reshard each layer to the blocks it
computes with and sends the MoE FFN down the expert-parallel path.
The training step takes the gradient with ``torch.autograd.grad`` over
the parameter leaves (on the card the SSD scan's through K8b,
attention's through K5b and the RG-LRU's through K7b, the
expert-parallel MoE's through ``distributed.collectives``), accumulates
microbatches in a Python loop where the JAX package scans, applies the
int8 wire transform of ``distributed.compression`` (K3 and K4 on the
card) when ``tcfg.grad_compression == "int8"``, then AdamW, in place
(``adamw.apply_``).

Over a mesh the step computes the function JAX's jitted step computes on
the global batch: ``loss_fn`` takes the loss over the rank's vocabulary
block of the logits where they split over ``model``
(``transformer.softmax_xent``'s vocabulary-parallel form), and each rank
scales its loss by 1 / (the mesh's ranks).
The backward of each layer's reshard sums the cotangent of a gathered
block in fp32 over the axes it was gathered over; then (microbatches
accumulated within the rank) each leaf's gradient is summed in fp32 over
the rest of the ranks that hold the same block of it (``leaf_axes``: the
axes its stored block is not split over), so a rank ends with the
gradient of its own blocks.  The int8 transform then acts on the reduced
gradient, every split leaf's block (dense or expert) against the whole
leaf's absmax (K3's given-absmax mode); the global norm counts each block
once; ``metrics["loss"]`` is the global mean.  The convention holds
whatever the batch's layout, because every collective the forward
issues has JAX's transpose as its backward (``distributed.collectives``:
a gather's is a reduce-scatter, a ``psum``'s an all-reduce): the ranks'
scaled losses sum to the global mean, and each rank's gradient is its
share of that sum's.  Under ``DECODE_RULES`` every rank's loss is the
global mean itself (every rank holds every token), so each contributes
1 / (the mesh's ranks) of it; a leaf's block held by several ranks (a
norm's scale, whole on all of them) sums their shares.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as SH
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def loss_fn(cfg: ModelConfig, params, batch, shard=None) -> torch.Tensor:
    logits = T.forward(cfg, params, batch["tokens"],
                       frontend_embeds=batch.get("frontend_embeds"),
                       encoder_frames=batch.get("encoder_frames"),
                       shard=shard)
    return T.softmax_xent(logits, batch["labels"],
                          T.vocab_split(cfg, logits.shape[-1], shard))


def value_and_grad(cfg: ModelConfig, params, batch, shard=None,
                   scale: float = 1.0):
    """(loss, grads) of ``loss_fn`` in the parameters, grads in each
    parameter's dtype, as ``jax.value_and_grad`` gives them; ``scale``
    multiplies the loss that is differentiated (not the one returned)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, shard)
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _sharder(mesh, batch_axes, rules):
    """No mesh: None (the one-card path as it was)."""
    return (None if mesh is None
            else SH.make_act_sharder(mesh, batch_axes, rules))


def leaf_axes(cfg: ModelConfig, mesh, rules=None
              ) -> List[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """For each parameter leaf, in ``tree_leaves`` order: (the mesh axes
    its stored block is split over, the axes of more than one rank its
    gradient is summed over: every other axis), from
    ``transformer.param_block_specs`` of ``rules``."""
    specs = tree_leaves(T.param_block_specs(cfg, mesh, rules),
                        is_leaf=SH.is_spec)
    names = tuple(SH.mesh_shape(mesh))
    out = []
    for spec in specs:
        split = coll.split_axes(spec)
        out.append((split, coll.live_axes(
            mesh, [a for a in names if a not in split])))
    return out


def _reduce_grouped(values: torch.Tensor, groups, mesh, op) -> torch.Tensor:
    """``values`` (n,): entry i reduced over the axes ``groups[i]``, one
    collective a distinct group and axis."""
    for axes in sorted(set(groups)):
        if not coll.live_axes(mesh, axes):
            continue
        idx = torch.tensor([i for i, g in enumerate(groups) if g == axes],
                           device=values.device)
        values[idx] = coll.reduce_(values[idx], mesh, axes, op)
    return values


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None,
                 batch_axes: Tuple[str, ...] = (), rules=None):
    """``(params, batch) -> (loss, grads)``: the train step's loss and the
    gradient it hands AdamW (microbatches accumulated; over a mesh the
    global mean's, each leaf reduced as ``leaf_axes`` says, in fp32; int8
    when ``tcfg`` asks)."""
    rules = SH.resolve_rules(rules)
    shard = _sharder(mesh, batch_axes, rules)
    world = 1 if mesh is None else SH.mesh_size(mesh)
    axes = leaf_axes(cfg, mesh, rules) if world > 1 else None
    scale = 1.0 / world

    def grad_fn(params, batch):
        if tcfg.microbatches > 1:
            # gradient accumulation over microbatches, in fp32
            n = tcfg.microbatches
            mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            lsum = 0.0
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            for i in range(n):
                l, g = value_and_grad(cfg, params,
                                       {k: v[i] for k, v in mb.items()},
                                       shard, scale)
                lsum = lsum + l
                gsum = tree_map(torch.add, gsum, g)
            loss = lsum / n
            grads = tree_map(lambda g: g / n, gsum)
        else:
            loss, grads = value_and_grad(cfg, params, batch, shard, scale)
        leaves = tree_leaves(grads)
        del grads
        if axes is not None:
            # the global mean's gradient: each leaf summed over the ranks
            # that hold its block, in fp32, one leaf at a time
            for i, (_, over) in enumerate(axes):
                leaves[i] = coll.reduce_(leaves[i].float(), mesh, over)
            loss = coll.reduce_(loss * scale, mesh, tuple(SH.mesh_shape(mesh)))
        if tcfg.grad_compression == "int8":
            # int8 + error-feedback DP gradient compression: stateless per
            # step, as in the JAX package (zeros in, the residual dropped);
            # the quantize -> dequantize wire transform runs K3 and K4
            from repro_torch.distributed import compression as GC
            GC.wire_transform(leaves, None if axes is None else
                              _whole_absmax(leaves, axes, mesh))
        return loss, tree_unflatten(params, leaves)

    return grad_fn


def norm_reduction(cfg: ModelConfig, mesh=None, rules=None):
    """The ``reduce_sq`` of ``adamw.global_norm`` for a gradient tree of
    ``make_grad_fn`` over ``mesh``: each split leaf's sum of squares summed
    over the axes it is split on, so each block counts once.  None off a
    mesh of more than one rank."""
    if mesh is None or SH.mesh_size(mesh) == 1:
        return None
    split = [s for s, _ in leaf_axes(cfg, mesh, rules)]
    return lambda sq: _reduce_grouped(sq, split, mesh, dist.ReduceOp.SUM)


def _whole_absmax(leaves, axes, mesh):
    """Each leaf's whole absmax where this rank holds a block of it (the
    blocks' maxima, reduced MAX over the split axes), else None."""
    split = [coll.live_axes(mesh, s) for s, _ in axes]
    if not any(split):
        return None

    def local(g):
        lo, hi = torch.aminmax(g)
        return torch.maximum(-lo, hi).float()

    zero = leaves[0].new_zeros((), dtype=torch.float32)
    amax = torch.stack([local(g) if s else zero
                        for g, s in zip(leaves, split)])
    amax = _reduce_grouped(amax, split, mesh, dist.ReduceOp.MAX)
    return [amax[i] if s else None for i, s in enumerate(split)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None,
                    batch_axes: Tuple[str, ...] = (), rules=None):
    """The train step; on ``mesh`` each rank passes its blocks of the
    parameters and of the AdamW state (``transformer.place_params`` under
    the same ``rules``) and of a batch split over ``batch_axes``, and gets
    its blocks of the updated tree; the metrics are the whole tree's,
    equal on every rank.  The update is ``adamw.apply_``, in place, the
    JAX train step's donation: the step returns the parameter and state
    objects it was given, updated, and a caller that wants the old values
    hands it a copy."""
    grad_fn = make_grad_fn(cfg, tcfg, mesh=mesh, batch_axes=batch_axes,
                           rules=rules)
    reduce_sq = norm_reduction(cfg, mesh, rules)
    sched = adamw.cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = adamw.apply_(
            params, grads, opt_state, sched=sched, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
            reduce_sq=reduce_sq)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def cache_specs_for(cfg: ModelConfig, shard, batch: int, seq: int):
    """The specs of the decode cache of a rank's token block of ``batch``
    sequences of the whole ``seq`` positions over ``shard``'s mesh:
    ``sharding.cache_specs`` (``shardings_for``'s ``"cache"``) of the
    whole batch (``batch`` times the token batch axes' ranks: under
    ``DECODE_RULES`` ``pod``'s alone, while the cache's blocks split it
    over ``data`` too); None off a mesh."""
    if shard is None:
        return None
    Bg = batch * math.prod(SH.mesh_shape(shard.mesh)[a]
                           for a in shard.batch_axes)
    return SH.cache_specs(cfg, shard.mesh, Bg, seq, shard.rules)


def make_prefill_step(cfg: ModelConfig, *, mesh=None, batch_axes=(),
                      rules=None):
    """The prefill step; on ``mesh`` each rank passes its blocks of the
    parameters under ``rules`` and its block of a batch split over
    ``batch_axes``, and gets its blocks of the prompts' cache
    (``cache_specs_for``; under ``DECODE_RULES`` its batch rows of the
    tokens it was given)."""
    shard = _sharder(mesh, batch_axes, SH.resolve_rules(rules))

    def prefill_step(params, batch):
        B, S = batch["tokens"].shape
        return DE.prefill(cfg, params, batch["tokens"],
                          encoder_frames=batch.get("encoder_frames"),
                          frontend_embeds=batch.get("frontend_embeds"),
                          shard=shard,
                          specs=cache_specs_for(cfg, shard, B, S))

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None, batch_axes=(),
                     rules=None, seq=None):
    """The decode step; on ``mesh`` as ``make_prefill_step``, the cache
    the rank's blocks of one of ``seq`` positions (its capacity: a rank's
    block cannot tell whether the sequence is split)."""
    shard = _sharder(mesh, batch_axes, SH.resolve_rules(rules))
    if shard is not None and seq is None:
        raise ValueError("make_decode_step: over a mesh the cache's "
                         "capacity (seq) is needed for its specs")

    specs = {}                 # by the rank's batch: the same every token

    def decode_step(params, cache, batch):
        B = batch["tokens"].shape[0]
        if B not in specs:
            specs[B] = cache_specs_for(cfg, shard, B, seq)
        return DE.decode_step(cfg, params, cache, batch["tokens"],
                              shard=shard, specs=specs[B])

    return decode_step


# ---------------------------------------------------------------------------
# sharding trees for a cell
# ---------------------------------------------------------------------------

def shardings_for(cfg: ModelConfig, mesh, shape: ShapeConfig, rules=None,
                  with_opt: bool = False):
    """(param, [opt], batch, [cache]) spec trees of one cell, with the meta
    shape trees beside them: the JAX package's ``shardings_for``, with a
    ``sharding.P`` where it has a ``NamedSharding``."""
    from repro_torch.launch.specs import input_specs
    rules = rules or SH.TRAIN_RULES
    pshapes = T.param_shapes(cfg)
    pspec = SH.param_spec_tree(pshapes, T.param_logical_axes(cfg), rules,
                               mesh)
    bspecs = input_specs(cfg, shape)
    bsh = {k: (SH.batch_spec(tuple(s.shape), rules, mesh)
               if k in ("tokens", "labels") or s.dim() >= 2 else SH.P())
           for k, s in bspecs.items()}
    out = {"params": pspec, "param_shapes": pshapes, "batch": bsh,
           "batch_shapes": bspecs}
    if with_opt:
        out["opt"] = adamw.AdamWState(step=SH.P(), mu=pspec, nu=pspec)
        out["opt_shapes"] = adamw.state_shapes(pshapes)
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        out["cache"] = SH.cache_specs(cfg, mesh, B, S, rules)
        out["cache_shapes"] = DE.cache_shapes(cfg, B, S)
    return out
