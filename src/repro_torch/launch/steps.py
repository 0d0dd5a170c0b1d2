"""The step functions of the JAX package's ``launch/steps.py``:
``loss_fn``, ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, and ``shardings_for``, the spec trees of a cell.

Without a mesh a step runs on one card.  With one (``launch.mesh``), every
rank calls the step on its own blocks: the batch's and cache's block along
``batch_axes`` (the axes ``sharding.batch_axes`` gives the whole batch
under the caller's rules), the parameters ``transformer.place_params``
placed for the same ``batch_axes``; the ``sharding.ActSharder`` of the
mesh and those axes sends the MoE FFN down the expert-parallel path.
Training over more than one rank (the gradient's
reduction over data, the experts' backward) is not ported: such a train
step raises. The training step takes the gradient with
``torch.autograd.grad`` over the parameter leaves (on the card the SSD
scan's through K8b, attention's through K5b and the RG-LRU's through K7b),
accumulates microbatches in a Python loop where the JAX package scans,
applies the int8 wire transform of ``distributed.compression`` (K3 and K4
on the card) when ``tcfg.grad_compression == "int8"``, then AdamW.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
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
    return T.softmax_xent(logits, batch["labels"])


def value_and_grad(cfg: ModelConfig, params, batch, shard=None):
    """(loss, grads) of ``loss_fn`` in the parameters, grads in each
    parameter's dtype, as ``jax.value_and_grad`` gives them."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, shard)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _sharder(mesh, batch_axes):
    """No mesh: None (the one-card path as it was)."""
    return None if mesh is None else SH.make_act_sharder(mesh, batch_axes)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None):
    """The train step; ``mesh``: one of a single rank (more raise
    ``NotImplementedError``)."""
    if mesh is not None and SH.mesh_size(mesh) > 1:
        raise NotImplementedError(
            "make_train_step: training over a mesh of more than one rank is "
            "the next slice of the port (the data-parallel gradient "
            "reduction and the expert-parallel backward)")
    shard = _sharder(mesh, ())
    sched = adamw.cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

    def train_step(params, opt_state, batch):
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
                                       shard)
                lsum = lsum + l
                gsum = tree_map(torch.add, gsum, g)
            loss = lsum / n
            grads = tree_map(lambda g: g / n, gsum)
        else:
            loss, grads = value_and_grad(cfg, params, batch, shard)
        if tcfg.grad_compression == "int8":
            # int8 + error-feedback DP gradient compression: stateless per
            # step, as in the JAX package (zeros in, the residual dropped);
            # the quantize -> dequantize wire transform runs K3 and K4
            from repro_torch.distributed import compression as GC
            err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                 device=g.device), grads)
            grads, _ = GC.compress_grads(grads, err)
        params, opt_state, metrics = adamw.apply(
            params, grads, opt_state, sched=sched, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, mesh=None, batch_axes=()):
    """The prefill step; on ``mesh`` each rank passes its block of a batch
    split over ``batch_axes``."""
    shard = _sharder(mesh, batch_axes)

    def prefill_step(params, batch):
        return DE.prefill(cfg, params, batch["tokens"],
                          encoder_frames=batch.get("encoder_frames"),
                          frontend_embeds=batch.get("frontend_embeds"),
                          shard=shard)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None, batch_axes=()):
    """The decode step; on ``mesh`` as ``make_prefill_step``."""
    shard = _sharder(mesh, batch_axes)

    def decode_step(params, cache, batch):
        return DE.decode_step(cfg, params, cache, batch["tokens"],
                              shard=shard)

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
        cshapes = DE.cache_shapes(cfg, B, S)
        out["cache"] = SH.param_spec_tree(
            cshapes, DE.cache_logical_axes(cfg, B, S), rules, mesh)
        out["cache_shapes"] = cshapes
    return out
