"""The step functions of the JAX package's ``launch/steps.py`` on one card:
``loss_fn``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step``.

There is no mesh and no sharding rules: the port runs on one card.  The
training step takes the gradient with ``torch.autograd.grad`` over the
parameter leaves (on the card the SSD scan's through K8b, attention's
through K5b and the RG-LRU's through K7b), accumulates
microbatches in a Python loop where the JAX package scans, applies the
int8 wire transform of ``distributed.compression`` (K3 and K4 on the card)
when ``tcfg.grad_compression == "int8"``, then AdamW.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    logits = T.forward(cfg, params, batch["tokens"],
                       frontend_embeds=batch.get("frontend_embeds"),
                       encoder_frames=batch.get("encoder_frames"))
    return T.softmax_xent(logits, batch["labels"])


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, grads) of ``loss_fn`` in the parameters, grads in each
    parameter's dtype, as ``jax.value_and_grad`` gives them."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
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
                                       {k: v[i] for k, v in mb.items()})
                lsum = lsum + l
                gsum = tree_map(torch.add, gsum, g)
            loss = lsum / n
            grads = tree_map(lambda g: g / n, gsum)
        else:
            loss, grads = value_and_grad(cfg, params, batch)
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


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return DE.prefill(cfg, params, batch["tokens"],
                          encoder_frames=batch.get("encoder_frames"),
                          frontend_embeds=batch.get("frontend_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        return DE.decode_step(cfg, params, cache, batch["tokens"])

    return decode_step
