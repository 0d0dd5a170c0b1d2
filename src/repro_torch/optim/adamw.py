"""AdamW + cosine schedule + gradient clipping.

The port of the JAX package's ``optim/adamw.py``, with the same formulas
and defaults: the state is shaped like the params (mu/nu fp32) plus an
int32 step, the schedule and the bias corrections (``b1 ** t`` included)
are fp32 tensors on the parameters' device, so a step never waits on the
host.  ``apply`` returns new trees, as the JAX version's function does;
``apply_``, which the train step calls, is the counterpart of the JAX
train step's donation (``donate_argnums=(0, 1)``): it writes the same
numbers into the parameters' and the moments' own storage, leaf by leaf,
so a step holds no second tree of either.  Gradient accumulation and the
optional int8 compression live in ``launch.steps.make_train_step``.
Over a mesh a rank may hold one block of a leaf: the global norm then
sums each split leaf's squares over the ranks of its blocks (the
``reduce_sq`` that ``launch.steps`` gives ``apply_``), so the clip and
the reported norm are the whole tree's; the update of a block stays
local.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    mu: Pytree                 # fp32
    nu: Pytree                 # fp32


def init(params: Pytree) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=tree_map(torch.clone, zeros))


def state_shapes(param_shapes: Pytree) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors (no storage), the
    counterpart of the JAX package's ShapeDtypeStructs."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(meta, param_shapes),
                      nu=tree_map(meta, param_shapes))


def cosine_schedule(lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(step):
        s = step.float()
        warm = lr * (s + 1.0) / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return sched


def global_norm(tree: Pytree,
                reduce_sq: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None) -> torch.Tensor:
    """sqrt of the sum of the leaves' sums of squares, in leaf order (the
    JAX package's order).  ``reduce_sq``: given the (n_leaves,) fp32 sums
    of this rank's leaves, the whole leaves' sums (each split leaf's summed
    over its blocks)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if reduce_sq is not None:
        leaves = list(reduce_sq(torch.stack(leaves)).unbind())
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads: Pytree, max_norm: float,
                        reduce_sq: Optional[Callable[[torch.Tensor],
                                                     torch.Tensor]] = None
                        ) -> Tuple[Pytree, torch.Tensor]:
    gnorm = global_norm(grads, reduce_sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def apply(params: Pytree, grads: Pytree, state: AdamWState, *,
          sched: Callable[[torch.Tensor], torch.Tensor], b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.1, grad_clip=1.0,
          reduce_sq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> Tuple[Pytree, AdamWState, dict]:
    """One AdamW step; ``reduce_sq`` as ``global_norm``'s (over a mesh, so
    the norm is the whole tree's)."""
    grads, gnorm = clip_by_global_norm(grads, grad_clip, reduce_sq)
    step = state.step + 1
    lr = sched(state.step)
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    leaves = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads),
                                   tree_leaves(state.mu),
                                   tree_leaves(state.nu))]
    new_p, new_m, new_v = ([o[i] for o in leaves] for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (tree_unflatten(params, new_p),
            AdamWState(step, tree_unflatten(params, new_m),
                       tree_unflatten(params, new_v)), metrics)


def apply_(params: Pytree, grads: Pytree, state: AdamWState, *,
           sched: Callable[[torch.Tensor], torch.Tensor], b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, grad_clip=1.0,
           reduce_sq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
           ) -> Tuple[Pytree, AdamWState, dict]:
    """``apply`` in place: each parameter leaf, its two moments and the
    step are written in their own storage, with ``apply``'s formulas,
    dtypes and order of operations, so the same bytes.  The clip's scale
    stays a device tensor and is folded into each leaf's fp32 gradient
    (no clipped copy of the tree); each leaf's old value is read for the
    weight decay before it is written; two fp32 temporaries of one leaf
    live at a time.  Returns ``params`` and ``state``, updated, and the
    metrics."""
    gnorm = global_norm(grads, reduce_sq)
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    lr = sched(state.step)
    t = (state.step + 1).float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            a, b = torch.empty_like(m), torch.empty_like(m)
            a.copy_(g).mul_(scale)                      # the clipped g
            m.mul_(b1).add_(torch.mul(a, 1 - b1, out=b))
            v.mul_(b2).add_(torch.square(a, out=b).mul_(1 - b2))
            torch.div(m, bc1, out=a)                    # mh
            torch.div(v, bc2, out=b).sqrt_().add_(eps)
            a.div_(b)
            a.add_(b.copy_(p).mul_(weight_decay))       # delta, old p
            p.copy_(b.copy_(p).sub_(a.mul_(lr)))
            del a, b            # freed before the next leaf's are made
        state.step.add_(1)
    return params, state, {"grad_norm": gnorm, "lr": lr}
