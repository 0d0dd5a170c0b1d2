"""Expert-parallel MoE over a ``DeviceMesh``: the JAX package's
``distributed/moe_ep.py``, its ``shard_map`` bodies run by every rank on
its own blocks.

With tokens sharded over the data axes and *replicated* over the model
axis, each model rank already holds every token of its batch block; it
selects the tokens routed to its local experts, computes them, and
contributes a partial output.  One all-reduce over the model axis combines
per-token expert outputs: a single activation-sized collective a layer.
``moe_ffn_ep_resident`` keeps expert weights 2-D sharded (experts over
model, the hidden F over data) and moves activations instead: an
all-gather of the tokens over data, an all-reduce of the F partials over
data and one of the outputs over model.

JAX's collectives map one for one onto ``distributed.collectives``:
``lax.psum`` is ``psum`` over the axis's group, ``lax.all_gather(...,
tiled=True)`` is ``all_gather_tiled`` (the group's ranks in the axis's
order), ``lax.axis_index`` is ``mesh.get_local_rank``.  Both carry the
gradient as JAX's transposes do, so the gradient flows into x, the gate
and the rank's expert blocks as the gather path's (``layers.moe_ffn``)
does: through the kept assignments' weights ``topv``, zero for a dropped
one.  The training step sums each leaf's gradient over the ranks that
hold the same block (``launch.steps``).

Each function takes the rank's blocks: x (B_local, S, D), the gate
replicated, w1/w3 (E_local, D, F[_local]) and w2 (E_local, F[_local], D)
(the JAX package's in_specs, ``moe_ffn_ep``'s at ``:76`` and the resident
form's at ``:167-168``; a rank stores its experts' D over data too under
``TRAIN_RULES``, and ``transformer.Placement`` reshards a layer's stored
blocks to these), and returns this rank's (B_local, S, D) and the aux
loss of its own tokens.  That aux is JAX's where JAX's is defined: on
every rank of a mesh whose batch is not split over data, and always for
the resident form, which routes the gathered batch; with the batch split
over data, ``moe_ffn_ep``'s shards differ and JAX returns one of them,
the port each rank's own.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.models.layers import act_fn


def moe_layout(cfg, mesh, batch_axes) -> Optional[str]:
    """The expert-parallel form the MoE FFN takes on ``mesh`` (the JAX
    package's conditions, ``models/transformer.py:366-376``): None for the
    gather path (no mesh, a model axis of 1, ``moe_impl == "gather"`` or
    experts that do not split over it), ``"ep_resident"`` where asked and
    the batch splits over a data axis larger than 1 that divides the
    expert width, else ``"ep"``."""
    if mesh is None or not cfg.num_experts:
        return None
    shape = mesh_shape(mesh)
    model = shape.get("model", 1)
    if model <= 1 or cfg.moe_impl == "gather" or cfg.num_experts % model:
        return None
    fe = cfg.moe_d_ff or cfg.d_ff
    data = shape.get("data", 1)
    if (cfg.moe_impl == "ep_resident" and data > 1 and "data" in batch_axes
            and fe % data == 0):
        return "ep_resident"
    return "ep"


def _route(xf: torch.Tensor, gate_w: torch.Tensor, k: int):
    """Softmax probabilities (T, E) fp32, the renormalised top-k weights
    and the flat expert ids (T*k,)."""
    probs = torch.softmax((xf @ gate_w.to(xf.dtype)).float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, topv, topi.reshape(-1)


def _aux(probs: torch.Tensor, flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss."""
    ce = torch.bincount(flat_e, minlength=E).float() / flat_e.numel()
    return E * (probs.mean(dim=0) * ce).sum()


def _local_experts(x_all: torch.Tensor, keep: torch.Tensor,
                   slot: torch.Tensor, k: int, C: int, w1: torch.Tensor,
                   w3: torch.Tensor, w2: torch.Tensor, act: str
                   ) -> torch.Tensor:
    """The local experts over their C slots each: the kept assignments'
    token rows of ``x_all`` scattered into their slots (JAX scatters the
    others into an overflow row that is never read), the gated FFN, and
    the outputs as an (E_local * C + 1, D) table whose last row is zero,
    for the combine's gather.  No operation is in place, so autograd
    takes the same code."""
    E_loc, D = w1.shape[0], x_all.shape[1]
    n_slots = E_loc * C
    buf = x_all.new_zeros((n_slots, D))
    idx = keep.nonzero()[:, 0]
    buf[slot[idx]] = x_all[idx // k]
    xe = buf.view(E_loc, C, D)
    del buf
    h = act_fn(act)(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    del xe
    y = torch.bmm(h, w2).view(n_slots, D)
    return torch.cat([y, y.new_zeros((1, D))])


def _combine(yflat: torch.Tensor, slot: torch.Tensor, wts: torch.Tensor,
             T: int, k: int) -> torch.Tensor:
    """Each token's k expert outputs, weighted, summed in k's order."""
    yk = yflat[slot] * wts.to(yflat.dtype)[:, None]
    return yk.view(T, k, yflat.shape[1]).sum(dim=1)


def _check_blocks(x, w1, w2, E_loc: int, F_loc: int, layout: str) -> None:
    """The blocks must be the ones ``layout`` computes with: E_loc experts
    of d_model and width F_loc.  Blocks of the other form (the whole width
    where ``ep_resident`` wants a slice of it, or the other way round) or
    stored blocks not resharded (D split over data) would give a wrong
    sum, not an error, in the collectives."""
    D = x.shape[-1]
    if w1.shape[0] != E_loc or w1.shape[1] != D or w2.shape[0] != E_loc:
        raise ValueError(f"expert blocks w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}: want {E_loc} local experts of "
                         f"d_model {D}")
    if w1.shape[2] != F_loc or w2.shape[1] != F_loc:
        raise ValueError(f"expert blocks w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}: {layout} wants an expert width "
                         f"of {F_loc} on each rank (were they resharded "
                         f"for another layout? transformer.placement takes "
                         f"the layout from the step's batch_axes)")


def moe_ffn_ep(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, *, num_experts: int,
               d_ff: int, k: int, capacity_factor: float, act: str, mesh,
               batch_axes: Tuple[str, ...], ep_axis: str = "model"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B_local, S, D) -> (B_local, S, D), aux.  Experts split over
    ``ep_axis``: this rank holds experts [r E_local, (r + 1) E_local) of
    its index r along it, each of the whole width ``d_ff``.  The capacity
    C = max(8, ceil(T k cf / E)) counts this rank's T = B_local S tokens,
    as JAX's shard does.
    ``batch_axes``: the axes the batch was split over (JAX's in_specs;
    the rank's block is what it is given)."""
    E = num_experts
    ep = mesh_shape(mesh)[ep_axis]
    assert E % ep == 0, (E, ep)
    E_loc = E // ep
    _check_blocks(x, w1, w2, E_loc, d_ff, "ep")
    Bl, S, D = x.shape
    T = Bl * S
    xf = x.reshape(T, D)
    probs, topv, flat_e = _route(xf, gate_w, k)
    C = max(8, int(math.ceil(T * k * capacity_factor / E)))
    oh = F.one_hot(flat_e, E)
    pos_in_e = ((oh.cumsum(0) - 1) * oh).sum(-1)
    del oh
    sid = mesh.get_local_rank(ep_axis)
    keep = (flat_e // E_loc == sid) & (pos_in_e < C)
    slot = torch.where(keep, (flat_e % E_loc) * C + pos_in_e, E_loc * C)
    yflat = _local_experts(xf, keep, slot, k, C, w1, w3, w2, act)
    wts = torch.where(keep, topv.reshape(-1), 0.0)
    out = _combine(yflat, slot, wts, T, k)
    del yflat
    out = coll.psum(out, mesh, ep_axis)                    # combine shards
    return out.reshape(Bl, S, D), _aux(probs, flat_e, E)


def _rank_in_expert(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Position of each routing decision within its expert's queue —
    sort-based (O(Tk log Tk) and O(Tk) memory) instead of the (Tk, E)
    one-hot cumsum."""
    n = flat_e.shape[0]
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=flat_e.device))
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    out = torch.empty_like(pos_sorted)
    out[perm] = pos_sorted
    return out


def moe_ffn_ep_resident(x: torch.Tensor, gate_w: torch.Tensor,
                        w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                        *, num_experts: int, d_ff: int, k: int,
                        capacity_factor: float, act: str, mesh,
                        batch_axes: Tuple[str, ...], ep_axis: str = "model",
                        fsdp_axis: str = "data"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-resident expert parallelism.  Expert weights are 2-D split
    (experts over ``ep_axis``, their width ``d_ff`` over ``fsdp_axis``)
    and never move: the tokens are gathered over the data axis once a
    layer, each rank computes its experts' F-slice for the whole gathered
    batch, the partials are summed over data, each rank combines its own
    token block and the outputs are summed over the experts' axis.  Routing
    and the
    capacity C = max(8, ceil(T_all k cf / E)) count the gathered T_all
    tokens, so they are the one-card path's over the same batch."""
    E = num_experts
    shape = mesh_shape(mesh)
    ep, dp = shape[ep_axis], shape[fsdp_axis]
    assert E % ep == 0, (E, ep)
    E_loc = E // ep
    if d_ff % dp:
        raise ValueError(f"an expert width of {d_ff} does not split over "
                         f"{fsdp_axis} of {dp}")
    _check_blocks(x, w1, w2, E_loc, d_ff // dp, "ep_resident")
    Bl, S, D = x.shape
    T = Bl * S
    x_all = coll.all_gather_tiled(x.reshape(T, D), mesh,
                                  fsdp_axis)             # (T_all, D)
    T_all = T * dp
    probs, topv, flat_e = _route(x_all, gate_w, k)
    C = max(8, int(math.ceil(T_all * k * capacity_factor / E)))
    pos_in_e = _rank_in_expert(flat_e, E)
    sid = mesh.get_local_rank(ep_axis)
    keep = (flat_e // E_loc == sid) & (pos_in_e < C)
    slot = torch.where(keep, (flat_e % E_loc) * C + pos_in_e, E_loc * C)
    yflat = _local_experts(x_all, keep, slot, k, C, w1, w3, w2, act)
    del x_all
    yflat = coll.psum(yflat, mesh, fsdp_axis)              # F-combine
    wts = torch.where(keep, topv.reshape(-1), 0.0)
    # combine only the local token block, then sum over the experts' axis
    mine = slice(mesh.get_local_rank(fsdp_axis) * T,
                 (mesh.get_local_rank(fsdp_axis) + 1) * T)
    out = _combine(yflat, slot.view(T_all, k)[mine].reshape(-1),
                   wts.view(T_all, k)[mine].reshape(-1), T, k)
    del yflat
    out = coll.psum(out, mesh, ep_axis)                    # expert-combine
    return out.reshape(Bl, S, D), _aux(probs, flat_e, E)
