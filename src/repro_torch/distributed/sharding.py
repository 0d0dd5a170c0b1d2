"""Logical-axis -> mesh-axis sharding rules.

The port of the JAX package's ``distributed/sharding.py``.  Params carry
*logical* axis names (``models.transformer.PDef``); this module resolves
them against a mesh with divisibility filtering, so the same rules work
across all ten architectures (40 heads don't divide a 16-way model axis ->
that dim falls back to replicated, while the flat H*Dh projection dim
still shards).

Rule sets:
  TRAIN_RULES  : FSDP ("fsdp"->data) + TP ("tp"->model) + EP ("expert"->model)
  TP_RULES     : pure tensor parallel (no FSDP)
  SEQPAR_RULES : TRAIN_RULES + the residual stream sharded over model along
                 the sequence between blocks
  DECODE_RULES : weights 2-D resident, the residual stream sharded over data
                 along the hidden dim, the token batch over pod alone

A mesh is a ``torch.distributed.DeviceMesh`` over an initialised process
group, or anything whose ``.shape`` is a ``{name: size}`` dict (the tests'
fake meshes); ``mesh_shape`` reads either.  ``P`` stands in for JAX's
``PartitionSpec``: a tuple of mesh-axis names, ``None`` or tuples of names,
trimmed of trailing ``None``s, equal to ``tuple(jax P)`` of the same spec.

The port runs a mesh as explicit SPMD: every rank holds its own block of
each tensor and runs the model on it.  A parameter has two blocks
(``leaf_specs``): the one a rank stores, its spec under the rules (JAX's
``param_spec_tree``: FSDP over data, TP and the vocabulary over model,
experts over model), and the one a layer computes with
(``compute_spec``): a TP or vocabulary leaf its stored block without the
data split (the column-parallel in and row-parallel out products XLA's
partitioner makes of JAX's layout), a leaf the model keeps whole (its
logical axes given without ``tp``: ``transformer.compute_defs``) whole,
expert leaves in the in_specs of the MoE layout.  Under ``DECODE_RULES``
(``resident``) a dense leaf computes with the block it stores: the
model's products take the data split of their in-dim as a sum of
activation partials instead.  The model reshards one into the other a
layer at a time (``models.transformer.Placement``).  Where JAX's
activation constraint steers GSPMD's layout, the local batch block
already is the layout, so nothing is left of the callback but what the
model reads: ``make_act_sharder`` gives an ``ActSharder``, the mesh, the
axes the batch was split over and the rules, and from them the axes the
residual stream's hidden dim splits over (``act_hidden``) and its
sequence between blocks (``act_seq``, ``SEQPAR_RULES``: a block gathers
the sequence in and reduce-scatters it out, ``models.transformer``).
``cache_specs`` gives the decode cache's
blocks (the batch over ``pod``/``data``, the sequence over ``model``, the
SSD state's heads over ``model``).  ``local_block`` cuts a rank's block of
a tensor out of the whole by its spec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

Pytree = Any

TRAIN_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "fsdp": ("data",),
    "tp": ("model",),
    "expert": ("model",),
    "layer": (),
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "cache_seq": ("model",),
    "heads": ("model",),
    "act_seq": (),            # sequence-parallel residual stream (off)
}

TP_RULES: Dict[str, Tuple[str, ...]] = dict(TRAIN_RULES, fsdp=())

SEQPAR_RULES: Dict[str, Tuple[str, ...]] = dict(TRAIN_RULES,
                                                act_seq=("model",))

DECODE_RULES: Dict[str, Tuple[str, ...]] = dict(
    TRAIN_RULES, batch=("pod",), cache_batch=("pod", "data"),
    act_hidden=("data",),
)


class P(tuple):
    """A partition spec: one entry a dim, a mesh-axis name, a tuple of
    names (the dim split over their product, the first the major) or
    ``None`` (replicated); trailing ``None``s are dropped."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        # a tuple subclass otherwise pickles as P(<its tuple>): one entry
        return (P, tuple(self))


def is_spec(x) -> bool:
    return isinstance(x, P)


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of names and ``None``s."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a fake mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def _fit_axes(dim: int, names: Sequence[str], mesh) -> Tuple[str, ...]:
    """Longest prefix of mesh axes whose size product divides ``dim``."""
    shape = mesh_shape(mesh)
    out = []
    prod = 1
    for n in names:
        if n not in shape:
            continue
        sz = shape[n]
        if dim % (prod * sz) != 0:
            break
        out.append(n)
        prod *= sz
    return tuple(out)


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             rules: Dict[str, Tuple[str, ...]], mesh) -> P:
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in rules:
            parts.append(None)
            continue
        cand = tuple(a for a in rules[ax] if a not in used)
        fit = _fit_axes(dim, cand, mesh)
        used.update(fit)
        if len(fit) == 0:
            parts.append(None)
        elif len(fit) == 1:
            parts.append(fit[0])
        else:
            parts.append(fit)
    return P(*parts)


def resolve_rules(rules=None) -> Dict[str, Tuple[str, ...]]:
    """``rules``, ``TRAIN_RULES`` where None."""
    return TRAIN_RULES if rules is None else rules


def resident(rules) -> bool:
    """``rules`` keep every dense weight where it is stored and split the
    residual stream instead (``act_hidden``: ``DECODE_RULES``)."""
    return bool(rules.get("act_hidden"))


def compute_spec(axes: Tuple[Optional[str], ...], layout: Optional[str],
                 shape: Tuple[int, ...] = (), rules=None, mesh=None) -> P:
    """The block of a leaf of logical ``axes`` that a layer computes with
    under the MoE ``layout`` (``moe_ep.moe_layout``): an expert leaf split
    on its expert dim over ``model`` (``moe_ffn_ep``'s in_specs), for
    ``ep_resident`` also on the expert width over ``data``, whole on the
    gather path (``layout`` None); any other leaf of ``shape`` its spec
    under ``rules`` without the FSDP split (``tp`` and ``vocab`` over
    model), whole where no ``rules`` are given."""
    if "expert" in axes:
        if layout is None:
            return P()
        e = axes.index("expert")
        parts = [None] * len(axes)
        parts[e] = "model"
        if layout == "ep_resident":
            parts[axes.index(None, e + 1)] = "data"  # F: w1/w3 last, w2 -2
        return P(*parts)
    if rules is None:
        return P()
    return spec_for(shape, axes, dict(rules, fsdp=()), mesh)


@dataclass(frozen=True)
class LeafSpecs:
    """A parameter's block as a rank stores it and as a layer computes
    with it."""
    storage: P
    compute: P


def leaf_specs(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
               rules, mesh, layout: Optional[str],
               compute_axes: Optional[Tuple[Optional[str], ...]] = None
               ) -> LeafSpecs:
    """The storage spec (``spec_for`` under ``rules``) and the compute
    spec (``compute_spec`` of ``layout`` and ``rules``, of
    ``compute_axes``: ``axes`` without the splits a layer does not take;
    ``axes`` where None) of one leaf.  Under ``resident`` rules a dense
    leaf computes with its stored block; an expert leaf takes the MoE
    layout's in_specs all the same (``ep``'s gather its ``fsdp`` dim over
    data, as JAX's ``shard_map`` in_specs do)."""
    storage = spec_for(shape, axes, rules, mesh)
    if "expert" not in axes and resident(rules):
        return LeafSpecs(storage, storage)
    return LeafSpecs(storage,
                     compute_spec(axes if compute_axes is None
                                  else compute_axes, layout, shape, rules,
                                  mesh))


def param_spec_tree(shape_tree: Pytree, axes_tree: Pytree,
                    rules: Dict[str, Tuple[str, ...]], mesh) -> Pytree:
    """``shape_tree``'s structure with a ``P`` for each leaf (a tensor, a
    meta tensor, anything with ``.shape``), resolved from the logical axes
    at the same place in ``axes_tree``."""
    flat_s = tree_leaves(shape_tree)
    flat_a = tree_leaves(axes_tree, is_leaf=is_axes)
    assert len(flat_s) == len(flat_a), (len(flat_s), len(flat_a))
    specs = [spec_for(tuple(s.shape), a, rules, mesh)
             for s, a in zip(flat_s, flat_a)]
    return tree_unflatten(shape_tree, specs)


def block_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``
    on ``mesh`` (a ``DeviceMesh`` or a fake one)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, part in enumerate(spec):
        if part is not None:
            out[dim] //= math.prod(sizes[a] for a in (
                (part,) if isinstance(part, str) else part))
    return tuple(out)


def cache_specs(cfg, mesh, batch: int, seq: int, rules=None) -> Pytree:
    """The spec of every leaf of the decode cache of ``batch`` sequences of
    ``seq`` positions on ``mesh`` under ``rules`` (None: ``TRAIN_RULES``):
    the cache part of the JAX package's ``shardings_for``, ``spec_for`` of
    ``decode.cache_logical_axes`` with every rule (``cache_batch``,
    ``cache_seq`` and ``heads``, the sequence over ``model`` where it
    divides)."""
    from repro_torch.models import decode as DE
    return param_spec_tree(DE.cache_shapes(cfg, batch, seq,
                                           make=DE.LeafShape),
                           DE.cache_logical_axes(cfg, batch, seq),
                           rules or TRAIN_RULES, mesh)


def batch_axes(batch: int, rules, mesh) -> Tuple[str, ...]:
    """The mesh axes a leading batch dim of ``batch`` splits over."""
    shape = mesh_shape(mesh)
    return _fit_axes(batch, [a for a in rules.get("batch", ()) if a in shape],
                     mesh)


def batch_spec(shape: Tuple[int, ...], rules, mesh) -> P:
    """(B, ...) arrays: shard the leading batch dim."""
    fit = batch_axes(shape[0], rules, mesh)
    if not fit:
        return P()
    return P(fit if len(fit) > 1 else fit[0])


@dataclass(frozen=True)
class ActSharder:
    """The port's activation sharding: under explicit SPMD a rank's
    activations are its batch block already, so what is left of the JAX
    package's callback is what the model reads: the ``mesh``, the
    ``batch_axes`` the caller split the whole batch over (``batch_axes``
    of it; () when every rank holds it whole) and the ``rules`` the
    parameters were placed by (JAX's ``shard.rules``).  JAX reads the
    batch's axes from the global array's shape, which a rank's block
    cannot tell: a block of 1 on a data axis of 2 may be a batch of 1 or
    the half of 2."""
    mesh: Any
    batch_axes: Tuple[str, ...] = ()
    rules: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: TRAIN_RULES)

    def hidden_axes(self, width: int) -> Tuple[str, ...]:
        """The mesh axes the residual stream's hidden dim of ``width``
        splits over: JAX's ``"act"`` constraint, ``act_hidden`` less the
        batch's axes, the longest prefix that divides ``width`` (() where
        none does: the stream stays whole, as the constraint leaves
        it)."""
        return _fit_axes(width, [a for a in self.rules.get("act_hidden", ())
                                 if a not in self.batch_axes], self.mesh)

    def seq_axes(self, seq_len: int) -> Tuple[str, ...]:
        """The mesh axes the residual stream's sequence of ``seq_len``
        tokens splits over between blocks: JAX's ``"act"`` constraint on
        a 3-D stream, ``act_seq`` less the batch's axes, the longest
        prefix that divides ``seq_len`` (() where none does: a prompt the
        axes do not divide, a decode token, keeps the stream whole)."""
        return _fit_axes(seq_len, [a for a in self.rules.get("act_seq", ())
                                   if a not in self.batch_axes], self.mesh)


def make_act_sharder(mesh, batch_axes: Sequence[str] = (),
                     rules=None) -> ActSharder:
    return ActSharder(mesh, tuple(batch_axes), resolve_rules(rules))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def is_first_rank(mesh) -> bool:
    """This rank is at index 0 along every axis of the ``DeviceMesh``."""
    return all(i == 0 for i in mesh_coords(mesh).values())


def block_index(part, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index of the block, number of blocks) of a spec entry ``part``: a
    name, or a tuple of names whose first is the major."""
    shape = mesh_shape(mesh)
    idx, n = 0, 1
    for a in ((part,) if isinstance(part, str) else part):
        idx = idx * shape[a] + coords[a]
        n *= shape[a]
    return idx, n


def local_block(t: torch.Tensor, spec: P, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view);
    ``coords`` the rank's index along each axis (default: the
    ``DeviceMesh``'s own)."""
    coords = mesh_coords(mesh) if coords is None else coords
    for dim, part in enumerate(spec):
        if part is None:
            continue
        i, n = block_index(part, mesh, coords)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks ({spec})")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t
