"""The port's sharding rules, logical axes and shape trees against the JAX
package's, on the CPU.

For every architecture of ``ARCHS`` (full widths), all four rule sets and
the fake meshes below, ``spec_for`` through ``param_spec_tree`` must give
the JAX package's partition specs leaf for leaf (compared as tuples), and
so must ``batch_spec`` and the cache's spec tree (``cache_specs``, which
the steps take, against JAX's ``shardings_for`` on the production
meshes); ``param_logical_axes``,
``cache_logical_axes``, ``adamw.state_shapes`` and ``specs.input_specs``
must give its axes, shapes and dtypes.  ``shardings_for`` is held to JAX's
on its one-device local mesh, and ``transformer.param_block_specs`` (the
blocks a rank stores) to JAX's ``param_spec_tree`` under ``TRAIN_RULES``
and ``TP_RULES`` on the (2, 4), (4, 2) and (1, 8) meshes of the host-mesh
tests.  Nothing here needs a process group: a fake mesh is a ``{name:
size}`` dict, as ``tests/test_distributed.py`` fakes one.  Mesh entry
points without a group raise, and so do the gradient and train step
makers given ``DECODE_RULES``, which serves; ``ActSharder.seq_axes``
splits the residual stream's sequence where JAX's ``"act"`` constraint
does under ``SEQPAR_RULES``;
under it ``transformer.placement`` moves no dense leaf (the weights stay
resident), only the expert leaves the MoE layout gathers.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES, get_arch as jget_arch
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh as jlocal_mesh
from repro.models import decode as JDE
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


class _FakeMesh:
    """Just enough of a mesh for the spec functions (both packages)."""

    def __init__(self, shape):
        self.shape = shape
        self.size = int(np.prod(list(shape.values())))


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x4": {"data": 1, "model": 4},
    "2x2": {"data": 2, "model": 2},
    "1x1": {"data": 1, "model": 1},
}
RULES = {"train": "TRAIN_RULES", "tp": "TP_RULES", "seqpar": "SEQPAR_RULES",
         "decode": "DECODE_RULES"}
DECODE_SHAPES = [s for s in SHAPES if s.kind == "decode"]


def _walk(tree, path):
    for k in path:
        if hasattr(k, "key"):
            tree = tree[k.key]
        elif hasattr(k, "idx"):
            tree = tree[k.idx]
        else:
            tree = getattr(tree, k.name)
    return tree


def _specs_equal(jspecs, specs):
    """Every JAX spec leaf equals the port's at the same path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))
    assert flat
    for path, jsp in flat:
        got = _walk(specs, path)
        assert isinstance(got, SH.P), (path, got)
        assert tuple(got) == tuple(jsp), (path, got, jsp)
    assert len(T.tree_leaves(specs, is_leaf=SH.is_spec)) == len(flat)


def _shapes_equal(jshapes, shapes):
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        t = _walk(shapes, path)
        assert tuple(t.shape) == tuple(s.shape) and t.device.type == "meta"
        assert str(t.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)


def test_rule_sets_are_jax_s():
    for name in RULES.values():
        assert getattr(SH, name) == getattr(JSH, name)


# ---- tests/test_distributed.py:28 and :39, on the port -----------------------

def test_spec_divisibility_filtering():
    mesh = _FakeMesh({"data": 16, "model": 16})
    # 40 heads * 96 = 3840 divides 16 -> shard; 40 alone does not
    sp = SH.spec_for((2560, 3840), ("fsdp", "tp"), SH.TRAIN_RULES, mesh)
    assert sp == SH.P("data", "model") == ("data", "model")
    sp = SH.spec_for((40, 96), ("tp", None), SH.TRAIN_RULES, mesh)
    assert sp == SH.P() == ()                # 40 % 16 != 0 -> replicated
    sp = SH.spec_for((256, 4096), ("batch", None), SH.TRAIN_RULES, mesh)
    assert sp == SH.P("data")
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    sp = SH.spec_for((256, 4096), ("batch", None), SH.TRAIN_RULES, mesh)
    assert sp == SH.P(("pod", "data"))


def test_spec_no_axis_reuse():
    mesh = _FakeMesh({"data": 4, "model": 4})
    sp = SH.spec_for((64, 64, 64), ("tp", "tp", "fsdp"), SH.TRAIN_RULES, mesh)
    flat = [a for part in sp if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(set(flat))   # each mesh axis used at most once
    assert sp == JSH.spec_for((64, 64, 64), ("tp", "tp", "fsdp"),
                              JSH.TRAIN_RULES, mesh)


def test_partition_spec_trims_trailing_nones():
    assert SH.P("model", None, None) == ("model",) == tuple(JP("model"))
    assert SH.P(None, "model", None, "data") == (None, "model", None, "data")
    assert SH.P(None, None) == ()


# ---- every arch, rule set and mesh -------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    axes = T.param_logical_axes(cfg)
    jaxes = JT.param_logical_axes(jcfg)
    _shapes_equal(jshapes, shapes)
    flat, _ = jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=SH.is_axes)
    for path, ax in flat:
        assert _walk(axes, path) == ax, path
    for mname, mshape in MESHES.items():
        mesh = _FakeMesh(mshape)
        for rname in RULES.values():
            rules, jrules = getattr(SH, rname), getattr(JSH, rname)
            _specs_equal(JSH.param_spec_tree(jshapes, jaxes, jrules, mesh),
                         SH.param_spec_tree(shapes, axes, rules, mesh))
            for B in (1, 4, 6, 256):
                assert (SH.batch_spec((B, 4096), rules, mesh)
                        == tuple(JSH.batch_spec((B, 4096), jrules, mesh))), \
                    (mname, rname, B)


STORAGE_MESHES = {"2x4": {"data": 2, "model": 4},
                  "4x2": {"data": 4, "model": 2},
                  "1x8": {"data": 1, "model": 8}}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_block_specs_are_jax_s_param_spec_tree(arch):
    """The block of every leaf a rank stores, dense leaves included, is
    JAX's spec of it: FSDP over data and TP over model under
    ``TRAIN_RULES``, TP alone under ``TP_RULES``."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    jshapes, jaxes = JT.param_shapes(jcfg), JT.param_logical_axes(jcfg)
    split = 0
    for mshape in STORAGE_MESHES.values():
        mesh = _FakeMesh(mshape)
        for rname in ("TRAIN_RULES", "TP_RULES"):
            got = T.param_block_specs(cfg, mesh, getattr(SH, rname))
            _specs_equal(JSH.param_spec_tree(jshapes, jaxes,
                                             getattr(JSH, rname), mesh), got)
            split += sum(bool(sp) for sp in
                         T.tree_leaves(got, is_leaf=SH.is_spec))
    assert split                           # some leaf is split somewhere
    assert T.param_block_specs(cfg, mesh) == T.param_block_specs(
        cfg, mesh, SH.TRAIN_RULES)


@pytest.mark.parametrize("maker", ["make_grad_fn", "make_train_step"])
def test_decode_rules_training_makers_build(maker):
    """Both training makers take ``DECODE_RULES`` (no batch axis: every
    rank the whole batch) and build a step; the gradient's reduction is
    the one every rule set takes: each leaf summed over the axes its
    stored block is not split over (a norm's whole scale over all of
    them, a 2-D resident block over none) and the norm counting each
    block once."""
    from repro_torch.configs import TrainConfig
    cfg = get_arch("qwen3-8b").reduced()
    mesh = _FakeMesh({"data": 2, "model": 2})
    rules = SH.DECODE_RULES
    assert SH.batch_axes(4, rules, mesh) == ()
    step = getattr(ST, maker)(cfg, TrainConfig(), mesh=mesh, batch_axes=(),
                              rules=rules)
    assert callable(step)
    axes = ST.leaf_axes(cfg, mesh, rules)
    specs = T.tree_leaves(T.param_block_specs(cfg, mesh, rules),
                          is_leaf=SH.is_spec)
    assert len(axes) == len(specs)
    for (split, over), spec in zip(axes, specs):
        assert set(split) | set(over) == {"data", "model"}
        assert not set(split) & set(over)
    assert ((), ("data", "model")) in axes
    assert (("data", "model"), ()) in axes
    assert ST.norm_reduction(cfg, mesh, rules) is not None


class _Act:
    """An activation's shape, all JAX's ``make_act_sharder`` reads."""

    def __init__(self, shape):
        self.shape, self.ndim = shape, len(shape)


@pytest.mark.parametrize("mname", ["2x4", "1x8", "16x16", "2x16x16", "1x1"])
def test_seq_axes_are_jax_s_act_constraint(mname, monkeypatch):
    """``ActSharder.seq_axes`` of a (B, S, D) residual stream under
    ``SEQPAR_RULES`` is the sequence entry of the spec JAX's
    ``make_act_sharder`` constrains ``"act"`` to (its ``NamedSharding``
    and ``with_sharding_constraint`` patched to hand the spec back), the
    batch's axes taken first: a sequence that does not divide, a decode
    token and a batch that does not divide among the shapes.  The other
    rule sets split no sequence; ``transformer.seq_split`` drops the axes
    of one rank."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    shape = {"16x16": {"data": 16, "model": 16}, "1x8": {"data": 1,
                                                         "model": 8}}.get(
        mname, MESHES.get(mname))
    mesh = _FakeMesh(shape)
    split = 0
    for B, S in ((256, 4096), (8, 32), (8, 30), (4, 1), (3, 64), (2, 48)):
        for rname in ("SEQPAR_RULES", "TRAIN_RULES", "TP_RULES"):
            rules = getattr(SH, rname)
            jspec = JSH.make_act_sharder(mesh, getattr(JSH, rname))(
                _Act((B, S, 64)), "act")
            if mesh.size == 1:               # JAX's sharder returns x itself
                jspec = JP()
            want = tuple(jspec)[1] if len(jspec) > 1 else None
            want = () if want is None else (
                (want,) if isinstance(want, str) else tuple(want))
            shard = SH.ActSharder(mesh, SH.batch_axes(B, rules, mesh), rules)
            got = shard.seq_axes(S) if mesh.size > 1 else ()
            assert got == want, (B, S, rname, got, want)
            assert T.seq_split(shard, S) == tuple(
                a for a in got if mesh.shape[a] > 1)
            split += bool(T.seq_split(shard, S))
    assert split or mname == "1x1"


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2},
                                   {"data": 16, "model": 16}])
@pytest.mark.parametrize("arch", ["qwen3-8b", "minicpm3-4b", "mamba2-370m",
                                  "qwen3-moe-235b-a22b"])
def test_decode_rules_move_no_dense_leaf(arch, shape):
    """Under ``DECODE_RULES`` every dense leaf computes with the block it
    stores (``placement`` None for a dense model), where ``TRAIN_RULES``
    gathers its FSDP split; expert leaves alone are resharded, to
    ``moe_ep``'s in_specs (``ep``: the batch is whole on a pod); the
    residual stream splits over ``data`` along ``d_model``."""
    from repro_torch.distributed import collectives as C
    cfg = get_arch(arch)
    mesh = _FakeMesh(shape)
    shard = SH.ActSharder(mesh, SH.batch_axes(4, SH.DECODE_RULES, mesh),
                          SH.DECODE_RULES)
    assert shard.batch_axes == () and shard.hidden_axes(cfg.d_model) == (
        "data",)
    train = T.placement(cfg, SH.ActSharder(mesh, ("data",), SH.TRAIN_RULES))
    place = T.placement(cfg, shard)
    defs = T.tree_leaves(T.param_defs(cfg))
    if not cfg.num_experts:
        assert place is None
    else:
        specs = T.tree_leaves(place.specs)
        moved = [pd.axes for pd, ls in zip(defs, specs) if C.moves(
            len(pd.shape), ls.storage, ls.compute, mesh)]
        assert moved and all("expert" in ax for ax in moved)
        assert all(ls.compute[:2] == (None, "model") for pd, ls in
                   zip(defs, specs) if "expert" in pd.axes)
    # what TRAIN_RULES moves that DECODE_RULES keeps: the FSDP split
    assert any(C.moves(len(pd.shape), ls.storage, ls.compute, mesh)
               for pd, ls in zip(defs, T.tree_leaves(train.specs))
               if "expert" not in pd.axes)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_axes_and_specs_match_jax(arch, monkeypatch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    # JAX's shardings_for on a fake mesh: its specs, not NamedShardings
    monkeypatch.setattr(JST, "NamedSharding", lambda mesh, spec: spec)
    for shape in DECODE_SHAPES + [SHAPES[0]]:
        B, S = shape.global_batch, shape.seq_len
        cshapes, jcshapes = (DE.cache_shapes(cfg, B, S),
                             JDE.cache_shapes(jcfg, B, S))
        _shapes_equal(jcshapes, cshapes)
        caxes, jcaxes = (DE.cache_logical_axes(cfg, B, S),
                         JDE.cache_logical_axes(jcfg, B, S))
        flat, _ = jax.tree_util.tree_flatten_with_path(jcaxes,
                                                       is_leaf=SH.is_axes)
        for path, ax in flat:
            assert _walk(caxes, path) == ax, path
        for mshape in MESHES.values():
            mesh = _FakeMesh(mshape)
            for rname in RULES.values():
                _specs_equal(
                    JSH.param_spec_tree(jcshapes, jcaxes,
                                        getattr(JSH, rname), mesh),
                    SH.param_spec_tree(cshapes, caxes, getattr(SH, rname),
                                       mesh))
        if shape.kind != "decode":
            continue
        # the cache specs the port's steps take, against JAX's
        # shardings_for on the production meshes
        for mname in ("16x16", "2x16x16"):
            mesh = _FakeMesh(MESHES[mname])
            for rname in RULES.values():
                want = JST.shardings_for(jcfg, mesh, shape,
                                         getattr(JSH, rname))["cache"]
                _specs_equal(want, SH.cache_specs(cfg, mesh, B, S,
                                                  getattr(SH, rname)))
                _specs_equal(want, ST.shardings_for(
                    cfg, mesh, shape, getattr(SH, rname))["cache"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_and_input_shapes_match_jax(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    st = adamw.state_shapes(T.param_shapes(cfg))
    jst = JA.state_shapes(JT.param_shapes(jcfg))
    _shapes_equal(jst, st)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    for shape in SHAPES:
        got, want = SP.input_specs(cfg, shape), JSP.input_specs(jcfg, shape)
        assert list(got) == list(want)
        _shapes_equal(want, got)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shardings_for_match_jax_on_a_one_device_mesh(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    jmesh = jlocal_mesh()
    mesh = _FakeMesh(dict(jmesh.shape))
    ns = lambda t: jax.tree.map(lambda s: s.spec, t)
    for shape in SHAPES:
        want = JST.shardings_for(jcfg, jmesh, shape, with_opt=True)
        got = ST.shardings_for(cfg, mesh, shape, with_opt=True)
        assert sorted(got) == sorted(want)
        _specs_equal(ns(want["params"]), got["params"])
        _specs_equal(ns(want["batch"]), got["batch"])
        _specs_equal(ns(want["opt"]), got["opt"])
        _shapes_equal(want["param_shapes"], got["param_shapes"])
        _shapes_equal(want["batch_shapes"], got["batch_shapes"])
        _shapes_equal(want["opt_shapes"], got["opt_shapes"])
        if shape.kind == "decode":
            _specs_equal(ns(want["cache"]), got["cache"])
            _shapes_equal(want["cache_shapes"], got["cache_shapes"])


def test_make_batch_matches_input_specs_and_its_generator():
    cfg = get_arch("whisper-medium").reduced()
    shape = SHAPES[0].__class__("t", "train", 16, 2)
    b1 = SP.make_batch(cfg, shape, torch.Generator().manual_seed(3), "cpu")
    b2 = SP.make_batch(cfg, shape, torch.Generator().manual_seed(3), "cpu")
    specs = SP.input_specs(cfg, shape)
    assert list(b1) == list(specs) == ["tokens", "labels", "encoder_frames"]
    for k, s in specs.items():
        assert b1[k].shape == s.shape and b1[k].dtype == s.dtype
        assert torch.equal(b1[k], b2[k])
    assert 0 <= int(b1["tokens"].min()) and int(b1["tokens"].max()) < 512


# ---- blocks of a tensor -------------------------------------------------------

def test_local_block_takes_the_rank_s_block():
    mesh = _FakeMesh({"pod": 2, "data": 2, "model": 2})
    t = torch.arange(8 * 6).reshape(8, 6)
    blocks = {}
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                c = {"pod": pod, "data": data, "model": model}
                blocks[(pod, data, model)] = SH.local_block(
                    t, SH.P(("pod", "data"), "model"), mesh, c)
    # ("pod", "data") splits rows 4 ways with pod the major; model cols 2
    assert torch.equal(blocks[(0, 0, 0)], t[0:2, 0:3])
    assert torch.equal(blocks[(0, 1, 1)], t[2:4, 3:6])
    assert torch.equal(blocks[(1, 0, 0)], t[4:6, 0:3])
    assert torch.equal(blocks[(1, 1, 1)], t[6:8, 3:6])
    with pytest.raises(ValueError):
        SH.local_block(torch.zeros(3, 2), SH.P("data"), mesh,
                       {"pod": 0, "data": 0, "model": 0})


@pytest.mark.parametrize("impl,shape,layout", [
    ("ep", {"data": 2, "model": 4}, "ep"),
    ("ep_resident", {"data": 2, "model": 4}, "ep_resident"),
    ("ep_resident", {"data": 1, "model": 4}, "ep"),
    ("gather", {"data": 2, "model": 4}, None),
    ("ep", {"data": 4, "model": 1}, None),
])
def test_moe_layout_and_expert_specs(impl, shape, layout):
    import dataclasses

    from repro_torch.distributed import moe_ep
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"), moe_impl=impl)
    mesh = _FakeMesh(shape)
    assert moe_ep.moe_layout(cfg, mesh, ("data",)) == layout
    if impl == "ep_resident" and layout == "ep_resident":
        # a batch not split over data stays on the plain EP form
        assert moe_ep.moe_layout(cfg, mesh, ()) == "ep"
    w1 = T.param_defs(cfg)["blocks"]["b0_attn"]["ffn"]["w1"]
    w2 = T.param_defs(cfg)["blocks"]["b0_attn"]["ffn"]["w2"]
    want1 = {None: (), "ep": (None, "model"),
             "ep_resident": (None, "model", None, "data")}[layout]
    want2 = {None: (), "ep": (None, "model"),
             "ep_resident": (None, "model", "data")}[layout]
    # the blocks a layer computes with: moe_ep's in_specs
    assert SH.compute_spec(w1.axes, layout) == want1
    assert SH.compute_spec(w2.axes, layout) == want2
    # the blocks a rank stores, whatever the layout: TRAIN_RULES' spec
    specs = SH.leaf_specs(w1.shape, w1.axes, SH.TRAIN_RULES, mesh, layout)
    assert specs.compute == want1
    assert specs.storage == SH.spec_for(w1.shape, w1.axes, SH.TRAIN_RULES,
                                        mesh)
    if shape["model"] > 1:
        assert specs.storage[1] == "model"


def test_mesh_entry_points_raise_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh((1, 4), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_local_mesh(device="cpu")
    assert M.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert M.production_mesh_shape(True) == ((2, 16, 16),
                                             ("pod", "data", "model"))


@pytest.mark.parametrize("spec", [SH.P(), SH.P("model"),
                                  SH.P("model", None, "data"),
                                  SH.P(("pod", "data"), None)])
def test_a_spec_survives_pickling(spec):
    """Specs cross processes (a rank's results, ``all_gather_object``)."""
    import pickle
    back = pickle.loads(pickle.dumps(spec))
    assert type(back) is SH.P and back == spec and bool(back) == bool(spec)


LEAF_AXES = [  # (arch, impl, mesh, rules): {leaf path: (split, summed)}
    ("qwen3-moe-235b-a22b", "ep", "1x4", "TRAIN_RULES", {
        # JAX's spec keeps a data axis of one rank: nothing to sum over it
        "/blocks/b0_attn/ffn/w1": (("model", "data"), ()),
        "/blocks/b0_attn/attn/wq": (("data", "model"), ()),
        "/blocks/b0_attn/attn/ln": ((), ("model",)),
        "/embed": (("model",), ())}),
    ("qwen3-moe-235b-a22b", "ep", "2x2", "TRAIN_RULES", {
        "/blocks/b0_attn/ffn/w1": (("model", "data"), ()),
        "/blocks/b0_attn/ffn/w2": (("model", "data"), ()),
        "/blocks/b0_attn/ffn/wg": ((), ("data", "model")),
        "/blocks/b0_attn/attn/wo": (("model", "data"), ()),
        "/lm_head": (("model",), ("data",))}),
    ("qwen3-moe-235b-a22b", "ep_resident", "2x2", "TP_RULES", {
        "/blocks/b0_attn/ffn/w1": (("model",), ("data",)),
        "/blocks/b0_attn/attn/wq": (("model",), ("data",)),
        "/final_norm": ((), ("data", "model"))}),
    ("qwen3-8b", "ep", "2x2", "TRAIN_RULES", {
        "/blocks/b0_attn/ffn/w1": (("data", "model"), ()),
        "/blocks/b0_attn/attn/wo": (("model", "data"), ()),
        "/blocks/b0_attn/attn/qn": ((), ("data", "model"))}),
    ("mamba2-370m", "ep", "2x2", "TRAIN_RULES", {
        "/blocks/b0_ssd/ssd/in_proj": (("data", "model"), ()),
        "/blocks/b0_ssd/ssd/conv_w": (("model",), ("data",)),
        "/blocks/b0_ssd/ssd/a_log": ((), ("data", "model"))}),
]


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("arch,impl,mesh,rules,want", LEAF_AXES)
def test_leaf_axes_say_where_each_gradient_is_summed(arch, impl, mesh, rules,
                                                     want):
    """A leaf's gradient is summed over the axes of more than one rank
    that its stored block is not split over (the reshard's backward has
    summed it over those it is gathered over), so each block counts each
    rank's share once, whatever the MoE layout."""
    import dataclasses
    cfg = dataclasses.replace(get_arch(arch).reduced(), moe_impl=impl)
    fake = _FakeMesh(MESHES[mesh])
    axes = ST.leaf_axes(cfg, fake, getattr(SH, rules))
    specs = T.tree_leaves(T.param_block_specs(cfg, fake, getattr(SH, rules)),
                          is_leaf=SH.is_spec)
    paths = _leaf_paths(T.param_defs(cfg))
    assert len(axes) == len(specs) == len(paths)
    names = tuple(MESHES[mesh])
    for path, sp, (split, over) in zip(paths, specs, axes):
        live = [a for a in names if MESHES[mesh][a] > 1]
        assert set(split) | set(over) >= set(live) and not set(split) & set(
            over), path
        assert tuple(split) == tuple(a for part in sp if part for a in
                                     ((part,) if isinstance(part, str)
                                      else part)), path
        if path in want:
            assert (split, over) == want[path], (path, split, over)
    assert set(want) <= set(paths)


class _RankMesh(_FakeMesh):
    """A fake mesh seen from one rank: its index along each axis."""

    def __init__(self, shape, coords):
        super().__init__(shape)
        self.mesh_dim_names = tuple(shape)
        self.coords = coords

    def get_local_rank(self, name):
        return self.coords[name]


@pytest.mark.parametrize("impl,shape", [("ep", {"data": 1, "model": 4}),
                                        ("ep", {"data": 2, "model": 2}),
                                        ("ep_resident",
                                         {"data": 2, "model": 2})])
def test_place_params_keeps_the_rank_s_expert_blocks(impl, shape):
    """From a generator (leaf by leaf, the block cut from each fp32 draw)
    and from a whole tree: the rank's block of every leaf of
    ``init_params`` under ``param_block_specs`` (the expert leaves' and
    the dense leaves' alike, whatever the MoE layout), equal to the
    whole leaf's block; zero and one leaves (the QKV biases) at the
    block's shape."""
    import dataclasses
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").reduced(),
                              moe_impl=impl, qkv_bias=True)
    whole = T.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    defs = T.param_defs(cfg)
    specs = T.tree_leaves(T.param_block_specs(cfg, _FakeMesh(shape)),
                          is_leaf=SH.is_spec)
    for data in range(shape["data"]):
        for model in range(shape["model"]):
            mesh = _RankMesh(shape, {"data": data, "model": model})
            drawn = T.place_params(cfg, torch.Generator().manual_seed(5), mesh,
                                   device="cpu")
            given = T.place_params(cfg, whole, mesh, device="cpu")
            leaves = zip(T.tree_leaves(defs), specs, T.tree_leaves(whole),
                         T.tree_leaves(drawn), T.tree_leaves(given))
            n_expert = n_split = 0
            for pd, spec, w, d, g in leaves:
                want = SH.local_block(w, spec, mesh, mesh.coords)
                n_expert += "expert" in pd.axes and bool(spec)
                n_split += bool(spec)
                assert torch.equal(d, want) and torch.equal(g, want)
                assert d.is_contiguous() and d.numel() * math.prod(
                    mesh.shape[a] for part in spec if part for a in
                    ((part,) if isinstance(part, str) else part)) == w.numel()
            assert n_expert == 3           # the stacked w1, w3, w2
            assert n_split > n_expert      # the dense leaves too


@pytest.mark.parametrize("placed,run", [(("data",), ()), ((), ("data",))])
def test_blocks_placed_for_another_layout_are_refused(placed, run):
    """On a (2, 2) ``ep_resident`` mesh the batch's axes decide the layout:
    split over data, the experts' width is cut over data too; not split,
    every rank holds the whole width (``ep``).  Expert blocks laid out for
    one (``SH.compute_spec`` of the layout of ``placed``) and run by the
    other would sum two whole widths, or leave half of one out, in the
    collectives: the MoE FFN refuses them before any.  So does a stored
    block (D split over data) that was not resharded."""
    import dataclasses

    from repro_torch.distributed import moe_ep
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").reduced(),
                              moe_impl="ep_resident", dtype="float32")
    mesh = _RankMesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    whole = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ffn = T.group_params(whole["blocks"], 0)["b0_attn"]["ffn"]
    defs = T.param_defs(cfg)["blocks"]["b0_attn"]["ffn"]
    layout = moe_ep.moe_layout(cfg, mesh, placed)

    def blocks(spec_of):
        return {k: (SH.local_block(v, SH.P(*spec_of(defs[k])[1:]), mesh,
                                   mesh.coords) if k in ("w1", "w2", "w3")
                    else v) for k, v in ffn.items()}

    x = torch.zeros((2, 8, cfg.d_model))
    ctx = T.Ctx(cfg=cfg, shard=SH.make_act_sharder(mesh, run))
    with torch.no_grad(), pytest.raises(ValueError, match="expert width"):
        T.ffn_forward(cfg, blocks(lambda pd: SH.compute_spec(pd.axes,
                                                              layout)), x, ctx)
    with torch.no_grad(), pytest.raises(ValueError, match="d_model"):
        T.ffn_forward(cfg, blocks(lambda pd: SH.spec_for(
            pd.shape, pd.axes, SH.TRAIN_RULES, mesh)), x, ctx)
