"""Training over a mesh: the port's ranks against the JAX package's jitted
train step, on the CPU.

The reduced qwen3-moe-235b (8 experts of width 64, top-2, 2 layers) trains
3 AdamW steps on 8 gloo ranks (``launch.mesh.run_ranks``, one spawn for
the module; ``torch_mesh_ranks.train_mesh_rank``) over (2, 4) ``ep``,
(2, 4) ``ep_resident`` and (1, 8) ``ep`` meshes, at capacity factors 8
(nothing drops) and 1.25 (assignments drop; both sides on the same mesh
cap the same tokens), with the int8 gradient transform off and on.  JAX
runs ``make_train_step`` jitted on an 8-device host mesh of the same shape
in a subprocess (``--xla_force_host_platform_device_count=8``), its
parameters placed by ``TRAIN_RULES``; both start from the JAX package's
``init_params`` and take ``TokenStream``'s global batch (seed 1, 4 x 32),
each rank its block.  The reduced qwen3-8b and Mamba-2 train over (2, 1)
and (4, 1) meshes (Mamba-2 also with 2 microbatches a rank, held to JAX's
2 microbatches of the global batch: the same mean), held to JAX's step on
one device over the global batch.  Every rank stores only its block of
each leaf under the rules (FSDP over data, TP and the vocabulary over
model); the step reshards a layer at a time, under remat (the configs'
default).  ``SHARD_CASES`` train the reduced qwen3-8b and Mamba-2 over
the whole (2, 4) mesh, under ``TRAIN_RULES`` and under ``SEQPAR_RULES``
(the residual stream split over ``model`` along the sequence between
blocks: every block's output on a rank is its S / 4 rows, recorded by a
wrapper of ``transformer.apply_block``), and qwen3-8b under
``TP_RULES``, beside JAX's step on the same host mesh; there, and in the MoE's (2, 4) cases at capacity
factor 8 without int8, each rank's parameter and AdamW moment blocks must
have the shape of JAX's ``addressable_shards`` at the same mesh
coordinates and hold their values at the bars below.

Bars (fp32 on both sides; the sums run in other orders, and gloo's ring
adds the ranks' shares in its own): the first loss 1e-5 and its grad norm
1e-6 relative; later losses and norms 1e-4, where Adam's normalised
update has amplified the first step's rounding; the final parameters 1e-3
in relative Frobenius error, the bar of ``tests/test_torch_train.py``;
every rank's whole leaves byte-equal.  With int8 on, a gradient element
on a rounding boundary may get a code one off between the two packages,
and Adam turns that into a step of up to the learning rate in that
element, which a leaf that started at zero (Mamba-2's ``out_ln``, norm
~0.03 after 3 steps) reads as more than 1e-3: there a leaf may instead
differ in at most two elements by more than 1e-6, each by no more than
one learning rate (1e-3).  The split expert leaves' codes, each rank's block
quantized against the whole leaf's absmax, are byte-equal, block for
block, to JAX's ``compression._quantize_leaf`` of the whole reduced
gradient put together from the blocks.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.distributed import compression as JGC
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from torch_mesh_ranks import (CODES_CASES, COMPRESSION, DP_CASES, MOE_CF,
                              MOE_MESHES, SHARD_CASES, SHARD_MOE, TRAIN_B,
                              TRAIN_KW, TRAIN_S, TRAIN_SEED, TRAIN_STEPS,
                              dp_key, moe_key, shard_key, train_mesh_rank)

MOE = "qwen3-moe-235b-a22b"
ARCHS = [MOE, "qwen3-8b", "mamba2-370m"]

_JAX = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import TrainConfig, get_arch
    from repro.data.pipeline import TokenStream
    from repro.distributed import sharding as SH
    from repro.launch import steps as ST
    from repro.models import transformer as T
    from repro.optim import adamw
    d = dict(np.load(sys.argv[1]))
    c = json.loads(sys.argv[3])
    _at = getattr(jax.sharding, "AxisType", None)
    out = {}

    def dump(tree, tag, key, mesh):
        # each device's shard of each leaf, by its mesh coordinates
        at = {dv.id: ix for ix, dv in np.ndenumerate(mesh.devices)}
        for j, leaf in enumerate(jax.tree.leaves(tree)):
            for sh in leaf.addressable_shards:
                dd, mm = at[sh.device.id]
                out[f"{key}_s{tag}{j}_{dd}_{mm}"] = np.asarray(sh.data)

    def run(cfg, mesh, comp, mb, arch, key, rules=SH.TRAIN_RULES,
            shards=False):
        shapes = T.param_shapes(cfg)
        n = len(jax.tree.leaves(shapes))
        tree = jax.tree.unflatten(jax.tree.structure(shapes),
                                  [d[f"{arch}_{j}"] for j in range(n)])
        pspec = SH.param_spec_tree(shapes, T.param_logical_axes(cfg), rules,
                                   mesh)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspec,
                           is_leaf=lambda x: isinstance(x, P))
        osh = adamw.AdamWState(NamedSharding(mesh, P()), psh, psh)
        tcfg = TrainConfig(grad_compression=comp, microbatches=mb,
                           **c["kw"])
        stream = TokenStream(cfg, c["B"], c["S"], c["seed"])
        bsh = {k: NamedSharding(mesh, SH.batch_spec(v.shape, rules, mesh))
               for k, v in stream.batch_at(0).items()}
        with mesh:
            params = jax.device_put(tree, psh)
            opt = jax.device_put(adamw.init(params), osh)
            step = jax.jit(ST.make_train_step(cfg, mesh, tcfg, rules),
                           in_shardings=(psh, osh, bsh),
                           out_shardings=(psh, osh, None))
            for i in range(c["steps"]):
                params, opt, m = step(params, opt, stream.batch_at(i))
                out[f"{key}_loss{i}"] = np.asarray(m["loss"])
                out[f"{key}_gnorm{i}"] = np.asarray(m["grad_norm"])
        for j, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{key}_p{j}"] = np.asarray(leaf)
        if shards:
            dump(params, "p", key, mesh)
            dump(opt.mu, "mu", key, mesh)
            dump(opt.nu, "nu", key, mesh)

    def host_mesh(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             **({"axis_types": (_at.Auto,) * 2} if _at
                                else {}))

    for shape, impl, cf, comp, key, shards in c["moe"]:
        cfg = dataclasses.replace(get_arch(c["moe_arch"]).reduced(),
                                  moe_impl=impl, moe_capacity_factor=cf)
        run(cfg, host_mesh(shape), comp, 1, c["moe_arch"], key,
            shards=shards)
    for arch, shape, rname, comp, key in c["shard"]:
        run(get_arch(arch).reduced(), host_mesh(shape), comp, 1, arch, key,
            getattr(SH, rname), shards=True)
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for arch, comp, mb, key in c["dp"]:
        run(get_arch(arch).reduced(), one, comp, mb, arch, key)
    np.savez(sys.argv[2], **out)
    print("JAX_TRAIN_OK")
""")


def _jax_dp_key(arch, comp, mb):
    return f"{arch}_one_{comp}_{mb}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's ranks' results by rank)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = {}
    for arch in ARCHS:
        leaves = jax.tree.leaves(JT.init_params(jget_arch(arch).reduced(),
                                                jax.random.PRNGKey(0)))
        inputs.update({f"{arch}_{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
    np.savez(tmp / "inputs.npz", **inputs)
    cases = {
        "moe_arch": MOE, "B": TRAIN_B, "S": TRAIN_S, "seed": TRAIN_SEED,
        "steps": TRAIN_STEPS, "kw": TRAIN_KW,
        "moe": [(shape, impl, cf, comp, moe_key(shape, impl, cf, comp),
                 (shape, impl, cf, comp) in SHARD_MOE)
                for shape, impl in MOE_MESHES for cf in MOE_CF
                for comp in COMPRESSION],
        "shard": [(arch, shape, rname, comp,
                   shard_key(arch, shape, rname, comp))
                  for arch, shape, rname, comp in SHARD_CASES],
        "dp": sorted({(arch, comp, mb, _jax_dp_key(arch, comp, mb))
                      for arch, _, comp, mb in DP_CASES})}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    # JAX's cases in two processes beside the ranks: its compiles bind
    halves = [dict(cases, moe=cases["moe"][:6], dp=[]),
              dict(cases, moe=cases["moe"][6:], shard=[])]
    jax_runs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "inputs.npz"),
         str(tmp / f"jax{i}.npz"), json.dumps(half)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, half in enumerate(halves)]
    (tmp / "ranks").mkdir()
    try:
        M.run_ranks(train_mesh_rank, 8, str(tmp / "inputs.npz"),
                    str(tmp / "ranks"), timeout_s=400)
    finally:
        logs = [run.communicate(timeout=400)[0] for run in jax_runs]
    for log in logs:
        assert "JAX_TRAIN_OK" in log, log
    ranks = [dict(np.load(tmp / "ranks" / f"rank{r}.npz"))
             for r in range(8)]
    jx = {}
    for i in range(len(halves)):
        jx.update(np.load(tmp / f"jax{i}.npz"))
    return jx, ranks


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _specs(cfg, shape, rules=None):
    """Each leaf's stored block spec on a (data, model) mesh of ``shape``
    under ``rules``, and the mesh as the spec functions see it."""
    fake = type("Fake", (), {"shape": {"data": shape[0], "model": shape[1]}})
    return (T.tree_leaves(T.param_block_specs(cfg, fake, rules),
                          is_leaf=SH.is_spec), fake)


def _assemble(blocks, spec, fake, shape):
    """The whole tensor from the blocks of the ranks (rank = data * model
    + model index), each put where ``spec`` says."""
    first = blocks[0]
    whole_shape = list(first.shape)
    for dim, part in enumerate(spec):
        if part is not None:
            whole_shape[dim] *= SH.block_index(part, fake, {
                "data": 0, "model": 0})[1]
    out = np.zeros(whole_shape, first.dtype)
    for r, b in enumerate(blocks):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        idx = []
        for dim, part in enumerate(spec):
            if part is None:
                idx.append(slice(None))
                continue
            i, n = SH.block_index(part, fake, coords)
            size = whole_shape[dim] // n
            idx.append(slice(i * size, (i + 1) * size))
        out[tuple(idx)] = b
    return out


def _leaf_held(got, want, int8) -> bool:
    if _rel(got, want) <= 1e-3:
        return True
    off = np.abs(got.astype(np.float64) - want)
    return (int8 and int((off > 1e-6).sum()) <= 2
            and off.max() <= TRAIN_KW["lr"])


def _held(jx, ranks, key, jkey, cfg, shape, int8, rules=None):
    n = math.prod(shape)
    for i in range(TRAIN_STEPS):
        for r in ranks[:n]:       # the metrics are global: equal everywhere
            assert r[f"{key}_loss{i}"] == ranks[0][f"{key}_loss{i}"]
            assert r[f"{key}_gnorm{i}"] == ranks[0][f"{key}_gnorm{i}"]
        bar = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(ranks[0][f"{key}_loss{i}"],
                                   jx[f"{jkey}_loss{i}"], rtol=bar)
        np.testing.assert_allclose(ranks[0][f"{key}_gnorm{i}"],
                                   jx[f"{jkey}_gnorm{i}"],
                                   rtol=1e-6 if i == 0 else 1e-4)
    specs, fake = _specs(cfg, shape, rules)
    for j, spec in enumerate(specs):
        if spec:
            got = _assemble([r[f"{key}_p{j}"] for r in ranks[:n]], spec,
                            fake, shape)
        else:
            got = ranks[0][f"{key}_p{j}"]
            for r in ranks[:n]:
                assert r[f"{key}_h{j}"] == ranks[0][f"{key}_h{j}"], j
        want = jx[f"{jkey}_p{j}"]
        assert got.shape == want.shape, j
        assert _leaf_held(got, want, int8), (j, _rel(got, want))


MOE_IDS = [moe_key(s, i, cf, c) for s, i in MOE_MESHES for cf in MOE_CF
           for c in COMPRESSION]


@pytest.mark.parametrize("case", [(s, i, cf, c) for s, i in MOE_MESHES
                                  for cf in MOE_CF for c in COMPRESSION],
                         ids=MOE_IDS)
def test_moe_train_steps_over_a_mesh_match_jax(runs, case):
    import dataclasses
    jx, ranks = runs
    shape, impl, cf, comp = case
    key = moe_key(*case)
    cfg = dataclasses.replace(get_arch(MOE).reduced(), moe_impl=impl,
                              moe_capacity_factor=cf)
    _held(jx, ranks, key, key, cfg, shape, comp == "int8")


@pytest.mark.parametrize("case", DP_CASES, ids=[dp_key(*c) for c in DP_CASES])
def test_data_parallel_steps_match_jax_on_one_device(runs, case):
    jx, ranks = runs
    arch, shape, comp, mb = case
    _held(jx, ranks, dp_key(*case), _jax_dp_key(arch, comp, mb),
          get_arch(arch).reduced(), shape, comp == "int8")


SHARD_IDS = [shard_key(*c) for c in SHARD_CASES]


@pytest.mark.parametrize("case", SHARD_CASES, ids=SHARD_IDS)
def test_whole_mesh_train_steps_match_jax_on_the_same_mesh(runs, case):
    jx, ranks = runs
    arch, shape, rname, comp = case
    key = shard_key(*case)
    _held(jx, ranks, key, key, get_arch(arch).reduced(), shape,
          comp == "int8", getattr(SH, rname))


@pytest.mark.parametrize("case", [("moe",) + c for c in SHARD_MOE]
                         + [("dense",) + c for c in SHARD_CASES],
                         ids=[moe_key(*c) for c in SHARD_MOE] + SHARD_IDS)
def test_each_rank_holds_jax_s_addressable_shards(runs, case):
    """Every rank's block of every parameter and AdamW moment after the
    steps has the shape of the shard JAX's device at the same (data,
    model) coordinates holds, and its values (``_leaf_held``'s bars)."""
    import dataclasses
    jx, ranks = runs
    if case[0] == "moe":
        shape, impl, cf, comp = case[1:]
        key, rules = moe_key(*case[1:]), None
        cfg = dataclasses.replace(get_arch(MOE).reduced(), moe_impl=impl,
                                  moe_capacity_factor=cf)
    else:
        arch, shape, rname, comp = case[1:]
        key, rules = shard_key(*case[1:]), getattr(SH, rname)
        cfg = get_arch(arch).reduced()
    specs, _ = _specs(cfg, shape, rules)
    assert any(specs) and sum(bool(sp) for sp in specs) > sum(
        "expert" in pd.axes for pd in T.tree_leaves(T.param_defs(cfg)))
    for r, got in enumerate(ranks[:math.prod(shape)]):
        at = f"{r // shape[1]}_{r % shape[1]}"
        for j in range(len(specs)):
            for tag in ("p", "mu", "nu"):
                want = jx[f"{key}_s{tag}{j}_{at}"]
                mine = got[f"{key}_{tag}{j}"]
                assert mine.shape == want.shape, (r, tag, j)
                assert _leaf_held(mine, want, comp == "int8"), (
                    r, tag, j, _rel(mine, want))


@pytest.mark.parametrize("shape,impl", CODES_CASES)
def test_split_leaf_codes_are_the_whole_leafs_codes_in_jax(runs, shape,
                                                             impl):
    import dataclasses
    _, ranks = runs
    key = moe_key(shape, impl, MOE_CF[0], "codes")
    cfg = dataclasses.replace(get_arch(MOE).reduced(), moe_impl=impl,
                              moe_capacity_factor=MOE_CF[0])
    specs, fake = _specs(cfg, shape)
    split = [j for j, sp in enumerate(specs) if sp]
    assert split and all(f"{key}_q{j}" in ranks[0] for j in split)
    for j in split:
        whole = _assemble([r[f"{key}_g{j}"] for r in ranks], specs[j], fake,
                          shape)
        q, _ = JGC._quantize_leaf(whole)
        want = np.asarray(q)
        got = _assemble([r[f"{key}_q{j}"] for r in ranks], specs[j], fake,
                        shape)
        assert np.abs(want).max() == 127
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", SHARD_CASES, ids=SHARD_IDS)
def test_between_blocks_a_rank_holds_its_rows_of_the_stream(runs, case):
    """Every block's output on every rank, a layer of each step's forward
    (remat's recompute stops once it has what the backward needs, before
    the block returns): under ``SEQPAR_RULES`` the rank's S / 4 rows of
    the sequence, the (2, 4) mesh's ``model`` ranks each a quarter; under
    the other rule sets the whole sequence."""
    _, ranks = runs
    arch, shape, rname, _ = case
    cfg = get_arch(arch).reduced()
    want = TRAIN_S // shape[1] if rname == "SEQPAR_RULES" else TRAIN_S
    for r in ranks:
        rows = r[shard_key(*case) + "_rows"]
        assert len(rows) == TRAIN_STEPS * cfg.num_layers, len(rows)
        assert set(rows.tolist()) == {want}
