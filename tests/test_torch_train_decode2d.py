"""Training under ``DECODE_RULES``: the port's ranks against the JAX
package's jitted train step on the same mesh, on the CPU.

Under ``DECODE_RULES`` the weights stay resident in their 2-D blocks,
every rank holds the whole token batch (it splits over ``pod`` alone,
which a (data, model) mesh lacks) and the residual stream splits over
``data`` along the hidden dim: column-parallel products sum their data
partials, the norms their squares, and the outputs of leaves kept whole
over ``model`` (the SSD block's in_proj and conv, MLA's ``wq_a``, the
MoE's whole-width rows) are gathered, each collective's backward JAX's
transpose.  ``torch_mesh_ranks.decode2d_train_rank`` runs
``DECODE2D_CASES`` on 8 gloo ranks over (2, 4) (one spawn for the
module): the reduced qwen3-8b with and without int8, Mamba-2 370M, the
qwen3-moe ``ep`` at capacity factor 8, RecurrentGemma-2B and MiniCPM3-4B
(MLA), each 3 AdamW steps from the JAX package's ``init_params`` on
``TokenStream``'s batches (seed 1, 4 x 32).  JAX runs ``make_train_step(
cfg, mesh, tcfg, DECODE_RULES)`` jitted on an 8-device host mesh of the
same shape in a subprocess, and the first batch's gradient jitted on the
same mesh.

Bars: those of ``tests/test_torch_train_mesh.py`` (its ``_held`` and
``_leaf_held``), unchanged: the first loss 1e-5 and its grad norm 1e-6
relative, later ones 1e-4, the final parameters and every rank's
parameter and AdamW moment blocks against JAX's ``addressable_shards``
1e-3 in relative Frobenius error (with int8, at most two elements off by
up to one learning rate).  A gather that carried no gradient would leave
every leaf upstream of it zero on every rank: no block of the reduced
gradient of the first step may be zero where JAX's is not.
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
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from test_torch_train_mesh import _assemble, _held, _leaf_held, _rel, _specs
from torch_mesh_ranks import (DECODE2D_CASES, DECODE2D_SHAPE, TRAIN_B,
                              TRAIN_KW, TRAIN_S, TRAIN_SEED, TRAIN_STEPS,
                              decode2d_key, decode2d_train_rank)

_JAX = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import TrainConfig, get_arch
    from repro.data.pipeline import TokenStream
    from repro.distributed import sharding as SH
    from repro.launch import steps as ST
    from repro.models import transformer as T
    from repro.optim import adamw
    d = dict(np.load(sys.argv[1]))
    c = json.loads(sys.argv[3])
    _at = getattr(jax.sharding, "AxisType", None)
    mesh = jax.make_mesh(tuple(c["shape"]), ("data", "model"),
                         **({"axis_types": (_at.Auto,) * 2} if _at else {}))
    at = {dv.id: ix for ix, dv in np.ndenumerate(mesh.devices)}
    rules = SH.DECODE_RULES
    out, grads = {}, {}

    def dump(tree, tag, key):
        # each device's shard of each leaf, by its mesh coordinates
        for j, leaf in enumerate(jax.tree.leaves(tree)):
            for sh in leaf.addressable_shards:
                dd, mm = at[sh.device.id]
                out[f"{key}_s{tag}{j}_{dd}_{mm}"] = np.asarray(sh.data)

    for arch, over, comp, key in c["cases"]:
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        shapes = T.param_shapes(cfg)
        n = len(jax.tree.leaves(shapes))
        tree = jax.tree.unflatten(jax.tree.structure(shapes),
                                  [d[f"{arch}_{j}"] for j in range(n)])
        pspec = SH.param_spec_tree(shapes, T.param_logical_axes(cfg), rules,
                                   mesh)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspec,
                           is_leaf=lambda x: isinstance(x, P))
        osh = adamw.AdamWState(NamedSharding(mesh, P()), psh, psh)
        tcfg = TrainConfig(grad_compression=comp, **c["kw"])
        stream = TokenStream(cfg, c["B"], c["S"], c["seed"])
        bsh = {k: NamedSharding(mesh, SH.batch_spec(v.shape, rules, mesh))
               for k, v in stream.batch_at(0).items()}
        shard = SH.make_act_sharder(mesh, rules)
        gkey = json.dumps([arch, over])
        with mesh:
            params = jax.device_put(tree, psh)
            if gkey not in grads:
                # the first batch's gradient, before any int8 transform:
                # the same for every compression of one config
                grads[gkey] = [np.asarray(g) for g in jax.tree.leaves(
                    jax.jit(lambda p, b: jax.grad(ST.loss_fn, argnums=1)(
                        cfg, p, b, shard), in_shardings=(psh, bsh),
                        out_shardings=psh)(params, stream.batch_at(0)))]
            for j, g in enumerate(grads[gkey]):
                out[f"{key}_gw{j}"] = g
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
        dump(params, "p", key)
        dump(opt.mu, "mu", key)
        dump(opt.nu, "nu", key)
    np.savez(sys.argv[2], **out)
    print("JAX_TRAIN_OK")
""")

IDS = [decode2d_key(*c) for c in DECODE2D_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's ranks' results by rank)."""
    tmp = tmp_path_factory.mktemp("train_decode2d")
    inputs = {}
    for arch in sorted({a for a, _, _ in DECODE2D_CASES}):
        leaves = jax.tree.leaves(JT.init_params(jget_arch(arch).reduced(),
                                                jax.random.PRNGKey(0)))
        inputs.update({f"{arch}_{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
    np.savez(tmp / "inputs.npz", **inputs)
    cases = [(a, ov, comp, decode2d_key(a, ov, comp))
             for a, ov, comp in DECODE2D_CASES]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    # JAX's cases in three processes beside the ranks (its compiles bind),
    # qwen3-8b's two compressions in one: they share the gradient
    parts = [cases[:2], cases[2:4], cases[4:]]
    jax_runs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "inputs.npz"),
         str(tmp / f"jax{i}.npz"), json.dumps({
             "cases": part, "shape": DECODE2D_SHAPE, "B": TRAIN_B,
             "S": TRAIN_S, "seed": TRAIN_SEED, "steps": TRAIN_STEPS,
             "kw": TRAIN_KW})], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, part in enumerate(parts)]
    (tmp / "ranks").mkdir()
    world = math.prod(DECODE2D_SHAPE)
    try:
        M.run_ranks(decode2d_train_rank, world, str(tmp / "inputs.npz"),
                    str(tmp / "ranks"), timeout_s=400)
    finally:
        logs = [run.communicate(timeout=400)[0] for run in jax_runs]
    for log in logs:
        assert "JAX_TRAIN_OK" in log, log
    ranks = [dict(np.load(tmp / "ranks" / f"rank{r}.npz"))
             for r in range(world)]
    jx = {}
    for i in range(len(parts)):
        jx.update(np.load(tmp / f"jax{i}.npz"))
    return jx, ranks


def _cfg(arch, over):
    import dataclasses
    return dataclasses.replace(get_arch(arch).reduced(), **over)


@pytest.mark.parametrize("case", DECODE2D_CASES, ids=IDS)
def test_decode_rules_train_steps_match_jax_on_the_same_mesh(runs, case):
    """The losses, grad norms and final parameters of 3 steps (every
    rank's metrics equal, every whole leaf byte-equal across ranks)."""
    jx, ranks = runs
    arch, over, comp = case
    key = decode2d_key(*case)
    _held(jx, ranks, key, key, _cfg(arch, over), DECODE2D_SHAPE,
          comp == "int8", SH.DECODE_RULES)


@pytest.mark.parametrize("case", DECODE2D_CASES, ids=IDS)
def test_each_rank_holds_jax_s_addressable_shards(runs, case):
    """Every rank's block of every parameter and AdamW moment after the
    steps has the shape of the shard JAX's device at the same (data,
    model) coordinates holds, and its values (``_leaf_held``'s bars)."""
    jx, ranks = runs
    arch, over, comp = case
    key = decode2d_key(*case)
    specs, _ = _specs(_cfg(arch, over), DECODE2D_SHAPE, SH.DECODE_RULES)
    assert any(specs)
    for r, got in enumerate(ranks):
        at = f"{r // DECODE2D_SHAPE[1]}_{r % DECODE2D_SHAPE[1]}"
        for j in range(len(specs)):
            for tag in ("p", "mu", "nu"):
                want = jx[f"{key}_s{tag}{j}_{at}"]
                mine = got[f"{key}_{tag}{j}"]
                assert mine.shape == want.shape, (r, tag, j)
                assert _leaf_held(mine, want, comp == "int8"), (
                    r, tag, j, _rel(mine, want))


@pytest.mark.parametrize("case", DECODE2D_CASES, ids=IDS)
def test_no_gradient_block_is_zero_where_jax_s_is_not(runs, case):
    """The first step's reduced gradient, each rank's block of each leaf
    where the step hands it on: never all zero where JAX's gradient of
    the same block is not (a gather without a gradient would zero every
    leaf before it), and put together from the blocks within 1e-4 of
    JAX's in relative Frobenius error."""
    jx, ranks = runs
    arch, over, comp = case
    key = decode2d_key(*case)
    shape = DECODE2D_SHAPE
    specs, fake = _specs(_cfg(arch, over), shape, SH.DECODE_RULES)
    for j, spec in enumerate(specs):
        want = jx[f"{key}_gw{j}"]
        for r, got in enumerate(ranks):
            block = SH.local_block(
                torch.from_numpy(want), spec, fake,
                {"data": r // shape[1], "model": r % shape[1]}).numpy()
            mine = got[f"{key}_g{j}"]
            assert mine.shape == block.shape, (r, j)
            assert np.any(mine != 0) or not np.any(block != 0), (r, j)
        whole = (_assemble([g[f"{key}_g{j}"] for g in ranks], spec, fake,
                           shape) if spec else ranks[0][f"{key}_g{j}"])
        assert _rel(whole, want) <= 1e-4, (j, _rel(whole, want))
