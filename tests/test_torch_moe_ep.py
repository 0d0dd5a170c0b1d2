"""The port's expert-parallel MoE (``distributed/moe_ep.py``) on a gloo
group of 8 ranks on the CPU, against the JAX package's on an 8-device host
mesh.

The inputs are ``tests/test_distributed.py``'s shapes (B 4, S 8, D 16, 8
experts of width 32, top-2), drawn with numpy and handed to both sides
through an ``.npz``: JAX runs ``moe_ffn_ep`` and ``moe_ffn_ep_resident``
on a (2, 4) ("data", "model") host mesh in a subprocess (as
``tests/test_distributed.py:142`` runs it), the port's 8 ranks
(``launch.mesh.run_ranks``, one group for the module) run them on their
blocks.  At capacity factor 8 nothing drops; at 1.25 the capacity drops
assignments, and both sides must drop the same ones.  Both are fp32: the
bar is 1e-5.  The port's own equalities, which the card's phase 16(b)
relies on: on a (1, 8) mesh ``moe_ffn_ep`` is the gather path
(``layers.moe_ffn``) over the whole batch, and so is the resident form on
(2, 4); ``moe_ffn_ep`` on (2, 4) is the gather path over each data block
on its own, its capacity counting the block.  JAX's ``aux`` is compared
where it is defined (the resident form); ``moe_ffn_ep``'s each rank's own.

The gradients: each rank differentiates its share of sum(out * c) (a data
block's share split evenly over the model axis) through the collectives'
backward (``distributed.collectives``); summed over the ranks that hold
the same block (x over the model axis, the gate over every rank, an
``ep`` expert block over the data axis, a resident block over none) they
must be autograd's gradient of the gather path at the same bar, at both
capacity factors (a dropped assignment passes no gradient).
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from torch_mesh_ranks import EP_CAPACITY, ep_rank

B, S, D, E, F_, K = 4, 8, 16, 8, 32, 2
TOL = dict(rtol=1e-5, atol=1e-5)

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.distributed.moe_ep import moe_ffn_ep, moe_ffn_ep_resident
    _at = getattr(jax.sharding, "AxisType", None)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         **({"axis_types": (_at.Auto,) * 2} if _at else {}))
    d = dict(np.load(sys.argv[1]))
    args = [d[n] for n in ("x", "wg", "w1", "w3", "w2")]
    out = {}
    for name, fn in (("ep", moe_ffn_ep), ("resident", moe_ffn_ep_resident)):
        for cf in %r:
            with mesh:
                o, aux = jax.jit(lambda *a: fn(
                    *a, num_experts=%d, k=%d, capacity_factor=cf, act="silu",
                    mesh=mesh, batch_axes=("data",)))(*args)
            out[f"{name}_{cf}"] = np.asarray(o)
            out[f"{name}_{cf}_aux"] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
    print("JAX_EP_OK")
""") % (EP_CAPACITY, E, K)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX's outputs, the port's ranks' outputs by rank)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    inputs = {"x": f(B, S, D), "wg": f(D, E), "w1": f(E, D, F_, std=0.1),
              "w3": f(E, D, F_, std=0.1), "w2": f(E, F_, D, std=0.1),
              "k": np.int32(K), "c": f(B, S, D)}
    np.savez(tmp / "inputs.npz", **inputs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    (tmp / "ranks").mkdir()
    try:
        M.run_ranks(ep_rank, 8, str(tmp / "inputs.npz"), str(tmp / "ranks"),
                    timeout_s=300)
    finally:
        log = jax_run.communicate(timeout=300)[0]
    assert "JAX_EP_OK" in log, log
    ranks = [dict(np.load(tmp / "ranks" / f"rank{r}.npz")) for r in range(8)]
    return inputs, dict(np.load(tmp / "jax.npz")), ranks


def _whole(ranks, key, data):
    """The whole (B, S, D) output from each data block's model-0 rank, and
    every rank of a block holding the same numbers."""
    model = 8 // data
    blocks = []
    for di in range(data):
        first = ranks[di * model][key]
        for mi in range(model):
            np.testing.assert_array_equal(ranks[di * model + mi][key], first)
        blocks.append(first)
    return np.concatenate(blocks, axis=0)


def _gather(inputs, x, cf):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out, aux = L.moe_ffn(t(x).reshape(-1, D), t(inputs["wg"]),
                         t(inputs["w1"]), t(inputs["w3"]), t(inputs["w2"]),
                         num_experts=E, k=K, capacity_factor=cf)
    return out.reshape(x.shape).numpy(), aux.numpy()


def _dropped(x, wg, cf):
    """Assignments past their expert's capacity (numpy)."""
    xf = x.reshape(-1, D)
    C = max(8, int(math.ceil(len(xf) * K * cf / E)))
    top = np.argsort(-(xf @ wg), axis=-1, kind="stable")[:, :K]
    return int(np.maximum(np.bincount(top.ravel(), minlength=E) - C, 0).sum())


@pytest.mark.parametrize("cf", EP_CAPACITY)
@pytest.mark.parametrize("name", ["ep", "resident"])
def test_port_matches_jax_on_a_2x4_mesh(runs, name, cf):
    inputs, jax_out, ranks = runs
    got = _whole(ranks, f"2x4_{name}_{cf}", 2)
    np.testing.assert_allclose(got, jax_out[f"{name}_{cf}"], **TOL)
    if name == "resident":       # identical on every shard in JAX too
        for r in ranks:
            np.testing.assert_allclose(r[f"2x4_{name}_{cf}_aux"],
                                       jax_out[f"{name}_{cf}_aux"], **TOL)


def test_the_low_capacity_drops_assignments(runs):
    inputs = runs[0]
    assert _dropped(inputs["x"], inputs["wg"], 1.25) > 0
    assert _dropped(inputs["x"], inputs["wg"], 8.0) == 0


@pytest.mark.parametrize("cf", EP_CAPACITY)
def test_1x8_ep_is_the_gather_path_over_the_whole_batch(runs, cf):
    inputs, _, ranks = runs
    want, aux = _gather(inputs, inputs["x"], cf)
    np.testing.assert_allclose(_whole(ranks, f"1x8_ep_{cf}", 1), want, **TOL)
    for r in ranks:
        np.testing.assert_allclose(r[f"1x8_ep_{cf}_aux"], aux, **TOL)


@pytest.mark.parametrize("cf", EP_CAPACITY)
def test_resident_is_the_gather_path_over_the_whole_batch(runs, cf):
    inputs, _, ranks = runs
    want, aux = _gather(inputs, inputs["x"], cf)
    np.testing.assert_allclose(_whole(ranks, f"2x4_resident_{cf}", 2), want,
                               **TOL)
    for r in ranks:
        np.testing.assert_allclose(r[f"2x4_resident_{cf}_aux"], aux, **TOL)


@pytest.mark.parametrize("cf", EP_CAPACITY)
def test_2x4_ep_is_the_gather_path_over_each_data_block(runs, cf):
    inputs, _, ranks = runs
    got = _whole(ranks, f"2x4_ep_{cf}", 2)
    for di in range(2):
        want, aux = _gather(inputs, inputs["x"][2 * di: 2 * di + 2], cf)
        np.testing.assert_allclose(got[2 * di: 2 * di + 2], want, **TOL)
        for mi in range(4):
            np.testing.assert_allclose(ranks[4 * di + mi][f"2x4_ep_{cf}_aux"],
                                       aux, **TOL)


def test_a_mesh_the_world_does_not_fill_raises(runs):
    assert all(int(r["mismatch_raises"]) == 1 for r in runs[2])


MESH_FORMS = [((2, 4), "ep"), ((2, 4), "resident"), ((1, 8), "ep")]


def _gather_grads(inputs, cf, blocks):
    """Autograd's gradient of sum(out * c) through the gather path, over
    the whole batch or (``blocks``) over each data block on its own."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = [t(inputs[n]).requires_grad_()
            for n in ("x", "wg", "w1", "w3", "w2")]
    parts = args[0].split(B // 2) if blocks else [args[0]]
    cs = t(inputs["c"]).split(B // 2) if blocks else [t(inputs["c"])]
    loss = 0.0
    for xb, cb in zip(parts, cs):
        out, _ = L.moe_ffn(xb.reshape(-1, D), *args[1:], num_experts=E, k=K,
                           capacity_factor=cf)
        loss = loss + (out.reshape(xb.shape) * cb).sum()
    return dict(zip(("x", "wg", "w1", "w3", "w2"),
                    (g.numpy() for g in torch.autograd.grad(loss, args))))


def _reduced(ranks, key, shape, name):
    """The ranks' gradients summed over the ranks of each block and put
    together into whole tensors."""
    data, model = shape
    at = lambda di, mi, n: ranks[di * model + mi][f"{key}_d{n}"]
    out = {"x": np.concatenate([sum(at(di, mi, "x") for mi in range(model))
                                for di in range(data)]),
           "wg": sum(r[f"{key}_dwg"] for r in ranks)}
    for n in ("w1", "w3", "w2"):
        if name == "ep":
            out[n] = np.concatenate([sum(at(di, mi, n) for di in range(data))
                                     for mi in range(model)])
        else:       # F split over data: w1/w3's last dim, w2's middle one
            fdim = 2 if n != "w2" else 1
            out[n] = np.concatenate([
                np.concatenate([at(di, mi, n) for di in range(data)],
                               axis=fdim) for mi in range(model)])
    return out


@pytest.mark.parametrize("cf", EP_CAPACITY)
@pytest.mark.parametrize("shape,name", MESH_FORMS)
def test_gradients_summed_over_the_ranks_are_the_gather_paths(runs, shape,
                                                              name, cf):
    inputs, _, ranks = runs
    got = _reduced(ranks, f"{shape[0]}x{shape[1]}_{name}_{cf}", shape, name)
    want = _gather_grads(inputs, cf, blocks=shape[0] > 1 and name == "ep")
    for n in want:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
        assert np.abs(want[n]).max() > 0, n
