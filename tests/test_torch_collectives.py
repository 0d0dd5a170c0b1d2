"""The pieces of training over a mesh, on a gloo group of 4 ranks on the
CPU (``launch.mesh.run_ranks``, one spawn for the module; the rank
function is ``torch_mesh_ranks.units_rank``).

- ``collectives.psum`` and ``all_gather_tiled`` over each axis of a (2, 2)
  mesh: each rank differentiates sum(y * w_r) in its x_r; the forward must
  be the sum (the concatenation in the axis's order) of the group's x, and
  x_r's gradient autograd's gradient of the sum over all ranks of
  sum(y_r * w_r) in x_r, computed here in one process (fp32, 1e-6).
- ``collectives.all_gather_dim`` and ``psum_scatter`` along dim 1 over
  each axis of the (2, 2) mesh (``SEQ_COLLECTIVES``, the residual stream's
  sequence split under ``SEQPAR_RULES``): the forward the concatenation
  in the axis's order (the rank's block of the sum), x_r's gradient
  autograd's gradient of the whole-tensor arithmetic summed over the
  ranks (fp32, 1e-6): the gather's backward a reduce-scatter, the
  scatter's an all-gather.  In bf16 over the 4 ranks of a (1, 4) mesh,
  both sum in fp32 and round once: 1, 2^-8, 2^-8, 0 give 1 + 2^-7, in
  bf16 (the output's dtype).
- ``collectives.reshard`` from a stored block to a computed one
  (``RESHARD_CASES``: gathered whole, the resident experts' move of the
  split from D to F, a swap of axes, a cut alone): the forward must be
  the rank's block of the whole tensor under the target spec, and the
  sum of the gradients of the ranks holding the same stored block
  autograd's gradient of the sum over ranks in one process, cut to that
  block (fp32, 1e-6).  In bf16 the backward sums in fp32: cotangents 1,
  2^-8, 2^-8, 0 give 1 + 2^-7, where bf16 adds over model, then data,
  give 1.
- ``cfg.remat`` on the reduced qwen3-moe over the mesh (every leaf stored
  split but the norms, gate and positions): with it on, no tensor kept
  for the backward outside a checkpoint has the whole per-layer shape of
  a split leaf; with it off some do (the probe sees them); the gradients
  agree within 1e-6.
- The global norm AdamW takes with ``launch.steps.norm_reduction``, over
  the reduced qwen3-moe's placed parameters (``ep``: experts split over
  model; ``ep_resident``: also their width over data): each block counted
  once, so it is the whole tree's norm (1e-6 relative).
- The launcher over a mesh: the reduced qwen3-moe (``ep_resident``) over
  (2, 2) and the reduced Mamba-2 over a (2, 1) mesh of two ranks train
  4 steps straight and as 2 + a crash + a resume of 2, which must give
  the same losses exactly (JAX's ``test_train_crash_restart_resumes_
  identically``, on a mesh); the straight losses are one process's within
  1e-5 (fp32; the sums run in another order), and the mesh's step-2
  checkpoint, restored in one process, continues to the mesh's last two
  losses within 1e-5.
"""
import dataclasses
import math
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.distributed import sharding as SH
from torch_mesh_ranks import (BF16_COTANGENTS, RESHARD_CASES,
                              SEQ_COLLECTIVES, UNIT_MOE, UNIT_TRAIN,
                              units_rank)

SHAPE = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_units")
    M.run_ranks(units_rank, 4, str(out), timeout_s=300)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _groups(axis):
    """The ranks of each group along ``axis`` of the (2, 2) mesh, in the
    axis's order (rank = 2 * data + model)."""
    if axis == "model":
        return [[0, 1], [2, 3]]
    return [[0, 2], [1, 3]]


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("name", ["psum", "gather"])
def test_a_collectives_backward_is_autograd_of_the_sum_over_ranks(
        ranks, name, axis):
    got = ranks[1]
    key = f"{name}_{axis}"
    xs = [torch.from_numpy(r[f"{key}_x"]).requires_grad_() for r in got]
    total = 0.0
    for group in _groups(axis):
        if name == "psum":
            y = sum(xs[r] for r in group)
        else:
            y = torch.cat([xs[r] for r in group])
        for r in group:
            np.testing.assert_allclose(got[r][f"{key}_y"],
                                       y.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
            total = total + (y * torch.from_numpy(got[r][f"{key}_w"])).sum()
    want = torch.autograd.grad(total, xs)
    for r in range(4):
        np.testing.assert_allclose(got[r][f"{key}_dx"], want[r].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("name", [c[0] for c in SEQ_COLLECTIVES])
def test_sequence_collectives_backward_is_autograd_of_the_whole(
        ranks, name, axis):
    got = ranks[1]
    key = f"{name}_{axis}"
    xs = [torch.from_numpy(r[f"{key}_x"]).requires_grad_() for r in got]
    total = 0.0
    for group in _groups(axis):
        if name == "gather_dim":
            ys = [torch.cat([xs[r] for r in group], dim=1)] * len(group)
        else:
            ys = list(torch.chunk(sum(xs[r] for r in group), len(group),
                                  dim=1))
        for r, y in zip(group, ys):
            np.testing.assert_allclose(got[r][f"{key}_y"],
                                       y.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
            total = total + (y * torch.from_numpy(got[r][f"{key}_w"])).sum()
    want = torch.autograd.grad(total, xs)
    for r in range(4):
        np.testing.assert_allclose(got[r][f"{key}_dx"], want[r].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_sequence_collectives_sum_bf16_in_fp32(ranks):
    got = ranks[1]
    c = [torch.tensor(v, dtype=torch.bfloat16) for v in BF16_COTANGENTS]
    assert float((c[0] + c[1]) + (c[2] + c[3])) == 1.0
    for r in got:
        assert r["psum_scatter_bf16"][0] == "torch.bfloat16"
        np.testing.assert_array_equal(r["psum_scatter_bf16_y"],
                                      np.full((1, 1, 2), 1.0 + 2.0 ** -7))
        np.testing.assert_array_equal(r["gather_dim_bf16_dx"],
                                      np.full((1, 1, 2), 1.0 + 2.0 ** -7))


class _At:
    """The (2, 2) mesh as ``local_block`` sees it from rank ``r``."""
    shape = SHAPE

    def __init__(self, r):
        self.coords = {"data": r // 2, "model": r % 2}


def _block(t, spec, r):
    at = _At(r)
    return SH.local_block(t, SH.P(*spec), at, at.coords)


@pytest.mark.parametrize("case", RESHARD_CASES, ids=[c[0] for c in
                                                     RESHARD_CASES])
def test_reshard_backward_is_autograd_of_the_sum_over_ranks(ranks, case):
    name, shape, src, dst = case
    got = ranks[1]
    whole = torch.from_numpy(got[0][f"rs_{name}_whole"]).requires_grad_()
    total = 0.0
    for r in range(4):
        y = _block(whole, dst, r)
        np.testing.assert_array_equal(got[r][f"rs_{name}_y"],
                                      y.detach().numpy())
        total = total + (y * torch.from_numpy(got[r][f"rs_{name}_w"])).sum()
    (want,) = torch.autograd.grad(total, [whole])
    held = {}
    for r in range(4):              # ranks that hold the same stored block
        key = _block(torch.arange(whole.numel()).view(shape), src, r)
        held.setdefault(tuple(key.flatten().tolist()), []).append(r)
    assert len(held) == math.prod(2 for part in src if part is not None)
    for rs in held.values():
        dx = sum(torch.from_numpy(got[r][f"rs_{name}_dx"]) for r in rs)
        np.testing.assert_allclose(dx.numpy(), _block(want, src,
                                                      rs[0]).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_reshard_backward_sums_bf16_in_fp32(ranks):
    got = ranks[1]
    c = [torch.tensor(v, dtype=torch.bfloat16) for v in BF16_COTANGENTS]
    in_bf16 = float((c[0] + c[1]) + (c[2] + c[3]))
    assert in_bf16 == 1.0
    assert float(got[0]["rs_bf16_dx"][0, 0]) == 1.0 + 2.0 ** -7


def test_remat_keeps_no_whole_split_leaf_for_the_backward(ranks):
    got = ranks[1]
    for r in got:
        split = set(r["remat_split_shapes"].tolist())
        assert "(8, 128, 64)" in split and "(512, 128)" in split
        on = set(r["remat1_kept"].tolist())
        off = set(r["remat0_kept"].tolist())
        assert not split & on, split & on
        assert split & off                       # the probe sees them
        assert r["remat1_loss"] == r["remat0_loss"]
        n = sum(1 for k in r if k.startswith("remat1_g"))
        assert n == sum(1 for k in r if k.startswith("remat0_g")) > 10
        for j in range(n):
            np.testing.assert_allclose(r[f"remat1_g{j}"], r[f"remat0_g{j}"],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["ep", "ep_resident"])
def test_the_mesh_global_norm_counts_each_block_once(ranks, impl):
    cfg = dataclasses.replace(get_arch(UNIT_MOE).reduced(), moe_impl=impl)
    whole = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = adamw.global_norm(whole).item()
    for r in ranks[1]:
        np.testing.assert_allclose(float(r[f"norm_{impl}"]), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("tag,arch,world", [("moe", UNIT_MOE, 4),
                                            ("mamba", "mamba2-370m", 2)])
def test_a_mesh_run_resumes_identically_and_is_one_process(
        ranks, tmp_path, tag, arch, world):
    out, got = ranks
    straight = got[0][f"{tag}_straight"]
    for r in got[:world]:
        np.testing.assert_array_equal(r[f"{tag}_straight"], straight)
        np.testing.assert_array_equal(r[f"{tag}_resumed"], straight)
    assert np.isfinite(straight).all() and straight[-1] < straight[0]
    one = TR.train(arch, ckpt_dir=str(tmp_path / "one"), **UNIT_TRAIN)
    np.testing.assert_allclose(straight, one, rtol=1e-5)
    # the mesh's step-2 checkpoint, restored in one process, continues
    shutil.copytree(out / f"{tag}_b" / "step_00000002",
                    tmp_path / "half" / "step_00000002")
    cont = TR.train(arch, ckpt_dir=str(tmp_path / "half"), resume=True,
                    **UNIT_TRAIN)
    np.testing.assert_allclose(cont, straight[2:], rtol=1e-5)
    cfg = get_arch(arch).reduced()
    tmpl = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    (p, o), step, _ = ckpt.restore(str(out / f"{tag}_a"),
                                   (tmpl, adamw.init(tmpl)), device="cpu")
    assert step == 4 and int(o.step) == 4
    for a, b in zip(T.tree_leaves(p), T.tree_leaves(tmpl)):
        assert a.shape == b.shape and torch.isfinite(a).all()
