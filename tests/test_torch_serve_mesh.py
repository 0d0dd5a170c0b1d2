"""``serve`` over meshes of ranks against the one-process ``serve``, on the
CPU.

The reduced qwen3-moe (8 experts, top-2, qk-norm) and Llama 4 Maverick (8
experts, top-1), fp32, served by 4 gloo ranks (``launch.mesh.run_ranks``,
one group for the module) over a (1, 4) mesh (``moe_ffn_ep``: each rank 2
experts, the whole batch), a (2, 2) mesh with ``moe_impl="ep_resident"``
(each rank half of 4 experts' width, a data block of 2 prompts) and a
(2, 2) mesh with ``moe_ffn_ep``.  The first two route and cap over the
whole batch at the config's capacity factor (1.25), as one process does;
the third caps each data block on its own, so it is served at capacity
factor 16, where nothing drops, and held to one process at the same.
Each rank holds its ``TRAIN_RULES`` block of every weight and the steps
gather each layer as they take it; one more case serves the reduced
qwen3-moe over (2, 2) ``ep_resident`` under ``TP_RULES`` (no FSDP: the
experts stored whole in width, cut over data to compute), and one the
reduced qwen3-8b over (1, 4) under ``TP_RULES``, where every stored block
is the block a rank computes with (TP's compute split: its heads and
channels, its block of the vocabulary; decode keeps attention whole and
gathers it).  Every rank
must return the one-process greedy tokens, and the prefill step's
last-position logits, gathered over the batch's blocks, must be within
1e-5 (fp32; the sums run in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import RequestStream
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as SV
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T
from torch_mesh_ranks import serve_rank

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
MESHES = [((1, 4), {}), ((2, 2), {"moe_impl": "ep_resident"}),
          ((2, 2), {"moe_capacity_factor": 16.0})]
SERVE = {"batch": 4, "prompt": 32, "gen": 8, "seed": 0, "smoke": False}
CASES = [(arch, shape, over, SERVE, "TRAIN_RULES") for arch in ARCHS
         for shape, over in MESHES] + [
    (ARCHS[0], (2, 2), {"moe_impl": "ep_resident"}, SERVE, "TP_RULES"),
    ("qwen3-8b", (1, 4), {}, SERVE, "TP_RULES")]
IDS = [(f"{a.split('-')[0]}-{s[0]}x{s[1]}-{'-'.join(o) or 'ep'}"
        if get_arch(a).num_experts else f"{a}-{s[0]}x{s[1]}")
       + ("" if r == "TRAIN_RULES" else f"-{r}") for a, s, o, _, r in CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    M.run_ranks(serve_rank, 4, CASES, str(out), timeout_s=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _one_process(arch, over):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    real = SV.get_arch
    SV.get_arch = lambda name: cfg
    try:
        gen = SV.serve(arch, device="cpu", **SERVE)["generated"]
    finally:
        SV.get_arch = real
    params = T.init_params(cfg, torch.Generator().manual_seed(SERVE["seed"]),
                           device="cpu")
    tok = torch.from_numpy(RequestStream(cfg, SERVE["batch"], SERVE["prompt"],
                                         SERVE["seed"]).requests_at(0)
                           ["tokens"])
    logits, _ = DE.prefill(cfg, params, tok)
    return gen, logits.numpy()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_serve_over_a_mesh_is_the_one_process_serve(ranks, i):
    arch, shape, over, _, _ = CASES[i]
    gen, logits = _one_process(arch, over)
    assert gen.shape == (SERVE["batch"], SERVE["gen"])
    for r in ranks:
        np.testing.assert_array_equal(r[f"{i}_generated"], gen)
        np.testing.assert_allclose(r[f"{i}_logits"], logits, rtol=1e-5,
                                   atol=1e-5)
