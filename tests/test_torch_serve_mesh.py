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
channels, its block of the vocabulary, in prefill and decode alike).
The families whose decode mixers compute on TP's blocks against the
cache split along the sequence follow, over (1, 4) ``TP_RULES`` and (2, 2)
``TRAIN_RULES``: the reduced minicpm3-4b (MLA: the latent cache split,
the absorbed step on a rank's heads), Mamba-2 370M (the SSD state's 8
heads split), Whisper-medium (the 16 encoder frames of ``xk``/``xv``
split, its frames a seeded draw) and RecurrentGemma-2B with a 96-token
prompt past its 64-token window (the ring split, 16 slots a rank at
(1, 4)).  Then ``DECODE_RULES`` over (2, 2), which serves with the
weights 2-D resident (no leaf gathered a token), the residual stream
split over ``data`` along ``d_model`` and every ``data`` rank holding the
whole token batch (``serve_rank`` takes ``batch_spec`` under the rules:
whole, as the batch splits over ``pod`` alone) against its block of the
cache, split over ``data`` by batch and over ``model`` by sequence:
qwen3-8b, minicpm3-4b, minicpm3-4b with 3 heads (the resident ``wk_b``
and ``wv_b`` blocks cutting a head in two over ``model``: the absorbed
step's partial heads summed), Mamba-2 370M, Whisper-medium,
RecurrentGemma-2B on the 96-token ring prompt (its one kv head gathered
whole over ``model``), qwen2-vl (``patch_proj`` resident) and qwen3-moe
(``ep``: every rank routes the whole batch, at the config's capacity
factor).  Then ``SEQPAR_RULES``, whose prefill keeps the residual stream
split over ``model`` along the sequence between blocks (the cache's
leaves from the gathered rows, the last logits from the rank that holds
the last row): qwen3-8b, minicpm3-4b (MLA's latents computed whole) and
Mamba-2 (the SSD block whole) over (1, 4) and (2, 2); RecurrentGemma-2B
on the 96-token ring prompt, Whisper-medium (the encoder whole) and
qwen3-moe (``ep``, at the config's capacity factor: every rank routes
the whole batch's gathered tokens) and qwen2-vl (its patch rows spliced
into the ranks that hold them) over (1, 4); and qwen3-8b at a
30-token prompt, which 4 ranks do not divide, so the stream stays
whole.  Every rank must return the one-process greedy tokens, and the
prefill step's last-position logits, gathered over the batch's blocks,
must be within 1e-5 (fp32; the sums run in another order); each rank's
cache after the prefill, and after the decode steps fed the served
tokens, must be its block (``sharding.local_block`` under
``sharding.cache_specs``) of the one-process cache within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as SV
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves
from torch_mesh_ranks import serve_inputs, serve_rank

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
MESHES = [((1, 4), {}), ((2, 2), {"moe_impl": "ep_resident"}),
          ((2, 2), {"moe_capacity_factor": 16.0})]
SERVE = {"batch": 4, "prompt": 32, "gen": 8, "seed": 0, "smoke": False}
RING = dict(SERVE, prompt=96, gen=6)
SPLIT = ["minicpm3-4b", "mamba2-370m", "whisper-medium"]
CASES = [(arch, shape, over, SERVE, "TRAIN_RULES") for arch in ARCHS
         for shape, over in MESHES] + [
    (ARCHS[0], (2, 2), {"moe_impl": "ep_resident"}, SERVE, "TP_RULES"),
    ("qwen3-8b", (1, 4), {}, SERVE, "TP_RULES")] + [
    (arch, shape, {}, kw, rules)
    for arch, kw in [(a, SERVE) for a in SPLIT] + [("recurrentgemma-2b",
                                                      RING)]
    for shape, rules in (((1, 4), "TP_RULES"), ((2, 2), "TRAIN_RULES"))] + [
    (arch, (2, 2), over, kw, "DECODE_RULES") for arch, over, kw in [
        ("qwen3-8b", {}, SERVE), ("minicpm3-4b", {}, SERVE),
        ("minicpm3-4b", {"num_heads": 3, "num_kv_heads": 3}, SERVE),
        ("mamba2-370m", {}, SERVE), ("whisper-medium", {}, SERVE),
        ("recurrentgemma-2b", {}, RING), ("qwen2-vl-72b", {}, SERVE),
        (ARCHS[0], {}, SERVE)]] + [
    (arch, shape, {}, kw, "SEQPAR_RULES") for arch, kw, shapes in [
        ("qwen3-8b", SERVE, ((1, 4), (2, 2))),
        ("minicpm3-4b", SERVE, ((1, 4), (2, 2))),
        ("mamba2-370m", SERVE, ((1, 4), (2, 2))),
        ("recurrentgemma-2b", RING, ((1, 4),)),
        ("whisper-medium", SERVE, ((1, 4),)), (ARCHS[0], SERVE, ((1, 4),)),
        ("qwen2-vl-72b", SERVE, ((1, 4),)),
        ("qwen3-8b", dict(SERVE, prompt=30), ((1, 4),))]
    for shape in shapes]
IDS = [(f"{a.split('-')[0]}-{s[0]}x{s[1]}-{'-'.join(o) or 'ep'}"
        if get_arch(a).num_experts else
        f"{a}-{s[0]}x{s[1]}" + "".join(f"-{k}" for k in o))
       + ("" if r == "TRAIN_RULES" else f"-{r}")
       + ("" if kw["prompt"] in (SERVE["prompt"], RING["prompt"]) else
          f"-prompt{kw['prompt']}") for a, s, o, kw, r in CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    M.run_ranks(serve_rank, 4, CASES, str(out), timeout_s=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _one_process(arch, over, kw):
    """The one-process serve's tokens, and its prefill's last logits and
    cache, then the cache grown and the last logits and cache after the
    decode steps fed those tokens (the rank's inputs)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    real = SV.get_arch
    SV.get_arch = lambda name: cfg
    try:
        gen = SV.serve(arch, device="cpu", **kw)["generated"]
    finally:
        SV.get_arch = real
    params = T.init_params(cfg, torch.Generator().manual_seed(kw["seed"]),
                           device="cpu")
    tok, frames = serve_inputs(cfg, kw)
    B, S, G = kw["batch"], kw["prompt"], kw["gen"]
    with torch.no_grad():
        logits, cache = DE.prefill(cfg, params, tok, encoder_frames=frames)
        pre = [t.clone() for t in tree_leaves(cache)]
        cache = SV._grow_cache(cfg, cache, B, S + G)
        feed = torch.from_numpy(gen)
        for t in range(G - 1):
            last, cache = DE.decode_step(cfg, params, cache,
                                         feed[:, t:t + 1])
    return cfg, gen, logits.numpy(), pre, last.numpy(), tree_leaves(cache)


def _held(got, cache, specs, shape, coords, what):
    """Each of a rank's cache leaves ``got`` its block of the one-process
    ``cache`` under ``specs``."""
    mesh = type("Fake", (), {"shape": {"data": shape[0],
                                       "model": shape[1]}})()
    at = {"data": int(coords[0]), "model": int(coords[1])}
    for j, (t, sp) in enumerate(zip(cache, tree_leaves(specs,
                                                        is_leaf=SH.is_spec))):
        want = SH.local_block(t, sp, mesh, at).numpy()
        assert got[j].shape == want.shape, (what, j, sp)
        np.testing.assert_allclose(got[j], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} leaf {j} {sp}")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_serve_over_a_mesh_is_the_one_process_serve(ranks, i):
    arch, shape, over, kw, rname = CASES[i]
    cfg, gen, logits, pre, last, post = _one_process(arch, over, kw)
    assert gen.shape == (kw["batch"], kw["gen"])
    B, S, G = kw["batch"], kw["prompt"], kw["gen"]
    rules = getattr(SH, rname)
    mesh = type("Fake", (), {"shape": {"data": shape[0],
                                       "model": shape[1]}})()
    pre_specs = SH.cache_specs(cfg, mesh, B, S, rules)
    post_specs = SH.cache_specs(cfg, mesh, B, S + G, rules)
    n = len(pre)
    for r in ranks:
        np.testing.assert_array_equal(r[f"{i}_generated"], gen)
        np.testing.assert_allclose(r[f"{i}_logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"{i}_decode_logits"], last, rtol=1e-5,
                                   atol=1e-5)
        _held([r[f"{i}_prefill_c{j}"] for j in range(n)], pre, pre_specs,
              shape, r[f"{i}_coords"], "prefill")
        _held([r[f"{i}_decode_c{j}"] for j in range(n)], post, post_specs,
              shape, r[f"{i}_coords"], "decode")
