"""TP's compute split over meshes of ranks against the JAX package on one
device, on the CPU.

A rank along ``model`` computes with the block of each TP leaf it stores,
less its FSDP split: attention's and MLA's heads, the MLP's and the
RG-LRU's channels (column-parallel in, row-parallel out, summed over
``model``), the embedding, head and loss over its block of the vocabulary.
Five reduced models, fp32, each on 4 gloo ranks (``launch.mesh.run_ranks``,
one spawn for the module; ``torch_mesh_ranks.tp_rank``) over (1, 4) and
(2, 2) meshes under ``TRAIN_RULES`` and ``TP_RULES``: qwen3-8b (GQA,
qk-norm and QKV bias drawn nonzero), minicpm3-4b (MLA, tied head, a
vocabulary of 500 padded to 512 so the last block masks columns),
recurrentgemma-2b (RG-LRU, one kv head computed whole on every rank, a
window of 16 under a 32-token batch), whisper-medium (the encoder and
cross-attention, fed ``TokenStream``'s frames) and qwen3-moe-235b-a22b
(the split attention beside the expert-parallel FFN, at capacity factor
16, where nothing drops, so a data block caps as the whole batch does).
The parameters are the JAX package's ``init_params`` carried across
(``params_from_jax``), each rank placing its blocks.  Each case holds the
training step's global loss, every rank's reduced gradient block of every
leaf (``make_grad_fn``) and the forward's logits, gathered over the
vocabulary and the batch, to ``jax.value_and_grad`` of the JAX package's
``loss_fn`` and its ``forward`` on one device over the global batch:
1e-5 relative on the loss and, in Frobenius norm, on each leaf and the
logits (fp32 on both sides; only the order of the sums differs).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import TokenStream as JTokenStream
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.paper_suite import PAPER_LM_SUITE
from repro_torch.distributed import moe_ep
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from test_torch_dense import perturb
from torch_mesh_ranks import tp_rank

B, S = 4, 32
OVER = {"qwen3-8b": {},
        "minicpm3-4b": {"vocab_size": 500},
        "recurrentgemma-2b": {"sliding_window": 16},
        "whisper-medium": {},
        "qwen3-moe-235b-a22b": {"moe_capacity_factor": 16.0}}
MESHES = [(1, 4), (2, 2)]
RULES = ["TRAIN_RULES", "TP_RULES"]
CASES = [(arch, over, shape, rname) for arch, over in OVER.items()
         for shape in MESHES for rname in RULES]
IDS = [f"{a}-{s[0]}x{s[1]}-{r}" for a, _, s, r in CASES]
BAR = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's loss, gradient leaves and logits by arch; the ranks'
    results)."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs, jx = {}, {}
    for arch, over in OVER.items():
        jcfg = dataclasses.replace(jget_arch(arch).reduced(), **over)
        jparams = perturb(JT.init_params(jcfg, jax.random.PRNGKey(0)))
        batch = JTokenStream(jcfg, B, S, 3).batch_at(0)
        inputs.update({f"{arch}_{j}": np.asarray(x) for j, x in
                       enumerate(jax.tree.leaves(jparams))})
        inputs.update({f"{arch}_{k}": np.asarray(v)
                       for k, v in batch.items()})
        mesh = make_local_mesh()
        shard = JSH.make_act_sharder(mesh, JSH.TRAIN_RULES)
        with mesh:
            loss, grads = jax.value_and_grad(JST.loss_fn, argnums=1)(
                jcfg, jparams, batch, shard)
            logits = JT.forward(jcfg, jparams, batch["tokens"],
                                frontend_embeds=batch.get("frontend_embeds"),
                                encoder_frames=batch.get("encoder_frames"),
                                shard=shard)
        jx[arch] = (float(loss), [np.asarray(g) for g in
                                  jax.tree.leaves(grads)],
                    np.asarray(logits))
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "ranks").mkdir()
    M.run_ranks(tp_rank, 4, str(tmp / "inputs.npz"),
                [(a, o, s, r) for a, o, s, r in CASES], str(tmp / "ranks"),
                timeout_s=300)
    return jx, [dict(np.load(tmp / "ranks" / f"rank{r}.npz"))
                for r in range(4)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_split_compute_matches_jax_on_one_device(runs, i):
    jx, ranks = runs
    arch, over, shape, rname = CASES[i]
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    jloss, jgrads, jlogits = jx[arch]
    fake = type("Fake", (), {"shape": {"data": shape[0], "model": shape[1]}})
    specs = T.tree_leaves(T.param_block_specs(cfg, fake, getattr(SH, rname)),
                          is_leaf=SH.is_spec)
    assert len(specs) == len(jgrads)
    V = cfg.vocab_size
    for r, got in enumerate(ranks):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        np.testing.assert_allclose(got[f"{i}_loss"], jloss, rtol=BAR)
        assert _rel(got[f"{i}_logits"][..., :V], jlogits[..., :V]) <= BAR
        for j, (spec, jg) in enumerate(zip(specs, jgrads)):
            want = SH.local_block(torch.from_numpy(np.array(jg)), spec,
                                  fake, coords).numpy()
            g = got[f"{i}_g{j}"]
            assert g.shape == want.shape, (r, j)
            assert _rel(g, want) <= BAR, (r, j, _rel(g, want))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for k, v in enumerate(tree):
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _want(cfg, path, pd, mesh, layout):
    """The compute spec the split asks of a leaf: its ``TP_RULES`` storage
    spec, or whole for the SSD block, MLA's latent projections,
    ``patch_proj`` and an attention block whose heads (or, for K/V, kv
    heads) do not divide over ``model``; experts in the MoE layout."""
    if "expert" in pd.axes:
        return SH.compute_spec(pd.axes, layout)
    name, parent = path[-1], path[-2] if len(path) > 1 else None
    m = SH.mesh_shape(mesh)["model"]
    if parent == "ssd" or name in ("wq_a", "wkv_a", "patch_proj"):
        return SH.P()
    kv = cfg.num_kv_heads
    if parent in ("attn", "xattn") and (cfg.num_heads % m or (
            kv % m and m % kv) or (
            name in ("wk", "wv", "bk", "bv") and kv % m)):
        return SH.P()
    return SH.spec_for(pd.shape, pd.axes, SH.TP_RULES, mesh)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 8), (16, 16)])
@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(PAPER_LM_SUITE))
def test_compute_specs_follow_tp_rules_and_heads(arch, shape):
    """For every arch, each leaf's compute spec under either rule set is
    its ``TP_RULES`` storage spec, or whole for the named exceptions and
    the head counts that do not divide (GPT-2's 25 heads, RecurrentGemma's
    10 at 4 and 16, qwen3-8b's 8 kv heads at 16); prefill and decode take
    the same placement."""
    cfg = ARCHS[arch] if arch in ARCHS else PAPER_LM_SUITE[arch]
    mesh = type("Fake", (), {"shape": {"data": shape[0],
                                       "model": shape[1]}})()
    layout = moe_ep.moe_layout(cfg, mesh, ("data",))
    defs = T.param_defs(cfg)
    cdefs = dict(_walk(T.compute_defs(cfg, mesh, SH.TP_RULES)))
    for rules in (SH.TRAIN_RULES, SH.TP_RULES):
        for path, pd in _walk(defs):
            got = SH.leaf_specs(pd.shape, pd.axes, rules, mesh, layout,
                                cdefs[path].axes).compute
            assert got == _want(cfg, path, pd, mesh, layout), (path, got)


def test_heads_that_do_not_divide_stay_whole():
    mesh = type("Fake", (), {"shape": {"data": 1, "model": 4}})()
    for arch, leaf in (("gpt2-1.5b", "wq"), ("recurrentgemma-2b", "wo")):
        cfg = ARCHS[arch] if arch in ARCHS else PAPER_LM_SUITE[arch]
        cd = T.compute_defs(cfg, mesh, SH.TP_RULES)
        key = next(k for k in cd["blocks"] if k.endswith("attn"))
        assert "tp" not in cd["blocks"][key]["attn"][leaf].axes
    cd = T.compute_defs(get_arch("qwen3-8b"), type("Fake", (), {"shape": {
        "data": 1, "model": 16}})(), SH.TP_RULES)["blocks"]["b0_attn"]
    assert "tp" in cd["attn"]["wq"].axes and "tp" in cd["attn"]["wo"].axes
    assert "tp" not in cd["attn"]["wk"].axes
    assert "tp" in cd["ffn"]["w1"].axes


def test_tp_rules_on_a_dense_model_move_no_leaf():
    """Under ``TP_RULES`` over (1, 4) the reduced qwen3-8b's stored
    blocks are its compute blocks: no placement, nothing resharded."""
    mesh = type("Fake", (), {"shape": {"data": 1, "model": 4}})()
    cfg = get_arch("qwen3-8b").reduced()
    assert T.placement(cfg, SH.ActSharder(mesh, (), SH.TP_RULES)) is None
    assert T.placement(cfg, SH.ActSharder(mesh, (), SH.TRAIN_RULES)) is None
    # decode computes on the same blocks: its cache splits the sequence
    # over model, not the heads
    spec = SH.cache_specs(cfg, mesh, 4, 64, SH.TP_RULES)["blocks"]["b0_attn"]
    assert spec["k"] == spec["v"] == SH.P(None, "data", "model")
