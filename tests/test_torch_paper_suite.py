"""The paper's own Table I LMs (``configs/paper_suite.py``) on the port,
against the JAX package, on the CPU.

BERT-base (Question answering) and GPT-2 1.5B (Document translation) are
dense MHA decoders at head dim 64 with learned positions, gelu and tied
embeddings, as the JAX package defines them (gated MLP, RMSNorm, causal).
Their reduced configs (2 layers, d_model 128, 4 heads of 32, d_ff 256,
vocab 512, fp32) take parameters from the JAX package's ``init_params``
through ``params_from_jax``; the same tokens go through both packages'
``forward``, ``prefill`` and ``decode_step``.  ViT-632M, through the
``vision_patches`` frontend, is held to the JAX package in
``tests/test_torch_vlm.py``, its training at head dim 80 in
``tests/test_torch_train_mla.py``.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_suite import PAPER_LM_SUITE as JSUITE
from repro.models import decode as JDE
from repro.models import transformer as JT
from repro_torch.configs.paper_suite import PAPER_LM_SUITE as SUITE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve as S
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
LMS = ["bert-base", "gpt2-1.5b"]
FULL_PARAMS = {"bert-base": 137_251_584, "gpt2-1.5b": 2_048_564_800}
RTOL, ATOL = 1e-4, 1e-5        # port vs JAX, fp32 on one CPU


@pytest.fixture(scope="module", params=LMS)
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    jcfg = JSUITE[request.param].reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return SUITE[request.param].reduced(), jcfg, jparams, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _walk(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


# ---- the copy and the configs -----------------------------------------------

def test_paper_suite_copy_matches_original():
    orig = (ROOT / "src/repro/configs/paper_suite.py").read_text()
    got = (ROOT / "src/repro_torch/configs/paper_suite.py").read_text()
    assert got == re.sub(r"\brepro\.", "repro_torch.", orig)


@pytest.mark.parametrize("name", sorted(JSUITE))
def test_paper_suite_configs_behave_as_in_jax(name):
    cfg, jcfg = SUITE[name], JSUITE[name]
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert (c.padded_vocab, c.resolved_head_dim) == \
            (jc.padded_vocab, jc.resolved_head_dim)


@pytest.mark.parametrize("name", LMS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_tree_dtypes_and_count_match_jax(name, full):
    cfg, jcfg = SUITE[name], JSUITE[name]
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert T.count_params(cfg) == JT.count_params(jcfg)
    if full:
        assert T.count_params(cfg) == FULL_PARAMS[name]
        assert (cfg.resolved_head_dim, cfg.num_kv_heads, cfg.rope,
                cfg.act) == (64, cfg.num_heads, "learned", "gelu")
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = _walk(shapes, path)
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)
    assert "pos_embed" in shapes and "lm_head" not in shapes


def test_vit_632m_raises_naming_its_slice():
    """ViT-632M builds; its attention's gradient at full width (head dim
    80), once refused naming its slice, now runs through
    ``FlashAttention`` (K5b's (80, 80) on the card) and matches autograd
    through the plain forward; tests/test_torch_train_mla.py trains the
    ViT at head dim 80 against JAX."""
    for cfg in (SUITE["vit-632m"], SUITE["vit-632m"].reduced()):
        assert "patch_proj" in T.param_defs(cfg)
    D = SUITE["vit-632m"].resolved_head_dim
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, D))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = ops.attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    want = torch.autograd.grad(
        flash_attention_plain(q, k, v).square().sum(), (q, k, v))
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-4, atol=1e-5)


# ---- the models against the JAX package -------------------------------------

def test_forward_matches_jax(model):
    """S = 40 runs past the reduced attn_chunk of 32."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 40)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == (2, 40, cfg.padded_vocab) == want.shape
    _close(got, want)


@pytest.mark.parametrize("S", [24, 40])
def test_prefill_logits_and_cache_match_jax(model, S):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, S, seed=S)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    jl, jc = jax.jit(lambda p, t: JDE.prefill(jcfg, p, t))(jparams, tok)
    _close(logits, jl)
    assert int(cache["pos"]) == int(jc["pos"]) == S
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    for path, want in flat:
        got = _walk(cache, path)
        assert tuple(got.shape) == want.shape, path
        _close(got, want)
    assert len(T.tree_leaves(cache)) == len(flat)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 3 greedy decode steps in both packages (each at its
    learned position): the same logits and tokens."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 24
    tok = _tokens(cfg, B, S, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    cache = _grow_cache(cfg, cache, B, S + 3)
    jl, jc = JDE.prefill(jcfg, jparams, tok)
    tmpl = JDE.cache_shapes(jcfg, B, S + 3)
    jc = jax.tree.map(lambda s, c: jnp.zeros(s.shape, s.dtype).at[
        tuple(slice(0, n) for n in c.shape)].set(c), tmpl, jc)
    jstep = jax.jit(lambda p, c, t: JDE.decode_step(jcfg, p, c, t))
    for step in range(3):
        _close(logits, jl)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        jnxt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        logits, cache = DE.decode_step(cfg, params, cache, nxt)
        jl, jc = jstep(jparams, jc, jnxt)
        assert int(cache["pos"]) == int(jc["pos"]) == S + step + 1
    _close(logits, jl)


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31),
    and the prefill's last logits forward's (rtol 1e-5)."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    pl, cache = DE.prefill(cfg, params, tok[:, :S])
    torch.testing.assert_close(pl[:, 0], full[:, S - 1], rtol=1e-5,
                               atol=1e-5)
    cache = _grow_cache(cfg, cache, B, S + 1)
    dl, _ = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


def test_serve_generates_on_the_cpu(monkeypatch):
    """``serve`` of a suite LM (the registry, like the JAX package's, holds
    only the assigned architectures, so ``get_arch`` is pointed at the
    suite): the greedy continuation under forward."""
    cfg = SUITE["gpt2-1.5b"].reduced()
    monkeypatch.setattr(S, "get_arch", lambda name: SUITE[name])
    out = S.serve("gpt2-1.5b", smoke=True, batch=2, prompt=20, gen=3,
                  seed=4, device="cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    tok = torch.from_numpy(S.RequestStream(cfg, 2, 20, 4).requests_at(0)
                           ["tokens"])
    for t in range(3):
        nxt = torch.argmax(T.forward(cfg, params, tok)[:, -1], dim=-1)
        assert np.array_equal(nxt.numpy(), out["generated"][:, t])
        tok = torch.cat([tok, nxt[:, None].to(tok.dtype)], dim=1)
