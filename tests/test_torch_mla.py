"""The port's MLA (multi-head latent attention, minicpm3-4b) against the JAX
package, on the CPU.

``get_arch("minicpm3-4b").reduced()`` (2 layers, d_model 128, 4 heads,
q_lora_rank 32, kv_lora_rank 16, nope 24 + rope 8 = 32 q/k dims, vocab 512,
fp32) with ``v_head_dim`` 16 in both packages: the reduced config's v 32
equals q/k's 32 and would hide a fault in K5's value head dim (at full
width q/k 96 against v 64).  Parameters come from the JAX package's
``init_params`` and cross over by ``params_from_jax``; the same tokens go
through both packages' ``forward``, ``prefill`` (the ``lat``/``kr``
cache) and ``decode_step`` (the absorbed form).  Both sides are fp32 on one
CPU and differ only in the order of fp32 sums, so the tolerances are those
of ``tests/test_torch_dense.py``; decode == forward is held to
``tests/test_models.py::test_decode_matches_forward``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import decode as JDE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import decode as DE
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_unflatten

ARCH = "minicpm3-4b"
V_HEAD_DIM = 16                 # against q/k's 24 + 8
RTOL, ATOL = 1e-4, 1e-5         # port vs JAX, fp32 on one CPU
MLA_LEAVES = {"ln", "wq_a", "q_ln", "wq_b", "wkv_a", "kv_ln", "wk_b", "wv_b",
              "wo"}


def _reduced(get):
    return dataclasses.replace(get(ARCH).reduced(), v_head_dim=V_HEAD_DIM)


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    jcfg = _reduced(jget_arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return _reduced(get_arch), jcfg, jparams, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _walk(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _jgrow(jcfg, cache, B, cap):
    """The JAX package's serve._grow_cache (its module needs a mesh)."""
    tmpl = JDE.cache_shapes(jcfg, B, cap)
    new = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tmpl)
    new = jax.tree.map(lambda d, s: s if d.shape == s.shape else
                       d.at[tuple(slice(0, n) for n in s.shape)].set(s),
                       new, cache)
    new["pos"] = cache["pos"]
    return new


# ---- K5's plain version at Dqk != Dv ----------------------------------------

@pytest.mark.parametrize("S", [24, 40])
def test_attention_with_its_own_value_dim_matches_jax(S):
    """K5's plain version and the port's ``blocked_attention`` at MLA's
    reduced shape (4 heads, GQA 1, q/k 32, v 16, causal) against JAX's
    ``layers.blocked_attention``; S = 40 runs past JAX's 32-row chunk."""
    rng = np.random.default_rng(S)
    q, k = (rng.standard_normal((2, S, 4, 32), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, S, 4, V_HEAD_DIM), dtype=np.float32)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, chunk=32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = L.blocked_attention(tq, tk, tv, causal=True, chunk=32)
    assert got.shape == (2, S, 4, V_HEAD_DIM) == want.shape
    _close(got, want)
    plain = flash_attention_plain(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                                  causal=True)
    _close(plain.transpose(1, 2), want)


def test_k5_refuses_what_it_was_not_built_for():
    """The card's wrapper takes (Dqk, Dv) pairs it was built for and checks
    them before the device; K5b (and ``FlashAttention``, on the CPU too)
    takes the same pairs, (32, 16) among them, and refuses any other by
    name, (32, 24) here."""
    q, k = torch.ones((1, 2, 8, 32)), torch.ones((1, 2, 8, 32))
    with pytest.raises(ValueError, match=r"head dims \(q/k 32, v 24\)"):
        flash_attention(q, k, torch.ones((1, 2, 8, 24)))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k, torch.ones((1, 2, 7, 16)))
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        flash_attention(q, k, torch.ones((1, 2, 8, 16)))
    v = torch.ones((1, 2, 8, 16))
    out = FlashAttention.apply(q.requires_grad_(), k, v, True, 0)
    assert out.shape == (1, 2, 8, 16)
    assert torch.autograd.grad(out.sum(), q)[0].shape == q.shape
    bad = torch.ones((1, 2, 8, 24))
    with pytest.raises(ValueError, match=r"FlashAttention: head dims "
                                         r"\(q/k 32, v 24\): K5b is built"):
        FlashAttention.apply(q, k, bad, True, 0)
    with pytest.raises(ValueError, match=r"\(q/k 32, v 24\): K5b is built"):
        ops.attention(q, k, bad)


# ---- the model against the JAX package --------------------------------------

def test_param_tree_and_full_width_count_match_jax(model):
    cfg, jcfg, jparams, params = model
    attn = params["blocks"]["b0_attn"]["attn"]
    assert set(attn) == MLA_LEAVES
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for path, want in flat:                     # params_from_jax, leaf for leaf
        np.testing.assert_array_equal(_walk(params, path).numpy(),
                                      np.asarray(want))
    assert len(T.tree_leaves(params)) == len(flat)
    full, jfull = get_arch(ARCH), jget_arch(ARCH)
    assert T.count_params(full) == JT.count_params(jfull)
    shapes = T.param_shapes(full)["blocks"]["b0_attn"]["attn"]
    assert (tuple(shapes["wq_b"].shape), tuple(shapes["wv_b"].shape)) == \
        ((62, 768, 40 * 96), (62, 256, 40 * 64))


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 40)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == (2, 40, cfg.padded_vocab) == want.shape
    _close(got, want)


@pytest.mark.parametrize("S", [24, 40])
def test_prefill_logits_and_latent_cache_match_jax(model, S):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, S, seed=S)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    jl, jc = jax.jit(lambda p, t: JDE.prefill(jcfg, p, t))(jparams, tok)
    _close(logits, jl)
    assert int(cache["pos"]) == int(jc["pos"]) == S
    assert set(cache["blocks"]["b0_attn"]) == {"lat", "kr"}
    assert tuple(cache["blocks"]["b0_attn"]["lat"].shape) == \
        (cfg.num_layers, 2, S, cfg.kv_lora_rank)
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    for path, want in flat:
        got = _walk(cache, path)
        assert tuple(got.shape) == want.shape, path
        _close(got, want)
    assert len(T.tree_leaves(cache)) == len(flat)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 3 greedy absorbed-MLA decode steps in both packages:
    the same logits, tokens and latent caches."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 24
    tok = _tokens(cfg, B, S, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    cache = _grow_cache(cfg, cache, B, S + 3)
    jl, jc = JDE.prefill(jcfg, jparams, tok)
    jc = _jgrow(jcfg, jc, B, S + 3)
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
    for name in ("lat", "kr"):
        _close(cache["blocks"]["b0_attn"][name], jc["blocks"]["b0_attn"][name])


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31),
    within tests/test_models.py::test_decode_matches_forward's rtol 2e-2,
    atol 2e-3 (the absorbed form sums in another order)."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    cache = _grow_cache(cfg, cache, B, S + 1)
    dl, cache = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert int(cache["pos"]) == S + 1
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)


def test_mla_training_raises_naming_its_item(model):
    """MLA's training, once refused by name, runs: under autograd the
    forward is the one served (the same logits), its attention goes
    through ``FlashAttention`` once a layer, and every leaf gets a finite
    gradient (tests/test_torch_train_mla.py holds them to JAX's)."""
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 1, 8))
    leaves = [p.detach().requires_grad_() for p in T.tree_leaves(params)]
    logits = T.forward(cfg, tree_unflatten(params, leaves), tok)
    nodes, todo = set(), [logits.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in nodes:
            nodes.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    assert sum(type(f).__name__ == "FlashAttentionBackward"
               for f in nodes) == cfg.num_layers
    grads = torch.autograd.grad(logits.square().mean(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():                       # serving is untouched
        torch.testing.assert_close(
            T.forward(cfg, tree_unflatten(params, leaves), tok), logits,
            rtol=0, atol=0)
