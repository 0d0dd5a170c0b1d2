"""The port's RecurrentGemma serving stack against the JAX package, on the CPU.

``get_arch("recurrentgemma-2b").reduced()`` (3 layers: rglru, rglru, attn;
d_model 128, 4 heads of 32 with one KV head, d_ff 256, sliding window 64,
vocab 512, fp32) and a 5-layer variant whose two pattern-remainder rglru
layers cover the ``rem`` list the full 26-layer model has: parameters from
the JAX package's ``init_params``, carried across by ``params_from_jax``,
then the same tokens through both packages' ``forward``, ``prefill`` and
``decode_step``.  Both sides are fp32 on one CPU and differ only in the
order of fp32 sums, so the tolerances are those of
``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import decode as JDE
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import RequestStream
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-2b"
RTOL, ATOL = 1e-4, 1e-5        # port vs JAX, fp32 on one CPU


def _cfgs(layers):
    cfg, jcfg = get_arch(ARCH).reduced(), jget_arch(ARCH).reduced()
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    return cfg, jcfg


@pytest.fixture(scope="module", params=[3, 5], ids=["3L", "5L"])
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    cfg, jcfg = _cfgs(request.param)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


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


# ---- parameters -------------------------------------------------------------

@pytest.mark.parametrize("layers", [3, 5, 26])
def test_param_tree_dtypes_and_count_match_jax(layers):
    if layers == 26:
        cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    else:
        cfg, jcfg = _cfgs(layers)
    assert T.count_params(cfg) == JT.count_params(jcfg)
    if layers == 26:
        assert T.count_params(cfg) == 2_894_528_000
        assert sum(t.numel() * t.element_size() for t in
                   T.tree_leaves(T.param_shapes(cfg))) == 5_789_148_160
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = _walk(shapes, path)
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)
    assert len(shapes["rem"]) == layers % 3
    # log_a keeps fp32 in a bf16 model, in param_shapes and init_params
    assert shapes["blocks"]["b0_rglru"]["rec"]["log_a"].dtype == torch.float32
    assert shapes["blocks"]["b2_attn"]["attn"]["wq"].dtype == getattr(
        torch, cfg.dtype)
    if layers == 5:
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        params = T.init_params(bf, torch.Generator().manual_seed(0),
                               device="cpu")
        assert jax.tree.map(lambda _: 0, params) == \
            jax.tree.map(lambda _: 0, jshapes)
        log_a = params["rem"][1]["rec"]["log_a"]
        assert log_a.dtype == torch.float32
        a = torch.exp(-8.0 * torch.nn.functional.softplus(log_a))
        assert ((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all()
        assert params["rem"][0]["ffn"]["w1"].dtype == torch.bfloat16


def test_embedding_scale_is_rounded_as_in_jax():
    """bf16: x * bf16(sqrt(2560)) = x * 50.5, not x * 50.596, bit for bit."""
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=3, vocab_size=512)
    jcfg = dataclasses.replace(jget_arch(ARCH), num_layers=3, vocab_size=512)
    emb = np.random.default_rng(0).standard_normal((512, 2560)) / 50
    jemb = jnp.asarray(emb, jnp.bfloat16)
    params = params_from_jax({"embed": np.asarray(jemb)}, device="cpu")
    tok = _tokens(cfg, 2, 9)
    got = T.embed_tokens(cfg, params, torch.from_numpy(tok))
    want = np.asarray(JT.embed_tokens(jcfg, {"embed": jemb}, tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert torch.equal(got, params["embed"][torch.from_numpy(tok)] * 50.5)
    assert not torch.equal(got, (params["embed"][torch.from_numpy(tok)].float()
                                 * 2560 ** 0.5).bfloat16())


# ---- the model against the JAX package --------------------------------------

def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 96)            # 3 query chunks, window 64 < S
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == (2, 96, cfg.padded_vocab) == want.shape
    _close(got, want)


@pytest.mark.parametrize("S", [40, 96])
def test_prefill_logits_and_cache_match_jax(model, S):
    """S = 40 fills a full K/V cache, S = 96 > window 64 a ring with kpos."""
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
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
        if want.dtype == jnp.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)
    ring = "kpos" in cache["blocks"]["b2_attn"]
    assert ring == (S > cfg.sliding_window)
    assert len(cache["rem"]) == len(jc["rem"]) == cfg.num_layers % 3


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 4 greedy decode steps in both packages: the same
    logits within tolerance and the same tokens."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 32
    tok = _tokens(cfg, B, S, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    cache = _grow_cache(cfg, cache, B, S + 4)
    jl, jc = JDE.prefill(jcfg, jparams, tok)
    jc = _jgrow(jcfg, jc, B, S + 4)
    jstep = jax.jit(lambda p, c, t: JDE.decode_step(jcfg, p, c, t))
    got_toks, want_toks = [], []
    for step in range(4):
        _close(logits, jl)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        jnxt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        got_toks.append(nxt.numpy())
        want_toks.append(np.asarray(jnxt))
        logits, cache = DE.decode_step(cfg, params, cache, nxt)
        jl, jc = jstep(jparams, jc, jnxt)
        assert int(cache["pos"]) == int(jc["pos"]) == S + step + 1
    _close(logits, jl)
    np.testing.assert_array_equal(np.concatenate(got_toks, 1),
                                  np.concatenate(want_toks, 1))
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    for path, want in flat:
        _close(_walk(cache, path), want)


def _jgrow(jcfg, cache, B, cap):
    """The JAX package's serve._grow_cache (its module needs a mesh)."""
    tmpl = JDE.cache_shapes(jcfg, B, cap)
    new = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tmpl)
    new = jax.tree.map(lambda d, s: s if d.shape == s.shape else
                       d.at[tuple(slice(0, n) for n in s.shape)].set(s),
                       new, cache)
    new["pos"] = cache["pos"]
    return new


# ---- the port's own identities (tests/test_models.py:48, :62 and :97) -------

def test_prefill_matches_forward(model):
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 2, 80, seed=1))
    full = T.forward(cfg, params, tok)
    pl, _ = DE.prefill(cfg, params, tok)
    torch.testing.assert_close(pl[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31)."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    cache = _grow_cache(cfg, cache, B, S + 1)
    kc = cache["blocks"]["b2_attn"]["k"]
    dl, cache2 = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert cache2 is cache and int(cache2["pos"]) == S + 1
    assert cache2["blocks"]["b2_attn"]["k"] is kc
    assert kc[0, :, S].abs().sum() > 0 and kc[0, :, S + 1:].abs().sum() == 0
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


def test_ring_decode_matches_forward():
    """tests/test_models.py::test_sliding_window_ring_cache_equivalence on
    the port: window 16, a 48-token prompt, so the prefill builds a ring
    and decode writes slot 48 % 16 = 0."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), sliding_window=16)
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), sliding_window=16)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    B, S = 1, 48
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=3))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    cache = _grow_cache(cfg, cache, B, S + 1)
    kpos = cache["blocks"]["b2_attn"]["kpos"]
    assert kpos.shape == (1, 16) and kpos.min() == S - 16
    dl, cache = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert int(cache["blocks"]["b2_attn"]["kpos"][0, 0]) == S
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)
    want = JT.forward(jcfg, jparams, tok.numpy())[:, S]
    _close(dl[:, 0], want)


def test_bf16_recurrent_state_is_rounded_as_in_jax():
    """bf16: rglru_step returns x's dtype and the cache stores that value
    as fp32, so the carried state is a bf16 number after the prefill and
    after every decoded token, in both packages."""
    cfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs(5))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tok = _tokens(cfg, 2, 20, seed=4)
    _, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    _, jc = JDE.prefill(jcfg, jparams, tok)
    cache = _grow_cache(cfg, cache, 2, 22)
    jc = _jgrow(jcfg, jc, 2, 22)

    def states(c):
        return [c["blocks"]["b0_rglru"]["h"], c["blocks"]["b1_rglru"]["h"],
                c["rem"][0]["h"], c["rem"][1]["h"]]

    for step in range(2):
        for h, jh in zip(states(cache), states(jc)):
            assert h.dtype == torch.float32 and jh.dtype == jnp.float32
            assert torch.equal(h, h.bfloat16().float())
            jh = np.asarray(jh)
            np.testing.assert_array_equal(
                jh, np.asarray(jnp.asarray(jh, jnp.bfloat16), np.float32))
            _close(h, jh, rtol=5e-2, atol=5e-2)
        nxt = tok[:, step:step + 1]
        _, cache = DE.decode_step(cfg, params, cache, torch.from_numpy(nxt))
        _, jc = JDE.decode_step(jcfg, jparams, jc, nxt)


# ---- serve ------------------------------------------------------------------

@pytest.mark.parametrize("prompt,gen", [(32, 4), (80, 3)])
def test_serve_generates_on_the_cpu(prompt, gen):
    """A full cache (32 + 4 <= window 64) and a ring (80 > 64): serve's
    tokens are the greedy continuation of its prompts under the parameters
    init_params draws from its seed."""
    cfg = get_arch(ARCH).reduced()
    out = serve(ARCH, smoke=True, batch=2, prompt=prompt, gen=gen, seed=5,
                device="cpu")
    gen_tok = out["generated"]
    assert gen_tok.shape == (2, gen) and gen_tok.dtype == np.int32
    assert ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()
    assert out["prefill_s"] > 0 and out["decode_s_per_token"] > 0
    params = T.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    tok = torch.from_numpy(RequestStream(cfg, 2, prompt, 5).requests_at(0)
                           ["tokens"])
    for t in range(gen):
        nxt = torch.argmax(T.forward(cfg, params, tok)[:, -1], dim=-1)
        assert np.array_equal(nxt.numpy(), gen_tok[:, t])
        tok = torch.cat([tok, nxt[:, None].to(tok.dtype)], dim=1)


def test_serve_refuses_a_prompt_that_the_window_outgrows():
    """prompt <= window < prompt + gen: the JAX package's _grow_cache breaks
    on the mismatched trees; the port names the case."""
    with pytest.raises(ValueError, match="outgrows it"):
        serve(ARCH, smoke=True, batch=1, prompt=64, gen=2, device="cpu")


def test_serve_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(ARCH, smoke=True, batch=1, prompt=8, gen=2)
