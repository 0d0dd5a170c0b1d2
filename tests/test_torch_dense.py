"""The port's dense Qwen decoders against the JAX package, on the CPU.

``get_arch("qwen3-8b").reduced()`` (qk-norm) and ``get_arch("qwen1.5-4b")
.reduced()`` (QKV bias): 2 layers, d_model 128, 4 heads of 32, d_ff 256,
vocab 512, fp32.  Parameters come from the JAX package's ``init_params``,
which makes ``bq``/``bk``/``bv`` and ``qn``/``kn`` zeros; zeros would hide
a missing bias or a wrong norm scale, so ``perturb`` draws those leaves
from a seeded numpy generator into the JAX tree before ``params_from_jax``
carries it across, and both packages see the same nonzero values.  The
same tokens then go through both packages' ``forward``, ``prefill`` and
``decode_step``.  Both sides are fp32 on one CPU and differ only in the
order of fp32 sums, so the tolerances are those of
``tests/test_torch_hybrid.py``.
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

ARCHS = ["qwen3-8b", "qwen1.5-4b"]
RTOL, ATOL = 1e-4, 1e-5        # port vs JAX, fp32 on one CPU
# bf16 forward, port vs JAX: both round every product and norm to bf16 but
# sum in other orders, so logits move by a few bf16 ulps of their scale
BF16_RTOL, BF16_ATOL = 5e-2, 5e-2
PERTURBED = ("bq", "bk", "bv", "qn", "kn")


def perturb(jparams, seed=0):
    """``jparams`` with every QKV bias and qk-norm scale drawn from a seeded
    normal (0.2 for a bias, 0.5 for a scale), in each leaf's dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else None
        if name not in PERTURBED:
            return leaf
        std = 0.2 if name.startswith("b") else 0.5
        return jnp.asarray(rng.normal(0.0, std, leaf.shape), leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, jparams)


def _cfgs(arch, **kw):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    if kw:
        cfg, jcfg = (dataclasses.replace(c, **kw) for c in (cfg, jcfg))
    return cfg, jcfg


def _carry(cfg, jcfg, seed=0):
    jparams = perturb(JT.init_params(jcfg, jax.random.PRNGKey(seed)), seed)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    return _carry(*_cfgs(request.param))


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


def _jgrow(jcfg, cache, B, cap):
    """The JAX package's serve._grow_cache (its module needs a mesh)."""
    tmpl = JDE.cache_shapes(jcfg, B, cap)
    new = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tmpl)
    new = jax.tree.map(lambda d, s: s if d.shape == s.shape else
                       d.at[tuple(slice(0, n) for n in s.shape)].set(s),
                       new, cache)
    new["pos"] = cache["pos"]
    return new


# ---- parameters -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["qwen1.5-110b"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_tree_dtypes_and_count_match_jax(arch, full):
    cfg, jcfg = ((get_arch(arch), jget_arch(arch)) if full
                 else _cfgs(arch))
    assert T.count_params(cfg) == JT.count_params(jcfg)
    if full and arch == "qwen3-8b":
        assert T.count_params(cfg) == 8_191_783_936
    if full and arch == "qwen1.5-4b":
        assert T.count_params(cfg) == 3_951_024_640
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = _walk(shapes, path)
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)
    attn = shapes["blocks"]["b0_attn"]["attn"]
    assert ("qn" in attn and "kn" in attn) == cfg.qk_norm
    assert ("bq" in attn) == cfg.qkv_bias
    if not full:
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        assert jax.tree.map(lambda _: 0, params) == \
            jax.tree.map(lambda _: 0, jshapes)


# ---- the model against the JAX package --------------------------------------

def test_forward_matches_jax(model):
    """S = 48 runs past the reduced attn_chunk of 32."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 48)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == (2, 48, cfg.padded_vocab) == want.shape
    _close(got, want)


def test_perturbed_leaves_reach_the_output(model):
    """With the drawn biases and qk-norm scales set back to JAX's zeros the
    logits move: the fixture's draws are live in both packages."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 1, 16, seed=3)
    zeroed = T.tree_map(lambda t: t, params)
    for blk in (zeroed["blocks"]["b0_attn"]["attn"],):
        for name in PERTURBED:
            if name in blk:
                blk[name] = torch.zeros_like(blk[name])
    got = T.forward(cfg, params, torch.from_numpy(tok))
    base = T.forward(cfg, zeroed, torch.from_numpy(tok))
    assert (got - base).abs().max() > 1e-3


def test_gqa_forward_matches_jax():
    """Two query heads a KV head (the reduced configs are 4:4)."""
    cfg, jcfg, jparams, params = _carry(*_cfgs("qwen3-8b", num_kv_heads=2),
                                        seed=5)
    tok = _tokens(cfg, 2, 40, seed=5)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    _close(got, JT.forward(jcfg, jparams, tok))


@pytest.mark.parametrize("S", [32, 48])
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
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
        _close(got, want)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 4 greedy decode steps in both packages: the same
    logits within tolerance, the same tokens and the same caches."""
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


# ---- the port's own identities (tests/test_models.py:48 and :62) ------------

def test_prefill_matches_forward(model):
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 2, 40, seed=1))
    full = T.forward(cfg, params, tok)
    pl, _ = DE.prefill(cfg, params, tok)
    torch.testing.assert_close(pl[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31);
    the new K row, qk-normed and rotated, lands at S in the cache."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    cache = _grow_cache(cfg, cache, B, S + 1)
    kc = cache["blocks"]["b0_attn"]["k"]
    dl, cache2 = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert cache2 is cache and int(cache2["pos"]) == S + 1
    assert kc[0, :, S].abs().sum() > 0
    _, want_cache = DE.prefill(cfg, params, tok)
    torch.testing.assert_close(kc, want_cache["blocks"]["b0_attn"]["k"],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


def test_bf16_forward_matches_jax(model):
    cfg, jcfg, _, _ = model
    cfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (cfg, jcfg))
    _, _, jparams, params = _carry(cfg, jcfg, seed=4)
    assert params["blocks"]["b0_attn"]["attn"]["wq"].dtype == torch.bfloat16
    tok = _tokens(cfg, 2, 40, seed=4)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = JT.forward(jcfg, jparams, tok)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_RTOL, BF16_ATOL)


# ---- serve ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generates_on_the_cpu(arch):
    """serve's tokens are the greedy continuation of its prompts under the
    parameters init_params draws from its seed."""
    cfg = get_arch(arch).reduced()
    prompt, gen = 24, 4
    out = serve(arch, smoke=True, batch=2, prompt=prompt, gen=gen, seed=5,
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
