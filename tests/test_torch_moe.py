"""The port's top-k MoE FFN and MoE decoders against the JAX package, on the
CPU.

``moe_ffn`` against the JAX package's ``layers.moe_ffn`` on numpy-made
inputs: top-2 with room for every token, a capacity factor that drops
tokens into the overflow row, top-1 (Llama 4's routing) and the token-block
loop.  Then ``get_arch("qwen3-moe-235b-a22b").reduced()`` (qk-norm, 8
experts, top-2) and ``get_arch("llama4-maverick-400b-a17b").reduced()`` (8
experts, top-1): 2 layers, d_model 128, 4 heads of 32 (KV 4), expert
d_ff 64, vocab 512, fp32, parameters from the JAX package's ``init_params``
(qk-norm scales drawn nonzero, as ``tests/test_torch_dense.py`` does)
carried across by ``params_from_jax``.  Both sides are fp32 on one CPU;
the tolerances are ``tests/test_torch_hybrid.py``'s.  Random inputs make
a tie between two experts' probabilities (which ``torch.topk`` and
``lax.top_k`` might order apart) vanishingly rare, and no test builds one.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as JDE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import decode as DE
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_dense import _carry, _cfgs, _close, _jgrow, _tokens, _walk

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]


def _moe_inputs(T_, D, E, Fe, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return (f(T_, D), f(D, E, std=0.3), f(E, D, Fe, std=0.2),
            f(E, D, Fe, std=0.2), f(E, Fe, D, std=0.2))


def _dropped(x, gw, E, k, cf, block):
    """Assignments past their expert's capacity, block by block (numpy)."""
    n = 0
    for xb in np.split(x, len(x) // block):
        C = max(8, int(math.ceil(len(xb) * k * cf / E)))
        top = np.argsort(-(xb @ gw), axis=-1, kind="stable")[:, :k]
        n += int(np.maximum(np.bincount(top.ravel(), minlength=E) - C,
                            0).sum())
    return n


@pytest.mark.parametrize("T_,E,k,cf,block,drops", [
    (32, 8, 2, 16.0, 0, False),       # top-2, room for every token
    (128, 8, 2, 0.5, 0, True),        # C = 16 of 256 assignments: drops
    (48, 8, 1, 1.25, 0, None),        # top-1 (Llama 4)
    (64, 8, 2, 1.0, 16, None),        # the token-block loop, 4 blocks
])
def test_moe_ffn_matches_jax(T_, E, k, cf, block, drops):
    D, Fe = 32, 16
    x, gw, w1, w3, w2 = _moe_inputs(T_, D, E, Fe, seed=T_ + k)
    kw = dict(num_experts=E, k=k, capacity_factor=cf, act="silu",
              block_tokens=block)
    want, jaux = JL.moe_ffn(*map(jnp.asarray, (x, gw, w1, w3, w2)), **kw)
    got, aux = L.moe_ffn(*map(torch.from_numpy, (x, gw, w1, w3, w2)), **kw)
    assert got.shape == (T_, D) and aux.shape == ()
    _close(got, want)
    _close(aux, jaux)
    n_drop = _dropped(x, gw, E, k, cf, block or T_)
    if drops is not None:
        assert (n_drop > 0) == drops, n_drop
    if drops:
        # the dropped assignments are missing from the sum: with room for
        # every token the same inputs give another output
        roomy, _ = L.moe_ffn(*map(torch.from_numpy, (x, gw, w1, w3, w2)),
                             **{**kw, "capacity_factor": 16.0})
        assert (got - roomy).abs().max() > 1e-3


def test_moe_ffn_block_aux_is_the_mean_over_blocks():
    D, E, Fe = 32, 8, 16
    x, gw, w1, w3, w2 = map(torch.from_numpy,
                            _moe_inputs(64, D, E, Fe, seed=9))
    kw = dict(num_experts=E, k=2, capacity_factor=1.0)
    out, aux = L.moe_ffn(x, gw, w1, w3, w2, block_tokens=16, **kw)
    parts = [L.moe_ffn(xb, gw, w1, w3, w2, **kw) for xb in x.split(16)]
    torch.testing.assert_close(out, torch.cat([o for o, _ in parts]))
    torch.testing.assert_close(aux, torch.stack([a for _, a in parts]).mean())


# ---- the MoE decoders against the JAX package -------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _carry(*_cfgs(request.param))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_tree_dtypes_and_count_match_jax(arch, full):
    from repro.configs import get_arch as jget_arch
    cfg, jcfg = (get_arch(arch), jget_arch(arch)) if full else _cfgs(arch)
    assert T.count_params(cfg) == JT.count_params(jcfg)
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = _walk(shapes, path)
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)
    ffn = shapes["blocks"]["b0_attn"]["ffn"]
    E, Fe = cfg.num_experts, cfg.moe_d_ff
    assert tuple(ffn["w1"].shape[1:]) == (E, cfg.d_model, Fe)
    assert tuple(ffn["w2"].shape[1:]) == (E, Fe, cfg.d_model)


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 48)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == want.shape
    _close(got, want)


def test_prefill_logits_and_cache_match_jax(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 40, seed=40)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    jl, jc = jax.jit(lambda p, t: JDE.prefill(jcfg, p, t))(jparams, tok)
    _close(logits, jl)
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    for path, want in flat:
        _close(_walk(cache, path), want)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 4 greedy decode steps in both packages (default
    capacity factor: the same drops on both sides)."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 32
    tok = _tokens(cfg, B, S, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    cache = _grow_cache(cfg, cache, B, S + 4)
    jl, jc = JDE.prefill(jcfg, jparams, tok)
    jc = _jgrow(jcfg, jc, B, S + 4)
    jstep = jax.jit(lambda p, c, t: JDE.decode_step(jcfg, p, c, t))
    toks, jtoks = [], []
    for _ in range(4):
        _close(logits, jl)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        jnxt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(nxt.numpy())
        jtoks.append(np.asarray(jnxt))
        logits, cache = DE.decode_step(cfg, params, cache, nxt)
        jl, jc = jstep(jparams, jc, jnxt)
    _close(logits, jl)
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_models.py::test_decode_matches_forward on the port: at
    capacity factor 16 no token is dropped, so batch prefill and one-token
    decode route alike."""
    cfg, jcfg = _cfgs(arch, moe_capacity_factor=16.0)
    _, _, _, params = _carry(cfg, jcfg, seed=2)
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    cache = _grow_cache(cfg, cache, B, S + 1)
    dl, cache = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert int(cache["pos"]) == S + 1
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)


def test_moe_routes_tokens_and_balances(model):
    """tests/test_models.py::test_moe_routes_tokens_and_balances: other
    tokens give other expert mixtures, so other logits."""
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 2, 32, seed=4))
    l1 = T.forward(cfg, params, tok)
    l2 = T.forward(cfg, params, (tok + 7) % cfg.vocab_size)
    assert (l1 - l2).abs().max() > 1e-4
