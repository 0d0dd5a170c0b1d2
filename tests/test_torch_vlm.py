"""The port's M-RoPE and ``vision_patches`` frontend (qwen2-vl-72b, the
paper's ViT-632M) against the JAX package, on the CPU.

``get_arch("qwen2-vl-72b").reduced()`` (2 layers, d_model 128, 4 heads of
32 with 4 KV heads, QKV bias, M-RoPE, 16 frontend positions, vocab 512,
fp32) and ``PAPER_LM_SUITE["vit-632m"].reduced()`` (learned positions,
gelu, the same frontend).  Parameters come from the JAX package's
``init_params`` and cross over by ``params_from_jax``; the QKV biases are
drawn nonzero.  The patch embeddings are random (normal(0, 1)), since
serving's stub is zeros and ``patch_proj(0) = 0`` would hide the
projection; M-RoPE's positions are distinct on the t/h/w channels, since
with equal channels M-RoPE reads exactly as RoPE.  Both sides are fp32 on
one CPU and differ only in the order of fp32 sums, so the tolerances are
those of ``tests/test_torch_dense.py``; decode == forward is held to
``tests/test_models.py::test_decode_matches_forward``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.paper_suite import PAPER_LM_SUITE as JSUITE
from repro.models import decode as JDE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.paper_suite import PAPER_LM_SUITE as SUITE
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as S
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import decode as DE
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

RTOL, ATOL = 1e-4, 1e-5         # port vs JAX, fp32 on one CPU
MODELS = {"qwen2-vl-72b": (get_arch, jget_arch),
          "vit-632m": (SUITE.__getitem__, JSUITE.__getitem__)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced model, its
    QKV biases drawn nonzero."""
    get, jget = MODELS[request.param]
    jcfg = jget(request.param).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    attn = jparams["blocks"]["b0_attn"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = jnp.asarray(
                rng.normal(0, 0.2, attn[name].shape).astype(np.float32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return get(request.param).reduced(), jcfg, jparams, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _patches(cfg, B, seed=0):
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _positions(B, S, seed=0):
    """(B, S, 3) t/h/w ids that differ between the channels (t = i // 4,
    h = i % 4 + i // 4, w = i for position i), each row shifted by small
    offsets of its own."""
    rng = np.random.default_rng(seed)
    i = np.arange(S)
    pos = np.stack([i // 4, i % 4 + i // 4, i], axis=-1)
    return np.stack([pos + rng.integers(0, 3, (1, 3)) for _ in range(B)]
                    ).astype(np.int32)


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


# ---- M-RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sections", [(32, (1, 1, 1)),
                                               (32, (2, 1, 1)),
                                               (128, (16, 24, 24))])
def test_mrope_angles_match_jax(head_dim, sections):
    pos = _positions(2, 24, seed=head_dim)
    assert not (pos[..., 0] == pos[..., 1]).all()
    got = L.mrope_angles(torch.from_numpy(pos), head_dim, 1e6,
                         sections=sections)
    want = JL.mrope_angles(jnp.asarray(pos), head_dim, 1e6,
                           sections=sections)
    for g, w in zip(got, want):
        assert g.shape == (2, 24, head_dim // 2) == w.shape
        _close(g, w, rtol=1e-6, atol=1e-6)


# ---- the models against the JAX package --------------------------------------

def test_forward_matches_jax(model):
    """S = 40 past the 32-row attention chunk, random patch embeddings in
    the first 16 positions; qwen2-vl at explicit, distinct t/h/w
    positions."""
    cfg, jcfg, jparams, params = model
    tok, fe = _tokens(cfg, 2, 40), _patches(cfg, 2)
    kw = {"positions": _positions(2, 40)} if cfg.rope == "mrope" else {}
    got = T.forward(cfg, params, torch.from_numpy(tok),
                    frontend_embeds=torch.from_numpy(fe),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jax.jit(lambda p, t, f, **k: JT.forward(
        jcfg, p, t, frontend_embeds=f, **k))(jparams, tok, fe, **kw)
    assert got.shape == (2, 40, cfg.padded_vocab) == want.shape
    _close(got, want)
    if cfg.rope == "mrope":      # the positions reach the model
        plain = T.forward(cfg, params, torch.from_numpy(tok),
                          frontend_embeds=torch.from_numpy(fe))
        assert (plain - got).abs().max() > 1e-3


def test_prefill_and_greedy_decode_match_jax(model):
    """Prefill with the patch embeddings (logits and every cache leaf),
    then 3 greedy decode steps in both packages."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 24
    tok, fe = _tokens(cfg, B, S, seed=7), _patches(cfg, B, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok),
                               frontend_embeds=torch.from_numpy(fe))
    jl, jc = JDE.prefill(jcfg, jparams, tok, frontend_embeds=fe)
    _close(logits, jl)
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    for path, want in flat:
        got = _walk(cache, path)
        assert tuple(got.shape) == want.shape, path
        _close(got, want)
    assert len(T.tree_leaves(cache)) == len(flat)
    cache = _grow_cache(cfg, cache, B, S + 3)
    jc = _jgrow(jcfg, jc, B, S + 3)
    jstep = jax.jit(lambda p, c, t: JDE.decode_step(jcfg, p, c, t))
    for step in range(3):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        jnxt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        logits, cache = DE.decode_step(cfg, params, cache, nxt)
        jl, jc = jstep(jparams, jc, jnxt)
        assert int(cache["pos"]) == int(jc["pos"]) == S + step + 1
        _close(logits, jl)


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31),
    the patch embeddings in both, within tests/test_models.py::
    test_decode_matches_forward's rtol 2e-2, atol 2e-3."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    fe = torch.from_numpy(_patches(cfg, B, seed=2))
    full = T.forward(cfg, params, tok, frontend_embeds=fe)
    _, cache = DE.prefill(cfg, params, tok[:, :S], frontend_embeds=fe)
    cache = _grow_cache(cfg, cache, B, S + 1)
    dl, cache = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert int(cache["pos"]) == S + 1
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)


def test_frontend_longer_than_the_prompt_raises(model):
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 1, cfg.frontend_seq - 1))
    fe = torch.from_numpy(_patches(cfg, 1))
    msg = f"{cfg.frontend_seq} frontend positions.*{cfg.frontend_seq - 1}"
    with pytest.raises(ValueError, match=msg):
        T.forward(cfg, params, tok, frontend_embeds=fe)
    with pytest.raises(ValueError, match=msg):
        DE.prefill(cfg, params, tok, frontend_embeds=fe)


# ---- the suite and serving ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(SUITE))
def test_paper_suite_configs_build(name):
    """tests/test_serving.py::test_paper_suite_configs_build on the port:
    each reduced suite model's forward (ViT-632M with zero patch
    embeddings, as there), and its full-width parameter count as the JAX
    package's."""
    r = SUITE[name].reduced()
    params = T.init_params(r, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, r.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    kw = {}
    if r.frontend == "vision_patches":
        kw["frontend_embeds"] = torch.zeros((1, r.frontend_seq, r.d_model),
                                            dtype=getattr(torch, r.dtype))
    logits = T.forward(r, params, tokens, **kw)
    assert logits.shape[-1] in (r.vocab_size, r.padded_vocab)
    assert torch.isfinite(logits).all()
    assert T.count_params(SUITE[name]) == JT.count_params(JSUITE[name])


def test_serve_with_the_stub_frontend_on_the_cpu():
    """``serve`` of the reduced qwen2-vl (zero patch embeddings in the
    first 16 of 24 prompt positions): the greedy continuation under
    forward, and the full model's parameter count as the JAX package's."""
    cfg = get_arch("qwen2-vl-72b").reduced()
    out = S.serve("qwen2-vl-72b", smoke=True, batch=2, prompt=24, gen=3,
                  seed=4, device="cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    tok = torch.from_numpy(S.RequestStream(cfg, 2, 24, 4).requests_at(0)
                           ["tokens"])
    fe = torch.zeros((2, cfg.frontend_seq, cfg.d_model))
    for t in range(3):
        nxt = torch.argmax(T.forward(cfg, params, tok,
                                     frontend_embeds=fe)[:, -1], dim=-1)
        assert np.array_equal(nxt.numpy(), out["generated"][:, t])
        tok = torch.cat([tok, nxt[:, None].to(tok.dtype)], dim=1)
    full = get_arch("qwen2-vl-72b")
    assert T.count_params(full) == JT.count_params(jget_arch("qwen2-vl-72b"))
    with pytest.raises(ValueError, match="frontend positions"):
        S.serve("qwen2-vl-72b", smoke=True, batch=1, prompt=8, gen=2,
                device="cpu")
