"""The port's Whisper encoder-decoder against the JAX package, on the CPU.

``get_arch("whisper-medium").reduced()`` (2 decoder and 2 encoder layers,
d_model 128, 4 heads of 32, d_ff 256, 16 encoder frames, vocab 512, fp32,
learned positions, gelu, cross-attention in every decoder block).
Parameters come from the JAX package's ``init_params`` and cross over by
``params_from_jax``; the frame embeddings are drawn from a seeded numpy
normal(0, 0.02), as ``TokenStream`` draws them, and the same frames and
tokens go through both packages' ``encode``, ``forward``, ``prefill``,
``decode_step`` and ``loss_fn``.  Both sides are fp32 on one CPU and differ
only in the order of fp32 sums, so the tolerances are those of
``tests/test_torch_dense.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as JST
from repro.models import decode as JDE
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import RequestStream, TokenStream
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T

ARCH = "whisper-medium"
RTOL, ATOL = 1e-4, 1e-5        # port vs JAX, fp32 on one CPU


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    jcfg = jget_arch(ARCH).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return get_arch(ARCH).reduced(), jcfg, jparams, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frames(cfg, B, seed=0):
    return np.random.default_rng(seed + 100).normal(
        0, 0.02, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


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


# ---- parameters and cache ---------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_tree_dtypes_and_count_match_jax(full):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert T.count_params(cfg) == JT.count_params(jcfg)
    if full:
        assert T.count_params(cfg) == 1_027_954_688
    shapes, jshapes = T.param_shapes(cfg), JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = _walk(shapes, path)
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(shapes)) == len(flat)
    assert sorted(shapes["blocks"]["b0_attn"]["xattn"]) == \
        ["ln", "wk", "wo", "wq", "wv"]
    assert shapes["encoder"]["pos_embed"].shape == (cfg.encoder_seq,
                                                    cfg.d_model)
    assert shapes["pos_embed"].shape == (cfg.max_position, cfg.d_model)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_cache_shapes_match_jax(full):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = DE.cache_shapes(cfg, 4, 416)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        JDE.cache_shapes(jcfg, 4, 416))
    for path, s in flat:
        node = _walk(got, path)
        assert tuple(node.shape) == s.shape, path
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    assert len(T.tree_leaves(got)) == len(flat)
    assert got["blocks"]["b0_attn"]["xk"].shape == (
        cfg.num_layers, 4, cfg.encoder_seq, cfg.num_kv_heads,
        cfg.resolved_head_dim)


# ---- the model against the JAX package --------------------------------------

def test_encode_matches_jax(model):
    cfg, jcfg, jparams, params = model
    fr = _frames(cfg, 2)
    got = T.encode(cfg, params, torch.from_numpy(fr))
    want = jax.jit(lambda p, f: JT.encode(jcfg, p, f))(jparams, fr)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model) == want.shape
    _close(got, want)


@pytest.mark.parametrize("with_frames", [True, False])
def test_forward_matches_jax(model, with_frames):
    """S = 40 runs past the reduced attn_chunk of 32; without frames both
    packages skip cross-attention."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 40)
    fr = _frames(cfg, 2) if with_frames else None
    got = T.forward(cfg, params, torch.from_numpy(tok),
                    encoder_frames=None if fr is None else torch.from_numpy(fr))
    want = jax.jit(lambda p, t, f: JT.forward(jcfg, p, t, encoder_frames=f))(
        jparams, tok, fr)
    assert got.shape == (2, 40, cfg.padded_vocab) == want.shape
    _close(got, want)


def test_frames_and_positions_reach_the_logits(model):
    """Other frames, or the learned positions zeroed, move the logits: the
    encoder and pos_embed are live."""
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 1, 16, seed=3))
    fr = torch.from_numpy(_frames(cfg, 1, seed=3))
    base = T.forward(cfg, params, tok, encoder_frames=fr)
    other = T.forward(cfg, params, tok, encoder_frames=fr * 3.0)
    assert (base - other).abs().max() > 1e-4
    nopos = dict(params, pos_embed=torch.zeros_like(params["pos_embed"]))
    assert (base - T.forward(cfg, nopos, tok, encoder_frames=fr)
            ).abs().max() > 1e-4


@pytest.mark.parametrize("S", [24, 40])
def test_prefill_logits_and_cache_match_jax(model, S):
    cfg, jcfg, jparams, params = model
    tok, fr = _tokens(cfg, 2, S, seed=S), _frames(cfg, 2, seed=S)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok),
                               encoder_frames=torch.from_numpy(fr))
    jl, jc = jax.jit(lambda p, t, f: JDE.prefill(jcfg, p, t,
                                                 encoder_frames=f))(
        jparams, tok, fr)
    _close(logits, jl)
    assert int(cache["pos"]) == int(jc["pos"]) == S
    flat, _ = jax.tree_util.tree_flatten_with_path(jc)
    names = set()
    for path, want in flat:
        got = _walk(cache, path)
        names.add(path[-1].key if hasattr(path[-1], "key") else None)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
        _close(got, want)
    assert {"k", "v", "xk", "xv"} <= names


def test_prefill_attends_through_the_attention_kernel(model, monkeypatch):
    """Every prefill attention, the encoder's, the decoder's and
    cross-attention's, goes through ``ops.attention`` (K5 on the card,
    here its plain version): one call an encoder layer and two a decoder
    layer; decode calls it never (plain ``_attn_block``, as in JAX)."""
    cfg, _, _, params = model
    calls = []
    real = ops.flash_attention_plain

    def counting(q, k, v, *, causal, window, **pos):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal, window=window, **pos)

    monkeypatch.setattr(ops, "flash_attention_plain", counting)
    B, S = 2, 24
    tok = torch.from_numpy(_tokens(cfg, B, S, seed=9))
    _, cache = DE.prefill(cfg, params, tok,
                          encoder_frames=torch.from_numpy(_frames(cfg, B)))
    H, Dh, E = cfg.num_heads, cfg.resolved_head_dim, cfg.encoder_seq
    enc = [((B, H, E, Dh), (B, H, E, Dh), False)] * cfg.encoder_layers
    dec = [((B, H, S, Dh), (B, H, S, Dh), True),
           ((B, H, S, Dh), (B, H, E, Dh), False)] * cfg.num_layers
    assert calls == enc + dec
    cache = _grow_cache(cfg, cache, B, S + 1)
    DE.decode_step(cfg, params, cache, tok[:, -1:])
    assert len(calls) == len(enc + dec)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill with frames, then 4 greedy decode steps in both packages:
    the same logits within tolerance, the same tokens and caches."""
    cfg, jcfg, jparams, params = model
    B, S = 2, 24
    tok, fr = _tokens(cfg, B, S, seed=7), _frames(cfg, B, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok),
                               encoder_frames=torch.from_numpy(fr))
    cache = _grow_cache(cfg, cache, B, S + 4)
    jl, jc = JDE.prefill(jcfg, jparams, tok, encoder_frames=fr)
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
    fr = torch.from_numpy(_frames(cfg, 2, seed=1))
    full = T.forward(cfg, params, tok, encoder_frames=fr)
    pl, _ = DE.prefill(cfg, params, tok, encoder_frames=fr)
    torch.testing.assert_close(pl[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def test_decode_matches_forward(model):
    """decode_step at position S (its learned position, cross-attention
    over the cached xk/xv) equals forward on S+1 tokens (S = 31)."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    fr = torch.from_numpy(_frames(cfg, B, seed=2))
    full = T.forward(cfg, params, tok, encoder_frames=fr)
    _, cache = DE.prefill(cfg, params, tok[:, :S], encoder_frames=fr)
    cache = _grow_cache(cfg, cache, B, S + 1)
    xk = cache["blocks"]["b0_attn"]["xk"]
    dl, cache2 = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert cache2 is cache and int(cache2["pos"]) == S + 1
    assert cache2["blocks"]["b0_attn"]["xk"] is xk and xk.abs().sum() > 0
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


def test_learned_positions_refuse_a_block_past_max_position(model):
    cfg, _, _, params = model
    short = T.tree_map(lambda t: t, params)
    short["pos_embed"] = params["pos_embed"][:16]
    cut = dataclasses.replace(cfg, max_position=16)
    tok = torch.from_numpy(_tokens(cfg, 1, 17))
    with pytest.raises(ValueError, match="past the 16 learned positions"):
        T.forward(cut, short, tok)
    assert T.forward(cut, short, tok[:, :16]).shape[1] == 16


# ---- the training loss and serve --------------------------------------------

def test_loss_fn_with_frames_matches_jax(model):
    """``loss_fn`` reads the batch's ``encoder_frames`` (TokenStream's), as
    the JAX package's does."""
    cfg, jcfg, jparams, params = model
    batch = TokenStream(cfg, 2, 24, seed=3, device="cpu").batch_at(1)
    assert batch["encoder_frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    jbatch = {k: v.numpy() for k, v in batch.items()}
    got = ST.loss_fn(cfg, params, batch)
    want = JST.loss_fn(jcfg, jparams, jbatch, lambda x, k: x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    no_frames = ST.loss_fn(cfg, params, {k: v for k, v in batch.items()
                                         if k != "encoder_frames"})
    assert abs(no_frames.item() - got.item()) > 1e-6


def test_serve_generates_on_the_cpu():
    """serve's stub frontend (zero frames) and its tokens: the greedy
    continuation under forward with the same zero frames."""
    cfg = get_arch(ARCH).reduced()
    prompt, gen = 24, 4
    out = serve(ARCH, smoke=True, batch=2, prompt=prompt, gen=gen, seed=5,
                device="cpu")
    gen_tok = out["generated"]
    assert gen_tok.shape == (2, gen) and gen_tok.dtype == np.int32
    assert ((0 <= gen_tok) & (gen_tok < cfg.vocab_size)).all()
    params = T.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    tok = torch.from_numpy(RequestStream(cfg, 2, prompt, 5).requests_at(0)
                           ["tokens"])
    fr = torch.zeros(2, cfg.encoder_seq, cfg.d_model)
    for t in range(gen):
        nxt = torch.argmax(T.forward(cfg, params, tok,
                                     encoder_frames=fr)[:, -1], dim=-1)
        assert np.array_equal(nxt.numpy(), gen_tok[:, t])
        tok = torch.cat([tok, nxt[:, None].to(tok.dtype)], dim=1)
