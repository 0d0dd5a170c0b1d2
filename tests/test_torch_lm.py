"""The port's Mamba-2 serving stack against the JAX package, on the CPU.

``get_arch("mamba2-370m").reduced()`` (2 layers, d_model 128, 8 SSD heads of
32, state 16, chunk 32, vocab 512, fp32): parameters from the JAX package's
``init_params``, carried across by ``params_from_jax``, then the same
tokens through both packages' ``forward``, ``prefill`` and ``decode_step``.
Both sides are fp32 on one CPU and differ only in the order of fp32 sums
(the port's SSD carries its state chunk by chunk, the JAX oracle uses an
associative scan), so the tolerances are tighter than those of
``tests/test_models.py``.  The copied configs and ``RequestStream`` are
held to their originals word for word, apart from the import renames.
"""
import dataclasses
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import RequestStream as JRequestStream
from repro.models import decode as JDE
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import RequestStream
from repro_torch.launch.serve import serve
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "mamba2-370m"
RTOL, ATOL = 1e-4, 1e-5        # port vs JAX, fp32 on one CPU
CONFIG_FILES = sorted(p.name for p in (ROOT / "src/repro_torch/configs")
                      .glob("*.py"))


def _renamed(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


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


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---- copies -----------------------------------------------------------------

def test_config_copies_cover_the_jax_package():
    want = sorted(p.name for p in (ROOT / "src/repro/configs").glob("*.py"))
    assert CONFIG_FILES == want


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_copies_match_originals(name):
    orig = (ROOT / "src/repro/configs" / name).read_text()
    assert (ROOT / "src/repro_torch/configs" / name).read_text() == \
        _renamed(orig)


def test_configs_behave_as_in_jax():
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(JARCHS)
    for name, cfg in ARCHS.items():
        for c, jc in ((cfg, JARCHS[name]), (cfg.reduced(),
                                           JARCHS[name].reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(jc)
            assert (c.padded_vocab, c.subquadratic, c.resolved_head_dim) == \
                (jc.padded_vocab, jc.subquadratic, jc.resolved_head_dim)


def test_request_stream_copy_matches_original():
    assert inspect.getsource(RequestStream) == inspect.getsource(
        JRequestStream)
    for seed in (0, 3):
        got = RequestStream(get_arch(ARCH), 3, 17, seed).requests_at(2)
        want = JRequestStream(jget_arch(ARCH), 3, 17, seed).requests_at(2)
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ---- parameters -------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_param_tree_and_count_match_jax(reduced):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert T.count_params(cfg) == JT.count_params(jcfg)
    if not reduced:
        assert T.count_params(cfg) == 368_383_488
    shapes = T.param_shapes(cfg)
    jshapes = JT.param_shapes(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, s in flat:
        node = shapes
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == s.shape and node.device.type == "meta"
        assert str(node.dtype).split(".")[1] == str(s.dtype), path
    gen = torch.Generator().manual_seed(0)
    if reduced:
        params = T.init_params(cfg, gen, device="cpu")
        got = jax.tree.map(lambda _: 0, params)
        assert got == jax.tree.map(lambda _: 0, jshapes)


def test_params_from_jax_carries_bf16_bit_for_bit():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                      jax.random.PRNGKey(3)))
    params = params_from_jax(jparams, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    n_bf16 = 0
    for path, arr in flat:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        want = {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[arr.dtype.name]
        assert node.dtype == want and tuple(node.shape) == arr.shape, path
        if want == torch.bfloat16:
            n_bf16 += 1
            bits = arr.view(np.int16)
            np.testing.assert_array_equal(node.view(torch.int16).numpy(), bits)
        else:
            np.testing.assert_array_equal(node.numpy(), arr)
    assert n_bf16 >= 8


def test_unsupported_architectures_raise():
    """Every architecture of the registry builds (MLA and qwen2-vl's M-RoPE
    and patch frontend too) and an unknown name raises naming the known
    ones; MLA, the last one whose training was refused, now differentiates
    (a finite gradient reaches every leaf)."""
    for arch in ARCHS:
        T.param_defs(get_arch(arch).reduced())
    with pytest.raises(KeyError, match="minicpm3-4b"):
        get_arch("minicpm3-4b-typo")
    cfg = get_arch("minicpm3-4b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    for t in T.tree_leaves(params):
        t.requires_grad_()
    logits = T.forward(cfg, params, torch.zeros((1, 4), dtype=torch.int32))
    grads = torch.autograd.grad(logits.square().mean(), T.tree_leaves(params))
    assert all(torch.isfinite(g).all() for g in grads)


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_arch(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(ARCH, smoke=True, batch=2, prompt=16, gen=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DE.init_cache(cfg, 2, 16)


# ---- the model against the JAX package --------------------------------------

def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 64)
    got = T.forward(cfg, params, torch.from_numpy(tok))
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams, tok)
    assert got.shape == (2, 64, cfg.padded_vocab) == want.shape
    _close(got, want)


@pytest.mark.parametrize("S", [32, 16, 64])
def test_prefill_logits_and_cache_match_jax(model, S):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, S, seed=S)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    jl, jc = jax.jit(lambda p, t: JDE.prefill(jcfg, p, t))(jparams, tok)
    _close(logits, jl)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    assert int(cache["pos"]) == int(jc["pos"]) == S
    assert cache["rem"] == [] == jc["rem"]
    for name in ("h", "conv"):
        got = cache["blocks"]["b0_ssd"][name]
        want = jc["blocks"]["b0_ssd"][name]
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)


def test_greedy_decode_loop_matches_jax(model):
    """Prefill, then 4 greedy decode steps in both packages: the same
    logits within tolerance and the same tokens."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 32, seed=7)
    logits, cache = DE.prefill(cfg, params, torch.from_numpy(tok))
    jl, jc = JDE.prefill(jcfg, jparams, tok)
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
        assert int(cache["pos"]) == int(jc["pos"]) == 32 + step + 1
    _close(logits, jl)
    np.testing.assert_array_equal(np.concatenate(got_toks, 1),
                                  np.concatenate(want_toks, 1))
    for name in ("h", "conv"):
        _close(cache["blocks"]["b0_ssd"][name], jc["blocks"]["b0_ssd"][name])


# ---- the port's own identities (tests/test_models.py:48 and :62) ------------

def test_prefill_matches_forward(model):
    cfg, _, _, params = model
    tok = torch.from_numpy(_tokens(cfg, 2, 32, seed=1))
    full = T.forward(cfg, params, tok)
    pl, _ = DE.prefill(cfg, params, tok)
    torch.testing.assert_close(pl[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def test_decode_matches_forward(model):
    """decode_step at position S equals forward on S+1 tokens (S = 31, so
    the prefill runs one 31-token chunk and the forward one of 32)."""
    cfg, _, _, params = model
    B, S = 2, 31
    tok = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    full = T.forward(cfg, params, tok)
    _, cache = DE.prefill(cfg, params, tok[:, :S])
    dl, cache2 = DE.decode_step(cfg, params, cache, tok[:, S:S + 1])
    assert cache2 is cache and int(cache2["pos"]) == S + 1
    torch.testing.assert_close(dl[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


# ---- serve ------------------------------------------------------------------

def test_serve_generates_on_the_cpu():
    out = serve(ARCH, smoke=True, batch=2, prompt=16, gen=4, device="cpu")
    assert out["generated"].shape == (2, 4)
    assert out["generated"].dtype == np.int32
    assert out["prefill_s"] > 0 and out["decode_s_per_token"] > 0
    cfg = get_arch(ARCH).reduced()
    assert ((0 <= out["generated"]) & (out["generated"] < cfg.vocab_size)).all()
    # the prompts it served are the JAX package's, from the same seed
    got = RequestStream(cfg, 2, 16, 0).requests_at(0)["tokens"]
    want = JRequestStream(jget_arch(ARCH).reduced(), 2, 16, 0).requests_at(0)
    np.testing.assert_array_equal(got, want["tokens"])
    again = serve(ARCH, smoke=True, batch=2, prompt=16, gen=4, device="cpu")
    np.testing.assert_array_equal(again["generated"], out["generated"])


def test_serve_decodes_what_prefill_and_decode_step_give():
    """serve's tokens are the greedy continuation of its prompts under the
    parameters init_params draws from its seed."""
    cfg = get_arch(ARCH).reduced()
    out = serve(ARCH, smoke=True, batch=2, prompt=16, gen=3, seed=5,
                device="cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    tok = torch.from_numpy(RequestStream(cfg, 2, 16, 5).requests_at(0)
                           ["tokens"])
    for t in range(3):
        nxt = torch.argmax(T.forward(cfg, params, tok)[:, -1], dim=-1)
        assert np.array_equal(nxt.numpy(), out["generated"][:, t])
        tok = torch.cat([tok, nxt[:, None].to(tok.dtype)], dim=1)
