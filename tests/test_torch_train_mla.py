"""The port's training of MLA (minicpm3-4b) and of ViT-632M at its head dim
80 against the JAX package, on the CPU.

Two models: ``get_arch("minicpm3-4b").reduced()`` with ``v_head_dim`` 16
(q/k 24 + 8 = 32: K5b's (32, 16), so that a fault in the value head dim of
the backward shows; the reduced config's v 32 would equal q/k's), and
``PAPER_LM_SUITE["vit-632m"].reduced()`` with ``head_dim`` 80, the full
model's (the reduced 32 would not reach K5b's (80, 80)), fed the patch
embeddings ``TokenStream`` draws.  Parameters come from the JAX package's
``init_params``, carried across by ``params_from_jax``; batches from both
packages' ``TokenStream`` (byte-equal).  The loss and every gradient leaf
go through ``jax.value_and_grad`` of ``repro.launch.steps.loss_fn`` and the
port's ``launch.steps.value_and_grad``, whose attention gradient runs
``FlashAttention`` (K5b's plain version on the CPU, once a layer); then
three AdamW steps through both packages' train steps.  The tolerances are
``tests/test_torch_train_hybrid.py``'s: both sides are fp32 on one CPU and
differ in the order of fp32 sums, so the loss at 1e-5 and each leaf at a
relative Frobenius error of 1e-4; after three steps losses at 1e-4 and
parameters at 1e-3.  Last, the launcher's CLI trains the reduced
minicpm3-4b for two steps, and ``launch.train.train`` a reduced Whisper in
bf16 on ``TokenStream``'s fp32 frames, which the port casts to the model's
dtype (the JAX package's forward raises on them).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jget_arch
from repro.configs.paper_suite import PAPER_LM_SUITE as JSUITE
from repro.data.pipeline import TokenStream as JTokenStream
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs.paper_suite import PAPER_LM_SUITE as SUITE
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 48
# name: (port getter, JAX getter, what each changes from ``reduced()``,
# K5b's (Dqk, Dv))
MODELS = {"minicpm3-4b": (get_arch, jget_arch, {"v_head_dim": 16}, (32, 16)),
          "vit-632m": (SUITE.__getitem__, JSUITE.__getitem__,
                       {"head_dim": 80}, (80, 80))}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced model."""
    get, jget, changes, _ = MODELS[request.param]
    cfg, jcfg = (dataclasses.replace(g(request.param).reduced(), **changes)
                 for g in (get, jget))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def _leaf_pairs(tree, jtree):
    """(port leaf, JAX leaf) in ``jax.tree.leaves`` order."""
    jleaves = jax.tree.leaves(jtree)
    leaves = T.tree_leaves(tree)
    assert len(leaves) == len(jleaves)
    return list(zip(leaves, jleaves))


def _batch(cfg, jcfg, seed=0, step=0, batch=B, seq=S):
    b = TokenStream(cfg, batch, seq, seed, device="cpu").batch_at(step)
    jb = JTokenStream(jcfg, batch, seq, seed).batch_at(step)
    return b, jb


def test_the_head_dims_are_the_pairs_k5b_takes(model):
    """The cells are what they claim: the attention runs at a (Dqk, Dv)
    pair of ``HEAD_DIM_PAIRS`` that is not square (MLA) or not a square
    dim of ``HEAD_DIMS`` (the ViT); the ViT is fed patch embeddings."""
    cfg, jcfg, _, _ = model
    pair = MODELS[cfg.name.removesuffix("-smoke")][3]
    if cfg.attention == "mla":
        got = (cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim)
    else:
        got = (cfg.resolved_head_dim,) * 2
        assert "frontend_embeds" in _batch(cfg, jcfg)[0]
    assert got == pair and pair in FA.HEAD_DIM_PAIRS
    assert pair[0] != pair[1] or pair[0] not in FA.HEAD_DIMS


def test_loss_and_gradients_match_jax(model, monkeypatch):
    """Each attention layer's gradient comes from ``FlashAttention``'s
    backward, once a layer."""
    cfg, jcfg, jparams, params = model
    batch, jbatch = _batch(cfg, jcfg)
    mesh = make_local_mesh()
    shard = JSH.make_act_sharder(mesh, JSH.TRAIN_RULES)
    with mesh:
        jloss, jgrads = jax.value_and_grad(JST.loss_fn, argnums=1)(
            jcfg, jparams, jbatch, shard)
    calls = []
    real = FA.flash_attention_bwd_plain

    def counting(q, k, v, *args, **kw):
        calls.append((q.shape[-1], v.shape[-1]))
        return real(q, k, v, *args, **kw)

    monkeypatch.setattr(FA, "flash_attention_bwd_plain", counting)
    loss, grads = ST.value_and_grad(cfg, params, batch)
    assert calls == [MODELS[cfg.name.removesuffix("-smoke")][3]] * \
        cfg.num_layers
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg in _leaf_pairs(grads, jgrads):
        assert g.shape == jg.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all() and g.abs().sum() > 0
        assert _rel(g, jg) <= 1e-4


def test_train_steps_match_jax(model):
    cfg, jcfg, jparams, params = model
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    step_fn = ST.make_train_step(cfg, TrainConfig(**kw))
    mesh = make_local_mesh()
    with mesh:
        jstep = jax.jit(JST.make_train_step(jcfg, mesh, JTrainConfig(**kw)))
        jp, jo = jparams, jadamw.init(jparams)
        # the step updates in place (JAX's donation): a copy of the
        # module's tree, which the other tests read
        p = T.tree_map(torch.clone, params)
        o = adamw.init(p)
        for step in range(3):
            batch, jbatch = _batch(cfg, jcfg, seed=1, step=step, batch=4)
            p, o, m = step_fn(p, o, batch)
            jp, jo, jm = jstep(jp, jo, jbatch)
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                       rtol=1e-4)
    assert int(o.step) == int(jo.step) == 3
    for a, b in _leaf_pairs(p, jp):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= 1e-3


def test_launcher_cli_trains_minicpm3(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm3-4b", "--device", "cpu", "--steps", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] step 2/2 loss=" in out.stdout
    assert "[train] first loss" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_bf16_whisper_trains_through_the_launcher(monkeypatch, tmp_path):
    """The encoder and cross-attention run in the model's dtype on the
    frames ``TokenStream`` draws in fp32: the same logits as on frames cast
    by the caller, and ``launch.train.train`` takes two finite steps."""
    cfg = dataclasses.replace(get_arch("whisper-medium").reduced(),
                              dtype="bfloat16")
    batch = TokenStream(cfg, B, S, 0, device="cpu").batch_at(0)
    frames = batch["encoder_frames"]
    assert frames.dtype == torch.float32
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    logits = T.forward(cfg, params, batch["tokens"], encoder_frames=frames)
    assert logits.dtype == torch.bfloat16
    assert torch.equal(logits, T.forward(cfg, params, batch["tokens"],
                                         encoder_frames=frames.bfloat16()))
    monkeypatch.setattr(TR, "get_arch", lambda name: cfg)
    losses = TR.train(cfg.name, smoke=False, steps=2, batch=B, seq=S,
                      ckpt_dir=str(tmp_path), log_every=2, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
