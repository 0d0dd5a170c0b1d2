"""The port's training of the hybrid and dense families against the JAX
package, on the CPU.

Two models: ``get_arch("recurrentgemma-2b").reduced()`` (rglru, rglru,
attn; d_model 128, 4 heads of 32 with one KV head) with the sliding window
cut to 16, so that at 64 tokens the window bites; and
``get_arch("qwen3-8b").reduced()`` (2 GQA layers with qk-norm), its
qk-norm scales drawn nonzero into the JAX tree first
(``test_torch_dense.perturb``: JAX makes them zeros, which would hide a
wrong scale).  Parameters come from the JAX package's ``init_params``,
carried across by ``params_from_jax``; batches from both packages'
``TokenStream`` (byte-equal).  The loss and every gradient leaf go through
``jax.value_and_grad`` of ``repro.launch.steps.loss_fn`` and the port's
``launch.steps.value_and_grad``, whose attention and RG-LRU gradients run
``FlashAttention`` and ``RGLRUScan`` (K5b's and K7b's plain versions on the
CPU); then three AdamW steps through both packages' train steps.  The
tolerances are ``tests/test_torch_train.py``'s: both sides are fp32 on one
CPU and differ in the order of fp32 sums, so the loss at 1e-5 and each leaf
at a relative Frobenius error of 1e-4; after three steps losses at 1e-4 and
parameters at 1e-3.  Last, the launcher's CLI trains the reduced
RecurrentGemma for two steps.
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
from repro.data.pipeline import TokenStream as JTokenStream
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rglru as RG
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from test_torch_dense import perturb

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
# the reduced models, with what each changes from ``reduced()``
MODELS = {"recurrentgemma-2b": {"sliding_window": 16}, "qwen3-8b": {}}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced model."""
    arch = request.param
    cfg, jcfg = (dataclasses.replace(c, **MODELS[arch])
                 for c in (get_arch(arch).reduced(),
                           jget_arch(arch).reduced()))
    jparams = perturb(JT.init_params(jcfg, jax.random.PRNGKey(0)))
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


def test_the_window_bites_and_the_leaves_are_drawn(model):
    """The cells are what they claim: RecurrentGemma's window is shorter
    than the sequence, qwen3-8b's qk-norm scales are not zeros."""
    cfg, jcfg, jparams, params = model
    if cfg.family == "hybrid":
        assert cfg.sliding_window == jcfg.sliding_window == 16 < S
        assert cfg.block_pattern == ("rglru", "rglru", "attn")
    else:
        assert cfg.qk_norm
        attn = params["blocks"]["b0_attn"]["attn"]
        assert attn["qn"].abs().sum() > 0 and attn["kn"].abs().sum() > 0


def test_loss_and_gradients_match_jax(model, monkeypatch):
    """Each attention layer's gradient comes from ``FlashAttention``'s
    backward and each rglru layer's from ``RGLRUScan``'s, once a layer."""
    cfg, jcfg, jparams, params = model
    batch, jbatch = _batch(cfg, jcfg)
    mesh = make_local_mesh()
    shard = JSH.make_act_sharder(mesh, JSH.TRAIN_RULES)
    with mesh:
        jloss, jgrads = jax.value_and_grad(JST.loss_fn, argnums=1)(
            jcfg, jparams, jbatch, shard)
    calls = {"attn": 0, "rglru": 0}

    def counting(kind, fn):
        def run(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(FA, "flash_attention_bwd_plain",
                        counting("attn", FA.flash_attention_bwd_plain))
    monkeypatch.setattr(RG, "rglru_scan_bwd_plain",
                        counting("rglru", RG.rglru_scan_bwd_plain))
    loss, grads = ST.value_and_grad(cfg, params, batch)
    kinds = [cfg.block_pattern[j % len(cfg.block_pattern)]
             for j in range(cfg.num_layers)]
    assert calls == {k: kinds.count(k) for k in calls}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg in _leaf_pairs(grads, jgrads):
        assert g.shape == jg.shape and g.dtype == torch.float32
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


def test_launcher_cli_trains_recurrentgemma(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "recurrentgemma-2b", "--device", "cpu", "--steps", "2", "--seq",
         "32", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] step 2/2 loss=" in out.stdout
    assert "[train] first loss" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 2
