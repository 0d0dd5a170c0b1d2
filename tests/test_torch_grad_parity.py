"""The gradient of every LM family the other training tests leave out,
against the JAX package, on the CPU.

The reduced qwen3-moe-235b-a22b (top-2 of 8 experts) and
llama4-maverick-400b-a17b (top-1), through the gather path of
``layers.moe_ffn`` with its dropped slots; whisper-medium (the encoder,
cross-attention, learned positions) fed ``TokenStream``'s frames;
qwen2-vl-72b (M-RoPE, ``patch_proj``) fed its patch embeddings; the
paper's GPT-2 1.5B and BERT-base.  Each model's QKV biases and qk-norm
scales are drawn nonzero (``test_torch_dense.perturb``).  The loss and
every gradient leaf of ``jax.value_and_grad(repro.launch.steps.loss_fn)``
and of the port's ``launch.steps.value_and_grad`` (attention's gradient
through ``FlashAttention``, K5b's plain version on the CPU) on the same
batch: the loss within 1e-5, each leaf within a relative Frobenius error of
1e-4, as ``tests/test_torch_train_hybrid.py`` holds them.

One leaf is held otherwise.  Under top-1 routing the router's weight of
the chosen expert renormalises to 1 whatever the logits, and ``loss_fn``
leaves out the MoE's auxiliary loss, so llama4's router ``wg`` has an
analytically zero gradient: both packages give fp32 residues of ~1e-10,
whose relative error means nothing.  That leaf's error is read against a
norm floored at an rms of ``ZERO_GRAD_RMS`` (as ``chip_smoke.py``'s
``K5B_REL_FLOOR`` floors a gradient that cancels), and both sides' rms must
lie under it; every other leaf keeps the 1e-4 bar on its own norm.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.paper_suite import PAPER_LM_SUITE as JSUITE
from repro.data.pipeline import TokenStream as JTokenStream
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.paper_suite import PAPER_LM_SUITE as SUITE
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from test_torch_dense import perturb

B, S = 2, 48
FAMILIES = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "whisper-medium", "qwen2-vl-72b", "gpt2-1.5b", "bert-base"]
# leaves whose gradient is analytically zero (top-1 routing without the aux
# loss), by family: the last key of each leaf's path
ZERO_GRAD = {"llama4-maverick-400b-a17b": {"wg"}}
ZERO_GRAD_RMS = 1e-6


def _getters(name):
    return ((SUITE.__getitem__, JSUITE.__getitem__) if name in SUITE
            else (get_arch, jget_arch))


@pytest.fixture(scope="module", params=FAMILIES)
def run(request):
    """(family, port cfg, (JAX loss, grads), (port loss, grads)) of one
    reduced model on one batch."""
    name = request.param
    get, jget = _getters(name)
    cfg, jcfg = get(name).reduced(), jget(name).reduced()
    jparams = perturb(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = TokenStream(cfg, B, S, 3, device="cpu").batch_at(0)
    jbatch = JTokenStream(jcfg, B, S, 3).batch_at(0)
    mesh = make_local_mesh()
    shard = JSH.make_act_sharder(mesh, JSH.TRAIN_RULES)
    with mesh:
        jloss, jgrads = jax.value_and_grad(JST.loss_fn, argnums=1)(
            jcfg, jparams, jbatch, shard)
    loss, grads = ST.value_and_grad(cfg, params, batch)
    return name, cfg, (jloss, jgrads), (loss, grads)


def test_the_family_reaches_what_it_claims(run):
    """MoE layers route, Whisper has an encoder fed frames, qwen2-vl runs
    M-RoPE fed patches, GPT-2 and BERT learned positions."""
    name, cfg, _, _ = run
    want = {"qwen3-moe-235b-a22b": cfg.num_experts and
            cfg.experts_per_token > 1,
            "llama4-maverick-400b-a17b": cfg.num_experts and
            cfg.experts_per_token == 1,
            "whisper-medium": cfg.encoder_layers and
            cfg.frontend == "audio_frames",
            "qwen2-vl-72b": cfg.rope == "mrope" and
            cfg.frontend == "vision_patches",
            "gpt2-1.5b": cfg.rope == "learned",
            "bert-base": cfg.rope == "learned"}[name]
    assert want


def test_loss_matches_jax(run):
    _, _, (jloss, _), (loss, _) = run
    assert math.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


def test_every_gradient_leaf_matches_jax(run):
    name, _, (_, jgrads), (_, grads) = run
    jflat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    leaves = T.tree_leaves(grads)
    assert len(leaves) == len(jflat)
    floored = 0
    for g, (path, jg) in zip(leaves, jflat):
        key = path[-1].key if hasattr(path[-1], "key") else None
        want = torch.from_numpy(np.array(jg, dtype=np.float32))
        assert g.shape == want.shape and g.dtype == torch.float32, path
        assert torch.isfinite(g).all(), path
        norm, floor = want.norm(), 1e-30
        if key in ZERO_GRAD.get(name, ()):
            floor = ZERO_GRAD_RMS * math.sqrt(want.numel())
            assert max(norm, g.norm()) <= floor, path
            floored += 1
        rel = ((g.float() - want).norm() / norm.clamp_min(floor)).item()
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)
    assert floored == (1 if name in ZERO_GRAD else 0)
