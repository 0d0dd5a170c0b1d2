"""The card runs' training schedules: the port's ``launch.train.train``
against the JAX package's ``train``, on the CPU.

The card's runs of qwen3-8b (4 of 36 layers) and minicpm3-4b (batch 4 x
1024, ``steps=5``, so ``warmup_steps = max(2, 5 // 10) = 2`` and the
cosine reaches 0 at step 5) saw their losses rise over the five steps
(minicpm3-4b's then fall), and Mamba-2 370M's (batch 8 x 1024, int8
gradients, ten steps, warm-up 2) rise at step 3.  Here each reduced model
(2 layers, d_model 128, fp32: qwen3-8b with qk-norm, minicpm3-4b's MLA,
Mamba-2's SSD) trains through both launchers with its card run's schedule,
the same seed, batch and 1024 tokens: the JAX package's ``init_params``
(carried into the port by ``params_from_jax`` in place of the port's own
draw) and both packages' ``TokenStream`` (byte-equal).  The JAX launcher
takes no ``grad_compression``: its ``TrainConfig`` is handed the int8
setting here.  The losses must agree within 1e-4: both sides are fp32 on
one CPU and differ only in the order of their sums.
"""
import functools

import jax
import numpy as np

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jget_arch
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as TR

RUN = dict(smoke=True, steps=5, batch=4, seq=1024, seed=0, log_every=1,
           checkpoint_every=100)


def _losses(arch, tmp_path, monkeypatch, run, int8=False):
    """(port, JAX) losses of ``run`` through both launchers, from the JAX
    package's initial parameters."""
    jcfg = jget_arch(arch).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(run["seed"]))
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    monkeypatch.setattr(TR.T, "init_params",
                        lambda cfg, gen, device=None: carried)
    if int8:
        monkeypatch.setattr(JTR, "TrainConfig", functools.partial(
            JTrainConfig, grad_compression="int8"))
    want = JTR.train(arch, ckpt_dir=str(tmp_path / "jax"), **run)
    got = TR.train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu",
                   grad_compression="int8" if int8 else "none", **run)
    assert len(got) == len(want) == run["steps"]
    print(f"{arch} losses, port:", got, "JAX:", want)
    return got, want


def test_five_step_losses_match_jax(tmp_path, monkeypatch):
    got, want = _losses("qwen3-8b", tmp_path, monkeypatch, RUN)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_minicpm3_five_step_losses_match_jax(tmp_path, monkeypatch):
    got, want = _losses("minicpm3-4b", tmp_path, monkeypatch, RUN)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mamba2_int8_ten_step_losses_match_jax(tmp_path, monkeypatch):
    run = {**RUN, "steps": 10, "batch": 8}
    got, want = _losses("mamba2-370m", tmp_path, monkeypatch, run,
                        int8=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
