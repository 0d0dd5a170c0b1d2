"""qwen3-8b's five-step schedule: the port's ``launch.train.train`` against
the JAX package's ``train``, on the CPU.

The card's run of qwen3-8b (4 of 36 layers, batch 4 x 1024, ``steps=5``,
so ``warmup_steps = max(2, 5 // 10) = 2`` and the cosine reaches 0 at step
5) saw its loss rise over the five steps.  Here the reduced qwen3-8b (2
layers, d_model 128, qk-norm, fp32) trains through both launchers with
that schedule, the same seed, batch 4 and 1024 tokens: the JAX package's
``init_params`` (carried into the port by ``params_from_jax`` in place of
the port's own draw) and both packages' ``TokenStream`` (byte-equal).  The
five losses must agree within 1e-4: both sides are fp32 on one CPU and
differ only in the order of their sums.
"""
import jax
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as TR

RUN = dict(smoke=True, steps=5, batch=4, seq=1024, seed=0, log_every=1,
           checkpoint_every=100)


def test_five_step_losses_match_jax(tmp_path, monkeypatch):
    jcfg = jget_arch("qwen3-8b").reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(RUN["seed"]))
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    monkeypatch.setattr(TR.T, "init_params",
                        lambda cfg, gen, device=None: carried)
    want = JTR.train("qwen3-8b", ckpt_dir=str(tmp_path / "jax"), **RUN)
    got = TR.train("qwen3-8b", ckpt_dir=str(tmp_path / "port"),
                   device="cpu", **RUN)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    print("losses, port:", got, "JAX:", want)
