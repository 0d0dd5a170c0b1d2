"""A plain model of K7's chunked scan against the JAX package, on the CPU.

``csrc/rglru.cu`` walks the time axis in windows of a thread-block
cluster: each block of the cluster takes ``SUBCHUNKS`` sub-chunks of
``SUB_STEPS`` steps, forms each sub-chunk's composite (prod a, h from 0),
folds those before each sub-chunk in shared memory, publishes its own to
the cluster, and takes its carry-in from the window's carry-in (h0 in the
first window) folded through the blocks before it; pass 2 walks each
sub-chunk again from there.  ``chunked_model`` below is that decomposition
in plain PyTorch, fold for fold, so that the algebra is held to the JAX
package's Pallas kernel (interpret mode) and ``layers.rglru`` (the
associative-scan oracle) at the kernel's plan and at spans that divide
nothing, before the kernel runs on a card.  The tolerance is
``tests/test_kernels.py::test_rglru_kernel``'s 1e-4: the fold re-associates
fp32 products, as the port's plain doubling scan does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rglru import rglru_scan as jax_rglru_scan
from repro.models import layers as JL
from repro_torch.kernels.rglru import (C, CHANNELS, MAX_CLUSTER, SUB_STEPS,
                                       SUBCHUNKS, launch_plan)

RTOL, ATOL = 1e-4, 1e-4         # tests/test_kernels.py::test_rglru_kernel


def chunked_model(x, gx, ga, log_a, h0, *, steps, subchunks, cluster):
    """K7's function through the kernel's decomposition: windows of
    ``cluster`` blocks of ``subchunks`` sub-chunks of ``steps`` steps; past
    S, a = 1 and b = 0.  fp32 in, fp32 out."""
    B, S, W = x.shape
    log_a_t = C * torch.sigmoid(ga) * F.softplus(log_a)
    a = torch.exp(log_a_t)
    b = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a_t), min=1e-12))
         * torch.sigmoid(gx) * x)
    window = cluster * subchunks * steps
    windows = -(-S // window)
    pad = windows * window - S
    a = torch.cat([a, torch.ones(B, pad, W)], 1)
    b = torch.cat([b, torch.zeros(B, pad, W)], 1)
    shape = (B, windows, cluster, subchunks, steps, W)
    a, b = a.view(shape), b.view(shape)
    y = torch.empty(shape)
    carry = h0.clone()                          # the window's carry-in
    for win in range(windows):
        aw, bw = a[:, win], b[:, win]           # (B, cluster, sub, steps, W)
        # pass 1: each sub-chunk's composite
        A = torch.ones(B, cluster, subchunks, W)
        H = torch.zeros(B, cluster, subchunks, W)
        for i in range(steps):
            H = aw[:, :, :, i] * H + bw[:, :, :, i]
            A = A * aw[:, :, :, i]
        # each sub-chunk's prefix in its block, and the block's composite
        PA, PH = torch.ones(B, cluster, W), torch.zeros(B, cluster, W)
        pre_a, pre_h = [], []
        for j in range(subchunks):
            pre_a.append(PA)
            pre_h.append(PH)
            PH = A[:, :, j] * PH + H[:, :, j]
            PA = PA * A[:, :, j]
        # the cluster: each block's carry-in, and the next window's
        c, block_in = carry, []
        for r in range(cluster):
            block_in.append(c)
            c = PA[:, r] * c + PH[:, r]
        carry = c
        # pass 2: from each sub-chunk's carry-in
        h = (torch.stack(pre_a, 2) * torch.stack(block_in, 1)[:, :, None]
             + torch.stack(pre_h, 2))
        for i in range(steps):
            h = aw[:, :, :, i] * h + bw[:, :, :, i]
            y[:, win, :, :, i] = h
    return y.reshape(B, windows * window, W)[:, :S]


def _inputs(b, s, w, seed):
    """tests/test_kernels.py::test_rglru_kernel's distributions, from
    numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32) * 0.2
    gx = rng.standard_normal((b, s, w), dtype=np.float32)
    ga = rng.standard_normal((b, s, w), dtype=np.float32)
    la = rng.standard_normal(w, dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32) * 0.1
    return x, gx, ga, la, h0


# the kernel's own plan, and spans of 5 steps x 3 sub-chunks x 4 blocks (a
# 60-step window) that divide none of the lengths
PLANS = {"kernel": None, "ragged": (5, 3, 4)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("s", [1, 31, 77, 255, 1024])
def test_chunked_model_matches_jax(plan, s):
    b, w = 2, 200
    args = _inputs(b, s, w, seed=s)
    if PLANS[plan] is None:
        steps, subchunks = SUB_STEPS, SUBCHUNKS
        cluster = launch_plan(b, s, w)["cluster"]
    else:
        steps, subchunks, cluster = PLANS[plan]
    got = chunked_model(*map(torch.from_numpy, args), steps=steps,
                        subchunks=subchunks, cluster=cluster)
    # the Pallas kernel in interpret mode, its tiles made to divide (S, W)
    kernel = jax_rglru_scan(*map(jnp.asarray, args), bb=b, bw=w,
                            bs=s if s <= 256 else 64, interpret=True)
    oracle, _ = JL.rglru(*map(jnp.asarray, args))
    assert got.shape == (b, s, w)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("s", [1, 31, 77, 255, 1024, 1025, 4096])
def test_launch_plan_spans_the_time_axis(s):
    """The fewest windows of the smallest cluster that covers S: one
    window while a cluster of at most MAX_CLUSTER blocks spans S, else
    clusters of MAX_CLUSTER."""
    plan = launch_plan(4, s, 2560)
    span = SUBCHUNKS * SUB_STEPS
    cover = plan["cluster"] * span
    assert 1 <= plan["cluster"] <= MAX_CLUSTER
    assert (plan["windows"] - 1) * cover < s <= plan["windows"] * cover
    if plan["windows"] == 1:
        assert (plan["cluster"] - 1) * span < s
    else:
        assert plan["cluster"] == MAX_CLUSTER
    assert plan["items"] == 4 * 2560 // CHANNELS
