"""A plain model of K7b's reverse chunked scan against the JAX package, on
the CPU.

``csrc/rglru.cu``'s K7b runs K7's chunked scan backward in time.  The carry
c_t = a_t g_t of the reverse recurrence g_t = dy_t + a_{t+1} g_{t+1} obeys
c_{t-1} = a_t (c_t + dy_t), so each step is the affine map (a_t, a_t dy_t).
Each block of a cluster takes ``SUBCHUNKS`` sub-chunks of ``SUB_STEPS``
steps; each sub-chunk's composite runs from its last step to its first, the
block folds the sub-chunks after each one (its suffix) in shared memory,
and its carry-in is the window's carry-in folded through the blocks after
it; the windows are walked from the last to the first.  Pass 2 walks each
sub-chunk again from its carry-in and forms the five gradients.  dlog_a is
summed in a fixed order: each thread's steps (last to first), the block's
sub-chunks, the cluster's ranks, the windows (as walked), the batch rows.

``reverse_chunked_model`` below is that decomposition in plain PyTorch, fold
for fold and sum for sum, held to ``jax.vjp`` of
``repro.models.layers.rglru`` at the kernel's plan and at a ragged one, at
``tests/test_torch_rglru_grad.py``'s tolerances (rtol 1e-4, atol 1e-5;
both sides fp32, differing only in the order of fp32 operations).  The
plan's walk is checked to cover the time axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro_torch.kernels.rglru import (C, CHANNELS, MAX_CLUSTER, SUB_STEPS,
                                       SUBCHUNKS, launch_plan,
                                       rglru_scan_plain)

RTOL, ATOL = 1e-4, 1e-5         # tests/test_torch_rglru_grad.py
NAMES = ("dx", "dgx", "dga", "dlog_a", "dh0")


def reverse_chunked_model(x, gx, ga, log_a, h0, h32, dy, *, steps, subchunks,
                          cluster):
    """K7b's gradients (dx, dgx, dga, dlog_a, dh0) through the kernel's
    decomposition: windows of ``cluster`` blocks of ``subchunks`` sub-chunks
    of ``steps`` steps, walked from the last window; past S, a = 1 and
    dy = 0.  fp32 in, fp32 out."""
    B, S, W = x.shape
    r, ig = torch.sigmoid(ga), torch.sigmoid(gx)
    sp = C * F.softplus(log_a)
    a = torch.exp(sp * r)
    e2 = torch.exp(2.0 * sp * r)
    u = 1.0 - e2
    m = torch.sqrt(torch.clamp(u, min=1e-12))
    window = cluster * subchunks * steps
    windows = -(-S // window)
    pad = windows * window - S
    shape = (B, windows, cluster, subchunks, steps, W)
    ap = torch.cat([a, torch.ones(B, pad, W)], 1).view(shape)
    dyp = torch.cat([dy, torch.zeros(B, pad, W)], 1).view(shape)
    g = torch.empty(shape)
    cw = torch.zeros(B, W)                      # the window's carry-in
    for win in reversed(range(windows)):
        aw, dw = ap[:, win], dyp[:, win]        # (B, cluster, sub, steps, W)
        # pass 1: each sub-chunk's composite, its last step first
        A = torch.ones(B, cluster, subchunks, W)
        H = torch.zeros(B, cluster, subchunks, W)
        for i in reversed(range(steps)):
            H = aw[:, :, :, i] * H + aw[:, :, :, i] * dw[:, :, :, i]
            A = A * aw[:, :, :, i]
        # each sub-chunk's suffix in its block, and the block's composite
        PA, PH = torch.ones(B, cluster, W), torch.zeros(B, cluster, W)
        suf_a, suf_h = [None] * subchunks, [None] * subchunks
        for j in reversed(range(subchunks)):
            suf_a[j], suf_h[j] = PA, PH
            PH = A[:, :, j] * PH + H[:, :, j]
            PA = PA * A[:, :, j]
        # the cluster: each block's carry-in, from the last rank, and the
        # carry-in of the window before
        c, block_in = cw, [None] * cluster
        for rank in reversed(range(cluster)):
            block_in[rank] = c
            c = PA[:, rank] * c + PH[:, rank]
        cw = c
        # pass 2: from each sub-chunk's carry-in, its last step first
        cc = (torch.stack(suf_a, 2) * torch.stack(block_in, 1)[:, :, None]
              + torch.stack(suf_h, 2))
        for i in reversed(range(steps)):
            g[:, win, :, :, i] = dw[:, :, :, i] + cc
            cc = aw[:, :, :, i] * g[:, win, :, :, i]
    g = g.reshape(B, windows * window, W)[:, :S]
    h_prev = torch.cat([h0[:, None], h32[:, :-1]], 1)
    gi = g * ig
    dL = g * h_prev * a + torch.where(u > 1e-12, -gi * x * e2 / m, 0.0)
    # dL r in the kernel's order: each thread's steps last to first, the
    # sub-chunks, the ranks, the windows as walked, the batch rows
    t = torch.cat([dL * r, torch.zeros(B, pad, W)], 1).view(shape)
    part = torch.zeros(B, windows, cluster, subchunks, W)
    for i in reversed(range(steps)):
        part = part + t[:, :, :, :, i]
    block = torch.zeros(B, windows, cluster, W)
    for j in range(subchunks):
        block = block + part[:, :, :, j]
    win_sum = torch.zeros(B, windows, W)
    for rank in range(cluster):
        win_sum = win_sum + block[:, :, rank]
    row = torch.zeros(B, W)
    for win in reversed(range(windows)):
        row = row + win_sum[:, win]
    total = torch.zeros(W)
    for b in range(B):
        total = total + row[b]
    return (gi * m, gi * m * x * (1.0 - ig), dL * sp * r * (1.0 - r),
            C * torch.sigmoid(log_a) * total, a[:, 0] * g[:, 0])


def _inputs(b, s, w, seed):
    """tests/test_torch_rglru_grad.py's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32) * 0.2
    gx = rng.standard_normal((b, s, w), dtype=np.float32)
    ga = rng.standard_normal((b, s, w), dtype=np.float32)
    la = rng.standard_normal(w, dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32) * 0.1
    dseq = rng.standard_normal((b, s, w), dtype=np.float32)
    dlast = rng.standard_normal((b, w), dtype=np.float32)
    return (x, gx, ga, la, h0), dseq, dlast


def _jax_vjp(args, dseq, dlast):
    """(dx, dgx, dga, dlog_a, dh0) of layers.rglru, jitted."""
    def run(cot, *a):
        _, vjp = jax.vjp(lambda *b: JL.rglru(*b), *a)
        return vjp(cot)

    cot = (jnp.asarray(dseq), jnp.asarray(dlast))
    return jax.jit(run)(cot, *map(jnp.asarray, args))


# the kernel's own plan, and spans of 5 steps x 3 sub-chunks x 4 blocks (a
# 60-step window) that divide none of the lengths
PLANS = {"kernel": None, "ragged": (5, 3, 4)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("s", [1, 31, 77, 255, 1025])
def test_reverse_chunked_model_matches_jax_vjp(plan, s):
    b, w = 2, 40
    args, dseq, dlast = _inputs(b, s, w, seed=s)
    if PLANS[plan] is None:
        steps, subchunks = SUB_STEPS, SUBCHUNKS
        cluster = launch_plan(b, s, w)["cluster"]
    else:
        steps, subchunks, cluster = PLANS[plan]
    want = _jax_vjp(args, dseq, dlast)
    x, gx, ga, la, h0 = map(torch.from_numpy, args)
    _, h32 = rglru_scan_plain(x, gx, ga, la, h0, keep_states=True)
    dy = torch.from_numpy(dseq).clone()
    dy[:, -1] += torch.from_numpy(dlast)      # h_last is the last step's
    got = reverse_chunked_model(x, gx, ga, la, h0, h32, dy, steps=steps,
                                subchunks=subchunks, cluster=cluster)
    for name, gg, ww in zip(NAMES, got, want):
        assert gg.dtype == torch.float32 and gg.shape == ww.shape, name
        # dlog_a, a sum of B x S terms, at rtol 1e-4 of its size
        atol = (RTOL * float(np.abs(np.asarray(ww)).max())
                if name == "dlog_a" else ATOL)
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), rtol=RTOL,
                                   atol=max(atol, ATOL), err_msg=name)


def walk(B, S, W):
    """The steps K7b visits for one item, as (window, rank, sub-chunk,
    step, t) in the order a cluster walks its units: windows from the last,
    each rank's block, each warp's sub-chunk, each thread's steps from the
    last."""
    plan = launch_plan(B, S, W)
    R, span = plan["cluster"], SUBCHUNKS * SUB_STEPS
    out = []
    for win in reversed(range(plan["windows"])):
        for rank in range(R):
            for j in range(SUBCHUNKS):
                for i in reversed(range(SUB_STEPS)):
                    t = (win * R + rank) * span + j * SUB_STEPS + i
                    out.append((win, rank, j, i, t))
    return plan, out


@pytest.mark.parametrize("s", [1, 31, 77, 255, 256, 257, 1025, 4096])
def test_bwd_walk_covers_the_time_axis(s):
    """Every step of [0, S) once, the windows from the last to the first
    (the carry flows from later steps to earlier), the cluster as K7's, and
    every (batch row, channel tile) an item."""
    plan, steps = walk(4, s, 2560)
    ts = [t for *_, t in steps]
    assert sorted(ts) == list(range(len(ts)))
    assert s <= len(ts) and len(ts) - s < plan["cluster"] * SUBCHUNKS * SUB_STEPS
    wins = [w for w, *_ in steps]
    assert wins == sorted(wins, reverse=True)
    assert 1 <= plan["cluster"] <= MAX_CLUSTER
    assert plan["items"] == 4 * -(-2560 // CHANNELS)
