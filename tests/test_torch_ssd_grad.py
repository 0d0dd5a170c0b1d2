"""The gradient of the port's SSD scan (K8b's plain version, ``SSDScan``)
and of the Mamba-2 block's other layers against the JAX package, on the
CPU.

``ssd_scan_bwd_plain`` is ``torch.autograd.grad`` through
``ssd_scan_plain``; the JAX package has no kernel for this gradient and
differentiates ``repro.models.layers.ssd_chunked``, so the same numpy
inputs and cotangents (dy, dstate) go through ``jax.vjp`` of that function.
Both sides are fp32 on one CPU and differ only in the order of fp32 sums
(a chunk-by-chunk carry against an associative scan), hence rtol 1e-4,
atol 1e-5.  The reference's own gradient is NaN in ddt and dA for a head
whose decay within one chunk exceeds the fp32 range: ``ssd_chunked`` takes
``exp`` of the whole (Q, Q) difference matrix before masking its upper
triangle with ``jnp.where``, whose gradient is then 0 * inf.  The port
masks before ``exp``.  Where the reference is NaN, the port is held to the
step-by-step recurrence differentiated in float64, by relative Frobenius
error (dA sums a few hundred terms that cancel).  ``ops.ssd`` goes through ``SSDScan`` whenever autograd needs
it; on the CPU its two directions are the plain versions, so its gradients
are those of autograd through ``ssd_scan_plain``.  The CUDA kernel K8b is
held to ``ssd_scan_bwd_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here only its argument checks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.ssd import (SSDScan, ssd_scan_bwd,
                                     ssd_scan_bwd_plain, ssd_scan_plain)
from repro_torch.models import layers as L

RTOL, ATOL = 1e-4, 1e-5
# tests/test_kernels.py::test_ssd_kernel's three shapes (B, S, H, P, G, N, Q)
SHAPES = [(2, 128, 4, 32, 2, 16, 32), (1, 256, 2, 16, 1, 8, 64),
          (2, 64, 4, 16, 4, 16, 64)]
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")


def _inputs(b, s, h, p, g, n, seed=0):
    """test_ssd_kernel's distributions, h0, and the cotangents, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.4
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.4).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32) * 0.5
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32) * 0.1
    return (x, dt, A, Bm, Cm, h0), dy, dstate


def _jax_vjp(args, dy, dstate, chunk, with_h0=True):
    x, dt, A, Bm, Cm, h0 = map(jnp.asarray, args)

    def f(x, dt, A, Bm, Cm, h0):
        return JL.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                              h0=h0 if with_h0 else None)

    _, vjp = jax.vjp(f, x, dt, A, Bm, Cm, h0)
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_bwd_plain_matches_jax_vjp(b, s, h, p, g, n, chunk):
    args, dy, dstate = _inputs(b, s, h, p, g, n)
    t = [torch.from_numpy(a) for a in args]
    got = ssd_scan_bwd_plain(*t, torch.from_numpy(dy),
                             torch.from_numpy(dstate), chunk=chunk)
    want = _jax_vjp(args, dy, dstate, chunk)
    for name, gg, ww, a in zip(NAMES, got, want, args):
        assert gg.dtype == torch.float32 and gg.shape == a.shape, name
        _close(gg, ww, name)


def _float64_grads(args, dy):
    """Autograd of the step-by-step recurrence (S_t = a_t S_{t-1} + dt_t x_t
    B_t^T, y_t = S_t C_t) in float64: (dx, ddt, dA, dBm, dCm)."""
    ins = [torch.from_numpy(a).double().requires_grad_() for a in args[:5]]
    x, dt, A, Bm, Cm = ins
    rep = x.shape[2] // Bm.shape[2]
    st = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[3],
                     dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t] * A)
        Bh = Bm[:, t].repeat_interleave(rep, 1)
        Ch = Cm[:, t].repeat_interleave(rep, 1)
        st = (a[..., None, None] * st + dt[:, t][..., None, None]
              * x[:, t][..., None] * Bh[:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch))
    y = torch.stack(ys, 1)
    return torch.autograd.grad(y, ins, torch.from_numpy(dy).double())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES[:2])
def test_bwd_plain_without_h0_and_dstate(b, s, h, p, g, n, chunk):
    """h0 None is zeros (its gradient still comes back) and dstate None
    adds nothing, as a zero cotangent does in JAX.  At (1, 256, 2, ...) the
    reference's ddt and dA are NaN for one head (see the module's
    docstring): that gradient is held to the float64 recurrence instead."""
    args, dy, _ = _inputs(b, s, h, p, g, n, seed=1)
    zero_h0 = (*args[:5], np.zeros_like(args[5]))
    t = [torch.from_numpy(a) for a in args[:5]]
    got = ssd_scan_bwd_plain(*t, None, torch.from_numpy(dy), None,
                             chunk=chunk)
    want = _jax_vjp(zero_h0, dy, np.zeros_like(args[5]), chunk,
                    with_h0=False)
    exact = None
    for i, (name, gg, ww) in enumerate(zip(NAMES[:5], got, want)):
        assert torch.isfinite(gg).all(), name
        ww = np.asarray(ww)
        nan = np.isnan(ww)
        if not nan.any():
            _close(gg, ww, name)
            continue
        assert name in ("ddt", "dA"), name
        np.testing.assert_allclose(gg.numpy()[~nan], ww[~nan], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        exact = exact or _float64_grads(args, dy)
        rel = ((gg.double() - exact[i]).norm() / exact[i].norm()).item()
        assert rel <= RTOL, (name, rel)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssdscan_on_the_cpu_is_autograd_through_the_plain_scan(
        b, s, h, p, g, n, chunk, with_h0):
    args, dy, dstate = _inputs(b, s, h, p, g, n, seed=2)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    h0 = ins[5] if with_h0 else None
    y, hf = ops.ssd(*ins[:5], chunk=chunk, h0=h0)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad(
        [y, hf], ins[:5] + ([h0] if with_h0 else []),
        [torch.from_numpy(dy), torch.from_numpy(dstate)])
    ref_ins = [torch.from_numpy(a).requires_grad_() for a in args]
    yr, hr = ssd_scan_plain(*ref_ins[:5], chunk=chunk,
                            h0=ref_ins[5] if with_h0 else None)
    want = torch.autograd.grad(
        [yr, hr], ref_ins[:5] + ([ref_ins[5]] if with_h0 else []),
        [torch.from_numpy(dy), torch.from_numpy(dstate)])
    assert torch.equal(y.detach(), yr.detach())
    for name, gg, ww in zip(NAMES, got, want):
        assert torch.equal(gg, ww), name


def test_ssdscan_with_only_y_used():
    """A loss of y alone (the model drops the final state): the state's
    gradient is None, and SSDScan treats it as zero."""
    args, dy, _ = _inputs(2, 64, 4, 16, 2, 8, seed=3)
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y, _ = SSDScan.apply(*ins, None, 32)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), ins)
    want = ssd_scan_bwd_plain(*[a.detach() for a in ins], None,
                              torch.from_numpy(dy), None, chunk=32)
    for name, gg, ww in zip(NAMES, got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-6, atol=1e-7, msg=name)


def test_ops_ssd_without_grad_is_the_plain_scan():
    """Serving is unchanged: no grad needed, no autograd.Function."""
    args, _, _ = _inputs(1, 64, 2, 16, 1, 8)
    t = [torch.from_numpy(a) for a in args]
    y, hf = ops.ssd(*t[:5], chunk=32, h0=t[5])
    assert y.grad_fn is None
    yr, hr = ssd_scan_plain(*t[:5], chunk=32, h0=t[5])
    assert torch.equal(y, yr) and torch.equal(hf, hr)
    with torch.no_grad():
        y2, _ = ops.ssd(*[a.requires_grad_() for a in t[:5]], chunk=32)
    assert y2.grad_fn is None


def test_bwd_plain_keeps_bf16_dtypes():
    args, dy, dstate = _inputs(1, 64, 2, 16, 1, 8, seed=4)
    x, dt, A, Bm, Cm, h0 = [torch.from_numpy(a) for a in args]
    got = ssd_scan_bwd_plain(x.bfloat16(), dt, A, Bm.bfloat16(),
                             Cm.bfloat16(), h0, torch.from_numpy(dy).bfloat16(),
                             torch.from_numpy(dstate), chunk=32)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]


def test_ssd_scan_bwd_refuses_cpu_tensors_and_bad_arguments():
    args, dy, dstate = _inputs(1, 64, 4, 16, 2, 8)
    x, dt, A, Bm, Cm, h0 = [torch.from_numpy(a) for a in args]
    dy, dstate = torch.from_numpy(dy), torch.from_numpy(dstate)
    states = torch.zeros(1, 4, 1, 16, 8)
    before = ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=32,
                     states=states)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=48,
                     states=states)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan_bwd(x, dt, A[:3], Bm, Cm, h0, dy, dstate, chunk=32,
                     states=states)
    with pytest.raises(TypeError, match="differ in dtype"):
        ssd_scan_bwd(x.bfloat16(), dt, A, Bm, Cm, h0, dy, dstate, chunk=32,
                     states=states)
    with pytest.raises(TypeError, match="states"):   # K8's kept states
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=32)
    assert ssd_scan_bwd.launches == before


# ---- the chunk-parallel split of K8 and K8b, modelled in plain PyTorch ----
# csrc/ssd.cu spreads the chunks of one (batch row, head) over a cluster of
# blocks: block k takes a run of chunks, forms its run-local state (or, in
# the backward, its run-local gradient Delta) from zero, and the state
# entering its run is the decayed prefix over the runs before it (the
# gradient leaving it the decayed suffix over the runs after it).  K8b sums
# dB and dC over the heads a block takes.  The model below is that algebra
# at small sizes (chunks of T rows, clusters of up to CLUSTER blocks), held
# to the JAX package, so that a derivation error shows before the card.

SPLIT_T, SPLIT_CLUSTER = 16, 4
# (B, S, H, P, G, N, heads a block, the reference's chunk): several runs
# with a ragged last chunk (S 102: 7 chunks of 16, runs of 2, the last run
# one chunk) and H / G = 3 heads in blocks of 2 and 1; S < T; runs of 1.
SPLIT_SHAPES = [(2, 102, 6, 8, 2, 4, 2, 34), (1, 12, 2, 8, 1, 8, 2, 12),
                (1, 64, 4, 4, 2, 8, 1, 32)]


def _plan(S):
    nc = -(-S // SPLIT_T)
    run = -(-nc // SPLIT_CLUSTER)
    return nc, run, -(-nc // run)


def _chunks(x, dt, A, Bm, Cm, dy=None):
    """Per chunk of SPLIT_T rows (zeros past S): x, dy, B, C by head, dt,
    cum (the running sum of dt A), its last value cl, the masked decays
    L[b, i, j, h] (masked before exp), exp(cum) and exp(cl - cum)."""
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    nc = -(-S // SPLIT_T)
    pad = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, nc * SPLIT_T - S))
    Bh, Ch = (pad(t.repeat_interleave(rep, dim=2)) for t in (Bm, Cm))
    xs, dts = pad(x), pad(dt)
    dys = pad(dy) if dy is not None else None
    upper = ~torch.ones(SPLIT_T, SPLIT_T, dtype=torch.bool).tril()
    out = []
    for c in range(nc):
        r = slice(c * SPLIT_T, (c + 1) * SPLIT_T)
        cum = torch.cumsum(dts[:, r] * A, dim=1)
        cl = cum[:, -1]
        diff = (cum[:, :, None] - cum[:, None, :]).masked_fill(
            upper[None, :, :, None], float("-inf"))
        out.append(dict(x=xs[:, r], dy=None if dys is None else dys[:, r],
                        B=Bh[:, r], C=Ch[:, r], dt=dts[:, r], cum=cum, cl=cl,
                        L=torch.exp(diff), ecum=torch.exp(cum),
                        el=torch.exp(cl[:, None] - cum)))
    return out


def _local_state(ch, st):
    """exp(cl) st + sum_j exp(cl - cum_j) dt_j x_j B_j^T."""
    return (torch.exp(ch["cl"])[..., None, None] * st + torch.einsum(
        "bjhp,bjhn->bhpn", ch["x"] * (ch["dt"] * ch["el"])[..., None],
        ch["B"]))


def _split_forward(x, dt, A, Bm, Cm, h0):
    """K8's split: (y, final state, the state entering each chunk)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    chunks = _chunks(x, dt, A, Bm, Cm)
    nc, run, R = _plan(S)
    runs = [range(k * run, min(nc, (k + 1) * run)) for k in range(R)]
    zero = torch.zeros(Bsz, H, P, N)
    loc, ld = [], []
    for k in range(R):                        # each block, independently
        st, l = zero, torch.zeros(Bsz, H)
        for c in runs[k]:
            st = _local_state(chunks[c], st)
            l = l + chunks[c]["cl"]
        loc.append(st)
        ld.append(l)
    ys, states = [], []
    for k in range(R):
        st = zero if h0 is None else h0       # the decayed prefix
        for j in range(k):
            st = torch.exp(ld[j])[..., None, None] * st + loc[j]
        for c in runs[k]:
            ch = chunks[c]
            states.append(st)
            W = (torch.einsum("bihn,bjhn->bijh", ch["C"], ch["B"]) * ch["L"]
                 * ch["dt"][:, None])
            ys.append(torch.einsum("bijh,bjhp->bihp", W, ch["x"])
                      + ch["ecum"][..., None]
                      * torch.einsum("bihn,bhpn->bihp", ch["C"], st))
            st = _local_state(ch, st)
    return torch.cat(ys, 1)[:, :S], st, torch.stack(states, 2)


def _split_backward(x, dt, A, Bm, Cm, states, dy, dstate, hpb):
    """K8b's split from K8's kept chunk states: (dx, ddt, dA, dBm, dCm,
    dh0), dB and dC summed over blocks of ``hpb`` heads of a group, then
    over the blocks."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    chunks = _chunks(x, dt, A, Bm, Cm, dy)
    nc, run, R = _plan(S)
    runs = [range(k * run, min(nc, (k + 1) * run)) for k in range(R)]
    g_in = lambda ch, g: (torch.exp(ch["cl"])[..., None, None] * g
                          + torch.einsum("bihp,bihn->bhpn",
                                         ch["dy"] * ch["ecum"][..., None],
                                         ch["C"]))
    zero = torch.zeros(Bsz, H, P, N)
    delta, ld = [], []
    for k in range(R):                        # run-local gradients
        g, l = zero, torch.zeros(Bsz, H)
        for c in reversed(runs[k]):
            g = g_in(chunks[c], g)
            l = l + chunks[c]["cl"]
        delta.append(g)
        ld.append(l)
    dx, ddt = torch.zeros(Bsz, nc * SPLIT_T, H, P), torch.zeros(
        Bsz, nc * SPLIT_T, H)
    dB_h, dC_h = (torch.zeros(Bsz, nc * SPLIT_T, H, N) for _ in range(2))
    dA = torch.zeros(H)
    for k in range(R):
        g = zero if dstate is None else dstate   # the decayed suffix
        for j in range(R - 1, k, -1):
            g = torch.exp(ld[j])[..., None, None] * g + delta[j]
        for c in reversed(runs[k]):
            ch, s_in = chunks[c], states[:, :, c]
            r = slice(c * SPLIT_T, (c + 1) * SPLIT_T)
            d, el, ecum = ch["dt"], ch["el"], ch["ecum"]
            M = torch.einsum("bihn,bjhn->bijh", ch["C"], ch["B"]) * ch["L"]
            DX = torch.einsum("bihp,bjhp->bijh", ch["dy"], ch["x"])
            Q = ch["L"] * DX
            Rp = M * DX
            BG = torch.einsum("bihn,bhpn->bihp", ch["B"], g)
            u = (ch["x"] * BG).sum(-1)
            v = (ch["dy"] * torch.einsum("bihn,bhpn->bihp", ch["C"],
                                         s_in)).sum(-1)
            w = (g * s_in).sum((-2, -1))
            rowR = torch.einsum("bijh,bjh->bih", Rp, d)
            colR = Rp.sum(1)
            dcum = rowR - d * colR + ecum * v - el * d * u
            dcum[:, -1] += (torch.exp(ch["cl"]) * w
                            + (el * d * u).sum(1))
            suffix = dcum.flip(1).cumsum(1).flip(1)
            ddt[:, r] = colR + el * u + A * suffix
            dA = dA + (d * suffix).sum((0, 1))
            dx[:, r] = d[..., None] * (el[..., None] * BG + torch.einsum(
                "bith,bihp->bthp", M, ch["dy"]))
            dC_h[:, r] = (ecum[..., None] * torch.einsum(
                "bthp,bhpn->bthn", ch["dy"], s_in) + torch.einsum(
                "btjh,bjhn->bthn", Q * d[:, None], ch["B"]))
            dB_h[:, r] = d[..., None] * (el[..., None] * torch.einsum(
                "bthp,bhpn->bthn", ch["x"], g) + torch.einsum(
                "bith,bihn->bthn", Q, ch["C"]))
            g = g_in(ch, g)
        if k == 0:
            dh0 = g                           # the first run's block
    # per block of heads, then over the blocks of a group
    blocks = [(grp * HG + lo, grp * HG + min(HG, lo + hpb))
              for grp in range(G) for lo in range(0, HG, hpb)]
    per_block = lambda t: torch.stack(
        [t[:, :, a:e].sum(2) for a, e in blocks], 2)
    per_group = lambda t: per_block(t)[:, :S].view(
        Bsz, S, G, -(-HG // hpb), N).sum(3)
    return (dx[:, :S], ddt[:, :S], dA, per_group(dB_h), per_group(dC_h),
            dh0)


@pytest.mark.parametrize("b,s,h,p,g,n,hpb,chunk", SPLIT_SHAPES)
def test_chunk_parallel_split_matches_jax(b, s, h, p, g, n, hpb, chunk):
    """The split's forward against the JAX package's Pallas kernel
    (interpret mode) and ssd_chunked with h0; its backward, from the
    chunk states its forward kept, against jax.vjp of ssd_chunked, with h0
    and dstate, at this file's tolerances."""
    from repro.kernels.ssd import ssd_scan as pallas_ssd_scan
    args, dy, dstate = _inputs(b, s, h, p, g, n, seed=6)
    t = [torch.from_numpy(a) for a in args]
    y, hf, _ = _split_forward(*t[:5], None)
    yj, hj = pallas_ssd_scan(*map(jnp.asarray, args[:5]), chunk=chunk,
                             interpret=True)
    _close(y, yj, "y (Pallas)")
    _close(hf, hj, "final state (Pallas)")
    y, hf, states = _split_forward(*t)
    yj, hj = JL.ssd_chunked(*map(jnp.asarray, args[:5]), chunk=chunk,
                            h0=jnp.asarray(args[5]))
    _close(y, yj, "y (ssd_chunked, h0)")
    _close(hf, hj, "final state (ssd_chunked, h0)")
    assert torch.equal(states[:, :, 0], t[5])
    got = _split_backward(*t[:5], states, torch.from_numpy(dy),
                          torch.from_numpy(dstate), hpb)
    want = _jax_vjp(args, dy, dstate, chunk)
    for name, gg, ww, a in zip(NAMES, got, want, args):
        assert gg.shape == a.shape, name
        _close(gg, ww, name)


# ---- the rest of the Mamba block: nothing in place, gradients as in JAX ---

def test_causal_conv1d_and_rms_norm_gradients_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32) * 0.1
    sc = rng.standard_normal(24, dtype=np.float32) * 0.1
    cot = rng.standard_normal((2, 9, 24), dtype=np.float32)

    def jf(x, w, sc):
        y, _ = JL.causal_conv1d(x, w)
        return JL.rms_norm(jax.nn.silu(y), sc)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, (x, w, sc)))
    want = vjp(jnp.asarray(cot))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w, sc)]
    y, _ = L.causal_conv1d(ins[0], ins[1])
    out = L.rms_norm(torch.nn.functional.silu(y), ins[2])
    got = torch.autograd.grad(out, ins, torch.from_numpy(cot))
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), rtol=1e-5,
                                   atol=1e-6)
