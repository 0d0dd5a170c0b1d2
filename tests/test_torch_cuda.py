"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit; elsewhere they
skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
fp32 products run without TF32 so that the plain versions are fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.core import lindley as core_lindley
from repro_torch.core.arrivals import PoissonProcess
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.function import standard_pipeline
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lindley import lindley_scan, lindley_scan_plain
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
from repro_torch.kernels.ssd import (ssd_scan, ssd_scan_bwd,
                                     ssd_scan_bwd_plain, ssd_scan_plain)
from repro_torch.kernels.systolic_matmul import (_ACTS, systolic_matmul,
                                                 systolic_matmul_plain)
from repro_torch.kernels.vector_engine import (dequantize_int8,
                                               dequantize_int8_plain,
                                               fused_affine_act,
                                               fused_affine_act_plain,
                                               quantize_int8,
                                               quantize_int8_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 147, 53), (1, 1, 1),
                                   (300, 576, 64), (49, 4608, 512),
                                   (49, 100, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", list(_ACTS))
def test_systolic_matmul_matches_plain(cuda, m, k, n, dtype, act):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, (m, k), dtype, cuda), _randn(rng, (k, n), dtype, cuda)
    b = _randn(rng, (n,), dtype, cuda)
    before = systolic_matmul.launches
    got = systolic_matmul(x, w, b, act=act)
    assert systolic_matmul.launches == before + 1
    want = systolic_matmul_plain(x, w, b, act=act)
    bf = dtype == torch.bfloat16
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-4,
                               atol=(2e-2 if bf else 2e-4) * max(1, k // 64))


@pytest.mark.parametrize("m,n", [(1, 150528), (256, 1024), (3, 7)])
@pytest.mark.parametrize("act", list(_ACTS))
def test_fused_affine_act_matches_plain(cuda, m, n, act):
    rng = np.random.default_rng(1)
    x = _randn(rng, (m, n), torch.float32, cuda)
    s, b = (_randn(rng, (n,), torch.float32, cuda) for _ in range(2))
    torch.testing.assert_close(fused_affine_act(x, s, b, act=act),
                               fused_affine_act_plain(x, s, b, act=act),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,kv,sq,skv,d", [
    (2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 128, 32), (1, 4, 4, 17, 17, 32),
    (2, 4, 2, 100, 70, 128), (1, 2, 2, 50, 40, 16)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48),
                                           (False, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, b, h, kv, sq, skv, d, causal,
                                       window, dtype):
    rng = np.random.default_rng(2)
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k, v = (_randn(rng, (b, kv, skv, d), dtype, cuda) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-3,
                               atol=0.03 if bf else 2e-4)


# The 20 distinct (M, K, N) of the 53 GEMMs of one ResNet-50 request at
# 224x224, batch 1 (im2col convolutions).
REQUEST_SHAPES = [
    (12544, 147, 64), (3136, 64, 256), (3136, 64, 64), (3136, 576, 64),
    (3136, 256, 64), (3136, 256, 128), (784, 256, 512), (784, 1152, 128),
    (784, 128, 512), (784, 512, 128), (784, 512, 256), (196, 512, 1024),
    (196, 2304, 256), (196, 256, 1024), (196, 1024, 256), (196, 1024, 512),
    (49, 1024, 2048), (49, 4608, 512), (49, 512, 2048), (49, 2048, 512)]


def tf32_split(a: torch.Tensor):
    """fp32 -> (hi, lo) as K1 splits it: hi is a with its low 13 mantissa
    bits cleared (TF32 by truncation), lo is a - hi cleared the same way."""
    hi = (a.view(torch.int32) & -8192).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def tf32_product(x: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """x @ w in fp32 from TF32 operands: one product (1xTF32) or K1's three
    (3xTF32: hi.hi + hi.lo + lo.hi)."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    if terms == 1:
        return xh @ wh
    return xl @ wh + xh @ wl + xh @ wh


def rel_frobenius(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _k1_close(got, want, k):
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=2e-4 * max(1, k // 64))


@pytest.mark.parametrize("m,k,n", REQUEST_SHAPES)
def test_systolic_matmul_request_shapes_match_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = _randn(rng, (m, k), torch.float32, cuda), \
        _randn(rng, (k, n), torch.float32, cuda)
    _k1_close(systolic_matmul(x, w), systolic_matmul_plain(x, w), k)


def test_systolic_matmul_is_3xtf32_not_1xtf32(cuda):
    """At N(0, 1) inputs one TF32 product is off by ~7.7e-4 (relative
    Frobenius, against fp64); K1's three products by ~5e-7."""
    rng = np.random.default_rng(17)
    m, k, n = 196, 2304, 256
    x, w = _randn(rng, (m, k), torch.float32, cuda), \
        _randn(rng, (k, n), torch.float32, cuda)
    exact = x.double() @ w.double()
    assert rel_frobenius(systolic_matmul(x, w), exact) < 1e-5
    assert rel_frobenius(tf32_product(x, w, 1), exact) > 1e-4


@pytest.mark.parametrize("m,k,n", [(37, 147, 53), (196, 2304, 256),
                                   (49, 4608, 512)])
def test_systolic_matmul_non_finite_as_plain(cuda, m, k, n):
    """Exactly the plain version's non-finite outputs are non-finite; NaN
    may stand for +-inf (a cross term inf * lo with lo = 0)."""
    rng = np.random.default_rng(5)
    x, w = _randn(rng, (m, k), torch.float32, cuda), \
        _randn(rng, (k, n), torch.float32, cuda)
    x[3, 5] = float("inf")
    x[7, k - 1] = float("nan")
    w[k // 2, 2] = -float("inf")
    got, want = systolic_matmul(x, w), systolic_matmul_plain(x, w)
    bad = ~torch.isfinite(want)
    assert bad.any() and torch.equal(~torch.isfinite(got), bad)
    assert torch.isnan(got[torch.isnan(want)]).all()
    inf = torch.isinf(want)
    assert ((got[inf] == want[inf]) | torch.isnan(got[inf])).all()
    _k1_close(got[~bad], want[~bad], k)


def test_systolic_matmul_split_k_repeats_bit_for_bit(cuda):
    from repro_torch.kernels.systolic_matmul import tile_plan
    m, k, n = 49, 4608, 512
    assert tile_plan(m, k, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count)[2] > 1
    rng = np.random.default_rng(3)
    x, w = _randn(rng, (m, k), torch.float32, cuda), \
        _randn(rng, (k, n), torch.float32, cuda)
    assert torch.equal(systolic_matmul(x, w), systolic_matmul(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_systolic_matmul_takes_views_at_a_4_byte_offset(cuda, dtype):
    """K = 147 and bases 4 bytes off 16: the element-wise load path."""
    rng = np.random.default_rng(11)
    m, k, n = 300, 147, 130
    skip = 4 // torch.tensor([], dtype=dtype).element_size()
    fx = _randn(rng, (m * k + skip,), dtype, cuda)
    fw = _randn(rng, (k * n + skip,), dtype, cuda)
    x, w = fx[skip:].view(m, k), fw[skip:].view(k, n)
    assert x.data_ptr() % 16 == 4 and w.data_ptr() % 16 == 4
    got = systolic_matmul(x, w, act="relu")
    want = systolic_matmul_plain(x, w, act="relu")
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-4,
                               atol=(2e-2 if bf else 2e-4) * max(1, k // 64))


@pytest.mark.parametrize("m,k,n", [(37, 147, 53), (300, 576, 64),
                                   (196, 2304, 256), (49, 4608, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_systolic_matmul_takes_a_k_major_w(cuda, m, k, n, dtype):
    """w as the transpose of a contiguous (N, K) tensor, as models/vision.py
    hands over a 3x3 or 7x7 convolution's weight, straight to the kernel."""
    rng = np.random.default_rng(13)
    x = _randn(rng, (m, k), dtype, cuda)
    w = _randn(rng, (n, k), dtype, cuda).t()
    b = _randn(rng, (n,), dtype, cuda)
    assert not w.is_contiguous()
    before = systolic_matmul.launches
    got = ops.matmul(x, w, b, act="silu")
    assert systolic_matmul.launches == before + 1
    want = systolic_matmul_plain(x, w, b, act="silu")
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-4,
                               atol=(2e-2 if bf else 2e-4) * max(1, k // 64))


def test_systolic_matmul_is_one_launch_without_a_reduce(cuda):
    """Split-K is summed inside the launch: the profiler sees one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    x, w = _randn(rng, (49, 4608), torch.float32, cuda), \
        _randn(rng, (4608, 512), torch.float32, cuda)
    systolic_matmul(x, w)                          # built and loaded
    torch.cuda.synchronize()
    before = systolic_matmul.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        systolic_matmul(x, w)
        torch.cuda.synchronize()
    assert systolic_matmul.launches == before + 1
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "matmul_kernel" in kernels[0].name, \
        [e.name for e in kernels]


def test_ops_launch_kernels_for_cuda_tensors(cuda):
    x = torch.ones((4, 8), device=cuda)
    w = torch.ones((8, 3), device=cuda)
    counts = (systolic_matmul.launches, fused_affine_act.launches,
              flash_attention.launches)
    ops.matmul_padded(x, w)
    ops.affine_act(x, torch.ones(8, device=cuda), torch.zeros(8, device=cuda))
    q = torch.ones((1, 1, 4, 16), device=cuda)
    ops.attention(q, q, q)
    assert (systolic_matmul.launches, fused_affine_act.launches,
            flash_attention.launches) == tuple(c + 1 for c in counts)


def _queues(rng, r, w):
    """Sorted arrivals and service demands, each row zero-padded past a
    random length, as the solver's length buckets hand them over."""
    t = np.sort(rng.uniform(0.0, 1e3, size=(r, w)), axis=1)
    s = rng.uniform(1e-4, 2.0, size=(r, w))
    lens = rng.integers(w // 2 + 1, w + 1, size=r)
    pad = np.arange(w)[None, :] >= lens[:, None]
    t[pad] = 0.0
    s[pad] = 0.0
    return t, s


@pytest.mark.parametrize("r,w", [(3, 17), (128, 1024), (257, 4096),
                                 (1, 1 << 19), (65, 1), (1, 1)])
def test_lindley_scan_bytes_equal_plain_on_cpu(cuda, r, w):
    """torch.cumsum on the card re-associates, so the plain version is run
    on a CPU copy, where it gives numpy's bytes."""
    t, s = _queues(np.random.default_rng(r * 7 + w), r, w)
    before = lindley_scan.launches
    got = lindley_scan(torch.from_numpy(t).to(cuda),
                       torch.from_numpy(s).to(cuda))
    torch.cuda.synchronize()
    assert lindley_scan.launches == before + 1
    want = lindley_scan_plain(torch.from_numpy(t), torch.from_numpy(s))
    assert got.dtype == torch.float64
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


def test_solver_cuda_bytes_equal_segmented_on_zipf(cuda):
    rng = np.random.default_rng(0)
    n, nserv = 200_000, 128
    p = np.arange(1, nserv + 1, dtype=np.float64) ** -1.2
    p /= p.sum()
    keys = np.sort(rng.choice(nserv, size=n, p=p))
    t = np.sort(rng.uniform(0.0, n / 1e4, size=n))
    s = rng.uniform(1e-4, 2e-3, size=n)
    seg = core_lindley.segment_fenceposts(keys, 0, nserv)
    out = {}
    before = lindley_scan.launches
    for backend in ("segmented", "cuda"):
        start, fin = np.empty(n), np.empty(n)
        core_lindley.solve_segments(seg, t, s, start, fin, backend=backend)
        out[backend] = (start.tobytes(), fin.tobytes())
    assert lindley_scan.launches > before
    assert out["cuda"] == out["segmented"]


def test_fleet_cuda_bytes_equal_segmented(cuda):
    pipes = [standard_pipeline(n) for n in ("asset_damage",
                                            "content_moderation")]
    runs = {}
    for backend in ("segmented", "cuda"):
        eng = ClusterEngine(n_dscs=64, n_cpu=64, hedge_budget_s=0.08, seed=0)
        before = lindley_scan.launches
        tr = eng.run_sharded(pipes, arrivals=PoissonProcess(rate=1600.0),
                             duration_s=3.0, n_shards=2, processes=1,
                             backend=backend)
        runs[backend] = (eng, tr, lindley_scan.launches - before)
    (es, ts, n_seg), (ec, tc, n_cuda) = runs["segmented"], runs["cuda"]
    assert ec.last_shard_stats["path"] == "partitioned"
    assert n_seg == 0 and n_cuda > 0
    for col in ("arrival", "finish", "winner", "drive", "start", "service",
                "hedged", "dscs_finish", "cpu_finish"):
        assert getattr(ts, col).tobytes() == getattr(tc, col).tobytes(), col
    assert ts.events == tc.events
    assert es._qstate == ec._qstate and es._pstate == ec._pstate
    assert dict(es.telemetry.counters) == dict(ec.telemetry.counters)


def _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed=0):
    """tests/test_kernels.py::test_ssd_kernel's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape,
                                                           dtype=np.float32))
    x = (f(b, s, h, p) * 0.4).to(dev, dtype)
    dt = torch.nn.functional.softplus(f(b, s, h)).to(dev)
    A = -torch.exp(f(h) * 0.4).to(dev)
    Bm = (f(b, s, g, n) * 0.3).to(dev, dtype)
    Cm = (f(b, s, g, n) * 0.3).to(dev, dtype)
    return x, dt, A, Bm, Cm


# the edges of the kernels' cluster of chunks: S < 64 (1 and 17 rows), 9
# chunks (runs of 2 over 5 blocks), 64 chunks (runs of 8 over 8 blocks),
# H / G = 3 heads in K8b's blocks of 2 (bf16), N of 8, 16 and 32
SSD_EDGES = [(1, 1, 2, 16, 1, 16, 1), (2, 17, 4, 32, 2, 8, 17),
             (1, 576, 4, 64, 1, 32, 64), (1, 4096, 4, 64, 1, 16, 256),
             (2, 320, 6, 64, 2, 32, 64)]
# tests/test_kernels.py::test_ssd_kernel's shapes, a ragged 63-row tail, a
# P wider than one tile, Mamba-2 370M's layer at batch 1, and the edges
SSD_SHAPES = [(2, 128, 4, 32, 2, 16, 32), (1, 256, 2, 16, 1, 8, 64),
              (2, 64, 4, 16, 4, 16, 64), (2, 255, 4, 64, 1, 128, 256),
              (1, 96, 2, 80, 2, 32, 96),
              (1, 1024, 32, 64, 1, 128, 256)] + SSD_EDGES


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype,
                                with_h0):
    """y within rtol 1e-3 (fp32; tests/test_kernels.py's bar) or one bf16
    rounding (1e-2), the fp32 state within 1e-3: the kernel walks 64-row
    chunks, the plain version the caller's, so only fp32 sums differ."""
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, dtype, cuda)
    h0 = (torch.randn(b, h, p, n, generator=torch.Generator().manual_seed(1))
          .to(cuda) if with_h0 else None)
    before = ssd_scan.launches
    y, hf = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yp, hp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    assert y.dtype == dtype and hf.dtype == torch.float32
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), yp.float(), rtol=1e-2 if bf else 1e-3,
                               atol=1e-2 if bf else 1e-4)
    torch.testing.assert_close(hf, hp, rtol=1e-3, atol=1e-4)
    y2, hf2 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)   # no float atomics


def test_ops_ssd_launches_the_kernel_for_cuda_tensors(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 4, 16, 2, 8, torch.float32, cuda)
    before = ssd_scan.launches
    # non-contiguous views, as ssd_forward's splits hand them over
    y, hf = ops.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                    Bm, Cm, chunk=32)
    assert ssd_scan.launches == before + 1
    yp, hp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=32)
    torch.testing.assert_close(y, yp, rtol=1e-3, atol=1e-4)


def test_ssd_scan_refuses_what_it_cannot_run(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 4, 16, 2, 8, torch.float32, cuda)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        ssd_scan(x.cpu(), dt.cpu(), A.cpu(), Bm.cpu(), Cm.cpu(), chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm,
                 Cm, chunk=32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(TypeError, match="differ in dtype"):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), chunk=32)
    with pytest.raises(TypeError, match="dt must be float32"):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    assert ssd_scan.launches == before


def _rglru_inputs(b, s, w, dtype, dev, seed=0):
    """tests/test_kernels.py::test_rglru_kernel's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = _randn(rng, (b, s, w), torch.float32, dev) * 0.2
    gx, ga = (_randn(rng, (b, s, w), torch.float32, dev) for _ in range(2))
    la = _randn(rng, (w,), torch.float32, dev)
    h0 = _randn(rng, (b, w), torch.float32, dev) * 0.1
    return x.to(dtype), gx.to(dtype), ga.to(dtype), la, h0


# tests/test_kernels.py::test_rglru_kernel's shapes, a ragged one (neither S
# nor W a multiple of a tile) and RecurrentGemma-2B's layer shape
RGLRU_SHAPES = [(2, 64, 128), (4, 128, 256), (1, 32, 128), (3, 77, 200),
                (4, 1024, 2560)]


@pytest.mark.parametrize("b,s,w", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_plain(cuda, b, s, w, dtype, with_h0):
    """fp32 within tests/test_kernels.py's rtol/atol 1e-4; bf16 y within
    one bf16 rounding (1e-2): the state is fp32 in both."""
    x, gx, ga, la, h0 = _rglru_inputs(b, s, w, dtype, cuda)
    if not with_h0:
        h0 = torch.zeros_like(h0)
    before = rglru_scan.launches
    got = rglru_scan(x, gx, ga, la, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    want = rglru_scan_plain(x, gx, ga, la, h0)
    assert got.dtype == dtype and got.shape == (b, s, w)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_ops_rglru_launches_the_kernel_for_cuda_tensors(cuda):
    x, gx, ga, la, h0 = _rglru_inputs(2, 40, 48, torch.float32, cuda)
    before = rglru_scan.launches
    # a non-contiguous view, as a transposed projection would hand it over
    got = ops.rglru(x.transpose(0, 1).contiguous().transpose(0, 1), gx, ga,
                    la, h0)
    assert rglru_scan.launches == before + 1
    torch.testing.assert_close(got, rglru_scan_plain(x, gx, ga, la, h0),
                               rtol=1e-4, atol=1e-4)


def test_rglru_scan_refuses_what_it_cannot_run(cuda):
    x, gx, ga, la, h0 = _rglru_inputs(2, 40, 48, torch.float32, cuda)
    before = rglru_scan.launches
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        rglru_scan(x.cpu(), gx.cpu(), ga.cpu(), la.cpu(), h0.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(x.transpose(0, 1).contiguous().transpose(0, 1), gx, ga, la,
                   h0)
    with pytest.raises(ValueError, match="do not match"):
        rglru_scan(x, gx[:, :39], ga, la, h0)
    with pytest.raises(TypeError, match="differ in dtype"):
        rglru_scan(x, gx.bfloat16(), ga, la, h0)
    with pytest.raises(TypeError, match="h0 must be float32"):
        rglru_scan(x, gx, ga, la, h0.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan(x.half(), gx.half(), ga.half(), la, h0)
    assert rglru_scan.launches == before


@pytest.mark.parametrize("b,sq,skv", [(1, 300, 300), (2, 100, 70),
                                      (1, 33, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_256_matches_plain(cuda, b, sq, skv, causal,
                                                    window, dtype):
    """K5 at RecurrentGemma-2B's head dim (10 heads, one KV head), with and
    without a window that masks."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (b, 10, sq, 256), dtype, cuda)
    k, v = (_randn(rng, (b, 1, skv, 256), dtype, cuda) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-3,
                               atol=0.03 if bf else 2e-4)


def _k5_case(cuda, b, h, kv, sq, skv, d, causal, window, dtype, seed=4):
    """K5 against its plain version at one shape; returns (q, k, v, got)."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k, v = (_randn(rng, (b, kv, skv, d), dtype, cuda) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-3,
                               atol=0.03 if bf else 2e-4)
    return q, k, v, got


# Sq and Skv at and around the 64-key tile, Skv > Sq and Sq > Skv; windows
# that are no multiple of a tile.
K5_LENGTHS = [(1, 1), (63, 64), (64, 63), (65, 200), (200, 65), (1, 200),
              (200, 1)]
K5_MASKS = [(True, 0), (False, 0), (True, 37), (False, 45)]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sq,skv", K5_LENGTHS)
@pytest.mark.parametrize("causal,window", K5_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_every_head_dim_and_length_matches_plain(
        cuda, d, sq, skv, causal, window, dtype):
    _k5_case(cuda, 1, 2, 1, sq, skv, d, causal, window, dtype)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (10, 1)])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_groups_match_plain(cuda, h, kv, d, dtype):
    """GQA groups of 1, 2 and 10 query heads a KV head, two sequences."""
    _k5_case(cuda, 2, h, kv, 130, 130, d, True, 100, dtype)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("causal,sq,skv,window", [(False, 128, 32, 16),
                                                  (True, 300, 40, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_rows_get_the_mean_of_v(
        cuda, d, causal, sq, skv, window, dtype):
    """Rows at or past Skv + window - 1 see no key: like the TPU kernel and
    the plain version, K5 gives them the mean of V over all Skv keys."""
    _, _, v, got = _k5_case(cuda, 1, 2, 2, sq, skv, d, causal, window, dtype)
    mean = v.float().mean(dim=2, keepdim=True)
    rows = got[:, :, skv + window - 1:].float()
    torch.testing.assert_close(rows, mean.expand_as(rows), rtol=0.01,
                               atol=0.01)


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_repeats_bit_for_bit(cuda, d, dtype):
    q, k, v, got = _k5_case(cuda, 4, 10, 1, 300, 300, d, True, 200, dtype)
    again = flash_attention(q, k, v, causal=True, window=200)
    assert torch.equal(got, again)


def test_flash_attention_bf16_one_tile_is_the_softmax_of_q_kt(cuda):
    """One 64-key tile with V the identity: O is P itself, so this holds
    S = Q.K^T's fragment layout apart from the P.V product."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (1, 1, 64, 64), torch.bfloat16, cuda)
    k = _randn(rng, (1, 1, 64, 64), torch.bfloat16, cuda)
    v = torch.eye(64, device=cuda, dtype=torch.bfloat16)[None, None]
    got = flash_attention(q, k, v, causal=False)
    p = torch.softmax(q[0, 0].float() @ k[0, 0].float().T / 8.0, dim=-1)
    torch.testing.assert_close(got[0, 0].float(), p, rtol=0.05, atol=0.01)


def test_flash_attention_bf16_zero_q_is_the_mean_of_v(cuda):
    """Q = 0 makes every weight equal: O is the mean of V, which holds the
    P.V product's layout apart from S."""
    rng = np.random.default_rng(6)
    q = torch.zeros((1, 1, 64, 256), device=cuda, dtype=torch.bfloat16)
    k, v = (_randn(rng, (1, 1, 64, 256), torch.bfloat16, cuda)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=False)
    mean = v[0, 0].float().mean(dim=0, keepdim=True).expand(64, 256)
    torch.testing.assert_close(got[0, 0].float(), mean, rtol=0.02, atol=0.01)


def test_flash_attention_takes_a_view_at_an_odd_offset(cuda):
    rng = np.random.default_rng(7)
    flat = _randn(rng, (3 * 64 * 16 + 4,), torch.bfloat16, cuda)
    q, k, v = (flat[4 + i * 64 * 16:4 + (i + 1) * 64 * 16].view(1, 1, 64, 16)
               for i in range(3))
    assert q.data_ptr() % 16
    torch.testing.assert_close(
        flash_attention(q, k, v).float(),
        flash_attention_plain(q, k, v).float(), rtol=0.05, atol=0.03)


def test_serve_recurrentgemma_launches_k7_and_k5(cuda):
    """The reduced RecurrentGemma served on the card: one K7 launch per
    rglru layer and one K5 launch per attention layer of the prefill, and
    none in decode."""
    from repro_torch.launch.serve import serve
    counts = (rglru_scan.launches, flash_attention.launches)
    out = serve("recurrentgemma-2b", smoke=True, batch=2, prompt=32, gen=4)
    assert (rglru_scan.launches - counts[0],
            flash_attention.launches - counts[1]) == (2, 1)
    assert out["generated"].shape == (2, 4)
    assert ((0 <= out["generated"]) & (out["generated"] < 512)).all()


# ---- K3, K4: int8 quantize and dequantize, byte for byte -------------------

QUANT_SHAPES = [(128, 256), (3, 1000), (1, 4096), (2, 64), (5, 1),
                (1, (1 << 22) + 3), (3000, 40)]


def _quant_input(m, n, dtype, dev):
    rng = np.random.default_rng(m * 7 + n)
    x = _randn(rng, (m, n), torch.float32, dev) * 3.0
    if (m, n) == (2, 64):
        x[0] = 0.0                                  # an all-zero row
    return x.to(dtype)


@pytest.mark.parametrize("m,n", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_bytes_equal_plain(cuda, m, n, dtype):
    """Codes and scales byte-equal to the plain version, on the card and on
    a CPU copy (tests/test_kernels.py:85's demand of the TPU kernel)."""
    x = _quant_input(m, n, dtype, cuda)
    before = quantize_int8.launches
    q, s = quantize_int8(x)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (m, n) and s.shape == (m, 1)
    for want_q, want_s in (quantize_int8_plain(x),
                           quantize_int8_plain(x.cpu())):
        assert torch.equal(q.cpu(), want_q.cpu())
        assert torch.equal(s.cpu().view(torch.int32),
                           want_s.cpu().view(torch.int32))


@pytest.mark.parametrize("m,n", QUANT_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequantize_int8_bytes_equal_plain(cuda, m, n, out_dtype):
    q, s = quantize_int8_plain(_quant_input(m, n, torch.float32, cuda))
    before = dequantize_int8.launches
    got = dequantize_int8(q, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dequantize_int8.launches == before + 1
    want = dequantize_int8_plain(q, s, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    bits = torch.int32 if out_dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("m,n", [(3, 1000), (1, (1 << 22) + 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_nan_and_inf_propagate_as_plain(cuda, m, n, dtype):
    """Row 0 holds one NaN and one -Inf, the last one in the row's last
    block: K3 -> K4 gives the plain version's codes (0), scale (NaN) and
    dequantized values (all NaN), NaN for NaN; other rows stay finite."""
    x = _quant_input(m, n, dtype, cuda)
    x[0, n // 3] = float("nan")
    x[0, n - 1] = float("-inf")
    q, s = quantize_int8(x)
    wq, ws = quantize_int8_plain(x)
    assert torch.equal(q, wq) and not bool(q[0].any())
    torch.testing.assert_close(s, ws, rtol=0, atol=0, equal_nan=True)
    assert bool(s[0].isnan()) and bool(torch.isfinite(s[1:]).all())
    for out_dtype in (torch.float32, torch.bfloat16):
        got = dequantize_int8(q, s, out_dtype=out_dtype)
        want = dequantize_int8_plain(wq, ws, out_dtype=out_dtype)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert bool(got[0].isnan().all())
        assert bool(torch.isfinite(got[1:]).all())


def test_ops_quantize_and_compress_grads_launch_k3_k4(cuda):
    from repro_torch.distributed import compression as C
    g = {"a": torch.randn(33, 17, device=cuda).bfloat16(),
         "b": [torch.randn(5, device=cuda)]}
    err = C.init_error_state(g)
    counts = (quantize_int8.launches, dequantize_int8.launches)
    deq, new_err = C.compress_grads(g, err)
    assert (quantize_int8.launches - counts[0],
            dequantize_int8.launches - counts[1]) == (2, 2)
    cpu = {"a": g["a"].cpu(), "b": [g["b"][0].cpu()]}
    want, want_err = C.compress_grads(cpu, C.init_error_state(cpu))
    assert torch.equal(deq["a"].cpu(), want["a"])
    assert torch.equal(new_err["b"][0].cpu(), want_err["b"][0])


def test_quantize_refuses_what_it_cannot_run(cuda):
    before = quantize_int8.launches, dequantize_int8.launches
    x = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8(x.t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quantize_int8(x.half())
    q = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        dequantize_int8(q, torch.ones(3, 1, device=cuda))
    assert (quantize_int8.launches, dequantize_int8.launches) == before


# ---- K8b: the SSD scan's gradient ------------------------------------------

def _bwd_inputs(b, s, h, p, g, n, dtype, dev, seed=0):
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed)
    rng = np.random.default_rng(seed + 100)
    h0 = _randn(rng, (b, h, p, n), torch.float32, dev) * 0.5
    dy = _randn(rng, (b, s, h, p), torch.float32, dev).to(dtype)
    dstate = _randn(rng, (b, h, p, n), torch.float32, dev) * 0.1
    return x, dt, A, Bm, Cm, h0, dy, dstate


BWD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES[:5] + SSD_EDGES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_bwd_matches_plain(cuda, b, s, h, p, g, n, chunk, with_h0):
    """fp32, within K8's card bar (rtol 1e-3, atol 1e-4): the kernel walks
    64-row chunks, the plain version autograd through the caller's."""
    x, dt, A, Bm, Cm, h0, dy, dstate = _bwd_inputs(b, s, h, p, g, n,
                                                   torch.float32, cuda)
    h0 = h0 if with_h0 else None
    dstate = dstate if with_h0 else None
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    _, _, states = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                            keep_states=True)
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                       states=states)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk)
    for name, gg, ww in zip(BWD_NAMES, got, want):
        assert gg.dtype == ww.dtype and gg.shape == ww.shape, name
        torch.testing.assert_close(gg, ww, rtol=1e-3, atol=1e-4, msg=name)
    again = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                         states=states)
    for gg, aa in zip(got, again):
        assert torch.equal(gg, aa)             # no float atomics: repeatable


def test_ssd_scan_keeps_the_chunk_states(cuda):
    """states[:, :, c] is the state entering row 64c: h0 for c = 0, the
    plain scan's final state over the first 64c rows after."""
    x, dt, A, Bm, Cm, h0, _, _ = _bwd_inputs(2, 200, 4, 32, 2, 16,
                                             torch.float32, cuda)
    y, hf, states = ssd_scan(x, dt, A, Bm, Cm, chunk=200, h0=h0,
                             keep_states=True)
    assert states.shape == (2, 4, 4, 32, 16)
    assert torch.equal(states[:, :, 0], h0)
    for c in (1, 3):
        r = 64 * c
        _, hp = ssd_scan_plain(x[:, :r], dt[:, :r], A, Bm[:, :r], Cm[:, :r],
                               chunk=r, h0=h0)
        torch.testing.assert_close(states[:, :, c], hp, rtol=1e-3, atol=1e-4)


def test_ssd_scan_bwd_bf16_at_the_layer_shape(cuda):
    """Mamba-2 370M's layer at batch 1 in bf16: each gradient within 1e-2
    relative Frobenius error of the plain version."""
    x, dt, A, Bm, Cm, _, dy, _ = _bwd_inputs(1, 1024, 32, 64, 1, 128,
                                             torch.bfloat16, cuda)
    _, _, states = ssd_scan(x, dt, A, Bm, Cm, chunk=256, keep_states=True)
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, None, dy, None, chunk=256,
                       states=states)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, None, dy, None, chunk=256)
    for name, gg, ww in zip(BWD_NAMES, got, want):
        assert gg.dtype == ww.dtype, name
        rel = ((gg.float() - ww.float()).norm() / ww.float().norm()).item()
        assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_EDGES)
def test_ssd_scan_bwd_bf16_at_the_edges(cuda, b, s, h, p, g, n, chunk):
    """bf16 with h0 and dstate at the cluster's edges: each gradient within
    1e-2 relative Frobenius error of the plain version (the layer shape's
    bar), and the same bytes from run to run."""
    x, dt, A, Bm, Cm, h0, dy, dstate = _bwd_inputs(b, s, h, p, g, n,
                                                   torch.bfloat16, cuda)
    _, _, states = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                            keep_states=True)
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                       states=states)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk)
    for name, gg, ww in zip(BWD_NAMES, got, want):
        assert gg.dtype == ww.dtype and gg.shape == ww.shape, name
        rel = ((gg.float() - ww.float()).norm() / ww.float().norm()).item()
        assert rel <= 1e-2, (name, rel)
    again = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=chunk,
                         states=states)
    for gg, aa in zip(got, again):
        assert torch.equal(gg, aa)


def test_ssd_launch_spreads_the_chunks(cuda):
    """K8 and K8b at the layer shapes: a cluster of 8 blocks a (batch row,
    head), two heads a K8b block in bf16."""
    from repro_torch.kernels.ssd import launch_shape
    fwd = launch_shape(4, 1024, 32, 64, 1, 128, torch.bfloat16)
    bwd = launch_shape(8, 1024, 32, 64, 1, 128, torch.bfloat16,
                       backward=True)
    assert fwd["grid"] == (128, 8, 1) and fwd["blocks"] == 1024
    assert bwd["grid"] == (128, 8, 1) and bwd["heads_per_block"] == 2
    assert launch_shape(1, 576, 4, 64, 1, 32, torch.float32)["cluster"] == 5


def test_ops_ssd_under_grad_runs_k8_and_k8b(cuda):
    x, dt, A, Bm, Cm, h0, dy, dstate = _bwd_inputs(2, 128, 4, 32, 2, 16,
                                                   torch.float32, cuda)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, hf = ops.ssd(*ins[:5], chunk=32, h0=ins[5])
    got = torch.autograd.grad([y, hf], ins, [dy, dstate])
    assert (ssd_scan.launches - before[0],
            ssd_scan_bwd.launches - before[1]) == (1, 1)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=32)
    for name, gg, ww in zip(BWD_NAMES, got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-3, atol=1e-4, msg=name)


def test_ssd_scan_bwd_refuses_what_it_cannot_run(cuda):
    x, dt, A, Bm, Cm, h0, dy, dstate = _bwd_inputs(1, 64, 4, 16, 2, 8,
                                                   torch.float32, cuda)
    states = ssd_scan(x, dt, A, Bm, Cm, chunk=32, h0=h0, keep_states=True)[2]
    before = ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy.bfloat16(), dstate, chunk=32,
                     states=states)
    with pytest.raises(ValueError, match="dstate"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate[..., :4], chunk=32,
                     states=states)
    with pytest.raises(ValueError, match="chunk states"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dstate, chunk=32,
                     states=torch.zeros(1, 4, 2, 16, 8, device=cuda))
    assert ssd_scan_bwd.launches == before


# ---- the kernels without a backward refuse to cut the graph ----------------

def test_kernels_without_a_backward_raise_under_grad(cuda):
    rng = np.random.default_rng(9)
    w = _randn(rng, (16, 8), torch.float32, cuda).requires_grad_()
    x = _randn(rng, (4, 16), torch.float32, cuda)
    s, b = (_randn(rng, (16,), torch.float32, cuda) for _ in range(2))
    q = _randn(rng, (1, 2, 8, 32), torch.float32, cuda).requires_grad_()
    k, v = (_randn(rng, (1, 2, 8, 32), torch.float32, cuda) for _ in range(2))
    t = torch.sort(torch.rand(2, 8, device=cuda, dtype=torch.float64))[0]
    sv = torch.rand(2, 8, device=cuda, dtype=torch.float64).requires_grad_()
    rx, gx, ga, la, h0 = _rglru_inputs(1, 16, 32, torch.float32, cuda)
    la.requires_grad_()
    calls = {"matmul": lambda: ops.matmul(x, w),
             "affine_act": lambda: ops.affine_act(x, s.requires_grad_(), b),
             "attention": lambda: ops.attention(q, k, v),
             "lindley": lambda: ops.lindley(t, sv),
             "rglru": lambda: ops.rglru(rx, gx, ga, la, h0)}
    counters = (systolic_matmul, fused_affine_act, flash_attention,
                lindley_scan, rglru_scan)
    before = [c.launches for c in counters]
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"ops.{name}:.*"
                           "no backward"):
            call()
    assert [c.launches for c in counters] == before
    with torch.no_grad():              # no graph to cut: the kernels run
        for call in calls.values():
            call()
    assert [c.launches - n for c, n in zip(counters, before)] == [1] * 5
