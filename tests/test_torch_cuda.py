"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit; elsewhere they
skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
fp32 products run without TF32 so that the plain versions are fp32.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.core import lindley as core_lindley
from repro_torch.core.arrivals import PoissonProcess
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.function import standard_pipeline
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.lindley import (lindley_scan, lindley_scan_plain,
                                         lindley_scan_segments,
                                         lindley_scan_segments_plain)
from repro_torch.kernels.rglru import (rglru_scan, rglru_scan_bwd,
                                       rglru_scan_bwd_plain, rglru_scan_plain)
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


# K2's edges: an x base off the 16-byte vector, N no multiple of the
# vector (the row's tail and the unaligned rows), bf16 in and out, and
# more rows than the grid (rows walked with a stride)
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("m,n", [(1, 150527), (1, 150528), (7, 1001),
                                 (5000, 64), (3, 5)])
@pytest.mark.parametrize("dt_in,dt_out", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_fused_affine_act_edges_match_plain(cuda, offset, m, n, dt_in,
                                            dt_out):
    rng = np.random.default_rng(m * n + offset)
    base = _randn(rng, (m * n + offset,), dt_in, cuda)
    x = base[offset:].view(m, n)
    s, b = (_randn(rng, (n,), torch.float32, cuda) for _ in range(2))
    before = fused_affine_act.launches
    got = fused_affine_act(x, s, b, act="silu", out_dtype=dt_out)
    assert fused_affine_act.launches == before + 1
    want = fused_affine_act_plain(x, s, b, act="silu", out_dtype=dt_out)
    assert got.dtype == dt_out and got.shape == (m, n)
    tol = 1e-2 if dt_out == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_fused_affine_act_takes_unaligned_scale_and_bias(cuda):
    rng = np.random.default_rng(2)
    x = _randn(rng, (4, 1024), torch.float32, cuda)
    s = _randn(rng, (1025,), torch.float32, cuda)[1:]
    b = _randn(rng, (1027,), torch.float32, cuda)[3:]
    torch.testing.assert_close(fused_affine_act(x, s, b),
                               fused_affine_act_plain(x, s, b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,kv,sq,skv,d", [
    (2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 128, 32), (1, 4, 4, 17, 17, 32),
    (2, 4, 2, 100, 70, 128), (1, 2, 2, 50, 40, 16),
    # Whisper's cross-attention in small: Sq < Skv, Skv three tiles and a
    # part; GPT-2's odd head count
    (1, 3, 3, 40, 150, 64), (2, 25, 25, 70, 70, 64)])
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


def _zipf_solve(n=200_000, nserv=128):
    rng = np.random.default_rng(0)
    p = np.arange(1, nserv + 1, dtype=np.float64) ** -1.2
    p /= p.sum()
    keys = np.sort(rng.choice(nserv, size=n, p=p))
    t = np.sort(rng.uniform(0.0, n / 1e4, size=n))
    s = rng.uniform(1e-4, 2e-3, size=n)
    return core_lindley.segment_fenceposts(keys, 0, nserv), t, s


def test_solver_cuda_bytes_equal_segmented_on_zipf(cuda):
    seg, t, s = _zipf_solve()
    n = t.size
    out = {}
    before = lindley_scan.launches
    for backend in ("segmented", "cuda"):
        start, fin = np.empty(n), np.empty(n)
        core_lindley.solve_segments(seg, t, s, start, fin, backend=backend)
        out[backend] = (start.tobytes(), fin.tobytes())
    assert lindley_scan.launches == before + 1          # one a solve
    assert out["cuda"] == out["segmented"]


def test_fleet_cuda_bytes_equal_segmented(cuda, monkeypatch):
    pipes = [standard_pipeline(n) for n in ("asset_damage",
                                            "content_moderation")]
    runs, solves = {}, []
    real = core_lindley.solve_segments

    def count(seg, t, s, start, fin, *, backend):
        solves.append((backend, t.size > 0))
        return real(seg, t, s, start, fin, backend=backend)

    monkeypatch.setattr(core_lindley, "solve_segments", count)
    for backend in ("segmented", "cuda"):
        eng = ClusterEngine(n_dscs=64, n_cpu=64, hedge_budget_s=0.08, seed=0)
        before = lindley_scan.launches
        tr = eng.run_sharded(pipes, arrivals=PoissonProcess(rate=1600.0),
                             duration_s=3.0, n_shards=2, processes=1,
                             backend=backend)
        runs[backend] = (eng, tr, lindley_scan.launches - before)
    (es, ts, n_seg), (ec, tc, n_cuda) = runs["segmented"], runs["cuda"]
    assert ec.last_shard_stats["path"] == "partitioned"
    # one launch for each solve with a non-empty input
    assert n_seg == 0 and n_cuda == solves.count(("cuda", True)) > 0
    assert solves.count(("cuda", True)) == solves.count(("segmented", True))
    for col in ("arrival", "finish", "winner", "drive", "start", "service",
                "hedged", "dscs_finish", "cpu_finish"):
        assert getattr(ts, col).tobytes() == getattr(tc, col).tobytes(), col
    assert ts.events == tc.events
    assert es._qstate == ec._qstate and es._pstate == ec._pstate
    assert dict(es.telemetry.counters) == dict(ec.telemetry.counters)


def _flat_solve(lens, seed, nan=None):
    """Fenceposts and flat sorted arrivals and demands for queues of
    ``lens``; ``nan`` ("t" or "s") puts a NaN into the longest queue ("2":
    a second NaN arrival of other bits after it, numpy's and x86's)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, dtype=np.int64)
    seg = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    t = np.concatenate([np.sort(rng.uniform(0.0, 1e3, n)) for n in lens]
                       + [np.empty(0)])
    s = rng.uniform(1e-4, 2.0, int(seg[-1]))
    if nan:
        j = int(np.argmax(lens))
        (t if nan != "s" else s)[seg[j] + lens[j] // 3] = np.nan
    if nan == "2":                   # x86's inf - inf, later in the queue
        t[seg[j] + 2 * lens[j] // 3] = np.array(
            [0xfff8000000000000], dtype=np.uint64).view(np.float64)[0]
    return seg, t, s


def _k6_segments(seg, t, s, dev, offset=0):
    """K6 on the card (t and s at ``offset`` elements past a fresh base)
    and its plain version on a CPU copy, as numpy arrays; one launch."""
    def col(a):
        base = torch.empty(a.size + offset, dtype=torch.float64, device=dev)
        base[offset:] = torch.from_numpy(a).to(dev)
        return base[offset:]
    before = lindley_scan.launches
    got = lindley_scan_segments(torch.from_numpy(seg).to(dev), col(t), col(s))
    torch.cuda.synchronize()
    assert lindley_scan.launches == before + 1
    want = lindley_scan_segments_plain(torch.from_numpy(seg),
                                       torch.from_numpy(t), torch.from_numpy(s))
    return got.cpu().numpy(), want.numpy()


K6_SOLVES = {
    "ragged": [1000, 3, 257, 0, 1, 513, 1, 0, 2048, 255, 256, 4097],
    "empty_and_one": [0, 1, 0, 0, 1, 1, 0],
    "fleet_like": [700 + (37 * j) % 390 for j in range(128)],
    "many": [(j * 7919) % 61 for j in range(5000)],
}


@pytest.mark.parametrize("name", sorted(K6_SOLVES))
@pytest.mark.parametrize("nan", [None, "t", "s", "2"])
@pytest.mark.parametrize("offset", [0, 1])
def test_lindley_segments_bytes_equal_plain_on_cpu(cuda, name, nan, offset):
    seg, t, s = _flat_solve(K6_SOLVES[name], len(name), nan)
    got, want = _k6_segments(seg, t, s, cuda, offset)
    assert got.tobytes() == want.tobytes()
    start, fin = np.empty(t.size), np.empty(t.size)
    core_lindley.solve_segments(seg, t, s, start, fin, backend="segmented")
    assert got.tobytes() == start.tobytes()            # numpy's bytes


def test_lindley_segments_on_a_zipf_solve(cuda):
    seg, t, s = _zipf_solve()
    got, want = _k6_segments(seg, t, s, cuda, offset=1)
    assert got.tobytes() == want.tobytes()


def test_lindley_nan_row_gives_numpy_s_bytes(cuda):
    t, s = np.array([[np.nan, 1.0]]), np.array([[1.0, 1.0]])
    got = lindley_scan(torch.from_numpy(t).to(cuda),
                       torch.from_numpy(s).to(cuda)).cpu().numpy()
    start, fin = np.empty(2), np.empty(2)
    core_lindley.solve_segments(np.array([0, 2]), t[0], s[0], start, fin,
                                backend="segmented")
    assert got[0].tobytes() == start.tobytes()
    assert got.tobytes() == lindley_scan_plain(
        torch.from_numpy(t), torch.from_numpy(s)).numpy().tobytes()


def test_lindley_segments_graph_replays_are_equal(cuda):
    seg, t, s = _flat_solve(K6_SOLVES["ragged"], 9)
    sd, td, ssd = (torch.from_numpy(a).to(cuda) for a in (seg, t, s))
    first, second = _graph_replays(lambda: lindley_scan_segments(sd, td, ssd))
    assert torch.equal(first[0], second[0])
    assert first[0].cpu().numpy().tobytes() == lindley_scan_segments_plain(
        *(torch.from_numpy(a) for a in (seg, t, s))).numpy().tobytes()


def test_lindley_segments_longest_first_past_the_resident_blocks(cuda):
    from repro_torch.kernels.lindley import resident_blocks
    n_seg = resident_blocks(cuda) + 7
    lens = [3] * n_seg
    lens[-1] = 5000
    seg, t, s = _flat_solve(lens, 1)
    got, want = _k6_segments(seg, t, s, cuda)
    assert got.tobytes() == want.tobytes()


def test_lindley_segments_refuses_what_it_cannot_run(cuda):
    seg, t, s = (torch.from_numpy(a).to(cuda)
                 for a in _flat_solve([3, 4], 0))
    before = lindley_scan.launches
    with pytest.raises(ValueError, match="int64"):
        lindley_scan_segments(seg.int(), t, s)
    with pytest.raises(TypeError, match="float64"):
        lindley_scan_segments(seg, t.float(), s.float())
    with pytest.raises(ValueError, match="CUDA tensor"):
        lindley_scan_segments(seg.cpu(), t, s)
    assert lindley_scan.launches == before


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


def _graph_replays(fn):
    """fn's outputs after each of two replays of one CUDA graph that
    captured it (the outputs are the graph's own, read between replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append([t.clone() for t in
                     (out if isinstance(out, tuple) else (out,))])
    return outs


# K7's new edges: one step, the 4096-token prompt (four windows of a
# cluster of 8), an odd W (the pair loads give way to single ones)
@pytest.mark.parametrize("b,s,w", [(2, 1, 256), (1, 4096, 256), (2, 300, 201),
                                   (1, 129, 63)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_edges_match_plain(cuda, b, s, w, dtype):
    x, gx, ga, la, h0 = _rglru_inputs(b, s, w, dtype, cuda, seed=s + w)
    got = rglru_scan(x, gx, ga, la, h0)
    want = rglru_scan_plain(x, gx, ga, la, h0)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_rglru_scan_graph_replays_are_equal(cuda):
    x, gx, ga, la, h0 = _rglru_inputs(4, 1024, 2560, torch.bfloat16, cuda)
    first, second = _graph_replays(lambda: rglru_scan(x, gx, ga, la, h0))
    assert torch.equal(first[0], second[0])
    torch.testing.assert_close(first[0].float(),
                               rglru_scan_plain(x, gx, ga, la, h0).float(),
                               rtol=1e-2, atol=1e-2)


def test_rglru_launch_at_the_layer_shapes(cuda):
    """Clusters of 8 blocks along the time axis, no more clusters than the
    items (the library's block is checked against the plan at load)."""
    from repro_torch.kernels.rglru import launch_plan, launch_shape
    for s in (1024, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            shape = launch_shape(4, s, 2560, dtype)
            assert shape["grid"][0] == launch_plan(4, s, 2560)["cluster"] == 8
            assert 1 <= shape["grid"][1] <= launch_plan(4, s, 2560)["items"]
    assert launch_shape(2, 1, 256, torch.bfloat16)["grid"][0] == 1


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


# K5's bar beside its elementwise tolerances at Whisper's and the paper LMs'
# shapes, as chip_smoke.py holds it (the same as K5B_REL below): at std-1
# inputs over 1500 keys a row's |o| is about 0.04, so the elementwise atol
# of 0.03 alone would pass a dropped key tile.
K5_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k5_case(cuda, b, h, kv, sq, skv, d, causal, window, dtype, seed=4,
             rel=False, dv=None, q_offset=0, kv_len=None):
    """K5 against its plain version at one shape (v's head dim ``dv``, d
    where None), the queries at ``q_offset`` and the keys below ``kv_len``;
    with ``rel`` also within K5_REL's relative Frobenius error.  Returns
    (q, k, v, got, want)."""
    rng = np.random.default_rng(seed)
    dv = dv or d
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k = _randn(rng, (b, kv, skv, d), dtype, cuda)
    v = _randn(rng, (b, kv, skv, dv), dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, sq, dv)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-3,
                               atol=0.03 if bf else 2e-4)
    if rel:
        assert _rel_frobenius(got, want) <= K5_REL[dtype]
    return q, k, v, got, want


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
    _, _, v, got, _ = _k5_case(cuda, 1, 2, 2, sq, skv, d, causal, window,
                               dtype)
    mean = v.float().mean(dim=2, keepdim=True)
    rows = got[:, :, skv + window - 1:].float()
    torch.testing.assert_close(rows, mean.expand_as(rows), rtol=0.01,
                               atol=0.01)


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_repeats_bit_for_bit(cuda, d, dtype):
    q, k, v, got, _ = _k5_case(cuda, 4, 10, 1, 300, 300, d, True, 200,
                               dtype)
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


# ---- K5b: flash attention's backward ---------------------------------------

# K5b's bar beside K5's elementwise tolerances, as chip_smoke.py holds it:
# each gradient within this relative Frobenius error of the plain version,
# the norm floored at an rms of 1e-2 where a gradient cancels to ~0 (one
# key: dQ = dK = 0, fp32 residues of ~2e-7).  A planted fault (dQ x 0.9, one 64-key tile dropped) reads
# above it.
K5B_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_frobenius(got, want):
    got, want = got.float(), want.float()
    floor = 1e-2 * math.sqrt(want.numel())
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


def _k5b_case(cuda, b, h, kv, sq, skv, d, causal, window, dtype, seed=5,
              dv=None, q_offset=0, kv_len=None):
    """K5 (with its lse) and K5b against their plain versions at one shape
    (v's head dim ``dv``, d where None), the queries at ``q_offset`` and
    the keys below ``kv_len``, both fed the kernel's o and lse; the
    elementwise tolerances are K5's, with K5B_REL beside them.  Returns
    (inputs, K5b's gradients, the plain version's)."""
    dv = dv or d
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k = _randn(rng, (b, kv, skv, d), dtype, cuda)
    v = _randn(rng, (b, kv, skv, dv), dtype, cuda)
    do = _randn(rng, (b, h, sq, dv), dtype, cuda)
    pos = dict(q_offset=q_offset, kv_len=kv_len)
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True, **pos)
    _, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True, **pos)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    # the lse of a row that saw no key is the mask value, as in the plain
    # version: K5b reads that to give the row its weights 1 / Skv
    assert torch.equal(lse == -1e30, want_lse == -1e30)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window, **pos)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window, **pos)
    bf = dtype == torch.bfloat16
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert gg.dtype == dtype and gg.shape == ww.shape, name
        torch.testing.assert_close(gg.float(), ww.float(),
                                   rtol=0.05 if bf else 1e-3,
                                   atol=0.03 if bf else 2e-4, msg=name)
        rel = _rel_frobenius(gg, ww)
        assert rel <= K5B_REL[dtype], (name, rel)
    return (q, k, v, o, lse, do), got, want


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 64), (65, 200), (200, 65),
                                    (130, 130)])
@pytest.mark.parametrize("causal,window", K5_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda, d, sq, skv, causal, window,
                                           dtype):
    """Every head dim, Sq and Skv around the tiles, Sq != Skv, windows off
    the tile, causal or not; GQA 2:1."""
    _k5b_case(cuda, 1, 4, 2, sq, skv, d, causal, window, dtype)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (10, 1), (8, 2)])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_gqa_groups_match_plain(cuda, h, kv, d, dtype):
    """dK and dV summed over GQA groups of 1, 2, 4 and 10 query heads."""
    _k5b_case(cuda, 2, h, kv, 300, 300, d, True, 100, dtype)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("causal,sq,skv,window", [(False, 128, 32, 16),
                                                  (True, 300, 40, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_fully_masked_rows(cuda, d, causal, sq, skv,
                                               window, dtype):
    """Rows that see no key: no gradient to their queries, 1 / Skv of their
    dO to every value row."""
    _, (dq, _, _), _ = _k5b_case(cuda, 1, 2, 2, sq, skv, d, causal, window,
                                 dtype)
    assert not dq[:, :, skv + window - 1:].any()


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_repeats_bit_for_bit(cuda, d, dtype):
    """dK and dV are summed over the group inside the kernel, in a fixed
    order (no atomics): two calls give the same bytes."""
    args, got, _ = _k5b_case(cuda, 2, 8, 2, 257, 257, d, True, 0, dtype)
    again = flash_attention_bwd(*args, causal=True, window=0)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


# ---- K5 and K5b in fp32: 3xTF32 on the tensor cores ------------------------

def tf32_standin(q, k, v, do=None, *, causal, terms):
    """``chip_smoke.py``'s dense attention (with ``do`` its dq, dk, dv) with
    every product one TF32 product (terms 1: the 1xTF32 stand-in) or a
    plain one in the inputs' dtype (terms 0; in fp64, the exact
    reference)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import tf32_standin as standin
    return standin(q, k, v, do, causal=causal, window=0, terms=terms)


# 17(f)'s rank shape (B, H, KV, S, Skv, D), causal, and one at head dim 64
# with no mask
TF32_SHAPES = [((2, 16, 4, 256, 256, 128), True),
               ((1, 4, 2, 200, 300, 64), False)]


@pytest.mark.parametrize("shape,causal", TF32_SHAPES)
def test_flash_attention_is_3xtf32_not_1xtf32(cuda, shape, causal):
    """Against fp64, K5 in fp32 reads below 1e-5 (relative Frobenius); a
    stand-in with one TF32 product a step (the lo terms dropped) reads
    above the card's fp32 bar of 1e-4."""
    B, H, KV, Sq, Skv, D = shape
    rng = np.random.default_rng(23)
    q = _randn(rng, (B, H, Sq, D), torch.float32, cuda)
    k, v = (_randn(rng, (B, KV, Skv, D), torch.float32, cuda)
            for _ in range(2))
    exact = tf32_standin(q.double(), k.double(), v.double(), causal=causal,
                         terms=0)
    assert rel_frobenius(flash_attention(q, k, v, causal=causal), exact) \
        < 1e-5
    assert rel_frobenius(tf32_standin(q, k, v, causal=causal, terms=1),
                         exact) > 1e-4


@pytest.mark.parametrize("shape,causal", TF32_SHAPES)
def test_flash_attention_bwd_is_3xtf32_not_1xtf32(cuda, shape, causal):
    """K5b in fp32, fed K5's o and lse, against the fp64 gradients: each of
    dq, dk, dv below 1e-5; the 1xTF32 stand-in above 1e-4."""
    B, H, KV, Sq, Skv, D = shape
    rng = np.random.default_rng(29)
    q = _randn(rng, (B, H, Sq, D), torch.float32, cuda)
    k, v = (_randn(rng, (B, KV, Skv, D), torch.float32, cuda)
            for _ in range(2))
    do = _randn(rng, (B, H, Sq, D), torch.float32, cuda)
    exact = tf32_standin(q.double(), k.double(), v.double(), do.double(),
                         causal=causal, terms=0)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    one = tf32_standin(q, k, v, do, causal=causal, terms=1)
    for name, gg, ee, ww in zip(("dq", "dk", "dv"), got, exact, one):
        assert rel_frobenius(gg, ee) < 1e-5, name
        assert rel_frobenius(ww, ee) > 1e-4, name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fp32_non_finite_as_plain(cuda, causal):
    """Exactly the plain version's non-finite outputs are non-finite: NaN
    in a query row and a key, +inf in a query row that sees 100 keys (some
    score +inf); without the causal mask also -inf in a value (with it, the
    plain version's 0 x inf reaches rows the kernel never pairs with that
    key).  NaN may stand for +-inf (a term inf x lo with lo = 0)."""
    rng = np.random.default_rng(9)
    q = _randn(rng, (1, 4, 150, 64), torch.float32, cuda)
    k, v = (_randn(rng, (1, 2, 150, 64), torch.float32, cuda)
            for _ in range(2))
    q[0, 1, 7, 3] = math.nan
    q[0, 2, 100, 0] = math.inf
    k[0, 1, 90, 9] = math.nan
    if not causal:
        v[0, 0, 60, 2] = -math.inf
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert (~torch.isfinite(want)).any()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))


def test_flash_attention_bwd_fp32_non_finite_as_plain(cuda):
    """K5b's non-finite outputs are the plain version's with NaN in a row
    of dO and +inf in a value, no mask (every pair is walked: the plain
    version's 0 x NaN reaches every key)."""
    rng = np.random.default_rng(10)
    q = _randn(rng, (1, 4, 150, 64), torch.float32, cuda)
    k, v = (_randn(rng, (1, 2, 150, 64), torch.float32, cuda)
            for _ in range(2))
    do = _randn(rng, (1, 4, 150, 64), torch.float32, cuda)
    do[0, 3, 30, 5] = math.nan
    v[0, 0, 70, 1] = math.inf
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert (~torch.isfinite(ww)).any(), name
        assert torch.equal(torch.isfinite(gg), torch.isfinite(ww)), name


# TP's compute split: the shapes of a rank along ``model`` (B, H, KV, S, D),
# causal, at a batch of 4 prompts of 1024 tokens: qwen3-8b's 32 heads and 8
# kv heads over 4 ranks, qwen3-moe's 64 and 4 over 4 and over 2
TP_RANK_SHAPES = [(4, 8, 2, 1024, 128), (4, 16, 1, 1024, 128),
                  (4, 32, 2, 1024, 128)]


@pytest.mark.parametrize("b,h,kv,s,d", TP_RANK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_tp_rank_shapes_matches_plain(cuda, b, h, kv,
                                                             s, d, dtype):
    rng = np.random.default_rng(4)
    q = _randn(rng, (b, h, s, d), dtype, cuda)
    k, v = (_randn(rng, (b, kv, s, d), dtype, cuda) for _ in range(2))
    got = flash_attention(q, k, v, causal=True, window=0)
    want = flash_attention_plain(q, k, v, causal=True, window=0)
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=0.05 if bf else 1e-3,
                               atol=0.03 if bf else 2e-4)


@pytest.mark.parametrize("b,h,kv,s,d", TP_RANK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_at_the_tp_rank_shapes_matches_plain(
        cuda, b, h, kv, s, d, dtype):
    _k5b_case(cuda, b, h, kv, s, s, d, True, 0, dtype)


# K5b's head split at its edges: RecurrentGemma's G = 10 query heads of one
# KV head over clusters that do not divide it (rank r takes heads r, r + R,
# ...), Skv no multiple of the 64-key tile, masks that leave the key tiles
# unequal walks
@pytest.mark.parametrize("cluster,d,skv,causal,window", [
    (3, 256, 200, True, 0), (4, 256, 1000, True, 300),
    (8, 128, 333, False, 0), (7, 64, 130, True, 0)])
def test_flash_attention_bwd_head_split_over_a_cluster(cuda, monkeypatch,
                                                       cluster, d, skv,
                                                       causal, window):
    from repro_torch.kernels import flash_attention as FA
    plan = FA.bwd_plan
    monkeypatch.setattr(FA, "bwd_plan",
                        lambda *a, **kw: plan(*a, **kw, cluster=cluster))
    args, got, _ = _k5b_case(cuda, 2, 10, 1, skv, skv, d, causal, window,
                             torch.bfloat16)
    again = flash_attention_bwd(*args, causal=causal, window=window)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


def test_ops_attention_under_grad_runs_k5_and_k5b(cuda):
    """ops.attention under grad: one K5 launch forward, one K5b backward,
    and the gradients of autograd through the plain version (fp32)."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (2, 8, 150, 64), torch.float32, cuda)
    k, v = (_randn(rng, (2, 2, 150, 64), torch.float32, cuda)
            for _ in range(2))
    do = _randn(rng, (2, 8, 150, 64), torch.float32, cuda)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    got = torch.autograd.grad(ops.attention(*ins, causal=True, window=40),
                              ins, do)
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (1, 1)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_plain(*ref, causal=True, window=40), ref, do)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-3, atol=2e-4)


# K5 and K5b with the queries shifted and the keys cut to a valid prefix:
# (Sq, Skv, causal, window, q_offset, kv_len).  A chunk of a long prompt
# against its cache; rows that see no key (a window past the valid keys;
# no valid key at all); a decode token; non-causal with a window; a
# q_offset past Skv; kv_len past Skv (every key)
K5_OFFSETS = [(256, 1024, True, 0, 768, 900), (100, 300, True, 37, 150, 200),
              (64, 200, False, 0, 0, 65), (130, 130, True, 0, 7, 0),
              (200, 300, True, 45, 250, 260), (1, 500, True, 0, 420, 421),
              (65, 200, False, 45, 30, 150), (70, 90, True, 0, 200, 1000)]
K5_OFFSET_DIMS = [(64, 64), (128, 128), (256, 256), (96, 64)]


@pytest.mark.parametrize("sq,skv,causal,window,q_offset,kv_len", K5_OFFSETS)
@pytest.mark.parametrize("d,dv", K5_OFFSET_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_with_offsets_matches_plain(cuda, sq, skv, causal,
                                                    window, q_offset, kv_len,
                                                    d, dv, dtype):
    """K5 with ``q_offset`` and ``kv_len`` (an int; a 0-d tensor on the
    card every other case) against the plain version: the shifted diagonal,
    the window and the valid prefix, and rows that see no key the mean of
    all Skv values."""
    if K5_OFFSETS.index((sq, skv, causal, window, q_offset, kv_len)) % 2:
        kv_len = torch.tensor(kv_len, device=cuda)
    _k5_case(cuda, 2, 4, 2, sq, skv, d, causal, window, dtype, dv=dv,
             q_offset=q_offset, kv_len=kv_len)


@pytest.mark.parametrize("sq,skv,causal,window,q_offset,kv_len", K5_OFFSETS)
@pytest.mark.parametrize("d,dv", K5_OFFSET_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_with_offsets_matches_plain(
        cuda, sq, skv, causal, window, q_offset, kv_len, d, dv, dtype):
    """K5b with ``q_offset`` and ``kv_len`` against its plain version, both
    fed K5's o and lse (whose rows that saw no key are the mask value in
    both): no gradient to a key past the valid prefix but the 1 / Skv of
    the rows that see no key in dV."""
    if K5_OFFSETS.index((sq, skv, causal, window, q_offset, kv_len)) % 2:
        kv_len = torch.tensor(kv_len, device=cuda)
    _, (_, dk, _), _ = _k5b_case(cuda, 2, 4, 2, sq, skv, d, causal, window,
                                 dtype, dv=dv, q_offset=q_offset,
                                 kv_len=kv_len)
    kvl = min(int(kv_len), skv)
    assert not dk[:, :, kvl:].any()


def test_a_kv_len_on_the_card_is_read_there(cuda):
    """A ``kv_len`` tensor on the card goes to K5 and K5b as a pointer:
    no call synchronizes with the host (torch's sync debug mode raises on
    one), and the result is the int's."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (2, 8, 64, 128), torch.bfloat16, cuda)
    k, v = (_randn(rng, (2, 2, 256, 128), torch.bfloat16, cuda)
            for _ in range(2))
    do = _randn(rng, (2, 8, 64, 128), torch.bfloat16, cuda)
    n = torch.tensor(150, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        o, lse = flash_attention(q, k, v, causal=True, q_offset=100,
                                 kv_len=n, return_lse=True)
        grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                    q_offset=100, kv_len=n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    o2, lse2 = flash_attention(q, k, v, causal=True, q_offset=100,
                               kv_len=150, return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b_ in zip(grads, flash_attention_bwd(q, k, v, o2, lse2, do,
                                                causal=True, q_offset=100,
                                                kv_len=150)):
        assert torch.equal(a, b_)


def test_layers_blocked_attention_takes_offsets_on_the_card(cuda):
    """``layers.blocked_attention`` with ``q_offset`` and ``kv_len`` runs K5
    (and K5b under grad) on the card, no plain attention: the gradients of
    autograd through the plain version (fp32)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(13)
    q = _randn(rng, (2, 40, 8, 64), torch.float32, cuda)
    k, v = (_randn(rng, (2, 120, 2, 64), torch.float32, cuda)
            for _ in range(2))
    do = _randn(rng, (2, 40, 8, 64), torch.float32, cuda)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    kw = dict(causal=True, window=48, q_offset=60,
              kv_len=torch.tensor(90, device=cuda))
    got = torch.autograd.grad(L.blocked_attention(*ins, **kw), ins, do)
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (1, 1)
    ref = [t.clone().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, **kw), ref,
                               do.transpose(1, 2))
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww.transpose(1, 2), rtol=1e-3,
                                   atol=2e-4)


def test_flash_attention_bwd_refuses_what_it_cannot_run(cuda):
    rng = np.random.default_rng(12)
    q = _randn(rng, (1, 2, 64, 32), torch.float32, cuda)
    k, v = (_randn(rng, (1, 1, 64, 32), torch.float32, cuda)
            for _ in range(2))
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :8], o)
    with pytest.raises(ValueError, match="do "):
        flash_attention_bwd(q, k, v, o, lse, o.bfloat16())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q[..., :24], k[..., :24], v[..., :24],
                            o[..., :24], lse, o[..., :24])
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        flash_attention_bwd(q, k, v, o, lse.cpu(), o)
    assert flash_attention_bwd.launches == before


# ---- K7b: the RG-LRU scan's backward ---------------------------------------

def _k7b_case(cuda, b, s, w, dtype, with_h0=True, seed=0, log_a_shift=0.0):
    """K7 (keeping its fp32 states) and K7b against their plain versions.
    fp32: the states within K7's bar (1e-4), the gradients within 1e-4
    (dlog_a, a sum over B x S terms in another order, 1e-3 relative); bf16:
    dx, dgx, dga one bf16 rounding apart (1e-2), the fp32 outputs 1e-3
    relative.  Returns (inputs, K7b's gradients)."""
    x, gx, ga, la, h0 = _rglru_inputs(b, s, w, dtype, cuda, seed=seed)
    la = la + log_a_shift
    if not with_h0:
        h0 = torch.zeros_like(h0)
    dy = _randn(np.random.default_rng(seed + 1), (b, s, w), dtype, cuda)
    y, h32 = rglru_scan(x, gx, ga, la, h0, keep_states=True)
    want_y, want_h = rglru_scan_plain(x, gx, ga, la, h0, keep_states=True)
    assert h32.dtype == torch.float32 and h32.shape == (b, s, w)
    assert torch.equal(y, rglru_scan(x, gx, ga, la, h0))
    torch.testing.assert_close(h32, want_h, rtol=1e-4, atol=1e-4)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(x, gx, ga, la, h0, h32, dy)
    torch.cuda.synchronize()
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_scan_bwd_plain(x, gx, ga, la, h0, h32, dy)
    bf = dtype == torch.bfloat16
    for name, gg, ww in zip(("dx", "dgx", "dga", "dlog_a", "dh0"), got,
                            want):
        assert gg.dtype == ww.dtype and gg.shape == ww.shape, name
        fp32_out = name in ("dlog_a", "dh0")
        tol = (1e-3 if fp32_out else 1e-2) if bf else 1e-4
        rtol = 1e-3 if name == "dlog_a" else tol
        torch.testing.assert_close(gg.float(), ww.float(), rtol=rtol,
                                   atol=tol, msg=name)
    return (x, gx, ga, la, h0, h32, dy), got


@pytest.mark.parametrize("b,s,w", RGLRU_SHAPES + [(2, 1, 256), (2, 31, 201),
                                                  (2, 255, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_matches_plain(cuda, b, s, w, dtype, with_h0):
    _k7b_case(cuda, b, s, w, dtype, with_h0)


# K7b's windows: S one cluster window (8 blocks of 32 steps) less one, one
# and one more, and 4096 (16 windows walked from the last), W a multiple of
# the 32-channel tile, W = 200 (the last tile ragged) and W = 201 (no
# 16-byte rows: the tiles staged element by element)
@pytest.mark.parametrize("s", [255, 256, 257, 4096])
@pytest.mark.parametrize("w", [256, 200, 201])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_windows_match_plain(cuda, s, w, dtype):
    _k7b_case(cuda, 2, s, w, dtype, seed=s + w)


def test_rglru_scan_bwd_where_the_clip_holds(cuda):
    """softplus(log_a) ~ 1e-13: 1 - exp(2 log_a_t) rounds to 0, below the
    clip at 1e-12, which passes no gradient."""
    _k7b_case(cuda, 2, 64, 40, torch.float32, log_a_shift=-30.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_repeats_bit_for_bit(cuda, dtype):
    """dlog_a is summed over B and S in a fixed order: two calls give the
    same bytes."""
    args, got = _k7b_case(cuda, 4, 300, 520, dtype)
    again = rglru_scan_bwd(*args)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


def test_ops_rglru_under_grad_runs_k7_and_k7b(cuda):
    """ops.rglru under grad: one K7 launch forward, one K7b backward, and
    the gradients of autograd through the plain version (fp32)."""
    x, gx, ga, la, h0 = _rglru_inputs(2, 100, 72, torch.float32, cuda)
    dy = _randn(np.random.default_rng(3), (2, 100, 72), torch.float32, cuda)
    ins = [t.clone().requires_grad_() for t in (x, gx, ga, la, h0)]
    before = (rglru_scan.launches, rglru_scan_bwd.launches)
    got = torch.autograd.grad(ops.rglru(*ins), ins, dy)
    assert (rglru_scan.launches - before[0],
            rglru_scan_bwd.launches - before[1]) == (1, 1)
    ref = [t.clone().requires_grad_() for t in (x, gx, ga, la, h0)]
    want = torch.autograd.grad(rglru_scan_plain(*ref), ref, dy)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-3, atol=1e-4)


def test_rglru_scan_bwd_refuses_what_it_cannot_run(cuda):
    x, gx, ga, la, h0 = _rglru_inputs(2, 40, 48, torch.float32, cuda)
    _, h32 = rglru_scan(x, gx, ga, la, h0, keep_states=True)
    before = rglru_scan_bwd.launches
    with pytest.raises(ValueError, match="h32"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32.bfloat16(), x)
    with pytest.raises(ValueError, match="dy"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32, x.bfloat16())
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        rglru_scan_bwd(x, gx, ga, la, h0, h32.cpu(), x)
    assert rglru_scan_bwd.launches == before


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


def _assert_quantize_bytes_equal(x):
    q, s = quantize_int8(x)
    wq, ws = quantize_int8_plain(x)
    assert torch.equal(q, wq)
    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("m,n", [(1, (1 << 22) + 3), (3, 1001), (3000, 40),
                                 (2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_given_absmax_bytes_equal_plain(cuda, offset, m, n,
                                                      dtype):
    """K3 given each row's absmax (a block of a split leaf takes the whole
    leaf's: here 1.5 times the row's own, one row NaN and one 0): one
    launch, codes and scales byte-equal to the plain version given the
    same, at an aligned and an unaligned base."""
    rng = np.random.default_rng(m + n + offset)
    flat = _randn(rng, (m * n + offset,), torch.float32, cuda).to(dtype)
    x = flat[offset:].view(m, n)
    absmax = x.float().abs().amax(dim=-1) * 1.5
    if m > 2:
        absmax[1] = float("nan")
        absmax[2] = 0.0
    before = quantize_int8.launches
    q, s = quantize_int8(x, absmax)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1
    wq, ws = quantize_int8_plain(x, absmax)
    assert torch.equal(q, wq)
    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))
    own, _ = quantize_int8(x)
    assert not torch.equal(own, q)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
@pytest.mark.parametrize("m,n", [(1, 4099), (3, 1001), (2, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_at_an_unaligned_base(cuda, offset, m, n, dtype):
    """x a contiguous view `offset` elements into its storage: the rows'
    heads and tails are taken one element at a time and the codes stored a
    byte at a time, and N is no multiple of 16."""
    rng = np.random.default_rng(offset * 31 + n)
    flat = _randn(rng, (m * n + offset,), torch.float32, cuda).to(dtype)
    x = flat[offset:].view(m, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _assert_quantize_bytes_equal(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_more_rows_than_the_grid(cuda, dtype):
    from repro_torch.kernels.vector_engine import quantize_plan
    resident = quantize_plan(1, 40, dtype)["resident"]
    m = 2 * resident + 3
    plan = quantize_plan(m, 40, dtype)
    assert plan["grid"] == resident and plan["segs"] == 1
    _assert_quantize_bytes_equal(_quant_input(m, 40, dtype, cuda))


def test_quantize_int8_spreads_one_long_row_over_the_grid(cuda):
    from repro_torch.kernels.vector_engine import quantize_plan
    plan = quantize_plan(1, 48 * 1024 * 4384, torch.float32)
    assert plan["grid"] == plan["resident"] == plan["segs"]
    assert plan["resident"] >= torch.cuda.get_device_properties(
        cuda).multi_processor_count


@pytest.mark.parametrize("m,n", [(1, (1 << 22) + 3), (3000, 40), (2, 64)])
def test_quantize_int8_graph_replays_are_byte_equal(cuda, m, n):
    """The grid barrier and the absmax scratch come back to rest inside
    the launch: a second replay of one graph gives the first's bytes."""
    x = _quant_input(m, n, torch.float32, cuda)
    first, second = _graph_replays(lambda: quantize_int8(x))
    wq, ws = quantize_int8_plain(x)
    for q, s in (first, second):
        assert torch.equal(q, wq)
        assert torch.equal(s.view(torch.int32), ws.view(torch.int32))


def test_quantize_int8_is_one_launch(cuda):
    """The profile of one quantize_int8 call holds one kernel, K3's.  The
    profiled call runs in a fresh process: in a process that has run other
    card tests first, torch.profiler can read no CUDA event at all, which
    says nothing of K3."""
    code = textwrap.dedent("""
        import json
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels.vector_engine import quantize_int8
        x = torch.randn(1, 1 << 20, device="cuda")
        quantize_int8(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            quantize_int8(x)
            torch.cuda.synchronize()
        print(json.dumps([e.key for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA]))
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    path = os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": path})
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "quantize_int8_kernel" in names[0], names


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
    """K1, K2 and K6 have no backward: under grad they raise and launch
    nothing.  K5 and K7 have theirs (K5b, K7b): under grad they keep the
    graph, and the gradient reaches the input that asked for it."""
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
             "lindley": lambda: ops.lindley(t, sv)}
    counters = (systolic_matmul, fused_affine_act, lindley_scan)
    before = [c.launches for c in counters]
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"ops.{name}:.*"
                           "no backward"):
            call()
    assert [c.launches for c in counters] == before
    with torch.no_grad():              # no graph to cut: the kernels run
        for call in calls.values():
            call()
    assert [c.launches - n for c, n in zip(counters, before)] == [1] * 3
    kept = {"attention": (lambda: ops.attention(q, k, v), q,
                          (flash_attention, flash_attention_bwd)),
            "rglru": (lambda: ops.rglru(rx, gx, ga, la, h0), la,
                      (rglru_scan, rglru_scan_bwd))}
    for name, (call, leaf, (fwd, bwd)) in kept.items():
        n = (fwd.launches, bwd.launches)
        out = call()
        assert out.requires_grad and out.grad_fn is not None, name
        (g,) = torch.autograd.grad(out.sum(), leaf)
        assert (fwd.launches - n[0], bwd.launches - n[1]) == (1, 1), name
        assert g.shape == leaf.shape and torch.isfinite(g).all(), name


# ---- the Qwen slice: K5 at head dim 128, the reduced decoders -------------

# (B, H, KV, S, D) of the Qwen serving paths at 1024 causal tokens:
# qwen3-8b (GQA 4:1), qwen1.5-4b (MHA 20:20), qwen3-moe-235b (GQA 16:1)
K5_QWEN = [(4, 32, 8, 1024, 128), (4, 20, 20, 1024, 128),
           (4, 64, 4, 1024, 128)]


@pytest.mark.parametrize("b,h,kv,s,d", K5_QWEN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_qwen_serving_shapes_match_plain(cuda, b, h, kv, s, d,
                                                         dtype):
    _k5_case(cuda, b, h, kv, s, s, d, True, 0, dtype)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen1.5-4b"])
def test_qwen_forward_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced model (fp32, QKV bias and qk-norm scales drawn nonzero)
    on the card, K5 in its 2 attention layers, against the same forward on
    the CPU (plain attention)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    for name, t in params["blocks"]["b0_attn"]["attn"].items():
        if name in ("bq", "bk", "bv", "qn", "kn"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.3, t.shape)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))
                           .astype(np.int32))
    want = T.forward(cfg, params, tok)
    before = flash_attention.launches
    got = T.forward(cfg, T.tree_map(lambda t: t.to(cuda), params),
                    tok.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---- Whisper and the paper's LMs: K5 at head dim 64 ------------------------

@pytest.mark.parametrize("b,h,sq,skv,causal", [
    (2, 16, 150, 1500, False), (1, 16, 1500, 1500, False),
    (1, 25, 992, 992, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_paper_serving_shapes_match_plain(
        cuda, monkeypatch, b, h, sq, skv, causal, dtype):
    """Whisper's encoder (1500 = 23 tiles of 64 and 28 keys, non-causal)
    and cross-attention (fewer queries than keys), GPT-2's 25 heads: within
    K5_REL, and in bf16 with planted faults (o x 0.9, the plain version
    without a key tile, the last query tile zeroed) reading above it."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, got, want = _k5_case(cuda, b, h, h, sq, skv, 64, causal, 0,
                                  dtype, rel=True)
    if dtype != torch.bfloat16:
        return
    t0 = (skv // 2 if causal else skv - 1) // 64 * 64
    real = FA._mask

    def dropped(*args):
        keep = real(*args)
        keep[:, t0:t0 + 64] = False
        return keep

    monkeypatch.setattr(FA, "_mask", dropped)
    drop = flash_attention_plain(q, k, v, causal=causal)
    monkeypatch.undo()
    zeroed = got.clone()
    zeroed[:, :, (sq - 1) // 128 * 128:] = 0
    for fault in (got * 0.9, drop, zeroed):
        assert _rel_frobenius(fault, want) > K5_REL[dtype]


def test_whisper_prefill_on_the_card_matches_the_cpu(cuda):
    """The reduced Whisper's prefill with frames on the card (K5 in its 2
    encoder, 2 self- and 2 cross-attention layers) against the same
    prefill on the CPU (plain attention): logits and the xk/xv cache."""
    from repro_torch.configs import get_arch
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T
    cfg = get_arch("whisper-medium").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))
                           .astype(np.int32))
    frames = torch.from_numpy(rng.normal(0, 0.02, (2, cfg.encoder_seq,
                                                   cfg.d_model))
                              .astype(np.float32))
    want, want_cache = DE.prefill(cfg, params, tok, encoder_frames=frames)
    before = flash_attention.launches
    got, cache = DE.prefill(cfg, T.tree_map(lambda t: t.to(cuda), params),
                            tok.to(cuda), encoder_frames=frames.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + (2 * cfg.num_layers
                                                 + cfg.encoder_layers)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in ("k", "v", "xk", "xv"):
        torch.testing.assert_close(cache["blocks"]["b0_attn"][name].cpu(),
                                   want_cache["blocks"]["b0_attn"][name],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["gpt2-1.5b", "bert-base"])
def test_paper_lm_forward_on_the_card_matches_the_cpu(cuda, name):
    """The reduced GPT-2 and BERT (learned positions, gelu) on the card, K5
    in their 2 layers, against the same forward on the CPU."""
    from repro_torch.configs.paper_suite import PAPER_LM_SUITE
    from repro_torch.models import transformer as T
    cfg = PAPER_LM_SUITE[name].reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    want = T.forward(cfg, params, tok)
    before = flash_attention.launches
    got = T.forward(cfg, T.tree_map(lambda t: t.to(cuda), params),
                    tok.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---- MLA and the vision frontend: K5 at (Dqk, Dv) pairs -------------------

# minicpm3-4b's (96, 64), ViT-632M's 80, the reduced MLA's (32, 16)
K5_PAIRS = [(96, 64), (80, 80), (32, 16)]


@pytest.mark.parametrize("d,dv", K5_PAIRS)
@pytest.mark.parametrize("sq,skv", K5_LENGTHS)
@pytest.mark.parametrize("causal,window", K5_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_pairs_match_plain(cuda, d, dv, sq, skv,
                                                    causal, window, dtype):
    """A value head dim of its own: Sq and Skv around the tiles (ragged
    Skv), windows off the tile; scores scaled by 1 / sqrt(Dqk)."""
    _k5_case(cuda, 1, 2, 1, sq, skv, d, causal, window, dtype, dv=dv)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (16, 4), (10, 1)])
@pytest.mark.parametrize("d,dv", [(80, 80), (96, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_pairs_gqa_match_plain(cuda, h, kv, d, dv,
                                                        dtype):
    """GQA groups of 1 to 10 query heads at ViT-632M's and MLA's dims, a
    ragged 300 keys."""
    _k5_case(cuda, 2, h, kv, 300, 300, d, True, 0, dtype, rel=True, dv=dv)


@pytest.mark.parametrize("b,h,s,d,dv", [(4, 40, 1024, 96, 64),
                                        (4, 16, 512, 80, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_and_vit_serving_shapes_match_plain(
        cuda, monkeypatch, b, h, s, d, dv, dtype):
    """minicpm3-4b's prefill attention (40 heads, KV 40, q/k 96, v 64) and
    ViT-632M's (16 heads of 80), causal: within K5_REL, and in bf16 with
    planted faults (o x 0.9, the plain version without a key tile, the
    last query tile zeroed) reading above it."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, got, want = _k5_case(cuda, b, h, h, s, s, d, True, 0, dtype,
                                  rel=True, dv=dv)
    if dtype != torch.bfloat16:
        return
    t0 = s // 2 // 64 * 64
    real = FA._mask

    def dropped(*args):
        keep = real(*args)
        keep[:, t0:t0 + 64] = False
        return keep

    monkeypatch.setattr(FA, "_mask", dropped)
    drop = flash_attention_plain(q, k, v, causal=True)
    monkeypatch.undo()
    zeroed = got.clone()
    zeroed[:, :, (s - 1) // 128 * 128:] = 0
    for fault in (got * 0.9, drop, zeroed):
        assert _rel_frobenius(fault, want) > K5_REL[dtype]


def test_flash_attention_bwd_refuses_head_dim_pairs(cuda):
    """K5b is built for the pairs of HEAD_DIM_PAIRS, MLA's (96, 64) and
    ViT's 80 among them (one launch each, a gradient of q's, k's and v's
    shapes), and refuses any other pair, (32, 24) here, by name before a
    launch."""
    rng = np.random.default_rng(3)
    for d, dv in ((96, 64), (80, 80)):
        q, k = (_randn(rng, (1, 2, 64, d), torch.bfloat16, cuda)
                for _ in range(2))
        v = _randn(rng, (1, 2, 64, dv), torch.bfloat16, cuda)
        o, lse = flash_attention(q, k, v, return_lse=True)
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, o, lse, o)
        assert flash_attention_bwd.launches == before + 1
        assert [tuple(g.shape) for g in got] == [tuple(q.shape),
                                                 tuple(k.shape),
                                                 tuple(v.shape)]
    q, k = (_randn(rng, (1, 2, 64, 32), torch.bfloat16, cuda)
            for _ in range(2))
    v = _randn(rng, (1, 2, 64, 24), torch.bfloat16, cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match=r"\(q/k 32, v 24\)"):
        flash_attention_bwd(q, k, v, v, lse, v)
    assert flash_attention_bwd.launches == before


@pytest.mark.parametrize("d,dv", K5_PAIRS)
@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 64), (65, 200), (200, 65),
                                    (130, 130)])
@pytest.mark.parametrize("causal,window", K5_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_head_dim_pairs_match_plain(cuda, d, dv, sq, skv,
                                                        causal, window,
                                                        dtype):
    """K5b at a value head dim of its own (MLA's (96, 64), the reduced
    MLA's (32, 16)) and at ViT-632M's 80: Sq and Skv around the tiles,
    windows off the tile, causal or not; GQA 2:1."""
    _k5b_case(cuda, 1, 4, 2, sq, skv, d, causal, window, dtype, dv=dv)


@pytest.mark.parametrize("h,kv", [(4, 4), (16, 4), (10, 1)])
@pytest.mark.parametrize("d,dv", [(80, 80), (96, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_head_dim_pairs_gqa_match_plain(cuda, h, kv, d,
                                                            dv, dtype):
    """dK and dV summed over GQA groups of 1, 4 and 10 query heads (a
    cluster of ranks splits them in bf16) at the new pairs, a ragged 300
    keys, twice byte for byte."""
    args, got, _ = _k5b_case(cuda, 2, h, kv, 300, 300, d, True, 0, dtype,
                             dv=dv)
    again = flash_attention_bwd(*args, causal=True, window=0)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,h,s,d,dv", [(4, 40, 1024, 96, 64),
                                        (4, 16, 512, 80, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_mla_and_vit_training_shapes_match_plain(
        cuda, monkeypatch, b, h, s, d, dv, dtype):
    """minicpm3-4b's training attention (40 heads, KV 40, q/k 96, v 64) and
    ViT-632M's (16 heads of 80), causal: within K5B_REL, and in bf16 with
    planted faults (dQ x 0.9, the plain version without a 64-key tile)
    reading above it."""
    from repro_torch.kernels import flash_attention as FA
    args, got, want = _k5b_case(cuda, b, h, h, s, s, d, True, 0, dtype,
                                dv=dv)
    if dtype != torch.bfloat16:
        return
    t0 = s // 2 // 64 * 64
    real = FA._mask

    def dropped(*a):
        keep = real(*a)
        keep[:, t0:t0 + 64] = False
        return keep

    monkeypatch.setattr(FA, "_mask", dropped)
    drop = flash_attention_bwd_plain(*args, causal=True, window=0)
    monkeypatch.undo()
    assert _rel_frobenius(got[0] * 0.9, want[0]) > K5B_REL[dtype]
    for gg, ww in zip(drop, want):
        assert _rel_frobenius(gg, ww) > K5B_REL[dtype]


@pytest.mark.parametrize("arch", ["minicpm3-4b", "vit-632m"])
def test_mla_and_vit_training_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MLA (v head dim 16: K5 and K5b at (32, 16)) and the
    reduced ViT-632M at its head dim 80 (K5 and K5b at (80, 80)), fp32:
    the loss and every gradient leaf of ``launch.steps.value_and_grad`` on
    the card (K5 twice a layer under ``cfg.remat``, the forward and its
    recompute, and K5b once) against the same on the CPU (the
    plain versions), at the fp32 gradient checks' bars (loss 1e-5, leaves
    1e-3 relative Frobenius)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_suite import PAPER_LM_SUITE
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    cfg = ({**PAPER_LM_SUITE}.get(arch) or get_arch(arch)).reduced()
    cfg = dataclasses.replace(
        cfg, **({"v_head_dim": 16} if cfg.attention == "mla"
                else {"head_dim": 80}))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = TokenStream(cfg, 2, 100, 0, device="cpu").batch_at(0)
    want_loss, want = ST.value_and_grad(cfg, params, batch)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    loss, got = ST.value_and_grad(
        cfg, T.tree_map(lambda t: t.to(cuda), params),
        {k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (
                (2 if cfg.remat else 1) * cfg.num_layers, cfg.num_layers)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for a, b_ in zip(T.tree_leaves(got), T.tree_leaves(want)):
        assert torch.isfinite(a).all()
        assert ((a.cpu() - b_).norm() / b_.norm().clamp_min(1e-30)) <= 1e-3


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-vl-72b", "vit-632m"])
def test_mla_and_vlm_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MLA (v head dim 16: K5 at (32, 16)), qwen2-vl (M-RoPE)
    and ViT-632M with random patch embeddings: the prefill on the card (K5
    once a layer) against the same prefill on the CPU (plain attention),
    logits and every cache leaf; then one decode step each."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_suite import PAPER_LM_SUITE
    from repro_torch.models import decode as DE
    from repro_torch.models import transformer as T
    cfg = {**PAPER_LM_SUITE}.get(arch) or get_arch(arch)
    cfg = cfg.reduced()
    if cfg.attention == "mla":
        cfg = dataclasses.replace(cfg, v_head_dim=16)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))
                           .astype(np.int32))
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    want, want_cache = DE.prefill(cfg, params, tok, **kw)
    on_card = T.tree_map(lambda t: t.to(cuda), params)
    before = flash_attention.launches
    got, cache = DE.prefill(cfg, on_card, tok.to(cuda),
                            **{k: t.to(cuda) for k, t in kw.items()})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b_ in zip(T.tree_leaves(cache), T.tree_leaves(want_cache)):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-4, atol=1e-4)
    nxt = torch.argmax(want[:, -1], dim=-1)[:, None].to(torch.int32)
    from repro_torch.launch.serve import _grow_cache
    dl, _ = DE.decode_step(cfg, on_card, _grow_cache(cfg, cache, 2, 41),
                           nxt.to(cuda))
    wl, _ = DE.decode_step(cfg, params, _grow_cache(cfg, want_cache, 2, 41),
                           nxt)
    torch.testing.assert_close(dl.cpu(), wl, rtol=1e-4, atol=1e-4)


# ---- expert-parallel MoE over ranks sharing the card --------------------------

def test_moe_ffn_ep_over_two_ranks_on_the_card_is_the_gather_path(cuda,
                                                                   tmp_path):
    """A 2-rank gloo (1, 2) mesh on the card (the ranks share it; gloo
    carries CUDA tensors) runs ``moe_ffn_ep`` at a reduced width, each rank
    4 of 8 experts: within 1e-5 (fp32, TF32 off) of the gather path
    (``layers.moe_ffn``) on the card, at a capacity factor where nothing
    drops and at 1.25, where both drop the same assignments."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_mesh_ranks import EP_CAPACITY, ep_card_rank
    rng = np.random.default_rng(0)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    B, S, D, E, F_, K = 2, 64, 128, 8, 64, 2
    inputs = {"x": f(B, S, D), "wg": f(D, E, std=0.3),
              "w1": f(E, D, F_, std=0.1), "w3": f(E, D, F_, std=0.1),
              "w2": f(E, F_, D, std=0.1), "k": np.int32(K)}
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "ranks").mkdir()
    M.run_ranks(ep_card_rank, 2, str(tmp_path / "inputs.npz"),
                str(tmp_path / "ranks"), timeout_s=300)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inputs.items()
         if k != "k"}
    for cf in EP_CAPACITY:
        want, aux = L.moe_ffn(t["x"].reshape(B * S, D), t["wg"], t["w1"],
                              t["w3"], t["w2"], num_experts=E, k=K,
                              capacity_factor=cf)
        for r in range(2):
            got = np.load(tmp_path / "ranks" / f"rank{r}.npz")
            np.testing.assert_allclose(got[f"ep_{cf}"].reshape(B * S, D),
                                       want.cpu().numpy(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[f"ep_{cf}_aux"], aux.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
