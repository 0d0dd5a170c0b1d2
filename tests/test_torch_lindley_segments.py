"""K6's one-launch-a-solve form against the JAX package, on the CPU.

``ops.lindley_segments(seg, t, s)`` takes a solve's flat columns and its
fenceposts; on CPU tensors it runs the kernel's plain version, which must
give the JAX package's ``segmented`` solver's bytes, empty segments,
segments of one and n = 0 included.  A NaN must propagate as numpy's
maximum propagates it, as the JAX Pallas kernel (interpret mode) gives it.

``csrc/lindley.cu`` splits the work: one thread walks the cumsum in order
and keeps c at the start of each lane's run of steps; each lane adds its
run again from there; the running max is a fold of each lane's run, a
warp shuffle scan of the lanes' totals and a carry across tiles, in
numpy's rule (``(a >= b or isnan(a)) ? a : b``, the earlier operand
first).
``kernel_model`` is that decomposition in numpy, step for step; it must
give numpy's bytes at the kernel's tile and warp sizes and at a small
ragged plan.  It is the only check of the scan's order before a card runs
the kernel.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lindley as jlindley
from repro.kernels.lindley import lindley_scan as jax_lindley_scan
from repro_torch.core import lindley
from repro_torch.kernels import ops
from repro_torch.kernels.lindley import LANE_STEPS, TILE, lindley_scan
from test_torch_lindley import _segments, _zipf

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "lindley.cu")


def _jax_segmented(seg, t, s):
    start, fin = np.empty(t.size), np.empty(t.size)
    jlindley.solve_segments(seg, t, s, start, fin, backend="segmented")
    return start


def _ops_segments(seg, t, s):
    return ops.lindley_segments(torch.from_numpy(seg), torch.from_numpy(t),
                                torch.from_numpy(s)).numpy()


def _edges():
    """Empty segments (first, inside, last), segments of one, a longer
    one, and the NaN rows: a NaN arrival, a NaN demand, and two NaN
    arrivals of other bits in one queue (numpy's and the negative NaN that
    inf - inf gives on x86), of which the first must be carried on."""
    rng = np.random.default_rng(3)
    lens = np.array([0, 1, 5, 0, 0, 1, 40, 3, 0])
    seg = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(seg[-1])
    t = np.empty(n)
    for j in range(lens.size):
        t[seg[j]:seg[j + 1]] = np.sort(rng.uniform(0.0, 5.0, lens[j]))
    s = rng.uniform(1e-3, 2.0, n)
    t_nan, s_nan = t.copy(), s.copy()
    t_nan[seg[6] + 7] = np.nan
    s_nan[seg[2] + 1] = np.nan
    t_nan2 = t_nan.copy()
    t_nan2[seg[6] + 20] = np.array([0xfff8000000000000],
                                   dtype=np.uint64).view(np.float64)[0]
    return seg, {"plain": (t, s), "nan_t": (t_nan, s), "nan_s": (t, s_nan),
                 "nan_2": (t_nan2, s)}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("nserv,n", [(6, 500), (1, 700), (40, 64), (300, 900)])
def test_lindley_segments_bytes_equal_jax_segmented(seed, nserv, n):
    seg, t, s = _segments(seed, nserv, n)
    got = _ops_segments(seg, t, s)
    assert got.dtype == np.float64 and got.shape == (n,)
    assert got.tobytes() == _jax_segmented(seg, t, s).tobytes()


def test_lindley_segments_bytes_equal_jax_segmented_on_zipf():
    seg, t, s = _zipf(20_000, 16)
    assert _ops_segments(seg, t, s).tobytes() \
        == _jax_segmented(seg, t, s).tobytes()


@pytest.mark.parametrize("case", ["plain", "nan_t", "nan_s", "nan_2"])
def test_lindley_segments_edges_bytes_equal_jax_segmented(case):
    seg, cases = _edges()
    t, s = cases[case]
    got = _ops_segments(seg, t, s)
    want = _jax_segmented(seg, t, s)
    assert got.tobytes() == want.tobytes()
    assert np.isnan(got).any() == (case != "plain")


def test_lindley_segments_takes_n_zero_and_no_segments():
    e = np.empty(0)
    for seg in (np.zeros(1, dtype=np.int64), np.zeros(5, dtype=np.int64)):
        assert _ops_segments(seg, e, e).shape == (0,)


@pytest.mark.parametrize("seg", [[1, 3], [0, 2], [0, 3, 2, 4], []])
def test_fenceposts_that_do_not_rise_from_0_to_n_raise(seg):
    """Elements outside every segment would come back unwritten: the
    plain version refuses, and the solver checks before any copy (the
    cuda backend's check is this one, on the host)."""
    _, t, s = _segments(0, 2, 4)
    seg = np.array(seg, dtype=np.int64)
    with pytest.raises(ValueError, match="fenceposts"):
        _ops_segments(seg, t, s)
    with pytest.raises(ValueError, match="fenceposts"):
        lindley.solve_segments(seg, t, s, np.empty(4), np.empty(4),
                               backend="torch")


def test_nan_propagates_as_the_jax_kernel_gives_it():
    """The smallest input on which a max that keeps b when a is NaN
    differs: the running max is NaN after step 0 and must stay NaN."""
    t, s = np.array([[np.nan, 1.0]]), np.array([[1.0, 1.0]])
    with jax.enable_x64(True):
        want = np.asarray(jax_lindley_scan(jnp.asarray(t), jnp.asarray(s),
                                           interpret=True))
    assert np.isnan(want).all()
    seg = np.array([0, 2], dtype=np.int64)
    flat = _ops_segments(seg, t[0], s[0])
    assert flat.tobytes() == want[0].tobytes()
    assert ops.lindley(torch.from_numpy(t), torch.from_numpy(s)).numpy() \
        .tobytes() == want.tobytes()
    assert kernel_model(seg, t[0], s[0]).tobytes() == want[0].tobytes()
    assert _jax_segmented(seg, t[0], s[0]).tobytes() == want[0].tobytes()


# ---- a plain model of the kernel's decomposition ---------------------------

def npmax(a, b):
    """numpy's maximum, elementwise: a on ties, a NaN in either kept."""
    with np.errstate(invalid="ignore"):
        return np.where((a >= b) | np.isnan(a), a, b)


def kernel_model(seg, t, s, *, tile=TILE, lanes=32):
    """csrc/lindley.cu's function through its decomposition: per segment,
    tiles of ``tile`` steps; the chain's cumsum in order, kept at the start
    of each lane's run of ``tile // lanes`` steps; each of ``lanes`` lanes
    adds its run again from there and folds it; a Hillis-Steele shuffle
    scan of the lanes' totals; the carry across tiles."""
    run = tile // lanes
    out = np.full(t.size, -1.0)
    for j in range(seg.size - 1):
        a, e = int(seg[j]), int(seg[j + 1])
        c, carry = np.float64(0.0), np.float64(-np.inf)
        for k0 in range(a, e, tile):
            n = min(tile, e - k0)
            tv = np.zeros(tile)
            sv = np.zeros(tile)
            tv[:n], sv[:n] = t[k0:k0 + n], s[k0:k0 + n]
            # the chain: one add after another, c kept at each run's start
            c_run = np.zeros(lanes)
            for i in range(n):
                if i % run == 0:
                    c_run[i // run] = c
                c = c + sv[i]
            # each lane adds its run again from there
            cv = np.zeros((lanes, run))
            acc_c = c_run.copy()
            for u in range(run):
                acc_c = acc_c + sv.reshape(lanes, run)[:, u]
                cv[:, u] = acc_c
            p = cv.reshape(-1) - sv
            x = np.where(np.arange(tile) < n, tv - p, -np.inf)
            x = x.reshape(lanes, run)
            f = np.empty_like(x)            # each lane's in-lane fold
            acc = np.full(lanes, -np.inf)
            for u in range(run):
                acc = npmax(acc, x[:, u])
                f[:, u] = acc
            inc = acc.copy()                # the lanes' totals, scanned
            d = 1
            while d < lanes:
                y = np.concatenate([np.full(d, np.nan), inc[:-d]])
                inc = np.where(np.arange(lanes) >= d, npmax(y, inc), inc)
                d *= 2
            before = np.concatenate([[np.nan], inc[:-1]])
            pre = np.where(np.arange(lanes) == 0, carry,
                           npmax(np.full(lanes, carry), before))
            m = npmax(pre[:, None], f).reshape(-1)
            out[k0:k0 + n] = npmax(tv, m + p)[:n]
            carry = npmax(carry, inc[-1])
    return out


def test_kernel_constants_are_the_source_s():
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int TILE = (\d+);", src)[1]) == TILE
    assert re.search(r"constexpr int LANE_STEPS = TILE / 32;", src)
    assert LANE_STEPS == TILE // 32


@pytest.mark.parametrize("plan", [(TILE, 32), (6, 3), (8, 4)])
@pytest.mark.parametrize("draw", ["segments", "zipf", "edges", "nan_t",
                                  "nan_s", "nan_2"])
def test_kernel_model_gives_numpy_bytes(plan, draw):
    tile, lanes = plan
    if draw == "segments":
        seg, t, s = _segments(5, 7, 1500)
    elif draw == "zipf":
        seg, t, s = _zipf(3000, 8)
    else:
        seg, cases = _edges()
        t, s = cases["plain" if draw == "edges" else draw]
    got = kernel_model(seg, t, s, tile=tile, lanes=lanes)
    assert got.tobytes() == _jax_segmented(seg, t, s).tobytes()


def test_solver_torch_backend_is_one_call_a_solve(monkeypatch):
    """The torch and cuda backends hand ops.lindley_segments the whole
    solve once; the per-bucket ops.lindley is not called."""
    seg, t, s = _segments(0, 12, 400)
    calls = []
    real = ops.lindley_segments
    monkeypatch.setattr(ops, "lindley_segments",
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(ops, "lindley", None)
    start, fin = np.empty(t.size), np.empty(t.size)
    lindley.solve_segments(seg, t, s, start, fin, backend="torch")
    assert len(calls) == 1
    assert [tuple(a.shape) for a in calls[0]] == [(13,), (400,), (400,)]
    assert start.tobytes() == _jax_segmented(seg, t, s).tobytes()
    assert fin.tobytes() == (start + s).tobytes()


def test_segments_wrapper_takes_only_cuda_tensors():
    seg, t, s = (torch.from_numpy(a) for a in _segments(0, 3, 20))
    from repro_torch.kernels.lindley import lindley_scan_segments
    before = lindley_scan.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        lindley_scan_segments(seg, t, s)
    assert lindley_scan.launches == before
