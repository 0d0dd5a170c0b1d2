"""The port's Lindley scan (K6) and segmented solver against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernel in interpret mode under ``jax.enable_x64(True)``, and through
the port's ``ops.lindley`` on CPU tensors, which takes the kernel's plain
PyTorch version: the outputs must be byte-equal, as the numpy solver they
both mirror is.  The JAX package's jnp oracle, whose cumsum XLA
re-associates, is held at its own tolerance.  The JAX package's
``ops.lindley`` is not used: it imports ``jax.experimental.enable_x64``,
which the installed jax no longer has.  The solver's ``torch`` backend must
be byte-equal to the JAX package's ``segmented`` backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lindley as jlindley
from repro.kernels import ref as jref
from repro.kernels.lindley import lindley_scan as jax_lindley_scan
from repro_torch.core import lindley
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lindley import lindley_scan


def _queues(r, w, seed=11):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 100.0, size=(r, w)), axis=1)
    s = rng.uniform(1e-3, 4.0, size=(r, w))
    return t, s


@pytest.mark.parametrize("r,w", [(3, 17), (128, 128), (200, 300), (1, 1)])
def test_ops_lindley_bytes_equal_jax_kernel_and_ref(r, w):
    t, s = _queues(r, w)
    got = ops.lindley(torch.from_numpy(t), torch.from_numpy(s))
    assert got.dtype == torch.float64 and tuple(got.shape) == (r, w)
    with jax.enable_x64(True):
        kern = np.asarray(jax_lindley_scan(jnp.asarray(t), jnp.asarray(s),
                                           interpret=True))
        want = np.asarray(jref.lindley_ref(jnp.asarray(t), jnp.asarray(s)))
    assert kern.dtype == want.dtype == np.float64
    assert got.numpy().tobytes() == kern.tobytes()
    assert ref.lindley_ref(torch.from_numpy(t),
                           torch.from_numpy(s)).numpy().tobytes() \
        == kern.tobytes()
    # the jnp oracle's cumsum is XLA's, which re-associates the prefix sums;
    # tests/test_kernels.py holds the kernel to it at this tolerance
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _segments(seed, nserv, n):
    """The (seed, nserv, n) draw of tests/test_kernels.py: sorted keys,
    arrivals sorted within each server's segment."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nserv, size=n))
    t = rng.uniform(0.0, 60.0, size=n)
    seg = jlindley.segment_fenceposts(keys, 0, nserv)
    for j in range(nserv):
        t[seg[j]:seg[j + 1]].sort()
    s = rng.uniform(1e-3, 3.0, size=n)
    return seg, t, s


def _zipf(n, nserv, zipf_s=1.2):
    """A Zipf draw made as benchmarks/bench_engine.py makes its
    ``lindley-zipf-1m`` solver cell, at a small size."""
    rng = np.random.default_rng(0)
    p = np.arange(1, nserv + 1, dtype=np.float64) ** -zipf_s
    p /= p.sum()
    keys = np.sort(rng.choice(nserv, size=n, p=p))
    t = np.sort(rng.uniform(0.0, n / 1e4, size=n))
    s = rng.uniform(1e-4, 2e-3, size=n)
    return jlindley.segment_fenceposts(keys, 0, nserv), t, s


def _solve(mod, seg, t, s, backend):
    start, fin = np.empty(t.size), np.empty(t.size)
    mod.solve_segments(seg, t, s, start, fin, backend=backend)
    return start.tobytes(), fin.tobytes()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("nserv,n", [(6, 500), (1, 700), (40, 64)])
def test_solver_torch_backend_bytes_equal_jax_segmented(seed, nserv, n):
    seg, t, s = _segments(seed, nserv, n)
    want = _solve(jlindley, seg, t, s, "segmented")
    for backend in ("torch", "segmented", "dense"):
        assert _solve(lindley, seg, t, s, backend) == want, backend


def test_solver_torch_backend_bytes_equal_on_zipf_skew():
    seg, t, s = _zipf(20_000, 16)
    lens = np.diff(seg)
    assert lens.max() > 8 * np.median(lens)       # one hot server
    want = _solve(jlindley, seg, t, s, "segmented")
    assert _solve(lindley, seg, t, s, "torch") == want
    assert lindley.queue_depth_max(seg, np.frombuffer(want[0]), t) \
        == jlindley.queue_depth_max(seg, np.frombuffer(want[0]), t)


def test_solver_empty_input_is_a_no_op():
    seg = np.zeros(4, dtype=np.int64)
    e = np.empty(0)
    lindley.solve_segments(seg, e, e, e, e, backend="torch")


def test_cuda_backend_raises_without_a_card(monkeypatch):
    seg, t, s = _segments(0, 6, 50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lindley.DEFAULT_BACKEND == "cuda"
    for kw in ({"backend": "cuda"}, {}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lindley.solve_segments(seg, t, s, np.empty(50), np.empty(50),
                                   **kw)


def test_unknown_backend_and_pallas_are_rejected():
    seg, t, s = _segments(0, 6, 50)
    for backend in ("pallas", "flat"):
        with pytest.raises(ValueError, match="backend"):
            lindley.solve_segments(seg, t, s, np.empty(50), np.empty(50),
                                   backend=backend)


def test_kernel_wrapper_takes_only_cuda_tensors():
    t, s = (torch.from_numpy(a) for a in _queues(2, 5))
    before = lindley_scan.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        lindley_scan(t, s)
    assert lindley_scan.launches == before
