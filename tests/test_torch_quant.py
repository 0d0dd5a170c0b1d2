"""The port's int8 quantize/dequantize (K3's and K4's plain versions) and
gradient compression against the JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.ops.quantize`` and
``dequantize`` (the Pallas kernels in interpret mode), ``repro.kernels.ref``
and ``repro.distributed.compression``, and through the port's ``ops`` and
``distributed.compression`` on CPU tensors, which run the plain versions.
The codes must be byte-equal, as ``tests/test_kernels.py:85`` demands of
the TPU kernel, and so must the scales, the dequantized values and the
error-feedback residuals: every step is one IEEE-rounded fp32 operation in
both packages.  One exception, in the reference: under ``jit`` (and the
interpret-mode Pallas kernel is jitted) XLA's CPU compiler turns the scale's
``/ 127.0`` into a multiply by the reciprocal, which is one ulp off the
division in some rows; eager JAX (``ref.quantize_int8_ref``,
``compress_grads``) divides.  The port divides, as ``ref.quantize_int8_ref``
does, so its codes and scales are byte-equal to the ref's; the jitted
kernel's scales are within one ulp of them, and its codes are byte-equal to
the port's in every row where the two scales agree (in bfloat16 a few codes
of the other rows move with the scale: 3 to 8 of 32,768 at (128, 256)).
The CUDA kernels are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here only their argument
checks run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.distributed import compression as C
from repro_torch.kernels import ops, ref
from repro_torch.kernels.vector_engine import dequantize_int8, quantize_int8
from repro_torch.models import transformer as T


def _case(name, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = {"scaled": lambda: rng.standard_normal((128, 256),
                                               dtype=np.float32) * 3.0,
         "ragged": lambda: rng.standard_normal((3, 1000), dtype=np.float32),
         "one_row": lambda: rng.standard_normal((1, 4096), dtype=np.float32),
         "zero_row": lambda: np.concatenate(
             [np.zeros((1, 64), np.float32),
              rng.standard_normal((1, 64), dtype=np.float32)]),
         }[name]()
    jx = jnp.asarray(x).astype(dtype)
    return np.array(jx.astype(jnp.float32)), jx


def _torch(x32, dtype):
    t = torch.from_numpy(x32)
    return t.bfloat16() if dtype == jnp.bfloat16 else t


CASES = ["scaled", "ragged", "one_row", "zero_row"]
DTYPES = [jnp.float32, jnp.bfloat16]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_bytes_equal_jax_kernel_and_ref(name, dtype):
    x32, jx = _case(name, dtype)
    q, s = ops.quantize(_torch(x32, dtype))
    jq, js = jops.quantize(jx)
    rq, rs = jref.quantize_int8_ref(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x32.shape and s.shape == (x32.shape[0], 1)
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    # the jitted interpret-mode kernel: scales within one ulp, codes equal
    # where the scales are, and its codes are the same formula on its scale
    js, jq = np.asarray(js), np.asarray(jq)
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                  - js.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    same = (ulps == 0)[:, 0]
    assert same.any()
    assert q.numpy()[same].tobytes() == jq[same].tobytes()
    x = torch.from_numpy(x32)
    with_js = torch.clamp(torch.round(x / torch.from_numpy(js)), -127, 127)
    assert with_js.to(torch.int8).numpy().tobytes() == jq.tobytes()
    pq, ps = ref.quantize_int8_ref(_torch(x32, dtype))
    assert torch.equal(pq, q) and torch.equal(ps, s)
    if name == "zero_row":
        assert (q[0] == 0).all() and s[0, 0].item() == np.float32(1e-12) / \
            np.float32(127.0)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("out_dtype", DTYPES)
def test_dequantize_bytes_equal_jax_kernel_and_ref(name, out_dtype):
    x32, jx = _case(name, jnp.float32, seed=1)
    jq, js = jops.quantize(jx)
    q, s = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    tdt = torch.bfloat16 if out_dtype == jnp.bfloat16 else torch.float32
    got = ops.dequantize(q, s, out_dtype=tdt)
    want = jops.dequantize(jq, js, out_dtype=out_dtype)
    rwant = jref.dequantize_int8_ref(jq, js, out_dtype=out_dtype)
    assert got.dtype == tdt and got.shape == x32.shape
    for w in (want, rwant):
        w = np.asarray(w)
        got_bits = (got.view(torch.int16) if tdt == torch.bfloat16
                    else got).numpy()
        assert got_bits.tobytes() == w.tobytes()
    assert torch.equal(ref.dequantize_int8_ref(q, s, out_dtype=tdt), got)
    # the JAX package's default out_dtype is float32
    assert ops.dequantize(q, s).dtype == torch.float32


def test_quantize_roundtrip_error_bound():
    """tests/test_kernels.py::test_vector_engine_quant_roundtrip's bound."""
    x32, _ = _case("scaled", jnp.float32)
    x = torch.from_numpy(x32)
    q, s = ops.quantize(x)
    xd = ops.dequantize(q, s)
    assert (xd - x).abs().max().item() <= s.max().item() * 0.51


def test_rounding_is_half_to_even():
    """x / scale exactly at .5 rounds to the even code, as jnp.round does:
    with absmax 127 the scale is 1, so the codes are rint(x)."""
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]],
                 np.float32)
    q, s = ops.quantize(torch.from_numpy(x))
    jq, js = jops.quantize(jnp.asarray(x))
    assert s.item() == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, -2, 126, 127]]
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()


def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (33, 17), "b": (5,), "blocks": [(2, 8, 16), (1,)],
              "emb": (64, 24)}

    def mk(scale):
        out = {}
        for k, shp in shapes.items():
            if isinstance(shp, list):
                out[k] = [rng.standard_normal(s, dtype=np.float32) * scale
                          for s in shp]
            else:
                out[k] = rng.standard_normal(shp, dtype=np.float32) * scale
        return out

    g, e = mk(1.0), mk(1e-3)
    g["b"][:] = 0.0                        # an all-zero leaf
    return g, e


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _pairs(tree, jtree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], jtree[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, jtree):
            yield from _pairs(a, b)
    else:
        yield tree, np.asarray(jtree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grads_bytes_equal_jax(seed):
    g, e = _grad_trees(seed)
    deq, err = C.compress_grads(_to_torch(g), _to_torch(e))
    jdeq, jerr = JC.compress_grads(g, e)
    n = 0
    for tree, jtree in ((deq, jdeq), (err, jerr)):
        for got, want in _pairs(tree, jtree):
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert got.numpy().tobytes() == want.tobytes()
            n += 1
    assert n == 10


@pytest.mark.parametrize("bad", ["nan", "inf", "both"])
def test_compress_grads_propagates_nan_and_inf_as_jax(bad):
    """A NaN or Inf in a gradient leaf makes that whole leaf's dequantized
    gradient and residual NaN, in both packages; the other leaves are
    untouched."""
    g, e = _grad_trees(4)
    if bad in ("nan", "both"):
        g["w"][3, 5] = np.nan
    if bad in ("inf", "both"):
        g["emb"][7, 1] = -np.inf
    for leaf in (g["w"], g["emb"]):
        q, s = C._quantize_leaf(torch.from_numpy(leaf))
        jq, js = JC._quantize_leaf(jnp.asarray(leaf))
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        np.testing.assert_array_equal(s.numpy().ravel(),
                                      np.asarray(js).ravel())
    deq, err = C.compress_grads(_to_torch(g), _to_torch(e))
    jdeq, jerr = JC.compress_grads(g, e)
    for tree, jtree in ((deq, jdeq), (err, jerr)):
        for got, want in _pairs(tree, jtree):
            np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN
        for k in ("w", "emb"):
            poisoned = not np.isfinite(g[k]).all()
            assert bool(tree[k].isnan().all()) == poisoned, k
        assert all(bool(torch.isfinite(t).all())
                   for t in (tree["b"], *tree["blocks"]))


def test_compress_grads_takes_bf16_grads():
    g, e = _grad_trees(3)
    tg = {k: (v.bfloat16() if isinstance(v, torch.Tensor) else v)
          for k, v in _to_torch(g).items()}
    jg = {k: (jnp.asarray(v).astype(jnp.bfloat16) if not isinstance(v, list)
              else v) for k, v in g.items()}
    deq, err = C.compress_grads(tg, _to_torch(e))
    jdeq, jerr = JC.compress_grads(jg, e)
    for tree, jtree in ((deq, jdeq), (err, jerr)):
        for got, want in _pairs(tree, jtree):
            assert got.numpy().tobytes() == want.tobytes()


SPLITS = [  # (whole shape, blocks: (dim, count) a split, major first)
    ((8, 16, 12), [(0, 4)]),                 # ep: experts over model
    ((8, 16, 12), [(0, 2), (2, 2)]),         # ep_resident: and F over data
    ((8, 12, 16), [(0, 2), (1, 3)]),
]


def _blocks(x, splits):
    """Every block of ``x`` under ``splits``, in index order."""
    out = [x]
    for dim, n in splits:
        out = [part for t in out for part in t.chunk(n, dim=dim)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,splits", SPLITS)
def test_given_absmax_gives_each_block_the_whole_leafs_codes(shape, splits,
                                                             dtype):
    """K3's plain version given the whole leaf's absmax: each block's codes
    are the whole leaf's codes of that block, byte for byte, and the
    whole leaf's are JAX's ``compression._quantize_leaf``'s."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2.0
                         ).to(dtype)
    q, s = ops.quantize(x.reshape(1, -1))
    jq, _ = JC._quantize_leaf(jnp.asarray(x.float().numpy()))
    assert q.numpy().tobytes() == np.asarray(jq).reshape(1, -1).tobytes()
    absmax = x.float().abs().amax().reshape(1)
    qw = q.reshape(shape)
    # the block holding the leaf's absmax would find it by itself; the
    # others' own absmax is smaller, so their codes differ without it
    differs = 0
    for blk, want in zip(_blocks(x, splits), _blocks(qw, splits)):
        got, gs = ops.quantize(blk.reshape(1, -1), absmax)
        assert got.numpy().tobytes() == want.reshape(1, -1).numpy().tobytes()
        assert gs.numpy().tobytes() == s.numpy().tobytes()
        own, _ = ops.quantize(blk.reshape(1, -1))
        differs += int(not torch.equal(own, got))
    assert differs >= len(_blocks(x, splits)) - 1 > 0


def test_a_given_absmax_must_be_one_fp32_value_a_row():
    x = torch.randn(3, 8)
    with pytest.raises(ValueError, match="absmax"):
        ops.quantize(x, torch.ones(2))
    with pytest.raises(ValueError, match="absmax"):
        ops.quantize(x, torch.ones(3, dtype=torch.float64))
    q, s = ops.quantize(x, x.abs().amax(dim=-1))
    wq, ws = ops.quantize(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)


def test_wire_transform_is_compress_grads_with_zero_error():
    """The train step's stateless transform, in place on a list of leaves,
    against ``compress_grads`` with a zero error tree and against JAX's,
    byte for byte."""
    import jax
    g, _ = _grad_trees(5)
    tg = _to_torch(g)
    want, _ = C.compress_grads(tg, C.init_error_state(tg))
    jwant, _ = JC.compress_grads(g, jax.tree.map(np.zeros_like, g))
    leaves = T.tree_leaves(tg)
    C.wire_transform(leaves)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jwant)]
    assert len(leaves) == len(jleaves) == 5
    for got, w, jw in zip(leaves, T.tree_leaves(want), jleaves):
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == w.numpy().tobytes() == jw.tobytes()


def test_init_error_state_is_fp32_zeros():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    err = C.init_error_state(params)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 4)
    assert not err["a"].any() and not err["b"][0].any()


def test_error_feedback_unbiased_over_time():
    """tests/test_compression.py::test_error_feedback_unbiased_over_time,
    mirrored, with the same numpy gradient in both packages, which must
    give the same bytes at every step."""
    g_true = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    g = torch.from_numpy(g_true)
    err, jerr = torch.zeros(256), jnp.zeros((256,))
    acc = torch.zeros(256)
    for _ in range(50):
        deq, err = C.compress_grads(g, err)
        jdeq, jerr = JC.compress_grads(jnp.asarray(g_true), jerr)
        assert deq.numpy().tobytes() == np.asarray(jdeq).tobytes()
        assert err.numpy().tobytes() == np.asarray(jerr).tobytes()
        acc = acc + deq
    rel = ((acc - 50 * g).norm() / (50 * g).norm()).item()
    assert rel < 0.01, rel


def test_wire_bytes_equal_jax():
    g, _ = _grad_trees(0)
    assert C.wire_bytes(_to_torch(g)) == JC.wire_bytes(g)
    assert C.wire_bytes(_to_torch(g), 2) == JC.wire_bytes(g, 2)
    params = {"a": torch.zeros(128, 128), "b": torch.zeros(64)}
    full, comp = C.wire_bytes(params)
    assert full / comp > 3.5


def test_kernels_refuse_cpu_tensors_and_bad_arguments():
    x = torch.randn(4, 8)
    q = torch.zeros(4, 8, dtype=torch.int8)
    s = torch.ones(4, 1)
    before = (quantize_int8.launches, dequantize_int8.launches)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        quantize_int8(x)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        dequantize_int8(q, s)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        quantize_int8(x[0])
    with pytest.raises(ValueError, match="empty row"):
        quantize_int8(x[:, :0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quantize_int8(x.double())
    with pytest.raises(TypeError, match="int8 codes"):
        dequantize_int8(q.int(), s)
    with pytest.raises(ValueError, match="scales"):
        dequantize_int8(q, s[:3])
    assert (quantize_int8.launches, dequantize_int8.launches) == before
