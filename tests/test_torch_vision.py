"""The port's vision models against the JAX package's, on the CPU.

Parameters are drawn once, by the port's initialiser from a seeded
``torch.Generator`` (the JAX initialisers draw eagerly and take about a
minute on a CPU), and handed to both packages with the same numpy image, on
the plain path and on the DSA (kernel) path; the JAX kernel path runs
Pallas in interpret mode.  ResNet-50 has no batch norm, so
activations grow through the residual stack: outputs are compared by
relative Frobenius error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import vision as jvision
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, vision

MODELS = {
    "resnet50": ("resnet50", {"width": 0.125}),
    "effnet": ("effnet", {"width": 0.25}),
    "fcn": ("fcn", {"width": 0.125}),
    "yolov3": ("yolov3", {"width": 0.125}),
    "vit": ("vit", {}),
}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want)
                 / np.linalg.norm(want))


def _image(size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (1, size, size, 3)).astype(np.float32)


def _jax_tree(tree):
    """The port's parameters as the JAX package's tree (ints stay ints)."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t,
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
def test_vision_model_matches_jax(model, use_kernel):
    """Weights from the port's initialiser (a seeded torch.Generator), fed
    to both packages; the JAX initialisers' own trees are covered by
    test_params_from_jax_keeps_the_tree and tests/test_torch_executor.py."""
    name, kw = MODELS[model]
    tparams = getattr(vision, f"{name}_init")(torch.Generator().manual_seed(0),
                                              device="cpu", **kw)
    x = _image(32)
    want = getattr(jvision, f"{name}_apply")(_jax_tree(tparams),
                                             jnp.asarray(x),
                                             use_kernel=use_kernel)
    got = getattr(vision, f"{name}_apply")(tparams, torch.from_numpy(x),
                                           use_kernel=use_kernel)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("size,k,stride", [
    (7, 3, 2), (8, 3, 2), (9, 7, 2), (8, 1, 2), (6, 3, 1), (5, 1, 1)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_conv2d_same_padding_matches_jax(size, k, stride, use_kernel):
    """XLA's SAME padding puts the odd pixel last for stride 2."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 5), dtype=np.float32)
    w = rng.standard_normal((k, k, 5, 6), dtype=np.float32)
    want = jvision.conv2d(jnp.asarray(x), jnp.asarray(w), stride, use_kernel)
    got = vision.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride,
                        use_kernel)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("size", [7, 8, 112])
def test_max_pool_same_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 4), dtype=np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = vision._max_pool_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rms_norm_and_gelu_match_jax():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    s = rng.standard_normal((16,), dtype=np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    for name in ("silu", "gelu"):
        np.testing.assert_allclose(
            layers.act_fn(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jlayers.act_fn(name)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)


def test_params_from_jax_keeps_the_tree():
    """A JAX tree after ``tree_map(np.asarray, ...)``: strides and ViT's
    meta became 0-d integer arrays, YOLO's residual pairs are tuples."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 4, 8), dtype=np.float32)
    jtree = {"stem": jnp.asarray(w), "blocks": [{"c1": jnp.zeros((1, 1, 8, 8)),
                                                 "stride": 2}],
             "trunk": [{"res": [(jnp.ones((1, 1, 8, 4)),
                                 jnp.ones((3, 3, 4, 8)))]}],
             "meta": {"heads": 4, "patch": 16}}
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                           device="cpu")
    np.testing.assert_array_equal(tree["stem"].numpy(), w)
    assert tree["stem"].dtype == torch.float32
    assert type(tree["blocks"][0]["stride"]) is int
    assert tree["blocks"][0]["stride"] == 2
    assert isinstance(tree["trunk"][0]["res"][0], tuple)
    assert tree["meta"] == {"heads": 4, "patch": 16}


@pytest.mark.parametrize("model", list(MODELS))
def test_port_initialisers_match_jax_shapes(model):
    """The port draws its own weights from a torch.Generator; the trees have
    the JAX package's structure and shapes (traced, not drawn, on the JAX
    side)."""
    name, kw = MODELS[model]
    jparams = jax.eval_shape(
        lambda key: getattr(jvision, f"{name}_init")(key, **kw),
        jax.random.PRNGKey(0))
    tparams = getattr(vision, f"{name}_init")(torch.Generator().manual_seed(0),
                                              device="cpu", **kw)
    jleaves, jdef = jax.tree_util.tree_flatten(jparams)
    tleaves, tdef = jax.tree_util.tree_flatten(
        tparams, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert jdef == tdef
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(getattr(b, "shape", ()))


def test_conv2d_hands_k1_its_weight_layout(monkeypatch):
    """A 3x3 or 7x7 weight reaches K1 K-major (the copy its reshape makes
    either way), a 1x1 weight as a row-major view of itself, and the result
    is the same convolution."""
    seen = []
    real = vision.ops.matmul_padded

    def record(x, w, *a, **kw):
        seen.append((w.is_contiguous(), w.t().is_contiguous()))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(vision.ops, "matmul_padded", record)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 9, 9, 4, generator=gen)
    for k, stride in ((1, 1), (3, 2), (7, 2)):
        w = torch.randn(k, k, 4, 5, generator=gen)
        torch.testing.assert_close(
            vision.conv2d(x, w, stride, use_kernel=True),
            vision.conv2d(x, w, stride, use_kernel=False),
            rtol=1e-5, atol=1e-5)
    assert seen == [(True, False), (False, True), (False, True)]
