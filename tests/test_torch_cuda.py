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
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.systolic_matmul import (_ACTS, systolic_matmul,
                                                 systolic_matmul_plain)
from repro_torch.kernels.vector_engine import (fused_affine_act,
                                               fused_affine_act_plain)

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
