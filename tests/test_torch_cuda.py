"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes and tolerances are those of ``tests/test_kernels.py`` (2e-5 in
fp32, 2e-2 in bf16); the inputs come from numpy with a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref

CONV_GRID = [
    ((2, 10, 10, 10, 3), 3, 8, 1),
    ((1, 9, 9, 9, 4), 3, 16, 2),
    ((2, 12, 8, 8, 8), 5, 4, 1),
    ((1, 6, 6, 6, 2), 1, 8, 1),
    ((1, 7, 7, 7, 16), 3, 32, 1),
]
BN_GRID = [(2, 5, 5, 5, 16), (4, 7, 3, 3, 32), (1, 128, 8)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(shape, k, cout, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    w = (r.randn(k, k, k, shape[-1], cout) * 0.1).astype(np.float32)
    return x, w


def _bn_inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    c = shape[-1]
    x = r.randn(*shape).astype(np.float32)
    mean, scale, bias = (r.randn(c).astype(np.float32) for _ in range(3))
    var = np.log1p(np.exp(r.randn(c))).astype(np.float32)  # softplus > 0
    return x, mean, var, scale, bias


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,cout,stride", CONV_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_kernel_matches_plain_on_card(cuda, shape, k, cout, stride,
                                             dtype):
    x, w = _conv_inputs(shape, k, cout)
    xt = torch.from_numpy(x).to(cuda, TORCH_DT[dtype])
    wt = torch.from_numpy(w).to(cuda, TORCH_DT[dtype])
    before = conv_ops.conv3d_valid.launches
    got = conv_ops.conv3d_valid(xt, wt, stride=stride, pads=((1, 1),) * 3)
    assert conv_ops.conv3d_valid.launches == before + 1
    want = conv_ref.conv3d_valid(xt, wt, stride, ((1, 1),) * 3)
    torch.cuda.synchronize()
    _close(got, want, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_GRID)
@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_bn_act_kernel_matches_plain_on_card(cuda, shape, slope):
    arrs = [torch.from_numpy(a).to(cuda) for a in _bn_inputs(shape)]
    before = bn_ops.bn_leaky_relu.launches
    got = bn_ops.bn_leaky_relu(*arrs, negative_slope=slope)
    assert bn_ops.bn_leaky_relu.launches == before + 1
    want = bn_ref.bn_leaky_relu(*arrs, negative_slope=slope)
    torch.cuda.synchronize()
    _close(got, want, TOL["float32"])


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_non_contiguous_input(cuda):
    x = torch.randn(1, 6, 6, 6, 8, device=cuda)
    w = torch.randn(3, 3, 3, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv3d_valid(x[..., ::2], w)
    v = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bn_ops.bn_leaky_relu(x[..., ::2], v, v, v, v)
