"""The port's kernels against the reference's.

On the CPU a wrapper runs its plain version, so these hold the port's
plain conv3d and bn_act against ``repro.kernels.*.ref`` (the jnp/XLA
oracles) and against the Pallas kernels in interpret mode, on the
shape grid of ``tests/test_kernels.py`` with its tolerances: 2e-5 in
fp32, 2e-2 in bf16 (one or two bf16 ulps at these magnitudes). Inputs
come from numpy with a seed and go to both frameworks.

The CUDA kernels are held against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bn_act import ops as jbn_ops
from repro.kernels.bn_act import ref as jbn_ref
from repro.kernels.conv3d import ops as jconv_ops
from repro.kernels.conv3d import ref as jconv_ref
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops

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
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


# ------------------------------------------------------------- conv3d ----
@pytest.mark.parametrize("shape,k,cout,stride", CONV_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_plain_matches_reference(shape, k, cout, stride, dtype):
    x, w = _conv_inputs(shape, k, cout)
    got = conv_ops.conv3d_valid(torch.from_numpy(x).to(TORCH_DT[dtype]),
                                torch.from_numpy(w).to(TORCH_DT[dtype]),
                                stride=stride)
    want = jconv_ref.conv3d_valid(jnp.asarray(x, JAX_DT[dtype]),
                                  jnp.asarray(w, JAX_DT[dtype]), stride)
    assert got.dtype == TORCH_DT[dtype]
    assert tuple(got.shape) == want.shape
    _close(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("shape,k,cout,stride", CONV_GRID[:2])
def test_conv3d_plain_matches_pallas_kernel(shape, k, cout, stride):
    x, w = _conv_inputs(shape, k, cout, seed=1)
    got = conv_ops.conv3d_valid(torch.from_numpy(x), torch.from_numpy(w),
                                stride=stride)
    want = jconv_ops.conv3d_valid(jnp.asarray(x), jnp.asarray(w),
                                  stride=stride)  # Pallas, interpret mode
    _close(_np(got), want, TOL["float32"])


@pytest.mark.parametrize("stride,pads", [(1, ((1, 1),) * 3),
                                         (2, ((0, 1),) * 3),
                                         (1, ((2, 0), (0, 1), (1, 2)))])
def test_conv3d_pads_equal_zero_padded_input(stride, pads):
    """The padding the kernel applies as bounds checks is the reference's
    ``jnp.pad`` before a VALID conv (``spatial_conv.py:_conv_piece``)."""
    x, w = _conv_inputs((2, 8, 6, 7, 3), 3, 5, seed=2)
    got = conv_ops.conv3d_valid(torch.from_numpy(x), torch.from_numpy(w),
                                stride=stride, pads=pads)
    xp = jnp.pad(jnp.asarray(x), ((0, 0),) + pads + ((0, 0),))
    want = jconv_ref.conv3d_valid(xp, jnp.asarray(w), stride)
    assert tuple(got.shape) == want.shape
    _close(_np(got), want, TOL["float32"])


@pytest.mark.parametrize("bad,err", [
    (lambda x, w: (x, w.to(torch.bfloat16)), TypeError),
    (lambda x, w: (x.to(torch.int32), w.to(torch.int32)), TypeError),
    (lambda x, w: (x, w[:, :, :, :2]), ValueError),
    (lambda x, w: (x[:, :2], w), ValueError),
])
def test_conv3d_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x, w = _conv_inputs((1, 6, 6, 6, 3), 3, 4)
    before = conv_ops.conv3d_valid.launches
    with pytest.raises(err):
        conv_ops.conv3d_valid(*bad(torch.from_numpy(x), torch.from_numpy(w)))
    assert conv_ops.conv3d_valid.launches == before


def test_wrappers_take_only_cpu_or_cuda_tensors():
    """Other devices raise: the plain version is for CPU tensors only."""
    x = torch.empty(1, 6, 6, 6, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv_ops.conv3d_valid(x, torch.empty(3, 3, 3, 3, 4, device="meta"))
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bn_ops.bn_leaky_relu(x, v, v, v, v)


# ------------------------------------------------------------- bn_act ----
@pytest.mark.parametrize("shape", BN_GRID)
@pytest.mark.parametrize("slope", [0.01, 1.0])
@pytest.mark.parametrize("oracle", ["ref", "pallas"])
def test_bn_act_plain_matches_reference(shape, slope, oracle):
    arrs = _bn_inputs(shape)
    got = bn_ops.bn_leaky_relu(*(torch.from_numpy(a) for a in arrs),
                               negative_slope=slope)
    fn = jbn_ref.bn_leaky_relu if oracle == "ref" else jbn_ops.bn_leaky_relu
    want = fn(*(jnp.asarray(a) for a in arrs), negative_slope=slope)
    _close(_np(got), want, TOL["float32"])


def test_bn_act_bf16_computes_in_fp32_and_rounds_once():
    x, mean, var, scale, bias = _bn_inputs((4, 7, 3, 3, 32), seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    vecs = [torch.from_numpy(a) for a in (mean, var, scale, bias)]
    got = bn_ops.bn_leaky_relu(xb, *vecs)
    assert got.dtype == torch.bfloat16
    want = jbn_ref.bn_leaky_relu(jnp.asarray(xb.float().numpy()),
                                 *(jnp.asarray(a) for a in
                                   (mean, var, scale, bias)))
    # the fp32 result rounded once to bf16: within half a bf16 ulp
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2 ** -8,
                               atol=1e-6)


def test_bn_act_wrapper_rejects_mismatched_vectors():
    x, mean, var, scale, bias = _bn_inputs((2, 4, 8))
    with pytest.raises(ValueError, match="mean"):
        bn_ops.bn_leaky_relu(torch.from_numpy(x), torch.from_numpy(mean[:4]),
                             *(torch.from_numpy(a) for a in
                               (var, scale, bias)))
