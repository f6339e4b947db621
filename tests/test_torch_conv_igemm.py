"""The implicit-GEMM conv3d kernel's arithmetic and index map, on the CPU.

The card's kernel (``src/repro_torch/csrc/conv3d.cu``) cannot run here, so
these pin down, before the card, what it computes:

- its fp32 arithmetic, 3xTF32 (``ref.conv3d_3xtf32``: x and w split into a
  TF32 part rounded to nearest and a TF32 remainder, three products
  summed in fp32), held against the JAX package's fp32 conv
  (``repro.kernels.conv3d.ref.conv3d_valid``) with the tolerances
  ``chip_smoke.py::phase_kernels`` holds the kernel to: 2e-5 * (1 + max)
  on the shape grid of ``tests/test_kernels.py``, 1e-6 * sqrt(k^3 Cin) of
  the output scale at every cosmoflow-128 layer (He-scaled weights);
- its index map (``ref.im2col``): the GEMM's A matrix, gathered tile by
  tile in the kernel's K order (kd, kh, kw, ci), times the weight viewed
  as (k^3 Cin, Cout), is the conv, with zeros past the last voxel and
  past K;
- its launch plan (``ops.plan``): which kernel, N tile, K split and
  gather width each shape gets.

Inputs come from numpy with a seed and go to both frameworks.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv3d import ref as jconv_ref
from repro_torch.configs import get_config
from repro_torch.kernels.conv3d import ops, ref
from repro_torch.models import cosmoflow

CONV_GRID = [
    ((2, 10, 10, 10, 3), 3, 8, 1),
    ((1, 9, 9, 9, 4), 3, 16, 2),
    ((2, 12, 8, 8, 8), 5, 4, 1),
    ((1, 6, 6, 6, 2), 1, 8, 1),
    ((1, 7, 7, 7, 16), 3, 32, 1),
]
SMS = 132  # the H100's SMs


def _jax_conv(x, w, stride, pads):
    xp = np.pad(x, ((0, 0),) + tuple(pads) + ((0, 0),))
    return np.asarray(jconv_ref.conv3d_valid(jnp.asarray(xp), jnp.asarray(w),
                                             stride))


def _layers_small():
    """Every cosmoflow-128 conv's (Cin, Cout, k, stride, pads) on a 6^3
    input (8^3 for the stride-2 layer)."""
    out = []
    for xs, ws, s, pads in cosmoflow.conv_shapes(get_config("cosmoflow-128"),
                                                 4):
        side = 8 if s == 2 else 6
        out.append(((1, side, side, side, ws[3]), ws, s, pads))
    return out


# ------------------------------------------------------- 3xTF32 split ----
def test_split_tf32_rounds_hi_to_nearest_and_truncates_lo():
    a = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32) * 37)
    hi, lo = ref.split_tf32(a)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi is the nearest TF32 value: |a - hi| at most half a TF32 ulp
    assert bool(((a - hi).abs() <= a.abs() * 2.0 ** -11).all())
    # what hi + lo drops is below 2^-21 of |a|
    rest = (a.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= a.abs().double() * 2.0 ** -21).all())
    # ties go away from zero, as cvt.rna.tf32.f32 rounds
    t = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert ref.split_tf32(t)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                             1 + 2 ** -9]


@pytest.mark.parametrize("shape,k,cout,stride", CONV_GRID)
def test_3xtf32_matches_the_reference_on_the_grid(shape, k, cout, stride):
    r = np.random.RandomState(0)
    x = r.randn(*shape).astype(np.float32)
    w = (r.randn(k, k, k, shape[-1], cout) * 0.1).astype(np.float32)
    pads = ((1, 1),) * 3
    got = ref.conv3d_3xtf32(torch.from_numpy(x), torch.from_numpy(w), stride,
                            pads).numpy()
    want = _jax_conv(x, w, stride, pads)
    assert got.shape == want.shape
    tol = 2e-5 * (1 + np.abs(want).max())
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("x_shape,w_shape,stride,pads", _layers_small(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_3xtf32_matches_the_reference_at_every_cosmoflow_layer(
        x_shape, w_shape, stride, pads):
    r = np.random.RandomState(1)
    kc = math.prod(w_shape[:4])
    x = r.randn(*x_shape).astype(np.float32)
    w = (r.randn(*w_shape) * math.sqrt(2.0 / kc)).astype(np.float32)
    got = ref.conv3d_3xtf32(torch.from_numpy(x), torch.from_numpy(w), stride,
                            pads).numpy()
    want = _jax_conv(x, w, stride, pads)
    tol = 1e-6 * math.sqrt(kc) * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol


def test_one_tf32_product_would_miss_the_fp32_tolerance():
    """Why the kernel takes three products: hi * w_hi alone (1xTF32) is
    off by ~1e-3 of the scale at a cosmoflow-128 layer, far outside
    1e-6 * sqrt(k^3 Cin)."""
    x_shape, w_shape, stride, pads = _layers_small()[2]
    r = np.random.RandomState(2)
    kc = math.prod(w_shape[:4])
    x = torch.from_numpy(r.randn(*x_shape).astype(np.float32))
    w = torch.from_numpy((r.randn(*w_shape) * math.sqrt(2.0 / kc)).astype(
        np.float32))
    want = _jax_conv(x.numpy(), w.numpy(), stride, pads)
    one = ref.conv3d_valid(ref.split_tf32(x)[0], ref.split_tf32(w)[0],
                           stride, pads).numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(one - want).max() > 10 * 1e-6 * math.sqrt(kc) * scale


# ----------------------------------------------------------- im2col ----
@pytest.mark.parametrize("x_shape,k,stride,pads,cout", [
    ((2, 5, 6, 7, 3), 3, 1, ((1, 1),) * 3, 5),           # SAME, Cin 3
    ((1, 9, 9, 9, 4), 3, 2, ((0, 1),) * 3, 8),           # stride 2, Cin 4
    ((2, 4, 3, 5, 2), 3, 1, ((2, 0), (0, 1), (1, 1)), 4),  # asymmetric
    ((1, 7, 7, 7, 4), 3, 1, ((1, 1),) * 3, 16),          # 343 rows: ragged
    ((1, 6, 6, 6, 2), 1, 1, ((1, 1),) * 3, 8),           # k = 1
    ((2, 3, 8, 8, 16), 3, 1, ((0, 0), (1, 1), (1, 1)), 32),  # thin piece
], ids=lambda v: str(v).replace(" ", ""))
def test_im2col_tiles_times_the_weight_are_the_conv(x_shape, k, stride, pads,
                                                     cout):
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(*x_shape))
    w = torch.from_numpy(r.randn(k, k, k, x_shape[-1], cout))
    out = ref.output_shape(x_shape, w.shape, stride, pads)
    m, kk = math.prod(out[:4]), k ** 3 * x_shape[-1]
    bk = ops.ROW_BYTES // 4  # one fp32 stage of K
    k_pad = -(-kk // bk) * bk
    tiles = [[ref.im2col(x, k, stride, pads, (m0, m0 + ops.BM), (k0, k0 + bk))
              for k0 in range(0, k_pad, bk)]
             for m0 in range(0, m, ops.BM)]
    a = torch.cat([torch.cat(row, 1) for row in tiles], 0)
    assert a.shape == (-(-m // ops.BM) * ops.BM, k_pad)
    assert not a[m:].any() and not a[:, kk:].any()
    got = (a[:m, :kk] @ w.reshape(kk, cout)).reshape(out)
    # the plain conv sums in fp32: a wrong index would be off by O(1)
    want = ref.conv3d_valid(x, w, stride, pads)
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())


# ------------------------------------------------------------- plan ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,batch", [("cosmoflow-128", 4),
                                        ("cosmoflow-512", 1)])
def test_plan_of_every_cosmoflow_layer(name, batch, dtype):
    size = 4 if dtype == torch.float32 else 2
    for i, (xs, ws, s, pads) in enumerate(
            cosmoflow.conv_shapes(get_config(name), batch)):
        out = ref.output_shape(xs, ws, s, pads)
        p = ops.plan(xs, ws, out, dtype, SMS, 0, s)
        assert p.bn == min(ws[4], 128)
        assert p.vec == (8 if ws[3] * size == 8 else 16)
        # every split is non-empty and together they cover K
        assert (p.splits - 1) * p.tiles_per_split < p.k_tiles
        assert p.splits * p.tiles_per_split >= p.k_tiles
        patch = i <= 2 and not (i == 0 and dtype == torch.bfloat16)
        assert (p.stages > 0) == patch, (i, p)
        if patch:
            assert p.splits == 1
            assert ops.patch_smem(ws[0], ws[3], p.bn, size,
                                  p.stages) <= ops.SMEM_BLOCK
        # the deep layers leave SMs idle unsplit: split-K at 128^3 from
        # layer 3, at 512^3 from layer 4 (layer 3 has 256 tiles)
        first_split = 3 if name == "cosmoflow-128" else 4
        assert (p.splits > 1) == (i >= first_split), (i, p)


@pytest.mark.parametrize("cin,dtype,ptr,vec", [
    (3, torch.bfloat16, 0, 2), (2, torch.bfloat16, 0, 4),
    (4, torch.bfloat16, 0, 8), (3, torch.float32, 0, 4),
    (2, torch.float32, 0, 8), (4, torch.float32, 0, 16),
    (16, torch.float32, 4, 4), (16, torch.bfloat16, 2, 2)])
def test_plan_gathers_the_widest_piece_inside_one_tap(cin, dtype, ptr, vec):
    xs, ws = (1, 32, 32, 32, cin), (3, 3, 3, cin, 16)
    p = ops.plan(xs, ws, (1, 32, 32, 32, 16), dtype, SMS, ptr, 1)
    assert p.vec == vec
    assert p.stages == 0 or vec == 16  # the patch kernel copies 16 bytes


def test_plan_takes_the_gather_kernel_where_the_patch_kernel_cannot():
    xs, ws = (4, 64, 64, 64, 16), (3, 3, 3, 16, 32)
    out = ref.output_shape(xs, ws, 1, ((1, 1),) * 3)
    assert ops.plan(xs, ws, out, torch.float32, SMS, 0, 1).stages > 0
    # stride 2; a 16-bit Cin not a multiple of 16; too few boxes for the card
    out2 = ref.output_shape(xs, ws, 2, ((0, 1),) * 3)
    assert ops.plan(xs, ws, out2, torch.float32, SMS, 0, 2).stages == 0
    ws8 = (3, 3, 3, 8, 32)
    xs8 = xs[:4] + (8,)
    assert ops.plan(xs8, ws8, out, torch.bfloat16, SMS, 0, 1).stages == 0
    assert ops.plan(xs8, ws8, out, torch.float32, SMS, 0, 1).stages > 0
    small = (1, 8, 8, 8, 16)
    out3 = ref.output_shape(small, ws, 1, ((1, 1),) * 3)
    assert ops.plan(small, ws, out3, torch.float32, SMS, 0, 1).stages == 0
