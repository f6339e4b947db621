"""The SSD scan kernel's tensor-core arithmetic and its in-place reads, on
the CPU.

The card's kernel (``src/repro_torch/csrc/ssd_scan.cu``) cannot run here,
so these pin down, before the card, what it computes:

- its arithmetic (``ref.ssd_scan_tc``: the kernel's chunked products with
  each operand rounded as its tensor cores take it, 3xTF32 for fp32, the
  computed operands split into three bf16 parts for bf16), held against the
  JAX package's sequential oracle (``repro.kernels.ssd_scan.ref``) and its
  Pallas kernel (``repro.kernels.ssd_scan.ops``, interpret mode on the
  CPU) on the shapes of ``tests/test_torch_ssd.py`` and one layer-like
  shape at reduced length (P = 64, N = 128, chunk 256, two chunks). fp32:
  3e-4 rtol/atol, the reference's kernel contract; bf16-valued inputs: y
  within 2e-2 of its scale (the reference's bf16 sweep tolerance), the
  fp32 state at 3e-4;
- the layouts the kernel reads in place (``ops.kernel_strides``): x, B
  and C as views of one (B, L, H*P + 2N) buffer, as the Mamba2 block
  splits its conv output, and the layouts it refuses;
- that ``ops.ssd_scan`` on such views of CPU tensors gives what it gives
  on contiguous copies and matches the reference, and that the Mamba2
  block hands the scan those views, not copies.

Inputs come from numpy with a seed and go to both frameworks.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import mamba2, ssm_lm

# (L, H, P, N, chunk): tests/test_torch_ssd.py's five, then a layer-like
# shape (mamba2-370m's P, N and chunk) at L = 512
SHAPES = [(32, 2, 8, 16, 8), (64, 3, 8, 16, 16), (64, 1, 16, 8, 64),
          (48, 2, 4, 4, 12), (40, 2, 8, 16, 16), (512, 2, 64, 128, 256)]
TOL = 3e-4
BF16_TOL = 2e-2


def _inputs(L, H, P, N, B=2, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(B, L, H))).astype(np.float32)  # softplus
    A = (-np.exp(r.randn(H) * 0.5)).astype(np.float32)
    Bm = r.randn(B, L, N).astype(np.float32)
    Cm = r.randn(B, L, N).astype(np.float32)
    return x, dt, A, Bm, Cm


def _bf16_valued(arrs):
    """x, dt, B, C rounded to bf16 (A stays fp32, as the kernel takes it)."""
    return [a if i == 2 else
            torch.from_numpy(a).bfloat16().float().numpy()
            for i, a in enumerate(arrs)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_arithmetic_matches_the_reference(shape):
    L, H, P, N, chunk = shape
    B = 1 if L > 64 else 2
    arrs = _inputs(L, H, P, N, B=B)
    q = ops.chunk_len(L, chunk)
    y, s = ref.ssd_scan_tc(*(torch.from_numpy(a) for a in arrs), chunk=q)
    js = [jnp.asarray(a) for a in arrs]
    want_y, want_s = jref.ssd_scan(*js)
    _close(y, want_y, TOL)
    _close(s, want_s, TOL)
    ky, ks = jops.ssd_scan(*js, chunk=chunk)
    _close(y, ky, TOL)
    _close(s, ks, TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_arithmetic_matches_the_reference(shape):
    L, H, P, N, chunk = shape
    B = 1 if L > 64 else 2
    arrs = _bf16_valued(_inputs(L, H, P, N, B=B, seed=1))
    ts = [torch.from_numpy(a) for a in arrs]
    ts = [t if i == 2 else t.bfloat16() for i, t in enumerate(ts)]
    y, s = ref.ssd_scan_tc(*ts, chunk=ops.chunk_len(L, chunk))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y, want_s = jref.ssd_scan(*(jnp.asarray(a) for a in arrs))
    want_y = np.asarray(want_y)
    scale = max(1.0, float(np.abs(want_y).max()))
    assert float(np.abs(y.float().numpy() - want_y).max()) <= BF16_TOL * scale
    _close(s, want_s, TOL)


def test_bf16_split_keeps_what_one_rounding_loses():
    a = torch.from_numpy(np.random.RandomState(2).randn(4096).astype(
        np.float32) * 37)
    once = (a - a.bfloat16().float()).abs()
    assert torch.equal(ref.split_bf16(a, parts=1), a.bfloat16().float())
    two = (a - ref.split_bf16(a, parts=2)).abs()
    assert bool((two <= a.abs() * 2.0 ** -16).all())
    assert float(two.max()) < float(once.max()) / 100
    # three parts keep all of an fp32 value's 24 bits
    assert torch.equal(ref.split_bf16(a), a)


def _xbc_views(L, H, P, N, B=2, seed=3):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(L, H, P, N, B=B, seed=seed))
    xbc = torch.cat([x.reshape(B, L, H * P), Bm, Cm], dim=-1)
    xv, bv, cv = torch.split(xbc, [H * P, N, N], dim=-1)
    return xv.reshape(B, L, H, P), dt, A, bv, cv


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4]],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_wrapper_takes_views_of_one_buffer(shape):
    L, H, P, N, chunk = shape
    x, dt, A, Bm, Cm = _xbc_views(L, H, P, N)
    width = H * P + 2 * N
    assert ops.kernel_strides(x, Bm, Cm) == (L * width, width,
                                             L * width, width)
    before = ops.ssd_scan.launches
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.ssd_scan.launches == before  # CPU: the plain version
    yc, sc = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                          Cm.contiguous(), chunk=chunk)
    assert torch.equal(y, yc) and torch.equal(s, sc)
    js = [jnp.asarray(t.contiguous().numpy()) for t in (x, dt, A, Bm, Cm)]
    want_y, want_s = jref.ssd_scan(*js)
    _close(y, want_y, TOL)
    _close(s, want_s, TOL)
    ty, ts = ref.ssd_scan_tc(x, dt, A, Bm, Cm, chunk=ops.chunk_len(L, chunk))
    _close(ty, want_y, TOL)
    _close(ts, want_s, TOL)


def test_kernel_strides_refuse_other_layouts():
    x, dt, A, Bm, Cm = _xbc_views(32, 2, 8, 16)
    xc, bc = x.contiguous(), Bm.contiguous()
    assert ops.kernel_strides(xc, bc, Cm.contiguous()) == (32 * 16, 16,
                                                           32 * 16, 16)
    xt = xc.transpose(2, 3).contiguous().transpose(2, 3)  # p not innermost
    with pytest.raises(ValueError, match="contiguous x"):
        ops.kernel_strides(xt, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous Cm"):
        ops.kernel_strides(xc, bc, torch.cat([Cm, Cm], -1)[..., ::2])
    with pytest.raises(ValueError, match="contiguous Cm"):  # B and C apart
        ops.kernel_strides(xc, bc, Cm)
    # a size-1 batch or length takes any stride there
    assert ops.kernel_strides(x[:1], Bm[:1], Cm[:1])[2:] == (
        32 * Bm.stride(1), Bm.stride(1))


def test_the_mamba2_block_passes_views_of_its_conv_output():
    cfg = get_smoke_config("mamba2-370m")
    params = ssm_lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)))
    seen = []
    real = ops.ssd_scan

    def spy(x, dt, A, Bm, Cm, *, chunk):
        seen.append((x.is_contiguous(), Bm.is_contiguous(),
                     Cm.is_contiguous(), dt.is_contiguous(),
                     ops.kernel_strides(x, Bm, Cm),
                     x.untyped_storage().data_ptr()
                     == Bm.untyped_storage().data_ptr()
                     == Cm.untyped_storage().data_ptr()))
        return real(x, dt, A, Bm, Cm, chunk=chunk)

    want = ssm_lm.forward(params, toks, cfg)
    with mock.patch.object(ops, "ssd_scan", spy):
        got = ssm_lm.forward(params, toks, cfg)
    assert torch.equal(got, want)
    assert len(seen) == cfg.num_layers
    width = cfg.d_inner + 2 * cfg.ssm_state
    for xc, bc, cc, dc, strides, shared in seen:
        assert not (xc or bc or cc) and dc and shared
        assert strides == (16 * width, width, 16 * width, width)
