"""The port's SSD scan against the reference's, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
sequential oracle (``repro.kernels.ssd_scan.ref``) and its Pallas kernel
(``repro.kernels.ssd_scan.ops``, interpret mode on the CPU), and through
the port's plain version (``ref.ssd_scan``) and wrapper (``ops.ssd_scan``,
which takes the plain version for CPU tensors). Shapes: the four of
``tests/test_kernels.py`` and one whose L is not a multiple of the chunk
(the chunk is lowered to a divisor, 10). Tolerance 3e-4 (rtol and atol),
the reference's own kernel contract: fp32 sums in another order.

``ssd_chunked`` (the plain chunked scan the kernel path is held against
on the card) matches the reference's on y, the final state and the
cumulative decays, with and without an initial state, at 1e-5: the same
fp32 arithmetic in the same chunk structure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro.models import mamba2 as jmamba2
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import mamba2

# (L, H, P, N, chunk): tests/test_kernels.py's four, then L = 40 with
# chunk 16, lowered to 10
SHAPES = [(32, 2, 8, 16, 8), (64, 3, 8, 16, 16), (64, 1, 16, 8, 64),
          (48, 2, 4, 4, 12), (40, 2, 8, 16, 16)]
TOL = 3e-4
_jit_ssd_chunked = jax.jit(jmamba2.ssd_chunked, static_argnames=("chunk",))


def _inputs(L, H, P, N, B=2, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(B, L, H))).astype(np.float32)  # softplus
    A = (-np.exp(r.randn(H) * 0.5)).astype(np.float32)
    Bm = r.randn(B, L, N).astype(np.float32)
    Cm = r.randn(B, L, N).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("port", ["ref", "ops"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_matches_the_reference(shape, port):
    """Port ``ref`` against the reference's oracle, port ``ops`` (CPU
    tensors) against the reference's Pallas kernel in interpret mode."""
    L, H, P, N, chunk = shape
    arrs = _inputs(L, H, P, N)
    ts = [torch.from_numpy(a) for a in arrs]
    js = [jnp.asarray(a) for a in arrs]
    if port == "ref":
        got = ref.ssd_scan(*ts)
        want = jref.ssd_scan(*js)
    else:
        before = ops.ssd_scan.launches
        got = ops.ssd_scan(*ts, chunk=chunk)
        assert ops.ssd_scan.launches == before  # CPU: the plain version
        want = jops.ssd_scan(*js, chunk=chunk)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    assert tuple(got[0].shape) == (2, L, H, P)
    assert tuple(got[1].shape) == (2, H, P, N)
    _close(got[0], want[0], TOL)
    _close(got[1], want[1], TOL)


@pytest.mark.parametrize("L,chunk,q", [(32, 8, 8), (48, 12, 12),
                                       (40, 16, 10), (37, 16, 1),
                                       (7, 64, 7)])
def test_chunk_len_lowers_as_the_pallas_wrapper_does(L, chunk, q):
    """min(chunk, L), lowered until it divides L (``kernel.py:70-73``)."""
    assert ops.chunk_len(L, chunk) == q


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("shape", [(32, 2, 8, 16, 8), (48, 3, 4, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_chunked_matches_the_reference(shape, with_init):
    L, H, P, N, chunk = shape
    arrs = _inputs(L, H, P, N, seed=1)
    init = (np.random.RandomState(2).randn(2, H, P, N).astype(np.float32)
            if with_init else None)
    y, ex = mamba2.ssd_chunked(
        *(torch.from_numpy(a) for a in arrs), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    jy, jex = _jit_ssd_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    _close(y, jy, 1e-5)
    _close(ex.final_state, jex.final_state, 1e-5)
    _close(ex.cumdecay, jex.cumdecay, 1e-5)
    assert ex.final_state.dtype == torch.float32


def test_ssd_chunked_keeps_x_dtype_and_rejects_a_ragged_chunk():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(32, 2, 8, 16))
    y, ex = mamba2.ssd_chunked(x.bfloat16(), dt.bfloat16(), A, Bm.bfloat16(),
                               Cm.bfloat16(), chunk=8)
    assert y.dtype == torch.bfloat16 and ex.final_state.dtype == torch.float32
    with pytest.raises(ValueError, match="divide"):
        mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=12)


def _bad_calls():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(16, 2, 4, 8))
    meta = torch.empty(x.shape, device="meta")
    return {
        "x not 4-D": ((x[0], dt, A, Bm, Cm), ValueError, r"\(B, L, H, P\)"),
        "dt shape": ((x, dt[:, :8], A, Bm, Cm), ValueError, "dt must be"),
        "A shape": ((x, dt, A[:1], Bm, Cm), ValueError, "A must be"),
        "Cm shape": ((x, dt, A, Bm, Cm[..., :4]), ValueError, "Cm must be"),
        "integer x": ((x.long(), dt, A, Bm, Cm), TypeError, "floating"),
        "integer Bm": ((x, dt, A, Bm.int(), Cm), TypeError, "floating"),
        "devices differ": ((x, dt.to("meta"), A, Bm, Cm), ValueError,
                           "dt is on meta"),
        "meta device": ((meta, dt.to("meta"), A.to("meta"), Bm.to("meta"),
                         Cm.to("meta")), ValueError, "CPU or CUDA"),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_rejects_what_it_cannot_take(case):
    args, err, match = _bad_calls()[case]
    with pytest.raises(err, match=match):
        ops.ssd_scan(*args, chunk=8)


def test_wrapper_rejects_a_bad_chunk():
    args = [torch.from_numpy(a) for a in _inputs(16, 2, 4, 8)]
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=0)


def test_ssd_chunked_computes_fp64_inputs_in_fp64():
    """fp64 inputs give an fp64 scan (the yardstick ``chip_smoke.py``
    holds fp32 forwards against), equal to the fp64 sequential
    recurrence to 1e-10."""
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in _inputs(24, 2, 4, 8))
    y, ex = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in
                                 (x, dt, A, Bm, Cm)), chunk=8)
    assert y.dtype == torch.float64 and ex.final_state.dtype == torch.float64
    s = np.zeros((2, 2, 4, 8))
    want = np.empty_like(x)
    for t in range(24):
        s = (np.exp(dt[:, t] * A)[:, :, None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * Bm[:, t, None, None, :])
        want[:, t] = np.einsum("bhpn,bn->bhp", s, Cm[:, t])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ex.final_state.numpy(), s, rtol=1e-10,
                               atol=1e-10)
