"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes and tolerances are those of ``tests/test_kernels.py`` (2e-5 in
fp32, 2e-2 in bf16); the inputs come from numpy with a seed. The conv3d
kernel is also held at every cosmoflow-128 layer (``chip_smoke.py``'s
tolerances), at small Cin, k = 1 and 5, stride 2 and the thin boundary
pieces of the overlapped spatial lowering, through both of its kernels,
and its split-K sum must give the same bits on every run. The halo
pack and unpack kernels are copies, so they must equal their plain
versions exactly, at every face of the depth-split layers that
``chip_smoke.py`` checks, and at each of their vector counts a thread
(``ops.REG_VECTORS`` patched to each) at the edges of the work split
(``chip_smoke.HALO_EDGES``): runs shorter than a chunk, not a multiple
of it, of many chunks, one width 0, rows of 2-byte elements not a
multiple of 16 bytes, more runs than a grid's y-dimension once took; a
split the kernel cannot take raises; a 2-way session, one stream per
shard on one
card, must match the unsharded forward. The SSD scan kernel is held
against its plain (sequential) version at ``tests/test_kernels.py``'s
shapes and two ragged ones, at 3e-4 in fp32 (the reference's kernel
contract) and 2e-2 of the output scale in bf16; on views of one
buffer (as the Mamba2 block passes x, B and C) it must give the bits it
gives on contiguous copies, and the same bits on every call; a Mamba2
forward through it against the same forward through the plain chunked
scan. The conv's input gradient (the same kernel over the flipped,
transposed filter) is held at every cosmoflow-128 layer that has one
against autograd through the plain conv, and a training ``Session`` on
the card launches 7 conv, 6 input-gradient and 7 bn_act kernels a
step and agrees with the same session on the CPU. A step with every
block rematerialized, at 1 x 1 and 1 x 2 on the card, matches the step
without (the reference's remat contract) and launches what
``kernel_launches`` counts with the recompute; the input pipeline's
batches on the card (pinned buffers, a copy stream) equal the CPU
loader's, prefetched or not.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.halo_pack import ref as pack_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

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


def _cosmoflow_128_convs():
    from repro_torch.configs import get_config
    from repro_torch.models import cosmoflow

    return cosmoflow.conv_shapes(get_config("cosmoflow-128"), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", range(7))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_kernel_at_every_cosmoflow_128_layer(cuda, layer, dtype):
    """The shapes of the main path (batch 4), He-scaled weights, at
    ``chip_smoke.py``'s tolerances: fp32 (3xTF32) within 1e-6 *
    sqrt(k^3 Cin) of the output scale, bf16 within one bf16 ulp."""
    xs, ws, stride, pads = _cosmoflow_128_convs()[layer]
    g = torch.Generator(device=cuda).manual_seed(layer)
    kc = ws[0] * ws[1] * ws[2] * ws[3]
    x = torch.randn(xs, generator=g, device=cuda).to(TORCH_DT[dtype])
    w = (torch.randn(ws, generator=g, device=cuda)
         * (2.0 / kc) ** 0.5).to(TORCH_DT[dtype])
    got = conv_ops.conv3d_valid(x, w, stride, pads)
    want = conv_ref.conv3d_valid(x, w, stride, pads)
    torch.cuda.synchronize()
    rel = 1e-6 * kc ** 0.5 if dtype == "float32" else 2 ** -7
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= rel * scale


# the U-Net's extreme input widths at a small depth: enc0_w0 (Cin = 1,
# 4-byte gather pieces in fp32, 2-byte in bf16) and dec2_w0 (Cin = 512,
# K = 13,824), and mid_w1's input gradient (K = 27 * 512)
UNET_CONVS = [((1, 8, 16, 16, 1), 32), ((1, 4, 8, 8, 512), 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("xs,cout", UNET_CONVS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_kernel_at_the_unet_input_widths(cuda, xs, cout, dtype):
    """``plan`` takes Cin = 1 and Cin = 512 (the gather kernel), and the
    kernel holds there and in the input gradient at ``chip_smoke.py``'s
    tolerances (fp32: 1e-6 sqrt(K) of the output scale; bf16 one ulp)."""
    ws = (3, 3, 3, xs[-1], cout)
    pads = ((1, 1),) * 3
    g = torch.Generator(device=cuda).manual_seed(xs[-1])
    x = torch.randn(xs, generator=g, device=cuda).to(TORCH_DT[dtype])
    w = (torch.randn(ws, generator=g, device=cuda)
         * (2.0 / (27 * xs[-1])) ** 0.5).to(TORCH_DT[dtype])
    plan = conv_ops.plan(xs, ws, xs[:4] + (cout,), TORCH_DT[dtype],
                         conv_ops._sms(0), x.data_ptr(), 1)
    assert plan.stages == 0  # the gather kernel
    got = conv_ops.conv3d_valid(x, w, 1, pads)
    want = conv_ref.conv3d_valid(x, w, 1, pads)
    dy = torch.randn(got.shape, generator=g, device=cuda).to(TORCH_DT[dtype])
    dx = conv_ops.conv3d_input_grad(dy, w, xs, 1, pads)
    w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    want_dx = conv_ref.conv3d_valid(dy, w_t, 1, pads)
    torch.cuda.synchronize()
    for a, b, k in ((got, want, 27 * xs[-1]), (dx, want_dx, 27 * cout)):
        rel = 1e-6 * k ** 0.5 if dtype == "float32" else 2 ** -7
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_split_k_gives_the_same_bits_every_run(cuda, dtype):
    """Layer 5's shape splits K over many blocks; the splits are added in
    a fixed order, with no float atomics."""
    xs, ws, stride, pads = _cosmoflow_128_convs()[5]
    out = conv_ref.output_shape(xs, ws, stride, pads)
    assert conv_ops.plan(xs, ws, out, TORCH_DT[dtype], conv_ops._sms(0), 0,
                         stride).splits > 1
    x, w = _conv_inputs(xs, ws[0], ws[4])
    xt = torch.from_numpy(x).to(cuda, TORCH_DT[dtype])
    wt = torch.from_numpy(w).to(cuda, TORCH_DT[dtype])
    first = conv_ops.conv3d_valid(xt, wt, stride, pads)
    again = conv_ops.conv3d_valid(xt, wt, stride, pads)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    _close(first, conv_ref.conv3d_valid(xt, wt, stride, pads), TOL[dtype])


SAME = ((1, 1),) * 3
# (x shape, k, Cout, stride, pads): Cin 2, 3 and 4, k = 1 and 5, stride
# 2, ragged boxes and channels, asymmetric pads
CONV_EXTRA = [((2, 9, 10, 11, 2), 3, 8, 1, SAME),
              ((2, 9, 10, 11, 3), 3, 8, 1, SAME),
              ((1, 12, 12, 12, 4), 3, 16, 2, ((0, 1),) * 3),
              ((1, 6, 6, 6, 4), 1, 8, 1, ((0, 0),) * 3),
              ((2, 8, 8, 8, 8), 5, 16, 1, ((2, 2),) * 3),
              ((1, 5, 20, 33, 16), 3, 20, 1, SAME),
              ((1, 4, 17, 16, 32), 3, 64, 1, ((1, 1), (0, 2), (2, 0)))]


def _boundary_pieces():
    """The conv pieces of the overlapped depth-split lowering
    (``core/spatial_conv.py::_conv3d_overlap``) at every halo case: the
    interior and the thin lo and hi pieces, depth unpadded."""
    from repro_torch.core.spatial_conv import overlap_split

    pieces = set()
    for (n, d, h, w, c), lo, hi in _halo_cases():
        k, s = (2 * lo + 1, 1) if lo == hi else (3, 2)
        n_out, n_lo, n_hi = overlap_split(d, k, s)
        depths = {d + lo + hi} if n_lo + n_hi >= n_out else {
            (n_out - n_hi - 1) * s - n_lo * s + k,
            (n_lo - 1) * s + k if n_lo else 0,
            d - (n_out - n_hi) * s + lo + hi if n_hi else 0} - {0}
        pieces |= {((n, dd, h, w, c), k, s, ((0, 0), (lo, hi), (lo, hi)))
                   for dd in depths}
    return sorted(pieces)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["as planned", "patch where it can"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_kernel_at_small_cin_k_stride_and_boundary_pieces(
        cuda, kernel, dtype):
    """Both kernels: as planned for the card, and with the patch kernel
    taken wherever it can run (the plan told the card has one SM, which
    also leaves K unsplit). ``chip_smoke.py``'s tolerances, of the output
    scale: the grid's (weights scaled by 0.1) for the small-Cin shapes,
    the cosmoflow-128 layers' (He-scaled weights) for the boundary pieces,
    which have those layers' K (up to 6912)."""
    from unittest import mock

    sms = conv_ops._sms if kernel == "as planned" else (lambda index: 1)
    cases = ([(xs, k, cout, s, pads, None) for xs, k, cout, s, pads
              in CONV_EXTRA]
             + [(xs, k, 16, s, pads, (2.0 / (k ** 3 * xs[-1])) ** 0.5)
                for xs, k, s, pads in _boundary_pieces()])
    g = torch.Generator(device=cuda).manual_seed(0)
    with mock.patch.object(conv_ops, "_sms", sms):
        for xs, k, cout, stride, pads, he in cases:
            kc = k ** 3 * xs[-1]
            x = torch.randn(xs, generator=g, device=cuda).to(TORCH_DT[dtype])
            w = (torch.randn((k, k, k, xs[-1], cout), generator=g,
                             device=cuda) * (he or 0.1)).to(TORCH_DT[dtype])
            got = conv_ops.conv3d_valid(x, w, stride, pads)
            want = conv_ref.conv3d_valid(x, w, stride, pads)
            torch.cuda.synchronize()
            peak = want.float().abs().max().item()
            if he is None:
                tol = TOL[dtype] * (1 + peak)
            else:
                tol = (1e-6 * kc ** 0.5 if dtype == "float32" else 2 ** -7
                       ) * max(1.0, peak)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol, (xs, k, stride, pads, err, tol)


@pytest.mark.cuda
def test_conv3d_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    x = torch.randn(1, 6, 6, 6, 8, device=cuda)
    w = torch.randn(3, 3, 3, 8, 4, device=cuda)
    before = conv_ops.conv3d_valid.launches
    with pytest.raises(TypeError, match="one dtype"):
        conv_ops.conv3d_valid(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv3d_valid(x, w.transpose(3, 4).contiguous()
                              .transpose(3, 4))
    with pytest.raises(ValueError, match="x on"):
        conv_ops.conv3d_valid(x, w.cpu())
    assert conv_ops.conv3d_valid.launches == before


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


def _halo_cases():
    """(shard input shape, lo, hi) of every depth-split conv of
    cosmoflow-128 at batch 4 (S = 2 and 4, and the plan that splits all
    7 blocks at S = 2), plus k = 5 (lo = hi = 2) and a row of 180 bytes,
    not a multiple of 16."""
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.models import cosmoflow

    cfg = get_config("cosmoflow-128")
    plans = [plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (s, 1, 1))
        for s in (2, 4)]
    plans.append(plan_lib.ParallelPlan(
        (plan_lib.Stage(0, 7, ("model", None, None)),
         plan_lib.Stage(7, 8, (None, None, None))),
        (("data", 1), ("model", 2)), 8, name="deep"))
    cases = {(sc.shape, sc.lo, sc.hi) for p in plans
             for sc in cosmoflow.split_convs(cfg, p, 4)}
    cases |= {((2, 8, 16, 16, 8), 2, 2), ((2, 6, 3, 5, 3), 1, 1)}
    return sorted(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_pack_unpack_kernels_equal_plain_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for shape, lo, hi in _halo_cases():
        x = torch.randn(shape, generator=g, device=cuda).to(TORCH_DT[dtype])
        before = (pack_ops.pack.launches, pack_ops.unpack.launches)
        got = pack_ops.pack(x, lo, hi)
        n, _, h, w, c = shape
        lo_b = torch.randn((n, lo, h, w, c), generator=g, device=cuda).to(
            x.dtype) if lo else None
        hi_b = torch.randn((n, hi, h, w, c), generator=g, device=cuda).to(
            x.dtype) if hi else None
        out = pack_ops.unpack(x, lo_b, hi_b)
        assert (pack_ops.pack.launches, pack_ops.unpack.launches) == (
            before[0] + 1, before[1] + 1)
        torch.cuda.synchronize()
        assert torch.equal(got.buf, pack_ref.pack(x, lo, hi).buf), shape
        assert torch.equal(out, pack_ref.unpack(x, lo_b, hi_b)), shape


def _halo_edges():
    """The edges of the halo copy's work split, as ``chip_smoke.py``
    holds the kernel at them."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return list(cs.HALO_EDGES)


@pytest.mark.cuda
@pytest.mark.parametrize("vectors", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_kernels_equal_plain_at_each_vector_count_at_the_split_edges(
        cuda, vectors, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    with mock.patch.multiple(pack_ops, REG_VECTORS=(vectors,),
                             REG_STREAM_BYTES=1 << 62):
        for shape, lo, hi in _halo_edges() + _halo_cases():
            x = torch.randn(shape, generator=g, device=cuda).to(
                TORCH_DT[dtype])
            n, d, h, w, c = shape
            row = h * w * c * x.element_size()
            for kind in ("pack", "unpack"):
                sp = pack_ops.split(pack_ops.parts(kind, n, d, row, lo, hi),
                                    n, pack_ops._sms(0))
                assert sp.vectors == vectors
            bufs = [torch.randn((n, k, h, w, c), generator=g,
                                device=cuda).to(x.dtype) if k else None
                    for k in (lo, hi)]
            before = (pack_ops.pack.launches, pack_ops.unpack.launches)
            got = pack_ops.pack(x, lo, hi)
            out = pack_ops.unpack(x, *bufs)
            assert (pack_ops.pack.launches, pack_ops.unpack.launches) == (
                before[0] + 1, before[1] + 1)
            torch.cuda.synchronize()
            assert torch.equal(got.buf, pack_ref.pack(x, lo, hi).buf), shape
            assert torch.equal(out, pack_ref.unpack(x, *bufs)), shape
            # views that start off 16 bytes: the faces of a pack buffer
            if lo and hi:
                out = pack_ops.unpack(x, got.to_prev, got.to_next)
                assert torch.equal(out, pack_ref.unpack(
                    x, got.to_prev, got.to_next)), shape


@pytest.mark.cuda
def test_halo_copy_raises_on_a_split_it_cannot_take(cuda):
    from repro_torch.kernels import _build

    x = torch.randn(2, 6, 8, 8, 8, device=cuda)
    # no instantiation for 3 or 8 vectors a thread
    for bad in ((3,), (8,)):
        with mock.patch.object(pack_ops, "REG_VECTORS", bad):
            with pytest.raises(_build.KernelLaunchError):
                pack_ops.pack(x, 1, 1)
            with pytest.raises(_build.KernelLaunchError):
                pack_ops.unpack(x, x[:, :1].contiguous(), None)


@pytest.mark.cuda
def test_two_shards_on_one_card_match_the_unsharded_forward(cuda):
    """One stream per shard on one card: the copies between the shards
    wait on events, not on the order of enqueueing."""
    from repro_torch.api import RunConfig, compile

    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 32, 32, 32, 2).astype(np.float32)).to(cuda)
    kw = dict(model="cosmoflow-128", smoke=True, mode="infer",
              global_batch=2)
    one = compile(RunConfig(**kw), devices=[cuda])
    two = compile(RunConfig(spatial=2, **kw), devices=[cuda] * 2)
    assert two.mesh.stream(0) != two.mesh.stream(1)
    want = one.predict(x)
    for _ in range(3):
        got = two.predict(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_shards_on_separate_cards_match_one_card(cuda):
    """S shards on S cards (copies between cards) against the same S
    shards on one card, and against the unsharded forward."""
    from repro_torch.api import RunConfig, compile

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two CUDA devices")
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 32, 32, 32, 2).astype(np.float32)).to(cuda)
    kw = dict(model="cosmoflow-128", smoke=True, mode="infer",
              global_batch=2)
    want = compile(RunConfig(**kw), devices=[cuda]).predict(x)
    spread = compile(RunConfig(spatial=n, **kw))  # cuda:0..n-1
    assert [d.index for d in spread.mesh.devices] == list(range(n))
    one = compile(RunConfig(spatial=n, **kw), devices=[cuda] * n)
    got, same = spread.predict(x), one.predict(x)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


# (L, H, P, N, chunk): tests/test_kernels.py's four; L = 40 with chunk 16
# (lowered to 10); and L = 300 with chunk 256 (lowered to 150: three
# query tiles, the last ragged), 5 heads (a partial group), P = 64,
# N = 128
SSD_SHAPES = [(32, 2, 8, 16, 8), (64, 3, 8, 16, 16), (64, 1, 16, 8, 64),
              (48, 2, 4, 4, 12), (40, 2, 8, 16, 16), (300, 5, 64, 128, 256)]


def _ssd_inputs(cuda, L, H, P, N, dtype, B=2, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, L, H, P)
    dt = np.log1p(np.exp(r.randn(B, L, H)))  # softplus
    A = -np.exp(r.randn(H) * 0.5)
    Bm, Cm = r.randn(B, L, N), r.randn(B, L, N)
    dt_ = TORCH_DT[dtype]
    return (torch.tensor(x, dtype=dt_, device=cuda),
            torch.tensor(dt, dtype=dt_, device=cuda),
            torch.tensor(A, dtype=torch.float32, device=cuda),
            torch.tensor(Bm, dtype=dt_, device=cuda),
            torch.tensor(Cm, dtype=dt_, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain_on_card(cuda, shape, dtype):
    L, H, P, N, chunk = shape
    args = _ssd_inputs(cuda, L, H, P, N, dtype)
    before = ssd_ops.ssd_scan.launches
    y, state = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert ssd_ops.ssd_scan.launches == before + 1
    want_y, want_s = ssd_ref.ssd_scan(*args)
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and state.dtype == torch.float32
    # the state is fp32 from the same inputs in both: 3e-4
    _close(state, want_s, 3e-4)
    if dtype == "float32":
        _close(y, want_y, 3e-4)
    else:  # both round the same fp32 sums to bf16 once
        scale = max(1.0, want_y.float().abs().max().item())
        assert (y.float() - want_y.float()).abs().max().item() <= 2e-2 * scale


def _xbc_views(cuda, L, H, P, N, dtype, B=2, seed=1):
    """x, dt, A, Bm, Cm with x, Bm and Cm views of one (B, L, H*P + 2N)
    buffer, as the Mamba2 block splits its conv output."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, L, H, P, N, dtype, B=B, seed=seed)
    xbc = torch.cat([x.reshape(B, L, H * P), Bm, Cm], dim=-1)
    xv, bv, cv = torch.split(xbc, [H * P, N, N], dim=-1)
    return xv.reshape(B, L, H, P), dt, A, bv, cv


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SSD_SHAPES[1], SSD_SHAPES[-1]],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_reads_views_in_place(cuda, shape, dtype):
    """On views of one xBC-like buffer the kernel gives the bits it gives
    on contiguous copies, and the same bits on a second call."""
    L, H, P, N, chunk = shape
    x, dt, A, Bm, Cm = _xbc_views(cuda, L, H, P, N, dtype)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y2, state2 = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yc, statec = ssd_ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                                  Cm.contiguous(), chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(state, state2)
    assert torch.equal(y, yc) and torch.equal(state, statec)
    want_y, want_s = ssd_ref.ssd_scan(x, dt, A, Bm, Cm)
    _close(state, want_s, 3e-4)
    scale = max(1.0, want_y.float().abs().max().item())
    tol = 3e-4 if dtype == "float32" else 2e-2
    assert (y.float() - want_y.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_ssd_scan_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 32, 2, 8, 16, "float32")
    with pytest.raises(TypeError, match="float16"):
        ssd_ops.ssd_scan(x.half(), dt.half(), A, Bm.half(), Cm.half())
    with pytest.raises(TypeError, match="dt in x's dtype"):
        ssd_ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError, match="A in float32"):
        ssd_ops.ssd_scan(x.bfloat16(), dt.bfloat16(), A.bfloat16(),
                         Bm.bfloat16(), Cm.bfloat16())
    xt = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous x"):
        ssd_ops.ssd_scan(xt, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous Cm"):
        ssd_ops.ssd_scan(x, dt, A, Bm, torch.cat([Cm, Cm], -1)[..., ::2])
    with pytest.raises(ValueError, match="above the kernel"):
        ssd_ops.ssd_scan(*_ssd_inputs(cuda, 8192, 1, 4, 4, "float32", B=1),
                         chunk=8192)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_mamba2_forward_through_the_kernel_matches_the_plain_scan(cuda, dtype,
                                                                  rel):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import mamba2, ssm_lm

    cfg = get_smoke_config("mamba2-370m")
    params = ssm_lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device=cuda, dtype=TORCH_DT[dtype])
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 32))).to(cuda)
    before = ssd_ops.ssd_scan.launches
    got = ssm_lm.forward(params, toks, cfg)
    assert ssd_ops.ssd_scan.launches == before + cfg.num_layers

    def plain(x, dt, A, Bm, Cm, *, chunk):
        y, ex = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        return y, ex.final_state

    with mock.patch.object(ssd_ops, "ssd_scan", plain):
        want = ssm_lm.forward(params, toks, cfg)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + cfg.num_layers
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("layer", range(1, 7))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_input_grad_at_cosmoflow_128_layers(cuda, layer, dtype):
    """dL/dx by the kernel (batch 1) against autograd through the plain
    conv in fp32 on the same values, on the card: fp32 within 1e-6 *
    sqrt(k^3 Cout) of the scale (the forward's contract at the input
    gradient's K), bf16 within 2^-7 (one rounding of an fp32 sum; the
    plain conv's own bf16 backward rounds each tap's part)."""
    xs, ws, stride, pads = _cosmoflow_128_convs()[layer]
    xs = (1,) + tuple(xs[1:])
    g = torch.Generator(device=cuda).manual_seed(layer)
    kc = ws[0] * ws[1] * ws[2] * ws[4]
    x = torch.randn(xs, generator=g, device=cuda).to(TORCH_DT[dtype])
    w = (torch.randn(ws, generator=g, device=cuda)
         * (2.0 / kc) ** 0.5).to(TORCH_DT[dtype])
    xr = x.float().requires_grad_(True)
    y = conv_ref.conv3d_valid(xr, w.float(), stride, pads)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(x.dtype)
    y.backward(dy.float())
    before = conv_ops.conv3d_input_grad.launches
    got = conv_ops.conv3d_input_grad(dy, w, xs, stride, pads)
    assert conv_ops.conv3d_input_grad.launches == before + 1
    torch.cuda.synchronize()
    rel = 1e-6 * kc ** 0.5 if dtype == "float32" else 2 ** -7
    want = xr.grad.float()
    scale = max(1.0, want.abs().max().item())
    assert (got.float() - want).abs().max().item() <= rel * scale


@pytest.mark.cuda
def test_train_session_on_card_matches_cpu(cuda):
    from repro_torch.api import RunConfig, compile

    r = np.random.RandomState(0)
    x = r.randn(2, 32, 32, 32, 2).astype(np.float32)
    y = r.randn(2, 4).astype(np.float32)
    from repro_torch.models import cosmoflow

    def masks(seed, layer, ids, width, device):  # the same on both
        return cosmoflow.generator_masks(seed, layer, ids, width,
                                         "cpu").to(device)

    cfg = RunConfig(model="cosmoflow-128", smoke=True, global_batch=2)
    cpu = compile(cfg, device="cpu", mask_source=masks)
    card = compile(cfg, device=cuda, mask_source=masks)
    card.params = {k: v.to(cuda) for k, v in cpu.params.items()}
    counters = (conv_ops.conv3d_valid, conv_ops.conv3d_input_grad,
                bn_ops.bn_leaky_relu)
    before = [c.launches for c in counters]
    for _ in range(2):
        want = float(cpu.step(x, y))
        got = float(card.step(x, y))
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    # 3 conv blocks: the first needs no input gradient
    assert [c.launches - b for c, b in zip(counters, before)] == [6, 4, 6]


def _remat_plan(plan):
    import dataclasses

    return dataclasses.replace(plan, stages=tuple(
        dataclasses.replace(s, remat=True) for s in plan.stages))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2])
def test_remat_on_card_matches_no_remat(cuda, S):
    """Every block rematerialized, on one card (S shards, one stream
    each): the step's loss and reduced gradients against the same step
    without remat (loss 1e-5, gradients atol 1e-5, rtol 1e-4), and its
    launches against ``kernel_launches(train=True)`` with the
    recompute."""
    from repro_torch.configs import cosmoflow as cosmo_cfg
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import cosmoflow
    from repro_torch.optim.adam import Adam, constant
    from repro_torch.train import train_step

    cfg = cosmo_cfg.SMOKE
    base = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (S, 1, 1))
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(4, 32, 32, 32, 2).astype(np.float32))
    y = torch.from_numpy(r.randn(4, 4).astype(np.float32))
    p = cosmoflow.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    counters = {"conv3d": conv_ops.conv3d_valid,
                "conv3d_dgrad": conv_ops.conv3d_input_grad,
                "bn_act": bn_ops.bn_leaky_relu, "pack": pack_ops.pack,
                "unpack": pack_ops.unpack}
    out = {}
    for tag, plan in (("off", base), ("on", _remat_plan(base))):
        mesh = Mesh(plan.mesh_axes, [cuda] * S)
        probe = train_step.make_convnet_phase_probes(
            cfg, mesh, Adam(lr=constant(1e-3)), global_batch=4,
            plan=plan)["grad_comm"]
        before = {k: c.launches for k, c in counters.items()}
        loss, grads = probe(p, None, x.to(cuda), y.to(cuda), 0)
        torch.cuda.synchronize()
        got = {k: c.launches - before[k] for k, c in counters.items()}
        assert got == cosmoflow.kernel_launches(cfg, plan, train=True), tag
        out[tag] = loss.item(), {k: v.cpu() for k, v in grads.items()}
    assert abs(out["on"][0] - out["off"][0]) <= 1e-5
    for k, v in out["off"][1].items():
        np.testing.assert_allclose(out["on"][1][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2])
def test_loader_on_card_matches_the_cpu_loader(cuda, S, tmp_path):
    """``Session.make_loader`` on the card (pinned buffers, the copy
    stream): prefetched and synchronous batches bitwise equal to the CPU
    loader's, each rank's store bytes 1/S of the volume, and training
    from either loader gives the same losses."""
    from repro_torch.api import RunConfig, compile
    from repro_torch.data import store, synthetic

    cubes, targets = synthetic.make_cosmology_dataset(4, 32, channels=2,
                                                      seed=0)
    store.write_dataset(str(tmp_path), cubes, targets)
    cfg = RunConfig(model="cosmoflow-128", smoke=True, global_batch=2,
                    spatial=S, data_dir=str(tmp_path))
    cpu = compile(cfg, devices=["cpu"] * S)
    want = cpu.make_loader(prefetch=0)
    order = want.epoch_schedule()
    losses = {}
    for depth in (0, 2):
        sess = compile(cfg, devices=[cuda] * S)
        ld = sess.make_loader(prefetch=depth)
        assert np.array_equal(ld.epoch_schedule(), order)
        losses[depth] = []
        for lo in (0, 2):
            x, y = ld.load_batch(order[lo:lo + 2])
            wx, wy = want.load_batch(order[lo:lo + 2])
            assert x.device.type == "cuda"
            assert torch.equal(x.cpu(), wx) and torch.equal(y.cpu(), wy)
            losses[depth].append(float(sess.step(x, y)))
        rank = ld.stats.rank_pfs_bytes
        assert sorted(rank) == list(range(S))
        assert all(v >= 2 * 32 ** 3 * 2 * 4 // S for v in rank.values())
        sess.close()
    assert losses[0] == losses[2]
    cpu.close()


@pytest.mark.cuda
def test_zero1_on_card_holds_its_chunk_and_matches_overlap(cuda):
    """ZeRO-1 at 2 x 2 on one card: each shard's optimizer state is its
    1/N of every padded bucket on the card (2 x 4 x padded / N bytes a
    bucket), spatial peers hold the same chunk, and the parameters after
    2 steps lie within atol 1e-5, rtol 1e-4 of ``overlap``'s."""
    from repro_torch.api import RunConfig, compile
    from repro_torch.train import train_step

    r = np.random.RandomState(2)
    batches = [(r.randn(4, 32, 32, 32, 2).astype(np.float32),
                r.randn(4, 4).astype(np.float32)) for _ in range(2)]
    got = {}
    for mode in ("overlap", "reduce_scatter"):
        sess = compile(RunConfig(model="cosmoflow-128", smoke=True,
                                 global_batch=4, data=2, spatial=2,
                                 grad_comm=mode), devices=[cuda] * 4)
        for x, y in batches:
            sess.step(x, y)
        got[mode] = {k: v.cpu() for k, v in sess.params.items()}
        if mode == "reduce_scatter":
            plan = train_step.convnet_grad_plan(sess.cfg)
            for rank, st in enumerate(sess.opt_state):
                assert all(t.device.type == "cuda" for t in st.m)
                assert sum(t.numel() * t.element_size()
                           for t in (*st.m, *st.v)) == sum(
                    2 * 4 * plan.padded_size(b, 2) // 2
                    for b in plan.buckets)
                peer = sess.opt_state[rank ^ 1]
                assert all(torch.equal(a, b) for a, b in zip(st.v, peer.v))
        sess.close()
    for k, v in got["overlap"].items():
        np.testing.assert_allclose(got["reduce_scatter"][k].numpy(),
                                   v.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.cuda
def test_measured_peak_bytes_reads_the_allocator(cuda):
    """``measured_peak_bytes`` counts what a call allocates (a 64 MiB
    tensor alive at its end) in ``allocated``, and ``reserved`` holds at
    least as much."""
    from repro_torch.core import memory

    keep = []
    base = torch.cuda.memory_allocated(cuda)
    peak = memory.measured_peak_bytes(
        lambda: keep.append(torch.empty(16 << 20, device=cuda)))
    assert peak.allocated >= base + (64 << 20)
    assert peak.reserved >= peak.allocated
    with pytest.raises(ValueError):
        memory.measured_peak_bytes(lambda: None, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_reshards_on_card_are_their_oracle_and_plans_serve_alike(cuda, S):
    """On one card, each shard on its own stream: ``spatial_to_batch`` is
    bitwise its gather-and-slice oracle and ``batch_to_spatial`` undoes
    it, with the reverse all_to_all as the adjoint; a b1 batch plan
    serves within 1e-5 of the fixed plan (the spatial contract)."""
    from repro_torch.api import RunConfig, compile
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import reshard, spmd
    from repro_torch.launch.mesh import Mesh

    r = np.random.RandomState(S)
    x = torch.from_numpy(r.randn(S, 4, 2 * S, 3, 5, 2).astype(np.float32))
    mesh = Mesh([("model", S)], [cuda] * S)
    xs = [x[i].to(cuda).requires_grad_(True) for i in range(S)]
    with torch.enable_grad():
        ys = spmd.run(mesh, lambda t: reshard.spatial_to_batch(
            t, "model", 1), xs)
        oracle = spmd.run(mesh, lambda t: reshard.spatial_to_batch_oracle(
            t, "model", 1), xs)
        back = spmd.run(mesh, lambda t: reshard.batch_to_spatial(
            t, "model", 1), ys)
        gs = torch.autograd.grad(sum((b * (i + 1)).sum()
                                     for i, b in enumerate(back)), xs)
    for i in range(S):
        assert torch.equal(ys[i], oracle[i])
        assert torch.equal(back[i], xs[i])
        assert torch.equal(gs[i], torch.full_like(gs[i], i + 1))
    cfg_x = r.randn(4, 32, 32, 32, 2).astype(np.float32)
    preds = {}
    for name in ("fixed", "b1"):
        from repro_torch.configs import cosmoflow as cosmo_cfg

        plan = "fixed" if name == "fixed" else plan_lib.convnet_plan(
            cosmo_cfg.SMOKE, boundary=1, kind="batch",
            spatial_degrees=(S, 1, 1))
        sess = compile(RunConfig(model="cosmoflow-128", smoke=True,
                                 mode="infer", global_batch=4, spatial=S,
                                 plan=plan), devices=[cuda] * S)
        preds[name] = sess.predict(cfg_x).cpu()
        sess.close()
    np.testing.assert_allclose(preds["b1"].numpy(), preds["fixed"].numpy(),
                               atol=1e-5, rtol=0)
