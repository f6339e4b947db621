"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes and tolerances are those of ``tests/test_kernels.py`` (2e-5 in
fp32, 2e-2 in bf16); the inputs come from numpy with a seed. The halo
pack and unpack kernels are copies, so they must equal their plain
versions exactly, at every face of the depth-split layers that
``chip_smoke.py`` checks; a 2-way session, one stream per shard on one
card, must match the unsharded forward.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.halo_pack import ref as pack_ref

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
