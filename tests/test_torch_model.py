"""The port's CosmoFlow forward against the reference's, on the same
weights carried across by ``params_from_numpy``.

Inputs and weights come from numpy / the reference's own initializer;
both forwards run on the CPU (the port's wrappers take their plain
versions there). Tolerances: fp32 1e-4 of the output scale (different
summation order through 3-5 conv + batch-norm blocks and the FC head);
bf16 5e-2 of the output scale (the reference's unfused bf16 batch-norm
rounds after every op, the port's kernel once).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import config as jconfig
from repro.configs import cosmoflow as jcosmo_cfg
from repro.configs.base import ConvNetConfig as JConvNetConfig
from repro.core import dist_norm as jdist_norm
from repro.core import plan as jplan
from repro.core import spatial_conv as jspatial
from repro.models import cosmoflow as jcosmo
from repro_torch.api import config as tconfig
from repro_torch.configs import cosmoflow as tcosmo_cfg
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import dist_norm, plan
from repro_torch.core import spatial_conv
from repro_torch.models import cosmoflow

SMOKE = tcosmo_cfg.SMOKE
# five blocks: block 3's stride-2 conv and the unpooled deep block run
FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d",
                     arch="cosmoflow", input_width=16, in_channels=2,
                     out_dim=4, conv_channels=(4, 8, 8, 16, 16),
                     fc_dims=(32, 16))


def _jcfg(cfg):
    return JConvNetConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jcosmo.init_params(k, jcfg))


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg, use_pallas=False, precision=None):
    return jax.jit(lambda p, x: jcosmo.forward(
        p, x, jcfg, use_pallas=use_pallas, precision=precision))


def _weights(cfg, seed=0):
    """Reference-initialized params as numpy, with non-trivial BN
    scales/biases and FC biases so every parameter is exercised."""
    p = {k: np.asarray(v) for k, v in
         _jit_init(_jcfg(cfg))(jax.random.PRNGKey(seed)).items()}
    r = np.random.RandomState(seed)
    for k in p:
        if k.endswith(("_scale", "_bias", "_b")):
            p[k] = (p[k] + 0.1 * r.randn(*p[k].shape)).astype(np.float32)
    return p


def _volume(cfg, n=2, seed=0):
    w = cfg.input_width
    return np.random.RandomState(seed).randn(
        n, w, w, w, cfg.in_channels).astype(np.float32)


def _assert_scaled_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), err


def test_config_copies_match_the_reference():
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(jcosmo_cfg.SMOKE)
    for w in (128, 256, 512):
        t, j = (tcosmo_cfg.config_for_width(w),
                jcosmo_cfg.config_for_width(w))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("cfg", [SMOKE, FIVE, tcosmo_cfg.CONFIG],
                         ids=["smoke", "five", "cosmoflow-512"])
def test_param_shapes_match_the_reference(cfg):
    want = jax.eval_shape(
        lambda k: jcosmo.init_params(k, _jcfg(cfg)), jax.random.PRNGKey(0))
    assert cosmoflow.param_shapes(cfg) == {k: tuple(v.shape)
                                           for k, v in want.items()}
    got = cosmoflow.init_params(cfg, torch.Generator().manual_seed(0),
                                "meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        cosmoflow.param_shapes(cfg)


def test_params_from_numpy_checks_names_and_shapes():
    p = _weights(SMOKE)
    got = cosmoflow.params_from_numpy(p, "cpu", cfg=SMOKE)
    for k, v in p.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bad = dict(p, conv0_w=p["conv0_w"][..., :2])
    with pytest.raises(ValueError, match="conv0_w"):
        cosmoflow.params_from_numpy(bad, "cpu", cfg=SMOKE)
    with pytest.raises(ValueError, match="missing"):
        cosmoflow.params_from_numpy(
            {k: v for k, v in p.items() if k != "fc0_b"}, "cpu", cfg=SMOKE)


@pytest.mark.parametrize("cfg,use_pallas", [(SMOKE, False), (FIVE, False),
                                            (FIVE, True)],
                         ids=["smoke", "five", "five-pallas"])
def test_forward_matches_reference_fp32(cfg, use_pallas):
    p, x = _weights(cfg), _volume(cfg)
    want = _jit_forward(_jcfg(cfg), use_pallas)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = cosmoflow.forward(cosmoflow.params_from_numpy(p, "cpu", cfg=cfg),
                            torch.from_numpy(x), cfg)
    _assert_scaled_close(got.numpy(), want, 1e-4)


def test_forward_matches_reference_bf16():
    p, x = _weights(FIVE), _volume(FIVE, seed=1)
    want = _jit_forward(_jcfg(FIVE), precision="bf16")(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = cosmoflow.forward(cosmoflow.params_from_numpy(p, "cpu", cfg=FIVE),
                            torch.from_numpy(x), FIVE, precision="bf16")
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(got.float().numpy(), want, 5e-2)


def test_mse_loss_matches_reference():
    p, x = _weights(SMOKE), _volume(SMOKE, n=3)
    y = np.random.RandomState(5).randn(3, SMOKE.out_dim).astype(np.float32)
    want = jax.jit(lambda p, x, y: jcosmo.mse_loss(
        p, x, y, _jcfg(SMOKE), train=False))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(y))
    got = cosmoflow.mse_loss(cosmoflow.params_from_numpy(p, "cpu", cfg=SMOKE),
                             torch.from_numpy(x), torch.from_numpy(y), SMOKE)
    _assert_scaled_close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_same_conv_matches_reference(stride):
    r = np.random.RandomState(stride)
    x = r.randn(2, 8, 8, 8, 3).astype(np.float32)
    w = (r.randn(3, 3, 3, 3, 6) * 0.2).astype(np.float32)
    want = jspatial.conv3d(jnp.asarray(x), jnp.asarray(w),
                           jspatial.SpatialPartitioning(), stride=stride)
    got = spatial_conv.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                              spatial_conv.SpatialPartitioning(),
                              stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 3), (1, 5, 6, 7, 2)])
def test_maxpool_matches_reference_exactly(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jspatial.maxpool3d(jnp.asarray(x), jspatial.SpatialPartitioning())
    got = spatial_conv.maxpool3d(torch.from_numpy(x),
                                 spatial_conv.SpatialPartitioning())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("slope", [None, 0.01])
def test_batchnorm_statistics_match_reference(slope):
    r = np.random.RandomState(7)
    x = (3.0 + 2.0 * r.randn(2, 5, 4, 3, 6)).astype(np.float32)
    scale, bias = (r.randn(6).astype(np.float32) for _ in range(2))
    want = jdist_norm.distributed_batchnorm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), (),
        activation_slope=slope)
    got = dist_norm.distributed_batchnorm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        activation_slope=slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # outside a sharded run every mesh axis has one shard: reducing over
    # it changes nothing
    over_model = dist_norm.distributed_batchnorm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        ("model",), activation_slope=slope)
    assert torch.equal(over_model, got)


@pytest.mark.parametrize("width,spatial", [(128, 1), (512, 1), (512, 4),
                                           (128, 2), (128, 4), (256, 2),
                                           (512, 2)])
def test_legacy_plan_json_matches_reference(width, spatial):
    args = (("model", None, None), (spatial, 1, 1))
    want = jconfig.plan_to_json(jplan.legacy_convnet_plan(
        jcosmo_cfg.config_for_width(width),
        jspatial.SpatialPartitioning(args[0]), args[1]))
    got = tconfig.plan_to_json(plan.legacy_convnet_plan(
        tcosmo_cfg.config_for_width(width),
        spatial_conv.SpatialPartitioning(args[0]), args[1]))
    assert got == want
    assert tconfig.plan_to_json(tconfig.plan_from_json(want)) == want


def test_run_config_json_matches_reference():
    kw = dict(mode="infer", global_batch=2, precision="bf16", seed=3)
    want = jconfig.RunConfig(model=_jcfg(FIVE), **kw).to_json()
    got = tconfig.RunConfig(model=FIVE, **kw).to_json()
    assert got == want
    assert tconfig.RunConfig.from_json(want).to_json() == want


def test_forward_rejects_what_this_slice_does_not_run():
    p = cosmoflow.params_from_numpy(_weights(SMOKE), "cpu", cfg=SMOKE)
    x = torch.from_numpy(_volume(SMOKE, n=1))
    with pytest.raises(NotImplementedError, match="training"):
        cosmoflow.forward(p, x, SMOKE, train=True)
    two_way = plan.legacy_convnet_plan(
        SMOKE, spatial_conv.SpatialPartitioning(("model", None, None)),
        (2, 1, 1))
    # a 2-way plan runs inside spmd.run over a 2-shard mesh, never
    # silently on one device
    with pytest.raises(ValueError, match="2 devices"):
        cosmoflow.forward(p, x, SMOKE, plan=two_way)
