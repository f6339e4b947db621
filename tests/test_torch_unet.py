"""The 3D U-Net through the port against the reference, on the CPU.

* ``deconv3d`` against ``lax.conv_transpose`` (DHWIO, the reference's
  up-convolution) on weights that are not symmetric, forward and
  gradients within 1e-6 of the scale: the taps are reversed;
* the forward and ``segmentation_loss`` with their gradients against
  ``jax.value_and_grad`` of the reference's, on ``unet3d-smoke``:
  logits within 1e-4 of their scale, each gradient leaf within 1e-5 of
  its max-abs — or, where the reference's own gradient lies farther than
  that from the fp64 gradient, nearer it than the reference and within
  1e-5 of it (the rule of ``tests/test_torch_spatial_train.py``);
* the ``Session``: a 4-step loss trajectory from the reference's
  checkpoint within 1e-5 relative, checkpoints restored both ways,
  ``evaluate`` against the reference's, and serving logits against the
  reference's ``InferenceSession`` on the same checkpoint, unsharded and
  depth-split (every shard on the CPU);
* ``kernel_launches`` against the wrappers' calls counted in a forward
  and a training step on every mesh the port trains on;
* ``RunConfigError`` naming the field for a bad spatial degree and for
  ``data > 1`` in ``mode="infer"``.

The grad_comm probe at 1 x 2, 1 x 4 and 2 x 2 is held against the
reference's in ``tests/test_torch_spatial_train.py``, which runs the
reference's sharded steps in its one 4-device subprocess. Inputs come
from numpy with a seed; the reference's parameters are carried across
with ``params_from_numpy``. Only the plain versions run here.
"""
import dataclasses
import functools
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from repro import api as japi
from repro.configs import unet3d as junet_cfg
from repro.models import unet3d as junet
from repro.serve import InferenceSession as JInferenceSession
from repro_torch.api import RunConfig, RunConfigError, Session, compile
from repro_torch.configs import get_smoke_config, unet3d as unet_cfg
from repro_torch.core import dist_norm
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning, deconv3d
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.models import unet3d
from repro_torch.serve import InferenceSession

CFG = unet_cfg.SMOKE
W = CFG.input_width
GB = 2
STEPS = 4


def _scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1e-12, np.max(np.abs(want)))


def _batch(seed, n=GB):
    r = np.random.RandomState(seed)
    return (r.randn(n, W, W, W, 1).astype(np.float32),
            r.randint(0, CFG.out_dim, (n, W, W, W)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _ref_params(seed=0):
    p = {k: np.asarray(v) for k, v in jax.jit(
        lambda key: junet.init_params(key, junet_cfg.SMOKE))(
            jax.random.PRNGKey(seed)).items()}
    r = np.random.RandomState(seed)
    for k in p:  # non-trivial BN scales and biases
        if p[k].ndim == 1:
            p[k] = (p[k] + 0.1 * r.randn(*p[k].shape)).astype(np.float32)
    return p


# ------------------------------------------------------------ config ----
def test_registry_and_shapes_match_reference():
    from repro.configs import get_config as jget_config

    assert dataclasses.asdict(unet_cfg.CONFIG) == dataclasses.asdict(
        jget_config("unet3d-256"))
    assert get_smoke_config("unet3d-256") == CFG
    shapes = unet3d.param_shapes(CFG)
    ref = _ref_params()
    assert set(shapes) == set(ref)
    assert all(tuple(ref[k].shape) == s for k, s in shapes.items())
    init = unet3d.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert all(tuple(init[k].shape) == s for k, s in shapes.items())
    assert torch.equal(init["enc0_s0"], torch.ones(4))
    assert torch.equal(init["dec0_b1"], torch.zeros(8))
    preset = unet_cfg.run_preset()
    assert preset.model == CFG and preset.total_steps == 30


# ------------------------------------------------------------ deconv ----
@pytest.mark.parametrize("shape,cout", [((2, 3, 4, 5, 6), 7),
                                        ((1, 2, 2, 2, 8), 4)])
def test_deconv3d_matches_conv_transpose(shape, cout):
    r = np.random.RandomState(shape[-1])
    x = r.randn(*shape).astype(np.float32)
    w = r.randn(2, 2, 2, shape[-1], cout).astype(np.float32)

    def jdeconv(x, w):
        return lax.conv_transpose(x, w, strides=(2, 2, 2), padding="VALID",
                                  dimension_numbers=("NDHWC", "DHWIO",
                                                     "NDHWC"))

    y, vjp = jax.vjp(jdeconv, jnp.asarray(x), jnp.asarray(w))
    ct = r.randn(*y.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = deconv3d(tx, tw, SpatialPartitioning(("model", None, None)))
    assert _scale_err(ty.detach(), y) <= 1e-6
    ty.backward(torch.from_numpy(ct))
    assert _scale_err(tx.grad, jdx) <= 1e-6
    assert _scale_err(tw.grad, jdw) <= 1e-6
    # PyTorch's own transposed conv takes the taps the other way round
    naive = F.conv_transpose3d(tx.detach().permute(0, 4, 1, 2, 3),
                               tw.detach().permute(3, 4, 0, 1, 2),
                               stride=2).permute(0, 2, 3, 4, 1)
    assert _scale_err(naive, y) > 1e-2


def test_deconv3d_takes_only_kernel_equal_to_stride():
    with pytest.raises(NotImplementedError, match="stride"):
        deconv3d(torch.zeros(1, 2, 2, 2, 3), torch.zeros(3, 3, 3, 3, 4),
                 SpatialPartitioning(), stride=2)


# ------------------------------------------------------ forward, loss ----
def _conv64(x, w, stride=1, pads=((0, 0),) * 3):
    (pd, qd), (ph, qh), (pw, qw) = pads
    xc = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)).permute(0, 4, 1, 2, 3)
    return F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=stride).permute(
        0, 2, 3, 4, 1)


def _bn64(x, scale, bias, reduce_axes=(), eps=1e-5, activation_slope=None):
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    return F.leaky_relu((x - mean) * torch.rsqrt(var + eps) * scale + bias,
                        activation_slope)


def _nll64(logits, labels, denominator):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).sum() / denominator


def _port_loss_grads(p, x, y, dtype=torch.float32):
    tp = {k: v.requires_grad_(True) for k, v in unet3d.params_from_numpy(
        p, "cpu", dtype, cfg=CFG).items()}
    loss = unet3d.segmentation_loss(tp, torch.from_numpy(x).to(dtype),
                                    torch.from_numpy(y), CFG,
                                    global_voxels=4 * W ** 3)
    return loss, dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))


def test_forward_and_loss_match_reference_with_gradients():
    p = _ref_params()
    x, y = _batch(1)

    def jloss(params):
        return junet.segmentation_loss(params, jnp.asarray(x),
                                       jnp.asarray(y), junet_cfg.SMOKE,
                                       global_voxels=4 * W ** 3)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jp)
    logits = junet.forward(jp, jnp.asarray(x), junet_cfg.SMOKE)
    with torch.no_grad():
        got = unet3d.forward(unet3d.params_from_numpy(p, "cpu", cfg=CFG),
                             torch.from_numpy(x), CFG)
    assert got.shape == (GB, W, W, W, CFG.out_dim)
    assert _scale_err(got, logits) <= 1e-4
    loss, grads = _port_loss_grads(p, x, y)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    assert set(grads) == set(p)
    exact = None
    for k, g in grads.items():
        if _scale_err(g, want[k]) <= 1e-5:
            continue
        if exact is None:  # the fp64 gradient: convs, BN and loss in fp64
            with mock.patch.object(conv_ops, "conv3d", _conv64), \
                    mock.patch.object(dist_norm, "distributed_batchnorm",
                                      _bn64), \
                    mock.patch.object(unet3d, "voxel_nll", _nll64):
                exact = _port_loss_grads(p, x, y, torch.float64)[1]
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(np.asarray(want[k]), exact[k].numpy())
        assert port_err <= min(1e-5, ref_err), (k, port_err, ref_err)


def test_segmentation_loss_is_the_mean_voxel_cross_entropy():
    logits = torch.randn(2, 3, 3, 3, 3, dtype=torch.float64)
    labels = torch.randint(0, 3, (2, 3, 3, 3))
    want = F.cross_entropy(logits.permute(0, 4, 1, 2, 3), labels)
    got = unet3d.voxel_nll(logits, labels, labels.numel())
    assert got.dtype == torch.float32
    assert abs(got.item() - want.item()) <= 1e-6 * want.item()
    # bf16 logits are widened before the softmax
    assert unet3d.voxel_nll(logits.bfloat16(), labels, 1).dtype == \
        torch.float32


# ------------------------------------------------------------ session ----
@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's U-Net smoke Session: a checkpoint at step 0 and at
    step 2, the loss of each of 4 steps, its final parameters and its
    evaluate on a fifth batch."""
    root = tmp_path_factory.mktemp("unet_ref")
    sess = japi.compile(japi.RunConfig(model="unet3d-256", smoke=True,
                                       global_batch=GB))
    sess.save(str(root / "step0"))
    losses = []
    for i in range(STEPS):
        if i == 2:
            sess.save(str(root / "step2"))
        x, y = _batch(10 + i)
        losses.append(float(sess.step(jnp.asarray(x), jnp.asarray(y))))
    x, y = _batch(20)
    ev_loss, ev_logits = sess.evaluate(jnp.asarray(x), jnp.asarray(y))
    out = {"root": root, "losses": losses,
           "params": {k: np.asarray(v) for k, v in sess.params.items()},
           "eval": (float(ev_loss), np.asarray(ev_logits))}
    sess.close()
    return out


def test_trajectory_matches_reference_session(reference_run):
    """Four steps from the reference's checkpoint: each loss within 1e-5
    relative of the reference's; ``evaluate``'s loss and logits after
    them. The final parameters lie within one step's largest move, lr
    (1e-3), of the reference's: rounding flips a few ReLU signs and pool
    winners (the discrete decisions of ``chip_smoke.py::decisions``),
    which changes those units' gradients outright, and Adam's normalized
    update moves each element it touches by up to lr a step (at
    ``enc0_w1`` the momentum of one element differs by ~10% after 4
    steps, its parameter by 2.6e-4)."""
    sess = Session.restore(str(reference_run["root"] / "step0"),
                           device="cpu")
    assert sess.step_count == 0 and sess.cfg == CFG
    assert sess.plan.name == "unet3d.legacy"
    losses = [float(sess.step(*_batch(10 + i))) for i in range(STEPS)]
    for got, want in zip(losses, reference_run["losses"]):
        assert abs(got - want) <= 1e-5 * abs(want), (
            losses, reference_run["losses"])
    for k, want in reference_run["params"].items():
        assert np.max(np.abs(sess.params[k].numpy() - want)) <= 1e-3, k
    ev_loss, ev_logits = sess.evaluate(*_batch(20))
    want_loss, want_logits = reference_run["eval"]
    assert abs(float(ev_loss) - want_loss) <= 1e-4 * want_loss
    assert _scale_err(ev_logits, want_logits) <= 1e-3
    sess.close()


def test_port_resumes_reference_checkpoint(reference_run):
    sess = Session.restore(str(reference_run["root"] / "step2"),
                           device="cpu")
    assert sess.step_count == 2 and int(sess.opt_state.step) == 2
    want = reference_run["losses"][2]
    assert abs(float(sess.step(*_batch(12))) - want) <= 1e-5 * abs(want)
    sess.close()


def test_reference_resumes_port_checkpoint(reference_run, tmp_path):
    sess = Session.restore(str(reference_run["root"] / "step0"),
                           device="cpu")
    for i in range(2):
        sess.step(*_batch(10 + i))
    path = sess.save(str(tmp_path / "port"))
    port_next = float(sess.step(*_batch(12)))
    sess.close()
    ref = japi.Session.restore(path)
    assert ref.step_count == 2
    x, y = _batch(12)
    got = float(ref.step(jnp.asarray(x), jnp.asarray(y)))
    ref.close()
    assert abs(got - port_next) <= 1e-5 * abs(port_next)
    assert abs(got - reference_run["losses"][2]) <= 1e-5 * abs(got)


@pytest.mark.parametrize("spatial", [1, 2])
def test_serving_logits_match_reference_inference_session(reference_run,
                                                          spatial):
    ckpt = str(reference_run["root"] / "step2")
    x, y = _batch(30)
    with JInferenceSession.restore(ckpt) as ref:
        want = np.asarray(ref.predict(jnp.asarray(x)))
        want_loss, _ = ref.evaluate(jnp.asarray(x), jnp.asarray(y))
    with InferenceSession.restore(ckpt, devices=["cpu"] * spatial,
                                  spatial=spatial) as sess:
        assert sess.mesh.shape == {"data": 1, "model": spatial}
        got = sess.predict(x)
        loss, logits = sess.evaluate(x, y)
        with sess.serve(max_batch=2, max_wait_ms=50) as h:
            rows = [f.result(timeout=120) for f in h.submit_many(list(x))]
    assert got.shape == want.shape == (GB, W, W, W, CFG.out_dim)
    assert _scale_err(got, want) <= 1e-4
    assert torch.equal(logits, got)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    assert _scale_err(np.stack(rows), want) <= 1e-4


def test_compile_serves_and_trains_the_smoke_unet():
    x, y = _batch(40)
    with compile(RunConfig(model="unet3d-256", smoke=True, mode="infer",
                           global_batch=GB), device="cpu") as sess:
        assert sess.describe().plan_name == "unet3d.legacy"
        one = sess.predict(x)
    for S in (2, 4):
        with compile(RunConfig(model="unet3d-256", smoke=True,
                               mode="infer", global_batch=GB, spatial=S),
                     devices=["cpu"] * S) as sess:
            assert _scale_err(sess.predict(x), one) <= 1e-5
    with compile(RunConfig(model="unet3d-256", smoke=True, global_batch=GB,
                           precision="bf16"), device="cpu") as sess:
        losses = [float(sess.step(x, y)) for _ in range(2)]
        assert all(v.dtype == torch.float32 for v in sess.params.values())
    assert all(np.isfinite(losses))


# ----------------------------------------------------------- launches ----
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2)]


@pytest.mark.parametrize("D,S", MESHES)
def test_kernel_launches_follow_the_plan(monkeypatch, D, S):
    """Each wrapper call, counted on the CPU in one forward and in one
    training step, equals what ``kernel_launches`` derives from the plan:
    the counts the card's launch counters are held to."""
    calls = dict.fromkeys(("conv3d", "conv3d_dgrad", "bn_act", "pack",
                           "unpack"), 0)
    lock = threading.Lock()

    def counted(key, fn):
        def wrapper(*a, **k):
            with lock:
                calls[key] += 1
            return fn(*a, **k)
        return wrapper

    for mod, attr, key in ((conv_ops, "conv3d_valid", "conv3d"),
                           (conv_ops, "conv3d_input_grad", "conv3d_dgrad"),
                           (bn_ops, "bn_leaky_relu", "bn_act"),
                           (pack_ops, "pack", "pack"),
                           (pack_ops, "unpack", "unpack")):
        monkeypatch.setattr(mod, attr, counted(key, getattr(mod, attr)))
    x, y = _batch(50)
    with compile(RunConfig(model="unet3d-256", smoke=True, global_batch=GB,
                           data=D, spatial=S),
                 devices=["cpu"] * (D * S)) as sess:
        sess.evaluate(x, y)
        fwd = dict(calls)
        want_fwd = unet3d.kernel_launches(CFG, sess.plan)
        assert fwd == dict(want_fwd, conv3d_dgrad=0)
        calls.update(dict.fromkeys(calls, 0))
        sess.step(x, y)
        assert calls == unet3d.kernel_launches(CFG, sess.plan, train=True)
    # a split bottleneck (local depth 2 or 1) has no interior: unpack runs
    assert calls["pack"] > 0 and calls["unpack"] > 0 if S > 1 else \
        calls["pack"] == calls["unpack"] == 0


def test_kernel_launches_at_unet3d_256():
    cfg = unet_cfg.CONFIG
    depth = SpatialPartitioning(("model", None, None))
    one = plan_lib.legacy_convnet_plan(cfg, depth)
    assert unet3d.kernel_launches(cfg, one, train=True) == {
        "conv3d": 14, "conv3d_dgrad": 13, "bn_act": 14, "pack": 0,
        "unpack": 0}
    two = plan_lib.legacy_convnet_plan(cfg, depth, (2, 1, 1))
    assert two.stages == (plan_lib.Stage(0, 4, ("model", None, None)),)
    assert unet3d.kernel_launches(cfg, two) == {
        "conv3d": 84, "bn_act": 28, "pack": 28, "unpack": 0}
    shapes = unet3d.conv_shapes(cfg, 1)
    assert len(shapes) == 14
    assert shapes[0][1] == (3, 3, 3, 1, 32)       # enc0_w0: Cin = 1
    assert shapes[8][:2] == ((1, 64, 64, 64, 512), (3, 3, 3, 512, 256))
    flops = sum(2 * np.prod(xs[:4]) * np.prod(ws) for xs, ws, _, _ in shapes)
    assert abs(flops / 1e12 - 23.8) < 0.1  # TFLOP a forward


# ------------------------------------------------------------- config ----
def test_config_rejects_bad_degrees_naming_the_field():
    for kw, field in ((dict(spatial=3), "spatial"),
                      (dict(spatial=8), "spatial"),
                      (dict(data=2, mode="infer"), "data")):
        with pytest.raises(RunConfigError) as e:
            RunConfig(model="unet3d-256", smoke=True, global_batch=GB,
                      **kw).validate(device_count=None)
        assert e.value.field == field, kw
        assert e.value.fix
    RunConfig(model="unet3d-256", spatial=64).validate(device_count=None)
    with pytest.raises(RunConfigError) as e:
        RunConfig(model="unet3d-256", spatial=128).validate(
            device_count=None)
    assert e.value.field == "spatial"  # local width 2 < 4


def test_remat_is_not_ported():
    plan = plan_lib.ParallelPlan(
        (plan_lib.Stage(0, 3, (None, None, None), ("data",), remat=True),),
        (("data", 1),), 3, name="remat")
    p = unet3d.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_batch(1)[0])
    with torch.no_grad():  # remat changes nothing without a backward
        unet3d.forward(p, x, CFG, plan=plan)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    with pytest.raises(NotImplementedError, match="remat"):
        unet3d.forward(p, x, CFG, plan=plan)
