"""Training through the port against the reference, on the CPU.

Each module of the training path is held against the JAX function it
ports, on the same numpy inputs: the conv's input and weight gradients
(``jax.vjp`` of ``lax.conv_general_dilated``), batch norm with its
statistics and the leaky-ReLU (``jax.vjp`` of the reference's
``distributed_batchnorm``), max pooling with ties, the dropout loss and
its gradients (``jax.value_and_grad`` of the reference's ``mse_loss``
with the reference's own masks), then the whole ``Session``: a 4-step
loss trajectory against the reference's ``Session.step`` from the
reference's checkpoint, and checkpoints restored across the packages in
both directions.

JAX's random bits cannot be reproduced in PyTorch, so the port is given
the reference's dropout masks (``jax_masks``), drawn the reference's way:
``bernoulli(fold_in(fold_in(PRNGKey(step), j), sample_id), 0.8)``.

Tolerances (fp32): 1e-5 of the scale for the conv gradients (the
reference's fwd+grad contract), 1e-5 for batch norm and the loss
gradients, exact for pooling, 1e-5 relative for the losses of the
trajectory.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import api as japi
from repro.core import dist_norm as jdist_norm
from repro.core import spatial_conv as jspatial
from repro.models import cosmoflow as jcosmo
from repro_torch.api import RunConfig, RunConfigError, Session, compile
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import dist_norm, faults, spatial_conv
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.models import cosmoflow
from repro_torch.optim.adam import AdamState

# five blocks: block 3's stride-2 conv and the unpooled deep block run
FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d",
                     arch="cosmoflow", input_width=16, in_channels=2,
                     out_dim=4, conv_channels=(4, 8, 8, 16, 16),
                     fc_dims=(32, 16))


def jax_masks(seed, layer, sample_ids, width, device):
    """The reference's dropout masks, as a port mask source."""
    layer_rng = jax.random.fold_in(jax.random.PRNGKey(seed), layer)
    rows = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(layer_rng, int(sid)), 0.8, (width,)))
        for sid in sample_ids]
    return torch.from_numpy(np.stack(rows)).to(device)


def _scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1e-12, np.max(np.abs(want)))


# ------------------------------------------------------------ conv ----
@pytest.mark.parametrize("stride,pads", [(1, (1, 1)), (2, (0, 1)),
                                         (1, (0, 1)), (2, (1, 1))])
def test_conv3d_gradients_match_xla_conv_vjp(stride, pads):
    r = np.random.RandomState(stride * 10 + pads[0])
    x = r.randn(2, 9, 8, 7, 3).astype(np.float32)
    w = (0.3 * r.randn(3, 3, 3, 3, 5)).astype(np.float32)

    def jconv(x, w):
        return lax.conv_general_dilated(
            x, w, (stride,) * 3, [pads] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    y, vjp = jax.vjp(jconv, jnp.asarray(x), jnp.asarray(w))
    dy = r.randn(*y.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = conv_ops.conv3d(tx, tw, stride, (pads,) * 3)
    assert _scale_err(ty.detach(), y) <= 1e-5
    ty.backward(torch.from_numpy(dy))
    assert _scale_err(tx.grad, jdx) <= 1e-5
    assert _scale_err(tw.grad, jdw) <= 1e-5
    # the input gradient alone, and none for an input needing none
    dx = conv_ops.conv3d_input_grad(torch.from_numpy(dy), tw.detach(),
                                    x.shape, stride, (pads,) * 3)
    assert torch.equal(dx, tx.grad)
    tw2 = torch.from_numpy(w).requires_grad_(True)
    conv_ops.conv3d(torch.from_numpy(x), tw2, stride, (pads,) * 3).backward(
        torch.from_numpy(dy))
    assert torch.equal(tw2.grad, tw.grad)


# -------------------------------------------------- batch norm, pool ----
def test_batchnorm_leaky_relu_gradients_match_reference():
    r = np.random.RandomState(3)
    x = (2.0 + r.randn(2, 4, 5, 3, 6)).astype(np.float32)
    scale = (1.0 + 0.2 * r.randn(6)).astype(np.float32)
    bias = (0.1 * r.randn(6)).astype(np.float32)

    def jbn(x, s, b):
        return jdist_norm.distributed_batchnorm(x, s, b, (),
                                                activation_slope=0.01)

    y, vjp = jax.vjp(jbn, *map(jnp.asarray, (x, scale, bias)))
    dy = r.randn(*y.shape).astype(np.float32)
    want = vjp(jnp.asarray(dy))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    ty = dist_norm.distributed_batchnorm(*ins, activation_slope=0.01)
    assert _scale_err(ty.detach(), y) <= 1e-5
    ty.backward(torch.from_numpy(dy))
    for t, w in zip(ins, want):
        assert _scale_err(t.grad, w) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_statistics_node_gives_autograds_values(dtype):
    """The statistics' autograd node (``dist_norm._Stats``, which saves x
    rather than an fp32 copy and writes its backward a piece at a time)
    against autograd of the two fp32 sums it replaces: the same sums and
    the same gradient bits, also when x spans several of the backward's
    pieces."""
    r = np.random.RandomState(4)
    x0 = torch.from_numpy((1.0 + 2.0 * r.randn(3, 5, 4, 2, 6)).astype(
        np.float32)).to(dtype)
    ds, dss = (torch.from_numpy(r.randn(6).astype(np.float32))
               for _ in range(2))
    dims = (0, 1, 2, 3)
    a = x0.clone().requires_grad_(True)
    with mock.patch.object(dist_norm.bn_ops, "BACKWARD_CHUNK_BYTES", 100):
        s, ss = dist_norm._Stats.apply(a)
        (ga,) = torch.autograd.grad((s * ds).sum() + (ss * dss).sum(), a)
    b = x0.clone().requires_grad_(True)
    bf = b.float()
    s2, ss2 = bf.sum(dim=dims), bf.square().sum(dim=dims)
    (gb,) = torch.autograd.grad((s2 * ds).sum() + (ss2 * dss).sum(), b)
    assert torch.equal(s, s2) and torch.equal(ss, ss2)
    assert ga.dtype == dtype and torch.equal(ga, gb)


def test_maxpool_gradient_follows_reference_tie_rule():
    """Windows with ties (zeros, a leaky-ReLU's common output, and
    repeated maxima) send the whole gradient where XLA's reduce_window
    gradient does: the first maximum in (d, h, w) order. Exact."""
    r = np.random.RandomState(4)
    x = r.randint(-2, 2, size=(2, 4, 6, 4, 3)).astype(np.float32)
    x[0, :2, :2, :2, 0] = 0.0   # a window of eight equal values
    x = np.concatenate([x, x[:, :1]], axis=1)  # odd depth: a cropped row
    part = jspatial.SpatialPartitioning()
    y, vjp = jax.vjp(lambda t: jspatial.maxpool3d(t, part), jnp.asarray(x))
    dy = r.randn(*y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = spatial_conv.maxpool3d(tx, spatial_conv.SpatialPartitioning())
    assert np.array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(torch.from_numpy(dy))
    assert np.array_equal(tx.grad.numpy(), np.asarray(want))


# -------------------------------------------------------------- loss ----
def _jcfg(cfg):
    from repro.configs.base import ConvNetConfig as JConvNetConfig

    return JConvNetConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _ref_params(cfg, seed=0):
    p = {k: np.asarray(v) for k, v in jax.jit(
        lambda k: jcosmo.init_params(k, _jcfg(cfg)))(
            jax.random.PRNGKey(seed)).items()}
    r = np.random.RandomState(seed)
    for k in p:  # non-trivial BN scales/biases and FC biases
        if k.endswith(("_scale", "_bias", "_b")):
            p[k] = (p[k] + 0.1 * r.randn(*p[k].shape)).astype(np.float32)
    return p


def test_dropout_loss_and_gradients_match_reference():
    cfg = FIVE
    p = _ref_params(cfg)
    r = np.random.RandomState(5)
    x = r.randn(3, 16, 16, 16, 2).astype(np.float32)
    y = r.randn(3, 4).astype(np.float32)
    ids = np.array([4, 1, 7])
    seed = 11

    def jloss(params):
        return jcosmo.mse_loss(
            params, jnp.asarray(x), jnp.asarray(y), _jcfg(cfg),
            global_batch=8, train=True, dropout_rng=jax.random.PRNGKey(seed),
            sample_ids=jnp.asarray(ids))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: v.requires_grad_(True) for k, v in cosmoflow.params_from_numpy(
        p, "cpu", cfg=cfg).items()}
    loss = cosmoflow.mse_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                              cfg, global_batch=8, train=True,
                              dropout_seed=seed, sample_ids=ids.tolist(),
                              mask_source=jax_masks)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    grads = torch.autograd.grad(loss, list(tp.values()))
    for name, g in zip(tp, grads):
        assert _scale_err(g, want[name]) <= 1e-5, name
    # the masks matter: without dropout the loss differs
    plain = cosmoflow.mse_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                               cfg, global_batch=8, train=False)
    assert abs(plain.item() - loss.item()) > 1e-3 * loss.item()


def test_default_masks_are_seeded_per_sample():
    a = cosmoflow.generator_masks(3, 0, [0, 5], 1000, "cpu")
    b = cosmoflow.generator_masks(3, 0, [5], 1000, "cpu")
    assert a.dtype == torch.bool and a.shape == (2, 1000)
    assert torch.equal(a[1], b[0])          # a sample's mask is its own
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, cosmoflow.generator_masks(4, 0, [0, 5], 1000,
                                                        "cpu"))
    assert 0.7 < a.float().mean() < 0.9


# ----------------------------------------------------------- session ----
STEPS = 4


def _batches(n=STEPS):
    r = np.random.RandomState(6)
    return [(r.randn(2, 32, 32, 32, 2).astype(np.float32),
             r.randn(2, 4).astype(np.float32)) for _ in range(n)]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's smoke Session: a checkpoint at step 0 and at step
    2, the loss of each of 4 steps, and the final parameters."""
    root = tmp_path_factory.mktemp("ref")
    sess = japi.compile(japi.RunConfig(model="cosmoflow-128", smoke=True,
                                       global_batch=2))
    sess.save(str(root / "step0"))
    losses = []
    for i, (x, y) in enumerate(_batches()):
        if i == 2:
            sess.save(str(root / "step2"))
        losses.append(float(sess.step(jnp.asarray(x), jnp.asarray(y))))
    params = {k: np.asarray(v) for k, v in sess.params.items()}
    sess.close()
    return {"root": root, "losses": losses, "params": params}


def _port_from(path):
    return Session.restore(str(path), device="cpu", mask_source=jax_masks)


def test_trajectory_matches_reference_session(reference_run):
    """Four steps from the reference's checkpoint: each loss within 1e-5
    relative of the reference's. Final parameters within 1e-4 of each
    leaf's scale: the gradients agree to ~1e-6 of their scale, but Adam
    divides each by its running RMS, so an element whose gradient is
    near zero can move by a larger share of the step lr (1e-3)."""
    sess = _port_from(reference_run["root"] / "step0")
    assert sess.step_count == 0 and sess.device.type == "cpu"
    losses = [float(sess.step(x, y)) for x, y in _batches()]
    for got, want in zip(losses, reference_run["losses"]):
        assert abs(got - want) <= 1e-5 * abs(want), (losses,
                                                     reference_run["losses"])
    assert sess.step_count == STEPS
    for k, want in reference_run["params"].items():
        got = sess.params[k].numpy()
        assert np.max(np.abs(got - want)) <= 1e-4 * max(
            1.0, np.max(np.abs(want))), k
    sess.close()


def test_port_resumes_reference_checkpoint(reference_run):
    sess = _port_from(reference_run["root"] / "step2")
    assert sess.step_count == 2
    assert isinstance(sess.opt_state, AdamState)
    assert int(sess.opt_state.step) == 2
    x, y = _batches()[2]
    want = reference_run["losses"][2]
    assert abs(float(sess.step(x, y)) - want) <= 1e-5 * abs(want)


def test_reference_resumes_port_checkpoint(reference_run, tmp_path):
    sess = _port_from(reference_run["root"] / "step0")
    batches = _batches()
    for x, y in batches[:2]:
        sess.step(x, y)
    path = sess.save(str(tmp_path / "port"))
    port_next = float(sess.step(*batches[2]))
    ref = japi.Session.restore(path)
    assert ref.step_count == 2
    x, y = batches[2]
    got = float(ref.step(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - port_next) <= 1e-5 * abs(port_next)
    assert abs(got - reference_run["losses"][2]) <= 1e-5 * abs(got)
    ref.close()


def test_nonfinite_fault_skips_the_step_bitwise(tmp_path):
    cfg = RunConfig(model="cosmoflow-128", smoke=True, global_batch=2,
                    checkpoint_dir=str(tmp_path), save_every=1, keep_last=2,
                    metrics_jsonl=str(tmp_path / "m.jsonl"))
    sess = compile(cfg, device="cpu")
    (x, y), (x2, y2) = _batches(2)
    sess.step(x, y)
    before = {k: v.clone() for k, v in sess.params.items()}
    m_before = {k: v.clone() for k, v in sess.opt_state.m.items()}
    with faults.active(faults.FaultSpec("grads.nonfinite", at_steps=(1,))):
        loss = sess.step(x2, y2)
    assert not torch.isfinite(loss)
    assert all(torch.equal(sess.params[k], before[k]) for k in before)
    assert all(torch.equal(sess.opt_state.m[k], m_before[k])
               for k in m_before)
    assert int(sess.opt_state.step) == 1
    tele = sess.telemetry()
    assert tele["skipped_steps"] == 1 and tele["steps"] == 2
    assert torch.isfinite(sess.step(x2, y2))
    assert int(sess.opt_state.step) == 2
    # save_every=1, keep_last=2: the two newest step checkpoints remain
    steps = [s for s, _ in __import__(
        "repro_torch.train.checkpoint", fromlist=["x"]).list_steps(
            str(tmp_path))]
    assert steps == [2, 3]
    sess.close()
    assert len(open(tmp_path / "m.jsonl").read().splitlines()) == 3
    resumed = Session.restore(str(tmp_path), device="cpu")
    assert resumed.step_count == 3
    assert all(torch.equal(resumed.params[k], sess.params[k])
               for k in before)


def test_phase_probes_nest_as_the_step():
    """The ``fwd`` probe's loss is the step's; ``bwd`` adds the sum of
    every gradient; ``grad_comm`` the reduced gradients (on one device,
    the gradients); ``step`` is the train step."""
    from repro_torch.train import train_step

    sess = compile(RunConfig(model="cosmoflow-128", smoke=True,
                             global_batch=2), device="cpu")
    x, y = (torch.from_numpy(a) for a in _batches(1)[0])
    probes = train_step.make_convnet_phase_probes(
        sess.cfg, sess.mesh, sess.optimizer, global_batch=2,
        plan=sess.plan)
    assert set(probes) == {"fwd", "bwd", "grad_comm", "step"}
    fwd = probes["fwd"](sess.params, sess.opt_state, x, y, 0)
    loss, gsum = probes["bwd"](sess.params, sess.opt_state, x, y, 0)
    comm_loss, reduced = probes["grad_comm"](sess.params, sess.opt_state,
                                             x, y, 0)
    _, _, step_loss = probes["step"](sess.params, sess.opt_state, x, y, 0)
    assert torch.equal(fwd, loss) and torch.equal(loss, step_loss)
    assert torch.equal(comm_loss, loss) and set(reduced) == set(sess.params)
    p = {k: v.detach().requires_grad_(True) for k, v in sess.params.items()}
    grads = torch.autograd.grad(cosmoflow.mse_loss(
        p, x, y, sess.cfg, plan=sess.plan, global_batch=2,
        dropout_seed=0), list(p.values()))
    assert torch.allclose(gsum, sum(g.sum() for g in grads), rtol=1e-6)


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_mixed_precision_sessions_train(precision):
    sess = compile(RunConfig(model="cosmoflow-128", smoke=True,
                             global_batch=2, precision=precision),
                   device="cpu")
    losses = [float(sess.step(x, y)) for x, y in _batches(2)]
    assert all(np.isfinite(losses))
    assert all(v.dtype == torch.float32 for v in sess.params.values())
    tele = sess.telemetry()
    # fp16: every overflowed step was skipped and halved the scale
    want = 2.0 ** 15 / 2 ** tele["skipped_steps"] if precision == "fp16" \
        else 1.0
    assert tele["loss_scale"] == want
    assert precision == "fp16" or tele["skipped_steps"] == 0
    loss, pred = sess.evaluate(*_batches(1)[0])
    assert pred.shape == (2, 4) and torch.isfinite(loss)


def test_train_config_rejects_what_this_slice_does_not_run():
    # data and spatial degrees train: one shard per device given
    for kw in (dict(spatial=2), dict(data=2)):
        with compile(RunConfig(model="cosmoflow-128", smoke=True, **kw),
                     devices=["cpu"] * 2) as sess:
            assert sess.mesh.shape == {"data": kw.get("data", 1),
                                       "model": kw.get("spatial", 1)}
    for kw, field in ((dict(pipeline=2), "pipeline"),
                      (dict(plan="bogus"), "plan"),
                      (dict(memory_budget_gib=-4.0), "memory_budget_gib")):
        with pytest.raises(RunConfigError) as e:
            compile(RunConfig(model="cosmoflow-128", smoke=True, **kw),
                    device="cpu")
        assert e.value.field == field, kw
    # the planner and batch-sharded serving run since the plans slice
    for kw in (dict(plan="auto"), dict(memory_budget_gib=4.0),
               dict(data=2, mode="infer")):
        with compile(RunConfig(model="cosmoflow-128", smoke=True, **kw),
                     devices=["cpu"] * kw.get("data", 1)) as sess:
            assert sess.mesh.shape["data"] == kw.get("data", 1)
    # ZeRO-1 compiles and steps at 1 x 1 and 2 x 2: one state a shard
    for D, S in ((1, 1), (2, 2)):
        with compile(RunConfig(model="cosmoflow-128", smoke=True,
                               global_batch=2 * D, data=D, spatial=S,
                               grad_comm="reduce_scatter"),
                     devices=["cpu"] * (D * S)) as sess:
            x, y = _batches(1)[0]
            loss = sess.step(np.concatenate([x] * D), np.concatenate([y] * D))
            assert torch.isfinite(loss) and sess.grad_comm == "reduce_scatter"
            assert isinstance(sess.opt_state, list)
            assert len(sess.opt_state) == D * S
    for mode in ("monolithic", "overlap", "reduce_scatter"):
        RunConfig(model="cosmoflow-128", grad_comm=mode).validate()
