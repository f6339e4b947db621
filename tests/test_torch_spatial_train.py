"""Hybrid data x spatial training through the port against the reference,
on the CPU (every shard a thread on ``"cpu"``).

* the collectives' adjoints (``ppermute``, ``psum``, tiled
  ``all_gather``) against ``jax.vjp`` through the reference's
  ``shard_map``; the halo pack/unpack adjoints against ``jax.vjp`` of
  the reference's ``halo_pack.ref``;
* the overlapped conv's gradients against the blocking conv's and the
  reference's (``jax.vjp`` of its blocking conv under ``shard_map``) at
  S = 2 and 4, within 1e-5 of the gradient's max-abs (the reference's
  fwd+grad contract, ``tests/test_overlap_halo.py``, and the port's for
  the conv's gradients, ``tests/test_torch_train.py``);
* the train step: the ``grad_comm`` probe's loss and reduced gradients
  at 1 x 2, 1 x 4 and 2 x 2 on the SMOKE config, and at 1 x 2 on a
  5-block config under a plan that splits every block (the unpack
  kernel's adjoint), against the reference's probe on the same mesh
  with the reference's dropout masks (``jax_masks``), within 1e-5 of
  each leaf's max-abs — or, where the reference's own step lies farther
  than that from the fp64 step, nearer it than the reference and
  within 1e-5 of it; the same for the 3D U-Net (``unet3d-smoke``, voxel
  labels split like the input) at 1 x 2, 1 x 4 and 2 x 2; ``overlap``
  against ``monolithic`` after two steps (atol 1e-5, rtol 1e-4,
  ``tests/test_grad_comm.py``); a 2 x 2 step against a 1 x 1 step
  (``tests/test_multidevice.py``'s tolerances); launches per step
  against ``kernel_launches``;
* a 2 x 2 checkpoint resumed by the reference's ``Session`` and by a
  one-device port ``Session``; bf16, fp16 and the guard at 2 x 2; a
  step that completes under a timeout with its shards in threads.

The reference runs once, in a subprocess with 4 forced host devices;
inputs come from numpy with a seed, and the reference's parameters are
carried across with ``params_from_numpy``.
"""
import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.halo_pack import ref as jpack_ref
from repro_torch.api import RunConfig, Session, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import faults, grad_comm, spmd
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning, conv3d
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cosmoflow, unet3d
from repro_torch.train import train_step

FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d",
                     arch="cosmoflow", input_width=16, in_channels=2,
                     out_dim=4, conv_channels=(4, 8, 8, 16, 16),
                     fc_dims=(32, 16))
CFGS = {"smoke": cosmo_cfg.SMOKE, "five": FIVE}
# (config, data, spatial, every block split)
TRAIN_RUNS = [("smoke", 1, 2, False), ("smoke", 1, 4, False),
              ("smoke", 2, 2, False), ("five", 1, 2, True)]
UNET_RUNS = [(1, 2), (1, 4), (2, 2)]  # (data, spatial) of the U-Net probe
# (model, spatial, plan) of the planned probes: one transition each (the
# U-Net's uniform plan is one stage, its legacy plan: UNET_RUNS probes it)
PLANS = {"b1_batch": dict(boundary=1, kind="batch"),
         "b2_replicated": dict(boundary=2, kind="replicated"),
         "uniform_batch": dict(boundary=None, kind="batch")}
PLAN_RUNS = [(m, S, p) for m in ("smoke", "unet") for S in (2, 4)
             for p in sorted(PLANS)
             if not (m == "unet" and p == "uniform_batch")]
COLLECTIVES = ("ppermute", "psum", "all_gather")
SEED = 3
GB = 4


def deep_plan(plan_mod, n_blocks, S):
    """Depth partitioned through every conv block, then the FC head
    replicated."""
    return plan_mod.ParallelPlan(
        (plan_mod.Stage(0, n_blocks, ("model", None, None), ("data",)),
         plan_mod.Stage(n_blocks, n_blocks + 1, (None, None, None),
                        ("data",))),
        (("data", 1), ("model", S)), n_blocks + 1, name="deep")


def jax_masks(seed, layer, sample_ids, width, device):
    """The reference's dropout masks, as a port mask source."""
    layer_rng = jax.random.fold_in(jax.random.PRNGKey(seed), layer)
    rows = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(layer_rng, int(sid)), 0.8, (width,)))
        for sid in sample_ids]
    return torch.from_numpy(np.stack(rows)).to(device)


REFERENCE = r'''
import numpy as np
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro import api
from repro.core import compat
from repro.core import plan as plan_lib
from repro.core.spatial_conv import SpatialPartitioning, conv3d
from repro.configs import cosmoflow as cosmo_cfg
from repro.configs.base import ConvNetConfig
from repro.models import cosmoflow
from repro.optim.adam import Adam, constant
from repro.train.train_step import (make_convnet_eval_step,
                                    make_convnet_phase_probes)

FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d", arch="cosmoflow",
                     input_width=16, in_channels=2, out_dim=4,
                     conv_channels=(4, 8, 8, 16, 16), fc_dims=(32, 16))
CFGS = {"smoke": cosmo_cfg.SMOKE, "five": FIVE}
out = {}

# the collectives' adjoints, 4 shards of (2, 3) each
mesh = compat.make_mesh((4,), ("model",))
x = np.random.RandomState(0).randn(8, 3).astype(np.float32)
ops = {"ppermute": lambda t: lax.ppermute(t, "model",
                                          [(i, i + 1) for i in range(3)]),
       "psum": lambda t: lax.psum(t, "model"),
       "all_gather": lambda t: lax.all_gather(t, "model", axis=1,
                                              tiled=True)}
for name, op in ops.items():
    f = compat.shard_map(op, mesh=mesh, in_specs=P("model"),
                         out_specs=P("model"))
    y, vjp = jax.vjp(f, jnp.asarray(x))
    ct = np.random.RandomState(1).randn(*y.shape).astype(np.float32)
    out["coll_x"] = x
    out["coll_y_" + name] = np.asarray(y)
    out["coll_ct_" + name] = ct
    out["coll_g_" + name] = np.asarray(vjp(jnp.asarray(ct))[0])

# the blocking conv's gradients, depth split over S
part = SpatialPartitioning(("model", None, None))
for S in (2, 4):
    mesh = compat.make_mesh((S,), ("model",))
    for s in (1, 2):
        r = np.random.RandomState(10 * S + s)
        x = r.randn(2, 16, 6, 6, 3).astype(np.float32)
        w = (0.2 * r.randn(3, 3, 3, 3, 4)).astype(np.float32)
        f = compat.shard_map(
            lambda x, w, _s=s: conv3d(x, w, part, stride=_s, overlap=False),
            mesh=mesh, in_specs=(P(None, "model"), P()),
            out_specs=P(None, "model"))
        y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        ct = r.randn(*y.shape).astype(np.float32)
        gx, gw = vjp(jnp.asarray(ct))
        tag = f"{S}_{s}"
        out.update({"conv_x_" + tag: x, "conv_w_" + tag: w,
                    "conv_ct_" + tag: ct, "conv_gx_" + tag: np.asarray(gx),
                    "conv_gw_" + tag: np.asarray(gw)})

# the train step's grad_comm probe
for name, cfg in CFGS.items():
    p = {k: np.asarray(v) for k, v in cosmoflow.init_params(
        jax.random.PRNGKey(0), cfg).items()}
    r = np.random.RandomState(5)
    for k in sorted(p):  # non-trivial BN scales/biases and FC biases
        if k.endswith(("_scale", "_bias", "_b")):
            p[k] = (p[k] + 0.1 * r.randn(*p[k].shape)).astype(np.float32)
    w = cfg.input_width
    out["x_" + name] = r.randn(GB, w, w, w, cfg.in_channels).astype(
        np.float32)
    out["y_" + name] = r.randn(GB, cfg.out_dim).astype(np.float32)
    for k, v in p.items():
        out[f"param_{name}_{k}"] = v
for name, D, S, deep in TRAIN_RUNS:
    cfg = CFGS[name]
    params = {k[len(f"param_{name}_"):]: jnp.asarray(v)
              for k, v in out.items() if k.startswith(f"param_{name}_")}
    mesh = compat.make_mesh((D, S), ("data", "model"))
    opt = Adam(lr=constant(1e-3))
    probe = make_convnet_phase_probes(
        cfg, mesh, opt, global_batch=GB,
        plan=deep_plan(plan_lib, len(cfg.conv_channels), S) if deep
        else None)["grad_comm"]
    loss, grads = probe(params, opt.init(params), out["x_" + name],
                        out["y_" + name], jnp.asarray(SEED, jnp.int32))
    tag = f"{name}_{D}_{S}"
    out["loss_" + tag] = np.asarray(loss)
    for k, v in grads.items():
        out[f"grad_{tag}_{k}"] = np.asarray(v)

# the U-Net's grad_comm probe (voxel labels split like x)
from repro.configs import unet3d as unet_cfg
from repro.models import unet3d
up = {k: np.asarray(v) for k, v in jax.jit(lambda k: unet3d.init_params(
    k, unet_cfg.SMOKE))(jax.random.PRNGKey(1)).items()}
r = np.random.RandomState(6)
for k in sorted(up):  # non-trivial BN scales and biases
    if up[k].ndim == 1:
        up[k] = (up[k] + 0.1 * r.randn(*up[k].shape)).astype(np.float32)
w = unet_cfg.SMOKE.input_width
out["x_unet"] = r.randn(GB, w, w, w, 1).astype(np.float32)
out["y_unet"] = r.randint(0, 3, (GB, w, w, w)).astype(np.int32)
for k, v in up.items():
    out["uparam_" + k] = v
for D, S in UNET_RUNS:
    mesh = compat.make_mesh((D, S), ("data", "model"))
    opt = Adam(lr=constant(1e-3))
    probe = make_convnet_phase_probes(unet_cfg.SMOKE, mesh, opt,
                                      global_batch=GB)["grad_comm"]
    params = {k: jnp.asarray(v) for k, v in up.items()}
    loss, grads = probe(params, opt.init(params), out["x_unet"],
                        out["y_unet"], jnp.asarray(SEED, jnp.int32))
    out[f"uloss_{D}_{S}"] = np.asarray(loss)
    for k, v in grads.items():
        out[f"ugrad_{D}_{S}_{k}"] = np.asarray(v)

# planned probes (1 x S): the grad_comm probe and the eval step's
# predictions under each pinned one-transition plan
for m, S, pname in PLAN_RUNS:
    if m == "unet":
        cfg, params = unet_cfg.SMOKE, {k: jnp.asarray(v)
                                       for k, v in up.items()}
        x, y = out["x_unet"], out["y_unet"]
    else:
        cfg = CFGS[m]
        params = {k[len(f"param_{m}_"):]: jnp.asarray(v)
                  for k, v in out.items() if k.startswith(f"param_{m}_")}
        x, y = out["x_" + m], out["y_" + m]
    plan = plan_lib.convnet_plan(cfg, spatial_degrees=(S, 1, 1),
                                 **PLANS[pname])
    mesh = compat.make_mesh((1, S), ("data", "model"))
    opt = Adam(lr=constant(1e-3))
    probe = make_convnet_phase_probes(cfg, mesh, opt, global_batch=GB,
                                      plan=plan)["grad_comm"]
    loss, grads = probe(params, opt.init(params), x, y,
                        jnp.asarray(SEED, jnp.int32))
    tag = f"{m}_{S}_{pname}"
    out["ploss_" + tag] = np.asarray(loss)
    for k, v in grads.items():
        out[f"pgrad_{tag}_{k}"] = np.asarray(v)
    ev = make_convnet_eval_step(cfg, mesh, global_batch=GB, plan=plan)
    out["ppred_" + tag] = np.asarray(ev(params, x, y)[1])

# the port's 2 x 2 checkpoint, resumed for one step
sess = api.Session.restore(CKPT)
xs, ys = np.load(BATCH)["x"], np.load(BATCH)["y"]
out["resumed_step"] = np.asarray(sess.step_count)
out["resumed_loss"] = np.asarray(sess.step(jnp.asarray(xs), jnp.asarray(ys)))
sess.close()
np.savez(OUT, **out)
'''


def _batch(seed=7):
    r = np.random.RandomState(seed)
    return (r.randn(GB, 32, 32, 32, 2).astype(np.float32),
            r.randn(GB, 4).astype(np.float32))


def _smoke_session(D, S, **kw):
    return compile(RunConfig(model="cosmoflow-128", smoke=True,
                             global_batch=GB, data=D, spatial=S, **kw),
                   devices=["cpu"] * (D * S), mask_source=jax_masks)


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    """The reference's outputs; before it runs, a port 2 x 2 session takes
    one step and writes the checkpoint the reference resumes."""
    root = tmp_path_factory.mktemp("spatial_train")
    ckpt, batch = str(root / "port2x2"), str(root / "batch.npz")
    x, y = _batch()
    with _smoke_session(2, 2) as sess:
        sess.step(x, y)
        sess.save(ckpt)
        x2, y2 = _batch(8)
        np.savez(batch, x=x2, y=y2)
        port_next = float(sess.step(x2, y2))
    path = root / "reference.npz"
    script = (f"OUT = {str(path)!r}\nCKPT = {ckpt!r}\nBATCH = {batch!r}\n"
              f"TRAIN_RUNS = {TRAIN_RUNS!r}\nUNET_RUNS = {UNET_RUNS!r}\n"
              f"PLANS = {PLANS!r}\nPLAN_RUNS = {PLAN_RUNS!r}\n"
              f"SEED = {SEED}\nGB = {GB}\n"
              + inspect.getsource(deep_plan) + REFERENCE)
    multidevice(script, devices=4)
    return dict(np.load(path), ckpt=ckpt, batch=(x2, y2),
                port_next=port_next)


def _scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1e-12, np.max(np.abs(want)))


def _backward(outs, ins, cts):
    """One backward over every shard's output, from this thread."""
    total = sum((o * c).sum() for o, c in zip(outs, cts))
    return [torch.zeros_like(t) if g is None else g for t, g in zip(
        ins, torch.autograd.grad(total, ins, allow_unused=True))]


# ------------------------------------------------------- collectives ----
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_adjoints_match_shard_map_vjp(reference, name):
    S = 4
    xs = [torch.from_numpy(c).requires_grad_(True)
          for c in np.split(reference["coll_x"], S)]

    def fn(t):
        g = spmd.axis("model")
        if name == "ppermute":
            return g.ppermute(t, [(i, i + 1) for i in range(S - 1)])
        if name == "psum":
            return g.psum(t)
        return g.all_gather(t, 1)

    with torch.enable_grad():
        ys = spmd.run(Mesh([("model", S)], ["cpu"] * S), fn, xs)
        cts = [torch.from_numpy(c) for c in np.split(
            reference["coll_ct_" + name], S)]
        grads = _backward(ys, xs, cts)
    np.testing.assert_array_equal(
        torch.cat([y.detach() for y in ys]).numpy(),
        reference["coll_y_" + name])
    np.testing.assert_allclose(torch.cat(grads).numpy(),
                               reference["coll_g_" + name], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("lo,hi", [(1, 1), (0, 1), (2, 1)])
def test_pack_and_unpack_adjoints_match_reference_vjp(lo, hi):
    r = np.random.RandomState(lo * 10 + hi)
    x = r.randn(2, 4, 3, 2, 3).astype(np.float32)
    (prv, nxt), vjp = jax.vjp(lambda t: jpack_ref.pack(t, 1, lo, hi),
                              jnp.asarray(x))
    ct_prv = r.randn(*prv.shape).astype(np.float32)
    ct_nxt = (r.randn(*nxt.shape).astype(np.float32) if lo else None)
    (want,) = vjp((jnp.asarray(ct_prv),
                   None if ct_nxt is None else jnp.asarray(ct_nxt)))
    tx = torch.from_numpy(x).requires_grad_(True)
    faces = pack_ops.pack(tx, lo, hi)
    total = (faces.to_prev * torch.from_numpy(ct_prv)).sum()
    if lo:
        total = total + (faces.to_next * torch.from_numpy(ct_nxt)).sum()
    (got,) = torch.autograd.grad(total, tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    bufs = [r.randn(2, m, 3, 2, 3).astype(np.float32) if m else None
            for m in (lo, hi)]
    given = [x] + [b for b in bufs if b is not None]

    def junpack(a, *rest):
        it = iter(rest)
        return jpack_ref.unpack(a, *(next(it) if m else None
                                     for m in (lo, hi)), 1)

    y, vjp = jax.vjp(junpack, *map(jnp.asarray, given))
    ct = r.randn(*y.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in given]
    it = iter(ins[1:])
    out = pack_ops.unpack(ins[0], *(next(it) if m else None
                                    for m in (lo, hi)))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------- overlapped conv ----
@pytest.mark.parametrize("S,s", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_overlapped_conv_gradients_match_blocking_and_reference(
        reference, S, s):
    tag = f"{S}_{s}"
    part = SpatialPartitioning(("model", None, None))
    got = {}
    for ov in (True, False):
        xs = [torch.from_numpy(c).requires_grad_(True) for c in np.split(
            reference["conv_x_" + tag], S, axis=1)]
        ws = [torch.from_numpy(reference["conv_w_" + tag]).requires_grad_(
            True) for _ in range(S)]
        cts = [torch.from_numpy(c) for c in np.split(
            reference["conv_ct_" + tag], S, axis=1)]
        with torch.enable_grad():
            ys = spmd.run(Mesh([("model", S)], ["cpu"] * S),
                          lambda x, w: conv3d(x, w, part, stride=s,
                                              overlap=ov), xs, ws)
            grads = _backward(ys, xs + ws, cts)
        got[ov] = (torch.cat(grads[:S], 1).numpy(),
                   sum(g for g in grads[S:]).numpy())
    for ov in (True, False):
        assert _scale_err(got[ov][0], reference["conv_gx_" + tag]) <= 1e-5
        assert _scale_err(got[ov][1], reference["conv_gw_" + tag]) <= 1e-5
    for i in (0, 1):
        assert _scale_err(got[True][i], got[False][i]) <= 1e-5


# ----------------------------------------------------------- the step ----
def _probe_session(name, D, S, deep):
    cfg = CFGS[name]
    plan = deep_plan(plan_lib, len(cfg.conv_channels), S) if deep \
        else "fixed"
    return compile(RunConfig(model=cfg, global_batch=GB, data=D, spatial=S,
                             plan=plan), devices=["cpu"] * (D * S),
                   mask_source=jax_masks)


def _ref_params(reference, name):
    pre = f"param_{name}_"
    return {k[len(pre):]: v for k, v in reference.items()
            if k.startswith(pre)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its shards are threads already, and beside other test workers a
    thread pool a shard only contends (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _exact(reference, key, fn):
    """``fn()``, the fp64 gradients the rule below falls back to, once a
    reference run (they do not depend on the mesh or the plan)."""
    cache = reference.setdefault("_exact", {})
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _fp64_grads(reference, name):
    """The ``grad_comm`` probe's gradients on one device in fp64 (the
    convs by ``F.conv3d``, batch norm and the loss in fp64, the same
    masks): the exact gradient, to ~1e-15."""
    import torch.nn.functional as F
    from unittest import mock

    def conv64(x, w, stride=1, pads=((0, 0),) * 3):
        (pd, qd), (ph, qh), (pw, qw) = pads
        xc = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)).permute(0, 4, 1, 2, 3)
        return F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=stride
                        ).permute(0, 2, 3, 4, 1)

    def bn64(x, scale, bias, reduce_axes=(), eps=1e-5,
             activation_slope=None):
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        return F.leaky_relu((x - mean) * torch.rsqrt(var + eps) * scale
                            + bias, activation_slope)

    def mse64(pred, y, denominator):
        return torch.sum(torch.mean(torch.square(pred - y), dim=-1)
                         ) / denominator

    cfg = CFGS[name]
    params = {k: torch.from_numpy(v).double()
              for k, v in _ref_params(reference, name).items()}
    with mock.patch.object(conv_ops, "conv3d", conv64), \
            mock.patch.object(cosmoflow.dist_norm, "distributed_batchnorm",
                              bn64), \
            mock.patch.object(cosmoflow, "mse", mse64), \
            _probe_session(name, 1, 1, False) as sess:
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan, mask_source=jax_masks)["grad_comm"]
        return probe(params, sess.opt_state,
                     torch.from_numpy(reference["x_" + name]).double(),
                     torch.from_numpy(reference["y_" + name]).double(),
                     SEED)[1]


@pytest.mark.parametrize("name,D,S,deep", TRAIN_RUNS)
def test_grad_comm_probe_matches_reference(reference, name, D, S, deep):
    cfg = CFGS[name]
    with _probe_session(name, D, S, deep) as sess:
        assert sess.mesh.shape == {"data": D, "model": S}
        params = cosmoflow.params_from_numpy(_ref_params(reference, name),
                                             "cpu", cfg=cfg)
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan, mask_source=jax_masks)["grad_comm"]
        loss, grads = probe(params, sess.opt_state,
                            torch.from_numpy(reference["x_" + name]),
                            torch.from_numpy(reference["y_" + name]), SEED)
    tag = f"{name}_{D}_{S}"
    want = float(reference["loss_" + tag])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert set(grads) == set(params)
    exact = None
    for k, g in grads.items():
        err = _scale_err(g, reference[f"grad_{tag}_{k}"])
        if err <= 1e-5:
            continue
        # the reference's own step strays from the exact gradient here
        # (its 1 x 4 SMOKE step, up to 1.8e-5 of a leaf): the port must
        # then lie nearer the fp64 step than the reference does, and
        # within 1e-5 of it
        if exact is None:
            exact = _exact(reference, name,
                           lambda: _fp64_grads(reference, name))
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(reference[f"grad_{tag}_{k}"], exact[k])
        assert port_err <= min(1e-5, ref_err), (k, err, port_err, ref_err)


def _unet_fp64_grads(reference):
    """The U-Net's ``grad_comm`` probe on one device in fp64 (convs by
    ``F.conv3d``, batch norm and the loss in fp64): the exact gradient."""
    import torch.nn.functional as F
    from unittest import mock

    def conv64(x, w, stride=1, pads=((0, 0),) * 3):
        (pd, qd), (ph, qh), (pw, qw) = pads
        xc = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)).permute(0, 4, 1, 2, 3)
        return F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=stride
                        ).permute(0, 2, 3, 4, 1)

    def bn64(x, scale, bias, reduce_axes=(), eps=1e-5,
             activation_slope=None):
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        return F.leaky_relu((x - mean) * torch.rsqrt(var + eps) * scale
                            + bias, activation_slope)

    def nll64(logits, labels, denominator):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels.long().unsqueeze(-1)).sum(
        ) / denominator

    params = {k: torch.from_numpy(v).double()
              for k, v in _unet_params(reference).items()}
    with mock.patch.object(conv_ops, "conv3d", conv64), \
            mock.patch.object(unet3d.dist_norm, "distributed_batchnorm",
                              bn64), \
            mock.patch.object(unet3d, "voxel_nll", nll64), \
            _unet_session(1, 1) as sess:
        probe = train_step.make_convnet_phase_probes(
            sess.cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan)["grad_comm"]
        return probe(params, sess.opt_state,
                     torch.from_numpy(reference["x_unet"]).double(),
                     torch.from_numpy(reference["y_unet"]), SEED)[1]


def _unet_params(reference):
    return {k[len("uparam_"):]: v for k, v in reference.items()
            if k.startswith("uparam_")}


def _unet_session(D, S):
    return compile(RunConfig(model="unet3d-256", smoke=True,
                             global_batch=GB, data=D, spatial=S),
                   devices=["cpu"] * (D * S))


@pytest.mark.parametrize("D,S", UNET_RUNS)
def test_unet_grad_comm_probe_matches_reference(reference, D, S):
    """The U-Net's reduced gradients over the mesh, labels split over the
    batch and depth like x, against the reference's, with the rule of
    ``test_grad_comm_probe_matches_reference``."""
    with _unet_session(D, S) as sess:
        assert sess.mesh.shape == {"data": D, "model": S}
        params = unet3d.params_from_numpy(_unet_params(reference), "cpu",
                                          cfg=unet_cfg.SMOKE)
        probe = train_step.make_convnet_phase_probes(
            sess.cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan)["grad_comm"]
        loss, grads = probe(params, sess.opt_state,
                            torch.from_numpy(reference["x_unet"]),
                            torch.from_numpy(reference["y_unet"]), SEED)
    want = float(reference[f"uloss_{D}_{S}"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert set(grads) == set(params)
    exact = None
    for k, g in grads.items():
        ref_g = reference[f"ugrad_{D}_{S}_{k}"]
        if _scale_err(g, ref_g) <= 1e-5:
            continue
        if exact is None:
            exact = _exact(reference, "unet",
                           lambda: _unet_fp64_grads(reference))
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(ref_g, exact[k])
        assert port_err <= min(1e-5, ref_err), (k, port_err, ref_err)


@pytest.mark.parametrize("model,S,plan_name", PLAN_RUNS)
def test_planned_probe_matches_reference(reference, model, S, plan_name):
    """A pinned one-transition plan (a batch move after block or level
    1, a replicated gather after 2, a batch move at the FC head or, for
    the U-Net, one stage) at 1 x S: the ``grad_comm`` probe's loss and
    reduced gradients and the eval step's predictions against the
    reference's same plan on the same inputs and (CosmoFlow) dropout
    masks, within the reference's planned-model tolerance (atol 1e-5,
    rtol 1e-4, ``tests/test_plan.py``)."""
    unet = model == "unet"
    cfg = unet_cfg.SMOKE if unet else CFGS[model]
    plan = plan_lib.convnet_plan(cfg, spatial_degrees=(S, 1, 1),
                                 **PLANS[plan_name])
    params = (unet3d.params_from_numpy(_unet_params(reference), "cpu",
                                       cfg=cfg) if unet else
              cosmoflow.params_from_numpy(_ref_params(reference, model),
                                          "cpu", cfg=cfg))
    x = torch.from_numpy(reference["x_" + model])
    y = torch.from_numpy(reference["y_" + model])
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=S,
                           plan=plan), devices=["cpu"] * S,
                 mask_source=jax_masks) as sess:
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan, mask_source=jax_masks)["grad_comm"]
        loss, grads = probe(params, sess.opt_state, x, y, SEED)
        sess.params = params
        _, preds = sess.evaluate(x, y)
    tag = f"{model}_{S}_{plan_name}"
    assert abs(float(loss) - float(reference["ploss_" + tag])) <= 1e-5
    np.testing.assert_allclose(preds.numpy(), reference["ppred_" + tag],
                               atol=1e-5, rtol=1e-4)
    assert set(grads) == set(params)
    exact = None
    for k, g in grads.items():
        ref_g = reference[f"pgrad_{tag}_{k}"]
        if np.allclose(g.numpy(), ref_g, atol=1e-5, rtol=1e-4):
            continue
        # the reference's own step strays from the exact gradient here
        # (its 1 x 4 U-Net step, as at its fixed plan): the port must lie
        # nearer the fp64 step (the same for every plan) than the
        # reference does, and within 1e-5 of its scale
        if exact is None:
            exact = _exact(reference, model, lambda: (
                _unet_fp64_grads(reference) if unet
                else _fp64_grads(reference, model)))
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(ref_g, exact[k])
        assert port_err <= min(1e-5, ref_err), (k, port_err, ref_err)


def test_overlap_matches_monolithic_after_two_steps():
    got = {}
    for mode in ("overlap", "monolithic"):
        with _smoke_session(2, 2, grad_comm=mode) as sess:
            for i in range(2):
                sess.step(*_batch(20 + i))
            got[mode] = sess.params
    for k, want in got["monolithic"].items():
        np.testing.assert_allclose(got["overlap"][k].numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_a_2x2_step_equals_a_one_device_step():
    x, y = _batch(9)
    out = {}
    for D, S in ((1, 1), (2, 2)):
        with _smoke_session(D, S) as sess:
            out[(D, S)] = (float(sess.step(x, y)), sess.params)
    (l1, p1), (l4, p4) = out[(1, 1)], out[(2, 2)]
    assert abs(l1 - l4) < 2e-5, (l1, l4)
    for k in p1:
        np.testing.assert_allclose(p4[k].numpy(), p1[k].numpy(), rtol=3e-3,
                                   atol=2e-3, err_msg=k)


@pytest.mark.parametrize("name,D,S,deep", TRAIN_RUNS)
def test_kernel_launches_of_a_step_follow_the_plan(monkeypatch, name, D, S,
                                                   deep):
    """Each wrapper call of one training step, counted on the CPU, equals
    what ``kernel_launches(train=True)`` derives from the plan — the
    counts the card's launch counters are held to."""
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
    cfg = CFGS[name]
    w = cfg.input_width
    with _probe_session(name, D, S, deep) as sess:
        sess.step(np.zeros((GB, w, w, w, cfg.in_channels), np.float32),
                  np.zeros((GB, cfg.out_dim), np.float32))
        want = cosmoflow.kernel_launches(cfg, sess.plan, train=True)
    assert calls == want
    assert want["pack"] > 0 and (want["unpack"] > 0) == deep


def test_bucket_plan_matches_reference():
    from repro.core import grad_comm as jgrad_comm

    shapes = cosmoflow.param_shapes(cosmo_cfg.config_for_width(128))
    tree = {k: torch.zeros(s) for k, s in shapes.items()}
    plan = grad_comm.make_plan(tree)
    jplan = jgrad_comm.make_plan({k: jnp.zeros(s) for k, s in shapes.items()})
    names = sorted(shapes)
    assert [(tuple(names[i] for i in b.indices), b.flat)
            for b in jplan.buckets] == [(b.names, b.flat)
                                        for b in plan.buckets]


# --------------------------------------------- checkpoints, precision ----
def test_reference_resumes_a_2x2_checkpoint(reference):
    x, y = reference["batch"]
    assert int(reference["resumed_step"]) == 1
    want = reference["port_next"]
    assert abs(float(reference["resumed_loss"]) - want) <= 1e-5 * abs(want)
    with Session.restore(reference["ckpt"], device="cpu", data=1, spatial=1,
                         mask_source=jax_masks) as one:
        assert one.mesh.shape == {"data": 1, "model": 1}
        assert one.step_count == 1
        got = float(one.step(x, y))
    assert abs(got - want) <= 1e-5 * abs(want)
    with Session.restore(reference["ckpt"], devices=["cpu"] * 4,
                         mask_source=jax_masks) as four:
        assert four.mesh.shape == {"data": 2, "model": 2}
        assert four.plan.name == "cosmoflow.legacy"
        assert float(four.step(x, y)) == want


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_mixed_precision_trains_at_2x2(precision):
    with _smoke_session(2, 2, precision=precision) as sess:
        losses = [float(sess.step(*_batch(30 + i))) for i in range(2)]
        tele = sess.telemetry()
        loss, pred = sess.evaluate(*_batch(40))
    assert all(np.isfinite(losses))
    want = (2.0 ** 15 / 2 ** tele["skipped_steps"] if precision == "fp16"
            else 1.0)
    assert tele["loss_scale"] == want
    assert pred.shape == (GB, 4) and torch.isfinite(loss)


def test_guard_skips_a_nonfinite_step_on_every_shard():
    with _smoke_session(2, 2) as sess:
        sess.step(*_batch(50))
        before = {k: v.clone() for k, v in sess.params.items()}
        with faults.active(faults.FaultSpec("grads.nonfinite",
                                            at_steps=(1,))):
            assert not torch.isfinite(sess.step(*_batch(51)))
        assert all(torch.equal(sess.params[k], before[k]) for k in before)
        assert sess.telemetry()["skipped_steps"] == 1
        assert torch.isfinite(sess.step(*_batch(51)))


def test_evaluate_at_2x2_matches_one_device():
    x, y = _batch(60)
    out = []
    for D, S in ((1, 1), (2, 2)):
        with _smoke_session(D, S) as sess:
            out.append(sess.evaluate(x, y))
    (l1, p1), (l4, p4) = out
    np.testing.assert_allclose(p4.numpy(), p1.numpy(), rtol=0, atol=1e-5)
    assert abs(float(l4) - float(l1)) <= 1e-5 * float(l1)


def test_a_sharded_step_completes_under_a_timeout():
    """The step's backward runs from one thread: no shard thread waits in
    a collective's backward, so the step ends, and no shard thread is
    left behind."""
    done = []
    sess = _smoke_session(1, 2)

    def run():
        done.append(float(sess.step(*_batch(70))))

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and done and np.isfinite(done[0])
    sess.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]


def test_mesh_groups_over_one_axis_or_several():
    mesh = Mesh([("data", 2), ("model", 3)], ["cpu"] * 6)
    assert mesh.group(4, "model") == (3, 4, 5)
    assert mesh.group(4, "data") == (1, 4)
    assert mesh.group(4, ("data", "model")) == tuple(range(6))
    assert mesh.groups("data") == ((0, 3), (1, 4), (2, 5)) * 2


def test_training_on_several_cards_raises():
    plan = plan_lib.legacy_convnet_plan(
        cosmo_cfg.SMOKE, SpatialPartitioning(("model", None, None)),
        (2, 1, 1))
    mesh = Mesh(plan.mesh_axes, ["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="one device"):
        train_step.make_convnet_train_step(
            cosmo_cfg.SMOKE, mesh, None, global_batch=2, plan=plan)
    # the FC head runs on both shards of the gathered spatial group
    assert plan.loss_redundancy == 2
    assert deep_plan(plan_lib, 5, 4).loss_redundancy == 4
