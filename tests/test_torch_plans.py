"""The cost-model planner, the spatial <-> batch reshards, planned models
and batch-sharded serving of the port, on the CPU.

* the planner: on a grid of configs (both models at their published and
  SMOKE widths; spatial degree 1/2/4; data degree 1/2; global batch
  2/4/8; ``overlap``/``monolithic``/``reduce_scatter``; with and
  without a memory budget, precisions and ``spatial_options``) the
  port's ``plan_convnet(cfg, V100, ...)`` returns the reference's plan —
  stages, name, precision, cost within rel 1e-12 — and its
  ``price_plan`` equals the reference's on every candidate; the
  reference's two regimes (``tests/test_plan.py``) hold on the port.
  Pure Python on both sides.
* the reshards: ``spatial_to_batch``, ``batch_to_spatial`` and the
  gather oracle on 1 x 2 and 1 x 4 in-process meshes, bitwise the
  reference's tiled ``all_to_all`` layout (its ``core/reshard.py`` under
  ``jax.vmap`` with a named axis), gradients by autograd bitwise its
  ``jax.vjp``.
* planned models against the port's own fixed plan: forward, loss and
  gradients of the ``b1_batch``, ``b2_replicated`` and
  ``uniform_batch`` plans of both models at 2- and 4-way, each leaf
  within atol 2e-5, rtol 1e-4 (the reference's own planned-vs-fixed
  gap is 1.75e-5 at the U-Net's ``dec0_b0``, summation order); the
  dropout masks each sample draws are the same under every plan. (The
  same plans against the reference's: ``test_torch_spatial_train.py``,
  which already runs the reference on 4 devices.)
* sessions: ``plan="auto"`` and ``memory_budget_gib`` choose what
  ``plan_convnet(cfg, H100, ...)`` chooses, a budget below the floor
  names the floor, ``plan="fixed"`` is the legacy plan, ``describe()``
  prices on ``H100``; batch-sharded serving (``data=2``, alone and with
  ``spatial=2``) gives the ``data=1`` predictions.
"""
import dataclasses
import functools
import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import perf_model as jperf
from repro.core import plan as jplan
from repro.core import reshard as jreshard
from repro_torch import configs
from repro_torch.api import RunConfig, RunConfigError, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.core import memory, perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import reshard, spmd
from repro_torch.core.perf_model import H100, V100, Hardware
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cosmoflow, unet3d
from repro_torch.obs import trace as trace_lib
from repro_torch.serve import InferenceSession
from repro_torch.train import train_step

ARCHS = [("cosmoflow-128", False), ("cosmoflow-512", False),
         ("unet3d-256", False), ("cosmoflow-512", True),
         ("unet3d-256", True)]
GB = 4
PLANS = {"b1_batch": dict(boundary=1, kind="batch"),
         "b2_replicated": dict(boundary=2, kind="replicated"),
         "uniform_batch": dict(boundary=None, kind="batch")}
# the planned-model runs: the SMOKE configs, CosmoFlow on the 16^3 input
# of the reference's planned-vs-fixed test (tests/test_plan.py)
MODELS = {"cosmoflow": dataclasses.replace(cosmo_cfg.SMOKE, input_width=16),
          "unet3d": unet_cfg.SMOKE}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its shards are threads already, and beside other test workers a
    thread pool a shard only contends (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, smoke):
    if smoke:
        return jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    return jconfigs.get_config(arch), configs.get_config(arch)


def _same_plan(want, got):
    assert got.name == want.name and got.precision == want.precision
    assert [dataclasses.astuple(s) for s in got.stages] == \
        [dataclasses.astuple(s) for s in want.stages]
    assert got.mesh_axes == want.mesh_axes and got.n_layers == want.n_layers
    assert abs(got.cost - want.cost) <= 1e-12 * abs(want.cost), (
        got.cost, want.cost)


def _grid(grad_comms=("overlap", "monolithic", "reduce_scatter")):
    for S, D, gb, gc in itertools.product((1, 2, 4), (1, 2), (2, 4, 8),
                                          grad_comms):
        if gb % D == 0:
            yield dict(spatial_degree=S, data_degree=D, global_batch=gb,
                       grad_comm=gc)


# planner options beside the grid's, by the grid's spatial degree S (the
# spatial options a session offers: S and up)
EXTRAS = {
    "plain": lambda S: {},
    "precisions": lambda S: dict(precisions=("fp32", "bf16")),
    "spatial_options": lambda S: dict(spatial_options=(S, 2 * S)),
    "budget": lambda S: dict(memory_budget_bytes=4 * 2 ** 30,
                             precisions=("fp32", "bf16"),
                             spatial_options=(S, 2 * S)),
    "tight_budget": lambda S: dict(memory_budget_bytes=0.02 * 2 ** 30),
    "remat": lambda S: dict(remat_options=True),
}


# ----------------------------------------------------------- planner ----
@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_plan_convnet_returns_the_reference_plan(arch, smoke, extra):
    jcfg, cfg = _cfgs(arch, smoke)
    # under a budget, monolithic differs from overlap in time only, which
    # the cases without one cover
    for kw in (_grid(("overlap", "reduce_scatter")) if "budget" in extra
               else _grid()):
        more = EXTRAS[extra](kw["spatial_degree"])
        try:
            want = jplan.plan_convnet(jcfg, jperf.V100, **kw, **more)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                plan_lib.plan_convnet(cfg, V100, **kw, **more)
            assert str(got.value) == str(e), kw
            if hasattr(e, "best_infeasible_plan"):
                _same_plan(e.best_infeasible_plan,
                           got.value.best_infeasible_plan)
                assert got.value.best_infeasible_mem.total == \
                    e.best_infeasible_mem.total
            continue
        _same_plan(want, plan_lib.plan_convnet(cfg, V100, **kw, **more))


@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_every_candidate_prices_as_the_reference(arch, smoke):
    """``iteration_time`` through ``price_plan`` on every candidate of
    the grid, every remat set and both precisions, and the fixed-degree
    baseline, equal the reference's to rel 1e-12 (the same arithmetic in
    the same order: in practice bitwise)."""
    jcfg, cfg = _cfgs(arch, smoke)
    for kw in _grid():
        try:
            jc = jplan.candidate_convnet_plans(jcfg, jperf.V100, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                plan_lib.candidate_convnet_plans(cfg, V100, **kw)
            continue
        tc = plan_lib.candidate_convnet_plans(cfg, V100, **kw)
        assert len(tc) == len(jc)
        for want, got in zip(jc, tc):
            _same_plan(want, got)
            for jv, tv in zip(jplan.remat_variants(jcfg, want),
                              plan_lib.remat_variants(cfg, got)):
                assert tv.name == jv.name
                assert plan_lib.plan_schedule(cfg, tv) == \
                    jplan.plan_schedule(jcfg, jv)
                for prec in ("fp32", "bf16"):
                    a = jplan.price_plan(
                        jcfg, jperf.V100,
                        dataclasses.replace(jv, precision=prec),
                        global_batch=kw["global_batch"],
                        grad_comm=kw["grad_comm"])
                    b = plan_lib.price_plan(
                        cfg, V100, dataclasses.replace(tv, precision=prec),
                        global_batch=kw["global_batch"],
                        grad_comm=kw["grad_comm"])
                    assert abs(a - b) <= 1e-12 * a, (tv.name, prec, a, b)
        _, a = jplan.price_fixed_degree(jcfg, jperf.V100, **kw)
        _, b = plan_lib.price_fixed_degree(cfg, V100, **kw)
        assert abs(a - b) <= 1e-12 * a
        for overlap in (True, False):
            a = jperf.iteration_time(jcfg, jperf.V100, num_gpus=kw[
                "spatial_degree"] * kw["data_degree"], ways=kw[
                "spatial_degree"], global_batch=kw["global_batch"],
                grad_comm=kw["grad_comm"], overlap=overlap)
            b = perf_model.iteration_time(cfg, V100, num_gpus=kw[
                "spatial_degree"] * kw["data_degree"], ways=kw[
                "spatial_degree"], global_batch=kw["global_batch"],
                grad_comm=kw["grad_comm"], overlap=overlap)
            assert a == pytest.approx(b, rel=1e-12, abs=0)


def test_planner_uniform_when_reshard_dominates():
    """The reference's first regime (``tests/test_plan.py``): a wide
    shallow net on a bandwidth-bound fabric keeps the uniform plan."""
    cfg = dataclasses.replace(configs.get_config("cosmoflow-128"),
                              conv_channels=(16, 32), input_width=128)
    bw_bound = Hardware("bwbound", peak_flops=15.7e12, mem_bw=900e9,
                        link_bw=1e6, ar_bw=10e9, latency=0.0)
    chosen = plan_lib.plan_convnet(cfg, bw_bound, spatial_degree=2,
                                   data_degree=2, global_batch=8)
    assert "uniform" in chosen.name, chosen.name
    assert len(chosen.stages[0].spatial_names) == 1
    assert chosen.stages[0].stop == plan_lib.cosmoflow_n_layers(cfg) - 1


def test_planner_transitions_when_halo_latency_dominates():
    """The reference's second regime: a deep net on a latency-bound
    fabric moves the spatial group into the batch mid-network."""
    cfg = configs.get_config("cosmoflow-512")
    lat_bound = Hardware("latbound", peak_flops=15.7e12, mem_bw=900e9,
                         link_bw=75e9, ar_bw=10e9, latency=5e-3)
    chosen = plan_lib.plan_convnet(cfg, lat_bound, spatial_degree=2,
                                   data_degree=2, global_batch=8)
    assert "uniform" not in chosen.name, chosen.name
    assert chosen.stages[0].stop < plan_lib.cosmoflow_n_layers(cfg) - 1
    assert chosen.batch_extension_axes == ("model",)
    assert chosen.loss_redundancy == 1


@pytest.mark.parametrize("hw", [V100, H100], ids=["V100", "H100"])
def test_planner_never_prices_above_the_fixed_degree_plan(hw):
    for name, kw in (("cosmoflow-512", dict(spatial_degree=16,
                                            data_degree=16,
                                            global_batch=64)),
                     ("cosmoflow-128", dict(spatial_degree=4,
                                            data_degree=1, global_batch=4)),
                     ("unet3d-256", dict(spatial_degree=8, data_degree=4,
                                         global_batch=16))):
        cfg = configs.get_config(name)
        cands = plan_lib.candidate_convnet_plans(cfg, hw, **kw)
        chosen = plan_lib.plan_convnet(cfg, hw, **kw)
        assert all(p.cost >= chosen.cost for p in cands)
        fixed, fixed_cost = plan_lib.price_fixed_degree(cfg, hw, **kw)
        assert "legacy" in fixed.name
        assert chosen.cost <= fixed_cost + 1e-12, (name, chosen.cost,
                                                  fixed_cost)


def test_h100_record_and_its_bf16_rate():
    """The port's card: fp32 at 3xTF32's rate, bf16 at the tensor cores'
    own, NVLink 4 each way, the conv kernel's measured share of its
    bound; a bf16 plan prices below the fp32 one (the reference's V100
    has one rate, so there bf16 only halves the messages)."""
    assert H100.peak_flops == pytest.approx(495e12 / 3)
    assert H100.half_flops == 989e12 and H100.mem_bw == 3.35e12
    assert H100.link_bw == H100.ar_bw == 450e9
    assert H100.base_eff == pytest.approx(0.3763, abs=1e-4)
    assert V100.half_flops is None
    assert {f.name for f in dataclasses.fields(jperf.Hardware)} | {
        "half_flops"} == {f.name for f in dataclasses.fields(Hardware)}
    cfg = configs.get_config("cosmoflow-128")
    plan = plan_lib.convnet_plan(cfg, boundary=3, kind="batch",
                                 spatial_degrees=(2, 1, 1))
    fp32 = plan_lib.price_plan(cfg, H100, plan, global_batch=4)
    bf16 = plan_lib.price_plan(
        cfg, H100, dataclasses.replace(plan, precision="bf16"),
        global_batch=4)
    assert 0 < bf16 < fp32 / 3
    assert plan_lib.price_plan(cfg, V100, plan, global_batch=4) > fp32


def test_pipelined_pricing_names_the_pipeline_slice():
    cfg = configs.get_config("cosmoflow-128")
    spec = plan_lib.PipelineSpec((0, 1))
    plan = plan_lib.ParallelPlan(
        (plan_lib.Stage(0, 3), plan_lib.Stage(3, 8)), (("data", 1),), 8,
        name="pipe", pipeline=spec)
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        plan_lib.price_plan(cfg, H100, plan, global_batch=4)
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        plan_lib.plan_convnet(cfg, H100, spatial_degree=1, global_batch=4,
                              pipeline_options=(2,))
    # a degree of 1 is no pipeline: the reference's plain argmin
    plan_lib.plan_convnet(cfg, H100, spatial_degree=1, global_batch=4,
                          pipeline_options=(1,))


def test_convnet_plan_names_axes_and_redundancy():
    """The reference's schema checks (``tests/test_plan.py``) on the
    port: names, axis accounting, what the targets follow, and the
    boundary and kind errors; ``uniform_plan`` is the one-transition
    plan with no boundary, as before."""
    cfg = configs.get_smoke_config("cosmoflow-512")
    jcfg = jconfigs.get_smoke_config("cosmoflow-512")
    for kw in (dict(boundary=1, kind="batch"),
               dict(boundary=2, kind="replicated"),
               dict(boundary=None, kind="batch"),
               dict(boundary=None, kind="replicated")):
        got = plan_lib.convnet_plan(cfg, spatial_degrees=(4, 1, 1),
                                    data_degrees=(2,), **kw)
        want = jplan.convnet_plan(jcfg, spatial_degrees=(4, 1, 1),
                                  data_degrees=(2,), **kw)
        assert got.name == want.name
        assert got.stages == tuple(plan_lib.Stage(*dataclasses.astuple(s))
                                   for s in want.stages)
        assert got.batch_extension_axes == want.batch_extension_axes
        assert got.loss_redundancy == want.loss_redundancy
    pl = plan_lib.convnet_plan(cfg, boundary=1, kind="batch",
                               spatial_degrees=(4, 1, 1), data_degrees=(2,))
    assert pl.axis_names == ("data", "model")
    assert pl.batch_extension_axes == ("model",) and pl.loss_redundancy == 1
    rep = plan_lib.convnet_plan(cfg, boundary=1, kind="replicated",
                                spatial_degrees=(4, 1, 1))
    assert rep.loss_redundancy == 4 and rep.batch_extension_axes == ()
    assert plan_lib.uniform_plan(cfg, spatial_degrees=(2, 1, 1)) == \
        plan_lib.convnet_plan(cfg, kind="replicated",
                              spatial_degrees=(2, 1, 1))
    with pytest.raises(ValueError, match="boundary"):
        plan_lib.convnet_plan(cfg, boundary=0)
    with pytest.raises(ValueError, match="kind"):
        plan_lib.convnet_plan(cfg, boundary=1, kind="bogus")


# ----------------------------------------------------------- reshards ----
def _jax_layout(fn, x, S):
    """The reference's ``fn`` over an S-way named axis (``jax.vmap``):
    the stacked outputs, and its vjp."""
    f = jax.vmap(lambda t: fn(t, "model", 1), axis_name="model")
    return jax.vjp(f, jnp.asarray(x))


@pytest.mark.parametrize("S", [2, 4])
def test_reshards_are_the_reference_all_to_all_bitwise(S):
    r = np.random.RandomState(S)
    x = r.randn(S, 4, 8 // S * 2, 3, 2, 3).astype(np.float32)  # per shard
    mesh = Mesh([("data", 1), ("model", S)], ["cpu"] * S)
    for name, jfn, fn in (
            ("spatial_to_batch", jreshard.spatial_to_batch,
             reshard.spatial_to_batch),
            ("oracle", jreshard.spatial_to_batch_oracle,
             reshard.spatial_to_batch_oracle)):
        want, vjp = _jax_layout(jfn, x, S)
        ct = r.randn(*want.shape).astype(np.float32)
        (want_g,) = vjp(jnp.asarray(ct))
        xs = [torch.from_numpy(x[i]).requires_grad_(True) for i in range(S)]
        with torch.enable_grad():
            ys = spmd.run(mesh, lambda t: fn(t, "model", 1), xs)
            total = sum((y * torch.from_numpy(ct[i])).sum()
                        for i, y in enumerate(ys))
            gs = torch.autograd.grad(total, xs)
        got = np.stack([y.detach().numpy() for y in ys])
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        np.testing.assert_array_equal(np.stack([g.numpy() for g in gs]),
                                      np.asarray(want_g), err_msg=name)
    # batch -> spatial, the inverse, on the layout spatial_to_batch left
    y = np.asarray(_jax_layout(jreshard.spatial_to_batch, x, S)[0])
    want, vjp = _jax_layout(jreshard.batch_to_spatial, y, S)
    ct = r.randn(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    np.testing.assert_array_equal(np.asarray(want), x)
    ys_in = [torch.from_numpy(y[i].copy()).requires_grad_(True)
             for i in range(S)]
    with torch.enable_grad():
        outs = spmd.run(mesh, lambda t: reshard.batch_to_spatial(
            t, "model", 1), ys_in)
        gs = torch.autograd.grad(sum((o * torch.from_numpy(ct[i])).sum()
                                     for i, o in enumerate(outs)), ys_in)
    np.testing.assert_array_equal(np.stack([o.detach().numpy()
                                            for o in outs]), x)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in gs]),
                                  np.asarray(want_g))
    # without autograd: the same bits
    with torch.no_grad():
        ys = spmd.run(mesh, lambda t: reshard.spatial_to_batch(
            t, "model", 1), [torch.from_numpy(x[i]) for i in range(S)])
    np.testing.assert_array_equal(np.stack([t.numpy() for t in ys]), y)


def test_all_to_all_on_a_data_x_spatial_mesh_and_its_errors():
    """The all_to_all runs within each data index's spatial group (as
    ``lax.all_to_all`` over the spatial axis of a 2-D mesh), and the
    divisibility errors name the dims; outside a run it is the
    identity."""
    r = np.random.RandomState(0)
    x = r.randn(2, 2, 4, 6, 3).astype(np.float32)  # (data, model, ...)
    mesh = Mesh([("data", 2), ("model", 2)], ["cpu"] * 4)
    ys = spmd.run(mesh, lambda t: spmd.axis("model").all_to_all(t, 0, 1),
                  [torch.from_numpy(x[d, m]) for d in range(2)
                   for m in range(2)])
    for d in range(2):
        want = jax.vmap(lambda t: jax.lax.all_to_all(
            t, "model", 0, 1, tiled=True), axis_name="model")(
            jnp.asarray(x[d]))
        for m in range(2):
            np.testing.assert_array_equal(ys[2 * d + m].numpy(),
                                          np.asarray(want[m]))
    t = torch.zeros(3, 4, 2)
    assert spmd.axis("model").all_to_all(t, 0, 1) is t
    mesh2 = Mesh([("model", 2)], ["cpu"] * 2)
    for fn, msg in ((lambda t: reshard.spatial_to_batch(t, "model", 1),
                     "local batch 3"),
                    (lambda t: reshard.batch_to_spatial(t, "model", 2),
                     "extent 3"),
                    (lambda t: spmd.axis("model").all_to_all(t, 1, 1),
                     "two different dims")):
        with pytest.raises(ValueError, match=msg):
            spmd.run(mesh2, fn, [torch.zeros(3, 4, 3, 2)] * 2)


def test_apply_cuts_ids_and_targets_through_batch_moves():
    """``apply`` returns the ids of the rows each shard holds after a
    batch move (None after the ascent), counts its transitions, and
    ``shard_batch`` cuts targets and ids alike."""
    cfg = cosmo_cfg.SMOKE
    plan = plan_lib.convnet_plan(cfg, boundary=1, kind="batch",
                                 spatial_degrees=(2, 1, 1))
    src, dst = plan.stages
    mesh = Mesh([("data", 1), ("model", 2)], ["cpu"] * 2)
    tracer = trace_lib.Tracer()
    trace_lib.enable(tracer)
    try:
        def body(h):
            h2, ids = reshard.apply(h, src, dst, sample_ids=range(10, 14))
            back, none = reshard.apply(h2, dst, src, sample_ids=ids)
            y = reshard.shard_batch(torch.arange(4), ("model",))
            return h2.shape, ids, back, none, y

        x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
        x = x[..., None, None].expand(4, 8, 2, 1, 1).contiguous()
        outs = spmd.run(mesh, body, [x[:, :4], x[:, 4:]])
    finally:
        trace_lib.disable(tracer)
    assert [o[1] for o in outs] == [range(10, 12), range(12, 14)]
    assert all(o[0] == (2, 8, 2, 1, 1) and o[3] is None for o in outs)
    assert torch.equal(torch.cat([outs[0][2], outs[1][2]], 1), x)
    assert [o[4].tolist() for o in outs] == [[0, 1], [2, 3]]
    assert tracer.metrics.counter("reshard.transitions").value == 4


# ----------------------------------------------------- planned models ----
def _model_inputs(cfg, seed=0):
    r = np.random.RandomState(seed)
    w = cfg.input_width
    x = torch.from_numpy(r.randn(GB, w, w, w, cfg.in_channels).astype(
        np.float32))
    if cfg.arch == "unet3d":
        y = torch.from_numpy(r.randint(0, cfg.out_dim, (GB, w, w, w)))
    else:
        y = torch.from_numpy(r.randn(GB, cfg.out_dim).astype(np.float32))
    return x, y


def _planned(cfg, S, name):
    if name == "fixed":
        return "fixed"
    return plan_lib.convnet_plan(cfg, spatial_degrees=(S, 1, 1),
                                 **PLANS[name])


@functools.lru_cache(maxsize=None)
def _fixed_run(arch, S):
    """``_probe_and_eval`` of the fixed plan, and its dropout rows."""
    calls = []
    return _probe_and_eval(MODELS[arch], S, "fixed", calls), calls


def _probe_and_eval(cfg, S, name, mask_calls=None):
    """(loss, reduced gradients, eval predictions) of a 1 x S session
    under plan ``name``; ``mask_calls`` records each shard's dropout
    rows."""
    def masks(seed, layer, ids, width, device):
        if mask_calls is not None:
            mask_calls.append((layer, tuple(ids)))
        return cosmoflow.generator_masks(seed, layer, ids, width, device)

    x, y = _model_inputs(cfg)
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=S,
                           plan=_planned(cfg, S, name)),
                 devices=["cpu"] * S, mask_source=masks) as sess:
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan, mask_source=masks)["grad_comm"]
        loss, grads = probe(sess.params, sess.opt_state, x, y, 3)
        _, preds = sess.evaluate(x, y)
    return float(loss), grads, preds


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_planned_model_matches_the_fixed_plan(arch, S, plan_name):
    """Loss, every reduced gradient leaf and the eval forward of a
    planned session against the fixed plan's on the same inputs: atol
    2e-5, rtol 1e-4 a leaf (the reference's own planned plans lie up to
    1.75e-5 from its fixed one, summation order); every sample draws its
    dropout masks once a layer under a batch-moved head, each shard all
    of them under a replicated one."""
    cfg = MODELS[arch]
    calls = {plan_name: []}
    got = _probe_and_eval(cfg, S, plan_name, calls[plan_name])
    want, calls["fixed"] = _fixed_run(arch, S)
    assert abs(got[0] - want[0]) <= 1e-5 * max(1.0, abs(want[0]))
    assert set(got[1]) == set(want[1])
    for k, g in got[1].items():
        np.testing.assert_allclose(g.numpy(), want[1][k].numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=2e-5,
                               rtol=1e-4)
    if arch == "cosmoflow":
        plan = plan_lib.convnet_plan(cfg, spatial_degrees=(S, 1, 1),
                                     **PLANS[plan_name])
        n_fc = len(cfg.fc_dims)
        for layer in range(n_fc):
            rows = sorted(i for lyr, ids in calls[plan_name] if lyr == layer
                          for i in ids)
            copies = plan.loss_redundancy
            assert rows == sorted(list(range(GB)) * copies), (layer, rows)
            assert sorted(i for lyr, ids in calls["fixed"] if lyr == layer
                          for i in ids) == sorted(list(range(GB)) * S)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_the_all_gather_oracle_gives_the_all_to_all_bits(arch):
    """A batch plan's forward and gradients lowered by the gather oracle
    (``reshard_oracle=True``) are bitwise those of the all_to_all."""
    cfg = MODELS[arch]
    S = 2
    plan = plan_lib.convnet_plan(cfg, boundary=1, kind="batch",
                                 spatial_degrees=(S, 1, 1))
    x, y = _model_inputs(cfg)
    mesh = Mesh(plan.mesh_axes, ["cpu"] * S)
    params = (cosmoflow if arch == "cosmoflow" else unet3d).init_params(
        cfg, torch.Generator().manual_seed(1), "cpu")
    xs = train_step.split_input(x, mesh, plan.stages[0])
    ys = train_step.split_targets(cfg, y, mesh, plan.stages[0])
    out = {}
    for oracle in (False, True):
        leaves = [{k: v.clone().requires_grad_(True)
                   for k, v in params.items()} for _ in range(S)]

        def loss(p, xi, yi):
            if arch == "unet3d":
                return unet3d.segmentation_loss(
                    p, xi, yi, cfg, plan=plan,
                    global_voxels=GB * cfg.input_width ** 3,
                    reshard_oracle=oracle)
            return cosmoflow.mse_loss(p, xi, yi, cfg, plan=plan,
                                      global_batch=GB, dropout_seed=5,
                                      sample_ids=range(GB),
                                      reshard_oracle=oracle)

        with torch.enable_grad():
            losses = spmd.run(mesh, loss, leaves, xs, ys)
            flat = [t for p in leaves for t in p.values()]
            out[oracle] = ([float(v.detach()) for v in losses],
                           torch.autograd.grad(sum(losses), flat))
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def _count_launches(monkeypatch):
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
    return calls


@pytest.mark.parametrize("plan_name", ["b1_batch", "b2_replicated"])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_kernel_launches_of_a_planned_step_follow_the_plan(
        monkeypatch, arch, plan_name):
    """Each wrapper call of one planned training step (1 x 2), counted
    on the CPU, equals what ``kernel_launches(train=True)`` derives from
    the plan: a batch-moved stage runs every block once a shard on half
    the batch, with no halo."""
    cfg = MODELS[arch]
    calls = _count_launches(monkeypatch)
    x, y = _model_inputs(cfg)
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=2,
                           plan=_planned(cfg, 2, plan_name)),
                 devices=["cpu"] * 2) as sess:
        sess.step(x, y)
        want = (cosmoflow if arch == "cosmoflow" else unet3d
                ).kernel_launches(cfg, sess.plan, train=True)
    assert calls == want
    fixed = (cosmoflow if arch == "cosmoflow" else unet3d).kernel_launches(
        cfg, _fixed_plan(cfg, 2), train=True)
    assert want["pack"] <= fixed["pack"]


def _fixed_plan(cfg, S):
    from repro_torch.core.spatial_conv import SpatialPartitioning

    return plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (S, 1, 1))


@functools.lru_cache(maxsize=None)
def _planned_2x2(grad_comm, plan):
    """The 2 x 2 session's ``grad_comm`` probe (loss, gradients) on the
    first batch, and (loss, parameters) after two steps."""
    cfg = MODELS["cosmoflow"]
    x, y = _model_inputs(cfg, 2)
    with compile(RunConfig(model=cfg, global_batch=GB, data=2, spatial=2,
                           plan=plan, grad_comm=grad_comm),
                 devices=["cpu"] * 4) as sess:
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB,
            plan=sess.plan, grad_comm=grad_comm)["grad_comm"](
            sess.params, sess.opt_state, x, y, 0)
        for _ in range(2):
            loss = sess.step(x, y)
        return probe, (float(loss), sess.params)


@pytest.mark.parametrize("grad_comm", ["overlap", "monolithic",
                                       "reduce_scatter"])
def test_a_planned_2x2_run_trains_under_every_grad_comm(grad_comm):
    """The b1 batch plan at 2 x 2: the ``grad_comm`` probe's loss and
    reduced gradients within atol 2e-5, rtol 1e-4 of the fixed plan's
    (the reference's planned-vs-fixed tolerance, ``tests/test_plan.py``),
    and after two steps the same bits under every reduction lowering
    (each adds the spatial peers, then the data shards). Parameters
    after two Adam steps are not compared with the fixed plan's: a
    gradient near zero turns its rounding into a whole step there."""
    plan = plan_lib.convnet_plan(MODELS["cosmoflow"], boundary=1,
                                 kind="batch", spatial_degrees=(2, 1, 1),
                                 data_degrees=(2,))
    (loss, grads), mine = _planned_2x2(grad_comm, plan)
    ref = _planned_2x2("overlap", plan)[1]
    assert mine[0] == ref[0]
    for k, v in mine[1].items():
        assert torch.equal(v, ref[1][k]), k
    floss, fgrads = _planned_2x2(grad_comm, "fixed")[0]
    assert abs(float(loss) - float(floss)) <= 1e-5
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), fgrads[k].numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)


# ----------------------------------------------------------- sessions ----
def test_plan_auto_is_the_planners_choice_on_the_h100():
    cfg = cosmo_cfg.SMOKE
    for D, S, gc in ((1, 2, "overlap"), (2, 2, "reduce_scatter"),
                     (1, 4, "monolithic")):
        with compile(RunConfig(model=cfg, global_batch=GB, data=D,
                               spatial=S, plan="auto", grad_comm=gc),
                     devices=["cpu"] * (D * S)) as sess:
            want = plan_lib.plan_convnet(
                cfg, H100, spatial_degree=S, data_degree=D,
                global_batch=GB, grad_comm=gc)
            assert sess.plan == want and sess.precision == "fp32"
            rep = sess.describe()
            assert rep.predicted_step_s == plan_lib.price_plan(
                cfg, H100, want, global_batch=GB, grad_comm=gc)
            assert "H100" in str(rep) and rep.memory_budget_bytes is None
    # an explicit precision is priced, and kept
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=2,
                           plan="auto", precision="bf16"),
                 devices=["cpu"] * 2) as sess:
        assert sess.plan == plan_lib.plan_convnet(
            cfg, H100, spatial_degree=2, data_degree=1, global_batch=GB,
            precisions=("bf16",))
        assert sess.precision == "bf16"


def test_plan_fixed_resolves_to_the_legacy_plan():
    for arch, cfg in MODELS.items():
        for D, S in ((1, 1), (1, 2), (2, 2)):
            with compile(RunConfig(model=cfg, global_batch=GB, data=D,
                                   spatial=S), devices=["cpu"] * (D * S)
                         ) as sess:
                want = plan_lib.legacy_convnet_plan(
                    cfg, plan_lib.SpatialPartitioning(("model", None, None)),
                    (S, 1, 1), data_degrees=(D,))
                assert sess.plan == want and sess.plan.cost is None
                assert sess.plan.name == f"{arch}.legacy"


def test_a_memory_budget_chooses_as_the_planner_and_names_its_floor():
    """A budget runs the planner over the spatial degrees the devices
    given allow (the plan's mesh takes the first ones), on the H100
    record; below every candidate's modeled peak it raises
    ``RunConfigError("memory_budget_gib")`` naming the floor."""
    cfg = cosmo_cfg.SMOKE
    for budget in (0.0045, 0.01, 4.0):
        config = RunConfig(model=cfg, global_batch=GB,
                           memory_budget_gib=budget)
        with compile(config, devices=["cpu"] * 4) as sess:
            want = plan_lib.plan_convnet(
                cfg, H100, spatial_degree=1, data_degree=1,
                global_batch=GB, grad_comm="overlap",
                memory_budget_bytes=budget * 2 ** 30,
                precisions=("fp32", "bf16"), spatial_options=(1, 2, 4))
            assert sess.plan == want
            assert sess.mesh.size == want.device_count
            assert sess.precision == want.precision
            rep = sess.describe()
            assert rep.modeled_peak.total <= budget * 2 ** 30
            assert rep.memory_budget_bytes == budget * 2 ** 30
            assert "budget" in str(rep)
    floor = min(
        memory.plan_peak_bytes(cfg, dataclasses.replace(v, precision=prec),
                               global_batch=GB).total
        for s in (1, 2, 4)
        for p in plan_lib.candidate_convnet_plans(
            cfg, H100, spatial_degree=s, global_batch=GB)
        for v in plan_lib.remat_variants(cfg, p)
        for prec in ("fp32", "bf16"))
    with pytest.raises(RunConfigError) as e:
        compile(RunConfig(model=cfg, global_batch=GB,
                          memory_budget_gib=0.001), devices=["cpu"] * 4)
    assert e.value.field == "memory_budget_gib"
    assert f"{floor / 2 ** 30:.3f} GiB" in e.value.fix
    # one device given: no spatial degree to raise to
    with pytest.raises(RunConfigError, match=r"spatial options \[1\]"):
        compile(RunConfig(model=cfg, global_batch=GB,
                          memory_budget_gib=0.001), device="cpu")
    # without a budget the devices must be one a shard
    with pytest.raises(RunConfigError, match="one device per shard"):
        compile(RunConfig(model=cfg, global_batch=GB, plan="auto"),
                devices=["cpu"] * 2)
    for bad in (0.0, -1.0):
        with pytest.raises(RunConfigError) as e:
            RunConfig(model=cfg, memory_budget_gib=bad).validate()
        assert e.value.field == "memory_budget_gib"


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_batch_sharded_serving_gives_the_data_1_predictions(arch, tmp_path):
    """``data=2`` (alone and with ``spatial=2``) and ``plan="auto"``
    serve the ``data=1`` predictions; a checkpoint re-degrees to
    ``data=2`` at restore; the harness pads a batch to a multiple of the
    data degree."""
    cfg = MODELS[arch]
    x, _ = _model_inputs(cfg)
    with compile(RunConfig(model=cfg, mode="infer", global_batch=GB),
                 device="cpu") as sess:
        base = sess.predict(x)
        # the harness pads one request to two rows: batch norm's
        # statistics are the padded batch's
        padded = sess.predict(x[:1].repeat(2, *([1] * (x.dim() - 1))))[0]
    runs = [dict(data=2), dict(data=2, spatial=2),
            dict(spatial=2, plan="auto")]
    for kw in runs:
        n = kw.get("data", 1) * kw.get("spatial", 1)
        with compile(RunConfig(model=cfg, mode="infer", global_batch=GB,
                               **kw), devices=["cpu"] * n) as sess:
            assert sess.mesh.shape["data"] == kw.get("data", 1)
            got = sess.predict(x)
            np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=str(kw))
            if kw.get("data", 1) > 1:
                with pytest.raises(ValueError, match="multiple of 2"):
                    sess.predict(x[:1])
                with sess.serve(max_batch=4, max_wait_ms=1.0) as h:
                    one = h.submit(x[0].numpy()).result(timeout=60)
                np.testing.assert_allclose(
                    np.asarray(one), padded.numpy(), atol=1e-5, rtol=1e-4)
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=2),
                 devices=["cpu"] * 2) as train:
        train.save(str(tmp_path / "ckpt"))
        params = train.params
    restored = InferenceSession.restore(str(tmp_path / "ckpt"), data=2,
                                        spatial=1, devices=["cpu"] * 2)
    with restored, compile(RunConfig(model=cfg, mode="infer",
                                     global_batch=GB), device="cpu") as one:
        assert restored.mesh.shape == {"data": 2, "model": 1}
        one.params = params
        np.testing.assert_allclose(restored.predict(x).numpy(),
                                   one.predict(x).numpy(), atol=1e-5,
                                   rtol=1e-4)
