"""The pipeline axis of the port (``train_step.make_pipeline_train_step``
and everything a pipelined run needs) against the reference, on the CPU
(every shard a thread on ``"cpu"``).

* ``_schedule_order``, ``pipelined_convnet_plan`` (names, group layer
  ranges, errors) and ``PipelineSpec``'s errors: the reference's;
* the segments (``cosmoflow.forward_range``, ``unet3d.down_range`` and
  ``up_range``): outputs and gradients against ``jax.vjp`` of the
  reference's, fp32, within 1e-5;
* the pipelined step at M = 4, 1F1B, ``overlap``, 2 shards a group
  (cosmoflow-512 SMOKE gb 8 cut at (2,), unet3d SMOKE gb 8 cut at (1,)):
  step 1's loss and merged gradients against the oracle — the sum over
  the micro-batches of ``jax.value_and_grad`` of the reference's loss,
  each on its own micro-batch (its batch-norm statistics), with the
  global normalizer, the rows' global sample ids and the step's dropout
  key —, each leaf within 1e-5 of its max-abs, or, where the
  reference's own leaf lies farther than that from the fp64 oracle,
  nearer it than the reference and within 1e-5 of it (the rule of
  ``tests/test_torch_unet.py``); step 1's loss against the reference's
  pipelined step within 1e-5;
* 1F1B against sequential and ``overlap`` against ``monolithic``:
  bitwise, also with an emulated link latency; the guard: 1.0 on a clean
  step, and a non-finite gradient in one group holds every group
  bitwise; a dispatcher that raises ends the step with its error;
* the reduction hooks under micro-batching: one non-last node's backward
  fires exactly ``make_plan(group params).num_buckets`` reductions, one
  before its last conv input gradient (the port's trace events);
* M = 1 against the unpipelined step of the same data degree; launches
  a step against ``kernel_launches`` (the wrappers' calls counted);
* the time and memory models (``pipeline_iteration_time``,
  ``group_param_counts``, ``_pipeline_peak_bytes``) and the planner's
  pipelined choices: the reference's numbers on ``V100``;
* ``RunConfig``'s pipeline errors; a pipelined ``Session``: ``describe``
  against the reference's, checkpoints both ways and ``Session.restore``
  resuming bitwise, ``profile``, the CLI at ``--pipeline 2``.

The reference's pipelined sessions run once, in a subprocess with 4
forced host devices, beside the port-only tests.

The reference's own U-Net pipeline never updates the encoder of every
group but the deepest: each group's up node returns zero gradients for
the down node's parameters, and merging the nodes' gradients keeps the
last (``src/repro/train/train_step.py:1166-1168``). The port's nodes
differentiate their own parameters only, and its gradients are held to
the oracle above, not to the reference's pipelined U-Net step.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.api import RunConfig as JRunConfig
from repro.api.config import RunConfigError as JRunConfigError
from repro.core import memory as jmemory
from repro.core import perf_model as jperf
from repro.core import plan as jplan
from repro.models import cosmoflow as jcosmo
from repro.models import unet3d as junet
from repro.train import train_step as jts

from repro_torch import configs
from repro_torch.api import RunConfig, Session, cli, compile
from repro_torch.api.config import RunConfigError
from repro_torch.core import dist_norm, flags, grad_comm, memory, perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cosmoflow, unet3d
from repro_torch.obs import trace as trace_lib
from repro_torch.optim.adam import Adam, constant
from repro_torch.train import train_step

from conftest import SRC

GB, M, D = 8, 4, 2
CASES = {"cosmo": ("cosmoflow-512", cosmoflow, jcosmo, (2,)),
         "unet": ("unet3d-256", unet3d, junet, (1,))}
FLOAT_REL = 1e-12

REFERENCE = r'''
import json
import numpy as np
import jax
import jax.numpy as jnp
from repro import api, configs
from repro.api.config import RunConfig
from repro.api.session import Session
from repro.core import plan as plan_lib
from repro.models import cosmoflow, unet3d


def _at_once(init):
    """``init`` as one program at XLA's optimization level 0 (op by op,
    the U-Net's random draws compile one at a time: ~30 s on the CPU).
    The sessions' initial parameters are replaced by the port's below."""
    once = jax.jit(init, static_argnums=(1, 2), compiler_options={
        "xla_backend_optimization_level": 0})

    def run(key, cfg, dtype=jnp.float32):
        if isinstance(key, jax.core.Tracer):
            return init(key, cfg, dtype)
        return once(key, cfg, dtype)
    return run


for model in (cosmoflow, unet3d):
    model.init_params = _at_once(model.init_params)

out = {}
inp = np.load(INPUTS)


def run(name, model, boundaries):
    cfg = configs.get_smoke_config(model)
    plan = plan_lib.pipelined_convnet_plan(
        cfg, boundaries=boundaries, micro_batches=M, schedule="1f1b",
        data_degrees=(D,))
    sess = api.compile(RunConfig(model=cfg, global_batch=GB, plan=plan,
                                 data=2 * D, pipeline=2, micro_batches=M,
                                 lr=1e-3, grad_clip=0.0))
    rep = sess.describe()
    peak = rep.modeled_peak
    out[name + "_describe"] = np.asarray(json.dumps({
        "plan_name": rep.plan_name, "stages": rep.stages,
        "mesh_shape": rep.mesh_shape, "precision": rep.precision,
        "grad_comm": rep.grad_comm, "global_batch": rep.global_batch,
        "param_count": rep.param_count,
        "modeled_peak": [peak.params, peak.param_copy, peak.grads,
                         peak.opt_state, peak.activations, peak.workspace],
        "predicted_step_s": rep.predicted_step_s,
        "stage_groups": rep.stage_groups,
        "group_devices": rep.group_devices,
        "micro_batches": rep.micro_batches,
        "pipeline_schedule": rep.pipeline_schedule,
        "bubble_fraction": rep.bubble_fraction,
        "lines": str(rep).split("\n")[3:5]}))
    prefix = name + "_p_"
    sess.params = {k[len(prefix):]: jnp.asarray(inp[k]) for k in inp.files
                   if k.startswith(prefix)}
    out[name + "_loss1"] = np.asarray(sess.step(inp[name + "_x1"],
                                                inp[name + "_y1"]))
    sess.save(CKPT_REF + name)
    out[name + "_loss2"] = np.asarray(sess.step(inp[name + "_x2"],
                                                inp[name + "_y2"]))
    sess.close()


run("cosmo", "cosmoflow-512", (2,))
run("unet", "unet3d-256", (1,))
# the port's pipelined checkpoint, resumed for one step
sess = Session.restore(CKPT_PORT)
out["resumed_step"] = np.asarray(sess.step_count)
out["resumed_groups"] = np.asarray(sess.plan.n_groups)
out["resumed_loss"] = np.asarray(sess.step(inp["cosmo_x2"],
                                           inp["cosmo_y2"]))
sess.close()
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its shards are threads already, and beside other test workers a
    thread pool a shard only contends (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_masks(seed, layer, sample_ids, width, device):
    """The reference's dropout masks, as a port mask source."""
    layer_rng = jax.random.fold_in(jax.random.PRNGKey(seed), layer)
    rows = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(layer_rng, int(sid)), 0.8, (width,)))
        for sid in sample_ids]
    return torch.from_numpy(np.stack(rows)).to(device)


def _cfgs(name):
    model = CASES[name][0]
    return configs.get_smoke_config(model), jconfigs.get_smoke_config(model)


def _batch(name, seed):
    cfg, _ = _cfgs(name)
    r = np.random.RandomState(seed)
    w = cfg.input_width
    x = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
    if cfg.arch == "unet3d":
        return x, r.randint(0, cfg.out_dim, (GB, w, w, w)).astype(np.int32)
    return x, r.randn(GB, cfg.out_dim).astype(np.float32)


def _params(name, seed=0):
    cfg, _ = _cfgs(name)
    return CASES[name][1].init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu")


def _plan(name, micro=M, schedule="1f1b", d=D, cfg=None):
    cfg = cfg or _cfgs(name)[0]
    return plan_lib.pipelined_convnet_plan(
        cfg, boundaries=CASES[name][3], micro_batches=micro,
        schedule=schedule, data_degrees=(d,))


def _step(name, plan, stage="step", grad_comm_="overlap", guard=False,
          cfg=None, schedule=None, lr=1e-3):
    """The port's pipelined step over 2 groups of ``plan``'s degree on
    the CPU: (step, meshes, opt)."""
    cfg = cfg or _cfgs(name)[0]
    meshes = mesh_lib.make_pipeline_meshes(
        plan, ["cpu"] * (plan.n_groups * plan.data_degree))
    opt = Adam(lr=constant(lr))
    step = train_step.make_pipeline_train_step(
        cfg, meshes, opt, plan=plan, global_batch=GB, grad_comm=grad_comm_,
        guard=guard, stage=stage, schedule=schedule,
        mask_source=jax_masks if cfg.arch == "cosmoflow" else None)
    return step, meshes, opt


def _run_steps(name, plan, n=2, **kw):
    """``n`` steps from the seeded parameters on the seeded batches:
    (params, losses)."""
    cfg = _cfgs(name)[0]
    step, meshes, opt = _step(name, plan, **kw)
    p = _params(name)
    o = train_step.make_pipeline_opt_state(cfg, opt, p, plan=plan,
                                           meshes=meshes)
    losses = []
    for i in range(n):
        x, y = _batch(name, 10 + i)
        out = step(p, o, torch.from_numpy(x), torch.from_numpy(y), i)
        p, o, loss = out[:3]
        losses.append(loss)
    return p, losses


class _Pending:
    """The reference's subprocess, started at once; ``result()`` waits
    for it (the port-only tests run meanwhile) and loads its outputs."""

    def __init__(self, script: str, **extra):
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.extra, self.out = extra, None

    def result(self) -> dict:
        if self.out is None:
            stdout, stderr = self.proc.communicate(timeout=560)
            assert self.proc.returncode == 0, (stdout, stderr)
            self.out = dict(np.load(self.extra["path"]), **self.extra)
        return self.out


def _port_session(name, **kw):
    cfg = _cfgs(name)[0]
    return compile(RunConfig(model=cfg, global_batch=GB, plan=_plan(name),
                             data=2 * D, pipeline=2, micro_batches=M,
                             lr=1e-3, grad_clip=0.0, **kw),
                   devices=["cpu"] * (2 * D),
                   mask_source=jax_masks if name == "cosmo" else None)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's pipelined sessions, started before this file's
    first test on the port's initial parameters and batches; before it
    starts, a port pipelined session takes a step and writes the
    checkpoint the reference resumes."""
    root = tmp_path_factory.mktemp("pipeline")
    arrays = {}
    for name in CASES:
        for k, v in _params(name).items():
            arrays[f"{name}_p_{k}"] = v.numpy()
        for i in (1, 2):
            arrays[f"{name}_x{i}"], arrays[f"{name}_y{i}"] = _batch(
                name, 40 + i)
    inputs = str(root / "inputs.npz")
    np.savez(inputs, **arrays)
    ckpt_port, ckpt_ref = str(root / "port"), str(root / "ref_")
    with _port_session("cosmo") as sess:
        sess.step(arrays["cosmo_x1"], arrays["cosmo_y1"])
        sess.save(ckpt_port)
        port_next = float(sess.step(arrays["cosmo_x2"], arrays["cosmo_y2"]))
    path = str(root / "reference.npz")
    script = (f"OUT = {path!r}\nINPUTS = {inputs!r}\n"
              f"CKPT_PORT = {ckpt_port!r}\nCKPT_REF = {ckpt_ref!r}\n"
              f"GB, M, D = {GB}, {M}, {D}\n" + REFERENCE)
    pending = _Pending(script, path=path, ckpt_ref=ckpt_ref,
                       ckpt_port=ckpt_port, port_next=port_next,
                       arrays=arrays)
    yield pending
    if pending.proc.poll() is None:
        pending.proc.kill()
        pending.proc.communicate()


# ------------------------------------------------ schedule and plans ----
@pytest.mark.parametrize("K,M_", [(2, 1), (2, 8), (3, 4), (4, 6), (3, 8),
                                  (4, 8), (5, 2), (2, 3)])
def test_schedule_order_is_the_references(K, M_):
    for schedule in plan_lib.PIPELINE_SCHEDULES:
        assert train_step._schedule_order(K, M_, schedule) == \
            jts._schedule_order(K, M_, schedule), (K, M_, schedule)


@pytest.mark.parametrize("model,cuts", [
    ("cosmoflow-512", (2,)), ("cosmoflow-512", (1, 3)),
    ("cosmoflow-128", (3,)), ("cosmoflow-128", (2, 5, 7)),
    ("unet3d-256", (1,)), ("unet3d-256", (2,)), ("unet3d-256", (1, 2, 3))])
def test_pipelined_plans_are_the_references(model, cuts):
    """Names, stages, the group of each layer and each group's range, the
    bubble and the serialized form, for SMOKE and full configs, both
    schedules; and the same errors."""
    for smoke in (True, False):
        cfg = (configs.get_smoke_config if smoke else configs.get_config)(
            model)
        jcfg = (jconfigs.get_smoke_config if smoke
                else jconfigs.get_config)(model)
        n = (plan_lib.cosmoflow_n_layers(cfg) if cfg.arch == "cosmoflow"
             else plan_lib.unet_n_layers(cfg))
        if max(cuts) >= n:
            continue
        for sched in plan_lib.PIPELINE_SCHEDULES:
            kw = dict(boundaries=cuts, micro_batches=3, schedule=sched,
                      data_degrees=(2,))
            got = plan_lib.pipelined_convnet_plan(cfg, **kw)
            want = jplan.pipelined_convnet_plan(jcfg, **kw)
            assert got.name == want.name
            assert [dataclasses.astuple(s) for s in got.stages] == \
                [dataclasses.astuple(s) for s in want.stages]
            assert got.group_layer_ranges() == want.group_layer_ranges()
            assert [got.group_for(i) for i in range(n)] == \
                [want.group_for(i) for i in range(n)]
            assert got.pipeline.bubble_fraction == \
                want.pipeline.bubble_fraction
            assert got.n_groups == want.n_groups == len(cuts) + 1
            assert got.device_count == 2 * got.n_groups
    cfg, jcfg = configs.get_config(model), jconfigs.get_config(model)
    for bad in ((0,), (2, 2), (99,)):
        with pytest.raises(ValueError, match="boundaries"):
            plan_lib.pipelined_convnet_plan(cfg, boundaries=bad)
        with pytest.raises(ValueError, match="boundaries"):
            jplan.pipelined_convnet_plan(jcfg, boundaries=bad)
    for spec_kw in (dict(stage_groups=(1, 2)), dict(stage_groups=(0, 2)),
                    dict(stage_groups=(0, 1), micro_batches=0),
                    dict(stage_groups=(0, 1), schedule="gpipe")):
        with pytest.raises(ValueError) as e:
            plan_lib.PipelineSpec(**spec_kw)
        with pytest.raises(ValueError) as je:
            jplan.PipelineSpec(**spec_kw)
        assert str(e.value) == str(je.value)
    plan = plan_lib.pipelined_convnet_plan(cfg, boundaries=cuts)
    with pytest.raises(ValueError, match="maps"):
        dataclasses.replace(plan, pipeline=plan_lib.PipelineSpec((0,)))
    # a pipeline with a spatial axis: each group shards only the batch
    with pytest.raises(ValueError, match="shard only the batch"):
        dataclasses.replace(
            plan, mesh_axes=plan.mesh_axes + (("model", 1),),
            stages=(dataclasses.replace(plan.stages[0], spatial_axes=(
                "model", None, None)),) + plan.stages[1:])
    flat = plan_lib.ParallelPlan(plan.stages, plan.mesh_axes, plan.n_layers)
    assert flat.group_layer_ranges() == ((0, plan.n_layers),)
    assert {flat.group_for(i) for i in range(plan.n_layers)} == {0}


# ------------------------------------------------------ the segments ----
@contextlib.contextmanager
def _fp64():
    """The port's models in fp64: convs by ``F.conv3d``, batch norm and
    the losses in fp64."""
    with mock.patch.object(conv_ops, "conv3d", _conv64), \
            mock.patch.object(dist_norm, "distributed_batchnorm", _bn64), \
            mock.patch.object(unet3d, "voxel_nll", _nll64), \
            mock.patch.object(cosmoflow, "mse", _mse64):
        yield


def _segment_vjp(fn, params, ins, couts, dtype=torch.float32):
    """``fn(params, *ins)``'s outputs (a list) and the gradients of
    ``params`` and ``ins`` (named ``in0``, ``in1``, ...) against the
    cotangents ``couts``, in ``dtype`` (fp64 under ``_fp64``)."""
    tp = {k: torch.as_tensor(v).to(dtype).requires_grad_(True)
          for k, v in params.items()}
    ti = [torch.as_tensor(v).to(dtype).requires_grad_(True) for v in ins]
    with (_fp64() if dtype == torch.float64 else contextlib.nullcontext()):
        outs = fn(tp, *ti)
        got = torch.autograd.grad(outs, list(tp.values()) + ti,
                                  [torch.as_tensor(c).to(dtype)
                                   for c in couts])
    names = list(tp) + [f"in{i}" for i in range(len(ti))]
    return ([o.detach().numpy() for o in outs],
            {n: g.numpy() for n, g in zip(names, got)})


def _hold_segment(fn, params, ins, couts, want_outs, want_grads):
    """Outputs within 1e-5 of their scale; gradients by ``_hold_leaves``
    against the fp64 segment."""
    outs, grads = _segment_vjp(fn, params, ins, couts)
    for got, want in zip(outs, want_outs):
        assert _scale_err(got, want) <= 1e-5
    _hold_leaves(grads, want_grads, lambda: _segment_vjp(
        fn, params, ins, couts, torch.float64)[1])


@pytest.mark.parametrize("a,b", [(0, 2), (2, 4), (1, 3), (0, 4)])
def test_forward_range_matches_the_references_vjp(a, b):
    """CosmoFlow's segment of plan layers [a, b) (the FC head with
    dropout when it covers it): output, parameter and input gradients
    against ``jax.vjp`` of the reference's ``forward_range``."""
    cfg, jcfg = _cfgs("cosmo")
    p = _params("cosmo")
    names = cosmoflow.segment_param_names(cfg, a, b)
    assert names == jcosmo.segment_param_names(jcfg, a, b)
    sub = {k: p[k].numpy() for k in names}
    shapes = [(cfg.input_width, cfg.in_channels)]
    for layer in perf_model.cosmoflow_layers(cfg):
        shapes.append((layer.width // layer.stride
                       // (2 if layer.pooled else 1), layer.cout))
    width, ch = shapes[a]
    r = np.random.RandomState(a * 10 + b)
    h = r.randn(4, width, width, width, ch).astype(np.float32)
    ids = list(range(6, 10))

    def jf(p_, h_):
        return jcosmo.forward_range(p_, h_, jcfg, a, b, train=True,
                                    dropout_rng=jax.random.PRNGKey(3),
                                    sample_ids=jnp.asarray(ids))

    jp = {k: jnp.asarray(v) for k, v in sub.items()}
    want = jax.jit(jf)(jp, jnp.asarray(h))
    g = r.randn(*want.shape).astype(np.float32)
    wp, wh = jax.jit(lambda p_, h_, g_: jax.vjp(jf, p_, h_)[1](g_))(
        jp, jnp.asarray(h), jnp.asarray(g))

    def fn(tp, th):
        return [cosmoflow.forward_range(
            tp, th, cfg, a, b, train=True, dropout_seed=3, sample_ids=ids,
            mask_source=jax_masks, precision="fp32")]

    _hold_segment(fn, sub, [h], [g], [want], dict(wp, in0=wh))


@pytest.mark.parametrize("a,b", [(0, 1), (1, 3), (0, 3), (1, 2)])
def test_unet_ranges_match_the_references_vjp(a, b):
    """The U-Net's descent (``down_range``: its activation and skips) and
    ascent (``up_range``) of levels [a, b) — fed by the descent itself
    when the range is the deepest group's (its core node), else by an
    activation of the level below's width and channels — against
    ``jax.vjp`` of the reference's."""
    cfg, jcfg = _cfgs("unet")
    p = _params("unet")
    dn, up = (unet3d.down_param_names(cfg, a, b),
              unet3d.up_param_names(cfg, a, b))
    assert dn == junet.down_param_names(jcfg, a, b)
    assert up == junet.up_param_names(jcfg, a, b)
    assert dn + up == unet3d.segment_param_names(cfg, a, b) == \
        junet.segment_param_names(jcfg, a, b)
    core = b > cfg.depth
    w = cfg.input_width // 2 ** a
    cin = cfg.in_channels if a == 0 else p[f"enc{a}_w0"].shape[3]
    r = np.random.RandomState(a * 10 + b)
    ins = [r.randn(2, w, w, w, cin).astype(np.float32)]
    if not core:  # the ascent's input from the level below
        wu = cfg.input_width // 2 ** b
        ins.append(r.randn(2, wu, wu, wu, p[f"dec{b - 1}_up"].shape[3])
                   .astype(np.float32))
    sub = {k: p[k].numpy() for k in dn + up}

    def jf(p_, h_, *u):
        h2, sk = junet.down_range({k: p_[k] for k in dn}, h_, jcfg, a, b)
        return h2, sk, junet.up_range({k: p_[k] for k in up},
                                      h2 if core else u[0], sk, jcfg, a, b)

    jp = {k: jnp.asarray(v) for k, v in sub.items()}
    jins = [jnp.asarray(t) for t in ins]
    wd, wsk, wu_ = jax.jit(jf)(jp, *jins)
    couts = [r.randn(*t.shape).astype(np.float32)
             for t in (wd, *wsk, wu_)]
    wp, *wins = jax.jit(lambda p_, c, *h_: jax.vjp(jf, p_, *h_)[1](c))(
        jp, (jnp.asarray(couts[0]), tuple(map(jnp.asarray, couts[1:-1])),
             jnp.asarray(couts[-1])), *jins)

    def fn(tp, th, *tu):
        d2, sk = unet3d.down_range({k: tp[k] for k in dn}, th, cfg, a, b)
        return [d2, *sk, unet3d.up_range({k: tp[k] for k in up},
                                         d2 if core else tu[0], sk, cfg,
                                         a, b)]

    _hold_segment(fn, sub, ins, couts, [wd, *wsk, wu_],
                  dict(wp, **{f"in{i}": v for i, v in enumerate(wins)}))


# --------------------------------------------- the pipelined step ----
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


def _mse64(pred, y, global_batch):
    return torch.sum(torch.mean(torch.square(pred - y), dim=-1)) / global_batch


def _fp64_oracle(name, x, y, seed=0):
    """The oracle's gradients in fp64 through the port's models (the
    convs by ``F.conv3d``, batch norm and the loss in fp64, the same
    masks): as near the exact gradient as the CPU computes."""
    cfg = _cfgs(name)[0]
    p = {k: v.double() for k, v in _params(name).items()}
    mb = GB // M
    total = None
    with mock.patch.object(conv_ops, "conv3d", _conv64), \
            mock.patch.object(dist_norm, "distributed_batchnorm", _bn64), \
            mock.patch.object(unet3d, "voxel_nll", _nll64), \
            mock.patch.object(cosmoflow, "mse", _mse64):
        for m in range(M):
            q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            xm = torch.from_numpy(x[m * mb:(m + 1) * mb]).double()
            ym = torch.from_numpy(y[m * mb:(m + 1) * mb])
            if name == "cosmo":
                loss = cosmoflow.mse_loss(
                    q, xm, ym.double(), cfg, global_batch=GB, train=True,
                    dropout_seed=seed, sample_ids=range(m * mb, (m + 1) * mb),
                    mask_source=jax_masks, precision="fp32")
            else:
                loss = unet3d.segmentation_loss(
                    q, xm, ym, cfg, global_voxels=GB * cfg.input_width ** 3,
                    precision="fp32")
            g = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
            total = g if total is None else {k: total[k] + g[k]
                                             for k in total}
    return {k: v.numpy() for k, v in total.items()}


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _hold_leaves(got, want, exact_fn, tol=1e-5):
    """Each leaf of ``got`` within ``tol`` of its max-abs from ``want``
    (the reference's) — or, where the reference's own leaf lies farther
    than that from the fp64 gradient (``exact_fn()``), nearer it than the
    reference and within ``tol`` of it (the rule of
    ``tests/test_torch_unet.py``)."""
    exact = None
    for k, g in got.items():
        if _scale_err(g, want[k]) <= tol:
            continue
        if exact is None:
            exact = exact_fn()
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(want[k], exact[k])
        assert port_err <= min(tol, ref_err), (k, port_err, ref_err)


def _oracle(name, x, y, seed=0):
    """The reference's oracle of a pipelined step's loss and gradients:
    the sum over the micro-batches of ``jax.value_and_grad`` of its loss
    on each (batch-norm over the micro-batch), normalized by the global
    batch, the rows' global ids and the step's dropout key."""
    cfg, jcfg = _cfgs(name)
    p = {k: jnp.asarray(v.numpy()) for k, v in _params(name).items()}
    mb = GB // M
    if name == "cosmo":
        def f(p_, xm, ym, ids):
            return jcosmo.mse_loss(p_, xm, ym, jcfg, global_batch=GB,
                                   train=True,
                                   dropout_rng=jax.random.PRNGKey(seed),
                                   sample_ids=ids)
    else:
        def f(p_, xm, ym, ids):
            del ids
            return junet.segmentation_loss(
                p_, xm, ym, jcfg, global_voxels=GB * cfg.input_width ** 3)
    vg = jax.jit(jax.value_and_grad(f))
    loss, grads = 0.0, None
    for m in range(M):
        sl = slice(m * mb, (m + 1) * mb)
        lm, gm = vg(p, jnp.asarray(x[sl]), jnp.asarray(y[sl]),
                    jnp.arange(m * mb, (m + 1) * mb))
        loss += float(lm)
        grads = gm if grads is None else jax.tree.map(jnp.add, grads, gm)
    return loss, {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_schedules_and_lowerings_are_bitwise(name, monkeypatch):
    """Two steps (M = 4 for CosmoFlow, 2 for the U-Net, as the
    reference's own tests run them): 1F1B, the sequential oracle,
    ``monolithic`` and 1F1B behind an emulated link latency give the
    same losses and parameters to the last bit; every boundary crossing
    counts ``pipe.cross_group`` (2 a micro-batch: the activation and its
    cotangent, 4 in the U-Net's V)."""
    micro = M if name == "cosmo" else 2
    base, base_l = _run_steps(name, _plan(name, micro))
    runs = {"sequential": _run_steps(name, _plan(name, micro,
                                                 schedule="sequential")),
            "monolithic": _run_steps(name, _plan(name, micro),
                                     grad_comm_="monolithic")}
    monkeypatch.setattr(flags, "PIPELINE_LINK_LATENCY_S", 0.002)
    tracer = trace_lib.enable()
    try:
        runs["latency"] = _run_steps(name, _plan(name, micro))
    finally:
        trace_lib.disable(tracer)
    for tag, (p, losses) in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(losses, base_l)), tag
        assert all(torch.equal(p[k], base[k]) for k in base), tag
    assert tracer.metrics.counter("pipe.cross_group").value == \
        2 * micro * (2 if name == "cosmo" else 4)
    spans = tracer.span_seconds()
    for s in ("pipe.place", "pipe.wait", "pipe.F", "pipe.FB", "pipe.B",
              "pipe.link", "pipe.update"):
        assert s in spans, s
    names = {e.thread for e in tracer.events() if e.name == "pipe.F"}
    assert all(n.startswith("pipe-dispatch") for n in names), names


@pytest.mark.parametrize("name", list(CASES))
def test_the_probes_nest(name):
    """``stage=`` gives ``_build_convnet_step``'s probes: ``fwd``,
    ``bwd``, ``grad_comm`` and ``step`` report step 1's loss to the
    same bits; ``bwd`` sums every shard's unreduced gradients, which
    add up to the sum of ``grad_comm``'s reduced ones (every
    parameter's)."""
    cfg = _cfgs(name)[0]
    plan = _plan(name, micro=2)
    x, y = map(torch.from_numpy, _batch(name, 9))
    p = _params(name)
    out = {}
    for stage in train_step.STAGES:
        fn, meshes, opt = _step(name, plan, stage=stage)
        out[stage] = fn(p, train_step.make_pipeline_opt_state(
            cfg, opt, p, plan=plan, meshes=meshes), x, y, 0)
    loss = out["step"][2]
    assert torch.equal(out["fwd"], loss)
    assert all(torch.equal(out[s][0], loss) for s in ("bwd", "grad_comm"))
    grads = out["grad_comm"][1]
    assert set(grads) == set(p)
    reduced = sum(g.sum() for g in grads.values())
    assert torch.allclose(out["bwd"][1], reduced, rtol=1e-4, atol=1e-5)


class _Poison(torch.autograd.Function):
    """The identity whose gradient is NaN."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


def test_guard_composes_across_groups(monkeypatch):
    """A clean guarded step applies (1.0); a NaN in one gradient of the
    loss group only (its last FC bias) holds BOTH groups' parameters and
    optimizer states bitwise (0.0)."""
    name = "cosmo"
    cfg = _cfgs(name)[0]
    plan = _plan(name, micro=2)
    step, meshes, opt = _step(name, plan, guard=True)
    p = _params(name)
    o = train_step.make_pipeline_opt_state(cfg, opt, p, plan=plan,
                                           meshes=meshes)
    x, y = map(torch.from_numpy, _batch(name, 3))
    p1, o1, _, applied = step(p, o, x, y, 0)
    assert float(applied) == 1.0
    assert not torch.equal(p1["conv0_w"], p["conv0_w"])
    real = cosmoflow.forward_range
    last = f"fc{len(cfg.fc_dims)}_b"

    def poisoned(params, h, cfg_, a, b, **kw):
        if last in params and torch.is_grad_enabled():
            params = dict(params, **{last: _Poison.apply(params[last])})
        return real(params, h, cfg_, a, b, **kw)

    monkeypatch.setattr(cosmoflow, "forward_range", poisoned)
    probe, _, _ = _step(name, plan, stage="grad_comm")
    _, grads = probe(p1, o1, x, y, 1)
    assert torch.isnan(grads[last]).all()
    assert all(bool(torch.isfinite(g).all()) for k, g in grads.items()
               if k in train_step.pipeline_group_params(cfg, plan, p)[0])
    p2, o2, loss, applied = step(p1, o1, x, y, 1)
    assert float(applied) == 0.0 and bool(torch.isfinite(loss))
    assert all(torch.equal(p2[k], p1[k]) for k in p1)
    for s2, s1 in zip(o2, o1):
        assert torch.equal(s2.step, s1.step)
        assert all(torch.equal(s2.m[k], s1.m[k]) for k in s1.m)
        assert all(torch.equal(s2.v[k], s1.v[k]) for k in s1.v)


def test_a_failing_dispatcher_ends_the_step(monkeypatch):
    """A shard of group 1 that raises ends the step with its error (the
    other dispatcher, blocked on the cotangent, is woken), and the step
    runs again afterwards."""
    name = "cosmo"
    cfg = _cfgs(name)[0]
    plan = _plan(name)
    step, meshes, opt = _step(name, plan)
    p = _params(name)
    o = train_step.make_pipeline_opt_state(cfg, opt, p, plan=plan,
                                           meshes=meshes)
    x, y = map(torch.from_numpy, _batch(name, 4))
    real = cosmoflow.mse

    def boom(*a, **k):
        raise FloatingPointError("shard failed")

    monkeypatch.setattr(cosmoflow, "mse", boom)
    with pytest.raises(FloatingPointError, match="shard failed"):
        step(p, o, x, y, 0)
    monkeypatch.setattr(cosmoflow, "mse", real)
    assert torch.isfinite(step(p, o, x, y, 0)[2])


def test_micro_backward_fires_bucketed_reductions():
    """The numeric half of the reference's
    ``test_micro_backward_fires_bucketed_reductions``: with ``overlap``,
    the backward of a non-last node (no batch norm, so every reduction is
    a gradient's; a segment of three blocks whose last weight is a big
    leaf of its own bucket) performs exactly
    ``make_plan(group params).num_buckets`` reductions a micro-batch, and
    one fires before that backward's last conv input gradient."""
    cfg = dataclasses.replace(configs.get_smoke_config("cosmoflow-512"),
                              conv_channels=(8, 64, 64), batchnorm=False)
    plan = plan_lib.pipelined_convnet_plan(cfg, boundaries=(3,),
                                           micro_batches=2,
                                           data_degrees=(2,))
    params = cosmoflow.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    gparams = train_step.pipeline_group_params(cfg, plan, params)[0]
    buckets = grad_comm.make_plan(gparams)
    assert buckets.num_buckets == 2  # the small leaves, and conv2_w
    meshes = mesh_lib.make_pipeline_meshes(plan, ["cpu"] * 4)
    opt = Adam(lr=constant(1e-3))
    step = train_step.make_pipeline_train_step(
        cfg, meshes, opt, plan=plan, global_batch=4, stage="grad_comm")
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(4, 32, 32, 32, 2).astype(np.float32))
    y = torch.from_numpy(r.randn(4, 4).astype(np.float32))
    tracer = trace_lib.enable()
    try:
        step(params, train_step.make_pipeline_opt_state(
            cfg, opt, params, plan=plan), x, y, 0)
    finally:
        trace_lib.disable(tracer)
    events = tracer.events()
    for span in [e for e in events if e.name == "pipe.B"
                 and e.attrs["node"] == 0]:
        inside = [e.name for e in sorted(events, key=lambda e: e.ts_ns)
                  if e.dur_ns is None and e.thread == span.thread
                  and span.ts_ns <= e.ts_ns <= span.ts_ns + span.dur_ns]
        assert inside.count("grad_comm.reduce") == buckets.num_buckets
        last_dx = max(i for i, n in enumerate(inside)
                      if n == "conv3d.input_grad")
        assert "grad_comm.reduce" in inside[:last_dx], inside
    assert len([e for e in events if e.name == "pipe.B"]) == 2


def test_m1_matches_the_unpipelined_step():
    """M = 1: one micro-batch is the batch, batch norm included: the
    pipelined ``grad_comm`` probe against the unpipelined step's at the
    same data degree (2 shards), the loss within 1e-5 and each leaf
    within 1e-5 of its max-abs."""
    for name in CASES:
        cfg = _cfgs(name)[0]
        plan = _plan(name, micro=1)
        probe, meshes, opt = _step(name, plan, stage="grad_comm")
        p = _params(name)
        x, y = map(torch.from_numpy, _batch(name, 5))
        loss, grads = probe(p, train_step.make_pipeline_opt_state(
            cfg, opt, p, plan=plan), x, y, 0)
        flat = plan_lib.legacy_convnet_plan(
            cfg, SpatialPartitioning(("model", None, None)), (1, 1, 1),
            data_degrees=(D,))
        mesh = mesh_lib.make_plan_mesh(flat, ["cpu"] * D)
        want_loss, want = train_step.make_convnet_phase_probes(
            cfg, mesh, opt, global_batch=GB, plan=flat,
            mask_source=jax_masks if name == "cosmo" else None)[
                "grad_comm"](p, opt.init(p), x, y, 0)
        assert abs(float(loss) - float(want_loss)) <= 1e-5
        for k in want:
            scale = float(want[k].abs().max())
            assert float((grads[k] - want[k]).abs().max()) <= 1e-5 * scale, k


WRAPPED = ((conv_ops, "conv3d_valid", "conv3d"),
           (conv_ops, "conv3d_input_grad", "conv3d_dgrad"),
           (bn_ops, "bn_leaky_relu", "bn_act"))


@pytest.mark.parametrize("name", list(CASES))
def test_launches_per_step_follow_kernel_launches(name, monkeypatch):
    """The kernel wrappers' calls in one pipelined step (each non-loss
    node's forward twice a micro-batch) equal what ``kernel_launches``
    derives for the plan, as the card's counters must."""
    calls = dict.fromkeys((key for _, _, key in WRAPPED), 0)
    lock = threading.Lock()

    def wrap(key, fn):
        def counted(*a, **k):
            with lock:
                calls[key] += 1
            return fn(*a, **k)
        return counted

    for mod, attr, key in WRAPPED:
        monkeypatch.setattr(mod, attr, wrap(key, getattr(mod, attr)))
    plan = _plan(name)
    _run_steps(name, plan, n=1)
    want = CASES[name][1].kernel_launches(_cfgs(name)[0], plan, train=True)
    assert calls == {k: want[k] for k in calls}
    assert want["pack"] == want["unpack"] == 0


# ------------------------------------------- time and memory models ----
MODEL_GRID = [("cosmoflow-128", ((0, 3), (3, 8))),
              ("cosmoflow-128", ((0, 1), (1, 5), (5, 8))),
              ("cosmoflow-512", ((0, 4), (4, 8))),
              ("cosmoflow-256", ((0, 7), (7, 8))),
              ("unet3d-256", ((0, 1), (1, 4))),
              ("unet3d-256", ((0, 2), (2, 3), (3, 4)))]


@pytest.mark.parametrize("model,ranges", MODEL_GRID)
def test_time_and_memory_models_are_the_references(model, ranges):
    """``group_param_counts`` and ``pipeline_iteration_time`` (V100,
    every micro-batch count, data degree, schedule, lowering and
    activation width), and the pipelined plans' ``plan_peak_bytes`` (the
    reference's integers, precision and schedule included)."""
    cfg, jcfg = configs.get_config(model), jconfigs.get_config(model)
    assert perf_model.group_param_counts(cfg, ranges) == \
        jperf.group_param_counts(jcfg, ranges)
    for m in (1, 2, 4, 8):
        for d in (1, 2, 4):
            for sched in plan_lib.PIPELINE_SCHEDULES:
                for gc in ("overlap", "monolithic"):
                    for act in (None, 2):
                        kw = dict(group_ranges=ranges, data_degree=d,
                                  micro_batches=m, global_batch=32,
                                  schedule=sched, grad_comm=gc,
                                  act_bytes=act)
                        got = perf_model.pipeline_iteration_time(
                            cfg, perf_model.V100, **kw)
                        want = jperf.pipeline_iteration_time(
                            jcfg, jperf.V100, **kw)
                        assert set(got) == set(want)
                        for k in want:
                            assert got[k] == pytest.approx(
                                want[k], rel=FLOAT_REL), (k, kw)
            cuts = tuple(b for _, b in ranges[:-1])
            for prec in ("fp32", "bf16"):
                for sched in plan_lib.PIPELINE_SCHEDULES:
                    kw = dict(boundaries=cuts, micro_batches=m,
                              schedule=sched, data_degrees=(2,))
                    got = memory.plan_peak_bytes(
                        cfg, plan_lib.pipelined_convnet_plan(cfg, **kw),
                        global_batch=32, precision=prec)
                    want = jmemory.plan_peak_bytes(
                        jcfg, jplan.pipelined_convnet_plan(jcfg, **kw),
                        global_batch=32, precision=prec)
                    assert dataclasses.astuple(got) == \
                        dataclasses.astuple(want), (m, prec, sched)
                    assert plan_lib.price_plan(
                        cfg, perf_model.V100,
                        plan_lib.pipelined_convnet_plan(cfg, **kw),
                        global_batch=32) == pytest.approx(jplan.price_plan(
                            jcfg, jperf.V100,
                            jplan.pipelined_convnet_plan(jcfg, **kw),
                            global_batch=32), rel=FLOAT_REL)


def _names_costs(plans):
    return [(p.name, p.cost) for p in plans]


def test_planner_pipeline_choices_are_the_references():
    """The reference's two planner tests on the port: the joint argmin
    never picks a pipelined plan priced above the best unpipelined one,
    and a budget only the pipelined split fits forces it; the candidates
    (names and costs) and both choices equal the reference's, on V100
    and on the U-Net too."""
    for model in ("cosmoflow-512", "unet3d-256", "cosmoflow-128"):
        cfg, jcfg = configs.get_config(model), jconfigs.get_config(model)
        kw = dict(pipeline_degrees=(2, 4), micro_batch_options=(2, 8),
                  num_devices=8, global_batch=32)
        got = plan_lib.candidate_pipeline_plans(cfg, perf_model.V100, **kw)
        want = jplan.candidate_pipeline_plans(jcfg, jperf.V100, **kw)
        assert [p.name for p in got] == [p.name for p in want]
        assert [p.cost for p in got] == pytest.approx(
            [p.cost for p in want], rel=FLOAT_REL)
        assert plan_lib.candidate_pipeline_plans(
            cfg, perf_model.V100, grad_comm="reduce_scatter", **kw) == []
        pkw = dict(spatial_degree=1, data_degree=8, global_batch=32,
                   grad_comm="overlap", pipeline_options=(2,),
                   micro_batch_options=(8,))
        joint = plan_lib.plan_convnet(cfg, perf_model.V100, **pkw)
        jjoint = jplan.plan_convnet(jcfg, jperf.V100, **pkw)
        assert joint.name == jjoint.name
        assert joint.cost == pytest.approx(jjoint.cost, rel=FLOAT_REL)
        for budget in (100, 20):
            bkw = dict(pkw, memory_budget_bytes=budget * 2 ** 30)
            try:
                chosen = plan_lib.plan_convnet(cfg, perf_model.V100, **bkw)
            except ValueError as e:
                with pytest.raises(ValueError) as je:
                    jplan.plan_convnet(jcfg, jperf.V100, **bkw)
                assert str(e) == str(je.value)
                continue
            jchosen = jplan.plan_convnet(jcfg, jperf.V100, **bkw)
            assert chosen.name == jchosen.name
            assert chosen.cost == pytest.approx(jchosen.cost, rel=FLOAT_REL)
    cfg = configs.get_config("cosmoflow-512")
    base = plan_lib.plan_convnet(cfg, perf_model.V100, spatial_degree=1,
                                 data_degree=8, global_batch=32)
    joint = plan_lib.plan_convnet(
        cfg, perf_model.V100, spatial_degree=1, data_degree=8,
        global_batch=32, pipeline_options=(2,), micro_batch_options=(8,))
    assert joint.n_groups == 1 and joint.cost == base.cost
    forced = plan_lib.plan_convnet(
        cfg, perf_model.V100, spatial_degree=1, data_degree=8,
        global_batch=32, memory_budget_bytes=100 * 2 ** 30,
        pipeline_options=(2,), micro_batch_options=(8,))
    assert forced.n_groups == 2 and forced.pipeline.micro_batches == 8
    assert memory.plan_peak_bytes(cfg, forced, global_batch=32).total <= \
        100 * 2 ** 30


# ---------------------------------------------------- config, session ----
ERRORS = [dict(data=4, pipeline=3), dict(data=4, pipeline=2, spatial=2),
          dict(data=4, pipeline=0), dict(data=3, pipeline=2),
          dict(data=4, pipeline=2, grad_comm="reduce_scatter"),
          dict(data=4, pipeline=2, precision="fp16"),
          dict(data=4, pipeline=2, grad_clip=1.0),
          dict(data=4, pipeline=2, micro_batches=3),
          dict(data=4, pipeline=2, micro_batches=8),
          dict(data=4, pipeline=2, micro_batches=0),
          dict(data=4, pipeline=2, pipeline_schedule="gpipe"),
          dict(data=4, pipeline=9),
          dict(data=4, pipeline=2, mode="infer")]


@pytest.mark.parametrize("kw", ERRORS)
def test_runconfig_pipeline_errors_are_the_references(kw):
    """The reference's ``test_runconfig_pipeline_field_errors`` and
    more: the same field, problem and fix."""
    cfg = configs.get_smoke_config("cosmoflow-512")
    jcfg = jconfigs.get_smoke_config("cosmoflow-512")
    with pytest.raises(RunConfigError) as e:
        RunConfig(model=cfg, global_batch=8, **kw).validate(device_count=8)
    with pytest.raises(JRunConfigError) as je:
        JRunConfig(model=jcfg, global_batch=8, **kw).validate(
            device_count=8)
    assert (e.value.field, e.value.problem) == (je.value.field,
                                                je.value.problem)
    RunConfig(model=cfg, global_batch=8, data=4, pipeline=2).validate(
        device_count=8)


def test_profile_report_evaluate_and_the_planned_sessions():
    """``profile`` times the step under its schedule and the sequential
    oracle; ``report`` sets the measured step beside the pipelined time
    model; ``evaluate`` runs the whole model on group 0; ``plan="fixed"``
    with ``pipeline=2`` is the cheapest split on H100, ``"auto"`` the
    joint argmin with the config's schedule."""
    with _port_session("unet", trace=True) as sess:
        prof = sess.profile(reps=1)
        assert {"step", "step_sequential", "pipeline_speedup"} <= set(prof)
        assert prof["pipeline_speedup"] == pytest.approx(
            prof["step_sequential"] / prof["step"])
        rows = {r.phase: r for r in sess.report().rows}  # profile's spans
        assert rows["step"].measured_s is not None and rows["step"].modeled_s
        assert rows["fwd"].measured_s is None and rows["fwd"].modeled_s
        x, y = map(torch.from_numpy, _batch("unet", 6))
        loss, logits = sess.evaluate(x, y)
        assert logits.shape == (GB, 16, 16, 16, 3) and torch.isfinite(loss)
    cfg = configs.get_smoke_config("cosmoflow-512")
    kw = dict(model=cfg, global_batch=GB, data=2, pipeline=2,
              micro_batches=2, grad_clip=0.0)
    with compile(RunConfig(**kw, pipeline_schedule="sequential"),
                 devices=["cpu"] * 2) as sess:
        want = min(plan_lib.candidate_pipeline_plans(
            cfg, perf_model.H100, pipeline_degrees=(2,),
            micro_batch_options=(2,), num_devices=2, global_batch=GB,
            schedule="sequential"), key=lambda p: p.cost)
        assert sess.plan == want and sess.plan.name.endswith(".sequential")
    with compile(RunConfig(**kw, plan="auto"), devices=["cpu"] * 2) as sess:
        want = plan_lib.plan_convnet(
            cfg, perf_model.H100, spatial_degree=1, data_degree=2,
            global_batch=GB, grad_comm="overlap", pipeline_options=(2,),
            micro_batch_options=(2,))
        assert sess.plan.name == want.name
        assert torch.isfinite(sess.step(*map(torch.from_numpy,
                                              _batch("cosmo", 7))))


def test_cli_trains_at_pipeline_2(tmp_path):
    """The drivers' flags: ``--pipeline 2 --data 2 --micro-batches 2``
    compiles a two-group session that steps, saves and describes
    itself."""
    ap = argparse.ArgumentParser()
    cli.add_session_args(ap)
    args = ap.parse_args(["--pipeline", "2", "--data", "2",
                          "--micro-batches", "2", "--grad-clip", "0",
                          "--batch", "4", "--ckpt", str(tmp_path / "ck"),
                          "--device", "cpu"])
    config = cli.config_from_args(RunConfig(model=_cfgs("unet")[0]), args)
    assert (config.pipeline, config.micro_batches) == (2, 2)
    with compile(config, **cli.placement(
            args, config.data * config.spatial)) as sess:
        assert sess.plan.n_groups == 2 and sess.mesh.size == 1
        r = np.random.RandomState(8)
        loss = sess.step(r.randn(4, 16, 16, 16, 1).astype(np.float32),
                         r.randint(0, 3, (4, 16, 16, 16)).astype(np.int32))
        assert torch.isfinite(loss)
        sess.save()
        assert "pipeline: 2 groups" in str(sess.describe())
    assert os.path.exists(tmp_path / "ck" / "run_config.json")


# ------------------------- against the reference's pipelined runs ----
@pytest.mark.parametrize("name", list(CASES))
def test_step1_matches_the_reference_oracle(name, reference):
    """The ``grad_comm`` probe of the pipelined step (M = 4, 1F1B,
    ``overlap``, 2 shards a group): step 1's loss and the merged reduced
    gradients against the reference's per-micro-batch oracle, each leaf
    within 1e-5 of its max-abs; the loss against the reference's
    pipelined step's step 1 on the same parameters and batch."""
    plan = _plan(name)
    step, meshes, opt = _step(name, plan, stage="grad_comm")
    x, y = reference.result()["arrays"][f"{name}_x1"], \
        reference.result()["arrays"][f"{name}_y1"]
    p = _params(name)
    o = train_step.make_pipeline_opt_state(_cfgs(name)[0], opt, p,
                                           plan=plan, meshes=meshes)
    loss, grads = step(p, o, torch.from_numpy(x), torch.from_numpy(y), 0)
    want_loss, want = _oracle(name, x, y)
    assert set(grads) == set(want) == set(p)
    _hold_leaves({k: v.numpy() for k, v in grads.items()}, want,
                 lambda: _fp64_oracle(name, x, y))
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    ref = float(reference.result()[f"{name}_loss1"])
    assert abs(float(loss) - ref) <= 1e-5 * abs(ref), (float(loss), ref)


@pytest.mark.parametrize("name", list(CASES))
def test_session_describe_is_the_references(name, reference):
    """A pipelined ``Session`` on the same pinned plan: every field of
    ``describe()`` the reference's (its predicted step priced on the
    reference's V100 beside the port's H100), the pipeline lines of its
    text too."""
    want = json.loads(str(reference.result()[f"{name}_describe"]))
    with _port_session(name) as sess:
        rep = sess.describe()
        assert rep.plan_name == want["plan_name"]
        assert [list(map(lambda v: list(v) if isinstance(v, tuple) else v,
                         s)) for s in rep.stages] == want["stages"]
        assert rep.mesh_shape == want["mesh_shape"] == {"data": D}
        for key in ("precision", "grad_comm", "global_batch", "param_count",
                    "micro_batches", "pipeline_schedule",
                    "bubble_fraction"):
            assert getattr(rep, key) == want[key], key
        assert [list(g) for g in rep.group_devices] == \
            want["group_devices"]
        assert list(rep.stage_groups) == want["stage_groups"]
        assert list(dataclasses.astuple(rep.modeled_peak)) == \
            want["modeled_peak"]
        priced = plan_lib.price_plan(sess.cfg, perf_model.V100, sess.plan,
                                     global_batch=GB)
        assert priced == pytest.approx(want["predicted_step_s"],
                                       rel=FLOAT_REL)
        assert rep.predicted_step_s == plan_lib.price_plan(
            sess.cfg, perf_model.H100, sess.plan, global_batch=GB)
        assert str(rep).split("\n")[3:5] == want["lines"]
        assert len(sess.meshes) == 2 and sess.mesh is sess.meshes[0]


def test_checkpoints_round_trip_and_cross_packages(reference, tmp_path):
    """A port pipelined checkpoint resumes bitwise in the port and in the
    reference (its next loss within 1e-5 of the port's); the
    reference's, saved after its step 1, resumes in the port with the
    reference's step-2 loss within 1e-5; the embedded run records the
    groups and micro-batches."""
    out = reference.result()
    arrays = out["arrays"]
    with _port_session("cosmo") as sess:
        sess.step(arrays["cosmo_x1"], arrays["cosmo_y1"])
        sess.save(str(tmp_path / "ck"))
        want = sess.step(arrays["cosmo_x2"], arrays["cosmo_y2"])
        assert float(want) == out["port_next"]
    with Session.restore(str(tmp_path / "ck"), devices=["cpu"] * 4,
                         mask_source=jax_masks) as again:
        assert again.plan.n_groups == 2
        assert again.plan.pipeline.micro_batches == M
        assert isinstance(again.opt_state, tuple)
        assert torch.equal(again.step(arrays["cosmo_x2"],
                                      arrays["cosmo_y2"]), want)
    blob = open(tmp_path / "ck" / "run_config.json").read()
    assert "stage_groups" in blob and "micro_batches" in blob
    assert int(out["resumed_step"]) == 1 and int(out["resumed_groups"]) == 2
    assert abs(float(out["resumed_loss"]) - out["port_next"]) <= \
        1e-5 * abs(out["port_next"])
    for name in CASES:
        with Session.restore(out["ckpt_ref"] + name, devices=["cpu"] * 4,
                             mask_source=jax_masks if name == "cosmo"
                             else None) as sess:
            assert sess.step_count == 1 and sess.plan.n_groups == 2
            got = float(sess.step(arrays[f"{name}_x2"],
                                  arrays[f"{name}_y2"]))
        ref = float(out[f"{name}_loss2"])
        assert abs(got - ref) <= 1e-5 * abs(ref), (name, got, ref)
