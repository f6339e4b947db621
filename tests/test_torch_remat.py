"""Rematerialization in the port (``core/spmd.checkpoint``, the models'
``remat`` stages) against the no-remat step and the reference, on the
CPU.

* at 1 x 1, for CosmoFlow and the U-Net: remat on against off — the
  loss within 1e-5, each gradient within atol 1e-5, rtol 1e-4 (the
  reference's ``test_remat_grad_parity_single_device``) — and the port's
  remat gradients against the reference's (``jax.value_and_grad``
  through its ``jax.checkpoint``-ed blocks) at the tolerance
  ``tests/test_torch_train.py`` and ``tests/test_torch_unet.py`` hold
  the port's step to;
* which blocks recompute (counted by the kernel wrappers' calls against
  ``kernel_launches(train=True)``): none, all, a first-stage-only plan's
  one, all under ``flags.REMAT`` with no plan marks, and the plan's one
  when the plan marks a stage (the reference's
  ``test_remat_jaxpr_structure_and_flag_fallback``);
* on in-process meshes of 1 x 2, 1 x 4 and 2 x 2 (``["cpu"] * n``), for
  both models, with ``grad_comm`` ``overlap`` and ``monolithic``: the
  ``grad_comm`` probe's loss and reduced gradients with every block
  rematerialized against without, under the same contract, and the
  launches of the step (the recompute included) against
  ``kernel_launches``. A recompute that ran each shard alone — zero
  halos, local batch-norm statistics — fails here;
* the bytes one step saves for the backward
  (``torch.autograd.graph.saved_tensors_hooks``): with every block
  rematerialized, the activations saved are exactly the blocks' inputs
  (CosmoFlow), and the total falls by what the blocks saved inside;
* a CosmoFlow train ``Session`` on a pinned remat plan checkpoints its
  blocks (a plan with remat stages once trained silently without).
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

from repro.configs import cosmoflow as jcosmo_cfg
from repro.configs import unet3d as junet_cfg
from repro.core import plan as jplan_lib
from repro.models import cosmoflow as jcosmo
from repro.models import unet3d as junet
from repro_torch.api import RunConfig, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.core import dist_norm, flags
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cosmoflow, unet3d
from repro_torch.optim.adam import Adam, constant
from repro_torch.train import train_step

GB = 4
COSMO = dataclasses.replace(cosmo_cfg.SMOKE, input_width=16)
JCOSMO = dataclasses.replace(jcosmo_cfg.SMOKE, input_width=16)
MODELS = {"cosmoflow": (COSMO, JCOSMO, cosmoflow, jcosmo),
          "unet3d": (unet_cfg.SMOKE, junet_cfg.SMOKE, unet3d, junet)}
MESHES = [(1, 2), (1, 4), (2, 2)]
WRAPPED = ((conv_ops, "conv3d_valid", "conv3d"),
           (conv_ops, "conv3d_input_grad", "conv3d_dgrad"),
           (bn_ops, "bn_leaky_relu", "bn_act"),
           (pack_ops, "pack", "pack"), (pack_ops, "unpack", "unpack"))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its shards are threads already, and beside other test workers a
    thread pool a shard only contends (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _with_remat(plan, flag=True):
    return dataclasses.replace(plan, stages=tuple(
        dataclasses.replace(s, remat=flag) for s in plan.stages))


def _batch(cfg, seed=0):
    r = np.random.RandomState(seed)
    w = cfg.input_width
    x = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
    if cfg.arch == "unet3d":
        y = r.randint(0, cfg.out_dim, (GB, w, w, w)).astype(np.int32)
    else:
        y = r.randn(GB, cfg.out_dim).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _ref_params(name, seed=2):
    cfg, jcfg, _, jmodel = MODELS[name]
    p = {k: np.asarray(v) for k, v in jax.jit(
        lambda k: jmodel.init_params(k, jcfg))(
            jax.random.PRNGKey(seed)).items()}
    r = np.random.RandomState(seed)
    for k in p:  # non-trivial BN scales and biases
        if p[k].ndim == 1:
            p[k] = (p[k] + 0.1 * r.randn(*p[k].shape)).astype(np.float32)
    return p


def _port_loss(name, params, x, y, plan):
    cfg, _, model, _ = MODELS[name]
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    if name == "unet3d":
        return unet3d.segmentation_loss(params, x, y, cfg, plan=plan,
                                        global_voxels=GB * cfg.input_width
                                        ** 3)
    return cosmoflow.mse_loss(params, x, y, cfg, plan=plan, global_batch=GB,
                              train=False)


def _port_grads(name, p, x, y, plan):
    cfg, _, model, _ = MODELS[name]
    leaves = {k: v.requires_grad_(True) for k, v in model.params_from_numpy(
        p, "cpu", cfg=cfg).items()}
    loss = _port_loss(name, leaves, x, y, plan)
    return loss.item(), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def _scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1e-12, np.max(np.abs(want)))


def _conv64(x, w, stride=1, pads=((0, 0),) * 3):
    return torch.nn.functional.conv3d(
        torch.nn.functional.pad(x.permute(0, 4, 1, 2, 3),
                                [v for p in reversed(pads) for v in p]),
        w.permute(4, 3, 0, 1, 2), stride=stride).permute(0, 2, 3, 4, 1)


def _bn64(x, scale, bias, reduce_axes=(), eps=1e-5, activation_slope=None):
    m = x.mean(dim=(0, 1, 2, 3))
    v = x.var(dim=(0, 1, 2, 3), unbiased=False)
    y = (x - m) / torch.sqrt(v + eps) * scale + bias
    if activation_slope is None:
        return y
    return torch.where(y >= 0, y, activation_slope * y)


# ------------------------------------------------------------- 1 x 1 ----
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_matches_no_remat_and_the_reference_on_one_device(name):
    cfg, jcfg, model, jmodel = MODELS[name]
    base = plan_lib.uniform_plan(cfg, spatial_axes=(None, None, None))
    jbase = jplan_lib.uniform_plan(jcfg, spatial_axes=(None, None, None))
    assert base.name == jbase.name and not base.uses_remat
    assert plan_lib.plan_remat_schedule(cfg, _with_remat(base)) == \
        jplan_lib.plan_remat_schedule(jcfg, _with_remat(jbase))
    p = _ref_params(name)
    x, y = _batch(cfg)
    l0, g0 = _port_grads(name, p, x, y, base)
    l1, g1 = _port_grads(name, p, x, y, _with_remat(base))
    assert abs(l0 - l1) <= 1e-5
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)

    def jloss(params):
        if name == "unet3d":
            return junet.segmentation_loss(
                params, jnp.asarray(x), jnp.asarray(y), jcfg,
                plan=_with_remat(jbase), global_voxels=GB * W3(cfg))
        return jcosmo.mse_loss(params, jnp.asarray(x), jnp.asarray(y), jcfg,
                               plan=_with_remat(jbase), global_batch=GB,
                               train=False)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in p.items()})
    assert abs(l1 - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    exact = None
    for k, g in g1.items():
        if _scale_err(g, want[k]) <= 1e-5:
            continue
        if exact is None:  # the fp64 gradients, as test_torch_unet.py
            with mock.patch.object(conv_ops, "conv3d", _conv64), \
                    mock.patch.object(dist_norm, "distributed_batchnorm",
                                      _bn64):
                exact = _port_grads(name, {k: v.astype(np.float64)
                                           for k, v in p.items()},
                                    x.astype(np.float64), y, base)[1]
        port_err = _scale_err(g, exact[k])
        ref_err = _scale_err(np.asarray(want[k]), exact[k].numpy())
        assert port_err <= min(1e-5, ref_err), (k, port_err, ref_err)


def W3(cfg):
    return cfg.input_width ** 3


# -------------------------------------------------- structure, flag ----
def _counted(monkeypatch):
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
    return calls


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_structure_and_flag_fallback(monkeypatch, name):
    """Recomputed convs (bn_act calls beyond the forward's) per plan:
    none, every block, the first stage's block only, every block under
    ``flags.REMAT`` with no plan marks, and the plan's marks over the
    flag; ``plan_remat_schedule`` marks exactly the recomputed convs."""
    cfg, _, model, _ = MODELS[name]
    base = plan_lib.uniform_plan(cfg, spatial_axes=(None, None, None))
    # plan remat on a first stage covering plan layer 0 only
    one = dataclasses.replace(base, stages=(
        dataclasses.replace(base.stages[0], stop=1, remat=True),
        dataclasses.replace(base.stages[0], start=1)) + base.stages[1:])
    assert one.uses_remat and not base.uses_remat
    calls = _counted(monkeypatch)
    p = _ref_params(name)
    x, y = _batch(cfg, 1)
    n = len(model.conv_shapes(cfg, 1))
    per_block = 2 if name == "unet3d" else 1  # a level's pair: two convs

    def recomputed(plan):
        for key in calls:
            calls[key] = 0
        _port_grads(name, p, x, y, plan)
        assert calls == model.kernel_launches(cfg, plan, train=True)
        # the per-layer schedule states the rule the models follow
        assert sum(plan_lib.plan_remat_schedule(cfg, plan)) == \
            calls["bn_act"] - n
        return calls["bn_act"] - n

    n_blocks = n // per_block
    assert recomputed(base) == 0
    assert recomputed(_with_remat(base)) == n
    if name == "unet3d":  # level 0: its encoder and its decoder pair
        assert recomputed(one) == 2 * per_block
    else:
        assert recomputed(one) == 1
    monkeypatch.setattr(flags, "REMAT", True)
    assert recomputed(base) == n == n_blocks * per_block
    assert recomputed(one) == (2 * per_block if name == "unet3d" else 1)


# ------------------------------------------------------------ meshes ----
def _probe(name, D, S, plan, grad_comm):
    cfg = MODELS[name][0]
    mesh = Mesh(plan.mesh_axes, ["cpu"] * (D * S))
    return train_step.make_convnet_phase_probes(
        cfg, mesh, Adam(lr=constant(1e-3)), global_batch=GB, plan=plan,
        grad_comm=grad_comm)["grad_comm"]


@pytest.mark.parametrize("grad_comm", ["overlap", "monolithic"])
@pytest.mark.parametrize("D,S", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_matches_no_remat_on_in_process_meshes(monkeypatch, name, D, S,
                                                     grad_comm):
    cfg, _, model, _ = MODELS[name]
    base = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (S, 1, 1),
        data_degrees=(D,))
    p = model.init_params(cfg, torch.Generator().manual_seed(D * S), "cpu")
    x, y = (torch.from_numpy(a) for a in _batch(cfg, 3))
    calls = _counted(monkeypatch)
    out = {}
    for tag, plan in (("off", base), ("on", _with_remat(base))):
        for key in calls:
            calls[key] = 0
        loss, grads = _probe(name, D, S, plan, grad_comm)(p, None, x, y, 0)
        assert calls == model.kernel_launches(cfg, plan, train=True), tag
        out[tag] = loss.item(), grads
    assert calls["conv3d"] > model.kernel_launches(cfg, base, True)["conv3d"]
    (l0, g0), (l1, g1) = out["off"], out["on"]
    assert abs(l0 - l1) <= 1e-5
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


# ------------------------------------------------------- saved bytes ----
def _saved(name, p, x, y, plan):
    """Bytes of the distinct storages one step saves for its backward:
    {"params", "acts" (other 5-D tensors), "other"}."""
    cfg, _, model, _ = MODELS[name]
    leaves = {k: v.requires_grad_(True) for k, v in model.params_from_numpy(
        p, "cpu", cfg=cfg).items()}
    params = {v.untyped_storage().data_ptr() for v in leaves.values()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        kind = ("params" if st.data_ptr() in params
                else "acts" if t.dim() == 5 else "other")
        if seen.get(st.data_ptr(), ("", ""))[1] != "acts":
            seen[st.data_ptr()] = (st.nbytes(), kind)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = _port_loss(name, leaves, x, y, plan)
    torch.autograd.grad(loss, list(leaves.values()))
    out = dict.fromkeys(("params", "acts", "other"), 0)
    for nbytes, kind in seen.values():
        out[kind] += nbytes
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_saved_bytes_fall_to_the_block_inputs(name):
    cfg, _, model, _ = MODELS[name]
    base = plan_lib.uniform_plan(cfg, spatial_axes=(None, None, None))
    p = _ref_params(name)
    x, y = _batch(cfg, 4)
    off = _saved(name, p, x, y, base)
    on = _saved(name, p, x, y, _with_remat(base))
    inputs = [s[0] for s in model.conv_shapes(cfg, GB)]
    if name == "cosmoflow":
        # the activations a remat step saves are the blocks' inputs (the
        # last block's output is saved as the FC head's 2-D input)
        assert on["acts"] == 4 * sum(int(np.prod(s)) for s in inputs)
    else:
        # the pairs' inputs, and outside the pairs the pools' winners, the
        # up-convolutions' and the head's inputs
        assert on["acts"] >= 4 * sum(int(np.prod(s)) for s in inputs[0::2])
    assert on["params"] == off["params"]
    assert on["other"] <= off["other"]  # the blocks' statistics
    assert on["acts"] < off["acts"]
    total = sum(off.values()) - sum(on.values())
    assert total >= off["acts"] - on["acts"] > 0


# --------------------------------------------------------- sessions ----
def test_a_train_session_on_a_pinned_remat_plan_checkpoints_its_blocks(
        monkeypatch):
    """A CosmoFlow train ``Session`` compiled on a plan whose stages set
    ``remat`` recomputes those blocks (it once trained silently without),
    and its step equals the no-remat session's."""
    calls = _counted(monkeypatch)
    base = plan_lib.legacy_convnet_plan(
        cosmo_cfg.SMOKE, SpatialPartitioning(("model", None, None)),
        (2, 1, 1))
    x, y = _batch(cosmo_cfg.SMOKE, 5)
    got = {}
    for tag, plan in (("off", base), ("on", _with_remat(base))):
        with compile(RunConfig(model="cosmoflow-128", smoke=True,
                               global_batch=GB, spatial=2, plan=plan),
                     devices=["cpu"] * 2) as sess:
            assert sess.describe().stages[0][-1] == (tag == "on")
            for key in calls:
                calls[key] = 0
            got[tag] = float(sess.step(x, y)), sess.params
            assert calls == cosmoflow.kernel_launches(
                cosmo_cfg.SMOKE, sess.plan, train=True)
            blocks = cosmoflow.num_blocks(cosmo_cfg.SMOKE)
            assert calls["bn_act"] == 2 * blocks * (2 if tag == "on" else 1)
    assert got["on"][0] == got["off"][0]
    for k, v in got["off"][1].items():
        np.testing.assert_allclose(got["on"][1][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
