"""ZeRO-1 (``grad_comm="reduce_scatter"``) through the port against the
reference, on the CPU (every shard a thread on ``"cpu"``).

* ``reduce_scatter_grads``, ``param_shards``, ``all_gather_params`` and
  ``init_sharded_opt_state`` on a seeded tree under a small
  ``BucketPolicy`` at N = 1, 2, 4 (every shard its own gradients),
  against the reference's under ``shard_map``: the same chunks, shard
  lengths and padding;
* ``monolithic``, ``overlap`` and ``reduce_scatter`` at 2 x 1, 4 x 1 and
  2 x 2 on the SMOKE config: the parameters after 2 steps from the
  reference's initial parameters, with its dropout masks, within atol
  1e-5, rtol 1e-4 of the reference's ``reduce_scatter`` run (the
  reference's own contract between the modes, ``tests/test_grad_comm.py``);
  the U-Net SMOKE at 2 x 2; the three lowerings bitwise equal to one
  another (each sums the spatial peers first, then the data shards);
* each shard holds exactly its 1/N of Adam's state, spatial peers the
  same chunk; an fp16 overflow in one data index's batch rows vetoes the
  step on every shard under the guard and backs the loss scale off;
* checkpoints both ways: a port 2 x 2 save resumed by the reference's
  ``Session`` (its buckets placed under the recorded spec), a reference
  save resumed by the port, and ``Session.restore`` resuming bitwise.

The reference runs once, in a subprocess with 4 forced host devices.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.core import grad_comm, spmd
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.core.tree import leaves
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cosmoflow, unet3d
from repro_torch.optim.adam import Adam, constant
from repro_torch.train import train_step

from conftest import SRC

GB = 4
MESHES = [(2, 1), (4, 1), (2, 2)]
MODES = ("monolithic", "overlap", "reduce_scatter")
ATOL, RTOL = 1e-5, 1e-4
# a tree whose buckets under POLICY pad at N = 4: two big leaves and
# small ones coalescing in name order, closed at 700 bytes
SHAPES = {"a": (10,), "b": (40, 40), "c": (90,), "d": (99,), "e": (5,),
          "f": (3, 7), "g": (7, 20)}
POLICY = dict(small_thresh_elems=100, target_bucket_bytes=700)

REFERENCE = r'''
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import api
from repro.core import compat, grad_comm
from repro.optim.adam import Adam, constant
from repro.models import cosmoflow, unet3d


def _at_once(init):
    """``init`` as one program at XLA's optimization level 0: run op by
    op it compiles each random draw on its own (the U-Net's take ~30 s
    on the CPU; this, ~2 s), and it draws the same values within an ulp.
    The port starts from whatever parameters the reference started
    from. Under a trace, as in eval_shape, ``init`` runs as it is."""
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
# the ZeRO-1 functions, every shard with its own gradients
policy = grad_comm.BucketPolicy(**POLICY)
r = np.random.RandomState(0)
tree = {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
plan = grad_comm.make_plan(tree, policy)
for k, v in tree.items():
    out["tree_" + k] = v
for N in (1, 2, 4):
    mesh = compat.make_mesh((N,), ("data",))
    grads = {k: r.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
    for k, v in grads.items():
        out[f"g{N}_{k}"] = v

    def f(g, p):
        g = jax.tree.map(lambda t: t[0], g)
        shards = grad_comm.reduce_scatter_grads(g, plan, ("data",))
        return (shards, grad_comm.param_shards(p, plan, ("data",)),
                grad_comm.all_gather_params(shards, plan, ("data",), p))

    shards, pshards, back = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(P("data"), P()),
        out_specs=(P("data"), P("data"), P())))(grads, tree)
    for i, (s, p) in enumerate(zip(shards, pshards)):
        out[f"rs{N}_{i}"] = np.asarray(s)
        out[f"ps{N}_{i}"] = np.asarray(p)
    for k, v in back.items():
        out[f"back{N}_{k}"] = np.asarray(v)
    st = grad_comm.init_sharded_opt_state(Adam(lr=constant(1e-3)), plan,
                                          num_shards=N)
    out[f"state{N}"] = np.asarray([l.size for l in jax.tree.leaves(st)])


def batch(seed, unet=False):
    r = np.random.RandomState(seed)
    if unet:
        return (r.randn(GB, 16, 16, 16, 1).astype(np.float32),
                r.randint(0, 3, (GB, 16, 16, 16)).astype(np.int32))
    return (r.randn(GB, 32, 32, 32, 2).astype(np.float32),
            r.randn(GB, 4).astype(np.float32))


# reduce_scatter sessions: the initial parameters, 2 steps
for name, D, S in RUNS:
    unet = name == "unet"
    sess = api.compile(api.RunConfig(
        model="unet3d-256" if unet else "cosmoflow-128", smoke=True,
        global_batch=GB, data=D, spatial=S, grad_comm="reduce_scatter"))
    tag = f"{name}_{D}_{S}"
    for k, v in sess.params.items():
        out[f"init_{tag}_{k}"] = np.asarray(v)
    for i in range(2):
        x, y = batch(20 + i, unet)
        loss = sess.step(jnp.asarray(x), jnp.asarray(y))
    for k, v in sess.params.items():
        out[f"final_{tag}_{k}"] = np.asarray(v)
    if (name, D, S) == ("cosmo", 2, 2):  # a checkpoint the port resumes
        sess.save(CKPT_REF)
        x, y = batch(22)
        out["ref_next"] = np.asarray(sess.step(jnp.asarray(x),
                                               jnp.asarray(y)))
    sess.close()

# the port's 2 x 2 checkpoint, resumed for one step
sess = api.Session.restore(CKPT_PORT)
out["resumed_step"] = np.asarray(sess.step_count)
out["resumed_specs"] = np.asarray([str(l.sharding.spec) for l in
                                   jax.tree.leaves(sess.opt_state)])
x, y = batch(31)
out["resumed_loss"] = np.asarray(sess.step(jnp.asarray(x), jnp.asarray(y)))
sess.close()
np.savez(OUT, **out)
'''

RUNS = [("cosmo", D, S) for D, S in MESHES] + [("unet", 2, 2)]


def jax_masks(seed, layer, sample_ids, width, device):
    """The reference's dropout masks, as a port mask source."""
    layer_rng = jax.random.fold_in(jax.random.PRNGKey(seed), layer)
    rows = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(layer_rng, int(sid)), 0.8, (width,)))
        for sid in sample_ids]
    return torch.from_numpy(np.stack(rows)).to(device)


def _batch(seed, unet=False):
    r = np.random.RandomState(seed)
    if unet:
        return (r.randn(GB, 16, 16, 16, 1).astype(np.float32),
                r.randint(0, 3, (GB, 16, 16, 16)).astype(np.int32))
    return (r.randn(GB, 32, 32, 32, 2).astype(np.float32),
            r.randn(GB, 4).astype(np.float32))


def _session(D, S, unet=False, **kw):
    return compile(RunConfig(model="unet3d-256" if unet else "cosmoflow-128",
                             smoke=True, global_batch=GB, data=D, spatial=S,
                             **kw),
                   devices=["cpu"] * (D * S),
                   mask_source=None if unet else jax_masks)


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


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's run, started before this file's first test; before
    it starts, a port 2 x 2 ZeRO-1 session takes one step and writes the
    checkpoint it resumes."""
    root = tmp_path_factory.mktemp("zero1")
    ckpt_port, ckpt_ref = str(root / "port2x2"), str(root / "ref2x2")
    with _session(2, 2, grad_comm="reduce_scatter") as sess:
        sess.step(*_batch(30))
        sess.save(ckpt_port)
        port_next = float(sess.step(*_batch(31)))
    path = str(root / "reference.npz")
    script = (f"OUT = {path!r}\nCKPT_PORT = {ckpt_port!r}\n"
              f"CKPT_REF = {ckpt_ref!r}\nGB = {GB}\nRUNS = {RUNS!r}\n"
              f"SHAPES = {SHAPES!r}\nPOLICY = {POLICY!r}\n" + REFERENCE)
    pending = _Pending(script, path=path, ckpt_port=ckpt_port,
                       ckpt_ref=ckpt_ref, port_next=port_next)
    yield pending
    if pending.proc.poll() is None:
        pending.proc.kill()
        pending.proc.communicate()


def _tree_plan():
    return grad_comm.make_plan(
        {k: torch.zeros(s) for k, s in SHAPES.items()},
        grad_comm.BucketPolicy(**POLICY))


# ------------------------------------------- the port alone, first ----
def test_sharded_opt_state_is_1_over_n():
    params = {"w": torch.zeros(1000), "b": torch.zeros(7)}
    plan = grad_comm.make_plan(params,
                               grad_comm.BucketPolicy(small_thresh_elems=100))
    opt = Adam(lr=constant(1e-3))
    full = opt.init(params)
    full_elems = sum(t.numel() for t in (*full.m.values(), *full.v.values()))
    for n in (1, 2, 4):
        st = grad_comm.init_sharded_opt_state(opt, plan, num_shards=n)
        total = sum(t.numel() for t in (*st.m, *st.v))
        # the global flat state is the tree's plus the shard grid's
        # padding; each data shard keeps exactly total / n
        assert total >= full_elems
        assert total - full_elems < 2 * n * plan.num_buckets
        shards = [grad_comm.local_opt_state(st, plan, i, n)
                  for i in range(n)]
        for s in shards:
            assert sum(t.numel() for t in (*s.m, *s.v)) == total // n
            assert s.step.dim() == 0
        back = grad_comm.global_opt_state(shards)
        assert all(torch.equal(a, b) for a, b in zip(back.m, st.m))


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_each_shard_holds_its_own_chunk(precision):
    """Each shard's state is its 1/N of every padded bucket (2 x 4 x
    padded / N bytes a bucket, plus the scalars); spatial peers hold the
    same chunk, and the chunks put together are the global state."""
    D, S = 2, 2
    with _session(D, S, grad_comm="reduce_scatter",
                  precision=precision) as sess:
        for i in range(2):
            sess.step(*_batch(50 + i))
        plan = train_step.convnet_grad_plan(sess.cfg)
        states = sess.opt_state
        assert len(states) == D * S
        for r, st in enumerate(states):
            inner = st.inner if precision == "fp16" else st
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*inner.m, *inner.v))
            assert nbytes == sum(2 * 4 * plan.padded_size(b, D) // D
                                 for b in plan.buckets)
            peer = states[r ^ 1]  # the other spatial shard, same data index
            peer = peer.inner if precision == "fp16" else peer
            assert all(torch.equal(a, b) for a, b in zip(inner.m, peer.m))
            assert int(inner.step) == 2
        owners = train_step.data_shards(sess.mesh, sess.plan.stages[0])
        assert owners == [0, 2]
        assert not torch.equal(states[0].m[0] if precision == "fp32"
                               else states[0].inner.m[0],
                               states[2].m[0] if precision == "fp32"
                               else states[2].inner.m[0])


@pytest.mark.parametrize("kind", ["adam_clipped", "sgd"])
def test_updates_on_chunks_match_the_full_tree(kind):
    """Two ``sharded_update`` steps over 2 data shards against the
    optimizer on the whole, summed tree: Adam with a clip that binds
    (the norm over every chunk, summed over the data axis; two steps, as
    Adam's first step cancels any scale) and SGD with momentum, each
    over the tuple of flat chunks."""
    from repro_torch.optim.adam import SGD

    plan = _tree_plan()
    r = np.random.RandomState(7)
    params = {k: torch.from_numpy(r.randn(*s).astype(np.float32))
              for k, s in SHAPES.items()}
    opt = (Adam(lr=constant(1e-2), grad_clip=0.5) if kind == "adam_clipped"
           else SGD(lr=constant(1e-2)))
    want, state = params, opt.init(params)
    got = [params, params]
    states = [grad_comm.local_opt_state(grad_comm.init_sharded_opt_state(
        opt, plan, num_shards=2), plan, i, 2) for i in range(2)]
    mesh = Mesh([("data", 2)], ["cpu"] * 2)
    for t in range(2):
        grads = [{k: torch.from_numpy((t + 1) * r.randn(*s).astype(
            np.float32)) for k, s in SHAPES.items()} for _ in range(2)]
        want, state = opt.update({k: grads[0][k] + grads[1][k]
                                  for k in SHAPES}, state, want)
        outs = spmd.run(mesh, lambda g, st, p: grad_comm.sharded_update(
            opt, g, st, p, plan, ("data",)), grads, states, got)
        got, states = [o[0] for o in outs], [o[1] for o in outs]
    for new, st in zip(got, states):
        assert int(st.step) == 2
        for k in SHAPES:
            torch.testing.assert_close(new[k], want[k], rtol=1e-6,
                                       atol=1e-7)


def test_an_overflow_in_one_chunk_skips_every_shard():
    """fp16's skip machine on chunks: a non-finite gradient element that
    the reduce-scatter hands to data shard 0 alone still skips the step
    on both shards (the finite verdict is summed over the data axis):
    parameters and the inner states held, both loss scales halved."""
    from repro_torch.core import precision as precision_lib

    plan = _tree_plan()
    r = np.random.RandomState(8)
    params = {k: torch.from_numpy(r.randn(*s).astype(np.float32))
              for k, s in SHAPES.items()}
    grads = [{k: torch.from_numpy(r.randn(*s).astype(np.float32))
              for k, s in SHAPES.items()} for _ in range(2)]
    first = plan.buckets[0].names[0]
    grads[1][first].view(-1)[0] = float("inf")  # in chunk 0 of bucket 0
    opt = precision_lib.MixedPrecision(Adam(lr=constant(1e-2)),
                                       precision_lib.FP16)
    full = grad_comm.init_sharded_opt_state(opt, plan, num_shards=2)
    states = [grad_comm.local_opt_state(full, plan, i, 2) for i in range(2)]

    def fn(g, st):
        chunks = grad_comm.reduce_scatter_grads(g, plan, ("data",))
        finite = bool(torch.isfinite(torch.cat(chunks)).all())
        return finite, grad_comm.sharded_update(opt, g, st, params, plan,
                                                ("data",))

    outs = spmd.run(Mesh([("data", 2)], ["cpu"] * 2), fn, grads, states)
    assert [o[0] for o in outs] == [False, True]  # shard 1's chunk finite
    for (_, (new, st)), old in zip(outs, states):
        assert all(torch.equal(new[k], params[k]) for k in SHAPES)
        assert int(st.inner.step) == 0
        assert float(st.loss_scale) == float(old.loss_scale) / 2


def test_fp16_overflow_on_one_data_index_vetoes_every_shard():
    """The step function called directly, a NaN written into the batch
    rows of data index 0 only: under the guard every shard skips the
    update (parameters and its own state held bitwise) and every loss
    scale halves."""
    cfg = cosmo_cfg.SMOKE
    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (1, 1, 1),
        data_degrees=(2,))
    mesh = Mesh(plan.mesh_axes, ["cpu"] * 2)
    opt = Adam(lr=constant(1e-3))
    step = train_step.make_convnet_train_step(
        cfg, mesh, opt, global_batch=GB, plan=plan,
        grad_comm="reduce_scatter", precision="fp16", guard=True,
        mask_source=jax_masks)
    params = cosmoflow.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    state = train_step.make_convnet_opt_state(
        cfg, opt, params, grad_comm="reduce_scatter", plan=plan,
        mesh=mesh, precision="fp16")
    params, state, loss, applied = step(params, state, *map(
        torch.from_numpy, _batch(60)), 0)
    assert float(applied) == 1.0 and torch.isfinite(loss)
    x, y = _batch(61)
    x[:GB // 2, 3] = np.nan  # data index 0's rows only
    new_params, new_state, loss, applied = step(
        params, state, torch.from_numpy(x), torch.from_numpy(y), 1)
    assert float(applied) == 0.0 and not torch.isfinite(loss)
    assert all(torch.equal(new_params[k], params[k]) for k in params)
    for old, new in zip(state, new_state):
        assert float(new.loss_scale) == float(old.loss_scale) / 2
        assert int(new.good_steps) == 0
        assert int(new.inner.step) == int(old.inner.step) == 1
        assert all(torch.equal(a, b) for a, b in zip(
            (*old.inner.m, *old.inner.v), (*new.inner.m, *new.inner.v)))


def test_grad_comm_probe_scatters_and_gathers():
    """The ``grad_comm`` probe under ZeRO-1 is the scatter and the gather
    alone: the reduced gradients, as ``overlap``'s probe gives them."""
    x, y = map(torch.from_numpy, _batch(70))
    got = {}
    for mode in ("overlap", "reduce_scatter"):
        with _session(2, 2, grad_comm=mode) as sess:
            probe = train_step.make_convnet_phase_probes(
                sess.cfg, sess.mesh, sess.optimizer, global_batch=GB,
                plan=sess.plan, grad_comm=mode,
                mask_source=jax_masks)["grad_comm"]
            got[mode] = probe(sess.params, sess.opt_state, x, y, 0)[1]
    for k, v in got["overlap"].items():
        torch.testing.assert_close(got["reduce_scatter"][k], v, rtol=1e-6,
                                   atol=1e-7)


def test_session_restore_resumes_bitwise(tmp_path):
    with _session(2, 2, grad_comm="reduce_scatter") as sess:
        sess.step(*_batch(80))
        sess.save(str(tmp_path / "c"))
        want = float(sess.step(*_batch(81)))
        params = sess.params
    with Session.restore(str(tmp_path / "c"), devices=["cpu"] * 4,
                         mask_source=jax_masks) as again:
        assert float(again.step(*_batch(81))) == want
        assert all(torch.equal(again.params[k], params[k]) for k in params)
    # re-degreed to 4 x 1 and 1 x 1: the padding is laid anew
    for D, S in ((4, 1), (1, 1)):
        with Session.restore(str(tmp_path / "c"), devices=["cpu"] * (D * S),
                             data=D, spatial=S, mask_source=jax_masks) as r:
            got = float(r.step(*_batch(81)))
            assert abs(got - want) <= 1e-5 * abs(want)


# ------------------------- against the reference, once its run ends ----
@pytest.mark.parametrize("N", [1, 2, 4])
def test_zero1_functions_match_reference(reference, N):
    reference = reference.result()
    plan = _tree_plan()
    tree = {k: torch.from_numpy(reference["tree_" + k]) for k in SHAPES}
    grads = [{k: torch.from_numpy(reference[f"g{N}_{k}"][r]) for k in SHAPES}
             for r in range(N)]

    def fn(g):
        shards = grad_comm.reduce_scatter_grads(g, plan, ("data",))
        return (shards, grad_comm.param_shards(tree, plan, ("data",)),
                grad_comm.all_gather_params(shards, plan, ("data",), tree),
                grad_comm.shard_index(("data",)))

    outs = spmd.run(Mesh([("data", N)], ["cpu"] * N), fn, grads)
    assert [o[3] for o in outs] == list(range(N))
    for i, b in enumerate(plan.buckets):
        padded = plan.padded_size(b, N)
        assert padded % N == 0 and 0 <= padded - b.size < N
        # shard r holds chunk r, padded / N long: the global vector is
        # the shards in rank order
        for kind, j in (("rs", 0), ("ps", 1)):
            got = torch.cat([o[j][i] for o in outs])
            assert all(o[j][i].shape == (padded // N,) for o in outs)
            np.testing.assert_allclose(got.numpy(),
                                       reference[f"{kind}{N}_{i}"],
                                       rtol=1e-6, atol=1e-6)
    for o in outs:
        for k in SHAPES:
            np.testing.assert_allclose(o[2][k].numpy(),
                                       reference[f"back{N}_{k}"],
                                       rtol=1e-6, atol=1e-6)
    state = grad_comm.init_sharded_opt_state(Adam(lr=constant(1e-3)), plan,
                                             num_shards=N)
    assert [t.numel() for t in leaves(state)] == list(
        reference[f"state{N}"])


# ---------------------------------------------------- the trajectory ----
def _ref_params(reference, tag):
    pre = f"init_{tag}_"
    return {k[len(pre):]: v for k, v in reference.items()
            if k.startswith(pre)}


def _assert_close(got, reference, tag):
    bad = []
    for k, v in got.items():
        want = reference[f"final_{tag}_{k}"]
        if not np.allclose(v.numpy(), want, atol=ATOL, rtol=RTOL):
            bad.append((k, float(np.max(np.abs(v.numpy() - want)))))
    assert not bad, (tag, bad)


_TRAJECTORIES = {}


def _trajectory(reference, mode, D, S):
    """The port's parameters after 2 steps of ``mode`` at D x S from the
    reference's initial parameters, run once for every test that reads
    them."""
    key = (mode, D, S)
    if key not in _TRAJECTORIES:
        with _session(D, S, grad_comm=mode) as sess:
            sess.params = cosmoflow.params_from_numpy(
                _ref_params(reference, f"cosmo_{D}_{S}"), "cpu",
                cfg=cosmo_cfg.SMOKE)
            for i in range(2):
                assert torch.isfinite(sess.step(*_batch(20 + i)))
            _TRAJECTORIES[key] = sess.params
    return _TRAJECTORIES[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D,S", MESHES)
def test_modes_match_reference_reduce_scatter_after_two_steps(
        reference, mode, D, S):
    reference = reference.result()
    _assert_close(_trajectory(reference, mode, D, S), reference,
                  f"cosmo_{D}_{S}")


@pytest.mark.parametrize("D,S", [(2, 1), (2, 2)])
def test_the_three_lowerings_are_bitwise_equal(reference, D, S):
    """Every lowering sums a gradient over the spatial peers first, then
    over the data shards, each in rank order (ZeRO-1: its spatial hooks,
    then its reduce-scatter), and Adam's arithmetic is elementwise: the
    same bits after two steps."""
    reference = reference.result()
    got = {mode: _trajectory(reference, mode, D, S) for mode in MODES}
    for mode in ("monolithic", "reduce_scatter"):
        assert all(torch.equal(got["overlap"][k], got[mode][k])
                   for k in got["overlap"]), mode


def test_unet_reduce_scatter_matches_reference_at_2x2(reference):
    reference = reference.result()
    tag = "unet_2_2"
    with _session(2, 2, unet=True, grad_comm="reduce_scatter") as sess:
        sess.params = unet3d.params_from_numpy(
            _ref_params(reference, tag), "cpu", cfg=unet_cfg.SMOKE)
        for i in range(2):
            assert torch.isfinite(sess.step(*_batch(20 + i, unet=True)))
        _assert_close(sess.params, reference, tag)


# ------------------------------------------------------ checkpoints ----
def test_port_checkpoint_restores_in_reference(reference):
    reference = reference.result()
    manifest = json.load(open(os.path.join(reference["ckpt_port"],
                                           "manifest.json")))
    specs = {e["path"]: e.get("spec") for e in manifest["leaves"]}
    assert specs["['opt'].m[0]"] == [["data"]]
    assert specs["['opt'].step"] == []
    assert int(reference["resumed_step"]) == 1
    assert all("data" in s for s in reference["resumed_specs"]
               if s != "PartitionSpec()")
    want = reference["port_next"]
    assert abs(float(reference["resumed_loss"]) - want) <= 1e-5 * abs(want)


def test_reference_checkpoint_restores_in_port(reference):
    reference = reference.result()
    path = reference["ckpt_ref"]
    with Session.restore(path, devices=["cpu"] * 4,
                         mask_source=jax_masks) as sess:
        assert sess.grad_comm == "reduce_scatter" and sess.step_count == 2
        # each shard's chunk of the reference's global buckets
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        files = {e["path"]: e["file"] for e in manifest["leaves"]}
        for r, st in enumerate(sess.opt_state):
            d = train_step.batch_slice(sess.mesh, r, sess.plan.stages[0])[0]
            for i, chunk in enumerate(st.m):
                flat = np.load(os.path.join(path, files[f"['opt'].m[{i}]"]))
                n = len(chunk)
                np.testing.assert_array_equal(chunk.numpy(),
                                              flat[d * n:(d + 1) * n])
        got = float(sess.step(*_batch(22)))
    want = float(reference["ref_next"])
    assert abs(got - want) <= 1e-5 * abs(want)
