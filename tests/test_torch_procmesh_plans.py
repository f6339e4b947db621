"""The cost-model planner over the process mesh (``launch.mesh.
ProcessMesh``: one process a shard): ``plan="auto"``, memory budgets over
a pool of ranks, and the planner's batch-sharded layouts (the spatial
group turned into batch shards by one ``all_to_all``) in training,
serving, the per-rank loader and the supervisor, against the in-process
mesh, on the CPU over gloo.

One 4-process world (``launch.dist.Pool``: spawned, a ``file://``
rendezvous in the module's temporary directory, one intra-op thread a
child, a child limit so that a deadlock fails the test instead of
hanging it) serves every case; the in-process runs go in this process
while the children work.

* every one-transition plan of ``core/plan.py::candidate_convnet_plans``
  for SMOKE CosmoFlow and the SMOKE U-Net at 1 x 2 and 1 x 4, under
  ``overlap``, ``monolithic`` and ``reduce_scatter``: step 1's reduced
  gradients, 2 steps' losses, the parameters and this rank's optimizer
  state bitwise the in-process mesh's, every rank's collectives in one
  order (a batch plan's ``all_to_all`` among them);
* ``plan="auto"`` at 1 x 2 and 1 x 4: every rank holds
  ``plan_convnet(cfg, H100, ...)``'s plan and trains bitwise the
  in-process ``plan="auto"`` session;
* budgets at data = spatial = 1 in a world of 4: every rank agrees on
  the plan one process given 4 devices chooses; the plan's ranks train
  bitwise the in-process budgeted session; the others are released
  (no subgroup of the mesh made, ``step``/``save``/``predict`` raise
  naming the plan's ranks, ``describe`` says so); a budget below every
  candidate names the floor on every rank, as in one process;
* the per-rank loader under ``uniform_batch`` (each rank reads whole
  volumes of its own samples) and ``b1_batch`` (its hyperslab): store
  bytes a rank exact, losses and parameters bitwise;
* the harness at S = 2 under ``plan="auto"``: rank 0's replies bitwise
  the in-process harness's;
* the supervisor: a budgeted start releases the ranks its plan leaves
  out and trains bitwise the in-process supervised run; a pinned 2 x 2
  plan losing a device re-plans (``"auto"``) to 1 x 2 on ranks 0-1 with
  the in-process elastic run's events and losses, ranks 2-3 released;
* ``api/cli.py``'s ``--memory-budget`` over 2 processes;
* against the JAX package (one subprocess with 2 forced host devices,
  beside the pool): the ``b1_batch`` 1 x 2 step 1 over processes from
  the reference's initial parameters and with its dropout masks, each
  leaf within 1e-5 of its max-abs of the reference's planned step.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.api import RunConfig, RunConfigError, compile, supervisor
from repro_torch.api import cli
from repro_torch.core import faults
from repro_torch.core import plan as plan_lib
from repro_torch.core.perf_model import H100
from repro_torch.core.tree import key_paths
from repro_torch.data import store, synthetic
from repro_torch.launch import dist as dist_lib
from repro_torch.models import cosmoflow
from repro_torch.train import train_step

from conftest import SRC

WORLD = 4
GB = 4
SAMPLES = 8
SEED = 3
MODELS = {"cosmo": "cosmoflow-128", "unet": "unet3d-256"}
GRAD_COMMS = ("overlap", "monolithic", "reduce_scatter")
# (model, budget GiB): the plans they choose over a pool of 4 (one rank
# rematerialized, four in bf16, one; the U-Net's four rematerialized)
BUDGETS = [("cosmo", 0.0045), ("cosmo", 0.008), ("cosmo", 0.01),
           ("unet", 0.003)]
FLOOR_GIB = 0.001  # below every candidate's modeled peak


def _cfg(model):
    return configs.get_smoke_config(MODELS[model])


def _plans(model, S):
    """The one-transition candidates of ``model`` at 1 x S, by name."""
    return {p.name: p for p in plan_lib.candidate_convnet_plans(
        _cfg(model), H100, spatial_degree=S, global_batch=GB)}


PLAN_CASES = [(m, S, name) for m in sorted(MODELS) for S in (2, 4)
              for name in sorted(_plans(m, S))]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs (the children have
    one each too), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("procmesh_plans")
    p = dist_lib.Pool(WORLD, "file://" + str(root / "rendezvous"),
                      timeout_s=240)
    # a lowered priority: the other test workers' timed steps go first
    p.run(os.nice, 10)
    yield p
    p.close()


def _batch(cfg, t):
    r = np.random.RandomState(11 + t)
    w = cfg.input_width
    x = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
    if cfg.arch == "unet3d":
        return x, r.randint(0, cfg.out_dim, (GB, w, w, w)).astype(np.int32)
    return x, r.randn(GB, cfg.out_dim).astype(np.float32)


def _rank():
    return torch.distributed.get_rank() if dist_lib.initialized() else None


def _devices(n):
    """Every rank's device over processes (the world's size), or one a
    shard in one process."""
    return ["cpu"] * (len(dist_lib.world()) if dist_lib.initialized()
                      else n)


def _state(sess):
    """(parameters, optimizer state as (path, leaf) pairs: under ZeRO-1
    one list a local shard)."""
    params = {k: v.clone() for k, v in sess.params.items()}
    if isinstance(sess.opt_state, list):
        return params, [[(p, v.clone()) for p, v in key_paths(s)]
                        for s in sess.opt_state]
    return params, [(p, v.clone()) for p, v in key_paths(sess.opt_state)]


def _run(sess, steps=2):
    """Step 1's ``grad_comm`` probe (loss, reduced gradients), then
    ``steps`` steps: their losses, the state after them, the describe
    report and this rank's collectives."""
    probe = train_step.make_convnet_phase_probes(
        sess.cfg, sess.mesh, sess.optimizer,
        global_batch=sess.config.global_batch, plan=sess.plan,
        grad_comm=sess.grad_comm, precision=sess.precision)["grad_comm"]
    loss1, grads = probe(sess.params, sess.opt_state,
                         *map(torch.from_numpy, _batch(sess.cfg, 0)), 0)
    return {"probe": (float(loss1), {k: v.clone() for k, v in
                                     grads.items()}),
            "losses": [float(sess.step(*_batch(sess.cfg, t)))
                       for t in range(steps)],
            "state": _state(sess), "describe": sess.describe(),
            "plan": sess.plan, "precision": sess.precision,
            "log": list(getattr(sess.mesh, "log", ())), "rank": _rank()}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _hold(got, want, rank):
    """A process rank's run against the in-process run's: the probe, the
    losses, the parameters and its optimizer state (ZeRO-1's own chunk:
    the in-process shard ``rank``'s), bitwise."""
    assert got["plan"] == want["plan"] and got["precision"] == \
        want["precision"], rank
    assert got["probe"][0] == want["probe"][0], rank
    assert _equal(got["probe"][1], want["probe"][1]), rank
    assert got["losses"] == want["losses"], rank
    params, opt = got["state"]
    w_params, w_opt = want["state"]
    assert _equal(params, w_params), rank
    if isinstance(opt[0], list):  # ZeRO-1: [this rank's chunk]
        (opt,), w_opt = opt, w_opt[rank]
    assert [p for p, _ in opt] == [p for p, _ in w_opt], rank
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(opt, w_opt)), rank


# -------------------------------------------------- planned layouts ----
def planned_job(model, S, name):
    """2 steps of each reduction lowering under the candidate ``name``
    at 1 x S (this process a shard, or every shard in one process)."""
    plan = _plans(model, S)[name]
    out = {}
    for gc in GRAD_COMMS:
        with compile(RunConfig(model=MODELS[model], smoke=True,
                               global_batch=GB, spatial=S, plan=plan,
                               grad_comm=gc), devices=["cpu"] * S) as sess:
            out[gc] = _run(sess)
    return out


@pytest.fixture(scope="module")
def planned(pool):
    """``planned_job`` over processes and in this process, once a
    (model, S, plan)."""
    cache = {}

    def get(model, S, name):
        key = (model, S, name)
        if key not in cache:
            ranks = pool.submit(planned_job, model, S, name,
                                ranks=range(S))
            want = planned_job(model, S, name)
            cache[key] = (pool.result(ranks, f"planned {key}"), want)
        return cache[key]
    return get


@pytest.mark.parametrize("grad_comm", GRAD_COMMS)
@pytest.mark.parametrize("model,S,name", PLAN_CASES)
def test_planned_layouts_train_bitwise_the_in_process_mesh(
        planned, model, S, name, grad_comm):
    got, want = planned(model, S, name)
    want = want[grad_comm]
    for rank, out in enumerate(got):
        out = out[grad_comm]
        assert out["rank"] == rank
        _hold(out, want, rank)
        assert out["describe"].process_rank == rank
        assert out["describe"].plan_name == name
        assert not out["describe"].released
        # every rank met the same collectives in the same order
        assert out["log"] == got[0][grad_comm]["log"], rank
    kinds = {k for k, _, _ in got[0][grad_comm]["log"]}
    # a batch transition is one all_to_all (and its adjoint) a step
    assert ("all_to_all" in kinds) == name.endswith(".batch"), kinds


# ------------------------------------------------------- plan="auto" ----
def auto_job(model, S):
    with compile(RunConfig(model=MODELS[model], smoke=True, global_batch=GB,
                           spatial=S, plan="auto"),
                 devices=["cpu"] * S) as sess:
        return _run(sess)


@pytest.mark.parametrize("model,S", [(m, S) for m in sorted(MODELS)
                                     for S in (2, 4)])
def test_plan_auto_over_processes_is_the_planners_choice(pool, model, S):
    ranks = pool.submit(auto_job, model, S, ranks=range(S))
    want = auto_job(model, S)
    got = pool.result(ranks, f"auto {model} 1x{S}")
    plan = plan_lib.plan_convnet(_cfg(model), H100, spatial_degree=S,
                                 data_degree=1, global_batch=GB,
                                 grad_comm="overlap")
    assert want["plan"] == plan
    for rank, out in enumerate(got):
        _hold(out, want, rank)
        rep = out["describe"]
        assert rep.plan_name == plan.name and rep.transport == "gloo"
        assert rep.predicted_step_s == want["describe"].predicted_step_s
        assert rep.modeled_peak == want["describe"].modeled_peak


# ---------------------------------------------------------- budgets ----
def budget_job(model, budget):
    """A session at data = spatial = 1 under ``budget`` over every rank
    of the world (4 devices in one process): a plan's rank trains 2
    steps; a released rank reports what it holds and what it refuses."""
    config = RunConfig(model=MODELS[model], smoke=True, global_batch=GB,
                       memory_budget_gib=budget)
    before = set(dist_lib._GROUPS)
    with compile(config, devices=_devices(WORLD)) as sess:
        if not sess.released:
            return _run(sess)
        refused = {}
        for what, call in (("step", lambda: sess.step(*_batch(sess.cfg, 0))),
                           ("save", lambda: sess.save("unused")),
                           ("make_loader", sess.make_loader)):
            try:
                call()
            except RuntimeError as e:
                refused[what] = str(e)
        return {"released": True, "rank": _rank(), "plan": sess.plan,
                "describe": sess.describe(), "refused": refused,
                "ranks": sess.ranks,
                "subgroups": sorted(set(dist_lib._GROUPS) - before)}


@pytest.mark.parametrize("model,budget", BUDGETS)
def test_a_budget_over_the_pool_plans_as_one_process_and_releases(
        pool, model, budget):
    ranks = pool.submit(budget_job, model, budget)
    want = budget_job(model, budget)
    got = pool.result(ranks, f"budget {model} {budget}")
    plan = plan_lib.plan_convnet(
        _cfg(model), H100, spatial_degree=1, data_degree=1, global_batch=GB,
        grad_comm="overlap", memory_budget_bytes=budget * 2 ** 30,
        precisions=("fp32", "bf16"), spatial_options=(1, 2, 4))
    assert want["plan"] == plan
    n = plan.device_count
    for rank, out in enumerate(got):
        assert out["plan"] == plan, rank
        if rank < n:
            _hold(out, want, rank)
            assert out["describe"].memory_budget_bytes == budget * 2 ** 30
            assert out["describe"].modeled_peak.total <= budget * 2 ** 30
            continue
        assert out["released"] and out["rank"] == rank
        assert out["ranks"] == tuple(range(n))
        # the compile made no subgroup here (the plan's all-gather rode
        # the world's): the released rank joined none of the mesh
        assert out["subgroups"] == [], out["subgroups"]
        assert set(out["refused"]) == {"step", "save", "make_loader"}
        for msg in out["refused"].values():
            assert f"ranks {list(range(n))}" in msg, msg
        rep = out["describe"]
        assert rep.released and rep.plan_name == plan.name
        assert rep.modeled_peak == want["describe"].modeled_peak
        assert "released" in str(rep)


def floor_job():
    try:
        compile(RunConfig(model=MODELS["cosmo"], smoke=True, global_batch=GB,
                          memory_budget_gib=FLOOR_GIB),
                devices=_devices(WORLD))
    except RunConfigError as e:
        return e.field, e.fix
    return None, None


def test_a_budget_below_every_plan_names_the_floor_on_every_rank(pool):
    want = floor_job()
    assert want[0] == "memory_budget_gib" and "floor" in want[1]
    assert all(got == want for got in pool.run(floor_job))


# ----------------------------------------------------------- loader ----
@pytest.fixture(scope="module")
def cosmo_store(tmp_path_factory):
    cfg = _cfg("cosmo")
    path = str(tmp_path_factory.mktemp("procmesh_plans_store") / "cosmo")
    cubes, targets = synthetic.make_cosmology_dataset(
        SAMPLES, cfg.input_width, channels=cfg.in_channels, seed=3)
    store.write_dataset(path, cubes, targets)
    return path


def loader_job(name, root, prefetch):
    """3 steps of a 1 x 2 session under the candidate ``name`` fed by its
    loader: the losses, the parameters, the store bytes a rank over the
    first epoch."""
    with compile(RunConfig(model=MODELS["cosmo"], smoke=True,
                           global_batch=GB, spatial=2,
                           plan=_plans("cosmo", 2)[name]),
                 devices=["cpu"] * 2) as sess:
        loader = sess.make_loader(root, prefetch=prefetch)
        bpe, losses, pfs = SAMPLES // GB, [], None
        for t in range(3):
            epoch, b = divmod(t, bpe)
            order = loader.schedule_for_epoch(epoch)
            losses.append(float(sess.step(loader.load_batch(
                order[b * GB:(b + 1) * GB]))))
            if t == bpe - 1:
                pfs = dict(loader.stats.rank_pfs_bytes)
        return {"losses": losses, "pfs": pfs, "rank": _rank(),
                "params": {k: v.clone() for k, v in sess.params.items()}}


@pytest.mark.parametrize("name,prefetch", [
    ("cosmoflow.uniform.batch", 0), ("cosmoflow.uniform.batch", 2),
    ("cosmoflow.b1.batch", 0)])
def test_the_per_rank_loader_under_a_batch_entry_stage(pool, cosmo_store,
                                                      name, prefetch):
    ranks = pool.submit(loader_job, name, cosmo_store, prefetch,
                        ranks=(0, 1))
    want = loader_job(name, cosmo_store, 0)
    cfg = _cfg("cosmo")
    w = cfg.input_width
    volume = w ** 3 * cfg.in_channels * 4
    for rank, out in enumerate(pool.result(ranks, f"loader {name}")):
        assert out["losses"] == want["losses"], rank
        assert _equal(out["params"], want["params"]), rank
        # uniform_batch: whole volumes of the rank's own half of the
        # samples; b1_batch: its half of every volume
        assert out["pfs"] == {rank: SAMPLES * volume // 2}, rank


# ---------------------------------------------------------- harness ----
def harness_job(xs):
    """``xs`` served at S = 2 under ``plan="auto"`` (rank 0's harness,
    rank 1 following; or in one process), in batches of 4."""
    with compile(RunConfig(model=MODELS["cosmo"], smoke=True, mode="infer",
                           global_batch=4, spatial=2, plan="auto"),
                 devices=["cpu"] * 2) as sess:
        h = sess.serve(max_batch=4, max_wait_ms=5000.0, workers=1)
        if type(h).__name__ == "ServingFollower":
            h.close()
            return {"follower": True, "batches": h.batches,
                    "plan": sess.plan}
        replies = []
        for i in range(0, len(xs), 4):
            replies += [f.result(timeout=120)
                        for f in h.submit_many(xs[i:i + 4])]
        h.close()
        return {"follower": False, "replies": replies, "plan": sess.plan,
                "requests": sess.telemetry()["serve.requests"]}


def test_the_harness_under_plan_auto_over_processes(pool):
    cfg = _cfg("cosmo")
    w = cfg.input_width
    xs = np.random.RandomState(21).randn(8, w, w, w, cfg.in_channels).astype(
        np.float32)
    ranks = pool.submit(harness_job, xs, ranks=(0, 1))
    want = harness_job(xs)
    front, follower = pool.result(ranks, "harness")
    assert want["plan"].name.endswith(".batch")  # the spatial group batched
    assert front["plan"] == follower["plan"] == want["plan"]
    assert follower["follower"] and follower["batches"] == 2
    assert front["requests"] == len(xs)
    assert all(np.array_equal(a, b)
               for a, b in zip(front["replies"], want["replies"]))


# ------------------------------------------------------- supervisor ----
def supervise_job(root, how):
    """A supervised run of 5 steps on every rank (or in one process with
    4 devices): ``how`` "budget" a budgeted start at data = spatial = 1;
    "lost" a pinned ``b1_batch`` 2 x 2 plan with ``DeviceLost(
    available=2)`` at step 3 on rank 2 (in one process: in the
    process)."""
    base = RunConfig(model=MODELS["cosmo"], smoke=True, global_batch=GB,
                     checkpoint_dir=root)
    specs = []
    if how == "budget":
        config = dataclasses.replace(base, memory_budget_gib=0.008)
    else:
        config = dataclasses.replace(
            base, data=2, spatial=2, plan=plan_lib.convnet_plan(
                _cfg("cosmo"), boundary=1, kind="batch",
                spatial_degrees=(2, 1, 1), data_degrees=(2,)))
        if _rank() in (2, None):
            specs.append(faults.FaultSpec("device.loss", at_steps=(3,),
                                          max_fires=1, available=2))
    with faults.active(*specs):
        r = supervisor.run(config, 5, save_every=2,
                           devices=_devices(WORLD))
    out = {"losses": r.losses, "events": r.events, "released": r.released,
           "final": (r.final_data, r.final_spatial), "replans": r.replans}
    if r.session is not None:
        out["params"] = {k: v.clone() for k, v in r.session.params.items()}
        out["plan"] = r.session.plan
        r.session.close()
    return out


@pytest.mark.parametrize("how", ["budget", "lost"])
def test_the_supervisor_plans_over_processes(pool, tmp_path, how):
    ranks = pool.submit(supervise_job, str(tmp_path / "procs"), how)
    want = supervise_job(str(tmp_path / "threads"), how)
    got = pool.result(ranks, f"supervise {how}")
    n = want["plan"].device_count
    if how == "lost":
        assert want["final"] == (1, 2) and want["replans"] == 1
        assert want["plan"] == plan_lib.plan_convnet(
            _cfg("cosmo"), H100, spatial_degree=2, data_degree=1,
            global_batch=GB, grad_comm="overlap")
    for rank, out in enumerate(got):
        if rank < n:
            assert not out["released"], rank
            assert out["events"] == want["events"], rank
            assert out["losses"] == want["losses"], rank
            assert out["plan"] == want["plan"], rank
            assert _equal(out["params"], want["params"]), rank
            continue
        assert out["released"] and "params" not in out, rank
        assert out["events"][-1].startswith("released"), rank
        if how == "budget":  # before the first step
            assert len(out["events"]) == 2, out["events"]


# -------------------------------------------------------------- cli ----
def cli_job(argv):
    """``api/cli.py``'s flags over ``RunConfig`` to ``compile``, one
    step: the plan, whether released, the loss."""
    ap = argparse.ArgumentParser()
    cli.add_session_args(ap)
    args = ap.parse_args(argv)
    config = cli.config_from_args(
        RunConfig(model=MODELS["cosmo"], smoke=True, global_batch=GB), args)
    where = cli.placement(args, config.data * config.spatial)
    if not dist_lib.initialized():  # one process: the pool as devices
        where = {"devices": [args.device] * 2}
    with compile(config, **where) as sess:
        if sess.released:
            return sess.plan, True, None
        return sess.plan, False, float(sess.step(*_batch(sess.cfg, 0)))


def test_cli_memory_budget_over_two_processes(pool):
    argv = ["--memory-budget", "0.0045", "--device", "cpu"]
    ranks = pool.submit(cli_job, argv, ranks=(0, 1))
    want = cli_job(argv)
    plan = plan_lib.plan_convnet(
        _cfg("cosmo"), H100, spatial_degree=1, data_degree=1,
        global_batch=GB, grad_comm="overlap",
        memory_budget_bytes=0.0045 * 2 ** 30, precisions=("fp32", "bf16"),
        spatial_options=(1, 2))
    assert want[0] == plan and plan.device_count == 2
    assert pool.result(ranks, "cli") == [want, want]


# --------------------------------------------------- against the JAX ----
REFERENCE = r'''
import numpy as np
import jax
import jax.numpy as jnp
from repro import configs
from repro.core import compat
from repro.core import plan as plan_lib
from repro.models import cosmoflow
from repro.optim.adam import Adam, constant
from repro.train.train_step import make_convnet_phase_probes

cfg = configs.get_smoke_config("cosmoflow-128")
out = {}
params = cosmoflow.init_params(jax.random.PRNGKey(0), cfg)
for k, v in params.items():
    out["p_" + k] = np.asarray(v)
r = np.random.RandomState(5)
w = cfg.input_width
out["x"] = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
out["y"] = r.randn(GB, cfg.out_dim).astype(np.float32)
for j, width in enumerate(cfg.fc_dims):
    layer_rng = jax.random.fold_in(jax.random.PRNGKey(SEED), j)
    for sid in range(GB):
        out[f"mask_{j}_{sid}"] = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(layer_rng, sid), 0.8, (width,)))
plan = plan_lib.convnet_plan(cfg, spatial_degrees=(2, 1, 1), boundary=1,
                             kind="batch")
mesh = compat.make_mesh((1, 2), ("data", "model"))
opt = Adam(lr=constant(1e-3))
probe = make_convnet_phase_probes(cfg, mesh, opt, global_batch=GB,
                                  plan=plan)["grad_comm"]
loss, grads = probe(params, opt.init(params), out["x"], out["y"],
                    jnp.asarray(SEED, jnp.int32))
out["loss"] = np.asarray(loss)
for k, v in grads.items():
    out["g_" + k] = np.asarray(v)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's planned step, started with the module's first
    test; it runs beside the pool."""
    path = str(tmp_path_factory.mktemp("procmesh_plans_ref")
               / "reference.npz")
    script = f"OUT = {path!r}\nGB = {GB}\nSEED = {SEED}\n" + REFERENCE
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE,
                            preexec_fn=lambda: os.nice(10))
    box = {}

    def result():
        if not box:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (stdout, stderr)
            box.update(np.load(path))
        return box
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


class MaskTable:
    """The reference's dropout masks as a (picklable) mask source:
    ``rows[(layer, sample id)]`` for the one seed it drew them at."""

    def __init__(self, ref):
        self.rows = {tuple(map(int, k.split("_")[1:])): v
                     for k, v in ref.items() if k.startswith("mask_")}

    def __call__(self, seed, layer, sample_ids, width, device):
        assert seed == SEED
        return torch.from_numpy(np.stack(
            [self.rows[(layer, int(s))] for s in sample_ids])).to(device)


def reference_probe_job(ref):
    """The ``b1_batch`` 1 x 2 ``grad_comm`` probe over processes from the
    reference's initial parameters, batch and masks."""
    cfg = _cfg("cosmo")
    plan = plan_lib.convnet_plan(cfg, spatial_degrees=(2, 1, 1), boundary=1,
                                 kind="batch")
    with compile(RunConfig(model=cfg, global_batch=GB, spatial=2, plan=plan),
                 devices=["cpu"] * 2, mask_source=MaskTable(ref)) as sess:
        probe = train_step.make_convnet_phase_probes(
            cfg, sess.mesh, sess.optimizer, global_batch=GB, plan=sess.plan,
            mask_source=MaskTable(ref))["grad_comm"]
        params = cosmoflow.params_from_numpy(
            {k[2:]: v for k, v in ref.items() if k.startswith("p_")}, "cpu",
            cfg=cfg)
        loss, grads = probe(params, sess.opt_state,
                            torch.from_numpy(ref["x"]),
                            torch.from_numpy(ref["y"]), SEED)
        return float(loss), {k: v.clone() for k, v in grads.items()}


def test_b1_batch_step_over_processes_matches_the_reference(pool,
                                                            reference):
    ref = reference()
    want = float(ref["loss"])
    for loss, grads in pool.run(reference_probe_job, dict(ref),
                                ranks=(0, 1)):
        assert abs(loss - want) <= 1e-5 * abs(want)
        assert set(grads) == {k[2:] for k in ref if k.startswith("g_")}
        for k, g in grads.items():
            r = np.asarray(ref["g_" + k], np.float64)
            err = np.max(np.abs(g.double().numpy() - r)) / max(
                1e-12, np.max(np.abs(r)))
            assert err <= 1e-5, (k, err)
