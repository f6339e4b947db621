"""ZeRO-1, rematerialization and pipeline groups over the process mesh
(``launch.mesh.ProcessMesh``: one process a shard, collectives through
``torch.distributed``) against the in-process mesh, on the CPU over
gloo.

One 4-process world (``launch.dist.Pool``: the spawn start method, a
``file://`` rendezvous in the module's temporary directory, one intra-op
thread a child, a child limit so that a deadlock fails the test instead
of hanging it) serves every case; the in-process mesh runs in this
process while the children work.

* ZeRO-1 (``grad_comm="reduce_scatter"``) at 2 x 1, 4 x 1 and 2 x 2 for
  SMOKE CosmoFlow and at 2 x 2 for the SMOKE U-Net, 2 steps: losses,
  parameters and each rank's optimizer chunk (exactly its 1/N of every
  padded bucket) bitwise the in-process run's, the same collectives on
  every rank;
* rematerialization (every stage of the plan ``remat``) at 1 x 2, also
  with every CosmoFlow block split (the recompute unpacks), and the
  U-Net at 1 x 2: bitwise the in-process remat and the in-process run
  without remat, the ranks' logs equal and holding the recomputes;
* pipeline groups, P = 2, one shard a group (ranks 0-1) and two (all
  four), 1F1B and sequential, ``overlap`` and ``monolithic``, both
  models: losses, each rank's group's parameters and optimizer state
  bitwise the in-process pipelined step's; ``describe`` gives the
  rank's group's modeled peak; ``evaluate`` is the in-process one; a
  non-finite gradient in one group holds every group; ZeRO-1 with
  pipeline groups raises as it does in one process;
* checkpoints: a ZeRO-1 2 x 2 and a pipelined checkpoint are byte for
  byte the in-process run's, and a process mesh that restores them
  steps bitwise as the in-process one does;
* the launcher under a process group at ``--grad-comm reduce_scatter``,
  ``--pipeline 2`` and ``--remat``;
* against the JAX package: the process ZeRO-1 2 x 2 parameters after 2
  steps from the reference's initial parameters and with its dropout
  masks, within atol 1e-5, rtol 1e-4 of the reference's ZeRO-1; the
  pipelined ``grad_comm`` probe's step 1 against the reference's
  per-micro-batch oracle, each leaf within 1e-5 of its max-abs. The
  reference runs once, in one subprocess with 4 forced host devices,
  beside the pool.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.api import RunConfig, Session, compile
from repro_torch.core import memory
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.core.tree import key_paths
from repro_torch.launch import dist as dist_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import cosmoflow, for_config
from repro_torch.train import train_step

from conftest import SRC

WORLD = 4
GB = 4
MODELS = {"cosmo": "cosmoflow-128", "unet": "unet3d-256"}
CUTS = {"cosmo": (2,), "unet": (1,)}
ATOL, RTOL = 1e-5, 1e-4


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
    root = tmp_path_factory.mktemp("procmesh_compose")
    p = dist_lib.Pool(WORLD, "file://" + str(root / "rendezvous"),
                      timeout_s=240)
    # a lowered priority: the other test workers' timed steps go first
    p.run(os.nice, 10)
    yield p
    p.close()


# ------------------------------------------------------------ runs ----
def _spec(model, D, S, mode="overlap", P=1, M=2, sched="1f1b",
          plan="fixed", remat=False):
    """A run: the model's key, the TOTAL data degree, the spatial degree,
    the reduction, the pipeline's groups, micro-batches and schedule,
    the plan ("fixed" or "deep": every CosmoFlow block depth-split) and
    whether every stage is rematerialized."""
    return dict(model=model, D=D, S=S, mode=mode, P=P, M=M, sched=sched,
                plan=plan, remat=remat)


def _plan(spec):
    """The pinned plan of ``spec`` (None: the session's fixed plan)."""
    cfg = configs.get_smoke_config(MODELS[spec["model"]])
    if spec["P"] > 1:
        return plan_lib.pipelined_convnet_plan(
            cfg, boundaries=CUTS[spec["model"]], micro_batches=spec["M"],
            schedule=spec["sched"], data_degrees=(spec["D"] // spec["P"],))
    if spec["plan"] == "deep":
        n = len(cfg.conv_channels)
        plan = plan_lib.ParallelPlan(
            (plan_lib.Stage(0, n, ("model", None, None)),
             plan_lib.Stage(n, n + 1, (None, None, None))),
            (("data", spec["D"]), ("model", spec["S"])), n + 1, name="deep")
    elif spec["remat"]:
        plan = plan_lib.legacy_convnet_plan(
            cfg, SpatialPartitioning(("model", None, None)),
            (spec["S"], 1, 1), data_degrees=(spec["D"],))
    else:
        return None
    if spec["remat"]:
        plan = dataclasses.replace(plan, stages=tuple(
            dataclasses.replace(s, remat=True) for s in plan.stages))
    return plan


def _config(spec, **kw):
    over = dict(kw)
    if spec["P"] > 1:
        over.update(pipeline=spec["P"], micro_batches=spec["M"],
                    pipeline_schedule=spec["sched"], grad_clip=0.0)
    plan = _plan(spec)
    if plan is not None:
        over["plan"] = plan
    return RunConfig(model=MODELS[spec["model"]], smoke=True,
                     global_batch=GB, data=spec["D"], spatial=spec["S"],
                     grad_comm=spec["mode"], **over)


def _batch(cfg, seed):
    r = np.random.RandomState(seed)
    w = cfg.input_width
    x = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
    if cfg.arch == "unet3d":
        return x, r.randint(0, cfg.out_dim, (GB, w, w, w)).astype(np.int32)
    return x, r.randn(GB, cfg.out_dim).astype(np.float32)


def _state(sess):
    """(parameters, optimizer state as (path, leaf) pairs; under ZeRO-1
    one list a local shard)."""
    params = {k: v.clone() for k, v in sess.params.items()}
    if isinstance(sess.opt_state, list):
        return params, [[(p, v.clone()) for p, v in key_paths(s)]
                        for s in sess.opt_state]
    return params, [(p, v.clone()) for p, v in key_paths(sess.opt_state)]


class MaskTable:
    """The JAX package's dropout masks, drawn in this process and
    carried to the children as a table (a picklable mask source):
    ``rows[(seed, layer, sample id)]``."""

    def __init__(self, seeds, cfg):
        self.rows = {}
        for seed in seeds:
            for j, width in enumerate(cfg.fc_dims):
                layer_rng = jax.random.fold_in(jax.random.PRNGKey(seed), j)
                for sid in range(GB):
                    self.rows[(seed, j, sid)] = np.asarray(
                        jax.random.bernoulli(jax.random.fold_in(
                            layer_rng, sid), 0.8, (width,)))

    def __call__(self, seed, layer, sample_ids, width, device):
        return torch.from_numpy(np.stack([
            self.rows[(int(seed), int(layer), int(s))]
            for s in sample_ids])).to(device)


def train_job(spec, steps=2, ckpt=None, init=None, masks=None, seed=11):
    """``steps`` steps of a session of ``spec`` (this process a shard,
    or every shard when no process group is up) from ``init``'s
    parameters (default the seeded ones) on the batches of seeds
    ``seed``, ``seed + 1``, ..., then, with ``ckpt``, a save, a restore
    and one more step."""
    n = spec["D"] * spec["S"]
    with compile(_config(spec), devices=["cpu"] * n,
                 mask_source=masks) as sess:
        if init is not None:
            sess.params = {k: torch.from_numpy(init[k]) for k in sess.params}
        losses = [float(sess.step(*_batch(sess.cfg, seed + t)))
                  for t in range(steps)]
        out = {"losses": losses, "state": _state(sess),
               "describe": sess.describe(),
               "log": list(getattr(sess.mesh, "log", ())),
               "group": getattr(getattr(sess.mesh, "pipeline", None),
                                "group", None)}
        if ckpt is not None:
            sess.save(ckpt)
            out["evaluate"] = sess.evaluate(*_batch(sess.cfg, 40))
    if ckpt is not None:
        with Session.restore(ckpt, devices=["cpu"] * n,
                             mask_source=masks) as again:
            out["resumed"] = float(again.step(*_batch(again.cfg,
                                                      seed + steps)))
            out["resumed_state"] = _state(again)
    return out


def _same(a, b):
    return (a.keys() == b.keys() if isinstance(a, dict) else len(a) == len(b)
            ) and all(torch.equal(x, y) for x, y in (
                zip(a.values(), (b[k] for k in a)) if isinstance(a, dict)
                else ((x, y) for (_, x), (_, y) in zip(a, b))))


def _hold(got, want, rank, zero1=False):
    """A process rank's state against the in-process run's: its
    parameters (a pipeline's: its group's) and optimizer state (ZeRO-1's
    own chunk; a pipeline's group's), bitwise."""
    params, opt = got
    w_params, w_opt = want
    assert params.keys() <= w_params.keys(), rank
    assert all(torch.equal(params[k], w_params[k]) for k in params), rank
    if zero1:
        (mine,) = opt
        assert [p for p, _ in mine] == [p for p, _ in w_opt[rank]], rank
        assert _same(mine, w_opt[rank]), rank
        return
    paths = dict(w_opt)
    assert [p for p, _ in opt] and all(p in paths for p, _ in opt), rank
    assert all(torch.equal(v, paths[p]) for p, v in opt), rank


def _ranks(spec):
    return tuple(range(spec["D"] * spec["S"]))


def _compare(pool, spec):
    """The process run of ``spec`` beside the in-process one: (process
    results by rank, in-process result)."""
    ranks = pool.submit(train_job, spec, ranks=_ranks(spec))
    want = train_job(spec)
    return pool.result(ranks, f"train {spec}"), want


# ------------------------------------------------------------ ZeRO-1 ----
ZERO1 = {"cosmo-2x1": ("cosmo", 2, 1), "cosmo-4x1": ("cosmo", 4, 1),
         "cosmo-2x2": ("cosmo", 2, 2), "unet-2x2": ("unet", 2, 2)}


@pytest.mark.parametrize("case", sorted(ZERO1))
def test_zero1_is_bitwise_the_in_process_mesh(pool, case):
    model, D, S = ZERO1[case]
    spec = _spec(model, D, S, "reduce_scatter")
    got, want = _compare(pool, spec)
    cfg = configs.get_smoke_config(MODELS[model])
    buckets = train_step.convnet_grad_plan(cfg)
    chunk = sum(2 * 4 * buckets.padded_size(b, D) // D
                for b in buckets.buckets)
    for rank, out in enumerate(got):
        assert out["losses"] == want["losses"], rank
        _hold(out["state"], want["state"], rank, zero1=True)
        (mine,) = out["state"][1]
        assert sum(v.numel() * v.element_size() for p, v in mine
                   if p.startswith((".m", ".v"))) == chunk, rank
        assert out["log"] == got[0]["log"], rank
        assert out["describe"].grad_comm == "reduce_scatter"
    kinds = {k for k, _, _ in got[0]["log"]}
    assert "psum_scatter" in kinds and "all_gather" in kinds


# ------------------------------------------------------------- remat ----
REMAT = {"cosmo-1x2": ("cosmo", "fixed"), "cosmo-1x2-all-split":
         ("cosmo", "deep"), "unet-1x2": ("unet", "fixed")}


@pytest.mark.parametrize("case", sorted(REMAT))
def test_remat_is_bitwise_the_in_process_mesh_and_no_remat(pool, case):
    model, kind = REMAT[case]
    spec = _spec(model, 1, 2, plan=kind, remat=True)
    got, want = _compare(pool, spec)
    plain = train_job(_spec(model, 1, 2, plan=kind))
    assert want["losses"] == plain["losses"]
    for rank, out in enumerate(got):
        assert out["losses"] == want["losses"], rank
        _hold(out["state"], want["state"], rank)
        _hold(out["state"], plain["state"], rank)
        assert out["log"] == got[0]["log"], rank
    kinds = [k for k, _, _ in got[0]["log"]]
    n_blocks = kinds.count("checkpoint")
    assert n_blocks and kinds.count("recompute") == n_blocks
    # a recompute meets its peers: its halo and statistics exchanges
    # follow it in the log
    assert kinds[kinds.index("recompute") + 1] != "recompute"


# ---------------------------------------------------------- pipeline ----
PIPES = [(model, d, sched, mode) for model in sorted(MODELS)
         for d in (1, 2) for sched in ("1f1b", "sequential")
         for mode in ("overlap", "monolithic")]


@pytest.mark.parametrize("model,d,sched,mode", PIPES)
def test_pipeline_groups_are_bitwise_the_in_process_step(pool, model, d,
                                                         sched, mode):
    spec = _spec(model, 2 * d, 1, mode, P=2, sched=sched)
    got, want = _compare(pool, spec)
    cfg = configs.get_smoke_config(MODELS[model])
    plan = _plan(spec)
    names = train_step.pipeline_group_names(cfg, plan)
    for rank, out in enumerate(got):
        g = rank // d
        assert out["group"] == g, rank
        assert out["losses"] == want["losses"], rank
        assert set(out["state"][0]) == set(names[g]), rank
        _hold(out["state"], want["state"], rank)
        assert out["log"] == got[g * d]["log"], rank
        assert out["describe"].modeled_peak == memory.plan_peak_bytes(
            cfg, plan, global_batch=GB, grad_comm=mode, group=g)
    assert want["describe"].modeled_peak == max(
        (memory.plan_peak_bytes(cfg, plan, global_batch=GB, grad_comm=mode,
                                group=g) for g in range(2)),
        key=lambda b: b.total)


def _poisoned_forward_range(real, last):
    class Poison(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return torch.full_like(g, float("nan"))

    def poisoned(params, h, cfg_, a, b, **kw):
        if last in params and torch.is_grad_enabled():
            params = dict(params, **{last: Poison.apply(params[last])})
        return real(params, h, cfg_, a, b, **kw)
    return poisoned


def guard_job():
    """A clean pipelined step, then one whose loss group's last FC bias
    gradient is NaN: (applied a step, whether this rank's parameters and
    state held, the skipped steps)."""
    spec = _spec("cosmo", 2, 1, P=2)
    with compile(_config(spec), devices=["cpu"] * 2) as sess:
        sess.step(*_batch(sess.cfg, 3))
        before = _state(sess)
        last = f"fc{len(sess.cfg.fc_dims)}_b"
        real = cosmoflow.forward_range
        cosmoflow.forward_range = _poisoned_forward_range(real, last)
        try:
            loss = sess.step(*_batch(sess.cfg, 4))
        finally:
            cosmoflow.forward_range = real
        params, opt = _state(sess)
        return (bool(torch.isfinite(loss)), _same(params, before[0])
                and _same(opt, before[1]),
                sess.telemetry()["skipped_steps"], last in params)


def test_a_nonfinite_group_holds_every_group(pool):
    got = pool.run(guard_job, ranks=(0, 1))
    for finite, held, skipped, _ in got:
        assert finite and held and skipped == 1
    assert [owns for *_, owns in got] == [False, True]


def evaluate_job(spec, masks=None):
    with compile(_config(spec), devices=["cpu"] * (spec["D"] * spec["S"]),
                 mask_source=masks) as sess:
        sess.step(*_batch(sess.cfg, 5))
        return sess.evaluate(*_batch(sess.cfg, 6))


def profile_job(spec):
    """A pipelined session's ``profile`` over processes, and the rows of
    its ``report`` that were measured (it loads two batches through the
    rank's loader)."""
    with compile(_config(spec), devices=["cpu"] * spec["D"]) as sess:
        prof = sess.profile(reps=1)
        rep = sess.report(reps=1)
        return prof, {r.phase for r in rep.rows if r.measured_s is not None}


def test_pipelined_profile_and_report_over_processes(pool):
    """``profile`` times the pipelined step under both schedules on every
    rank; ``report`` measures the step and, through each rank's loader,
    the ``io`` row (the entry group's reads of x, the loss group's of
    y)."""
    for prof, measured in pool.run(profile_job, _spec("cosmo", 2, 1, P=2),
                                   ranks=(0, 1)):
        assert prof["step"] > 0 and prof["step_sequential"] > 0
        assert prof["pipeline_speedup"] == (prof["step_sequential"]
                                             / prof["step"])
        assert {"step", "io"} <= measured, measured


def refusal_job():
    try:
        compile(_config(_spec("cosmo", 2, 1, "reduce_scatter", P=2)),
                devices=["cpu"] * 2)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return type(e).__name__, str(e)
    return None, None


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pipelined_evaluate_matches_in_process(pool, model):
    spec = _spec(model, 2, 1, P=2)
    ranks = pool.submit(evaluate_job, spec, ranks=(0, 1))
    refusals = pool.submit(refusal_job, ranks=(2, 3))
    want_loss, want_pred = evaluate_job(spec)
    for loss, pred in pool.result(ranks, "evaluate"):
        assert torch.equal(loss, want_loss) and torch.equal(pred, want_pred)
    for kind, msg in pool.result(refusals, "refusal"):
        assert kind in ("ValueError", "RunConfigError"), msg
        assert "reduce_scatter" in msg or "ZeRO-1" in msg, msg


def test_a_one_shard_group_exchanges_over_gloo():
    """A pipeline group of one shard has no collectives: its mesh takes
    gloo, the world's bookkeeping, even on a card of its own; two
    shards on cards of their own take NCCL."""
    one = [torch.device("cuda:0")]
    assert mesh_lib.placement_transport(("a",), one) == "gloo"
    assert mesh_lib.placement_transport(
        ("a", "a"), one + [torch.device("cuda:1")]) == "nccl"


# ------------------------------------------------------- checkpoints ----
def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


@pytest.mark.parametrize("case", ["zero1-2x2", "pipeline-2x1"])
def test_checkpoint_bytes_and_resume_match_in_process(pool, tmp_path, case):
    spec = (_spec("cosmo", 2, 2, "reduce_scatter") if case == "zero1-2x2"
            else _spec("cosmo", 2, 1, P=2))
    ranks = pool.submit(train_job, spec, 2, str(tmp_path / "procs"),
                        ranks=_ranks(spec))
    want = train_job(spec, ckpt=str(tmp_path / "threads"))
    got = pool.result(ranks, f"checkpoint {case}")
    procs, threads = (_files(tmp_path / "procs"),
                      _files(tmp_path / "threads"))
    assert sorted(procs) == sorted(threads) and procs == threads
    zero1 = spec["mode"] == "reduce_scatter"
    for rank, out in enumerate(got):
        assert out["resumed"] == want["resumed"], rank
        _hold(out["resumed_state"], want["resumed_state"], rank, zero1)
        loss, pred = out["evaluate"]
        assert torch.equal(loss, want["evaluate"][0]), rank
        assert torch.equal(pred, want["evaluate"][1]), rank


# ---------------------------------------------------------- drivers ----
def launcher_job(argv, root):
    launch_train.main(argv + ["--ckpt", root, "--device", "cpu"])
    return sorted(os.listdir(root))


@pytest.mark.parametrize("flags", [
    ["--data", "2", "--model", "2", "--grad-comm", "reduce_scatter"],
    ["--data", "4", "--pipeline", "2", "--micro-batches", "2"],
    ["--model", "4", "--remat"]])
def test_launcher_runs_each_composition(pool, tmp_path, flags):
    argv = ["--arch", "cosmoflow-128", "--steps", "2", "--batch", "4"] + flags
    for files in pool.run(launcher_job, argv, str(tmp_path / "ck")):
        assert "manifest.json" in files and "run_config.json" in files


# -------------------------------------------------- against the JAX ----
REFERENCE = r'''
import numpy as np
import jax
import jax.numpy as jnp
from repro import api, configs
from repro.models import cosmoflow


def _at_once(init):
    """``init`` as one program at XLA's optimization level 0 (op by op
    each random draw compiles on its own)."""
    once = jax.jit(init, static_argnums=(1, 2), compiler_options={
        "xla_backend_optimization_level": 0})

    def run(key, cfg, dtype=jnp.float32):
        if isinstance(key, jax.core.Tracer):
            return init(key, cfg, dtype)
        return once(key, cfg, dtype)
    return run


cosmoflow.init_params = _at_once(cosmoflow.init_params)
inp = np.load(INPUTS)
out = {}
# ZeRO-1 at 2 x 2, 2 steps from its own initial parameters
sess = api.compile(api.RunConfig(model="cosmoflow-128", smoke=True,
                                 global_batch=GB, data=2, spatial=2,
                                 grad_comm="reduce_scatter"))
for k, v in sess.params.items():
    out["init_" + k] = np.asarray(v)
for t in range(2):
    sess.step(jnp.asarray(inp[f"x{t}"]), jnp.asarray(inp[f"y{t}"]))
for k, v in sess.params.items():
    out["final_" + k] = np.asarray(v)
sess.close()
# the pipelined step's oracle: the micro-batches' value_and_grad summed
cfg = configs.get_smoke_config("cosmoflow-128")
p = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p_")}


def f(p_, xm, ym, ids):
    return cosmoflow.mse_loss(p_, xm, ym, cfg, global_batch=GB, train=True,
                              dropout_rng=jax.random.PRNGKey(0),
                              sample_ids=ids)


vg = jax.jit(jax.value_and_grad(f))
mb = GB // M
loss, grads = 0.0, None
for m in range(M):
    sl = slice(m * mb, (m + 1) * mb)
    lm, gm = vg(p, jnp.asarray(inp["px"][sl]), jnp.asarray(inp["py"][sl]),
                jnp.arange(m * mb, (m + 1) * mb))
    loss += float(lm)
    grads = gm if grads is None else jax.tree.map(jnp.add, grads, gm)
out["oracle_loss"] = np.asarray(loss)
for k, v in grads.items():
    out["oracle_" + k] = np.asarray(v)
np.savez(OUT, **out)
'''
PIPE_ORACLE = _spec("cosmo", 4, 1, P=2)
# the ZeRO-1 trajectory's batches, those of tests/test_torch_zero1.py
# (the reference's contract between the lowerings): Adam's first steps
# turn the rounding of a gradient near zero into a whole step, so two
# steps are held to atol 1e-5, rtol 1e-4 on batches whose gradients the
# port's own ZeRO-1 test holds there
ZERO1_SEED = 20


@pytest.fixture(scope="module")
def masks():
    return MaskTable((0, 1), configs.get_smoke_config("cosmoflow-128"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run, started at the first test that needs it; it
    runs beside the pool."""
    root = tmp_path_factory.mktemp("compose_ref")
    cfg = configs.get_smoke_config("cosmoflow-128")
    config = _config(PIPE_ORACLE)
    inputs = {f"p_{k}": v.numpy() for k, v in for_config(cfg).init_params(
        cfg, torch.Generator().manual_seed(config.seed), "cpu").items()}
    for t in range(2):  # the batches of tests/test_torch_zero1.py
        inputs[f"x{t}"], inputs[f"y{t}"] = _batch(cfg, ZERO1_SEED + t)
    inputs["px"], inputs["py"] = _batch(cfg, 30)
    np.savez(root / "inputs.npz", **inputs)
    path = str(root / "reference.npz")
    script = (f"OUT = {path!r}\nINPUTS = {str(root / 'inputs.npz')!r}\n"
              f"GB = {GB}\nM = {PIPE_ORACLE['M']}\n" + REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
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


def probe_job(spec, masks):
    """Step 1's ``grad_comm`` probe of a pipelined session over
    processes: (loss, every group's merged gradients, on every rank)."""
    cfg = configs.get_smoke_config(MODELS[spec["model"]])
    x, y = map(torch.from_numpy, _batch(cfg, 30))
    with compile(_config(spec), devices=["cpu"] * spec["D"],
                 mask_source=masks) as sess:
        probe = train_step.make_pipeline_train_step(
            sess.cfg, sess.meshes, sess.optimizer, plan=sess.plan,
            global_batch=GB, stage="grad_comm", mask_source=masks)
        return probe(sess.params, sess.opt_state, x, y, 0)


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def test_pipelined_step1_matches_the_reference_oracle(pool, reference,
                                                      masks):
    reference = reference()
    got = pool.run(probe_job, PIPE_ORACLE, masks)
    want_loss = float(reference["oracle_loss"])
    for rank, (loss, grads) in enumerate(got):
        assert torch.equal(loss, got[0][0]), rank
        assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
        assert {f"oracle_{k}" for k in grads} == {
            k for k in reference if k.startswith("oracle_") and
            k != "oracle_loss"}
        bad = {k: e for k, v in grads.items() if (e := _scale_err(
            v.numpy(), reference[f"oracle_{k}"])) > 1e-5}
        assert not bad, (rank, bad)


def test_process_zero1_matches_the_reference(pool, reference, masks):
    reference = reference()
    init = {k[len("init_"):]: v for k, v in reference.items()
            if k.startswith("init_")}
    got = pool.run(train_job, _spec("cosmo", 2, 2, "reduce_scatter"), 2,
                   None, init, masks, ZERO1_SEED)
    for rank, out in enumerate(got):
        params = out["state"][0]
        bad = [(k, float(np.max(np.abs(v.numpy() - reference[f"final_{k}"]))))
               for k, v in params.items()
               if not np.allclose(v.numpy(), reference[f"final_{k}"],
                                  atol=ATOL, rtol=RTOL)]
        assert not bad, (rank, bad)
        assert _same(params, got[0]["state"][0]), rank
