"""The per-rank loader, the serving harness and the supervisor over the
process mesh (``launch.mesh.ProcessMesh``: one process a shard) against
the in-process mesh, on the CPU over gloo.

One 4-process world (``launch.dist.Pool``: spawned, a ``file://``
rendezvous in the module's temporary directory, one intra-op thread a
child, a child limit so that a deadlock fails the test instead of
hanging it) serves every case; the in-process runs go in this process
while the children work. Every store is written here once.

* the loader (sync and ``prefetch=2``) at 1 x 2 and 2 x 2, SMOKE
  CosmoFlow and the SMOKE U-Net: each rank's blocks bitwise its slice
  of the in-process loader's global batch (``block_index``), each rank's
  ``rank_pfs_bytes`` over the first epoch exactly its hyperslab and,
  summed over the ranks (``gather_stats``), the in-process loader's
  dict (later epochs differ at D > 1: a sample that moves to another
  data rank is read again there, where the in-process cache hands it
  over); 3 loader-fed steps' losses and the parameters bitwise the in-process run's; a pipelined
  run (two groups) fed by the loader, its entry group reading x and its
  loss group y;
* the harness (``workers=2``): predictions bitwise the in-process
  harness's and telemetry on rank 0; full batches of 4; a
  ``serve.forward`` fault on one follower fails that batch on rank 0
  with its error and the next batches are served;
* the supervisor, loader-fed, ZeRO-1 2 x 2: a crash at step 3 on every
  rank and a persistent ``loader.read`` error on rank 1 alone recover to
  the unfaulted run's losses and parameters, bitwise (and the in-process
  unfaulted run's); ``DeviceLost(available=2)`` on rank 2 alone re-plans
  ranks 0-1 to 1 x 2 with the in-process supervisor's events and losses,
  and releases ranks 2-3;
* the launcher under a process group reads the loader: its losses are
  the in-process launcher's, bitwise;
* against the JAX package (one subprocess with 4 forced host devices,
  beside the pool): the ranks' blocks, assembled, are the reference
  ``SpatialParallelLoader.load_batch``'s on the same store, seed and
  schedule, and each rank's bytes the reference's reads for that rank;
  the harness's predictions from the reference's initial parameters
  (``params_from_numpy``) within 1e-5 of the reference forward.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.api import RunConfig, compile, supervisor
from repro_torch.core import faults
from repro_torch.data import store, synthetic
from repro_torch.launch import dist as dist_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import cosmoflow
from repro_torch.train import train_step

from conftest import SRC

WORLD = 4
GB = 4
SAMPLES = 8
STEPS = 3
MODELS = {"cosmo": "cosmoflow-128", "unet": "unet3d-256"}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
PRED_TOL = 1e-5


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
    root = tmp_path_factory.mktemp("procmesh_io")
    p = dist_lib.Pool(WORLD, "file://" + str(root / "rendezvous"),
                      timeout_s=240)
    # a lowered priority: the other test workers' timed steps go first
    p.run(os.nice, 10)
    yield p
    p.close()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One store a model, ``SAMPLES`` volumes at its SMOKE width."""
    root = tmp_path_factory.mktemp("procmesh_io_stores")
    out = {}
    for key, name in MODELS.items():
        cfg = configs.get_smoke_config(name)
        path = str(root / key)
        if cfg.arch == "cosmoflow":
            cubes, targets = synthetic.make_cosmology_dataset(
                SAMPLES, cfg.input_width, channels=cfg.in_channels, seed=3)
            store.write_dataset(path, cubes, targets)
        else:
            vols, labels = synthetic.make_segmentation_dataset(
                SAMPLES, cfg.input_width, num_classes=cfg.out_dim,
                channels=cfg.in_channels, seed=4)
            store.write_dataset(path, vols, labels=labels)
        out[key] = path
    return out


def _ranks(n):
    return tuple(range(n))


def _config(model, D, S, **kw):
    return RunConfig(model=MODELS[model], smoke=True, global_batch=GB,
                     data=D, spatial=S, **kw)


def _plan(model, D, S):
    with compile(_config(model, D, S), devices=["cpu"] * (D * S)) as sess:
        return sess.plan


def _copy(b):
    if b is None:
        return None
    return (b.t if isinstance(b, train_step.Block) else b).clone()


# ------------------------------------------------------------ loader ----
def loader_job(model, D, S, root, prefetch, P=1, plan="fixed"):
    """``STEPS`` steps fed by the session's loader (this process a shard,
    or every shard when no process group is up; ``P`` pipeline groups,
    ``D`` the total; ``plan`` the config's): each step's batch as the
    loader gave it (a rank's blocks over processes), the losses, the
    parameters, the counters."""
    kw = {"plan": plan}
    if P > 1:
        kw.update(pipeline=P, micro_batches=2, grad_clip=0.0)
    with compile(_config(model, D, S, **kw),
                 devices=["cpu"] * (D * S)) as sess:
        loader = sess.make_loader(root, prefetch=prefetch)
        bpe = SAMPLES // GB
        batches, losses, out = [], [], {}
        for t in range(STEPS):
            epoch, b = divmod(t, bpe)
            order = loader.schedule_for_epoch(epoch)
            batch = loader.load_batch(order[b * GB:(b + 1) * GB])
            batches.append(tuple(_copy(v) for v in batch))
            losses.append(float(sess.step(batch)))
            if t == bpe - 1:  # epoch 0's reads: every sample once
                out.update(rank_pfs=dict(loader.stats.rank_pfs_bytes),
                           gathered=loader.gather_stats())
        return dict(out, batches=batches, losses=losses, params={
            k: v.clone() for k, v in sess.params.items()}, plan=sess.plan,
            redistributed=loader.stats.cache_bytes_redistributed,
            kinds=[type(v).__name__ for v in batch],
            rank=getattr(sess.mesh, "rank", None))


def _slab_bytes(cfg, S):
    """One sample's hyperslab at spatial degree S: x's, and the U-Net's
    voxel labels'."""
    w, c = cfg.input_width, cfg.in_channels
    x = (w // S) * w * w * c * 4
    return x + ((w // S) * w * w * 4 if cfg.arch == "unet3d" else 0)


CASES = [(model, mesh, pf) for model in sorted(MODELS)
         for mesh in sorted(MESHES) for pf in (0, 2)]


@pytest.mark.parametrize("model,mesh,prefetch", CASES)
def test_each_rank_reads_its_blocks_and_trains_bitwise(pool, stores, model,
                                                       mesh, prefetch):
    D, S = MESHES[mesh]
    root = stores[model]
    ranks = pool.submit(loader_job, model, D, S, root, prefetch,
                        ranks=_ranks(D * S))
    want = loader_job(model, D, S, root, prefetch)
    got = pool.result(ranks, f"loader {model} {mesh} pf={prefetch}")
    cfg = configs.get_smoke_config(MODELS[model])
    plan = _plan(model, D, S)
    ref_mesh = mesh_lib.Mesh(plan.mesh_axes, ["cpu"] * (D * S))
    entry = plan.stages[0]
    for rank, out in enumerate(got):
        assert out["rank"] == rank
        assert out["kinds"] == ["Block", "Block"]
        assert out["losses"] == want["losses"], rank
        assert all(torch.equal(v, want["params"][k])
                   for k, v in out["params"].items()), rank
        for (x, y), (wx, wy) in zip(out["batches"], want["batches"]):
            assert torch.equal(x, wx[train_step.block_index(
                wx.shape, ref_mesh, rank, entry)])
            if cfg.arch == "unet3d":
                wy = wy[train_step.block_index(wy.shape, ref_mesh, rank,
                                               entry)]
            else:
                index, count = train_step.batch_slice(ref_mesh, rank, entry)
                n = GB // count
                wy = wy[index * n:(index + 1) * n]
            assert torch.equal(y, wy)
        # its own reads alone: 1/S of a volume a sample of its rows
        assert out["rank_pfs"] == {
            rank: SAMPLES // D * _slab_bytes(cfg, S)}, rank
        assert out["redistributed"] == 0
        assert out["gathered"].rank_pfs_bytes == want["rank_pfs"]
        assert out["gathered"].pfs_bytes == want["gathered"].pfs_bytes


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_pipelined_run_fed_by_the_loader_is_bitwise(pool, stores, model):
    root = stores[model]
    ranks = pool.submit(loader_job, model, 2, 1, root, 0, 2,
                        ranks=_ranks(2))
    want = loader_job(model, 2, 1, root, 0, 2)
    got = pool.result(ranks, f"pipelined loader {model}")
    loss_group = 0 if model == "unet" else 1
    for rank, out in enumerate(got):
        assert out["losses"] == want["losses"], rank
        assert all(torch.equal(v, want["params"][k])
                   for k, v in out["params"].items()), rank
        # the entry group reads x, the loss group y
        assert out["kinds"][0] == ("Block" if rank == 0 else "NoneType")
        assert out["kinds"][1] == ("Block" if rank == loss_group
                                   else "NoneType")


def test_a_block_of_the_wrong_shape_raises(pool, stores):
    for kind, msg in pool.run(bad_block_job, stores["cosmo"], ranks=(0, 1)):
        assert kind == "ValueError" and "block of x" in msg, msg


def bad_block_job(root):
    with compile(_config("cosmo", 1, 2), devices=["cpu"] * 2) as sess:
        loader = sess.make_loader(root)
        x, y = loader.load_batch(np.arange(GB))
        try:
            sess.step(train_step.RankBatch(
                x.map(lambda t: t[:, 1:]), y))
        except ValueError as e:
            return type(e).__name__, str(e)
    return None, None


def poisoned_job(root):
    """Two loader-fed steps, the second's blocks poisoned by the
    ``grads.nonfinite`` site: the skipped steps and the parameters."""
    with faults.active(faults.FaultSpec("grads.nonfinite", at_steps=(1,))):
        with compile(_config("cosmo", 1, 2),
                     devices=["cpu"] * 2) as sess:
            loader = sess.make_loader(root)
            order = loader.schedule_for_epoch(0)
            for t in range(2):
                sess.step(loader.load_batch(order[t * GB:(t + 1) * GB]))
            return (sess.telemetry()["skipped_steps"],
                    {k: v.clone() for k, v in sess.params.items()})


def test_a_poisoned_block_skips_the_step_on_every_rank(pool, stores):
    ranks = pool.submit(poisoned_job, stores["cosmo"], ranks=(0, 1))
    skipped, params = poisoned_job(stores["cosmo"])
    assert skipped == 1
    for got_skipped, got in pool.result(ranks, "poisoned"):
        assert got_skipped == 1
        assert all(torch.equal(v, params[k]) for k, v in got.items())


# ----------------------------------------------------------- harness ----
def _volumes(n, seed=21):
    cfg = configs.get_smoke_config(MODELS["cosmo"])
    w = cfg.input_width
    return np.random.RandomState(seed).randn(
        n, w, w, w, cfg.in_channels).astype(np.float32)


def harness_job(S, xs, workers, max_batch, fail_rank=None, init=None):
    """Serve ``xs`` through ``serve()`` (rank 0's harness, the other
    ranks following it; or in one process): the replies (or their
    errors) and rank 0's telemetry. ``fail_rank``: that rank's first
    ``serve.forward`` raises. ``init``: the reference's parameters."""
    config = RunConfig(model=MODELS["cosmo"], smoke=True, mode="infer",
                       global_batch=max_batch, spatial=S)
    rank = torch.distributed.get_rank() if dist_lib.initialized() else 0
    spec = ([faults.FaultSpec("serve.forward", at_calls=(0,))]
            if rank == fail_rank else [])
    with faults.active(*spec), compile(config,
                                       devices=["cpu"] * S) as sess:
        if init is not None:
            sess.params = sess._cast_once(cosmoflow.params_from_numpy(
                init, sess.device, cfg=sess.cfg))
        h = sess.serve(max_batch=max_batch, max_wait_ms=5000.0,
                       workers=workers)
        if type(h).__name__ == "ServingFollower":
            h.close()
            return {"rank": rank, "follower": True, "batches": h.batches}
        replies = []
        for i in range(0, len(xs), max_batch):
            futs = h.submit_many(xs[i:i + max_batch])
            for f in futs:
                try:
                    replies.append(f.result(timeout=120))
                except Exception as e:  # noqa: BLE001 — the reply
                    replies.append(f"{type(e).__name__}: {e}")
        h.close()
        tele = sess.telemetry()
        return {"rank": rank, "follower": False, "replies": replies,
                "telemetry": {k: v for k, v in tele.items()
                              if "latency" not in k}}


@pytest.mark.parametrize("workers,max_batch", [(2, 1), (1, 4)])
def test_the_harness_over_processes_is_the_in_process_harness(
        pool, workers, max_batch):
    xs = _volumes(8)
    ranks = pool.submit(harness_job, 2, xs, workers, max_batch,
                        ranks=(0, 1))
    want = harness_job(2, xs, workers, max_batch)
    front, follower = pool.result(ranks, "harness")
    assert not front["follower"] and follower["follower"]
    assert follower["batches"] == len(xs) // max_batch
    assert len(front["replies"]) == len(xs)
    for got, w in zip(front["replies"], want["replies"]):
        assert np.array_equal(got, w)
    assert front["telemetry"] == want["telemetry"]
    assert front["telemetry"]["serve.requests"] == len(xs)
    assert front["telemetry"]["serve.worker_failures"] == 0


def test_a_follower_that_fails_fails_the_batch_on_rank_0(pool):
    xs = _volumes(4)
    front, follower = pool.run(harness_job, 2, xs, 1, 1, 1, ranks=(0, 1))
    first, rest = front["replies"][0], front["replies"][1:]
    assert isinstance(first, str) and "rank 1" in first, first
    assert "injected serving forward error" in first
    want = harness_job(2, xs[1:], 1, 1)["replies"]
    assert all(np.array_equal(a, b) for a, b in zip(rest, want))
    assert front["telemetry"]["serve.worker_failures"] == 1
    assert follower["batches"] == 3


# -------------------------------------------------------- supervisor ----
def supervise_job(root, data_dir, crash_at=None, read_fault_rank=None,
                  lost_rank=None, steps=6, pipeline=1):
    """A loader-fed ZeRO-1 2 x 2 run under the supervisor (every rank,
    or in one process): ``crash_at`` an ``InjectedCrash`` at that step on
    every rank, ``read_fault_rank`` a persistent ``loader.read`` error on
    that rank (every attempt of one read), ``lost_rank`` a
    ``DeviceLost(available=2)`` at step 3 on that rank."""
    rank = torch.distributed.get_rank() if dist_lib.initialized() else None
    specs = []
    if read_fault_rank is not None and rank in (read_fault_rank, None):
        specs.append(faults.FaultSpec("loader.read", at_calls=(2, 3, 4, 5)))
    if lost_rank is not None and rank in (lost_rank, None):
        specs.append(faults.FaultSpec("device.loss", at_steps=(3,),
                                      max_fires=1, available=2))
    real = supervisor._loader_batch_fn
    fired = []

    def batch_fn(sess, config):
        make = real(sess, config)

        def crashing(t):
            if t == crash_at and not fired:
                fired.append(t)
                raise faults.InjectedCrash("loader.read",
                                           f"injected crash at step {t}")
            return make(t)
        return crashing

    config = RunConfig(model=MODELS["cosmo"], smoke=True, global_batch=GB,
                       data=2, spatial=2, grad_comm="reduce_scatter",
                       checkpoint_dir=root, data_dir=data_dir)
    if pipeline > 1:  # two groups of two shards, data-parallel
        config = dataclasses.replace(
            config, data=4, spatial=1, grad_comm="overlap",
            pipeline=pipeline, micro_batches=2, grad_clip=0.0)
    supervisor._loader_batch_fn = batch_fn
    try:
        with faults.active(*specs):
            r = supervisor.run(config, steps, save_every=2,
                               devices=["cpu"] * 4)
    finally:
        supervisor._loader_batch_fn = real
    out = {"losses": r.losses, "events": r.events, "restarts": r.restarts,
           "replans": r.replans, "released": r.released,
           "final": (r.final_data, r.final_spatial),
           "recovery_s": r.recovery_s}
    if r.session is not None:
        out["params"] = {k: v.clone() for k, v in r.session.params.items()}
        out["mesh"] = r.session.mesh.shape
        out["groups"] = r.session.plan.n_groups
        r.session.close()
    return out


def test_supervised_recovery_over_processes_is_bitwise(pool, stores,
                                                       tmp_path):
    clean = pool.submit(supervise_job, str(tmp_path / "clean"),
                        stores["cosmo"])
    want = supervise_job(str(tmp_path / "threads"), stores["cosmo"])
    clean = pool.result(clean, "supervise clean")
    got = pool.run(supervise_job, str(tmp_path / "faulted"),
                   stores["cosmo"], 3, 1)
    for rank, (c, g) in enumerate(zip(clean, got)):
        assert c["losses"] == want["losses"], rank
        assert g["losses"] == want["losses"], rank
        assert all(torch.equal(v, want["params"][k])
                   for k, v in g["params"].items()), rank
        assert g["restarts"] == 2 and g["events"] == got[0]["events"], rank
        assert len(g["recovery_s"]) == 2
    events = got[0]["events"]
    assert any("StoreReadError" in e for e in events), events
    assert any("InjectedCrash" in e for e in events), events


@pytest.mark.parametrize("pipeline", [1, 2])
def test_elastic_replan_over_processes_releases_ranks(pool, stores,
                                                      tmp_path, pipeline):
    """2 x 2 ZeRO-1 re-plans to 1 x 2; two pipeline groups of two
    shards to two groups of one (data 2 in all, spatial 1)."""
    ranks = pool.submit(supervise_job, str(tmp_path / "procs"),
                        stores["cosmo"], None, None, 2, 6, pipeline)
    want = supervise_job(str(tmp_path / "threads"), stores["cosmo"],
                         lost_rank=2, pipeline=pipeline)
    got = pool.result(ranks, "elastic")
    final = (1, 2) if pipeline == 1 else (2, 1)
    assert want["final"] == final and want["replans"] == 1
    assert want["groups"] == pipeline
    for rank, out in enumerate(got):
        if rank < 2:
            assert not out["released"], rank
            assert out["events"] == want["events"], rank
            assert out["losses"] == want["losses"], rank
            assert out["final"] == final
            assert out["mesh"] == ({"data": 1, "model": 2} if pipeline == 1
                                   else want["mesh"])
            assert out["groups"] == pipeline
            assert all(torch.equal(v, want["params"][k])
                       for k, v in out["params"].items()), rank
        else:
            assert out["released"] and "params" not in out, rank
            assert out["events"][:-1] == want["events"][:3], rank
            assert out["events"][-1].startswith("released"), rank


# ---------------------------------------------------------- launcher ----
def launcher_job(argv):
    """``launch.train.main`` with each step's loss recorded."""
    from repro_torch.api import session as session_lib

    losses = []
    real = session_lib.Session.step

    def step(self, *a, **k):
        out = real(self, *a, **k)
        losses.append(float(out))
        return out

    session_lib.Session.step = step
    try:
        launch_train.main(argv + ["--device", "cpu"])
    finally:
        session_lib.Session.step = real
    return losses


def test_the_launcher_over_processes_reads_the_loader(pool):
    argv = ["--arch", "cosmoflow-128", "--steps", "3", "--batch", "4",
            "--model", "2"]
    ranks = pool.submit(launcher_job, argv, ranks=(0, 1))
    want = launcher_job(argv)
    for losses in pool.result(ranks, "launcher"):
        assert losses == want and len(losses) == 3


def test_a_loader_fed_plan_auto_run_is_the_in_process_run(pool, stores):
    """``plan="auto"`` over the pool compiles the in-process choice (its
    deep layers batch-sharded) and its loader-fed steps are bitwise."""
    root = stores["cosmo"]
    ranks = pool.submit(loader_job, "cosmo", 1, 2, root, 0, 1, "auto",
                        ranks=(0, 1))
    want = loader_job("cosmo", 1, 2, root, 0, 1, "auto")
    assert want["plan"].name.endswith(".batch")
    for rank, out in enumerate(pool.result(ranks, "loader auto")):
        assert out["plan"] == want["plan"], rank
        assert out["losses"] == want["losses"], rank
        assert all(torch.equal(v, want["params"][k])
                   for k, v in out["params"].items()), rank


# -------------------------------------------------- against the JAX ----
REFERENCE = r'''
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.core import compat
from repro.data import pipeline, store
from repro.models import cosmoflow

out = {}
for key, root, voxel in (("cosmo", COSMO, False), ("unet", UNET, True)):
    for D, S in ((1, 2), (2, 2)):
        ld = pipeline.SpatialParallelLoader(
            store.HyperslabStore(root), compat.make_mesh((D, S),
                                                         ("data", "model")),
            P("data", "model", None, None, None), global_batch=GB, seed=0,
            label_spec=P("data", "model", None, None) if voxel else None)
        per_rank = {}
        real = ld._fetch

        def fetch(sample, slab, rank, what="x", _real=real, _ld=ld,
                  _pr=per_rank):
            before = _ld.stats.pfs_bytes
            arr = _real(sample, slab, rank, what)
            _pr[rank] = _pr.get(rank, 0) + _ld.stats.pfs_bytes - before
            return arr

        ld._fetch = fetch
        order = ld.schedule_for_epoch(0)
        for b in range(SAMPLES // GB):
            x, y = ld.load_batch(order[b * GB:(b + 1) * GB])
            out[f"{key}_{D}x{S}_x{b}"] = np.asarray(x)
            out[f"{key}_{D}x{S}_y{b}"] = np.asarray(y)
        out[f"{key}_{D}x{S}_ranks"] = np.array(
            [per_rank.get(r, 0) for r in range(D * S)])
cfg = configs.get_smoke_config("cosmoflow-128")
params = cosmoflow.init_params(jax.random.PRNGKey(0), cfg)
for k, v in params.items():
    out["p_" + k] = np.asarray(v)
vols = np.load(VOLS)
for i in range(len(vols)):
    out[f"pred{i}"] = np.asarray(cosmoflow.forward(
        params, jnp.asarray(vols[i:i + 1]), cfg))
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory, stores):
    """The reference's loads and forwards, started with the module's
    first test; it runs beside the pool."""
    root = tmp_path_factory.mktemp("procmesh_io_ref")
    np.save(root / "vols.npy", _volumes(4))
    path = str(root / "reference.npz")
    script = (f"OUT = {path!r}\nVOLS = {str(root / 'vols.npy')!r}\n"
              f"COSMO = {stores['cosmo']!r}\nUNET = {stores['unet']!r}\n"
              f"GB = {GB}\nSAMPLES = {SAMPLES}\n" + REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
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


def blocks_job(model, D, S, root):
    """Epoch 0's batches through this rank's loader: its blocks, and its
    bytes read."""
    with compile(_config(model, D, S), devices=["cpu"] * (D * S)) as sess:
        loader = sess.make_loader(root)
        order = loader.schedule_for_epoch(0)
        got = [tuple(_copy(v) for v in loader.load_batch(
            order[b * GB:(b + 1) * GB])) for b in range(SAMPLES // GB)]
        return got, dict(loader.stats.rank_pfs_bytes)


@pytest.mark.parametrize("model,mesh", [(m, k) for m in sorted(MODELS)
                                        for k in sorted(MESHES)])
def test_assembled_blocks_are_the_reference_batch(pool, stores, reference,
                                                  model, mesh):
    D, S = MESHES[mesh]
    got = pool.run(blocks_job, model, D, S, stores[model],
                   ranks=_ranks(D * S))
    ref = reference()
    plan = _plan(model, D, S)
    ref_mesh = mesh_lib.Mesh(plan.mesh_axes, ["cpu"] * (D * S))
    entry = plan.stages[0]
    unet = model == "unet"
    for b in range(SAMPLES // GB):
        want_x = ref[f"{model}_{mesh}_x{b}"]
        want_y = ref[f"{model}_{mesh}_y{b}"]
        x = np.zeros_like(want_x)
        y = np.zeros_like(want_y)
        for rank, (batches, _) in enumerate(got):
            bx, by = batches[b]
            x[train_step.block_index(x.shape, ref_mesh, rank,
                                     entry)] = bx.numpy()
            if unet:
                y[train_step.block_index(y.shape, ref_mesh, rank,
                                         entry)] = by.numpy()
            else:
                index, count = train_step.batch_slice(ref_mesh, rank, entry)
                n = GB // count
                y[index * n:(index + 1) * n] = by.numpy()
        assert x.tobytes() == want_x.tobytes()
        assert y.tobytes() == want_y.tobytes()
    for rank, (_, pfs) in enumerate(got):
        assert pfs == {rank: int(ref[f"{model}_{mesh}_ranks"][rank])}


def test_harness_predictions_match_the_reference_forward(pool, reference):
    ref = reference()
    init = {k[2:]: v for k, v in ref.items() if k.startswith("p_")}
    xs = _volumes(4)
    front, _ = pool.run(harness_job, 2, xs, 2, 1, None, init, ranks=(0, 1))
    for i, got in enumerate(front["replies"]):
        want = ref[f"pred{i}"][0]
        err = np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))
        assert err <= PRED_TOL, (i, err)
