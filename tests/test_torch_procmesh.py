"""The process mesh (``launch.mesh.ProcessMesh``: one process a shard,
``core/spmd.py``'s collectives through ``torch.distributed``) against
the in-process mesh, on the CPU over gloo.

One 4-process world (``launch.dist.Pool``: the spawn start method, a
``file://`` rendezvous in the module's temporary directory, one intra-op
thread a child) serves every case: the 1 x 2 meshes on ranks 0-1, the
1 x 4 and 2 x 2 meshes on all four. The in-process mesh runs in this
process while the children work.

* every collective of the interface and its adjoint (``ppermute``, the
  asynchronous ``ppermute_start``, ``psum`` with a number, ``all_gather``,
  ``all_to_all``, ``psum_scatter``, ``psum_grad``) gives each rank the
  in-process shard's values, bit for bit;
* SMOKE CosmoFlow and the SMOKE U-Net (16^3) train 2 steps at 1 x 2,
  1 x 4 and 2 x 2 under ``overlap`` and ``monolithic``: losses,
  parameters and optimizer state bitwise the in-process mesh's, and
  every rank issued the same collectives in the same order (their
  backward's reduction hooks among them);
* a 2 x 2 checkpoint is byte for byte the in-process run's, and a
  process mesh restoring it steps bitwise as the in-process one does;
* depth-split serving equals the in-process serving; ``evaluate``
  gathers the predictions on every rank;
* a world whose size is not data x spatial raises; ``plan="auto"`` over
  processes compiles the plan one process chooses and trains as it does
  (ZeRO-1, remat and pipeline groups over processes:
  ``tests/test_torch_procmesh_compose.py``; the loader, the harness and
  the supervisor: ``tests/test_torch_procmesh_io.py``; the planner's
  layouts, budgets and released ranks:
  ``tests/test_torch_procmesh_plans.py``).
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session, compile
from repro_torch.core import spmd
from repro_torch.core.tree import key_paths
from repro_torch.launch import dist as dist_lib
from repro_torch.launch import mesh as mesh_lib

WORLD = 4
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
COLLECTIVES = ("ppermute", "ppermute_start", "psum", "all_gather",
               "all_to_all", "psum_scatter", "psum_grad")
GB = 4


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
    root = tmp_path_factory.mktemp("procmesh")
    p = dist_lib.Pool(WORLD, "file://" + str(root / "rendezvous"),
                      timeout_s=240)
    # a lowered priority: the other test workers' timed steps go first
    p.run(os.nice, 10)
    yield p
    p.close()


def _ranks(D, S):
    return tuple(range(D * S))


# ------------------------------------------------------ collectives ----
def _inputs(n):
    g = torch.Generator().manual_seed(5)
    return ([torch.randn(4, 6, 2, generator=g) for _ in range(n)],
            [torch.randn(4, 6, 2, generator=g) for _ in range(n)])


def _collective(name, x, ct):
    """One collective over the mesh's ``model`` axis (``psum_grad`` over
    both) of the shard's ``x``; its output and the gradient of
    ``(out * ct).sum()`` (the adjoint of ``ct``)."""
    x = x.clone().requires_grad_(True)
    g = spmd.axis("model")
    shift = [(i, i + 1) for i in range(g.size - 1)]
    if name == "ppermute":
        out = g.ppermute(x, shift)
    elif name == "ppermute_start":
        pending = g.ppermute_start(x, [(i, (i + 1) % g.size)
                                       for i in range(g.size)])
        local = x * 2  # work between the start and the wait
        out = pending.wait() + local
    elif name == "psum":
        out, n = g.psum((x, 1.5))
        out = out * n
    elif name == "all_gather":
        out = g.all_gather(x, 1)
    elif name == "all_to_all":
        out = g.all_to_all(x, 0, 1)
    elif name == "psum_scatter":
        with torch.no_grad():
            return g.psum_scatter(x, 0), None
    else:
        out = spmd.axis(("data", "model")).psum_grad((x,))[0] * 3
    if name == "all_gather":
        ct = torch.cat([ct] * g.size, 1)
    elif name == "all_to_all":
        ct = ct.reshape(out.shape)
    (grad,) = torch.autograd.grad((out * ct).sum(), [x], allow_unused=True)
    return out.detach(), torch.zeros_like(x) if grad is None else grad


def collectives_job(axes):
    mesh = mesh_lib.ProcessMesh(axes, ["cpu"] * len(dist_lib.world()))
    xs, cts = _inputs(mesh.size)
    out = {}
    for name in COLLECTIVES:
        out[name] = spmd.run(mesh, lambda x, ct, _n=name: _collective(
            _n, x, ct), [xs[mesh.rank]], [cts[mesh.rank]])[0]
    return mesh.transport, out


def _in_process_collectives(axes):
    mesh = mesh_lib.Mesh(axes, ["cpu"] * math.prod(n for _, n in axes))
    xs, cts = _inputs(mesh.size)
    out = {}
    for name in COLLECTIVES:
        leaves = [x.clone().requires_grad_(name != "psum_scatter")
                  for x in xs]

        def body(x, ct, _n=name):
            g = spmd.axis("model")
            shift = [(i, i + 1) for i in range(g.size - 1)]
            if _n == "ppermute":
                return g.ppermute(x, shift)
            if _n == "ppermute_start":
                pending = g.ppermute_start(x, [(i, (i + 1) % g.size)
                                               for i in range(g.size)])
                local = x * 2
                return pending.wait() + local
            if _n == "psum":
                s, n = g.psum((x, 1.5))
                return s * n
            if _n == "all_gather":
                return g.all_gather(x, 1)
            if _n == "all_to_all":
                return g.all_to_all(x, 0, 1)
            if _n == "psum_scatter":
                with torch.no_grad():
                    return g.psum_scatter(x, 0)
            return spmd.axis(("data", "model")).psum_grad((x,))[0] * 3

        outs = spmd.run(mesh, body, leaves, cts)
        if name == "psum_scatter":
            out[name] = [(o, None) for o in outs]
            continue
        size = mesh.degree("model")
        weights = []
        for o, ct in zip(outs, cts):
            if name == "all_gather":
                ct = torch.cat([ct] * size, 1)
            elif name == "all_to_all":
                ct = ct.reshape(o.shape)
            weights.append(ct)
        total = sum((o * c).sum() for o, c in zip(outs, weights))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        out[name] = [(o.detach(), torch.zeros_like(x) if g is None else g)
                     for o, g, x in zip(outs, grads, leaves)]
    return out


@pytest.fixture(scope="module")
def collectives(pool):
    got = {}
    for key, (D, S) in MESHES.items():
        axes = [("data", D), ("model", S)]
        ranks = pool.submit(collectives_job, axes, ranks=_ranks(D, S))
        want = _in_process_collectives(axes)
        got[key] = (pool.result(ranks, f"collectives {key}"), want)
    return got


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_collective_and_adjoint_match_in_process(collectives, mesh, name):
    got, want = collectives[mesh]
    for rank, (transport, outs) in enumerate(got):
        assert transport == "gloo"
        out, grad = outs[name]
        w_out, w_grad = want[name][rank]
        assert torch.equal(out, w_out), (rank, name)
        assert (grad is None) == (w_grad is None)
        if grad is not None:
            assert torch.equal(grad, w_grad), (rank, name)


# --------------------------------------------------------- training ----
def _config(model, D, S, grad_comm, **kw):
    return RunConfig(model=model, smoke=True, global_batch=GB, data=D,
                     spatial=S, grad_comm=grad_comm, **kw)


def _batch(cfg, t):
    r = np.random.RandomState(11 + t)
    w = cfg.input_width
    x = r.randn(GB, w, w, w, cfg.in_channels).astype(np.float32)
    if cfg.arch == "unet3d":
        return x, r.randint(0, cfg.out_dim, (GB, w, w, w)).astype(np.int32)
    return x, r.randn(GB, cfg.out_dim).astype(np.float32)


def _state(sess):
    return ({k: v.clone() for k, v in sess.params.items()},
            [(p, v.clone()) for p, v in key_paths(sess.opt_state)])


def train_job(model, D, S, grad_comm, ckpt=None, steps=2):
    """``steps`` steps of a session (this process a shard, or every
    shard when no process group is up), then, with ``ckpt``, a save, a
    restore and one more step."""
    config = _config(model, D, S, grad_comm)
    with compile(config, devices=["cpu"] * (D * S)) as sess:
        losses = [float(sess.step(*_batch(sess.cfg, t)))
                  for t in range(steps)]
        out = {"losses": losses, "state": _state(sess),
               "describe": sess.describe(),
               "log": list(getattr(sess.mesh, "log", ()))}
        if ckpt is not None:
            sess.save(ckpt)
    if ckpt is not None:
        with Session.restore(ckpt, devices=["cpu"] * (D * S)) as again:
            out["resumed"] = float(again.step(*_batch(again.cfg, steps)))
            out["resumed_state"] = _state(again)
    return out


def _same_state(a, b):
    params_a, opt_a = a
    params_b, opt_b = b
    return (set(params_a) == set(params_b)
            and all(torch.equal(params_a[k], params_b[k]) for k in params_a)
            and [p for p, _ in opt_a] == [p for p, _ in opt_b]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(opt_a, opt_b)))


@pytest.mark.parametrize("grad_comm", ["overlap", "monolithic"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["cosmoflow-128", "unet3d-256"])
def test_training_is_bitwise_the_in_process_mesh(pool, model, mesh,
                                                 grad_comm):
    D, S = MESHES[mesh]
    ranks = pool.submit(train_job, model, D, S, grad_comm,
                        ranks=_ranks(D, S))
    want = train_job(model, D, S, grad_comm)
    got = pool.result(ranks, f"train {model} {mesh} {grad_comm}")
    assert want["describe"].transport is None
    for rank, out in enumerate(got):
        assert out["describe"].transport == "gloo"
        assert out["describe"].process_rank == rank
        assert out["losses"] == want["losses"], rank
        assert _same_state(out["state"], want["state"]), rank
        # every rank met the same collectives in the same order, the
        # backward's reduction hooks (``psum_grad``) among them
        assert out["log"] == got[0]["log"], rank
    kinds = [k for k, _, _ in got[0]["log"]]
    assert ("psum_grad" in kinds) == (grad_comm == "overlap")


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


def test_checkpoint_bytes_and_resume_match_in_process(pool, tmp_path):
    ranks = pool.submit(train_job, "cosmoflow-128", 2, 2, "overlap",
                        str(tmp_path / "procs"), ranks=_ranks(2, 2))
    want = train_job("cosmoflow-128", 2, 2, "overlap",
                     str(tmp_path / "threads"))
    got = pool.result(ranks, "checkpoint")
    procs, threads = (_files(tmp_path / "procs"),
                      _files(tmp_path / "threads"))
    assert sorted(procs) == sorted(threads) and procs == threads
    for out in got:
        assert out["resumed"] == want["resumed"]
        assert _same_state(out["resumed_state"], want["resumed_state"])


# ---------------------------------------------------------- serving ----
def serve_job(model, S):
    config = RunConfig(model=model, smoke=True, mode="infer",
                       global_batch=2, spatial=S)
    with compile(config, devices=["cpu"] * S) as sess:
        cfg = sess.cfg
        x, y = _batch(cfg, 0)
        pred = sess.predict(x[:2])
        return pred, sess.describe()


def eval_job(model, D, S):
    with compile(_config(model, D, S, "overlap"),
                 devices=["cpu"] * (D * S)) as sess:
        return sess.evaluate(*_batch(sess.cfg, 3))


@pytest.mark.parametrize("model", ["cosmoflow-128", "unet3d-256"])
def test_spatial_serving_and_evaluate_match_in_process(pool, model):
    serving = pool.submit(serve_job, model, 2, ranks=(0, 1))
    evals = pool.submit(eval_job, model, 1, 2, ranks=(2, 3))
    want_pred, want_report = serve_job(model, 2)
    want_loss, want_eval = eval_job(model, 1, 2)
    for pred, report in pool.result(serving, "serve"):
        assert torch.equal(pred, want_pred)
        assert report.transport == "gloo" and want_report.transport is None
        assert report.mesh_shape == want_report.mesh_shape
    for loss, preds in pool.result(evals, "evaluate"):
        assert torch.equal(loss, want_loss)
        assert torch.equal(preds, want_eval)


# ------------------------------------------------ the plan and world ----
def refusal_job():
    """The error a world that is not data x spatial raises, as (type
    name, message)."""
    devs = ["cpu"] * len(dist_lib.world())
    try:
        compile(_config("cosmoflow-128", 1, 4, "overlap"), devices=devs)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return type(e).__name__, str(e)
    return None, None


def auto_job(model):
    """A 1 x 2 ``plan="auto"`` session (over the pool's ranks 0-1, or in
    one process): its plan and 2 steps' losses."""
    with compile(dataclasses.replace(_config(model, 1, 2, "overlap"),
                                     plan="auto"),
                 devices=["cpu"] * 2) as sess:
        return sess.plan, [float(sess.step(*_batch(sess.cfg, t)))
                           for t in range(2)]


@pytest.mark.parametrize("model", ["cosmoflow-128", "unet3d-256"])
def test_plan_auto_over_the_pool_compiles_the_in_process_choice(pool, model):
    ranks = pool.submit(auto_job, model, ranks=(0, 1))
    want = auto_job(model)
    assert want[0].name.endswith(".batch")  # the planner batches deep layers
    assert pool.result(ranks, f"auto {model}") == [want, want]


def test_a_world_that_is_not_data_x_spatial_raises(pool):
    for kind, msg in pool.run(refusal_job, ranks=(0, 1)):
        assert kind == "RunConfigError" and "world" in msg, msg


@pytest.mark.parametrize("hosts,devices,want", [
    (("a", "a"), ("cuda:0", "cuda:1"), "nccl"),
    (("a", "a"), ("cuda:0", "cuda:0"), "gloo"),
    (("a", "b"), ("cuda:0", "cuda:0"), "nccl"),
    (("a", "a"), ("cpu", "cpu"), "gloo"),
    (("a", "a"), ("cuda:0", "cpu"), "gloo")])
def test_transport_follows_placement(hosts, devices, want):
    assert mesh_lib.placement_transport(
        hosts, [torch.device(d) for d in devices]) == want


def test_entry_points_stay_in_process_without_a_process_group():
    assert not dist_lib.wanted()
    with compile(_config("cosmoflow-128", 1, 2, "overlap"),
                 devices=["cpu"] * 2) as sess:
        assert type(sess.mesh) is mesh_lib.Mesh
        assert sess.mesh.local_ranks == (0, 1)
