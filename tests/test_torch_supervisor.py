"""The auto-resume supervisor (``repro_torch.api.supervisor``) against
the reference's ``repro.api.supervisor``, on the CPU.

* ``degrade_config`` gives the reference's degrees and plan policy over
  a grid of (data, spatial, global batch, input width, plan, devices
  left), and both raise with none left;
* ``_adapt_opt_state`` gives the reference's vectors and ``reset`` flag
  on seeded trees: zero-extended and truncated ZeRO-1 buckets, an
  unchanged layout, a changed shape and a mismatched structure;
* a supervised one-device run with a device loss at step 4 follows the
  reference's losses within 1e-5 relative, from the reference's initial
  parameters, batches and dropout masks, with the same recovery
  counters; it equals the port's own run without the fault bitwise
  (losses and every parameter);
* the port's recovery paths: the watchdog, a divergence rollback,
  giving up after ``max_restarts``, a corrupted newest checkpoint walked
  past, loader-fed replay at prefetch 0 and 2, and a 2 x 2 ZeRO-1 mesh
  resumed bitwise after a kill and re-degreed to 1 x 2 with
  ``available=2``;
* that elastic run against the reference's (one 4-device JAX
  subprocess, started before this file's first test), losses within
  1e-5 relative, both ending at 1 x 2;
* a pipelined run (cosmoflow-512 SMOKE at 16^3, data 4 over 2 groups,
  2 micro-batches) that loses devices at step 3 with 2 left: re-planned
  to data 2 spatial 1 and resumed from step 2 as the reference's same
  run (the same subprocess), with every group's parameters and
  optimizer state on its own devices; its losses within 1e-6 of its
  clean run, and as near the reference's as the clean runs are
  (the test's docstring).
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import supervisor as jsupervisor
from repro.api.config import RunConfig as JRunConfig
from repro.core import faults as jfaults
from repro.core import plan as jplan
from repro.core.spatial_conv import SpatialPartitioning as JPartitioning
from repro.models import cosmoflow as jcosmo
from repro.optim import adam as jadam
from repro_torch.api import RunConfig, supervisor
from repro_torch.core import faults
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.data import store, synthetic
from repro_torch.models import cosmoflow
from repro_torch.optim import adam
from repro_torch.train import checkpoint

from conftest import SRC

RTOL = 1e-5
# the numpy batches both packages are given: a pure function of the step
BATCHES = '''
def batch_fn_for(gb, w, cin, out_dim):
    def make(t):
        r = np.random.RandomState(1000 + t)
        return (r.randn(gb, w, w, w, cin).astype(np.float32),
                r.randn(gb, out_dim).astype(np.float32))
    return make
'''
exec(BATCHES)

ELASTIC = BATCHES + r'''
base = RunConfig(model="cosmoflow-512", smoke=True, global_batch=4, data=2,
                 spatial=2, grad_comm="reduce_scatter", total_steps=20)
base = dataclasses.replace(
    base, model=dataclasses.replace(base.resolve_model(), input_width=16))
cfg = base.resolve_model()
init = cosmoflow.init_params(jax.random.PRNGKey(0), cfg)
np.savez(INIT, **{k: np.asarray(v) for k, v in init.items()})
with faults.active(faults.FaultSpec("device.loss", at_steps=(3,),
                                    max_fires=1, available=2)):
    el = supervisor.run(
        dataclasses.replace(base, checkpoint_dir=tempfile.mkdtemp()), 6,
        save_every=2, batch_fn=batch_fn_for(4, 16, cfg.in_channels,
                                            cfg.out_dim))
# a pipelined run (2 groups of 2 data shards) re-planned for 2 devices
pbase = RunConfig(model="cosmoflow-512", smoke=True, global_batch=4, data=4,
                  pipeline=2, micro_batches=2, grad_clip=0.0, total_steps=20)
pbase = dataclasses.replace(pbase, model=cfg)
pclean = supervisor.run(
    dataclasses.replace(pbase, checkpoint_dir=tempfile.mkdtemp()), 6,
    save_every=2, batch_fn=batch_fn_for(4, 16, cfg.in_channels, cfg.out_dim))
with faults.active(faults.FaultSpec("device.loss", at_steps=(3,),
                                    max_fires=1, available=2)):
    pel = supervisor.run(
        dataclasses.replace(pbase, checkpoint_dir=tempfile.mkdtemp()), 6,
        save_every=2, batch_fn=batch_fn_for(4, 16, cfg.in_channels,
                                            cfg.out_dim))


def summary(r):
    return {"losses": r.losses, "events": r.events,
            "final": [r.final_data, r.final_spatial],
            "counters": [r.restarts, r.resumes, r.cold_starts,
                         r.rollbacks, r.replans]}


with open(OUT, "w") as f:
    json.dump(dict(summary(el), pipelined=summary(pel),
                   pipelined_clean=pclean.losses), f)
'''
ELASTIC_HEAD = '''
import dataclasses, json, tempfile
import numpy as np
import jax
from repro.api.config import RunConfig
from repro.api import supervisor
from repro.core import faults
from repro.models import cosmoflow
'''


class _Pending:
    """The reference's subprocess, started at once; ``result()`` waits for
    it (the port-only tests run meanwhile)."""

    def __init__(self, script: str, out: str, init: str):
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        # at a lowered priority: it runs beside this module's timed steps
        # (the watchdog's 0.5 s budget)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            preexec_fn=lambda: os.nice(10))
        self.paths, self.out = (out, init), None

    def result(self):
        if self.out is None:
            stdout, stderr = self.proc.communicate(timeout=560)
            assert self.proc.returncode == 0, (stdout, stderr)
            with open(self.paths[0]) as f:
                self.out = json.load(f), dict(np.load(self.paths[1]))
        return self.out


@pytest.fixture(scope="module", autouse=True)
def reference_elastic(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    out, init = str(root / "elastic.json"), str(root / "init.npz")
    pending = _Pending(ELASTIC_HEAD + f"OUT = {out!r}\nINIT = {init!r}\n"
                       + ELASTIC, out, init)
    yield pending
    if pending.proc.poll() is None:
        pending.proc.kill()
        pending.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its mesh's shards are threads already (restored after)."""
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


def _base(**kw):
    kw.setdefault("model", "cosmoflow-512")
    kw.setdefault("smoke", True)
    kw.setdefault("global_batch", 2)
    kw.setdefault("total_steps", 20)
    return RunConfig(**kw)


def _params_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@contextlib.contextmanager
def _as_reference(init):
    """The port's ``init_params`` and default dropout masks replaced by
    the reference's initial parameters and masks (its compile draws both
    with ``jax.random``)."""
    with mock.patch.object(
            cosmoflow, "init_params", lambda cfg, g, device:
            cosmoflow.params_from_numpy(init, device, torch.float32,
                                        cfg=cfg)), \
            mock.patch.object(cosmoflow, "generator_masks", jax_masks):
        yield


def _close(*reports):
    for r in reports:
        r.session.close()


# ------------------------------------------------------ degrade_config ----
def _pinned(pkg_plan, part, cfg, data, spatial):
    return pkg_plan.legacy_convnet_plan(cfg, part(("model", None, None)),
                                        (spatial, 1, 1),
                                        data_degrees=(data,))


@pytest.mark.parametrize("available", range(9))
def test_degrade_config_matches_reference(available):
    for data, spatial, gb, width, plan in (
            (d, s, gb, w, p) for d in (1, 2, 4) for s in (1, 2, 4, 8)
            for gb in (4, 6, 8) for w in (16, 32)
            for p in ("fixed", "auto", "pinned") if gb % d == 0):
        port, ref = _base(global_batch=gb), JRunConfig(
            model="cosmoflow-512", smoke=True, global_batch=gb)
        cfg = dataclasses.replace(port.resolve_model(), input_width=width)
        jcfg = dataclasses.replace(ref.resolve_model(), input_width=width)
        kw = dict(data=data, spatial=spatial)
        port = dataclasses.replace(port, model=cfg, plan=(
            _pinned(plan_lib, SpatialPartitioning, cfg, data, spatial)
            if plan == "pinned" else plan), **kw)
        ref = dataclasses.replace(ref, model=jcfg, plan=(
            _pinned(jplan, JPartitioning, jcfg, data, spatial)
            if plan == "pinned" else plan), **kw)
        if available == 0:
            with pytest.raises(supervisor.SupervisorError):
                supervisor.degrade_config(port, available)
            with pytest.raises(jsupervisor.SupervisorError):
                jsupervisor.degrade_config(ref, available)
            continue
        got = supervisor.degrade_config(port, available)
        want = jsupervisor.degrade_config(ref, available)
        case = (data, spatial, gb, width, plan, available)
        assert (got.data, got.spatial, got.plan) == (
            want.data, want.spatial, want.plan), case
        assert got.global_batch == gb and got.resolve_model() == cfg


# ---------------------------------------------------- _adapt_opt_state ----
def _trees(case: str, r):
    """(old, template) of one case, as numpy trees of AdamState-like
    NamedTuples built by ``make``: ZeRO-1 global buckets (tuples) and a
    replicated step count."""
    sizes = {"extend": ((6, 9), (8, 12)), "truncate": ((8, 12), (4, 10)),
             "same": ((6, 9), (6, 9)), "shape": ((6, 9), (6, 9)),
             "structure": ((6, 9), (6,))}[case]
    old = [r.randn(n).astype(np.float32) for n in sizes[0]]
    new = [np.zeros(n, np.float32) for n in sizes[1]]
    step_old, step_new = np.array(3, np.int32), np.array(0, np.int32)
    if case == "shape":
        new[1] = np.zeros((3, 3), np.float32)
    return ((step_old, tuple(old), tuple(o * 2 for o in old)),
            (step_new, tuple(new), tuple(new)))


@pytest.mark.parametrize("case", ["extend", "truncate", "same", "shape",
                                  "structure"])
def test_adapt_opt_state_matches_reference(case):
    old, new = _trees(case, np.random.RandomState(7))

    def port(tree):
        step, m, v = tree
        return adam.AdamState(torch.from_numpy(step),
                              tuple(map(torch.from_numpy, m)),
                              tuple(map(torch.from_numpy, v)))

    def ref(tree):
        step, m, v = tree
        return jadam.AdamState(jnp.asarray(step),
                               tuple(map(jnp.asarray, m)),
                               tuple(map(jnp.asarray, v)))

    got, reset = supervisor._adapt_opt_state(port(old), port(new))
    want, jreset = jsupervisor._adapt_opt_state(ref(old), ref(new))
    assert reset == jreset == (case in ("shape", "structure"))
    got_leaves = [got.step, *got.m, *got.v]
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adapt_opt_state_dict_trees():
    """The reference's own cases (``tests/test_resilience.py``) on dicts."""
    old = {"m": torch.arange(6, dtype=torch.float32), "t": torch.zeros(2, 2)}
    new = {"m": torch.zeros(8), "t": torch.zeros(2, 2)}
    got, reset = supervisor._adapt_opt_state(old, new)
    assert not reset
    assert got["m"].tolist() == [0, 1, 2, 3, 4, 5, 0, 0]
    shrunk, reset = supervisor._adapt_opt_state(
        old, {"m": torch.zeros(4), "t": torch.zeros(2, 2)})
    assert not reset and shrunk["m"].tolist() == [0, 1, 2, 3]
    _, reset = supervisor._adapt_opt_state(old, {"m": new["m"]})
    assert reset


# ------------------------------------- one device, against the reference ----
@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    root = tmp_path_factory.mktemp("trajectory")
    port_cfg, ref_cfg = _base(), JRunConfig(
        model="cosmoflow-512", smoke=True, global_batch=2, total_steps=20)
    cfg = ref_cfg.resolve_model()
    init = {k: np.asarray(v) for k, v in
            jcosmo.init_params(jax.random.PRNGKey(0), cfg).items()}
    batch_fn = batch_fn_for(2, cfg.input_width, cfg.in_channels, cfg.out_dim)
    with jfaults.active(jfaults.FaultSpec("device.loss", at_steps=(4,),
                                          max_fires=1)):
        ref = jsupervisor.run(dataclasses.replace(
            ref_cfg, checkpoint_dir=str(root / "ref")), 6, save_every=2,
            batch_fn=batch_fn)
    ref_params = {k: np.asarray(v) for k, v in ref.session.params.items()}
    ref.session.close()
    kw = dict(save_every=2, batch_fn=batch_fn, device="cpu")
    with _as_reference(init):
        clean = supervisor.run(dataclasses.replace(
            port_cfg, checkpoint_dir=str(root / "clean")), 6, **kw)
        with faults.active(faults.FaultSpec("device.loss", at_steps=(4,),
                                            max_fires=1)):
            got = supervisor.run(dataclasses.replace(
                port_cfg, checkpoint_dir=str(root / "port")), 6, **kw)
    yield ref, ref_params, clean, got
    _close(clean, got)


def _counters(r):
    return (r.restarts, r.resumes, r.cold_starts, r.rollbacks, r.replans,
            r.final_data, r.final_spatial, r.skipped_steps)


def test_supervised_trajectory_matches_reference(trajectories):
    ref, ref_params, _, got = trajectories
    assert _counters(got) == _counters(ref) == (1, 1, 1, 0, 0, 1, 1, 0)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=RTOL)
    assert len(got.events) == len(ref.events)
    assert got.session.telemetry()["resumes"] == 1.0
    for k, v in got.session.params.items():
        np.testing.assert_allclose(v.numpy(), ref_params[k], rtol=1e-4,
                                   atol=1e-5)


def test_faulted_run_replays_its_clean_run_bitwise(trajectories):
    _, _, clean, got = trajectories
    assert clean.restarts == 0 and clean.cold_starts == 1
    assert got.losses == clean.losses
    assert _params_equal(got.session.params, clean.session.params)
    assert got.recovery_s and got.recovery_s[0] > 0


# ------------------------------------------------ port recovery paths ----
def test_watchdog_catches_comm_stall(tmp_path):
    with faults.active(faults.FaultSpec("comm.stall", at_steps=(3,),
                                        max_fires=1, stall_s=0.8)):
        r = supervisor.run(_base(checkpoint_dir=str(tmp_path)), 5,
                           save_every=2, watchdog_timeout_s=0.5,
                           device="cpu")
    assert r.restarts == 1 and r.resumes == 1
    assert any("StepTimeout" in e for e in r.events)
    assert all(math.isfinite(l) for l in r.losses)
    _close(r)


def test_divergence_rolls_back(tmp_path):
    with faults.active(faults.FaultSpec("grads.nonfinite",
                                        at_steps=(3, 4, 5), max_fires=3)):
        r = supervisor.run(_base(checkpoint_dir=str(tmp_path)), 8,
                           save_every=2, divergence_patience=3,
                           device="cpu")
    assert r.rollbacks == 1 and r.resumes >= 1
    assert any("Divergence" in e for e in r.events)
    assert all(math.isfinite(l) for l in r.losses[4:])
    _close(r)


def test_gives_up_after_max_restarts(tmp_path):
    with faults.active(faults.FaultSpec("device.loss", probability=1.0)):
        with pytest.raises(supervisor.SupervisorError, match="2 restarts"):
            supervisor.run(_base(checkpoint_dir=str(tmp_path)), 4,
                           save_every=2, max_restarts=2, device="cpu")


def test_kernel_errors_are_not_recovered(tmp_path):
    """Only the reference's failure classes are caught: anything else
    (a kernel that fails to launch, a CUDA error) ends the run."""
    with mock.patch("repro_torch.api.session.Session.step",
                    side_effect=RuntimeError("launch failed")):
        with pytest.raises(RuntimeError, match="launch failed"):
            supervisor.run(_base(checkpoint_dir=str(tmp_path)), 4,
                           device="cpu")


def test_requires_a_checkpoint_dir():
    with pytest.raises(supervisor.RunConfigError, match="checkpoint_dir"):
        supervisor.run(_base(), 2, device="cpu")


def test_corrupt_newest_checkpoint_is_walked_past(tmp_path):
    clean = supervisor.run(_base(checkpoint_dir=str(tmp_path / "clean")), 6,
                           save_every=2, device="cpu")
    root = str(tmp_path / "run")
    first = supervisor.run(_base(checkpoint_dir=root), 4, save_every=2,
                           device="cpu")
    _close(first)
    newest = checkpoint.step_dir(root, 4)
    leaf = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    path = os.path.join(newest, leaf)
    with open(path, "r+b") as f:  # one byte flipped in the leaf's data
        f.seek(os.path.getsize(path) - 1)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert not checkpoint.validate(newest)
    r = supervisor.run(_base(checkpoint_dir=root), 6, save_every=2,
                       device="cpu")
    assert r.cold_starts == 0 and r.resumes == 1
    assert r.events[0].startswith("resumed from step 2")
    assert r.losses[2:] == clean.losses[2:]
    assert _params_equal(r.session.params, clean.session.params)
    _close(clean, r)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    cfg = _base().resolve_model()
    cubes, targets = synthetic.make_cosmology_dataset(
        6, cfg.input_width, channels=cfg.in_channels, seed=3)
    store.write_dataset(root, cubes, targets)
    return root


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_fed_replay_is_bitwise(tmp_path, dataset, prefetch):
    cfg = _base(data_dir=dataset, prefetch=prefetch)
    clean = supervisor.run(dataclasses.replace(
        cfg, checkpoint_dir=str(tmp_path / "clean")), 6, save_every=2,
        device="cpu")
    with faults.active(faults.FaultSpec("device.loss", at_steps=(4,),
                                        max_fires=1)):
        got = supervisor.run(dataclasses.replace(
            cfg, checkpoint_dir=str(tmp_path / "got")), 6, save_every=2,
            device="cpu")
    assert got.restarts == 1 and got.resumes == 1
    assert got.losses == clean.losses
    assert all(math.isfinite(l) for l in got.losses)
    assert _params_equal(got.session.params, clean.session.params)
    _close(clean, got)


def _sharded_base(**kw):
    base = _base(global_batch=4, data=2, spatial=2,
                 grad_comm="reduce_scatter", **kw)
    return dataclasses.replace(base, model=dataclasses.replace(
        base.resolve_model(), input_width=16))


def test_zero1_mesh_kill_resume_is_bitwise_and_replans(tmp_path):
    devs = ["cpu"] * 4
    clean = supervisor.run(_sharded_base(
        checkpoint_dir=str(tmp_path / "clean")), 6, save_every=2,
        devices=devs)
    with faults.active(faults.FaultSpec("device.loss", at_steps=(4,),
                                        max_fires=1)):
        got = supervisor.run(_sharded_base(
            checkpoint_dir=str(tmp_path / "got")), 6, save_every=2,
            devices=devs)
    assert got.restarts == 1 and got.resumes == 1, got.events
    assert got.losses == clean.losses
    assert _params_equal(got.session.params, clean.session.params)
    with faults.active(faults.FaultSpec("device.loss", at_steps=(3,),
                                        max_fires=1, available=2)):
        el = supervisor.run(_sharded_base(
            checkpoint_dir=str(tmp_path / "elastic")), 6, save_every=2,
            devices=devs)
    assert el.replans == 1 and (el.final_data, el.final_spatial) == (1, 2)
    assert el.session.mesh.shape == {"data": 1, "model": 2}
    assert el.session.grad_comm == "reduce_scatter"
    assert not any("reset" in e for e in el.events), el.events
    assert all(math.isfinite(l) for l in el.losses)
    # the state moved across: the restored step count is the checkpoint's
    assert int(el.session.opt_state[0].step) == 6
    _close(clean, got, el)


def test_elastic_restore_resets_an_incompatible_state(tmp_path):
    """A re-degreed run whose optimizer layout differs from the
    checkpoint's (ZeRO-1 buckets into a replicated state) starts its
    optimizer afresh and says so; the parameters still move across."""
    saved = supervisor.run(_sharded_base(
        checkpoint_dir=str(tmp_path)), 2, save_every=2, devices=["cpu"] * 4)
    _close(saved)
    path = checkpoint.step_dir(str(tmp_path), 2)
    new = dataclasses.replace(_sharded_base(), data=1, spatial=2,
                              grad_comm="overlap")
    report = supervisor.SupervisorReport(steps=4, losses=[])
    sess = supervisor._elastic_restore(path, new, report, ["cpu"] * 2)
    assert any("reset" in e for e in report.events)
    assert sess.step_count == 2 and int(sess.opt_state.step) == 0
    tree = checkpoint.restore(path, {"params": sess.params})
    assert all(torch.equal(sess.params[k], tree["params"][k])
               for k in sess.params)
    sess.close()


# --------------------------------------- elastic, against the reference ----
def test_elastic_zero1_matches_reference(reference_elastic, tmp_path):
    want, init = reference_elastic.result()
    base = _sharded_base(checkpoint_dir=str(tmp_path))
    cfg = base.resolve_model()
    with _as_reference(init), faults.active(faults.FaultSpec(
            "device.loss", at_steps=(3,), max_fires=1, available=2)):
        got = supervisor.run(base, 6, save_every=2, devices=["cpu"] * 4,
                             batch_fn=batch_fn_for(4, 16, cfg.in_channels,
                                                   cfg.out_dim))
    assert [got.final_data, got.final_spatial] == want["final"] == [1, 2]
    assert [got.restarts, got.resumes, got.cold_starts, got.rollbacks,
            got.replans] == want["counters"]
    np.testing.assert_allclose(got.losses, want["losses"], rtol=RTOL)
    _close(got)


def _pipelined_base(**kw):
    base = _base(global_batch=4, data=4, pipeline=2, micro_batches=2,
                 grad_clip=0.0, **kw)
    return dataclasses.replace(base, model=dataclasses.replace(
        base.resolve_model(), input_width=16))


def test_elastic_pipelined_run_replans_like_the_reference(reference_elastic,
                                                           tmp_path):
    """A pipelined checkpoint holds one optimizer state a group: the
    elastic restore reads it through the pipelined layout and places
    each group's state on its group's device. The run re-plans and
    resumes as the reference's does, and stays within 1e-6 of its own
    clean run, as the reference's does of its own.

    Against the reference's losses: step 0's within 1e-5. From step 1 on
    the two packages' CLEAN pipelined runs already differ (2.6e-4 at
    most): Adam's first update moves a few weights whose gradients
    nearly cancel (6 of ~70,000 here) by a whole step in the direction
    their summation order decides (ROADMAP §3, the reference's own
    pipeline parity test). So each step's elastic distance from the
    reference may exceed the clean runs' by no more than 1e-5 of the
    loss: the replan adds nothing of its own."""
    result, init = reference_elastic.result()
    want = result["pipelined"]
    cfg = _pipelined_base().resolve_model()
    batches = batch_fn_for(4, 16, cfg.in_channels, cfg.out_dim)
    with _as_reference(init):
        clean = supervisor.run(
            _pipelined_base(checkpoint_dir=str(tmp_path / "clean")), 6,
            save_every=2, devices=["cpu"] * 4, batch_fn=batches)
        with faults.active(faults.FaultSpec(
                "device.loss", at_steps=(3,), max_fires=1, available=2)):
            got = supervisor.run(
                _pipelined_base(checkpoint_dir=str(tmp_path / "elastic")), 6,
                save_every=2, devices=["cpu"] * 4, batch_fn=batches)
    assert [got.final_data, got.final_spatial] == want["final"] == [2, 1]
    for event in ("replanned for 2 devices: data=2 spatial=1",
                  "resumed from step 2 (data=2 spatial=1)"):
        assert event in got.events and event in want["events"], got.events
    assert not any("reset" in e for e in got.events), got.events
    assert [got.restarts, got.resumes, got.cold_starts, got.rollbacks,
            got.replans] == want["counters"]
    np.testing.assert_allclose(got.losses, clean.losses, rtol=1e-6)
    np.testing.assert_allclose(want["losses"], result["pipelined_clean"],
                               rtol=1e-6)
    np.testing.assert_allclose(got.losses[0], want["losses"][0], rtol=RTOL)
    drift = np.abs(np.subtract(clean.losses, result["pipelined_clean"]))
    assert np.all(np.abs(np.subtract(got.losses, want["losses"]))
                  <= drift + RTOL * np.abs(want["losses"])), (
        got.losses, want["losses"], drift)
    sess = got.session
    assert sess.plan.n_groups == 2 and len(sess.opt_state) == 2
    for state, mesh in zip(sess.opt_state, sess.meshes):
        assert all(leaf.device == mesh.devices[0]
                   for leaf in torch.utils._pytree.tree_leaves(state))
    _close(got, clean)
