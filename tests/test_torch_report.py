"""The drift report (``repro_torch.obs.report``, ``Session.profile`` and
``Session.report``) against the reference's, on the CPU, and the
metrics row of a training step.

* ``modeled_phases`` on ``V100`` equals the reference's to 1e-12
  relative: cosmoflow-128 and unet3d-256 under the fixed plan, the b1
  batch plan and the fixed plan with every stage rematerialized, at
  1 x 2 and 2 x 2, fp32 and bf16; a pipelined plan raises naming the
  pipeline slice;
* ``drift`` / ``DriftReport`` give the reference's rows, flags, ``str``
  and ``to_json`` on the same dicts;
* ``measured_phases`` reads the same numbers as the reference's from
  tracers given the same span durations;
* ``Session.report(reps=1)`` has the rows fwd, bwd, comm, io, opt and
  step from the session's spans, on one device and over a 1 x 2 mesh;
  an untraced session's tracer is disabled again afterwards, a traced
  one's stays active; probes already recorded are not run again;
* the metrics row of a step (``RunConfig.metrics_jsonl``) has the
  reference's keys without a loader and with a synchronous or a
  prefetching one (``io_stall_s`` only with a loader).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import perf_model as jperf
from repro.core import plan as jplan
from repro.core.spatial_conv import SpatialPartitioning as JPartitioning
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.api import RunConfig, compile
from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.obs import report
from repro_torch.obs import trace as trace_lib

ROWS = ("fwd", "bwd", "comm", "io", "opt", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs (its 1 x 2 session's
    shards are threads already; restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ modeled side ----
def _plans(pkg, part, cfg, kind, data, spatial):
    if kind == "b1_batch":
        return pkg.convnet_plan(cfg, boundary=1, kind="batch",
                                spatial_degrees=(spatial, 1, 1),
                                data_degrees=(data,))
    plan = pkg.legacy_convnet_plan(cfg, part(("model", None, None)),
                                   (spatial, 1, 1), data_degrees=(data,))
    if kind == "remat":
        plan = dataclasses.replace(plan, stages=tuple(
            dataclasses.replace(s, remat=True) for s in plan.stages))
    return plan


@pytest.mark.parametrize("arch", ["cosmoflow-128", "unet3d-256"])
@pytest.mark.parametrize("kind", ["fixed", "b1_batch", "remat"])
@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
def test_modeled_phases_match_reference(arch, kind, data, spatial):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    plan = _plans(plan_lib, SpatialPartitioning, cfg, kind, data, spatial)
    jp = _plans(jplan, JPartitioning, jcfg, kind, data, spatial)
    assert plan.name == jp.name
    for precision in ("fp32", "bf16"):
        for grad_comm in ("overlap", "reduce_scatter"):
            kw = dict(global_batch=4, grad_comm=grad_comm,
                      precision=precision)
            got = report.modeled_phases(cfg, perf_model.V100, plan, **kw)
            want = jreport.modeled_phases(jcfg, jperf.V100, jp, **kw)
            assert set(got) == set(want) == set(ROWS)
            for k in got:
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_modeled_phases_of_a_pipelined_plan_raise():
    cfg = configs.get_config("cosmoflow-128")
    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (1, 1, 1))
    piped = dataclasses.replace(plan, pipeline=plan_lib.PipelineSpec(
        (0,) * (len(plan.stages) - 1) + (1,), 4, "1f1b"))
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        report.modeled_phases(cfg, perf_model.H100, piped, global_batch=4,
                              grad_comm="overlap")


# ------------------------------------------------------------ drift ----
_DRIFT_CASES = [
    ({"fwd": 1e-3, "bwd": 2e-3, "comm": 0.0, "io": 4e-5, "opt": 8e-5,
      "step": 0.276},
     {"fwd": 2.1e-3, "bwd": 1.9e-3, "comm": 1e-4, "io": 0.05, "opt": 1.2e-3,
      "step": 0.038}),
    ({"fwd": 1.0, "step": 2.0, "extra": 3.0},
     {"fwd": 0.6, "bwd": 0.5, "step": 4.0, "zeta": 1.0}),
    ({}, {"io": 1.0}),
]


@pytest.mark.parametrize("case", range(len(_DRIFT_CASES)))
@pytest.mark.parametrize("flag_ratio", [2.0, 1.5])
def test_drift_matches_reference(case, flag_ratio):
    modeled, measured = _DRIFT_CASES[case]
    got = report.drift(modeled, measured, flag_ratio=flag_ratio)
    want = jreport.drift(modeled, measured, flag_ratio=flag_ratio)
    assert got.to_json() == want.to_json()
    assert str(got) == str(want)
    assert got.phases() == want.phases()
    assert [r.phase for r in got.flagged()] == [r.phase
                                               for r in want.flagged()]
    for r in got.rows:
        assert str(r) == str(want.row(r.phase))
    with pytest.raises(KeyError):
        got.row("nope")


@pytest.mark.parametrize("spans", [
    {"probe.fwd": [0.002, 0.004], "probe.bwd": [0.006], "probe.grad_comm":
     [0.0061], "probe.step": [0.0075, 0.0071], "io.load": [0.03, 0.05]},
    {"probe.fwd": [0.002], "probe.bwd": [0.0015], "io.load.sync": [0.01]},
    {"probe.step": [0.5]},
])
def test_measured_phases_read_the_tracers_spans(spans):
    port, ref = trace_lib.Tracer(), jtrace.Tracer()
    for name, durations in spans.items():
        for d in durations:
            port._record(name, port.epoch_ns, int(d * 1e9), None)
            ref._record(name, ref.epoch_ns, int(d * 1e9), None)
    got = report.measured_phases(port)
    assert got == jreport.measured_phases(ref)
    assert got  # every case measures something


# ------------------------------------------------- Session.report ----
def _session(**kw):
    spatial = kw.pop("spatial", 1)
    config = RunConfig(model="cosmoflow-512", smoke=True, global_batch=2,
                       spatial=spatial, **kw)
    place = ({"device": "cpu"} if spatial == 1
             else {"devices": ["cpu"] * spatial})
    return compile(config, **place)


@pytest.mark.parametrize("spatial", [1, 2])
def test_session_report_reads_its_spans(spatial):
    assert trace_lib.active() is None
    with _session(spatial=spatial) as sess:
        rep = sess.report(reps=1)
        assert rep.source == "spans" and rep.phases() == ROWS
        for phase in ROWS:
            assert rep.row(phase).measured_s is not None, phase
            assert rep.row(phase).modeled_s is not None, phase
        agg = sess.tracer.span_seconds()
        assert rep.row("fwd").measured_s == agg["probe.fwd"][1]
        assert rep.row("io").measured_s > 0
        # the modeled column: the time model on the H100, a card a shard
        assert rep.row("step").modeled_s == pytest.approx(
            report.modeled_phases(sess.cfg, perf_model.H100, sess.plan,
                                  global_batch=2, grad_comm=sess.grad_comm,
                                  precision=sess.precision)["step"])
        # the untraced session only borrowed its tracer
        assert trace_lib.active() is None
        # probes and io already recorded: a second report adds no spans
        n = len(sess.tracer)
        sess.report()
        assert len(sess.tracer) == n
        assert sess.step_count == 0  # profile leaves the session's state


def test_traced_session_keeps_its_tracer_active():
    with _session(trace=True) as sess:
        sess.report(reps=1)
        assert trace_lib.active() is sess.tracer
    assert trace_lib.active() is None


def test_profile_phases_nest():
    with _session() as sess:
        params = {k: v.clone() for k, v in sess.params.items()}
        out = sess.profile(reps=1)
        for key in ("fwd", "bwd", "grad_comm", "step", "backward", "comm",
                    "optimizer", "telemetry.steps"):
            assert key in out, key
        assert out["backward"] == max(out["bwd"] - out["fwd"], 0.0)
        assert all(torch.equal(params[k], sess.params[k]) for k in params)


# ----------------------------------------------- the metrics row (§0) ----
@pytest.fixture(scope="module")
def metrics_rows(tmp_path_factory):
    """Each package's rows of three steps: the first without a loader,
    the second after a synchronous loader is made, the third after a
    prefetching one."""
    root = tmp_path_factory.mktemp("metrics")
    r = np.random.RandomState(0)
    batch = (r.randn(2, 32, 32, 32, 2).astype(np.float32),
             r.randn(2, 4).astype(np.float32))
    rows = {}
    for name in ("ref", "port"):
        path = root / f"{name}.jsonl"
        kw = dict(model="cosmoflow-512", smoke=True, global_batch=2,
                  metrics_jsonl=str(path))
        sess = (japi.compile(japi.RunConfig(**kw)) if name == "ref"
                else compile(RunConfig(**kw), device="cpu"))
        sess.step(batch)
        for prefetch in (0, 2):
            ld = sess.make_loader(num_samples=4, prefetch=prefetch)
            sess.step(ld.load_batch(ld.schedule_for_epoch(0)[:2]))
        sess.close()
        rows[name] = [json.loads(l) for l in path.read_text().splitlines()]
    return rows


@pytest.mark.parametrize("step,loader", [(0, None), (1, 0), (2, 2)])
def test_metrics_row_keys_match_reference(metrics_rows, step, loader):
    """With a loader, each row carries ``io_stall_s`` (the loaders'
    summed stall, 0 for the synchronous one), as the reference's does;
    without one it does not."""
    got, want = metrics_rows["port"][step], metrics_rows["ref"][step]
    assert list(got) == list(want)
    assert ("io_stall_s" in got) == (loader is not None)
    assert got["step"] == want["step"] == step
    assert got["guarded_steps"] == want["guarded_steps"]
