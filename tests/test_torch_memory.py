"""The port's memory model (``core/memory.py``) against the reference's
(``src/repro/core/memory.py``), on the CPU; no model is run.

``plan_peak_bytes``, ``infer_peak_bytes`` and
``data_parallel_peak_bytes`` must give the reference's integers, field
by field, over {cosmoflow-128, cosmoflow-512, unet3d-256, both SMOKEs} x
{fp32, bf16, fp16} x {remat on, off} x {1 x 1, 2 x 1, 1 x 2, 1 x 4,
2 x 2} x each ``grad_comm``, each package on its own fixed-degree plan;
``perf_model.opt_state_bytes`` and ``memory_per_sample_bytes`` the
reference's numbers. Both sessions' ``describe().modeled_peak`` equal
the reference sessions'. A pipelined plan over spatial stages raises, and
``measured_peak_bytes`` raises on a CPU device.
"""
import dataclasses

import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.api import session as jsession
from repro.core import memory as jmemory
from repro.core import perf_model as jperf
from repro.core import plan as jplan
from repro.core.spatial_conv import SpatialPartitioning as JPart
from repro.serve import session as jserve
from repro_torch import configs
from repro_torch.api import RunConfig, compile
from repro_torch.core import memory, perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning

MODELS = ["cosmoflow-128", "cosmoflow-512", "unet3d-256", "cosmoflow-smoke",
          "unet3d-smoke"]
PRECISIONS = ["fp32", "bf16", "fp16"]
MESHES = [(1, 1), (2, 1), (1, 2), (1, 4), (2, 2)]
GRAD_COMMS = ["monolithic", "overlap", "reduce_scatter"]
BATCH = 4


def _configs(name):
    """(port config, reference config) of a model or its SMOKE."""
    if name.endswith("-smoke"):
        full = "cosmoflow-128" if name.startswith("cosmoflow") else \
            "unet3d-256"
        return configs.get_smoke_config(full), jconfigs.get_smoke_config(full)
    return configs.get_config(name), jconfigs.get_config(name)


def _plans(cfg, jcfg, D, S, remat):
    """Each package's fixed-degree plan at D x S, every stage
    rematerialized or none."""
    plans = (plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (S, 1, 1),
        data_degrees=(D,)),
        jplan.legacy_convnet_plan(jcfg, JPart(("model", None, None)),
                                  (S, 1, 1), data_degrees=(D,)))
    if remat:
        plans = tuple(dataclasses.replace(p, stages=tuple(
            dataclasses.replace(s, remat=True) for s in p.stages))
            for p in plans)
    return plans


def _fields(b):
    return dataclasses.astuple(b)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", MODELS)
def test_peaks_equal_the_reference_integers(name, precision):
    cfg, jcfg = _configs(name)
    for remat in (False, True):
        for D, S in MESHES:
            plan, jp = _plans(cfg, jcfg, D, S, remat)
            for gc in GRAD_COMMS:
                got = memory.plan_peak_bytes(cfg, plan, global_batch=BATCH,
                                             grad_comm=gc,
                                             precision=precision)
                want = jmemory.plan_peak_bytes(jcfg, jp, global_batch=BATCH,
                                               grad_comm=gc,
                                               precision=precision)
                assert _fields(got) == _fields(want), (remat, D, S, gc)
                assert got.total == want.total
            got = memory.infer_peak_bytes(cfg, plan, global_batch=BATCH,
                                          precision=precision)
            want = jmemory.infer_peak_bytes(jcfg, jp, global_batch=BATCH,
                                            precision=precision)
            assert _fields(got) == _fields(want), (remat, D, S)
    for gpus in (1, 2, 4):
        for gc in GRAD_COMMS:
            got = memory.data_parallel_peak_bytes(
                cfg, global_batch=BATCH, num_gpus=gpus, grad_comm=gc,
                precision=precision)
            want = jmemory.data_parallel_peak_bytes(
                jcfg, global_batch=BATCH, num_gpus=gpus, grad_comm=gc,
                precision=precision)
            assert _fields(got) == _fields(want), (gpus, gc)


@pytest.mark.parametrize("name", MODELS)
def test_perf_model_terms_equal_the_reference(name):
    cfg, jcfg = _configs(name)
    n = cfg.param_count()
    assert n == jcfg.param_count()
    for gc in GRAD_COMMS:
        for d in (1, 2, 3, 4):
            assert perf_model.opt_state_bytes(
                n, grad_comm=gc, data_degree=d) == jperf.opt_state_bytes(
                    n, grad_comm=gc, data_degree=d)
    for bn in (None, True, False):
        assert perf_model.memory_per_sample_bytes(cfg, bn) == \
            jperf.memory_per_sample_bytes(jcfg, bn)


def test_the_unet_skip_term_follows_the_reference():
    """The reference counts the encoder skips under ``arch == "unet"``,
    which the U-Net's configs (``"unet3d"``) never meet: the port keeps
    the test, and an ``"unet"`` config moves both alike."""
    cfg, jcfg = _configs("unet3d-256")
    cfg = dataclasses.replace(cfg, arch="unet")
    jcfg = dataclasses.replace(jcfg, arch="unet")
    plan, jp = _plans(cfg, jcfg, 1, 2, False)
    got = memory.infer_peak_bytes(cfg, plan, global_batch=1)
    want = jmemory.infer_peak_bytes(jcfg, jp, global_batch=1)
    assert _fields(got) == _fields(want) and got.activations > 0


def _reference_peak(kw):
    """The reference session's ``describe().modeled_peak``, its state
    built as the shape templates its ``restore`` builds (the model reads
    only the config, the plan and the parameter count, and random
    initialization alone takes seconds to compile on the CPU)."""
    config = japi.RunConfig(**kw)
    ref = (jserve._compile_infer(config, abstract_params=True)
           if config.mode == "infer"
           else jsession._compile(config, abstract_state=True))
    try:
        return ref.describe().modeled_peak
    finally:
        ref.close()


def test_train_session_describe_matches_the_reference():
    kw = dict(model="cosmoflow-128", smoke=True, global_batch=4,
              precision="bf16", grad_comm="reduce_scatter")
    with compile(RunConfig(**kw), device="cpu") as sess:
        got = sess.describe()
        assert "modeled peak/shard total=" in str(got)
    assert _fields(got.modeled_peak) == _fields(_reference_peak(kw))
    assert got.modeled_peak.opt_state == 2 * 4 * sess.cfg.param_count()
    # at 2 x 2 the session models its shard: ZeRO-1's state halves
    with compile(RunConfig(**dict(kw, data=2, spatial=2)),
                 devices=["cpu"] * 4) as sess:
        assert sess.describe().modeled_peak.opt_state == \
            2 * 4 * sess.cfg.param_count() // 2


def test_infer_session_describe_matches_the_reference():
    kw = dict(model="cosmoflow-128", smoke=True, mode="infer",
              global_batch=2, precision="bf16")
    with compile(RunConfig(**kw), device="cpu") as sess:
        got = sess.describe().modeled_peak
    assert _fields(got) == _fields(_reference_peak(kw))


def test_a_pipelined_plan_raises():
    """A pipeline over a plan whose stages shard space raises, as the
    reference's plans do (each group shards only the batch); a pipelined
    plan is modeled per group (``_pipeline_peak_bytes``, the reference's
    integers: ``tests/test_torch_pipeline.py``), its peak falling as the
    micro-batches rise."""
    cfg = configs.get_smoke_config("cosmoflow-128")
    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (1, 1, 1))
    with pytest.raises(ValueError, match="pipeline"):
        dataclasses.replace(plan, pipeline=plan_lib.PipelineSpec(
            tuple(range(len(plan.stages)))))
    peaks = [memory.plan_peak_bytes(cfg, plan_lib.pipelined_convnet_plan(
        cfg, boundaries=(2,), micro_batches=m), global_batch=8).total
        for m in (1, 2, 8)]
    assert peaks[0] > peaks[1] > peaks[2] > 0


def test_measured_peak_bytes_raises_on_a_cpu_device():
    with pytest.raises(ValueError, match="cpu"):
        memory.measured_peak_bytes(lambda: torch.ones(3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            memory.measured_peak_bytes(lambda: torch.ones(3))
