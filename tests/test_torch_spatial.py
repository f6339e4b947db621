"""The port's spatially partitioned serving against the reference's, on
the CPU.

* ``InferenceSession.predict`` with depth split over S shards
  (``devices=["cpu"] * S``) against the reference's ``InferenceSession``
  on S forced host devices, on the SMOKE config and a 5-block config at
  S = 2 and 4, plus a pinned plan that keeps depth partitioned through
  every block (the path that reaches the unpack kernel) — 1e-4 of the
  output scale, as the unsharded parity tests (summation order through
  the blocks, and the psum order of the batch-norm statistics). The
  reference runs once, in a subprocess with 4 forced host devices; its
  pinned-plan run takes the Pallas path (interpret mode), the others
  XLA's, to keep the subprocess short. Inputs come from numpy with a
  seed; the reference's parameters are carried across with
  ``params_from_numpy``.
* the kernel launches ``kernel_launches`` derives from a plan, against
  the wrapper calls a forward makes.
* failure and configuration: a fault in one shard surfaces from
  ``predict`` (and from the harness as a failed future) with no thread
  left waiting; a data degree below 1 and a ``devices`` list of the
  wrong length raise ``RunConfigError`` naming the field; without CUDA a spatial run
  with no ``devices`` raises.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.api import RunConfig as JRunConfig
from repro.api import compile as jcompile
from repro.configs.base import ConvNetConfig as JConvNetConfig
from repro_torch.api import RunConfig, RunConfigError, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib
from repro_torch.core import spatial_conv
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.models import cosmoflow
from repro_torch.serve import InferenceSession

FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d",
                     arch="cosmoflow", input_width=16, in_channels=2,
                     out_dim=4, conv_channels=(4, 8, 8, 16, 16),
                     fc_dims=(32, 16))
CFGS = {"smoke": cosmo_cfg.SMOKE, "five": FIVE}
RUNS = [("smoke", 2, False), ("smoke", 4, False), ("five", 2, False),
        ("five", 4, False), ("five", 2, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small and
    its shards are threads already, and beside other test workers a
    thread pool a shard only contends (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def deep_plan(plan_mod, n_blocks, S):
    """Depth partitioned through every conv block, then the FC head
    replicated."""
    return plan_mod.ParallelPlan(
        (plan_mod.Stage(0, n_blocks, ("model", None, None), ("data",)),
         plan_mod.Stage(n_blocks, n_blocks + 1, (None, None, None),
                        ("data",))),
        (("data", 1), ("model", S)), n_blocks + 1, name="deep")


REFERENCE = r'''
import numpy as np
from repro.api import RunConfig, compile
from repro.configs import cosmoflow as cosmo_cfg
from repro.configs.base import ConvNetConfig
from repro.core import plan as plan_lib

FIVE = ConvNetConfig(name="cosmoflow-five", family="conv3d", arch="cosmoflow",
                     input_width=16, in_channels=2, out_dim=4,
                     conv_channels=(4, 8, 8, 16, 16), fc_dims=(32, 16))
out = {}
for name, cfg in (("smoke", cosmo_cfg.SMOKE), ("five", FIVE)):
    w = cfg.input_width
    x = np.random.RandomState(0).randn(
        2, w, w, w, cfg.in_channels).astype(np.float32)
    out["x_" + name] = x
    for S, deep in RUNS[name]:
        plan = deep_plan(plan_lib, len(cfg.conv_channels), S) if deep \
            else "fixed"
        sess = compile(RunConfig(model=cfg, mode="infer", spatial=S,
                                 global_batch=2, plan=plan, use_pallas=deep))
        out[f"pred_{name}_{S}_{int(deep)}"] = np.asarray(sess.predict(x))
    for k, v in sess.params.items():
        out[f"param_{name}_{k}"] = np.asarray(v)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    import inspect

    path = tmp_path_factory.mktemp("spatial") / "reference.npz"
    runs = {n: [(s, d) for m, s, d in RUNS if m == n] for n in CFGS}
    script = (f"OUT = {str(path)!r}\nRUNS = {runs!r}\n"
              + inspect.getsource(deep_plan) + REFERENCE)
    multidevice(script, devices=4)
    return dict(np.load(path))


def _params(reference, name):
    pre = f"param_{name}_"
    return {k[len(pre):]: v for k, v in reference.items()
            if k.startswith(pre)}


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _session(cfg, S, plan="fixed", params=None, **kw):
    sess = compile(RunConfig(model=cfg, mode="infer", spatial=S,
                             global_batch=2, plan=plan, **kw),
                   devices=["cpu"] * S)
    if params is not None:
        sess.params = cosmoflow.params_from_numpy(params, "cpu", cfg=cfg)
    return sess


# ------------------------------------------------------------- parity ----
@pytest.mark.parametrize("name,S,deep", RUNS)
def test_spatial_predict_matches_reference(reference, name, S, deep):
    cfg = CFGS[name]
    plan = deep_plan(plan_lib, len(cfg.conv_channels), S) if deep \
        else "fixed"
    with _session(cfg, S, plan, _params(reference, name)) as sess:
        assert sess.describe().mesh_shape == {"data": 1, "model": S}
        got = sess.predict(reference["x_" + name])
    assert _scaled_err(got.numpy(),
                       reference[f"pred_{name}_{S}_{int(deep)}"]) <= 1e-4


@pytest.mark.parametrize("name,S,deep", RUNS)
def test_kernel_launches_follow_the_plan(monkeypatch, name, S, deep):
    """Each wrapper call of one sharded forward, counted on the CPU,
    equals what ``kernel_launches`` derives from the plan — the counts
    the card's launch counters are held to."""
    cfg = CFGS[name]
    plan = deep_plan(plan_lib, len(cfg.conv_channels), S) if deep \
        else "fixed"
    calls = {"conv3d": 0, "bn_act": 0, "pack": 0, "unpack": 0}
    lock = threading.Lock()

    def counted(key, fn):
        def wrapper(*a, **k):
            with lock:
                calls[key] += 1
            return fn(*a, **k)
        return wrapper

    for mod, attr, key in ((conv_ops, "conv3d_valid", "conv3d"),
                           (bn_ops, "bn_leaky_relu", "bn_act"),
                           (pack_ops, "pack", "pack"),
                           (pack_ops, "unpack", "unpack")):
        monkeypatch.setattr(mod, attr, counted(key, getattr(mod, attr)))
    with _session(cfg, S, plan) as sess:
        w = cfg.input_width
        sess.predict(np.zeros((2, w, w, w, cfg.in_channels), np.float32))
        want = cosmoflow.kernel_launches(cfg, sess.plan)
    assert calls == want
    assert want["pack"] > 0 and (want["unpack"] > 0) == deep


def test_overlap_and_blocking_sessions_agree():
    x = np.random.RandomState(3).randn(2, 16, 16, 16, 2).astype(np.float32)
    preds = []
    for overlap in (True, False):
        with _session(FIVE, 4, overlap_halo=overlap) as sess:
            preds.append(sess.predict(x).numpy())
    np.testing.assert_allclose(preds[0], preds[1], rtol=0, atol=1e-5)


def test_restore_a_reference_checkpoint_spatially(tmp_path):
    """A checkpoint the reference trained on one device serves depth-split
    over 2 shards as it serves unsplit."""
    cfg = ConvNetConfig(name="tiny8", family="conv3d", arch="cosmoflow",
                        input_width=8, in_channels=1, out_dim=4,
                        conv_channels=(2, 4), fc_dims=(16, 8))
    jcfg = JConvNetConfig(**dataclasses.asdict(cfg))
    ckpt = str(tmp_path / "ck")
    r = np.random.RandomState(4)
    x = r.randn(2, 8, 8, 8, 1).astype(np.float32)
    y = r.randn(2, 4).astype(np.float32)
    with jcompile(JRunConfig(model=jcfg, global_batch=2,
                             checkpoint_dir=ckpt)) as tr:
        tr.step(x, y)
        tr.save()
    with InferenceSession.restore(ckpt, device="cpu") as one, \
            InferenceSession.restore(ckpt, spatial=2,
                                     devices=["cpu"] * 2) as two:
        assert two.describe().mesh_shape == {"data": 1, "model": 2}
        assert two.describe().devices == ("cpu", "cpu")
        want = one.predict(x).numpy()
        loss, got = two.evaluate(x, y)
    assert _scaled_err(got.numpy(), want) <= 1e-5
    assert np.isfinite(float(loss))


# ------------------------------------------------- failure, config ----
def test_a_fault_in_one_shard_surfaces_from_predict(monkeypatch):
    real = pack_ops.pack

    def failing(x, lo, hi):
        from repro_torch.core import spmd

        if spmd.axis("model").index == 1:
            raise RuntimeError("injected fault in shard 1")
        return real(x, lo, hi)

    monkeypatch.setattr(pack_ops, "pack", failing)
    vol = np.zeros((2, 16, 16, 16, 2), np.float32)
    with _session(FIVE, 4) as sess:
        done = []

        def call():
            with pytest.raises(RuntimeError, match="shard 1"):
                sess.predict(vol)
            done.append(True)

        t = threading.Thread(target=call)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and done
        with sess.serve(max_batch=2, max_wait_ms=0.0) as h:
            fut = h.submit(vol[0])
            with pytest.raises(RuntimeError, match="shard 1"):
                fut.result(timeout=120)
        monkeypatch.setattr(pack_ops, "pack", real)
        assert sess.predict(vol).shape == (2, 4)  # the mesh still serves
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]


@pytest.mark.parametrize("kw,devices,field", [
    (dict(data=0), ["cpu"] * 2, "data"),
    (dict(spatial=2), ["cpu"] * 3, "spatial"),
    (dict(spatial=4), ["cpu"] * 2, "spatial"),
    (dict(spatial=1), ["cpu"] * 2, "spatial"),
])
def test_degree_and_device_mismatches_name_the_field(kw, devices, field):
    with pytest.raises(RunConfigError) as e:
        compile(RunConfig(model=FIVE, mode="infer", **kw), devices=devices)
    assert e.value.field == field and e.value.fix


def test_device_arguments_are_explicit():
    cfg = RunConfig(model=FIVE, mode="infer", spatial=2)
    with pytest.raises(ValueError, match="not both"):
        compile(cfg, device="cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match=r"devices=\['cpu'\] \* 2"):
        compile(cfg, device="cpu")
    if torch.cuda.device_count() >= 2:
        pytest.skip("enough CUDA devices: the default mesh is cuda:0..1")
    with pytest.raises(RuntimeError, match="devices="):
        compile(cfg)


def test_a_pinned_partitioned_plan_validates():
    for S in (2, 4):
        plan = deep_plan(plan_lib, 5, S)
        RunConfig(model=FIVE, mode="infer", spatial=S, plan=plan).validate(
            device_count=S)
        with pytest.raises(RunConfigError) as e:
            RunConfig(model=FIVE, mode="infer", spatial=1,
                      plan=plan).validate()
        assert e.value.field == "plan"


def test_spatial_allgather_reassembles_the_volume():
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import Mesh

    x = torch.arange(2 * 8 * 2 * 2 * 3, dtype=torch.float32).reshape(
        2, 8, 2, 2, 3)
    part = spatial_conv.SpatialPartitioning(("model", None, None))
    outs = spmd.run(Mesh([("model", 4)], ["cpu"] * 4),
                    lambda t: spatial_conv.spatial_allgather(t, part),
                    list(x.split(2, dim=1)))
    assert all(torch.equal(o, x) for o in outs)
