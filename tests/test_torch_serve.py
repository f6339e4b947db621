"""The port's serving path against the reference's.

* checkpoint -> inference parity: the reference trains one step on the
  ``tiny8`` config of ``tests/test_serve.py`` and saves; the port's
  ``InferenceSession.restore(ckpt, device="cpu")`` then matches the
  reference ``InferenceSession.restore(ckpt)`` on ``predict`` and
  ``evaluate`` — fp32 to 1e-4 of the output scale, bf16 to 5e-2 (masters
  cast once at load in both; the reference's unfused bf16 batch-norm
  rounds after every op, the port's kernel once).
* queue semantics of the harness: coalescing, a worker fault surfacing
  as a failed future, ``close()`` draining or failing what is queued.
* config surface: ``mode="infer"``'s FIELD-named rejections, the slices
  still to come, and the device rule (entry points run on the card
  unless told ``device="cpu"``).
"""
import json

import numpy as np
import pytest
import torch

from repro.api import RunConfig as JRunConfig
from repro.api import compile as jcompile
from repro.configs.base import ConvNetConfig as JConvNetConfig
from repro.serve import InferenceSession as JInferenceSession
from repro_torch.api import RunConfig, RunConfigError, compile
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import faults, memory
from repro_torch.obs import export as export_lib
from repro_torch.serve import InferenceSession, compile_infer

TINY = ConvNetConfig(name="tiny8", family="conv3d", arch="cosmoflow",
                     input_width=8, in_channels=1, out_dim=4,
                     conv_channels=(2, 4), fc_dims=(16, 8))
JTINY = JConvNetConfig(name="tiny8", family="conv3d", arch="cosmoflow",
                       input_width=8, in_channels=1, out_dim=4,
                       conv_channels=(2, 4), fc_dims=(16, 8))
VOL = np.zeros((8, 8, 8, 1), np.float32)


def _batch(n=4, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8, 8, 8, 1).astype(np.float32)
    y = r.randn(n, 4).astype(np.float32)
    return x, y


def _session(**kw):
    return compile(RunConfig(model=TINY, mode="infer", **kw), device="cpu")


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


# ------------------------------------------- checkpoint -> inference ----
@pytest.mark.parametrize("precision,rel", [("fp32", 1e-4), ("bf16", 5e-2)])
def test_reference_checkpoint_serves_the_same(tmp_path, precision, rel):
    ckpt = str(tmp_path / "ck")
    x, y = _batch()
    with jcompile(JRunConfig(model=JTINY, global_batch=4, precision=precision,
                             checkpoint_dir=ckpt)) as tr:
        tr.step(x, y)
        tr.save()
    with JInferenceSession.restore(ckpt) as ref:
        want_pred = np.asarray(ref.predict(x), np.float32)
        want_loss, _ = ref.evaluate(x, y)
    with InferenceSession.restore(ckpt, device="cpu") as sess:
        assert sess.config.mode == "infer"
        assert sess.precision == precision
        assert sess.plan.name == "cosmoflow.legacy"  # the pinned plan
        dt = torch.float32 if precision == "fp32" else torch.bfloat16
        assert all(v.dtype == dt for v in sess.params.values())
        pred = sess.predict(x)
        loss, pred2 = sess.evaluate(x, y)
    assert _scaled_err(pred.float().numpy(), want_pred) <= rel
    assert torch.equal(pred, pred2)
    assert abs(float(loss) - float(want_loss)) <= rel * max(
        1.0, abs(float(want_loss)))


def test_restore_reads_a_retention_root_and_only_params(tmp_path):
    ckpt = str(tmp_path / "ck")
    x, y = _batch()
    with jcompile(JRunConfig(model=JTINY, global_batch=4, guard=True,
                             save_every=1, keep_last=2,
                             checkpoint_dir=ckpt)) as tr:
        tr.step(x, y)  # writes step_<n> under the root
    with InferenceSession.restore(ckpt, device="cpu") as sess:
        assert sess.config.save_every is None
        assert sess.config.grad_comm == "auto"
        assert sess.config.resolved_guard is False
        assert set(sess.params) == {"conv0_w", "bn0_scale", "bn0_bias",
                                    "conv1_w", "bn1_scale", "bn1_bias",
                                    "fc0_w", "fc0_b", "fc1_w", "fc1_b",
                                    "fc2_w", "fc2_b"}


def test_restore_rejects_a_corrupt_leaf(tmp_path):
    from repro_torch.train import checkpoint

    ckpt = str(tmp_path / "ck")
    with jcompile(JRunConfig(model=JTINY, global_batch=4,
                             checkpoint_dir=ckpt)) as tr:
        tr.save()
    manifest = json.load(open(tmp_path / "ck" / "manifest.json"))
    files = {l["path"]: tmp_path / "ck" / l["file"]
             for l in manifest["leaves"]}
    # an optimizer leaf is never read by serving...
    opt_leaf = next(p for p in files if p.startswith("['opt']"))
    np.save(files[opt_leaf], np.load(files[opt_leaf]) + 1.0)
    assert not checkpoint.validate(ckpt)
    InferenceSession.restore(ckpt, device="cpu").close()
    # ...a params leaf is, and its CRC catches the change
    leaf = files["['params']['conv0_w']"]
    np.save(leaf, np.load(leaf) + 1.0)
    with pytest.raises(checkpoint.CheckpointCorrupt, match="CRC"):
        InferenceSession.restore(ckpt, device="cpu")


# ------------------------------------------------------ queue semantics ----
def test_harness_coalesces_into_one_batch():
    with _session() as sess:
        with sess.serve(max_batch=4, max_wait_ms=250.0) as h:
            x, _ = _batch()
            rows = [f.result(timeout=60) for f in h.submit_many(list(x))]
            s = h.stats()
        assert s["requests"] == 4 and s["batches"] == 1, s
        assert s["mean_fill"] == 4.0
        direct = sess.predict(x).numpy()  # same batch composition
        for i, r in enumerate(rows):
            np.testing.assert_array_equal(r, direct[i])


def test_worker_fault_surfaces_as_failed_future_not_hang():
    with _session() as sess:
        with sess.serve(max_batch=1, max_wait_ms=0.0) as h:
            with faults.active(faults.FaultSpec("serve.forward",
                                                at_calls=(0,))):
                bad = h.submit(VOL)
                with pytest.raises(faults.InjectedFault):
                    bad.result(timeout=60)
                good = h.submit(VOL)  # the worker survived
                assert good.result(timeout=60).shape == (TINY.out_dim,)
        t = sess.telemetry()
        assert t["serve.worker_failures"] == 1.0
        assert t["serve.requests"] == 1.0


@pytest.mark.parametrize("drain", [True, False])
def test_harness_close_drains_or_fails_queued(drain):
    with _session() as sess:
        h = sess.serve(max_batch=2, max_wait_ms=1.0, max_queue=32)
        futs = [h.submit(VOL) for _ in range(7)]
        h.close(drain=drain)
        assert all(f.done() for f in futs)
        for f in futs:
            if drain:
                assert f.result().shape == (TINY.out_dim,)
            elif f.exception() is not None:
                assert isinstance(f.exception(), RuntimeError)
        with pytest.raises(RuntimeError, match="closed"):
            h.submit(VOL)
        h.close()  # idempotent


def test_serve_trace_exports_the_reference_spans(tmp_path):
    path = str(tmp_path / "serve_trace.json")
    with _session(trace=path) as sess:
        with sess.serve(max_batch=4, max_wait_ms=50.0) as h:
            for f in h.submit_many(list(_batch()[0])):
                f.result(timeout=60)
    ok, problems = export_lib.validate_chrome_trace(path)
    assert ok, problems
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    for span in ("serve.enqueue", "serve.batch", "serve.forward",
                 "serve.reply"):
        assert span in names, (span, sorted(names))


# ------------------------------------------------------ config surface ----
@pytest.mark.parametrize("kw,field", [
    (dict(grad_comm="reduce_scatter"), "grad_comm"),
    (dict(pipeline=2), "pipeline"),
    (dict(guard=True), "guard"),
    (dict(save_every=5, checkpoint_dir="x"), "save_every"),
    (dict(keep_last=2, checkpoint_dir="x"), "keep_last"),
    (dict(data=2, global_batch=2), "data"),
    (dict(spatial=2), "spatial"),
    (dict(plan="auto"), "plan"),
    (dict(memory_budget_gib=1.0), "memory_budget_gib"),
    (dict(precision="fp8"), "precision"),
    (dict(global_batch=0), "global_batch"),
])
def test_infer_mode_rejections_name_the_field(kw, field):
    with pytest.raises(RunConfigError) as e:
        RunConfig(model=TINY, mode="infer", **kw).validate()
    assert e.value.field == field, (kw, e.value.field)
    assert e.value.fix  # every rejection names a concrete fix


def test_mode_dispatch_and_train_slice():
    sess = _session(global_batch=2)
    assert isinstance(sess, InferenceSession)
    rep = sess.describe()
    assert rep.plan_name == "cosmoflow.legacy"
    # the forward-only memory model at this batch (core/memory.py)
    assert rep.modeled_peak == memory.infer_peak_bytes(
        TINY, sess.plan, global_batch=2, precision="fp32")
    assert rep.modeled_peak.total > 0 and "modeled forward" in str(rep)
    assert rep.param_count == TINY.param_count()
    # float64 volumes are served as fp32, as the reference serves them
    x64 = _batch(n=2)[0].astype(np.float64)
    assert torch.equal(sess.predict(x64), sess.predict(x64.astype(np.float32)))
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.predict(_batch(n=1)[0])
    # training splits depth too, one device per shard
    with compile(RunConfig(model=TINY, spatial=2, global_batch=2),
                 devices=["cpu"] * 2) as train:
        assert train.mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(RunConfigError) as e:
        compile(RunConfig(model=TINY, spatial=2), devices=["cpu"] * 3)
    assert e.value.field == "spatial"
    with pytest.raises(RunConfigError) as e:
        compile_infer(RunConfig(model=TINY), device="cpu")
    assert e.value.field == "mode"
    # the U-Net serves too; a model the registry lacks names the field
    RunConfig(model="unet3d-256", mode="infer").validate()
    with pytest.raises(RunConfigError) as e:
        RunConfig(model="unet3d-512", mode="infer").validate()
    assert e.value.field == "model"


def test_entry_points_need_an_explicit_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile(RunConfig(model=TINY, mode="infer"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_infer(RunConfig(model=TINY, mode="infer"))
