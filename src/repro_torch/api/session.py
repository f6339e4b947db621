"""``compile(RunConfig, device=None, devices=None)``: the port's one
assembly path.

``mode="infer"`` validates the config, resolves the plan and precision,
places the plan's mesh on devices and returns a forward-only
``repro_torch.serve.InferenceSession``. ``mode="train"`` returns a
training ``Session`` over a data x spatial mesh whose shards all lie on
one device: ``step`` runs the hybrid train step of
``train/train_step.py`` (each shard's forward through the conv3d,
bn_act and halo kernels, one backward, the gradient reduction, the Adam
update) with the parameters, optimizer state and dropout seed threaded
inside; ``save``/``Session.restore`` write and read the reference's
checkpoint format, so each package resumes the other's runs, on any
mesh shape. Both run CosmoFlow (``y``: (N, out_dim) targets) and the 3D
U-Net (``y``: (N, D, H, W) voxel labels; ``evaluate`` returns per-voxel
logits).

Entry points run on the card unless the caller says otherwise:
``device="cpu"`` (one shard, as the tests run), or ``devices=[...]`` with
one device per shard of a run over data x spatial > 1 shards —
``["cuda:0"] * 2`` puts both shards on one card, ``["cpu"] * 2`` on the
CPU. With neither, a one-shard run takes the CUDA device and an n-shard
run ``cuda:0..n-1``; without enough cards they raise instead of running
elsewhere.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.api.config import RunConfig, RunConfigError
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import faults
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import DeviceLike
from repro_torch.models import cosmoflow as cosmoflow_lib
from repro_torch.models import for_config
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.optim.adam import Adam, constant, linear_decay, warmup_cosine
from repro_torch.train import checkpoint
from repro_torch.train import train_step as train_step_lib

# the run description a training checkpoint embeds (reference format)
_META_FILE = "run_config.json"


def _resolve_plan(config: RunConfig, cfg: ConvNetConfig
                  ) -> Tuple["plan_lib.ParallelPlan", str]:
    """(plan, precision name) for a validated config: a pinned plan as
    given, else the fixed-degree legacy plan at the config's degrees."""
    explicit = None if config.precision == "auto" else config.precision
    if isinstance(config.plan, plan_lib.ParallelPlan):
        return config.plan, explicit or config.plan.precision
    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)),
        (config.spatial, 1, 1), data_degrees=(config.data,))
    return plan, explicit or "fp32"


def _build_optimizer(config: RunConfig) -> Adam:
    if config.lr_schedule == "constant":
        sched = constant(config.lr)
    elif config.lr_schedule == "linear_decay":
        sched = linear_decay(config.lr, config.total_steps)
    else:
        sched = warmup_cosine(config.lr, config.warmup_steps,
                              config.total_steps)
    return Adam(lr=sched, grad_clip=config.grad_clip)


def compile(config: RunConfig, *, device: DeviceLike = None,  # noqa: A001
            devices: Optional[Sequence[DeviceLike]] = None,
            mask_source: Optional[cosmoflow_lib.MaskSource] = None):
    """Validate ``config`` and build its session on ``device`` or on
    ``devices`` (one per shard; give one of the two, or neither for the
    card). ``mode="infer"`` returns an ``InferenceSession``,
    ``mode="train"`` a ``Session`` with freshly initialized parameters
    (seeded from ``config.seed``); ``mask_source`` replaces its dropout
    masks (``models/cosmoflow.py``)."""
    if config.mode == "infer":
        from repro_torch.serve.session import compile_infer  # imports us

        return compile_infer(config, device=device, devices=devices)
    return _compile_train(config, device, devices, mask_source)


def _compile_train(config: RunConfig, device: DeviceLike,
                   devices: Optional[Sequence[DeviceLike]],
                   mask_source) -> "Session":
    config.validate(device_count=None)
    shards = config.data * config.spatial
    devs = mesh_lib.mesh_devices(shards, device=device, devices=devices)
    config.validate(device_count=len(devs))
    if len(devs) != shards:
        raise RunConfigError(
            "spatial", f"{len(devs)} devices given for data x spatial = "
            f"{shards} shards", "pass one device per shard")
    cfg = config.resolve_model()
    plan, precision = _resolve_plan(config, cfg)
    grad_comm = "overlap" if config.grad_comm == "auto" else config.grad_comm
    mesh = mesh_lib.make_plan_mesh(plan, devs)
    optimizer = _build_optimizer(config)
    params = for_config(cfg).init_params(
        cfg, torch.Generator().manual_seed(config.seed), mesh.devices[0])
    opt_state = train_step_lib.make_convnet_opt_state(
        cfg, optimizer, params, grad_comm=grad_comm, plan=plan,
        precision=precision)
    return Session(config, cfg, mesh, plan, precision, grad_comm, optimizer,
                   params, opt_state, mask_source)


class _Traced:
    """What every session has: a tracer that becomes the process's
    active one when ``config.trace`` asks for it, a metrics registry,
    trace export, and an idempotent, thread-safe ``close`` (also as a
    context manager). A subclass releases its own resources in
    ``_release``."""

    def _init_trace(self, config: RunConfig) -> None:
        self._close_lock = threading.Lock()
        self._closed = False
        self.tracer = trace_lib.Tracer()
        self._metrics = metrics_lib.MetricsRegistry()
        self._trace_path = (config.trace if isinstance(config.trace, str)
                            else None)
        self._exported_traces: set = set()
        if config.trace:
            trace_lib.enable(self.tracer)

    def export_trace(self, path: Optional[str] = None) -> str:
        """Write the session's span log as a Chrome/Perfetto trace. An
        existing file that this session did not write is not
        overwritten: ``-1``, ``-2``, ... are appended to the name."""
        path = path or self._trace_path
        if path is None:
            raise ValueError("no path: pass export_trace(path) or set "
                             "RunConfig(trace='out/trace.json')")
        if path not in self._exported_traces and os.path.exists(path):
            base, ext = os.path.splitext(path)
            i = 1
            while os.path.exists(f"{base}-{i}{ext}"):
                i += 1
            path = f"{base}-{i}{ext}"
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.tracer.export_chrome(path)
        self._exported_traces.add(path)
        return path

    def _release(self) -> None:
        pass

    def close(self) -> None:
        """Release the session's resources, write the trace file when one
        was asked for, and deregister the tracer. Idempotent and
        thread-safe."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._release()
        if self._trace_path and len(self.tracer):
            self.export_trace(self._trace_path)
        trace_lib.disable(self.tracer)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass(frozen=True)
class Report:
    """``Session.describe()``: the plan, mesh, device, precision,
    reduction mode and the guard's telemetry. The modeled peak memory
    and step time come with the memory and plans slices and are None
    until then."""

    plan_name: str
    stages: Tuple[Tuple[int, int, Tuple[Optional[str], ...],
                        Tuple[str, ...], bool], ...]
    mesh_shape: Dict[str, int]
    precision: str
    grad_comm: str
    global_batch: int
    param_count: int
    device: str
    telemetry: Dict[str, float] = dataclasses.field(default_factory=dict)
    modeled_peak: Optional[Any] = None
    predicted_step_s: Optional[float] = None

    def __str__(self) -> str:
        stages = "; ".join(
            f"[{a},{b}) spatial={[x for x in sp if x]} batch={list(ba)}"
            + (" remat" if rm else "") for a, b, sp, ba, rm in self.stages)
        return (
            f"Session[{self.plan_name}] on {self.device}\n"
            f"  mesh {self.mesh_shape}  precision={self.precision}  "
            f"grad_comm={self.grad_comm}  global_batch={self.global_batch}\n"
            f"  stages: {stages}\n"
            f"  params {self.param_count / 1e6:.2f}M  modeled peak and step "
            f"time: not modeled yet"
            + (("\n  guard: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(self.telemetry.items())))
               if self.telemetry else ""))


class Session(_Traced):
    """A training run over a data x spatial mesh on one device. The
    session holds one copy of the fp32 masters and the optimizer state
    (every shard's update is the same). Build with
    ``repro_torch.api.compile(RunConfig(mode="train"))`` or
    ``Session.restore(checkpoint_dir)``, not directly."""

    def __init__(self, config, cfg, mesh, plan, precision, grad_comm,
                 optimizer, params, opt_state, mask_source=None):
        self.config: RunConfig = config
        self.cfg: ConvNetConfig = cfg
        self.mesh: mesh_lib.Mesh = mesh
        self.plan: plan_lib.ParallelPlan = plan
        self.precision: str = precision_lib.get(precision).name
        self.grad_comm: str = grad_comm
        self.optimizer = optimizer
        self.device: torch.device = mesh.devices[0]
        self.params: Dict[str, torch.Tensor] = params
        self.opt_state = opt_state
        self.mask_source = mask_source
        self._step_fn = train_step_lib.make_convnet_train_step(
            cfg, mesh, optimizer, global_batch=config.global_batch,
            plan=plan, overlap=config.overlap_halo, grad_comm=grad_comm,
            precision=self.precision, guard=config.resolved_guard,
            mask_source=mask_source)
        self._eval_fns: Dict[int, Any] = {}
        self._t = 0
        # guard telemetry: the applied flags are summed on the device, so
        # a step never waits for the host to read them
        self._guarded_steps = 0
        self._applied_acc = torch.zeros((), device=self.device)
        self.resumes = 0
        self._init_trace(config)
        self._metrics_sink = None
        if config.metrics_jsonl:
            d = os.path.dirname(config.metrics_jsonl)
            if d:
                os.makedirs(d, exist_ok=True)
            self._metrics_sink = metrics_lib.MetricsJsonlSink(
                config.metrics_jsonl)

    def _as_input(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    def _as_target(self, y) -> torch.Tensor:
        """CosmoFlow's targets as ``_as_input``; the U-Net's voxel labels
        as they come (integer classes)."""
        if self.cfg.arch == "unet3d":
            return torch.as_tensor(y, device=self.device)
        return self._as_input(y)

    # ----------------------------------------------------------- train ----
    @property
    def step_count(self) -> int:
        return self._t

    def step(self, batch, y=None) -> torch.Tensor:
        """One training step on a global batch (an ``(x, y)`` pair, or
        ``step(x, y)``); returns the loss (a tensor on the device).
        Parameters, optimizer state and the dropout seed (the step count)
        are threaded inside; the checkpoint policy (``save_every``,
        ``keep_last``) fires here, and so do the fault sites
        ``comm.stall``, ``device.loss`` and ``grads.nonfinite`` (which
        poisons the batch, so that the guard must skip the update)."""
        if self._closed:
            raise RuntimeError("Session is closed")
        x, y = batch if y is None else (batch, y)
        x, y = self._as_input(x), self._as_target(y)
        sink = self._metrics_sink
        t0 = time.perf_counter() if sink is not None else 0.0
        with trace_lib.span("train.step", step=self._t):
            faults.fire("comm.stall", step=self._t)
            faults.fire("device.loss", step=self._t)
            if faults.fire("grads.nonfinite", step=self._t):
                x = x * float("nan")  # the loss and every gradient
            out = self._step_fn(self.params, self.opt_state, x, y, self._t)
            if self.config.resolved_guard:
                self.params, self.opt_state, loss, applied = out
                self._guarded_steps += 1
                self._applied_acc = self._applied_acc + applied
            else:
                self.params, self.opt_state, loss = out
            self._t += 1
        if sink is not None:
            # host-side counters only: reading the loss would wait for
            # the device every step
            sink.write({"step": self._t - 1,
                        "wall_s": time.perf_counter() - t0,
                        "guarded_steps": self._guarded_steps})
        if (self.config.checkpoint_dir and self.config.save_every
                and self._t % self.config.save_every == 0):
            if self.config.keep_last is not None:
                checkpoint.save_step(self.config.checkpoint_dir,
                                     keep_last=self.config.keep_last,
                                     **self._checkpoint())
            else:
                self.save()
        return loss

    def evaluate(self, x, y):
        """(loss, predictions) on an eval batch: the forward without
        dropout and the fp32 MSE over its samples (the U-Net: the voxel
        cross-entropy and the per-voxel logits)."""
        if self._closed:
            raise RuntimeError("Session is closed")
        gb = int(x.shape[0])
        fn = self._eval_fns.get(gb)
        if fn is None:
            fn = self._eval_fns[gb] = train_step_lib.make_convnet_eval_step(
                self.cfg, self.mesh, global_batch=gb, plan=self.plan,
                overlap=self.config.overlap_halo, precision=self.precision)
        return fn(self.params, self._as_input(x), self._as_target(y))

    # --------------------------------------------------- introspection ----
    def telemetry(self) -> Dict[str, float]:
        """Guard and recovery counters through the session's
        ``MetricsRegistry``: ``steps``, ``skipped_steps`` (guarded steps
        whose update was vetoed; reading it waits for the device),
        ``loss_scale`` (the live fp16 scale, else 1), ``loader_retries``
        (0: the input pipeline comes with its slice) and ``resumes``."""
        skipped = (self._guarded_steps - float(self._applied_acc)
                   if self._guarded_steps else 0.0)
        scale = (float(self.opt_state.loss_scale)
                 if isinstance(self.opt_state, precision_lib.MPState)
                 else 1.0)
        return self._metrics.absorb({
            "steps": float(self._t), "skipped_steps": round(skipped),
            "loss_scale": scale, "loader_retries": 0.0,
            "resumes": float(self.resumes)})

    def describe(self) -> Report:
        return Report(
            plan_name=self.plan.name,
            stages=tuple((s.start, s.stop, tuple(s.spatial_axes),
                          tuple(s.batch_axes), s.remat)
                         for s in self.plan.stages),
            mesh_shape=self.mesh.shape, precision=self.precision,
            grad_comm=self.grad_comm,
            global_batch=self.config.global_batch,
            param_count=self.cfg.param_count(), device=str(self.device),
            telemetry=self.telemetry())

    # ------------------------------------------------------ checkpoint ----
    def save(self, path: Optional[str] = None) -> str:
        """Checkpoint the fp32 masters (once: shard 0's, which every
        shard shares), the optimizer state and the resolved run
        description (``run_config.json``), published by one atomic
        rename, in the reference's format."""
        path = path or self.config.checkpoint_dir
        if path is None:
            raise ValueError("no path: pass save(path) or set "
                             "RunConfig.checkpoint_dir")
        checkpoint.save(path, **self._checkpoint())
        return path

    def _checkpoint(self) -> Dict[str, Any]:
        """What a checkpoint taken now holds, as ``checkpoint.save``'s
        keywords."""
        meta = {"run_config": self._pinned_config().to_json()}
        return {"tree": {"params": self.params, "opt": self.opt_state},
                "step": self._t, "precision": self.precision,
                "extra_files": {_META_FILE: meta}}

    def _pinned_config(self) -> RunConfig:
        """The config with every ``"auto"`` resolved: the concrete model,
        the plan, precision, reduction mode and degrees."""
        return dataclasses.replace(
            self.config, model=self.cfg, plan=self.plan,
            precision=self.precision, grad_comm=self.grad_comm,
            data=self.plan.data_degree, spatial=self.plan.spatial_degree,
            pipeline=self.plan.n_groups)

    @classmethod
    def restore(cls, path: str, *, device: DeviceLike = None,
                devices: Optional[Sequence[DeviceLike]] = None,
                data: Optional[int] = None, spatial: Optional[int] = None,
                mask_source: Optional[cosmoflow_lib.MaskSource] = None
                ) -> "Session":
        """Rebuild a training session on ``device`` or ``devices`` from a
        checkpoint directory alone (the port's or the reference's): the
        embedded config, then the parameters, the optimizer state and the
        step count. ``data=`` / ``spatial=`` re-degree the run, so that a
        checkpoint of any mesh shape resumes on any other (a 2 x 2 run on
        one device with ``data=1, spatial=1``); changed degrees re-resolve
        the fixed plan, unchanged ones keep the pinned plan. ``path`` may
        be a retention root of ``step_<n>`` checkpoints: the newest that
        validates is restored."""
        if not os.path.exists(os.path.join(path, _META_FILE)):
            for _, p in reversed(checkpoint.list_steps(path)):
                if checkpoint.validate(p):
                    return cls.restore(p, device=device, devices=devices,
                                       data=data, spatial=spatial,
                                       mask_source=mask_source)
            raise FileNotFoundError(
                f"no checkpoint at {path}: neither {_META_FILE} nor a "
                f"valid step_<n> directory")
        with open(os.path.join(path, _META_FILE)) as f:
            config = RunConfig.from_json(json.load(f)["run_config"])
        new_data = config.data if data is None else data
        new_spatial = config.spatial if spatial is None else spatial
        if (new_data, new_spatial) != (config.data, config.spatial):
            config = dataclasses.replace(config, data=new_data,
                                         spatial=new_spatial, plan="fixed")
        sess = _compile_train(config, device, devices, mask_source)
        model = for_config(sess.cfg)
        tree = checkpoint.restore(path, {
            "params": model.param_shapes(sess.cfg), "opt": sess.opt_state})
        sess.params = model.params_from_numpy(
            tree["params"], sess.device, torch.float32, cfg=sess.cfg)
        sess.opt_state = model.opt_state_from_numpy(
            tree["opt"], sess.device, cfg=sess.cfg)
        sess._t = checkpoint.latest_step(path)
        return sess

    # ------------------------------------------------------- lifecycle ----
    def _release(self) -> None:
        if self._metrics_sink is not None:
            self._metrics_sink.close()


__all__ = ["Report", "Session", "compile"]
