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
inside (under ``grad_comm="reduce_scatter"``, ZeRO-1, one optimizer
state a shard, each over its 1/N of the flat buckets);
``save``/``Session.restore`` write and read the reference's checkpoint
format (ZeRO-1's state as the reference's global padded buckets), so
each package resumes the other's runs, on any mesh shape; ``describe``
reports the modeled peak memory (``core/memory.py``); ``make_loader``
gives it batches from a hyperslab store (``data/pipeline.py``). Both
run CosmoFlow (``y``: (N, out_dim) targets) and the 3D U-Net (``y``:
(N, D, H, W) voxel labels; ``evaluate`` returns per-voxel logits).

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
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.api.config import RunConfig, RunConfigError
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import faults
from repro_torch.core import grad_comm as grad_comm_lib
from repro_torch.core import memory as memory_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.core.tree import key_paths
from repro_torch.data import pipeline, store, synthetic
from repro_torch.data import prefetch as prefetch_lib
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
        cfg, optimizer, params, grad_comm=grad_comm, plan=plan, mesh=mesh,
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
    reduction mode, the guard's telemetry and the modeled peak memory
    per shard (``core/memory.py``). The modeled step time comes with the
    plans slice and is None until then."""

    plan_name: str
    stages: Tuple[Tuple[int, int, Tuple[Optional[str], ...],
                        Tuple[str, ...], bool], ...]
    mesh_shape: Dict[str, int]
    precision: str
    grad_comm: str
    global_batch: int
    param_count: int
    device: str
    modeled_peak: Any
    telemetry: Dict[str, float] = dataclasses.field(default_factory=dict)
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
            f"  params {self.param_count / 1e6:.2f}M  modeled peak/shard "
            f"{self.modeled_peak.describe()}  step time: not modeled yet"
            + (("\n  guard: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(self.telemetry.items())))
               if self.telemetry else ""))


class Session(_Traced):
    """A training run over a data x spatial mesh on one device. The
    session holds one copy of the fp32 masters and the optimizer state
    (every shard's update is the same); under ZeRO-1 one state a shard
    (a list in rank order). Build with
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
        self._loaders: list = []  # telemetry and close()
        self._tmpdirs: list = []
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

    # ------------------------------------------------------------ data ----
    def make_loader(self, root: Optional[str] = None, *,
                    num_samples: int = 16, seed: int = 0, cache: bool = True,
                    prefetch: Optional[int] = None, halo_voxels: int = 0):
        """A loader of global batches for ``step``, each mesh rank's block
        of the plan's entry stage read on its own (``data/pipeline.py``).
        ``root`` (or ``config.data_dir``) names an existing
        ``HyperslabStore``; with neither, a synthetic dataset of
        ``num_samples`` volumes (the model's: cosmology cubes and targets,
        or segmentation volumes and voxel labels) is written to a
        directory the Session owns, which ``close()`` removes.

        ``prefetch`` (default ``config.prefetch``): 0 returns the
        synchronous ``SpatialParallelLoader`` (the bitwise oracle); >= 1
        wraps it in a ``PrefetchLoader`` of that queue depth, whose worker
        reads the next batch and enqueues its copies while the current
        step computes. ``halo_voxels`` widens each rank's reads by that
        margin."""
        root = root or self.config.data_dir
        if root is None:
            tmp = tempfile.TemporaryDirectory()
            self._tmpdirs.append(tmp)
            root = tmp.name
            if self.cfg.arch == "cosmoflow":
                cubes, targets = synthetic.make_cosmology_dataset(
                    num_samples, self.cfg.input_width,
                    channels=self.cfg.in_channels, seed=seed)
                store.write_dataset(root, cubes, targets)
            else:
                cubes, labels = synthetic.make_segmentation_dataset(
                    num_samples, self.cfg.input_width,
                    num_classes=self.cfg.out_dim,
                    channels=self.cfg.in_channels, seed=seed)
                store.write_dataset(root, cubes, labels=labels)
        loader = pipeline.SpatialParallelLoader(
            store.HyperslabStore(root), self.mesh, self.plan.stages[0],
            global_batch=self.config.global_batch, seed=seed, cache=cache,
            halo_voxels=halo_voxels)
        depth = self.config.prefetch if prefetch is None else prefetch
        if depth:
            loader = prefetch_lib.PrefetchLoader(loader, depth=depth)
        self._loaders.append(loader)
        return loader

    # --------------------------------------------------- introspection ----
    def telemetry(self) -> Dict[str, float]:
        """Guard, recovery and input counters through the session's
        ``MetricsRegistry``: ``steps``, ``skipped_steps`` (guarded steps
        whose update was vetoed; reading it waits for the device),
        ``loss_scale`` (the live fp16 scale, else 1), ``loader_retries``
        (store reads retried, over this Session's loaders) and
        ``resumes``. With a loader: ``io_pfs_bytes`` (store bytes read)
        and ``io_cache_hit_ratio`` (the share of loader bytes the cache
        served); with a prefetching loader also ``io_stall_s`` (time the
        steps still waited for a queued batch) and ``io_queue_occupancy``
        (the mean queue depth when a batch was served)."""
        skipped = (self._guarded_steps - float(self._applied_acc)
                   if self._guarded_steps else 0.0)
        state = (self.opt_state[0] if isinstance(self.opt_state, list)
                 else self.opt_state)
        scale = (float(state.loss_scale)
                 if isinstance(state, precision_lib.MPState) else 1.0)
        out = {"steps": float(self._t), "skipped_steps": round(skipped),
               "loss_scale": scale,
               "loader_retries": float(sum(ld.store.retries
                                           for ld in self._loaders)),
               "resumes": float(self.resumes)}
        if self._loaders:
            out["io_pfs_bytes"] = float(
                sum(ld.stats.pfs_bytes for ld in self._loaders))
            served = sum(
                ld.stats.pfs_bytes + ld.stats.cache_bytes_local
                + ld.stats.cache_bytes_redistributed for ld in self._loaders)
            out["io_cache_hit_ratio"] = (
                1.0 - out["io_pfs_bytes"] / served if served else 0.0)
            queued = [ld for ld in self._loaders
                      if hasattr(ld, "queue_occupancy")]
            if queued:
                out["io_stall_s"] = sum(ld.stall_s for ld in queued)
                out["io_queue_occupancy"] = (
                    sum(ld.queue_occupancy() for ld in queued) / len(queued))
        return self._metrics.absorb(out)

    def describe(self) -> Report:
        peak = memory_lib.plan_peak_bytes(
            self.cfg, self.plan, global_batch=self.config.global_batch,
            grad_comm=self.grad_comm, precision=self.precision)
        return Report(
            plan_name=self.plan.name,
            stages=tuple((s.start, s.stop, tuple(s.spatial_axes),
                          tuple(s.batch_axes), s.remat)
                         for s in self.plan.stages),
            mesh_shape=self.mesh.shape, precision=self.precision,
            grad_comm=self.grad_comm,
            global_batch=self.config.global_batch,
            param_count=self.cfg.param_count(), device=str(self.device),
            telemetry=self.telemetry(), modeled_peak=peak)

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
        opt, specs = self.opt_state, None
        if self.grad_comm == "reduce_scatter":
            # the reference's layout: global padded buckets, dim 0 sharded
            # over the data axes, scalars replicated
            opt = grad_comm_lib.global_opt_state(
                [self.opt_state[r] for r in train_step_lib.data_shards(
                    self.mesh, self.plan.stages[0])])
            axes = list(self.plan.stages[0].batch_axes)
            specs = {path: [axes] if leaf.dim() else []
                     for path, leaf in key_paths({"opt": opt})}
        return {"tree": {"params": self.params, "opt": opt},
                "step": self._t, "precision": self.precision,
                "extra_files": {_META_FILE: meta}, "specs": specs}

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
        zero1 = sess.grad_comm == "reduce_scatter"
        tree = checkpoint.restore(path, {
            "params": sess.params,
            "opt": sess.opt_state[0] if zero1 else sess.opt_state})
        sess.params = model.params_from_numpy(
            tree["params"], sess.device, torch.float32, cfg=sess.cfg)
        if zero1:  # each shard's chunk of the global buckets, anew
            buckets = train_step_lib.convnet_grad_plan(sess.cfg)
            n = train_step_lib.data_degree(sess.plan)
            sess.opt_state = [grad_comm_lib.local_opt_state(
                tree["opt"], buckets, train_step_lib.batch_slice(
                    sess.mesh, r, sess.plan.stages[0])[0], n, sess.device)
                for r in range(sess.mesh.size)]
        else:
            sess.opt_state = model.opt_state_from_numpy(
                tree["opt"], sess.device, cfg=sess.cfg)
        sess._t = checkpoint.latest_step(path)
        return sess

    # ------------------------------------------------------- lifecycle ----
    def _release(self) -> None:
        for ld in self._loaders:
            ld.close()
        self._loaders = []
        for tmp in self._tmpdirs:
            tmp.cleanup()
        self._tmpdirs = []
        if self._metrics_sink is not None:
            self._metrics_sink.close()


__all__ = ["Report", "Session", "compile"]
