"""Forward-only inference sessions.

``compile_infer(RunConfig(mode="infer"), device=None, devices=None) ->
InferenceSession``: validate, resolve the plan and precision, place the
plan's mesh on devices (``launch/mesh.py``), build the parameters
(seeded from ``config.seed``) and cast the fp32 masters to the serving
dtype once. The forward is the plan-sharded
``train.train_step.make_convnet_forward_step`` under
``torch.inference_mode()``: with ``spatial=S`` each batch is split along
depth into S shards that run the model's forward together
(``core/spmd.py``), through the port's conv3d, bn_act and halo
pack/unpack kernels on the card. CosmoFlow returns (N, out_dim)
predictions, the 3D U-Net (N, D, H, W, out_dim) per-voxel logits. With
``data=D`` each batch is also split into D slices (a batch then needs a
multiple of D volumes; the harness pads to one), and a plan whose deep
stages move the spatial group into the batch (``plan="auto"``, or a
pinned plan) serves each sample's deep layers on one shard (a batch
then needs a multiple of D x S volumes: ``batch_multiple``).

``InferenceSession.restore(path)`` serves a checkpoint the reference
trained: it reads the embedded run config, strips the training-only
knobs, reads ONLY the ``params`` leaves (the optimizer state on disk is
never touched) and casts the masters once at load, after which the
forward's per-use cast is the identity.

``InferenceSession.serve()`` starts a ``ServingHarness``
(``repro_torch.serve.harness``) whose worker threads feed coalesced
batches into the session's forward; over processes on rank 0, every
other rank following it (``ServingFollower``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import session as session_lib
from repro_torch.api.config import RunConfig, RunConfigError
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import memory as memory_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import DeviceLike
from repro_torch.models import cosmoflow as cosmoflow_lib
from repro_torch.models import for_config
from repro_torch.models import unet3d as unet_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.train import checkpoint
from repro_torch.train import train_step as train_step_lib

# training-only knobs stripped when an embedded training config is
# repurposed for serving (validate rejects them under mode="infer")
_TRAIN_ONLY = dict(mode="infer", guard=None, grad_comm="auto",
                   pipeline=1, micro_batches=4, pipeline_schedule="1f1b",
                   save_every=None, keep_last=None, metrics_jsonl=None,
                   prefetch=0)


@dataclasses.dataclass(frozen=True)
class InferReport:
    """``InferenceSession.describe()``: the serving plan, mesh, devices
    and precision, and the modeled forward-only peak per shard
    (``core/memory.py::infer_peak_bytes``)."""

    plan_name: str
    mesh_shape: Dict[str, int]
    precision: str
    param_count: int
    modeled_peak: Any
    device: str
    devices: Tuple[str, ...] = ()
    transport: Optional[str] = None
    process_rank: Optional[int] = None
    released: bool = False

    def __str__(self) -> str:
        procs = ("" if self.transport is None else
                 f" (rank {self.process_rank} of a process mesh over "
                 f"{self.transport})")
        if self.released:
            procs = (f" (rank {self.process_rank} released: the plan's "
                     f"ranks serve it)")
        return (
            f"InferenceSession[{self.plan_name}] on {', '.join(self.devices)}"
            f"{procs}\n  mesh {self.mesh_shape}  precision={self.precision}\n"
            f"  params {self.param_count / 1e6:.2f}M  modeled forward "
            f"peak/shard {self.modeled_peak.describe()}")


def compile_infer(config: RunConfig, *, device: DeviceLike = None,
                  devices: Optional[Sequence[DeviceLike]] = None
                  ) -> "InferenceSession":
    """Validate ``config`` (``mode`` must be ``"infer"``), resolve
    plan/precision, and return a live ``InferenceSession`` on ``device``
    or ``devices`` (one per shard; neither: the card(s)) with freshly
    initialized params."""
    sess = _compile_infer(config, device, devices)
    if sess.released:
        return sess
    gen = torch.Generator().manual_seed(config.seed)
    sess.params = sess._cast_once(session_lib.rank0_params(
        sess.mesh, for_config(sess.cfg).init_params(sess.cfg, gen,
                                                    sess.device)))
    return sess


def _compile_infer(config: RunConfig, device: DeviceLike,
                   devices: Optional[Sequence[DeviceLike]]
                   ) -> "InferenceSession":
    if config.mode != "infer":
        raise RunConfigError(
            "mode", f"compile_infer got mode={config.mode!r}",
            "set RunConfig(mode='infer') (repro_torch.api.compile "
            "dispatches on it)")
    config.validate(device_count=None)
    cfg = config.resolve_model()
    # the planner prices the default reduction; serving reduces nothing
    plan, precision, mesh, ranks = session_lib._mesh_for(
        config, cfg, device, devices, "overlap")
    if mesh is None:  # a rank the plan does not use
        return session_lib.Released(config, cfg, plan, precision, "overlap",
                                    ranks)
    return InferenceSession(config, cfg, mesh, plan, precision)


class InferenceSession(session_lib._Traced):
    """A forward-only serving run over a mesh of devices. Build with
    ``repro_torch.api.compile(RunConfig(mode="infer"))`` or
    ``InferenceSession.restore(checkpoint_dir)``, not directly."""

    released = False  # a rank the plan serves on (``api.session.Released``)

    def __init__(self, config, cfg, mesh, plan, precision):
        self.config: RunConfig = config
        self.cfg: ConvNetConfig = cfg
        self.mesh: mesh_lib.Mesh = mesh
        self.plan: plan_lib.ParallelPlan = plan
        self.precision: str = precision_lib.get(precision).name
        # the parameters live here; the predictions come back here
        self.device: torch.device = mesh.home
        self.params: Dict[str, torch.Tensor] = {}
        self._replicas: Optional[tuple] = None  # (params, one per shard)
        self._step = train_step_lib.make_convnet_forward_step(
            cfg, mesh, plan=plan, overlap=config.overlap_halo,
            precision=self.precision)
        self._harnesses: list = []
        self._followers: list = []  # over processes, ranks other than 0
        self._init_trace(config)

    # --------------------------------------------------------- forward ----
    def _cast_once(self, params):
        """fp32 masters -> serving dtype, ONCE at load."""
        return precision_lib.get(self.precision).cast_compute(params)

    def _as_input(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        # float64 volumes become fp32, as the reference's jnp.asarray
        # makes them with 64-bit floats off
        return t.float() if t.dtype == torch.float64 else t

    def _per_shard(self, params) -> list:
        """One parameter dict per shard, copies made once per device
        for the session's own parameters."""
        if params is not self.params:
            return train_step_lib.replicate(params, self.mesh.local_devices)
        if self._replicas is None or self._replicas[0] is not params:
            self._replicas = (params, train_step_lib.replicate(
                params, self.mesh.local_devices))
        return self._replicas[1]

    @property
    def batch_multiple(self) -> int:
        """What a batch must be a multiple of: the batch shards of the
        plan's most batch-sharded stage (the data degree, times the
        spatial degree where a stage turns the spatial group into batch
        shards)."""
        return max(math.prod(self.plan.degree(a) for a in s.batch_axes)
                   for s in self.plan.stages)

    def _forward_for(self, batch: int) -> Callable:
        """The forward for a batch of ``batch`` volumes:
        ``fn(params, x) -> (batch, out_dim)`` predictions on the
        session's device."""
        d = self.batch_multiple
        if batch < 1 or batch % d:
            raise ValueError(
                f"batch size {batch} does not divide over the plan's {d} "
                f"batch shards; pass a positive multiple of {d}")

        def fn(params, x):
            with torch.inference_mode():
                return self._step(self._per_shard(params), self._as_input(x))
        return fn

    def predict(self, x) -> torch.Tensor:
        """Forward a batch of volumes (N, D, H, W, C), numpy or tensor:
        returns CosmoFlow's (N, out_dim) predictions or the U-Net's
        (N, D, H, W, out_dim) logits, on the session's device. A shard
        that fails makes this raise its error."""
        if self._closed:
            raise RuntimeError("InferenceSession is closed")
        fn = self._forward_for(int(x.shape[0]))
        with trace_lib.span("serve.forward", batch=int(x.shape[0])):
            return fn(self.params, x)

    def evaluate(self, x, y):
        """(loss, predictions) on a labeled batch, as the reference's eval
        step: CosmoFlow's fp32 mean over samples of the per-sample MSE;
        the U-Net's voxel cross-entropy (the mean over every voxel of
        ``y``'s (N, D, H, W) labels) and its logits."""
        if self._closed:
            raise RuntimeError("InferenceSession is closed")
        pred = self.predict(x)
        with torch.inference_mode():
            if self.cfg.arch == "unet3d":
                labels = torch.as_tensor(y, device=self.device)
                loss = unet_lib.voxel_nll(pred, labels, labels.numel())
            else:
                loss = cosmoflow_lib.mse(pred, self._as_input(y),
                                         int(x.shape[0]))
        return loss, pred

    # --------------------------------------------------------- serving ----
    def serve(self, *, max_batch: int = 8, max_wait_ms: float = 2.0,
              max_queue: int = 64, workers: int = 1):
        """Start a batched serving harness over this session's forward
        (``repro_torch.serve.harness.ServingHarness``): a bounded request
        queue, worker threads coalescing up to ``max_batch`` requests
        (waiting at most ``max_wait_ms`` to fill a batch), per-request
        futures, backpressure at ``max_queue``. Over processes rank 0
        gets that harness, the one front end, and every other rank a
        ``ServingFollower`` that runs its shard of each batch rank 0
        broadcasts until rank 0's harness closes (every rank calls
        ``serve``). The session closes its harnesses on ``close()``."""
        from repro_torch.serve.harness import ServingFollower, ServingHarness

        if isinstance(self.mesh, mesh_lib.ProcessMesh) and self.mesh.rank:
            f = ServingFollower(self)
            self._followers.append(f)
            return f
        h = ServingHarness(self, max_batch=max_batch,
                           max_wait_ms=max_wait_ms, max_queue=max_queue,
                           workers=workers)
        self._harnesses.append(h)
        return h

    # --------------------------------------------------- introspection ----
    def telemetry(self) -> Dict[str, float]:
        """Serving counters, summed over this session's harnesses (live
        and closed): ``serve.requests`` / ``serve.batches`` completed,
        ``serve.batch_fill`` (mean real requests per forward),
        ``serve.queue_depth``, ``serve.worker_failures`` and the latency
        quantiles ``serve.latency_p50_ms`` / ``p95`` / ``p99``, routed
        through the session's ``MetricsRegistry``."""
        out = {"serve.requests": 0.0, "serve.batches": 0.0,
               "serve.batch_fill": 0.0, "serve.queue_depth": 0.0,
               "serve.worker_failures": 0.0}
        lat: list = []
        fill_sum = 0.0
        for h in self._harnesses:
            s = h.stats()
            out["serve.requests"] += s["requests"]
            out["serve.batches"] += s["batches"]
            out["serve.queue_depth"] += s["queue_depth"]
            out["serve.worker_failures"] += s["worker_failures"]
            fill_sum += s["mean_fill"] * s["batches"]
            lat.extend(h.latencies_s())
        if out["serve.batches"]:
            out["serve.batch_fill"] = fill_sum / out["serve.batches"]
        for q, key in ((0.50, "serve.latency_p50_ms"),
                       (0.95, "serve.latency_p95_ms"),
                       (0.99, "serve.latency_p99_ms")):
            out[key] = _quantile_ms(lat, q)
        return self._metrics.absorb(out)

    def describe(self) -> InferReport:
        """The serving plan, mesh, devices, precision, parameter count
        and the modeled forward-only peak at this config's batch."""
        peak = memory_lib.infer_peak_bytes(
            self.cfg, self.plan, global_batch=self.config.global_batch,
            precision=self.precision)
        return InferReport(
            plan_name=self.plan.name, mesh_shape=self.mesh.shape,
            precision=self.precision, param_count=self.cfg.param_count(),
            modeled_peak=peak, device=str(self.device),
            devices=tuple(str(d) for d in self.mesh.devices),
            **session_lib.process_fields(self.mesh))

    # ------------------------------------------------------ checkpoint ----
    @classmethod
    def restore(cls, path: str, *, device: DeviceLike = None,
                devices: Optional[Sequence[DeviceLike]] = None,
                data: Optional[int] = None, spatial: Optional[int] = None,
                global_batch: Optional[int] = None,
                precision: Optional[str] = None,
                trace=None) -> "InferenceSession":
        """Build an ``InferenceSession`` on ``device`` or ``devices``
        (as ``compile``) from a reference TRAINING checkpoint: the
        embedded run config is stripped of its training-only knobs, ONLY
        the ``params`` leaves are read, and the fp32 masters are cast to
        the serving dtype once at load. ``data=`` / ``spatial=`` re-degree
        the run (a checkpoint trained on many devices serves on one with
        ``data=1, spatial=1``, or depth-split over S with ``spatial=S``);
        changed degrees and pipelined training plans re-resolve the plan,
        unchanged degrees keep the pinned one. ``path`` may be a
        retention root of ``step_<n>`` checkpoints."""
        meta_path = os.path.join(path, session_lib._META_FILE)
        if not os.path.exists(meta_path):
            found = checkpoint.latest_valid_step(path)
            if found is not None:
                return cls.restore(
                    found[1], device=device, devices=devices, data=data,
                    spatial=spatial,
                    global_batch=global_batch, precision=precision,
                    trace=trace)
            raise FileNotFoundError(
                f"no checkpoint at {path}: neither "
                f"{session_lib._META_FILE} nor a valid step_<n> "
                f"directory")
        with open(meta_path) as f:
            meta = json.load(f)
        config = RunConfig.from_json(meta["run_config"])
        new_data = config.data if data is None else data
        new_spatial = config.spatial if spatial is None else spatial
        pinned_plan = config.plan
        keep_plan = (isinstance(pinned_plan, plan_lib.ParallelPlan)
                     and pinned_plan.n_groups == 1
                     and new_data == config.data
                     and new_spatial == config.spatial)
        config = dataclasses.replace(
            config, **_TRAIN_ONLY,
            data=new_data, spatial=new_spatial,
            plan=pinned_plan if keep_plan else "fixed",
            global_batch=(config.global_batch if global_batch is None
                          else global_batch),
            precision=(config.precision if precision is None
                       else precision),
            trace=config.trace if trace is None else trace)
        sess = _compile_infer(config, device, devices)
        if sess.released:
            return sess
        model = for_config(sess.cfg)
        tree = checkpoint.restore(path, {"params": {
            k: torch.empty(s, device="meta")
            for k, s in model.param_shapes(sess.cfg).items()}})
        sess.params = sess._cast_once(model.params_from_numpy(
            tree["params"], sess.device, cfg=sess.cfg))
        return sess

    # ------------------------------------------------------- lifecycle ----
    def _release(self) -> None:
        """Drain and join every serving harness; a follower waits for
        rank 0's harness to stop."""
        for h in self._harnesses:
            h.close(drain=True)
        for f in self._followers:
            f.close()


def _quantile_ms(samples_s, q: float) -> float:
    """Nearest-rank quantile of latency samples, in milliseconds (0.0
    with no samples)."""
    if not samples_s:
        return 0.0
    v = sorted(samples_s)
    idx = min(int(q * len(v)), len(v) - 1)
    return v[idx] * 1e3


def to_host(out: torch.Tensor) -> np.ndarray:
    """A forward's output as a host numpy array, in one transfer (half
    floats widened to fp32, exactly: numpy has no bfloat16)."""
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


__all__ = ["InferenceSession", "InferReport", "compile_infer", "to_host"]
