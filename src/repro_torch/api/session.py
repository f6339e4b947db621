"""``compile(RunConfig, device=None, devices=None)``: the port's one
assembly path.

``mode="infer"`` validates the config, resolves the plan and precision,
places the plan's mesh on devices and returns a forward-only
``repro_torch.serve.InferenceSession``. ``mode="train"`` returns a
training ``Session`` over a data x spatial mesh whose shards all lie on
one device, or over ``pipeline`` device groups, each a data-parallel
mesh (``RunConfig(pipeline=P, micro_batches=M, pipeline_schedule=)``;
``data`` the total degree): ``step`` runs the hybrid train step of
``train/train_step.py`` (each shard's forward through the conv3d,
bn_act and halo kernels, one backward, the gradient reduction, the Adam
update), or the pipelined step (1F1B or the sequential oracle over M
micro-batches, one optimizer state a group), with the parameters,
optimizer state and dropout seed threaded inside (under ``grad_comm="reduce_scatter"``, ZeRO-1, one optimizer
state a shard, each over its 1/N of the flat buckets);
``save``/``Session.restore`` write and read the reference's checkpoint
format (ZeRO-1's state as the reference's global padded buckets), so
each package resumes the other's runs, on any mesh shape; ``describe``
reports the modeled peak memory (``core/memory.py``) and the predicted
step time (``core/perf_model.py``); ``profile`` times the step's phases
and ``report`` sets them beside the time model's (``obs/report.py``);
``make_loader`` gives it batches from a hyperslab store
(``data/pipeline.py``). Both
run CosmoFlow (``y``: (N, out_dim) targets) and the 3D U-Net (``y``:
(N, D, H, W) voxel labels; ``evaluate`` returns per-voxel logits).

Over processes (one process a shard, as torchrun starts them): when the
process group is initialized, or torchrun's ``WORLD_SIZE`` > 1, both
modes build a ``launch.mesh.ProcessMesh`` over the world
(``launch/dist.py``), whose size must equal data x spatial, save under a
memory budget (below). Every rank resolves the plan (fixed, pinned,
``plan="auto"`` or budgeted, as in one process) and the ranks agree on
it in one all-gather before any mesh is built. Each rank's
device is ``cuda:LOCAL_RANK``, or ``devices[rank]`` when ``devices=``
lists every rank's (``["cuda:0"] * 2`` for two ranks on one card,
``["cpu"] * n`` in the tests), or ``device=`` for every rank. Every rank
gets the global batch, or its own blocks of it from its per-rank loader
(``make_loader``: each rank reads only its hyperslab), runs its own
shard and returns the same global loss; the initial parameters are
rank 0's, broadcast and checked on every rank; ``save`` is written by
rank 0 while the others wait at a barrier. ZeRO-1 keeps each rank's own chunk of the optimizer state (the
checkpoint gathers the data shards'); a plan whose stages set ``remat``
rematerializes over the ranks. With ``pipeline`` = P the world is P
groups of data x spatial ranks (``launch.mesh.make_pipeline_meshes``):
each rank holds its group's parameters and optimizer state (``params``
and ``opt_state[group]``; the other groups' states None), hands its
boundary activations and cotangents to the same shard of the
neighbouring groups over links of their own, and ``save`` writes every
group's, gathered from each group's shard 0, as the in-process run
does. ``InferenceSession.serve()`` gives rank 0 the harness that takes
the requests and every other rank a follower that runs its shard of
each batch (``serve/harness.py``); ``api.supervisor.run`` runs on every
rank and agrees on each recovery. Under ``memory_budget_gib`` the
world is the device pool the planner may raise the spatial degree over
(as the devices given in one process): the plan's mesh takes the first
``plan.device_count`` ranks, and ``compile`` returns every other rank a
``Released`` session, which holds nothing and joins no collective of
the mesh. The planner's batch-sharded layouts (the spatial group turned
into batch shards by one ``all_to_all``) run over processes as in one.

Entry points run on the card unless the caller says otherwise:
``device="cpu"`` (one shard, as the tests run), or ``devices=[...]`` with
one device per shard of a run over data x spatial > 1 shards —
``["cuda:0"] * 2`` puts both shards on one card, ``["cpu"] * 2`` on the
CPU. With neither, a one-shard run takes the CUDA device and an n-shard
run ``cuda:0..n-1``; without enough cards they raise instead of running
elsewhere.

The plan: ``plan="fixed"`` is the fixed-degree legacy plan,
``plan="auto"`` the cost-model planner's argmin at the config's degrees
(``core/plan.py::plan_convnet``, priced on ``perf_model.H100``), and
``memory_budget_gib`` the planner's choice under that modeled peak a
shard, over spatial degrees up to what the devices given allow (give
more devices than data x spatial shards to let it raise the degree; the
plan's mesh takes the first ones). With ``pipeline`` > 1, ``"fixed"``
is the priced argmin over the boundaries of exactly P groups and M
micro-batches, ``"auto"`` the joint argmin over group counts up to P
(or none).
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
from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.core.tree import key_paths, tree_map
from repro_torch.data import pipeline, store, synthetic
from repro_torch.data import prefetch as prefetch_lib
from repro_torch.core import spmd
from repro_torch.launch import dist as dist_lib
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


def _spatial_options(cfg: ConvNetConfig, config: RunConfig,
                     device_count: int) -> Tuple[int, ...]:
    """Spatial degrees the budgeted planner may raise to: powers of two
    from the configured degree while ``device_count`` (the devices the
    session is given) and layer 0's local width admit them."""
    opts, s = [], max(config.spatial, 1)
    while (config.data * s <= device_count and cfg.input_width % s == 0
           and cfg.input_width // s >= 4):
        opts.append(s)
        s *= 2
    return tuple(opts) or (config.spatial,)


def _pipeline_degree_options(pipeline: int) -> Tuple[int, ...]:
    """The group counts ``plan="auto"`` may pick from: the powers of two
    up to the configured ceiling, and the ceiling."""
    opts = {pipeline} | {2 ** k for k in range(1, pipeline.bit_length())
                         if 2 ** k <= pipeline}
    return tuple(sorted(p for p in opts if p > 1))


def _with_schedule(plan: "plan_lib.ParallelPlan",
                   schedule: str) -> "plan_lib.ParallelPlan":
    """A pipelined plan with its schedule set to ``schedule`` (the
    planner prices 1F1B; a config asking for the sequential oracle keeps
    the same groups)."""
    spec = plan.pipeline
    if spec is None or spec.schedule == schedule:
        return plan
    return dataclasses.replace(
        plan, pipeline=dataclasses.replace(spec, schedule=schedule),
        name=plan.name.replace(f".{spec.schedule}", f".{schedule}"))


def _resolve_plan(config: RunConfig, cfg: ConvNetConfig, grad_comm: str,
                  device_count: int) -> Tuple["plan_lib.ParallelPlan", str]:
    """(plan, precision name) for a validated config: a pinned plan as
    given; with ``pipeline`` > 1 and ``plan="fixed"`` the cheapest
    boundaries for exactly that many groups and micro-batches; under
    ``plan="auto"`` or a memory budget the planner's choice (with
    ``pipeline`` > 1 over group counts up to it too); else the
    fixed-degree legacy plan at the config's degrees. Everything priced
    on ``perf_model.H100`` with ``grad_comm``; a budget searches the
    spatial degrees ``device_count`` devices allow."""
    explicit = None if config.precision == "auto" else config.precision
    if isinstance(config.plan, plan_lib.ParallelPlan):
        return config.plan, explicit or config.plan.precision
    if config.plan == "fixed" and config.pipeline > 1:
        cands = plan_lib.candidate_pipeline_plans(
            cfg, perf_model.H100, pipeline_degrees=(config.pipeline,),
            micro_batch_options=(config.micro_batches,),
            num_devices=config.data, global_batch=config.global_batch,
            grad_comm=grad_comm, schedule=config.pipeline_schedule)
        if not cands:
            raise RunConfigError(
                "pipeline",
                f"no admissible {config.pipeline}-group split of "
                f"{cfg.name} at data={config.data}, micro_batches="
                f"{config.micro_batches}",
                "lower pipeline/micro_batches, or make data a multiple "
                "of pipeline")
        plan = min(cands, key=lambda p: p.cost)
        return plan, explicit or plan.precision
    if config.plan == "auto" or config.memory_budget_gib is not None:
        kw: Dict[str, Any] = dict(
            spatial_degree=config.spatial, data_degree=config.data,
            global_batch=config.global_batch, grad_comm=grad_comm)
        if config.pipeline > 1:
            kw.update(
                pipeline_options=_pipeline_degree_options(config.pipeline),
                micro_batch_options=(config.micro_batches,))
        if config.memory_budget_gib is not None:
            options = _spatial_options(cfg, config, device_count)
            kw.update(memory_budget_bytes=config.memory_budget_gib * 2 ** 30,
                      precisions=(explicit,) if explicit else ("fp32",
                                                               "bf16"),
                      spatial_options=options)
            try:
                plan = plan_lib.plan_convnet(cfg, perf_model.H100, **kw)
            except ValueError as e:
                # the planner attaches the smallest modeled peak of every
                # candidate it priced: the floor the error reports
                mem = getattr(e, "best_infeasible_mem", None)
                if mem is None:
                    raise RunConfigError(
                        "spatial", str(e),
                        "no admissible plan at these degrees; lower "
                        "spatial or give more devices") from e
                raise RunConfigError(
                    "memory_budget_gib",
                    f"{config.memory_budget_gib:.3f} GiB is below every "
                    f"feasible plan",
                    f"raise to at least {mem.total / 2 ** 30:.3f} GiB "
                    f"(the {e.best_infeasible_plan.name} floor over "
                    f"spatial options {list(options)}), give more "
                    f"devices, or allow lower precision") from e
            plan = _with_schedule(plan, config.pipeline_schedule)
            return plan, explicit or plan.precision
        if explicit:
            kw["precisions"] = (explicit,)
        plan = _with_schedule(plan_lib.plan_convnet(cfg, perf_model.H100,
                                                    **kw),
                              config.pipeline_schedule)
        return plan, explicit or plan.precision
    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)),
        (config.spatial, 1, 1), data_degrees=(config.data,))
    return plan, explicit or "fp32"


def _place(config: RunConfig, cfg: ConvNetConfig, device: DeviceLike,
           devices: Optional[Sequence[DeviceLike]], grad_comm: str
           ) -> Tuple["plan_lib.ParallelPlan", str, Tuple[torch.device, ...]]:
    """(plan, precision, one device per shard of the plan) for a config
    validated without a device count: exactly one device per data x
    spatial shard, save that under a memory budget the devices given are
    the pool the planner may raise the spatial degree over (the plan's
    mesh takes the first ones)."""
    shards = config.data * config.spatial
    devs = mesh_lib.mesh_devices(shards, device=device, devices=devices)
    config.validate(device_count=len(devs))
    plan, precision = _resolve_plan(config, cfg, grad_comm, len(devs))
    n = plan.device_count
    if len(devs) == n or (config.memory_budget_gib is not None
                          and len(devs) > n):
        return plan, precision, devs[:n]
    raise RunConfigError(
        "spatial", f"{len(devs)} devices given for data x spatial = "
        f"{shards} shards", "pass one device per shard")


def _agree_on_plan(world: Tuple[int, ...], plan: "plan_lib.ParallelPlan",
                   precision: str) -> None:
    """Every rank of ``world`` resolved the plan on its own: one
    all-gather of (plan name, precision, priced cost) over the world's
    gloo group, and a ``RuntimeError`` where a rank's differs from rank
    0's (the planner's floats are pure Python, so they should agree bit
    for bit; a difference is an error, not a hang)."""
    if len(world) == 1:
        return
    mine = (plan.name, precision, plan.cost)
    rows = dist_lib.group(world, "gloo").gather_objects(mine)
    for r, row in zip(world, rows):
        if row != rows[0]:
            raise RuntimeError(
                f"rank {r} resolved plan {row} but rank {world[0]} "
                f"resolved {rows[0]}: the ranks disagree on the plan")


def _process_mesh(config: RunConfig, cfg: ConvNetConfig, device: DeviceLike,
                  devices: Optional[Sequence[DeviceLike]], grad_comm: str
                  ) -> Tuple["plan_lib.ParallelPlan", str,
                             Optional[Tuple[mesh_lib.Mesh, ...]],
                             Tuple[int, ...]]:
    """(plan, precision, meshes, the ranks that continue) of a run over
    processes: this process's rank of the world (joined here from
    torchrun's environment if it is not yet) resolves the plan (pinned,
    fixed, ``"auto"`` or budgeted), and the ranks agree on it
    (``_agree_on_plan``). Without a budget data x spatial (``data`` the
    total over a pipeline's groups) = the world's size; under a budget
    the world is the device pool the planner may raise the spatial
    degree over (as the devices given in one process), and the plan's
    mesh takes its first ``plan.device_count`` ranks. Each rank on
    ``devices[rank]``, ``device``, or ``cuda:LOCAL_RANK``. ``meshes``:
    the ``ProcessMesh``, or a pipeline's one mesh a group (this
    process's group a ``ProcessMesh``, ``make_pipeline_meshes``), built
    over the continuing ranks alone; None on a released rank (one the
    plan does not use), which joins no collective of the mesh."""
    dist_lib.init()
    world = dist_lib.world()
    budget = config.memory_budget_gib is not None
    shards = config.data * config.spatial
    if shards > len(world) or (shards != len(world) and not budget):
        raise RunConfigError(
            "spatial", f"data x spatial = {shards} shards over a world of "
            f"{len(world)} processes", "make data x spatial equal the "
            "world size: one process a shard (or set memory_budget_gib "
            "to let the planner choose over the world)")
    config.validate(device_count=len(world))
    plan, precision = _resolve_plan(config, cfg, grad_comm, len(world))
    _agree_on_plan(world, plan, precision)
    train_step_lib.check_process_plan(plan, grad_comm)
    n = plan.device_count
    if n > len(world) or (n != len(world) and not budget):
        raise RunConfigError(
            "plan", f"plan {plan.name!r} spans {n} shards over a world of "
            f"{len(world)} processes", "pin a plan of one shard a process")
    if device is not None and devices is not None:
        raise ValueError("give device= or devices=, not both")
    local = None
    if devices is not None:
        if len(devices) != len(world):
            raise RunConfigError(
                "spatial", f"{len(devices)} devices given for a world of "
                f"{len(world)}", "pass one device per rank")
        devices = [mesh_lib.resolve_device(d) for d in devices][:n]
    elif device is not None:
        devices = [mesh_lib.resolve_device(device)] * n
    else:
        local = mesh_lib.resolve_device(f"cuda:{dist_lib.local_rank()}"
                                        if torch.cuda.is_available()
                                        else None)
    ranks = world[:n]
    if torch.distributed.get_rank() not in ranks:
        return plan, precision, None, ranks
    with dist_lib.sub_world(ranks):
        if plan.n_groups > 1:
            meshes = mesh_lib.make_pipeline_meshes(
                plan, devices, processes=True, local_device=local)
        else:
            meshes = (mesh_lib.ProcessMesh(plan.mesh_axes, devices,
                                           local_device=local),)
    home = meshes[train_step_lib.local_groups(meshes)[0]].home
    if home.type == "cuda":
        torch.cuda.set_device(home)
    return plan, precision, meshes, ranks


def _mesh_for(config: RunConfig, cfg: ConvNetConfig, device: DeviceLike,
              devices: Optional[Sequence[DeviceLike]], grad_comm: str
              ) -> Tuple["plan_lib.ParallelPlan", str,
                         Optional[mesh_lib.Mesh], Tuple[int, ...]]:
    """(plan, precision, the plan's mesh, the ranks that continue) of an
    unpipelined run: over processes when the process group is wanted
    (``_process_mesh``; the mesh None on a released rank), else in this
    process over ``_place``'s devices (the ranks then empty)."""
    if dist_lib.wanted():
        plan, precision, meshes, ranks = _process_mesh(
            config, cfg, device, devices, grad_comm)
        return plan, precision, meshes and meshes[0], ranks
    plan, precision, devs = _place(config, cfg, device, devices, grad_comm)
    return plan, precision, mesh_lib.make_plan_mesh(plan, devs), ()


def rank0_params(mesh, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Over processes (a ``ProcessMesh``, or a pipeline's
    ``PipelineWorld``), rank 0's initial ``params`` on every rank; raises
    where a rank's own differ (the seeded initialization should give
    every rank the same bits). An in-process mesh's as they are."""
    names = sorted(params)
    got, same = spmd.from_rank0(mesh, [params[k] for k in names])
    if not same:
        raise RuntimeError(f"rank {mesh.rank}'s initial parameters differ "
                           f"from rank 0's")
    return dict(zip(names, got))


def process_fields(mesh) -> Dict[str, Any]:
    """``describe()``'s ``transport`` and ``process_rank``: a process
    mesh's, else None."""
    if not isinstance(mesh, mesh_lib.ProcessMesh):
        return {}
    world = mesh.pipeline  # a pipeline's: the rank over every group
    return {"transport": mesh.transport,
            "process_rank": mesh.rank if world is None else world.rank}


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
    cfg = config.resolve_model()
    grad_comm = "overlap" if config.grad_comm == "auto" else config.grad_comm
    optimizer = _build_optimizer(config)
    if dist_lib.wanted():
        plan, precision, meshes, ranks = _process_mesh(
            config, cfg, device, devices, grad_comm)
        if meshes is None:
            return Released(config, cfg, plan, precision, grad_comm, ranks)
        mesh = meshes[train_step_lib.local_groups(meshes)[0]]
        params = rank0_params(mesh.pipeline or mesh, for_config(
            cfg).init_params(cfg, torch.Generator().manual_seed(config.seed),
                             mesh.home))
        if mesh.pipeline is None:
            opt_state = train_step_lib.make_convnet_opt_state(
                cfg, optimizer, params, grad_comm=grad_comm, plan=plan,
                mesh=mesh, precision=precision)
            return Session(config, cfg, mesh, plan, precision, grad_comm,
                           optimizer, params, opt_state, mask_source)
        params = {k: params[k] for k in train_step_lib.pipeline_group_names(
            cfg, plan)[mesh.pipeline.group]}
        opt_state = train_step_lib.make_pipeline_opt_state(
            cfg, optimizer, params, plan=plan, meshes=meshes,
            precision=precision)
        return Session(config, cfg, mesh, plan, precision, grad_comm,
                       optimizer, params, opt_state, mask_source,
                       meshes=meshes)
    plan, precision, devs = _place(config, cfg, device, devices, grad_comm)
    if plan.n_groups > 1:
        meshes = mesh_lib.make_pipeline_meshes(plan, devs)
        params = for_config(cfg).init_params(
            cfg, torch.Generator().manual_seed(config.seed),
            meshes[0].devices[0])
        for pg, m in zip(train_step_lib.pipeline_group_params(
                cfg, plan, params), meshes):
            params.update(reshard.to_group(pg, m.devices[0]))
        opt_state = train_step_lib.make_pipeline_opt_state(
            cfg, optimizer, params, plan=plan, meshes=meshes,
            precision=precision)
        return Session(config, cfg, meshes[0], plan, precision, grad_comm,
                       optimizer, params, opt_state, mask_source,
                       meshes=meshes)
    mesh = mesh_lib.make_plan_mesh(plan, devs)
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
        overwritten: ``-1``, ``-2``, ... are appended to the name. Over
        processes each rank writes its own (``trace_lib.rank_path``):
        its spans and its counters."""
        path = path or self._trace_path
        if path is None:
            raise ValueError("no path: pass export_trace(path) or set "
                             "RunConfig(trace='out/trace.json')")
        mesh = getattr(self, "mesh", None)
        if isinstance(mesh, mesh_lib.ProcessMesh):  # one file a rank
            path = trace_lib.rank_path(path, mesh.rank)
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
    reduction mode, the guard's telemetry, the modeled peak memory per
    shard (``core/memory.py``) beside the budget, and the predicted step
    time (``plan.price_plan`` on ``perf_model.H100``: a mesh whose
    shards are on separate cards, not the shards of one card). A
    pipelined plan adds each stage's group, each group's span of the
    device list, the micro-batch count, the schedule and the modeled
    1F1B bubble (all None without a pipeline)."""

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
    predicted_step_s: float
    memory_budget_bytes: Optional[float] = None
    telemetry: Dict[str, float] = dataclasses.field(default_factory=dict)
    stage_groups: Optional[Tuple[int, ...]] = None
    group_devices: Optional[Tuple[Tuple[int, int], ...]] = None
    micro_batches: Optional[int] = None
    pipeline_schedule: Optional[str] = None
    bubble_fraction: Optional[float] = None
    transport: Optional[str] = None
    process_rank: Optional[int] = None
    released: bool = False

    def __str__(self) -> str:
        stages = "; ".join(
            f"[{a},{b}) spatial={[x for x in sp if x]} batch={list(ba)}"
            + (" remat" if rm else "") for a, b, sp, ba, rm in self.stages)
        budget = ("none" if self.memory_budget_bytes is None
                  else f"{self.memory_budget_bytes / 2 ** 30:.2f}GiB")
        pipe = ""
        if self.stage_groups is not None:
            assign = "; ".join(
                f"stage{i}[{a},{b})->group{g} devices[{lo},{hi})"
                for i, ((a, b, _, _, _), g) in enumerate(
                    zip(self.stages, self.stage_groups))
                for lo, hi in [self.group_devices[g]])
            pipe = (
                f"\n  pipeline: {len(self.group_devices)} groups  "
                f"micro_batches={self.micro_batches}  "
                f"schedule={self.pipeline_schedule}  "
                f"bubble={self.bubble_fraction:.1%}\n"
                f"  groups: {assign}")
        procs = ("" if self.transport is None else
                 f" (rank {self.process_rank} of a process mesh over "
                 f"{self.transport})")
        if self.released:
            procs = (f" (rank {self.process_rank} released: the plan's "
                     f"ranks run it)")
        return (
            f"Session[{self.plan_name}] on {self.device}{procs}\n"
            f"  mesh {self.mesh_shape}  precision={self.precision}  "
            f"grad_comm={self.grad_comm}  global_batch={self.global_batch}\n"
            f"  stages: {stages}{pipe}\n"
            f"  params {self.param_count / 1e6:.2f}M  modeled peak/shard "
            f"{self.modeled_peak.describe()}\n"
            f"  budget {budget}  predicted step "
            f"{self.predicted_step_s * 1e3:.2f}ms (perf model, H100, a "
            f"card a shard)"
            + (("\n  guard: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(self.telemetry.items())))
               if self.telemetry else ""))


def _stages(plan: "plan_lib.ParallelPlan") -> tuple:
    """``Report.stages`` of ``plan``."""
    return tuple((s.start, s.stop, tuple(s.spatial_axes),
                  tuple(s.batch_axes), s.remat) for s in plan.stages)


def _plan_figures(config: RunConfig, cfg: ConvNetConfig,
                  plan: "plan_lib.ParallelPlan", precision: str,
                  grad_comm: str, group: Optional[int] = None) -> tuple:
    """(predicted step seconds, modeled peak a shard of ``group``, the
    budget in bytes or None) of a training run of ``plan``: the time
    model's price on ``perf_model.H100`` at ``precision`` and the memory
    model's peak."""
    priced = (plan if plan.precision == precision
              else dataclasses.replace(plan, precision=precision))
    t = plan_lib.price_plan(cfg, perf_model.H100, priced,
                            global_batch=config.global_batch,
                            grad_comm=grad_comm)
    peak = memory_lib.plan_peak_bytes(
        cfg, plan, global_batch=config.global_batch, grad_comm=grad_comm,
        precision=precision, group=group)
    budget = (None if config.memory_budget_gib is None
              else config.memory_budget_gib * 2 ** 30)
    return t, peak, budget


class Released(_Traced):
    """What ``compile`` returns on a rank of a run over processes that the
    plan does not use: under a memory budget the plan's mesh takes the
    world's first ``plan.device_count`` ranks (``ranks``) and releases
    the others. A released rank holds nothing on the card and joins no
    collective of the mesh: ``step``, ``evaluate``, ``predict``,
    ``serve``, ``make_loader``, ``profile``, ``report`` and ``save``
    raise a ``RuntimeError`` naming the ranks that continue;
    ``describe()`` reports the plan they run (its modeled peak a shard
    and predicted step time), marked released."""

    released = True

    def __init__(self, config, cfg, plan, precision, grad_comm, ranks):
        self.config: RunConfig = config
        self.cfg: ConvNetConfig = cfg
        self.plan: plan_lib.ParallelPlan = plan
        self.precision: str = precision_lib.get(precision).name
        self.grad_comm: str = grad_comm
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self.process_rank: int = torch.distributed.get_rank()
        self.mesh = None
        self.params: Dict[str, torch.Tensor] = {}
        self._init_trace(config)

    def _refuse(self, *args, **kwargs):
        raise RuntimeError(
            f"rank {self.process_rank} was released: plan "
            f"{self.plan.name!r} runs on ranks {list(self.ranks)}, and "
            f"this rank holds none of it")

    step = evaluate = predict = serve = make_loader = _refuse
    profile = report = save = _refuse

    def telemetry(self) -> Dict[str, float]:
        return {}

    def describe(self):
        """A ``Report`` (training) or ``InferReport`` (serving) of the
        plan the continuing ranks run, ``released`` set."""
        if self.config.mode == "infer":
            from repro_torch.serve.session import InferReport  # imports us

            return InferReport(
                plan_name=self.plan.name, mesh_shape=dict(self.plan.mesh_axes),
                precision=self.precision,
                param_count=self.cfg.param_count(),
                modeled_peak=memory_lib.infer_peak_bytes(
                    self.cfg, self.plan,
                    global_batch=self.config.global_batch,
                    precision=self.precision),
                device="released", process_rank=self.process_rank,
                released=True)
        t, peak, budget = _plan_figures(self.config, self.cfg, self.plan,
                                        self.precision, self.grad_comm)
        return Report(
            plan_name=self.plan.name, stages=_stages(self.plan),
            mesh_shape=dict(self.plan.mesh_axes), precision=self.precision,
            grad_comm=self.grad_comm, global_batch=self.config.global_batch,
            param_count=self.cfg.param_count(), device="released",
            modeled_peak=peak, predicted_step_s=t,
            memory_budget_bytes=budget, process_rank=self.process_rank,
            released=True)


class Session(_Traced):
    """A training run over a data x spatial mesh on one device. The
    session holds one copy of the fp32 masters and the optimizer state
    (every shard's update is the same); under ZeRO-1 one state a shard
    (a list in rank order; over processes this rank's alone); under a
    pipeline one state a group (a tuple in group order, ``meshes`` the
    groups' meshes, ``mesh`` group 0's; over processes ``mesh`` is this
    rank's group's, ``params`` its group's and the other groups' states
    None).
    Build with ``repro_torch.api.compile(RunConfig(mode="train"))`` or
    ``Session.restore(checkpoint_dir)``, not directly."""

    released = False  # a rank the plan runs on (``Released``: one it does not)

    def __init__(self, config, cfg, mesh, plan, precision, grad_comm,
                 optimizer, params, opt_state, mask_source=None,
                 meshes=None):
        self.config: RunConfig = config
        self.cfg: ConvNetConfig = cfg
        self.mesh: mesh_lib.Mesh = mesh
        self.meshes: Optional[Tuple[mesh_lib.Mesh, ...]] = meshes
        self.plan: plan_lib.ParallelPlan = plan
        self.precision: str = precision_lib.get(precision).name
        self.grad_comm: str = grad_comm
        self.optimizer = optimizer
        self.device: torch.device = mesh.home
        self.params: Dict[str, torch.Tensor] = params
        self.opt_state = opt_state
        self.mask_source = mask_source
        if meshes is not None:
            self._step_fn = train_step_lib.make_pipeline_train_step(
                cfg, meshes, optimizer, plan=plan,
                global_batch=config.global_batch, grad_comm=grad_comm,
                precision=self.precision, guard=config.resolved_guard,
                overlap=config.overlap_halo, mask_source=mask_source)
        else:
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

    def _as_input(self, x):
        """A global batch tensor on the session's device (float64 as
        fp32); a rank's ``Block`` (the per-rank loader's) or None as it
        is."""
        if x is None or isinstance(x, train_step_lib.Block):
            return x
        t = torch.as_tensor(x, device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    def _as_target(self, y):
        """CosmoFlow's targets as ``_as_input``; the U-Net's voxel labels
        as they come (integer classes)."""
        if self.cfg.arch == "unet3d" and not (
                y is None or isinstance(y, train_step_lib.Block)):
            return torch.as_tensor(y, device=self.device)
        return self._as_input(y)

    # ----------------------------------------------------------- train ----
    @property
    def step_count(self) -> int:
        return self._t

    def step(self, batch, y=None, *, agree=None) -> torch.Tensor:
        """One training step on a global batch (an ``(x, y)`` pair, or
        ``step(x, y)``), or over processes on this rank's blocks (the
        per-rank loader's ``RankBatch``); returns the loss (a tensor on
        the device). Parameters, optimizer state and the dropout seed
        (the step count) are threaded inside; the checkpoint policy
        (``save_every``, ``keep_last``) fires here, and so do the fault
        sites ``comm.stall``, ``device.loss`` and ``grads.nonfinite``
        (which poisons the batch, so that the guard must skip the
        update). ``agree`` (the supervisor's, over processes) is called
        after the pre-step sites with the failure one of them raised, or
        None, before any collective of the step: it raises what every
        rank agreed on."""
        if self._closed:
            raise RuntimeError("Session is closed")
        x, y = batch if y is None else (batch, y)
        x, y = self._as_input(x), self._as_target(y)
        sink = self._metrics_sink
        t0 = time.perf_counter() if sink is not None else 0.0
        with trace_lib.span("train.step", step=self._t):
            failure = None
            try:
                faults.fire("comm.stall", step=self._t)
                faults.fire("device.loss", step=self._t)
            except faults.InjectedFault as e:
                if agree is None:
                    raise
                failure = e
            if agree is not None:
                agree(failure)
            if faults.fire("grads.nonfinite", step=self._t) and x is not None:
                # the loss and every gradient
                x = (x.map(lambda t: t * float("nan"))
                     if isinstance(x, train_step_lib.Block)
                     else x * float("nan"))
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
            row = {"step": self._t - 1,
                   "wall_s": time.perf_counter() - t0,
                   "guarded_steps": self._guarded_steps}
            if self._loaders:  # the reference's rule: with a loader only
                row["io_stall_s"] = sum(getattr(ld, "stall_s", 0.0)
                                        for ld in self._loaders)
            sink.write(row)
        if (self.config.checkpoint_dir and self.config.save_every
                and self._t % self.config.save_every == 0):
            if self.config.keep_last is not None:
                held = self._checkpoint()  # on every rank: it may gather
                checkpoint.on_rank0(self._writer, lambda: checkpoint.save_step(
                    self.config.checkpoint_dir,
                    keep_last=self.config.keep_last, **held))
            else:
                self.save()
        return loss

    def evaluate(self, x, y):
        """(loss, predictions) on an eval batch: the forward without
        dropout and the fp32 MSE over its samples (the U-Net: the voxel
        cross-entropy and the per-voxel logits). A pipelined session
        evaluates the whole model on group 0's mesh, data parallel."""
        if self._closed:
            raise RuntimeError("Session is closed")
        gb = int(x.shape[0])
        fn = self._eval_fns.get(gb)
        if fn is None:
            fn = self._eval_fns[gb] = train_step_lib.make_convnet_eval_step(
                self.cfg, self.mesh, global_batch=gb, plan=self.plan,
                overlap=self.config.overlap_halo, precision=self.precision)
        return fn(reshard.to_group(self._full_params(), self.device),
                  self._as_input(x), self._as_target(y))

    @property
    def _pipeline_world(self):
        """A pipeline over processes' ``PipelineWorld`` (else None)."""
        return getattr(self.mesh, "pipeline", None)

    @property
    def _writer(self):
        """Who writes a checkpoint while the others wait: the world of a
        pipeline over processes, else the mesh (``checkpoint.on_rank0``)."""
        return self._pipeline_world or self.mesh

    def _from_group_firsts(self, tree) -> list:
        """Over a pipeline's processes, every group's ``tree`` (this
        rank's group's given here), taken from each group's shard 0 and
        moved to this rank's device, in group order."""
        world = self._pipeline_world
        rows = world.gather_objects(tree_map(lambda t: t.cpu(), tree)
                                    if world.rank % world.d == 0 else None)
        return [tree_map(lambda t: t.to(self.device), rows[g * world.d])
                for g in range(self.plan.n_groups)]

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter: ``params``, or over a pipeline's processes
        every group's gathered onto this rank."""
        if self._pipeline_world is None:
            return self.params
        return {k: v for part in self._from_group_firsts(self.params)
                for k, v in part.items()}

    # ------------------------------------------------------------ data ----
    def make_loader(self, root: Optional[str] = None, *,
                    num_samples: int = 16, seed: int = 0, cache: bool = True,
                    prefetch: Optional[int] = None, halo_voxels: int = 0):
        """A loader of batches for ``step``, each mesh rank's block of the
        plan's entry stage read on its own (``data/pipeline.py``): global
        batches in one process; over processes this rank's blocks alone
        (a ``RankBatch``: a pipeline's entry group reads x, its loss
        group y, each rank its slice of every micro-batch). ``root`` (or
        ``config.data_dir``) names an existing ``HyperslabStore``; with
        neither, a synthetic dataset of ``num_samples`` volumes (the
        model's: cosmology cubes and targets, or segmentation volumes and
        voxel labels) is written to a directory the Session owns, which
        ``close()`` removes (over processes rank 0 writes it and owns it;
        the exchange of its path after the write is every rank's
        barrier).

        ``prefetch`` (default ``config.prefetch``): 0 returns the
        synchronous ``SpatialParallelLoader`` (the bitwise oracle); >= 1
        wraps it in a ``PrefetchLoader`` of that queue depth, whose worker
        reads the next batch and enqueues its copies while the current
        step computes. ``halo_voxels`` widens each rank's reads by that
        margin."""
        procs = isinstance(self.mesh, mesh_lib.ProcessMesh)
        world = (self._pipeline_world or self.mesh.world) if procs else None
        root = root or self.config.data_dir
        if root is None:
            if not procs or (self._pipeline_world or self.mesh).rank == 0:
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
            if procs:  # rank 0's path, once it is written
                root = world.gather_objects(root)[0]
        micro, reads = 1, ("x", "y")
        pipe = self._pipeline_world
        if pipe is not None:  # what this rank's group takes
            micro = self.plan.pipeline.micro_batches
            takes = {"x": 0, "y": train_step_lib.pipeline_loss_group(
                self.cfg, self.plan)}
            reads = tuple(k for k, g in takes.items() if g == pipe.group)
        loader = pipeline.SpatialParallelLoader(
            store.HyperslabStore(root), self.mesh, self.plan.stages[0],
            global_batch=self.config.global_batch, seed=seed, cache=cache,
            halo_voxels=halo_voxels, micro_batches=micro, reads=reads)
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
        """The plan, the modeled peak a shard (``core/memory.py``), the
        budget, and the predicted step time: ``plan.price_plan`` on
        ``perf_model.H100``, which prices the plan's mesh with every
        shard on a card of its own (here they may share one)."""
        world = self._pipeline_world
        t, peak, budget = _plan_figures(
            self.config, self.cfg, self.plan, self.precision, self.grad_comm,
            group=None if world is None else world.group)
        pipe: Dict[str, Any] = {}
        if self.plan.n_groups > 1:
            spec, d = self.plan.pipeline, self.plan.data_degree
            pipe = dict(
                stage_groups=tuple(spec.stage_groups),
                group_devices=tuple((g * d, (g + 1) * d)
                                    for g in range(self.plan.n_groups)),
                micro_batches=spec.micro_batches,
                pipeline_schedule=spec.schedule,
                bubble_fraction=spec.bubble_fraction)
        return Report(
            plan_name=self.plan.name, stages=_stages(self.plan),
            mesh_shape=self.mesh.shape, precision=self.precision,
            grad_comm=self.grad_comm,
            global_batch=self.config.global_batch,
            param_count=self.cfg.param_count(), device=str(self.device),
            telemetry=self.telemetry(), modeled_peak=peak,
            predicted_step_s=t, memory_budget_bytes=budget,
            **process_fields(self.mesh), **pipe)

    def profile(self, batch=None, reps: int = 3) -> Dict[str, float]:
        """Measured phases: seconds of the ``fwd``, ``bwd``, ``grad_comm``
        and ``step`` probes (the train step's cumulative prefixes, the
        last without the guard), each a mean of ``reps`` after one call
        that builds what it needs, and their differences ``backward``,
        ``comm`` and ``optimizer``, plus the telemetry. Each rep is a
        ``probe.<phase>`` span that ends after the device has finished it.
        ``batch=None`` profiles a synthetic batch. The session's
        parameters and state are not changed.

        A pipelined session's phases interleave across its groups, so it
        times the whole step instead: under the plan's schedule
        (``step``), under the sequential oracle (``step_sequential``),
        and their ratio ``pipeline_speedup``."""
        if self._closed:
            raise RuntimeError("Session is closed")
        x, y = batch if batch is not None else self._synthetic_batch()
        x, y = self._as_input(x), self._as_target(y)
        if self.meshes is not None:
            probes = {label: train_step_lib.make_pipeline_train_step(
                self.cfg, self.meshes, self.optimizer, plan=self.plan,
                global_batch=self.config.global_batch,
                grad_comm=self.grad_comm, precision=self.precision,
                schedule=sched, overlap=self.config.overlap_halo,
                mask_source=self.mask_source)
                for label, sched in (("step", None),
                                     ("step_sequential", "sequential"))}
        else:
            probes = train_step_lib.make_convnet_phase_probes(
                self.cfg, self.mesh, self.optimizer,
                global_batch=self.config.global_batch, plan=self.plan,
                overlap=self.config.overlap_halo, grad_comm=self.grad_comm,
                precision=self.precision, mask_source=self.mask_source)
        out: Dict[str, float] = {}
        for stage, fn in probes.items():
            fn(self.params, self.opt_state, x, y, 0)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                with trace_lib.span(f"probe.{stage}"):
                    fn(self.params, self.opt_state, x, y, 0)
                    self._sync()
            out[stage] = (time.perf_counter() - t0) / reps
        if self.meshes is not None:
            out["pipeline_speedup"] = (out["step_sequential"] / out["step"]
                                       if out["step"] else 0.0)
        else:
            out["backward"] = max(out["bwd"] - out["fwd"], 0.0)
            out["comm"] = max(out["grad_comm"] - out["bwd"], 0.0)
            out["optimizer"] = max(out["step"] - out["grad_comm"], 0.0)
        for key, v in self.telemetry().items():
            out[f"telemetry.{key}"] = v
        return out

    def report(self, batch=None, reps: int = 2, flag_ratio: float = 2.0):
        """The drift table (``obs/report.py``): the time model's seconds
        a phase on ``perf_model.H100`` (a card a shard) beside the
        measured span aggregates, each ratio flagged when off by more
        than ``flag_ratio`` either way. The phase probes run under this
        session's tracer unless their ``probe.*`` spans are there
        already, and two batches are loaded for the ``io`` row unless a
        loader's spans are; the table reads ``tracer.span_seconds()``.
        An untraced session's tracer is active only during the call."""
        from repro_torch.obs import report as drift_lib

        prev = trace_lib.active()
        trace_lib.enable(self.tracer)
        try:
            have = self.tracer.span_seconds()
            probes = (("step",) if self.meshes is not None
                      else train_step_lib.STAGES)
            if not all(f"probe.{p}" in have for p in probes):
                self.profile(batch, reps=reps)
            have = self.tracer.span_seconds()
            if "io.load" not in have and "io.load.sync" not in have:
                self._drive_io_sample()
        finally:
            if prev is not None and prev is not self.tracer:
                trace_lib.enable(prev)
            elif not self.config.trace:
                trace_lib.disable(self.tracer)
        modeled = drift_lib.modeled_phases(
            self.cfg, perf_model.H100, self.plan,
            global_batch=self.config.global_batch,
            grad_comm=self.grad_comm, precision=self.precision)
        measured = drift_lib.measured_phases(self.tracer)
        return drift_lib.drift(modeled, measured, flag_ratio=flag_ratio)

    def _drive_io_sample(self, batches: int = 2) -> None:
        """Load a couple of batches through the newest loader (a
        synthetic one if there is none) so the drift table's ``io`` row
        has spans."""
        gb = self.config.global_batch
        loader = (self._loaders[-1] if self._loaders
                  else self.make_loader(num_samples=max(gb, 4)))
        order = loader.schedule_for_epoch(0)
        n = max(len(order) // gb, 1)
        for b in range(min(batches, n)):
            loader.load_batch(order[b * gb:(b + 1) * gb])
        self._sync()

    def _synthetic_batch(self):
        """A seeded batch on the session's device: normal volumes, and
        normal targets (CosmoFlow) or uniform voxel labels (the U-Net)."""
        w, gb = self.cfg.input_width, self.config.global_batch
        g = torch.Generator(device=self.device).manual_seed(
            self.config.seed + 1)
        x = torch.randn((gb, w, w, w, self.cfg.in_channels), generator=g,
                        device=self.device)
        if self.cfg.arch == "cosmoflow":
            y = torch.randn((gb, self.cfg.out_dim), generator=g,
                            device=self.device)
        else:
            y = torch.randint(0, self.cfg.out_dim, (gb, w, w, w), generator=g,
                              device=self.device, dtype=torch.int32)
        return x, y

    def _sync(self) -> None:
        """Wait for every card of the mesh (of every group's) that this
        process drives."""
        for d in {d for m in (self.meshes or (self.mesh,))
                  for d in m.local_devices}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

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
        held = self._checkpoint()  # on every rank: it may gather
        checkpoint.on_rank0(self._writer,
                            lambda: checkpoint.save(path, **held))
        return path

    def _checkpoint(self) -> Dict[str, Any]:
        """What a checkpoint taken now holds, as ``checkpoint.save``'s
        keywords (the same on every rank: over processes, ZeRO-1's chunks
        and a pipeline's groups are gathered here, so every rank calls
        it)."""
        meta = {"run_config": self._pinned_config().to_json()}
        params, opt, specs = self.params, self.opt_state, None
        if self.grad_comm == "reduce_scatter":
            # the reference's layout: global padded buckets, dim 0 sharded
            # over the data axes, scalars replicated
            states = spmd.all_shard_trees(self.mesh, self.opt_state)
            opt = grad_comm_lib.global_opt_state(
                [states[r] for r in train_step_lib.data_shards(
                    self.mesh, self.plan.stages[0])])
            axes = list(self.plan.stages[0].batch_axes)
            specs = {path: [axes] if leaf.dim() else []
                     for path, leaf in key_paths({"opt": opt})}
        elif self._pipeline_world is not None:
            g = self._pipeline_world.group
            parts = self._from_group_firsts((self.params, self.opt_state[g]))
            params = {k: v for p, _ in parts for k, v in p.items()}
            opt = tuple(o for _, o in parts)
        return {"tree": {"params": params, "opt": opt},
                "step": self._t, "precision": self.precision,
                "extra_files": {_META_FILE: meta}, "specs": specs}

    def _pinned_config(self) -> RunConfig:
        """The config with every ``"auto"`` resolved: the concrete model,
        the plan, precision, reduction mode and degrees (``data`` the
        total over a pipeline's groups, with its micro-batches and
        schedule)."""
        pipe: Dict[str, Any] = {}
        if self.plan.n_groups > 1:
            pipe = dict(micro_batches=self.plan.pipeline.micro_batches,
                        pipeline_schedule=self.plan.pipeline.schedule)
        return dataclasses.replace(
            self.config, model=self.cfg, plan=self.plan,
            precision=self.precision, grad_comm=self.grad_comm,
            data=self.plan.data_degree * self.plan.n_groups,
            spatial=self.plan.spatial_degree,
            pipeline=self.plan.n_groups, **pipe)

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
        if sess.released:
            return sess
        model = for_config(sess.cfg)
        zero1 = sess.grad_comm == "reduce_scatter"
        tree = checkpoint.restore(path, {
            "params": sess.params,
            "opt": sess.opt_state[0] if zero1 else sess.opt_state})
        world = sess._pipeline_world
        if world is not None:  # this rank's group's part alone
            shapes = model.param_shapes(sess.cfg)
            mine = {k: shapes[k] for k in sess.params}
            sess.params = cosmoflow_lib.checked_tree(
                tree["params"], mine, sess.device, torch.float32,
                sess.cfg.name)
            sess.opt_state = tuple(
                None if s is None else cosmoflow_lib.opt_state_from_numpy(
                    s, sess.device, cfg=sess.cfg, shapes=mine)
                for s in tree["opt"])
            sess._t = checkpoint.latest_step(path)
            return sess
        sess.params = model.params_from_numpy(
            tree["params"], sess.device, torch.float32, cfg=sess.cfg)
        if sess.meshes is not None:  # each group's on its device
            for pg, m in zip(train_step_lib.pipeline_group_params(
                    sess.cfg, sess.plan, sess.params), sess.meshes):
                sess.params.update(reshard.to_group(pg, m.devices[0]))
        if zero1:  # each shard's chunk of the global buckets, anew
            buckets = train_step_lib.convnet_grad_plan(sess.cfg)
            n = train_step_lib.data_degree(sess.plan)
            sess.opt_state = [grad_comm_lib.local_opt_state(
                tree["opt"], buckets, train_step_lib.batch_slice(
                    sess.mesh, r, sess.plan.stages[0])[0], n, sess.device)
                for r in sess.mesh.local_ranks]
        else:
            sess.opt_state = model.opt_state_from_numpy(
                tree["opt"], [m.devices[0] for m in sess.meshes]
                if sess.meshes is not None else sess.device, cfg=sess.cfg)
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


__all__ = ["Released", "Report", "Session", "compile"]
