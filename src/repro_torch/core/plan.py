"""Per-stage parallelism plans and the cost-model planner (the
reference's ``core/plan.py``).

A ``ParallelPlan`` is an ordered list of ``Stage``s, each naming the
mesh axes that shard the batch and the D/H/W dims for a contiguous
range of layers (cosmoflow: layers ``0..n_blocks-1`` are the conv
blocks, layer ``n_blocks`` the FC head; the U-Net: layers
``0..depth-1`` are the resolution levels, layer ``depth`` the
bottleneck, each decoder level running its encoder level's stage). The
dataclasses, their names and their JSON (``api/config.py``) are the
reference's, so a plan pinned in a reference checkpoint reads back.
``legacy_convnet_plan`` builds the fixed-degree plan
``RunConfig(plan="fixed")`` resolves to: for CosmoFlow, depth
partitioned over ``spatial`` shards until a block's local width would
drop below 4, then gathered; for the U-Net, one spatial stage over
every level. ``convnet_plan`` builds a one-transition plan: the spatial
group partitions the volume up to a boundary and then either turns into
extra batch shards (``kind="batch"``, an ``all_to_all``,
``core/reshard.py``) or gathers the volume and runs replicated
(``"replicated"``). ``pipelined_convnet_plan`` builds a pipelined plan:
the layers cut into contiguous groups, each a pure data-parallel mesh
of its own devices (``PipelineSpec``; trained by
``train_step.make_pipeline_train_step``).

The planner (``plan_convnet``) prices every admissible boundary and
kind with ``perf_model.iteration_time`` over the plan's per-layer
layout (``plan_schedule``) and returns the argmin; under a memory
budget it searches transition x kind x remat x precision x spatial
degree subject to ``core/memory.py``'s modeled peak. The arithmetic,
the candidate order and the tie-breaks are the reference's, so that on
the same ``Hardware`` both pick the same plan. ``pipeline_options``
adds pipelined candidates (``candidate_pipeline_plans``, priced by
``perf_model.pipeline_iteration_time``) to the same argmin; ties go to
the plan without a pipeline.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import flags, perf_model
from repro_torch.core import precision as precision_lib
from repro_torch.core.spatial_conv import SpatialPartitioning

AxesT = Tuple[Optional[str], Optional[str], Optional[str]]
PIPELINE_SCHEDULES = ("1f1b", "sequential")


@dataclasses.dataclass(frozen=True)
class Stage:
    """Layout of one contiguous layer range: which mesh axes shard the
    batch dim and the D/H/W dims. ``remat`` marks the stage's conv blocks
    for rematerialization in training."""

    start: int
    stop: int  # one past the last layer this stage covers
    spatial_axes: AxesT = (None, None, None)
    batch_axes: Tuple[str, ...] = ("data",)
    remat: bool = False

    @property
    def part(self) -> SpatialPartitioning:
        return SpatialPartitioning(tuple(self.spatial_axes))

    @property
    def spatial_names(self) -> Tuple[str, ...]:
        return self.part.names


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Stage -> device-group assignment plus the micro-batch schedule of
    a pipelined training plan: ``stage_groups[i]`` is the group running
    stage ``i`` (groups are disjoint, equal slices of the devices, each a
    data-parallel mesh); ``schedule`` is ``"1f1b"`` or the blocking
    ``"sequential"`` oracle, both over ``micro_batches`` micro-batches
    with the same arithmetic."""

    stage_groups: Tuple[int, ...]
    micro_batches: int = 4
    schedule: str = "1f1b"

    def __post_init__(self):
        gs = tuple(int(g) for g in self.stage_groups)
        if not gs or gs[0] != 0 or any(
                b not in (a, a + 1) for a, b in zip(gs, gs[1:])):
            raise ValueError(
                f"stage_groups={self.stage_groups}: must start at 0 and "
                f"step by 0 or 1 (contiguous stages per group)")
        if self.micro_batches < 1:
            raise ValueError(
                f"micro_batches={self.micro_batches}: must be >= 1")
        if self.schedule not in PIPELINE_SCHEDULES:
            raise ValueError(
                f"schedule={self.schedule!r}: expected one of "
                f"{PIPELINE_SCHEDULES}")

    @property
    def n_groups(self) -> int:
        return self.stage_groups[-1] + 1

    @property
    def bubble_fraction(self) -> float:
        """The idle share of 1F1B's fill and drain, ``(P-1)/(M+P-1)``."""
        p, m = self.n_groups, self.micro_batches
        return (p - 1) / (m + p - 1)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Ordered stages covering layers ``[0, n_layers)`` plus the mesh-axis
    degrees they reference. ``precision`` is the policy the plan was
    priced for; ``pipeline`` maps stages onto device groups, and the
    ``mesh_axes`` degrees are then those of each group."""

    stages: Tuple[Stage, ...]
    mesh_axes: Tuple[Tuple[str, int], ...]  # (axis name, degree)
    n_layers: int
    name: str = ""
    cost: Optional[float] = None
    precision: str = "fp32"
    pipeline: Optional[PipelineSpec] = None

    def __post_init__(self):
        pos = 0
        for st in self.stages:
            if st.start != pos or st.stop <= st.start:
                raise ValueError(
                    f"plan {self.name!r}: stages must tile [0, n_layers) "
                    f"contiguously; got {self.stages}")
            pos = st.stop
        if pos != self.n_layers:
            raise ValueError(
                f"plan {self.name!r}: stages cover [0, {pos}) but "
                f"n_layers={self.n_layers}")
        known = {a for a, _ in self.mesh_axes}
        used = {a for st in self.stages
                for a in tuple(st.batch_axes) + st.spatial_names}
        if not used <= known:
            raise ValueError(
                f"plan {self.name!r}: stages reference axes "
                f"{sorted(used - known)} missing from mesh_axes")
        if self.pipeline is not None:
            if len(self.pipeline.stage_groups) != len(self.stages):
                raise ValueError(
                    f"plan {self.name!r}: pipeline maps "
                    f"{len(self.pipeline.stage_groups)} stages but the "
                    f"plan has {len(self.stages)}")
            if self.pipeline.n_groups > 1 and self.spatial_axis_names:
                raise ValueError(
                    f"plan {self.name!r}: pipelined plans shard only the "
                    f"batch within each device group; drop the spatial "
                    f"axes or the pipeline")

    def stage_for(self, layer: int) -> Stage:
        for st in self.stages:
            if st.start <= layer < st.stop:
                return st
        raise IndexError(f"layer {layer} outside plan [0, {self.n_layers})")

    def degree(self, axis: str) -> int:
        for a, n in self.mesh_axes:
            if a == axis:
                return n
        raise KeyError(axis)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """Every mesh axis any stage references (batch first, then
        spatial, first-use order) — the reduction axes of the BN
        statistics."""
        out: List[str] = []
        for st in self.stages:
            for a in tuple(st.batch_axes) + st.spatial_names:
                if a not in out:
                    out.append(a)
        return tuple(out)

    @property
    def spatial_axis_names(self) -> Tuple[str, ...]:
        out: List[str] = []
        for st in self.stages:
            for a in st.spatial_names:
                if a not in out:
                    out.append(a)
        return tuple(out)

    @property
    def batch_extension_axes(self) -> Tuple[str, ...]:
        """Axes moved from spatial to batch, in transition order: the
        order in which targets are sliced to follow the activations
        (``reshard.shard_batch``)."""
        base = set(self.stages[0].batch_axes)
        out: List[str] = []
        for st in self.stages[1:]:
            for a in st.batch_axes:
                if a not in base and a not in out:
                    out.append(a)
        return tuple(out)

    @property
    def data_degree(self) -> int:
        """Product of the entry stage's batch-axis degrees."""
        d = 1
        for a in self.stages[0].batch_axes:
            d *= self.degree(a)
        return d

    @property
    def spatial_degree(self) -> int:
        """Product of every spatial axis degree any stage references."""
        d = 1
        for a in self.spatial_axis_names:
            d *= self.degree(a)
        return d

    @property
    def final_stage(self) -> Stage:
        return self.stages[-1]

    @property
    def loss_redundancy(self) -> int:
        """How many shards compute each sample's loss at the final stage:
        the product of the degrees of the spatial axes that are neither
        spatial nor batch axes there (the legacy plan's gathered FC head
        runs on every shard of the spatial group). A shard's loss is
        divided by it, so that the sum over every shard is the global
        loss and its gradients are right."""
        final = self.final_stage
        live = set(final.batch_axes) | set(final.spatial_names)
        r = 1
        for a in self.spatial_axis_names:
            if a not in live:
                r *= self.degree(a)
        return r

    @property
    def n_groups(self) -> int:
        """Pipeline device groups (1 without a pipeline)."""
        return self.pipeline.n_groups if self.pipeline is not None else 1

    def group_for(self, layer: int) -> int:
        """The device group running ``layer`` (0 without a pipeline)."""
        if self.pipeline is None:
            self.stage_for(layer)  # the range check
            return 0
        for st, g in zip(self.stages, self.pipeline.stage_groups):
            if st.start <= layer < st.stop:
                return g
        raise IndexError(f"layer {layer} outside plan [0, {self.n_layers})")

    def group_layer_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Each group's ``(start, stop)`` layer range, in group order: the
        segment whose parameters and compute the group owns."""
        if self.pipeline is None:
            return ((0, self.n_layers),)
        lo: dict = {}
        hi: dict = {}
        for st, g in zip(self.stages, self.pipeline.stage_groups):
            lo.setdefault(g, st.start)
            hi[g] = st.stop
        return tuple((lo[g], hi[g]) for g in range(self.pipeline.n_groups))

    @property
    def device_count(self) -> int:
        """Devices the plan spans: every mesh degree times the groups."""
        d = self.n_groups
        for _, n in self.mesh_axes:
            d *= n
        return d

    @property
    def uses_remat(self) -> bool:
        """Whether any stage asks for rematerialization. When False, the
        models fall back to ``core/flags.REMAT`` for every conv block;
        when True, each stage's own choice wins outright."""
        return any(st.remat for st in self.stages)


def stage_remat(plan: ParallelPlan, stage: Stage) -> bool:
    """Whether ``stage``'s conv blocks are rematerialized: the stage's
    own ``remat`` when ``plan`` marks any stage, else ``flags.REMAT``
    (the reference's rule)."""
    return stage.remat if plan.uses_remat else flags.REMAT


def cosmoflow_n_layers(cfg: ConvNetConfig) -> int:
    return len(cfg.conv_channels) + 1  # conv blocks + the FC head


def unet_n_layers(cfg: ConvNetConfig) -> int:
    return cfg.depth + 1  # resolution levels + the bottleneck


def _axes_pairs(axes: Sequence[str], degrees: Sequence[int]):
    return tuple(zip(tuple(axes), tuple(int(d) for d in degrees)))


def convnet_plan(
    cfg: ConvNetConfig,
    *,
    boundary: Optional[int] = None,
    kind: str = "batch",
    spatial_axes: AxesT = ("model", None, None),
    spatial_degrees: Tuple[int, ...] = (1, 1, 1),
    data_axes: Tuple[str, ...] = ("data",),
    data_degrees: Tuple[int, ...] = (1,),
    cost: Optional[float] = None,
) -> ParallelPlan:
    """A one-transition plan: layers ``[0, boundary)`` spatially
    partitioned, layers ``[boundary, n)`` not, the spatial group either
    turned into batch shards (``kind="batch"``) or gathered and
    replicated (``"replicated"``). ``boundary=None`` (or ``n``) keeps the
    spatial layout through the last conv layer; CosmoFlow's FC head then
    still transitions by ``kind`` (the reference's uniform plan is
    ``boundary=None, kind="replicated"``). Named as the reference names
    it."""
    if kind not in ("batch", "replicated"):
        raise ValueError(f"kind={kind!r}; expected 'batch' or 'replicated'")
    n = (cosmoflow_n_layers(cfg) if cfg.arch == "cosmoflow"
         else unet_n_layers(cfg))
    b = n if boundary is None else boundary
    if cfg.arch == "cosmoflow":
        b = min(b, n - 1)  # the FC head is never spatial
    if not 1 <= b <= n:
        raise ValueError(f"boundary={boundary} outside [1, {n}]")
    moved = tuple(a for a in spatial_axes if a) if kind == "batch" else ()
    stages = [Stage(0, b, tuple(spatial_axes), tuple(data_axes))]
    if b < n:
        stages.append(Stage(b, n, (None, None, None),
                            tuple(data_axes) + moved))
    mesh_axes = _axes_pairs(data_axes, data_degrees) + tuple(
        (a, d) for a, d in zip(spatial_axes, spatial_degrees) if a)
    if len(stages) == 1:
        name = f"{cfg.arch}.uniform"  # one stage: no kind
    else:
        label = ("uniform" if cfg.arch == "cosmoflow" and b == n - 1
                 else f"b{b}")
        name = f"{cfg.arch}.{label}.{kind}"
    return ParallelPlan(tuple(stages), mesh_axes, n, name=name, cost=cost)


def uniform_plan(
    cfg: ConvNetConfig,
    *,
    spatial_axes: AxesT = ("model", None, None),
    spatial_degrees: Tuple[int, ...] = (1, 1, 1),
    data_axes: Tuple[str, ...] = ("data",),
    data_degrees: Tuple[int, ...] = (1,),
) -> ParallelPlan:
    """The reference's one-stage plan: the spatial layout through the
    last conv layer, then, for CosmoFlow, the FC head replicated (the
    equivalence oracle of its memory tests)."""
    return convnet_plan(cfg, boundary=None, kind="replicated",
                        spatial_axes=spatial_axes,
                        spatial_degrees=spatial_degrees,
                        data_axes=data_axes, data_degrees=data_degrees)


def pipelined_convnet_plan(
    cfg: ConvNetConfig,
    *,
    boundaries: Sequence[int],
    micro_batches: int = 4,
    schedule: str = "1f1b",
    data_axes: Tuple[str, ...] = ("data",),
    data_degrees: Tuple[int, ...] = (1,),
    cost: Optional[float] = None,
) -> ParallelPlan:
    """A pipelined plan: ``len(boundaries) + 1`` device groups, group
    ``g`` owning the layers between consecutive cuts, each stage pure
    data parallel within its group (``data_degrees`` per group).
    ``schedule`` is the 1F1B lowering or the blocking sequential oracle.
    Named as the reference names it."""
    n = (cosmoflow_n_layers(cfg) if cfg.arch == "cosmoflow"
         else unet_n_layers(cfg))
    cuts = tuple(sorted(int(b) for b in boundaries))
    if any(b2 <= b1 for b1, b2 in zip(cuts, cuts[1:])) or any(
            not 0 < b < n for b in cuts):
        raise ValueError(
            f"boundaries={boundaries}: need strictly increasing cuts "
            f"inside (0, {n})")
    edges = (0,) + cuts + (n,)
    stages = tuple(Stage(a, b, (None, None, None), tuple(data_axes))
                   for a, b in zip(edges, edges[1:]))
    spec = PipelineSpec(tuple(range(len(stages))), micro_batches, schedule)
    name = (f"{cfg.arch}.pipe{len(stages)}"
            f"@{'-'.join(str(b) for b in cuts)}"
            f".m{micro_batches}.{schedule}")
    return ParallelPlan(stages, _axes_pairs(data_axes, data_degrees), n,
                        name=name, cost=cost, pipeline=spec)


def plan_remat_schedule(cfg: ConvNetConfig,
                        plan: ParallelPlan) -> List[bool]:
    """Per-layer remat flags, in the order of the reference's per-layer
    schedule: CosmoFlow's conv blocks, then its FC head; the U-Net's two
    convs per encoder level, the bottleneck's two, then per decoder
    level its up-convolution and two convs. A conv layer's flag is its
    stage's ``stage_remat`` (the rule the models checkpoint by, the
    ``flags.REMAT`` fallback included); the FC head and the
    up-convolutions are never rematerialized (the models do not
    checkpoint them)."""

    def rm(layer: int) -> bool:
        return stage_remat(plan, plan.stage_for(layer))

    if cfg.arch == "cosmoflow":
        return [rm(i) for i in range(len(cfg.conv_channels))] + [False]
    sched: List[bool] = []
    for lvl in range(cfg.depth):
        sched += [rm(lvl)] * 2
    sched += [rm(cfg.depth)] * 2
    for lvl in reversed(range(cfg.depth)):
        sched += [False] + [rm(lvl)] * 2
    return sched


def legacy_convnet_plan(
    cfg: ConvNetConfig,
    part: SpatialPartitioning,
    spatial_shards: Sequence[int] = (1, 1, 1),
    *,
    data_axes: Tuple[str, ...] = ("data",),
    data_degrees: Tuple[int, ...] = (1,),
    min_local_width: int = 4,
) -> ParallelPlan:
    """The fixed-degree plan: spatial layout everywhere, a replicated
    gather for any dim whose static local width drops below
    ``min_local_width``, and the replicated FC head — stage for stage the
    reference's, so the plan (and its name, ``cosmoflow.legacy``)
    serializes identically. The U-Net's is one stage over every level
    and the bottleneck, never gathered (``unet3d.legacy``)."""
    axes = list(part.axes)
    shards = tuple(int(s) for s in spatial_shards)
    mesh_axes = _axes_pairs(data_axes, data_degrees) + tuple(
        (a, s) for a, s in zip(axes, shards) if a)
    if cfg.arch != "cosmoflow":
        n = unet_n_layers(cfg)
        return ParallelPlan((Stage(0, n, tuple(axes), tuple(data_axes)),),
                            mesh_axes, n, name="unet3d.legacy")
    layers = perf_model.cosmoflow_layers(cfg)
    n_blocks = len(layers)
    stages: List[Stage] = []
    start = 0
    cur: Optional[AxesT] = None
    for i, layer in enumerate(layers):
        for d, ax in enumerate(axes):
            if ax is not None and layer.width // shards[d] < min_local_width:
                axes[d] = None
        if cur is None:
            cur = tuple(axes)
        elif tuple(axes) != cur:
            stages.append(Stage(start, i, cur, tuple(data_axes)))
            start, cur = i, tuple(axes)
    stages.append(Stage(start, n_blocks, cur, tuple(data_axes)))
    stages.append(Stage(n_blocks, n_blocks + 1, (None, None, None),
                        tuple(data_axes)))
    return ParallelPlan(tuple(stages), mesh_axes, n_blocks + 1,
                        name="cosmoflow.legacy")


# ------------------------------------------------------------- planner ----
def plan_schedule(cfg: ConvNetConfig, plan: ParallelPlan) -> List[str]:
    """The per-layer layout ``perf_model.iteration_time`` prices:
    CosmoFlow's conv layers and one trailing FC entry; the U-Net's
    encoder, bottleneck and decoder convs mapped to their levels (a
    decoder level's up-convolution runs in the level below's layout, so
    the ascent's reshards are priced too)."""

    def mode(layer: int) -> str:
        st = plan.stage_for(layer)
        if st.spatial_names:
            return "spatial"
        return "batch" if set(st.batch_axes) > set(
            plan.stages[0].batch_axes) else "replicated"

    if cfg.arch == "cosmoflow":
        return [mode(i) for i in range(len(cfg.conv_channels) + 1)]
    sched: List[str] = []
    for lvl in range(cfg.depth):          # encoder: 2 convs a level
        sched += [mode(lvl)] * 2
    sched += [mode(cfg.depth)] * 2        # bottleneck
    for lvl in reversed(range(cfg.depth)):  # decoder: deconv + 2 convs
        sched += [mode(lvl + 1)] + [mode(lvl)] * 2
    return sched


def price_plan(cfg: ConvNetConfig, hw: "perf_model.Hardware",
               plan: ParallelPlan, *, global_batch: int,
               overlap: bool = True, grad_comm: str = "overlap") -> float:
    """The predicted seconds of a training iteration under ``plan``
    (``plan_schedule``'s layout, its remat recompute and its precision's
    activation width), on the mesh the plan records, its shards on
    separate accelerators of ``hw``. A pipelined plan is priced by
    ``perf_model.pipeline_iteration_time`` (the bubble against the
    transfers)."""
    if plan.pipeline is not None and plan.pipeline.n_groups > 1:
        pol = precision_lib.get(plan.precision)
        return perf_model.pipeline_iteration_time(
            cfg, hw, group_ranges=plan.group_layer_ranges(),
            data_degree=plan.data_degree,
            micro_batches=plan.pipeline.micro_batches,
            schedule=plan.pipeline.schedule, global_batch=global_batch,
            grad_comm=grad_comm,
            act_bytes=None if pol.act_bytes == 4 else pol.act_bytes)["total"]
    ways = 1
    for a in plan.spatial_axis_names:
        ways *= plan.degree(a)
    data = 1
    for a in plan.stages[0].batch_axes:
        data *= plan.degree(a)
    pol = precision_lib.get(plan.precision)
    act_bytes = None if pol.act_bytes == 4 else pol.act_bytes
    r = perf_model.iteration_time(
        cfg, hw, num_gpus=max(ways, 1) * data, ways=max(ways, 1),
        global_batch=global_batch, overlap=overlap, grad_comm=grad_comm,
        schedule=plan_schedule(cfg, plan),
        remat_schedule=plan_remat_schedule(cfg, plan),
        act_bytes=act_bytes)
    return r["total"]


def remat_variants(cfg: ConvNetConfig,
                   plan: ParallelPlan) -> List[ParallelPlan]:
    """Every per-stage remat assignment of ``plan``, the no-remat one
    first; a stage holding only CosmoFlow's FC head is never marked."""
    n_conv = plan.n_layers - (1 if cfg.arch == "cosmoflow" else 0)
    idxs = [i for i, st in enumerate(plan.stages) if st.start < n_conv]
    out: List[ParallelPlan] = []
    for mask in itertools.product((False, True), repeat=len(idxs)):
        stages = list(plan.stages)
        for i, flag in zip(idxs, mask):
            stages[i] = dataclasses.replace(stages[i], remat=flag)
        name = plan.name
        if any(mask):
            name += ".remat" + "".join(
                str(i) for i, f in zip(idxs, mask) if f)
        out.append(dataclasses.replace(plan, stages=tuple(stages),
                                       name=name))
    return out


def candidate_convnet_plans(
    cfg: ConvNetConfig,
    hw: "perf_model.Hardware",
    *,
    spatial_axis: str = "model",
    spatial_degree: int,
    data_axes: Tuple[str, ...] = ("data",),
    data_degree: int = 1,
    global_batch: int,
    overlap: bool = True,
    grad_comm: str = "overlap",
    min_local_width: int = 4,
) -> List[ParallelPlan]:
    """Every admissible one-transition plan (each boundary x {batch,
    replicated}, the uniform plan included), priced. A batch transition
    needs the group's batch to divide by the spatial degree; a spatial
    stage needs every layer's local width >= ``min_local_width``."""
    per_group_batch = global_batch / max(data_degree, 1)
    batch_ok = (per_group_batch >= spatial_degree
                and per_group_batch % spatial_degree == 0)
    n = (cosmoflow_n_layers(cfg) if cfg.arch == "cosmoflow"
         else unet_n_layers(cfg))
    if cfg.arch == "cosmoflow":
        widths = [l.width for l in perf_model.cosmoflow_layers(cfg)]
    else:
        widths = [cfg.input_width // 2 ** lvl for lvl in range(n)]
    b_max = n
    for i, w in enumerate(widths):
        if w // spatial_degree < min_local_width:
            b_max = i
            break
    if b_max == 0:
        raise ValueError(
            f"{cfg.arch}: {spatial_degree}-way spatial decomposition gives "
            f"layer-0 local width {widths[0] // spatial_degree} < "
            f"{min_local_width}; reduce the spatial degree")

    out: List[ParallelPlan] = []
    seen = set()
    kinds = ("batch", "replicated") if batch_ok else ("replicated",)
    for b, kind in itertools.product(range(1, min(b_max, n) + 1), kinds):
        plan = convnet_plan(
            cfg, boundary=b, kind=kind,
            spatial_axes=(spatial_axis, None, None),
            spatial_degrees=(spatial_degree, 1, 1),
            data_axes=data_axes,
            data_degrees=(data_degree,) + (1,) * (len(data_axes) - 1))
        key = tuple(plan.stages)  # the kind lives in the stages
        if key in seen:
            continue
        seen.add(key)
        cost = price_plan(cfg, hw, plan, global_batch=global_batch,
                          overlap=overlap, grad_comm=grad_comm)
        out.append(dataclasses.replace(plan, cost=cost))
    return out


def candidate_pipeline_plans(
    cfg: ConvNetConfig,
    hw: "perf_model.Hardware",
    *,
    pipeline_degrees: Sequence[int],
    micro_batch_options: Sequence[int] = (1, 2, 4, 8),
    data_axes: Tuple[str, ...] = ("data",),
    num_devices: int,
    global_batch: int,
    grad_comm: str = "overlap",
    schedule: str = "1f1b",
) -> List[ParallelPlan]:
    """Every pipelined candidate, priced: each group count P >= 2 of
    ``pipeline_degrees`` that divides ``num_devices`` (d = num_devices
    / P devices a group), each micro-batch count whose micro-batch
    divides over d, each placement of the P - 1 cuts. None under
    ``reduce_scatter`` (ZeRO-1 shards one tree over one mesh)."""
    if grad_comm == "reduce_scatter":
        return []
    n = (cosmoflow_n_layers(cfg) if cfg.arch == "cosmoflow"
         else unet_n_layers(cfg))
    out: List[ParallelPlan] = []
    for p_ in sorted({int(p) for p in pipeline_degrees}):
        if p_ < 2 or p_ > n or num_devices % p_:
            continue
        d = num_devices // p_
        for m in micro_batch_options:
            if global_batch % m or (global_batch // m) % d:
                continue
            for cuts in itertools.combinations(range(1, n), p_ - 1):
                plan = pipelined_convnet_plan(
                    cfg, boundaries=cuts, micro_batches=m,
                    schedule=schedule, data_axes=data_axes,
                    data_degrees=(d,) + (1,) * (len(data_axes) - 1))
                cost = price_plan(cfg, hw, plan, global_batch=global_batch,
                                  grad_comm=grad_comm)
                out.append(dataclasses.replace(plan, cost=cost))
    return out


def plan_convnet(
    cfg: ConvNetConfig,
    hw: "perf_model.Hardware",
    *,
    memory_budget_bytes: Optional[float] = None,
    precisions: Sequence[str] = ("fp32",),
    spatial_options: Optional[Sequence[int]] = None,
    remat_options: Optional[bool] = None,
    pipeline_options: Optional[Sequence[int]] = None,
    micro_batch_options: Sequence[int] = (1, 2, 4, 8),
    **kw,
) -> ParallelPlan:
    """The cost model's argmin over ``candidate_convnet_plans`` (``kw``
    are its arguments); ties go to the fewest stages.

    With ``memory_budget_bytes`` the argmin runs over transition x kind x
    remat set x precision subject to ``core/memory.py``'s modeled peak a
    device fitting the budget; ``spatial_options`` lets it raise the
    spatial degree (the data degree stays), ``remat_options`` expands
    the per-stage remat sets (default: under a budget). Among plans
    within 1% of the fastest it prefers the highest precision, then no
    remat, then the fewest stages. When nothing fits, the ``ValueError``
    carries the candidate of the smallest modeled peak
    (``best_infeasible_plan``, ``best_infeasible_mem``).

    ``pipeline_options`` adds the pipelined candidates of every listed
    group count > 1 dividing the devices (micro-batch counts from
    ``micro_batch_options``) to the same argmin, never with remat
    variants (a pipeline recomputes each segment already) nor fp16;
    ties go to the plan without a pipeline."""
    prec_rank = {"fp32": 0, "bf16": 1, "fp16": 2}
    expand_remat = (remat_options if remat_options is not None
                    else memory_budget_bytes is not None)
    pipe_degrees = tuple(p for p in (pipeline_options or ()) if int(p) > 1)

    def pipeline_cands(num_devices: int) -> List[ParallelPlan]:
        if not pipe_degrees:
            return []
        return candidate_pipeline_plans(
            cfg, hw, pipeline_degrees=pipe_degrees,
            micro_batch_options=micro_batch_options,
            data_axes=kw.get("data_axes", ("data",)),
            num_devices=num_devices, global_batch=kw["global_batch"],
            grad_comm=kw.get("grad_comm", "overlap"))

    plain = (memory_budget_bytes is None and spatial_options is None
             and not expand_remat and tuple(precisions) == ("fp32",))
    if plain:
        cands = candidate_convnet_plans(cfg, hw, **kw)
        cands += pipeline_cands(kw["spatial_degree"]
                                * kw.get("data_degree", 1))
        if not cands:
            raise ValueError(
                "no admissible plans (spatial degree too large?)")
        return min(cands, key=lambda p: (p.cost, int(p.n_groups > 1),
                                         len(p.stages)))

    from repro_torch.core import memory as memory_lib  # imports plan

    global_batch = kw["global_batch"]
    overlap = kw.get("overlap", True)
    grad_comm = kw.get("grad_comm", "overlap")
    base_degree = kw.pop("spatial_degree")
    options = tuple(spatial_options) if spatial_options else (base_degree,)
    bases: List[Tuple[ParallelPlan, bool]] = []
    for s in options:
        try:
            cands = candidate_convnet_plans(cfg, hw, spatial_degree=s, **kw)
        except ValueError:
            continue  # the degree over-decomposes layer 0
        bases += [(b, expand_remat) for b in cands]
    bases += [(b, False) for b in
              pipeline_cands(base_degree * kw.get("data_degree", 1))]

    feasible: List[ParallelPlan] = []
    best_infeasible: Optional[Tuple[ParallelPlan, Any]] = None
    for base, can_remat in bases:
        for var in (remat_variants(cfg, base) if can_remat else [base]):
            for prec in precisions:
                if base.pipeline is not None and prec == "fp16":
                    continue  # no fp16 loss-scale machine under a pipeline
                p = dataclasses.replace(
                    var, precision=prec,
                    name=(var.name if prec == "fp32"
                          else f"{var.name}@{prec}"))
                if prec == "fp32" and not p.uses_remat:
                    cost = base.cost  # priced above
                else:
                    cost = price_plan(cfg, hw, p, global_batch=global_batch,
                                      overlap=overlap, grad_comm=grad_comm)
                p = dataclasses.replace(p, cost=cost)
                if memory_budget_bytes is not None:
                    mem = memory_lib.plan_peak_bytes(
                        cfg, p, global_batch=global_batch,
                        grad_comm=grad_comm)
                    if mem.total > memory_budget_bytes:
                        if (best_infeasible is None
                                or mem.total < best_infeasible[1].total):
                            best_infeasible = (p, mem)
                        continue
                feasible.append(p)
    if not feasible:
        if best_infeasible is not None:
            p, mem = best_infeasible
            err = ValueError(
                f"no plan fits memory_budget_bytes="
                f"{memory_budget_bytes / 2 ** 30:.2f}GiB; closest is "
                f"{p.name} at {mem.describe()} — raise the budget, the "
                f"spatial_options, or allow lower precision")
            err.best_infeasible_plan = p
            err.best_infeasible_mem = mem
            raise err
        raise ValueError("no admissible plans (spatial degree too large?)")
    cut = min(p.cost for p in feasible) * 1.01
    pool = [p for p in feasible if p.cost <= cut]
    return min(pool, key=lambda p: (prec_rank.get(p.precision, 99),
                                    int(p.n_groups > 1),
                                    int(p.uses_remat), len(p.stages),
                                    p.cost))


def price_fixed_degree(
    cfg: ConvNetConfig,
    hw: "perf_model.Hardware",
    *,
    spatial_axis: str = "model",
    spatial_degree: int,
    data_degree: int = 1,
    global_batch: int,
    overlap: bool = True,
    grad_comm: str = "overlap",
) -> Tuple[ParallelPlan, float]:
    """(the fixed-degree legacy plan, its priced iteration time): the
    baseline a chosen plan is compared with, built directly rather than
    drawn from the planner's candidates."""
    fixed = legacy_convnet_plan(
        cfg, SpatialPartitioning((spatial_axis, None, None)),
        (spatial_degree, 1, 1), data_degrees=(data_degree,))
    cost = perf_model.iteration_time(
        cfg, hw, num_gpus=spatial_degree * data_degree,
        ways=spatial_degree, global_batch=global_batch, overlap=overlap,
        grad_comm=grad_comm, schedule=plan_schedule(cfg, fixed))["total"]
    return fixed, cost
