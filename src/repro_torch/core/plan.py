"""Per-stage parallelism plans (the reference's ``core/plan.py``, data
part).

A ``ParallelPlan`` is an ordered list of ``Stage``s, each naming the
mesh axes that shard the batch and the D/H/W dims for a contiguous
range of layers (cosmoflow: layers ``0..n_blocks-1`` are the conv
blocks, layer ``n_blocks`` the FC head; the U-Net: layers
``0..depth-1`` are the resolution levels, layer ``depth`` the
bottleneck). The dataclasses, their names and their JSON
(``api/config.py``) are the reference's, so a plan pinned in a
reference checkpoint reads back. ``legacy_convnet_plan`` builds the
fixed-degree plan ``RunConfig(plan="fixed")`` resolves to: for
CosmoFlow, depth partitioned over ``spatial`` shards until a block's
local width would drop below 4, then gathered; for the U-Net, one
spatial stage over every level. The cost-model planner comes with the
plans slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import perf_model
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
    a pipelined training plan. Read from checkpoints; serving flattens
    pipelined plans."""

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


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Ordered stages covering layers ``[0, n_layers)`` plus the mesh-axis
    degrees they reference. ``precision`` is the policy the plan was
    priced for; ``pipeline`` maps stages onto device groups."""

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
        return self.pipeline.n_groups if self.pipeline is not None else 1

    @property
    def device_count(self) -> int:
        """Devices the plan spans: every mesh degree times the groups."""
        d = self.n_groups
        for _, n in self.mesh_axes:
            d *= n
        return d


def cosmoflow_n_layers(cfg: ConvNetConfig) -> int:
    return len(cfg.conv_channels) + 1  # conv blocks + the FC head


def unet_n_layers(cfg: ConvNetConfig) -> int:
    return cfg.depth + 1  # resolution levels + the bottleneck


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
    mesh_axes = tuple(zip(tuple(data_axes), tuple(int(d) for d in
                                                  data_degrees))) + tuple(
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
