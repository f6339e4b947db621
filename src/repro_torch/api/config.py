"""Declarative run configuration of the port's public API.

``RunConfig`` has every field of the reference's ``RunConfig`` and the
same JSON (``to_json``/``from_json``, with an inline ``ConvNetConfig``
and a pinned ``ParallelPlan``), so the run description a reference
checkpoint embeds reads back here. The device is not a field: the entry
points take ``device=`` or ``devices=`` (``repro_torch.api.compile``).

``validate`` raises ``RunConfigError`` naming the offending field and a
fix, as the reference does. ``plan`` is ``"fixed"`` (the fixed-degree
legacy plan), ``"auto"`` (the cost-model planner's choice at the
config's degrees) or a pinned ``ParallelPlan``; ``memory_budget_gib``
(> 0) makes the planner choose under that modeled peak a device
(``core/memory.py``), raising the spatial degree, the precision or the
remat set where it must. Both modes take data x spatial degrees. What
the port cannot run yet is rejected the same way, naming the slice that
brings it: the pipeline axis (``pipeline``). Training takes every
``grad_comm``, ZeRO-1 (``reduce_scatter``) included; serving none but
``auto``, as the reference rules.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Dict, Optional, Union

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib

PRECISIONS = ("auto", "fp32", "bf16", "fp16")
GRAD_COMMS = ("auto", "monolithic", "overlap", "reduce_scatter")
PLAN_POLICIES = ("fixed", "auto")
LR_SCHEDULES = ("constant", "linear_decay", "warmup_cosine")
MODES = ("train", "infer")
_MIN_LOCAL_WIDTH = 4  # the over-decomposition rule (DESIGN.md §5)


class RunConfigError(ValueError):
    """A misconfigured ``RunConfig`` field: names the field, what is
    wrong with it, and a suggested fix."""

    def __init__(self, field: str, problem: str, fix: str):
        self.field = field
        self.problem = problem
        self.fix = fix
        super().__init__(f"RunConfig.{field}: {problem} — fix: {fix}")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One declarative description of a run (the reference's fields and
    defaults). ``model`` is a registry name (``repro_torch.configs``,
    e.g. ``"cosmoflow-512"``; ``smoke=True`` picks its reduced variant)
    or an inline ``ConvNetConfig``. ``use_pallas`` is kept for JSON
    compatibility and has no effect: on CUDA the port always runs its
    own kernels."""

    model: Union[str, ConvNetConfig]
    smoke: bool = False
    mode: str = "train"
    global_batch: int = 4
    data: int = 1
    spatial: int = 1
    pipeline: int = 1
    micro_batches: int = 4
    pipeline_schedule: str = "1f1b"
    plan: Union[str, "plan_lib.ParallelPlan"] = "fixed"
    memory_budget_gib: Optional[float] = None
    precision: str = "auto"
    grad_comm: str = "auto"
    overlap_halo: Optional[bool] = None
    use_pallas: bool = False
    # --- optimizer ---
    lr: float = 1e-3
    lr_schedule: str = "linear_decay"
    warmup_steps: int = 0  # warmup_cosine only
    grad_clip: float = 0.0
    total_steps: int = 100
    seed: int = 0
    # --- checkpoint policy ---
    checkpoint_dir: Optional[str] = None
    save_every: Optional[int] = None
    keep_last: Optional[int] = None
    guard: Optional[bool] = None
    # --- input pipeline (Session.make_loader): the store's directory
    # (None: a synthetic dataset) and the prefetch queue's depth ---
    data_dir: Optional[str] = None
    prefetch: int = 2
    # --- observability: False = off, True = record spans in memory, a
    # path = also write the Chrome/Perfetto trace there on close ---
    trace: Union[bool, str] = False
    metrics_jsonl: Optional[str] = None

    # ------------------------------------------------------ resolution ----
    @property
    def resolved_guard(self) -> bool:
        """Explicit value, or the mode default (train guards non-finite
        steps; a forward-only program has no gradients to guard)."""
        if self.guard is None:
            return self.mode == "train"
        return bool(self.guard)

    def resolve_model(self) -> ConvNetConfig:
        """The concrete ``ConvNetConfig`` this run uses."""
        if isinstance(self.model, ConvNetConfig):
            cfg = self.model
        else:
            from repro_torch import configs  # deferred: registry is data

            if self.model not in configs.ALL_ARCHS:
                close = difflib.get_close_matches(str(self.model),
                                                  configs.ALL_ARCHS, n=3)
                hint = (f"did you mean {', '.join(close)}?" if close
                        else f"the port serves {', '.join(configs.ALL_ARCHS)}"
                        "; the other LMs come with their slices")
                raise RunConfigError("model", f"unknown model {self.model!r}",
                                     hint)
            if self.model in configs.LM_ARCHS:
                raise RunConfigError(
                    "model", f"{self.model!r} is a language model",
                    "score it with repro_torch.models.ssm_lm.forward / "
                    "lm_loss and decode with repro_torch.serve.lm.generate")
            cfg = (configs.get_smoke_config(self.model) if self.smoke
                   else configs.get_config(self.model))
        if cfg.arch not in ("cosmoflow", "unet3d"):
            raise RunConfigError(
                "model", f"{cfg.name!r} is a {cfg.arch} model",
                "pass a CosmoFlow or U-Net config")
        return cfg

    # ------------------------------------------------------ validation ----
    def validate(self, device_count: Optional[int] = 1) -> None:
        """Check every field up front; raise ``RunConfigError`` naming
        the field and a fix. ``device_count`` is the number of devices
        the run is given (one per shard; None: not checked here)."""
        cfg = self.resolve_model()
        if self.mode not in MODES:
            raise RunConfigError("mode", f"unknown mode {self.mode!r}",
                                 f"choices: {', '.join(MODES)}")
        if self.guard is not None and not isinstance(self.guard, bool):
            raise RunConfigError(
                "guard", f"must be True, False or None (auto), got "
                f"{self.guard!r}", "pass a bool or leave it None")
        if self.mode == "infer":
            self._validate_infer()
        else:
            self._validate_train()
        self._validate_common(device_count)
        self._validate_spatial(cfg)

    def _validate_train(self) -> None:
        """What the training slice runs: data x spatial shards (no
        pipeline axis), the fixed or a pinned plan, and any reduction
        mode."""
        if not isinstance(self.pipeline, int) or self.pipeline < 1:
            raise RunConfigError(
                "pipeline", f"group count must be an int >= 1, got "
                f"{self.pipeline!r}",
                "pass 1 (no pipelining) or the number of stage groups")
        if self.pipeline != 1:
            raise RunConfigError(
                "pipeline",
                f"pipeline={self.pipeline} needs the pipeline axis, which "
                "the pipeline slice of the port brings",
                "set pipeline=1")

    def _validate_infer(self) -> None:
        """Reject knobs that configure training machinery a forward-only
        program does not have."""
        if self.grad_comm != "auto":
            raise RunConfigError(
                "grad_comm",
                f"{self.grad_comm!r} configures gradient reduction, "
                "but mode='infer' compiles a forward-only program "
                "with no gradients",
                "drop grad_comm (leave it 'auto') for inference configs")
        if self.pipeline != 1:
            raise RunConfigError(
                "pipeline",
                f"pipeline={self.pipeline} schedules micro-batched "
                "fwd/bwd waves, but mode='infer' serves single "
                "forward calls",
                "set pipeline=1; use spatial= to shard large "
                "volumes instead")
        if self.guard is True:
            raise RunConfigError(
                "guard",
                "the non-finite step guard votes on gradients, "
                "which a forward-only program never produces",
                "drop guard (leave it None) for inference configs")
        if self.save_every is not None or self.keep_last is not None:
            bad = "save_every" if self.save_every is not None \
                else "keep_last"
            raise RunConfigError(
                bad,
                "checkpoint WRITE policy set, but mode='infer' only "
                "ever reads checkpoints",
                f"drop {bad}; restore with "
                "InferenceSession.restore(checkpoint_dir)")

    def _validate_common(self, device_count: Optional[int]) -> None:
        for field in ("data", "spatial"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise RunConfigError(field, f"degree must be an int >= 1, "
                                     f"got {v!r}", "pass a positive degree")
        if not isinstance(self.global_batch, int) or self.global_batch < 1:
            raise RunConfigError("global_batch",
                                 f"must be an int >= 1, got "
                                 f"{self.global_batch!r}",
                                 "pass a positive batch size")
        if self.global_batch % self.data:
            up = ((self.global_batch // self.data) + 1) * self.data
            raise RunConfigError(
                "global_batch",
                f"{self.global_batch} does not divide over data={self.data}",
                f"use a multiple of {self.data} (e.g. {up}), or lower data")
        if self.precision not in PRECISIONS:
            raise RunConfigError("precision",
                                 f"unknown policy {self.precision!r}",
                                 f"choices: {', '.join(PRECISIONS)}")
        if self.grad_comm not in GRAD_COMMS:
            raise RunConfigError("grad_comm",
                                 f"unknown mode {self.grad_comm!r}",
                                 f"choices: {', '.join(GRAD_COMMS)}")

        if isinstance(self.plan, plan_lib.ParallelPlan):
            self._validate_plan_degrees(self.plan)
        elif self.plan not in PLAN_POLICIES:
            raise RunConfigError(
                "plan", f"unknown policy {self.plan!r}",
                f"pass one of {PLAN_POLICIES} or a ParallelPlan instance")

        if self.memory_budget_gib is not None and self.memory_budget_gib <= 0:
            raise RunConfigError("memory_budget_gib",
                                 f"must be > 0, got {self.memory_budget_gib}",
                                 "pass the per-device budget in GiB")

        if self.lr_schedule not in LR_SCHEDULES:
            raise RunConfigError("lr_schedule",
                                 f"unknown schedule {self.lr_schedule!r}",
                                 f"choices: {', '.join(LR_SCHEDULES)}")
        if self.total_steps < 1:
            raise RunConfigError("total_steps",
                                 f"must be >= 1, got {self.total_steps}",
                                 "pass the run length in steps")
        if (self.lr_schedule == "warmup_cosine"
                and not 0 <= self.warmup_steps < self.total_steps):
            raise RunConfigError(
                "warmup_steps",
                f"{self.warmup_steps} outside [0, total_steps="
                f"{self.total_steps})", "shorten the warmup")

        if not isinstance(self.prefetch, int) or self.prefetch < 0:
            raise RunConfigError(
                "prefetch", f"queue depth must be an int >= 0, got "
                f"{self.prefetch!r}",
                "use 0 for the synchronous loader, >= 2 to double-buffer")

        if not isinstance(self.trace, (bool, str)):
            raise RunConfigError(
                "trace", f"must be a bool or a trace-file path, got "
                f"{self.trace!r}",
                "use False (off), True (record in memory), or "
                "'out/trace.json' (record + export on close)")
        if isinstance(self.trace, str) and not self.trace:
            raise RunConfigError(
                "trace", "empty trace path",
                "pass a filename like 'out/trace.json', or True/False")
        if self.metrics_jsonl is not None and not (
                isinstance(self.metrics_jsonl, str) and self.metrics_jsonl):
            raise RunConfigError(
                "metrics_jsonl", f"must be a path or None, got "
                f"{self.metrics_jsonl!r}",
                "pass a filename like 'out/metrics.jsonl'")

        if (device_count is not None
                and self.data * self.spatial > device_count):
            raise RunConfigError(
                "spatial",
                f"data x spatial = {self.data}x{self.spatial} = "
                f"{self.data * self.spatial} shards, but only "
                f"{device_count} device(s) given",
                "reduce the degrees, or pass one device per shard "
                "(devices=['cuda:0'] * n puts them all on one card)")

    def _validate_spatial(self, cfg: ConvNetConfig) -> None:
        """The reference's rule: the spatial degree divides the input
        width and leaves a local width of at least ``_MIN_LOCAL_WIDTH``."""
        w = cfg.input_width
        if self.spatial > 1 and w % self.spatial:
            raise RunConfigError(
                "spatial",
                f"{self.spatial} does not divide {cfg.name}'s input width "
                f"{w}", f"use a power-of-two divisor of {w}")
        if self.spatial > 1 and w // self.spatial < _MIN_LOCAL_WIDTH:
            raise RunConfigError(
                "spatial",
                f"{self.spatial}-way decomposition of width {w} gives local "
                f"width {w // self.spatial} < {_MIN_LOCAL_WIDTH}",
                f"reduce spatial to <= {w // _MIN_LOCAL_WIDTH}")

    def _validate_plan_degrees(self, plan: "plan_lib.ParallelPlan") -> None:
        n_groups = plan.n_groups
        data_deg = plan.data_degree * n_groups
        spatial_deg = plan.spatial_degree
        if data_deg != self.data or spatial_deg != self.spatial:
            raise RunConfigError(
                "plan",
                f"plan {plan.name!r} records {data_deg}-way data x "
                f"{spatial_deg}-way spatial, but the config asks for "
                f"{self.data}x{self.spatial}",
                f"set data={data_deg}, spatial={spatial_deg} (or rebuild "
                f"the plan for this mesh)")
        if n_groups != max(1, self.pipeline):
            raise RunConfigError(
                "pipeline",
                f"plan {plan.name!r} has {n_groups} device group(s) but "
                f"the config asks for pipeline={self.pipeline}",
                f"set pipeline={n_groups} (or rebuild the plan)")

    # --------------------------------------------------- serialization ----
    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if isinstance(self.model, ConvNetConfig):
            d["model"] = {"conv_config": dataclasses.asdict(self.model)}
        if isinstance(self.plan, plan_lib.ParallelPlan):
            d["plan"] = plan_to_json(self.plan)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RunConfig":
        d = dict(d)
        if isinstance(d.get("model"), dict):
            d["model"] = conv_config_from_json(d["model"]["conv_config"])
        if isinstance(d.get("plan"), dict):
            d["plan"] = plan_from_json(d["plan"])
        return cls(**d)


# ---------------------------------------------- plan/model (de)serialize ----
def plan_to_json(plan: "plan_lib.ParallelPlan") -> Dict[str, Any]:
    return {
        "stages": [
            {"start": s.start, "stop": s.stop,
             "spatial_axes": list(s.spatial_axes),
             "batch_axes": list(s.batch_axes), "remat": s.remat}
            for s in plan.stages],
        "mesh_axes": [[a, n] for a, n in plan.mesh_axes],
        "n_layers": plan.n_layers,
        "name": plan.name,
        "cost": plan.cost,
        "precision": plan.precision,
        "pipeline": (None if plan.pipeline is None else {
            "stage_groups": list(plan.pipeline.stage_groups),
            "micro_batches": plan.pipeline.micro_batches,
            "schedule": plan.pipeline.schedule,
        }),
    }


def plan_from_json(d: Dict[str, Any]) -> "plan_lib.ParallelPlan":
    stages = tuple(
        plan_lib.Stage(s["start"], s["stop"], tuple(s["spatial_axes"]),
                       tuple(s["batch_axes"]), s["remat"])
        for s in d["stages"])
    pipe = d.get("pipeline")
    spec = (plan_lib.PipelineSpec(
        tuple(int(g) for g in pipe["stage_groups"]),
        int(pipe["micro_batches"]), pipe["schedule"])
        if pipe else None)
    return plan_lib.ParallelPlan(
        stages, tuple((a, int(n)) for a, n in d["mesh_axes"]),
        d["n_layers"], name=d["name"], cost=d["cost"],
        precision=d["precision"], pipeline=spec)


def conv_config_from_json(d: Dict[str, Any]) -> ConvNetConfig:
    d = dict(d)
    for k in ("conv_channels", "fc_dims"):
        if k in d:
            d[k] = tuple(d[k])
    return ConvNetConfig(**d)
