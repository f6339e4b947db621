"""``compile(RunConfig, device=None, devices=None)``: the port's one
assembly path.

``mode="infer"`` validates the config, resolves the plan and precision,
places the plan's mesh on devices and returns a forward-only
``repro_torch.serve.InferenceSession``; ``mode="train"`` raises
``NotImplementedError`` until the training slice. Entry points run on
the card unless the caller says otherwise: ``device="cpu"`` (one shard,
as the tests run), or ``devices=[...]`` with one device per shard of a
``spatial > 1`` run — ``["cuda:0"] * 2`` puts both shards on one card,
``["cpu"] * 2`` on the CPU. With neither, a one-shard run takes the CUDA
device and an S-shard run ``cuda:0..S-1``; without enough cards they
raise instead of running elsewhere.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.api.config import RunConfig
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.launch.mesh import DeviceLike

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


def compile(config: RunConfig, *, device: DeviceLike = None,  # noqa: A001
            devices: Optional[Sequence[DeviceLike]] = None):
    """Validate ``config`` and build its session on ``device`` or on
    ``devices`` (one per shard; give one of the two, or neither for the
    card). ``mode="infer"`` returns an ``InferenceSession``."""
    if config.mode == "train":
        raise NotImplementedError(
            "mode='train' comes with the training slice of the port "
            "(backward kernels, optimizer, train step); use mode='infer'")
    from repro_torch.serve.session import compile_infer  # imports us

    return compile_infer(config, device=device, devices=devices)
