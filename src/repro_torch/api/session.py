"""``compile(RunConfig, device=None)``: the port's one assembly path.

``mode="infer"`` validates the config, resolves the plan and precision
and returns a forward-only ``repro_torch.serve.InferenceSession``;
``mode="train"`` raises ``NotImplementedError`` until the training
slice. Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (as the tests do); with no CUDA device and no explicit
``device`` they raise instead of running on the CPU.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.api.config import RunConfig
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning

# the run description a training checkpoint embeds (reference format)
_META_FILE = "run_config.json"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` -> the CUDA device; raises when there is none, naming
    the ``device`` argument."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "the port on the CPU (entry points default to the card)")
        return torch.device("cuda")
    return torch.device(device)


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


def compile(config: RunConfig, *, device: DeviceLike = None):  # noqa: A001
    """Validate ``config`` and build its session on ``device`` (None:
    the CUDA device). ``mode="infer"`` returns an ``InferenceSession``."""
    if config.mode == "train":
        raise NotImplementedError(
            "mode='train' comes with the training slice of the port "
            "(backward kernels, optimizer, train step); use mode='infer'")
    from repro_torch.serve.session import compile_infer  # imports us

    return compile_infer(config, device=device)
