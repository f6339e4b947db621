"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` under the reference registry's names — the
CosmoFlow variants, the 3D U-Net (``unet3d-256``) and the ten assigned
language models (``ASSIGNED``: the transformer, MoE, VLM and audio
families, mamba2-370m and the zamba2 hybrid). Each LM module exports
``CONFIG`` (the published spec) and ``SMOKE`` (a reduced variant of the
same family for CPU tests), copied from the reference's.
``applicable_shapes`` and ``skip_reason`` give the assignment's shape
skips (which ``INPUT_SHAPES`` apply to which architecture, and why the
others do not), as the reference's registry does; ``PLANS`` /
``plan_for`` give each language model's parallelism plan per shape
(``core/sharding.py``; the launcher's default ``--plan``)."""
from __future__ import annotations

from typing import Dict, Tuple, Union

from repro_torch.configs import (
    arctic_480b,
    cosmoflow,
    gemma2_2b,
    hubert_xlarge,
    llama3_405b,
    mamba2_370m,
    phi3_mini,
    phi3_vision,
    phi35_moe,
    qwen15_0p5b,
    unet3d,
    zamba2_1p2b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    ConvNetConfig,
    HybridConfig,
    InputShape,
    SSMConfig,
    TransformerConfig,
)

ASSIGNED = [
    "hubert-xlarge", "zamba2-1.2b", "phi3.5-moe", "gemma2-2b",
    "arctic-480b", "phi3-mini", "phi3-vision", "llama3-405b",
    "qwen1.5-0.5b", "mamba2-370m",
]
COSMOFLOW_ARCHS = ["cosmoflow-128", "cosmoflow-256", "cosmoflow-512"]
UNET_ARCHS = ["unet3d-256"]
PAPER_ARCHS = COSMOFLOW_ARCHS + UNET_ARCHS
LM_ARCHS = list(ASSIGNED)
ALL_ARCHS = COSMOFLOW_ARCHS + UNET_ARCHS + LM_ARCHS
_MODULES = {
    "hubert-xlarge": hubert_xlarge,
    "zamba2-1.2b": zamba2_1p2b,
    "phi3.5-moe": phi35_moe,
    "gemma2-2b": gemma2_2b,
    "arctic-480b": arctic_480b,
    "phi3-mini": phi3_mini,
    "phi3-vision": phi3_vision,
    "llama3-405b": llama3_405b,
    "qwen1.5-0.5b": qwen15_0p5b,
    "mamba2-370m": mamba2_370m,
    "unet3d-256": unet3d,
}
Config = Union[ConvNetConfig, SSMConfig, HybridConfig, TransformerConfig]

# parallelism plan per (arch, shape); conv nets plan through core/plan.py
_DEFAULT_PLAN = {"train_4k": "tp", "prefill_32k": "cp",
                 "decode_32k": "cp", "long_500k": "cp"}
PLANS: Dict[str, Dict[str, str]] = {
    "hubert-xlarge": {"train_4k": "tp", "prefill_32k": "cp"},
    "zamba2-1.2b": {"train_4k": "tp", "prefill_32k": "cp",
                    "decode_32k": "cp", "long_500k": "cp"},
    "phi3.5-moe": {"train_4k": "ep", "prefill_32k": "ep",
                   "decode_32k": "ep"},
    "gemma2-2b": dict(_DEFAULT_PLAN, train_4k="cp"),
    "arctic-480b": {"train_4k": "ep", "prefill_32k": "ep",
                    "decode_32k": "ep"},
    "phi3-mini": {"train_4k": "tp", "prefill_32k": "tp",
                  "decode_32k": "cp"},
    "phi3-vision": {"train_4k": "tp", "prefill_32k": "tp",
                    "decode_32k": "cp"},
    "llama3-405b": {"train_4k": "tp", "prefill_32k": "tp",
                    "decode_32k": "cp"},
    "qwen1.5-0.5b": {"train_4k": "tp", "prefill_32k": "tp",
                     "decode_32k": "cp"},
    "mamba2-370m": {"train_4k": "tp", "prefill_32k": "cp",
                    "decode_32k": "cp", "long_500k": "cp"},
}


def _check(name: str) -> None:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown model {name!r}; choices: {ALL_ARCHS}")


def get_config(name: str) -> Config:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].CONFIG
    return cosmoflow.config_for_width(int(name.split("-")[1]))


def get_smoke_config(name: str) -> Config:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].SMOKE
    return cosmoflow.SMOKE


def plan_for(arch: str, shape: str) -> str:
    """The plan ``arch`` takes at ``shape`` (``tp`` where none is set)."""
    return PLANS.get(arch, {}).get(shape, "tp")


def applicable_shapes(arch: str) -> Tuple[str, ...]:
    """Which of the four input shapes apply (assignment-mandated skips):
    a conv net trains only; a language model trains and prefills, and
    decodes where it has a decode step, and a sub-quadratic one also at
    ``long_500k``."""
    cfg = get_config(arch)
    if isinstance(cfg, ConvNetConfig):
        return ("train_4k",)  # conv nets: training only (paper scope)
    shapes = ["train_4k", "prefill_32k"]
    if getattr(cfg, "supports_decode", True):
        shapes.append("decode_32k")
        if getattr(cfg, "subquadratic", False):
            shapes.append("long_500k")
    return tuple(shapes)


def skip_reason(arch: str, shape: str) -> str:
    """Why ``shape`` does not apply to ``arch`` ("" where it applies)."""
    cfg = get_config(arch)
    if isinstance(cfg, ConvNetConfig):
        return ("conv net (paper model): token shapes N/A; evaluated on its "
                "own 3-D volumes")
    if shape in ("decode_32k", "long_500k") and not cfg.supports_decode:
        return "encoder-only: no decode step (DESIGN.md §7)"
    if shape == "long_500k" and not cfg.subquadratic:
        return ("pure full attention: long_500k requires sub-quadratic "
                "attention (DESIGN.md §7)")
    return ""


__all__ = ["ALL_ARCHS", "ASSIGNED", "COSMOFLOW_ARCHS", "ConvNetConfig",
           "HybridConfig", "INPUT_SHAPES", "InputShape",
           "LM_ARCHS", "PAPER_ARCHS", "PLANS", "SSMConfig",
           "TransformerConfig", "UNET_ARCHS", "applicable_shapes",
           "get_config", "get_smoke_config", "plan_for", "skip_reason"]
