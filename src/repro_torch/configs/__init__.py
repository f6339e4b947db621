"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` for the CosmoFlow variants, under the
reference registry's names. The 3D U-Net and the LM configs join with
their slices."""
from __future__ import annotations

from repro_torch.configs import cosmoflow
from repro_torch.configs.base import ConvNetConfig

ALL_ARCHS = ["cosmoflow-128", "cosmoflow-256", "cosmoflow-512"]


def get_config(name: str) -> ConvNetConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown model {name!r}; choices: {ALL_ARCHS}")
    return cosmoflow.config_for_width(int(name.split("-")[1]))


def get_smoke_config(name: str) -> ConvNetConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown model {name!r}; choices: {ALL_ARCHS}")
    return cosmoflow.SMOKE


__all__ = ["ALL_ARCHS", "ConvNetConfig", "get_config", "get_smoke_config"]
