"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` under the reference registry's names — the
CosmoFlow variants and ``mamba2-370m``. The 3D U-Net and the other LM
configs join with their slices."""
from __future__ import annotations

from typing import Union

from repro_torch.configs import cosmoflow, mamba2_370m
from repro_torch.configs.base import ConvNetConfig, SSMConfig

COSMOFLOW_ARCHS = ["cosmoflow-128", "cosmoflow-256", "cosmoflow-512"]
LM_ARCHS = ["mamba2-370m"]
ALL_ARCHS = COSMOFLOW_ARCHS + LM_ARCHS
_LM_MODULES = {"mamba2-370m": mamba2_370m}


def _check(name: str) -> None:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown model {name!r}; choices: {ALL_ARCHS}")


def get_config(name: str) -> Union[ConvNetConfig, SSMConfig]:
    _check(name)
    if name in _LM_MODULES:
        return _LM_MODULES[name].CONFIG
    return cosmoflow.config_for_width(int(name.split("-")[1]))


def get_smoke_config(name: str) -> Union[ConvNetConfig, SSMConfig]:
    _check(name)
    if name in _LM_MODULES:
        return _LM_MODULES[name].SMOKE
    return cosmoflow.SMOKE


__all__ = ["ALL_ARCHS", "COSMOFLOW_ARCHS", "ConvNetConfig", "LM_ARCHS",
           "SSMConfig", "get_config", "get_smoke_config"]
