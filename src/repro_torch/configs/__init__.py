"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` under the reference registry's names — the
CosmoFlow variants, the 3D U-Net (``unet3d-256``) and ``mamba2-370m``.
The other LM configs join with their slices."""
from __future__ import annotations

from typing import Union

from repro_torch.configs import cosmoflow, mamba2_370m, unet3d
from repro_torch.configs.base import ConvNetConfig, SSMConfig

COSMOFLOW_ARCHS = ["cosmoflow-128", "cosmoflow-256", "cosmoflow-512"]
UNET_ARCHS = ["unet3d-256"]
LM_ARCHS = ["mamba2-370m"]
ALL_ARCHS = COSMOFLOW_ARCHS + UNET_ARCHS + LM_ARCHS
_MODULES = {"mamba2-370m": mamba2_370m, "unet3d-256": unet3d}


def _check(name: str) -> None:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown model {name!r}; choices: {ALL_ARCHS}")


def get_config(name: str) -> Union[ConvNetConfig, SSMConfig]:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].CONFIG
    return cosmoflow.config_for_width(int(name.split("-")[1]))


def get_smoke_config(name: str) -> Union[ConvNetConfig, SSMConfig]:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].SMOKE
    return cosmoflow.SMOKE


__all__ = ["ALL_ARCHS", "COSMOFLOW_ARCHS", "ConvNetConfig", "LM_ARCHS",
           "SSMConfig", "UNET_ARCHS", "get_config", "get_smoke_config"]
