"""Per-layer width bookkeeping of CosmoFlow, from the reference's
``core/perf_model.py``: the single holder of the pool-count / stride-2
structure that ``core/plan.py`` derives its stages from. The analytic
time and memory model comes with the plans slice."""
from __future__ import annotations

import dataclasses
import math
from typing import List

from repro_torch.configs.base import ConvNetConfig


@dataclasses.dataclass
class ConvLayer:
    cin: int
    cout: int
    width: int      # global input width (cubic)
    stride: int
    kernel: int
    pooled: bool


def cosmoflow_layers(cfg: ConvNetConfig) -> List[ConvLayer]:
    layers, w, cin = [], cfg.input_width, cfg.in_channels
    npool = min(int(math.log2(cfg.input_width)) - 2,
                len(cfg.conv_channels))
    for i, c in enumerate(cfg.conv_channels):
        stride = 2 if i == 3 else 1
        pooled = i < npool
        layers.append(ConvLayer(cin, c, w, stride, cfg.kernel_size, pooled))
        w = w // stride // (2 if pooled else 1)
        cin = c
    return layers
