"""Per-layer width bookkeeping of CosmoFlow and the 3D U-Net, from the
reference's ``core/perf_model.py``: the single holder of CosmoFlow's
pool-count / stride-2 structure that ``core/plan.py`` derives its
stages from, and of the U-Net's conv and deconv shapes (its conv
shapes and launch counts, ``models/unet3d.py``). The analytic time and
memory model comes with the plans slice."""
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


def unet_layers(cfg: ConvNetConfig) -> List[ConvLayer]:
    """The U-Net's convs in forward order: per encoder level two k = 3
    convs (the second one pooled after), the bottleneck's two, then per
    decoder level the 2^3 deconv and two k = 3 convs. The 1^3 head is
    not listed (the reference's)."""
    layers, w, cin, ch = [], cfg.input_width, cfg.in_channels, \
        cfg.base_channels
    enc = []
    for _ in range(cfg.depth):
        layers.append(ConvLayer(cin, ch, w, 1, 3, False))
        layers.append(ConvLayer(ch, 2 * ch, w, 1, 3, True))
        enc.append(2 * ch)
        cin, ch, w = 2 * ch, 2 * ch, w // 2
    layers.append(ConvLayer(cin, ch, w, 1, 3, False))
    layers.append(ConvLayer(ch, 2 * ch, w, 1, 3, False))
    up = 2 * ch
    for skip in reversed(enc):
        w *= 2
        layers.append(ConvLayer(up, skip, w, 1, 2, False))        # deconv
        layers.append(ConvLayer(2 * skip, skip, w, 1, 3, False))
        layers.append(ConvLayer(skip, skip, w, 1, 3, False))
        up = skip
    return layers
