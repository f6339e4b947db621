"""Per-layer width bookkeeping of CosmoFlow and the 3D U-Net, from the
reference's ``core/perf_model.py``: the single holder of CosmoFlow's
pool-count / stride-2 structure that ``core/plan.py`` derives its
stages from and ``core/memory.py`` walks, and of the U-Net's conv and
deconv shapes (its conv shapes and launch counts, ``models/unet3d.py``);
the optimizer state's bytes (``opt_state_bytes``, shared with the memory
model) and the paper's activation bytes per sample
(``memory_per_sample_bytes``). The time model (``iteration_time``,
``Hardware``) comes with the plans slice."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

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


def opt_state_bytes(n_params: int, *, grad_comm: str = "overlap",
                    data_degree: int = 1) -> float:
    """Adam's m and v in fp32; ZeRO-1 (``reduce_scatter``) shards them
    over the data-parallel degree."""
    total = 2.0 * n_params * 4
    if grad_comm == "reduce_scatter":
        total /= max(data_degree, 1)
    return total


def memory_per_sample_bytes(cfg: ConvNetConfig,
                            batchnorm: Optional[bool] = None) -> float:
    """Activation memory per sample (forward stores and gradients), the
    paper's Table I: every layer's input and output in fp32, times 3.8
    (stored activations, gradient buffers and cuDNN's workspace: 0.82 /
    6.56 / 52.6 GiB at 128^3 / 256^3 / 512^3 against the paper's 0.824 /
    6.59 / 52.7), doubled with batch norm (the paper's §IV)."""
    layers = (cosmoflow_layers(cfg) if cfg.arch == "cosmoflow"
              else unet_layers(cfg))
    total = 0.0
    for l in layers:
        out_w = l.width // l.stride
        total += (l.width ** 3 * l.cin + out_w ** 3 * l.cout) * 4
    total *= 3.8
    if cfg.batchnorm if batchnorm is None else batchnorm:
        total *= 2
    return total
