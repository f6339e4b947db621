"""The analytic FLOPs of the conv nets (the reference's
``launch/specs.py``: ``conv_net_flops_per_sample`` and ``model_flops``).
The rest of that file builds XLA shape structs for dry runs, which have
no counterpart here; the language models' FLOPs come with the LM
slice."""
from __future__ import annotations

import math

from repro_torch.configs.base import ConvNetConfig

# the paper's batch sizes for the conv nets (Figs. 4 and 7)
CONV_GLOBAL_BATCH = {"cosmoflow": 64, "unet3d": 16}


def conv_net_flops_per_sample(cfg: ConvNetConfig,
                              forward_only: bool = False) -> float:
    """Conv FLOPs a sample (the paper's Table I): the forward, or with
    the input and weight gradients three times it."""
    k3 = cfg.kernel_size ** 3
    total = 0.0
    if cfg.arch == "cosmoflow":
        w, cin = cfg.input_width, cfg.in_channels
        npool = min(int(math.log2(w)) - 2, len(cfg.conv_channels))
        for i, c in enumerate(cfg.conv_channels):
            ow = w // 2 if i == 3 else w
            total += 2 * k3 * cin * c * ow ** 3
            w = ow // 2 if i < npool else ow
            cin = c
    else:
        w, cin, ch = cfg.input_width, cfg.in_channels, cfg.base_channels
        enc = []
        for _ in range(cfg.depth):
            total += 2 * k3 * cin * ch * w ** 3
            total += 2 * k3 * ch * 2 * ch * w ** 3
            enc.append(2 * ch)
            cin, ch, w = 2 * ch, 2 * ch, w // 2
        total += 2 * k3 * cin * ch * w ** 3
        total += 2 * k3 * ch * 2 * ch * w ** 3
        up_in = 2 * ch
        for skip in reversed(enc):
            w *= 2
            total += 2 * 8 * up_in * skip * w ** 3  # deconv
            total += 2 * k3 * 2 * skip * skip * w ** 3
            total += 2 * k3 * skip * skip * w ** 3
            up_in = skip
        total += 2 * up_in * cfg.out_dim * w ** 3
    return total if forward_only else 3.0 * total


def model_flops(arch: str, cfg, shape_name: str = "train_4k") -> float:
    """Useful FLOPs a global training step of a conv net at the paper's
    batch (``CONV_GLOBAL_BATCH``). ``shape_name`` names a language
    model's input shape in the reference; the conv nets ignore it."""
    if not isinstance(cfg, ConvNetConfig):
        raise NotImplementedError(
            f"model_flops of {arch!r}: the language models' FLOPs come "
            "with the LM-training slice of the port")
    return conv_net_flops_per_sample(cfg) * CONV_GLOBAL_BATCH[cfg.arch]


__all__ = ["CONV_GLOBAL_BATCH", "conv_net_flops_per_sample", "model_flops"]
