"""The analytic "useful" FLOPs (the reference's ``launch/specs.py``:
``conv_net_flops_per_sample`` and ``model_flops``): the paper's Table I
for the conv nets, the 6ND / 2ND convention over ``INPUT_SHAPES`` for
the language models. The rest of that file builds XLA shape structs for
dry runs, which have no counterpart here."""
from __future__ import annotations

import math

from repro_torch.configs.base import INPUT_SHAPES, ConvNetConfig

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
    """Useful FLOPs a global step: a conv net's training step at the
    paper's batch (``CONV_GLOBAL_BATCH``; ``shape_name`` ignored); a
    language model's at ``INPUT_SHAPES[shape_name]``, 6 x active
    parameters x tokens to train, 2x to prefill, 2x a sequence's one
    token to decode."""
    ishape = INPUT_SHAPES[shape_name]
    if isinstance(cfg, ConvNetConfig):
        return conv_net_flops_per_sample(cfg) * CONV_GLOBAL_BATCH[cfg.arch]
    n_active = cfg.active_param_count()
    tokens = ishape.global_batch * ishape.seq_len
    if ishape.kind == "train":
        return 6.0 * n_active * tokens
    if ishape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * ishape.global_batch  # decode: one token/seq


__all__ = ["CONV_GLOBAL_BATCH", "conv_net_flops_per_sample", "model_flops"]
