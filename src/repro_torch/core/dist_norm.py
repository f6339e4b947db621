"""Batch normalization with the statistics of the reference's
``core/dist_norm.py`` (paper §III-A), on one device.

The per-channel (count, sum, sumsq) triple is what a multi-device run
all-reduces over every axis that shards N/D/H/W; with one device there
is nothing to reduce, so non-empty ``reduce_axes`` raise until the
spatial slice brings ``torch.distributed``. Normalization uses the
batch's statistics (there are no running stats, also when serving),
then the fused ``kernels/bn_act`` pass applies scale, bias and the
leaky-ReLU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.bn_act import ops as bn_ops


def distributed_batchnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    reduce_axes: Sequence[str] = (),
    eps: float = 1e-5,
    activation_slope: Optional[float] = None,
) -> torch.Tensor:
    """BatchNorm over all dims but the channel (last) dim of x.

    ``activation_slope`` folds the following leaky-ReLU (0.0 = ReLU,
    None = identity) into the normalize pass."""
    if reduce_axes:
        raise NotImplementedError(
            f"statistics reduction over {tuple(reduce_axes)} needs the "
            "multi-device (spatial) slice of the port")
    reduce_dims = tuple(range(x.dim() - 1))
    n = float(x.numel() // x.shape[-1])
    # statistics in fp32 whatever the activation dtype, one-pass
    # variance clamped at 0 — the reference's arithmetic
    xf = x.float()
    s = xf.sum(dim=reduce_dims)
    ss = xf.square().sum(dim=reduce_dims)
    mean = (s / n).to(x.dtype)
    var = torch.clamp(ss / n - torch.square(s / n), min=0.0).to(x.dtype)
    slope = 1.0 if activation_slope is None else activation_slope
    return bn_ops.bn_leaky_relu(x, mean, var, scale, bias, eps=eps,
                                negative_slope=slope)
