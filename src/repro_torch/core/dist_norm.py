"""Distributed batch normalization (the reference's ``core/dist_norm.py``,
paper §III-A).

Per-channel statistics cover the whole mini-batch: each shard sums its
local (count, sum, sumsq) triple, then each of the three is summed over
every mesh axis in ``reduce_axes``, each tensor on its own, as the
reference does: fusing them into one tensor would change the fp32
summation order. (The three travel in one exchange per axis.)
Reducing over an axis along which the stage is replicated is equally
right: every replica holds the same statistics. Normalization uses the
batch's statistics (there are no running stats, also when serving), then
the fused ``kernels/bn_act`` pass applies scale, bias and the leaky-ReLU.

Gradients flow through the statistics as in the reference: the fp32
sums, the clamped one-pass variance and the casts back to x's dtype are
plain autograd operations, the statistics' ``psum`` carries the
gradients of ``s`` and ``ss`` (its adjoint sums the shards' cotangents,
``core/spmd.py``) with the count a constant, and the normalize pass is
``bn_ops.bn_act``, whose backward is autograd of the plain formula.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import spmd
from repro_torch.kernels.bn_act import ops as bn_ops


def distributed_batchnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    reduce_axes: Sequence[str] = (),
    eps: float = 1e-5,
    activation_slope: Optional[float] = None,
) -> torch.Tensor:
    """BatchNorm over all dims but the channel (last) dim of a local
    shard, the statistics summed over the ``reduce_axes`` mesh axes.

    ``activation_slope`` folds the following leaky-ReLU (0.0 = ReLU,
    None = identity) into the normalize pass."""
    reduce_dims = tuple(range(x.dim() - 1))
    n = float(x.numel() // x.shape[-1])
    # statistics in fp32 whatever the activation dtype, one-pass
    # variance clamped at 0 — the reference's arithmetic
    xf = x.float()
    s = xf.sum(dim=reduce_dims)
    ss = xf.square().sum(dim=reduce_dims)
    for ax in reduce_axes:
        s, ss, n = spmd.axis(ax).psum((s, ss, n))
    mean = (s / n).to(x.dtype)
    var = torch.clamp(ss / n - torch.square(s / n), min=0.0).to(x.dtype)
    slope = 1.0 if activation_slope is None else activation_slope
    return bn_ops.bn_act(x, mean, var, scale, bias, eps=eps,
                         negative_slope=slope)
