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

Gradients flow through the statistics as in the reference: the clamped
one-pass variance and the casts back to x's dtype are plain autograd
operations, the statistics' ``psum`` carries the gradients of ``s`` and
``ss`` (its adjoint sums the shards' cotangents, ``core/spmd.py``) with
the count a constant, and the normalize pass is ``bn_ops.bn_act``, whose
backward is autograd of the plain formula. The fp32 sums themselves are
one autograd node (``_Stats``) that saves x, not an fp32 copy of it
(autograd of ``x.float().square()`` would keep one for a 16-bit x), and
whose backward ``ds + 2·x·dss`` is computed in fp32 a piece of x at a
time into one tensor of x's dtype: the values autograd of the two sums
gives (in fp32 x's gradient adds its three terms in another order: ±1
ulp), without its full-size temporaries (at unet3d-256's level 0 each is
4.3 GB).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import spmd
from repro_torch.kernels.bn_act import ops as bn_ops


class _Stats(torch.autograd.Function):
    """(sum, sum of squares) of x in fp32 over every dim but the last;
    x saved as it is, the backward ``ds + 2·x·dss`` in fp32 over pieces
    of at most ``bn_ops.BACKWARD_CHUNK_BYTES`` of x's rows, cast to x's
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        return xf.sum(dim=dims), xf.square().sum(dim=dims)

    @staticmethod
    def backward(ctx, ds, dss):
        (x,) = ctx.saved_tensors
        c = x.shape[-1]
        rows = x.reshape(-1, c)
        dx = torch.empty_like(rows)
        step = max(1, bn_ops.BACKWARD_CHUNK_BYTES // (4 * c))
        for r0 in range(0, rows.shape[0], step):
            xf = rows[r0:r0 + step].float()
            dx[r0:r0 + step] = ds + dss * (2 * xf)
        return dx.view(x.shape)


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
    if torch.is_grad_enabled() and x.requires_grad:
        s, ss = _Stats.apply(x)
    else:
        xf = x.float()
        s, ss = xf.sum(dim=reduce_dims), xf.square().sum(dim=reduce_dims)
    for ax in reduce_axes:
        s, ss, n = spmd.axis(ax).psum((s, ss, n))
    mean = (s / n).to(x.dtype)
    var = torch.clamp(ss / n - torch.square(s / n), min=0.0).to(x.dtype)
    slope = 1.0 if activation_slope is None else activation_slope
    return bn_ops.bn_act(x, mean, var, scale, bias, eps=eps,
                         negative_slope=slope)
