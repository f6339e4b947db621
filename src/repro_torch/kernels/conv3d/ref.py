"""Plain PyTorch version of the direct 3-D convolution kernel.

It repeats the kernel's arithmetic: zero padding, then the sum over the
k^3 filter offsets of (voxels x Cin) @ (Cin x Cout) on the shifted
(strided) input window, accumulated in fp32 and cast to the input's
dtype at the end. The CPU path of ``ops.conv3d_valid`` runs it, and the
card's kernel is held against it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Sequence[Tuple[int, int]]
NO_PADS: Tuple[Tuple[int, int], ...] = ((0, 0),) * 3


def output_shape(x_shape, w_shape, stride: int, pads: Pads):
    """(N, Do, Ho, Wo, Cout) of a VALID conv over the zero-padded
    input."""
    k = w_shape[0]
    n = x_shape[0]
    spatial = tuple((x_shape[1 + d] + pads[d][0] + pads[d][1] - k) // stride
                    + 1 for d in range(3))
    return (n,) + spatial + (w_shape[4],)


def conv3d_valid(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pads: Pads = NO_PADS) -> torch.Tensor:
    """x: (N, D, H, W, Cin); w: (k, k, k, Cin, Cout); ``pads`` the
    (lo, hi) zero padding of D, H, W. Returns (N, Do, Ho, Wo, Cout) in
    x's dtype."""
    k = w.shape[0]
    n, do, ho, wo, cout = output_shape(x.shape, w.shape, stride, pads)
    (pd, qd), (ph, qh), (pw, qw) = pads
    xp = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd))
    cin = x.shape[-1]
    acc = torch.zeros(n * do * ho * wo, cout, dtype=torch.float32,
                      device=x.device)
    span = lambda o: (o - 1) * stride + 1  # noqa: E731
    for kd in range(k):
        for kh in range(k):
            for kw in range(k):
                xs = xp[:, kd:kd + span(do):stride, kh:kh + span(ho):stride,
                        kw:kw + span(wo):stride, :]
                acc.addmm_(xs.reshape(-1, cin).float(), w[kd, kh, kw].float())
    return acc.reshape(n, do, ho, wo, cout).to(x.dtype)
