"""Plain PyTorch versions of the implicit-GEMM 3-D convolution kernel.

``conv3d_valid`` repeats the kernel's function: zero padding, then the
sum over the k^3 filter offsets of (voxels x Cin) @ (Cin x Cout) on the
shifted (strided) input window, accumulated in fp32 and cast to the
input's dtype at the end. The CPU path of ``ops.conv3d_valid`` runs it,
and the card's kernel is held against it.

Beside it, for the tests only (nothing on the main path uses them):
``split_tf32`` and ``conv3d_3xtf32`` emulate the kernel's fp32
arithmetic on the tensor cores, and ``im2col`` gathers a tile of the
GEMM's A matrix by the kernel's index map.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Sequence[Tuple[int, int]]
NO_PADS: Tuple[Tuple[int, int], ...] = ((0, 0),) * 3
_TF32_DROP = 0x1FFF  # the 13 low mantissa bits that TF32 does not keep


def output_shape(x_shape, w_shape, stride: int, pads: Pads):
    """(N, Do, Ho, Wo, Cout) of a VALID conv over the zero-padded
    input."""
    k = w_shape[0]
    n = x_shape[0]
    spatial = tuple((x_shape[1 + d] + pads[d][0] + pads[d][1] - k) // stride
                    + 1 for d in range(3))
    return (n,) + spatial + (w_shape[4],)


def _conv_sum(pairs, k: int, stride: int, pads: Pads, out_shape):
    """The fp32 sum over the taps, and at each tap over ``pairs`` of
    (x, w), of window(x) @ w[tap]."""
    n, do, ho, wo, cout = out_shape
    (pd, qd), (ph, qh), (pw, qw) = pads
    padded = [(F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)), w) for x, w in pairs]
    cin = pairs[0][0].shape[-1]
    acc = torch.zeros(n * do * ho * wo, cout, dtype=torch.float32,
                      device=pairs[0][0].device)
    span = lambda o: (o - 1) * stride + 1  # noqa: E731
    for kd in range(k):
        for kh in range(k):
            for kw in range(k):
                for xp, w in padded:
                    xs = xp[:, kd:kd + span(do):stride,
                            kh:kh + span(ho):stride,
                            kw:kw + span(wo):stride, :]
                    acc.addmm_(xs.reshape(-1, cin).float(),
                               w[kd, kh, kw].float())
    return acc.reshape(n, do, ho, wo, cout)


def conv3d_valid(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pads: Pads = NO_PADS) -> torch.Tensor:
    """x: (N, D, H, W, Cin); w: (k, k, k, Cin, Cout); ``pads`` the
    (lo, hi) zero padding of D, H, W. Returns (N, Do, Ho, Wo, Cout) in
    x's dtype."""
    out = output_shape(x.shape, w.shape, stride, pads)
    return _conv_sum([(x, w)], w.shape[0], stride, pads, out).to(x.dtype)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a (fp32) as hi + lo: hi is a rounded to the nearest TF32 value,
    ties away from zero (``cvt.rna.tf32.f32``); lo is a - hi (exact in
    fp32) truncated to TF32, as the tensor core reads it. What the pair
    drops is below 2^-21 of |a|."""
    bits = a.float().contiguous().view(torch.int32)
    hi = ((bits + (_TF32_DROP + 1) // 2) & ~_TF32_DROP).view(torch.float32)
    lo = ((a.float() - hi).view(torch.int32) & ~_TF32_DROP).view(
        torch.float32)
    return hi, lo


def conv3d_3xtf32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pads: Pads = NO_PADS) -> torch.Tensor:
    """The kernel's fp32 arithmetic: x and w split by ``split_tf32``, and
    the three products hi*w_hi + hi*w_lo + lo*w_hi (each exact in fp32)
    summed per tap in one fp32 accumulator; lo*w_lo is left out. fp32 in
    and out."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    out = output_shape(x.shape, w.shape, stride, pads)
    return _conv_sum([(xh, wh), (xh, wl), (xl, wh)], w.shape[0], stride,
                     pads, out)


def im2col(x: torch.Tensor, k: int, stride: int, pads: Pads,
           rows: Tuple[int, int], cols: Tuple[int, int]) -> torch.Tensor:
    """Rows [rows[0], rows[1]) and columns [cols[0], cols[1]) of the
    implicit GEMM's A matrix, by the kernel's index map: row m is output
    voxel m in (n, d, h, w) order, column kk the tap (kd, kh, kw) =
    kk // Cin in that order and channel kk % Cin, so A @ w.reshape(-1,
    Cout) is the conv. The voxel's window starts at o * stride - pad_lo
    in each dimension; a tap outside x, a row past the last voxel and a
    column past k^3 * Cin read zero."""
    n, d, h, w, cin = x.shape
    _, do, ho, wo, _ = output_shape(x.shape, (k, k, k, cin, 1), stride,
                                    pads)
    m = torch.arange(*rows)
    kk = torch.arange(*cols)
    ow, oh = m % wo, (m // wo) % ho
    od, nn = (m // (wo * ho)) % do, m // (wo * ho * do)
    tap, ci = kk // cin, kk % cin
    kw, kh, kd = tap % k, (tap // k) % k, tap // (k * k)
    pos = [o[:, None] * stride - p[0] + t[None, :]
           for o, p, t in ((od, pads[0], kd), (oh, pads[1], kh),
                           (ow, pads[2], kw))]
    ok = ((m < n * do * ho * wo)[:, None] & (kk < k ** 3 * cin)[None, :])
    for p, size in zip(pos, (d, h, w)):
        ok &= (p >= 0) & (p < size)
    idx = [p.clamp(0, size - 1) for p, size in zip(pos, (d, h, w))]
    vals = x[nn.clamp(max=n - 1)[:, None], idx[0], idx[1], idx[2],
             ci[None, :].expand(len(m), -1)]
    return torch.where(ok, vals, torch.zeros((), dtype=x.dtype))
