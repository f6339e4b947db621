"""Plain PyTorch versions of the halo pack and unpack kernels.

``pack`` writes the two send faces of a shard into one flat buffer,
``[to_next | to_prev]``: first the trailing ``lo`` depth rows of every
sample (the next shard's lo halo), then the leading ``hi`` rows (the
previous shard's hi halo). ``faces`` views such a buffer, sent or
received, as its two parts. ``unpack`` stitches ``[lo_buf | x |
hi_buf]`` along depth. Both are copies, so the kernels must match them
bit for bit. The CPU path of ``ops`` runs them, and the card's kernels
are held against them.

Naming: the reference's ``pack`` returns ``(lo_face, hi_face)`` with
``lo_face`` = the LEADING ``hi`` rows and ``hi_face`` = the TRAILING
``lo`` rows (``repro/kernels/halo_pack/ops.py``). Here the parts are
named by where they go: ``to_next`` and ``to_prev``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class PackedFaces(NamedTuple):
    """One pack buffer and its two contiguous parts (None where the
    width is 0). ``buf`` is what a swap with the single neighbour of a
    2-way axis sends whole."""

    buf: torch.Tensor                  # flat: [to_next | to_prev]
    to_next: Optional[torch.Tensor]    # (N, lo, H, W, C)
    to_prev: Optional[torch.Tensor]    # (N, hi, H, W, C)


def faces(buf: torch.Tensor, shape: Sequence[int], lo: int,
          hi: int) -> PackedFaces:
    """The parts of the pack buffer of an (N, D, H, W, C) ``shape`` as
    views of ``buf``."""
    n, _, h, w, c = shape
    a = n * lo * h * w * c
    b = n * hi * h * w * c
    to_next = buf[:a].view(n, lo, h, w, c) if lo else None
    to_prev = buf[a:a + b].view(n, hi, h, w, c) if hi else None
    return PackedFaces(buf, to_next, to_prev)


def pack(x: torch.Tensor, lo: int, hi: int) -> PackedFaces:
    """x: (N, D, H, W, C) -> the pack buffer of its trailing ``lo`` and
    leading ``hi`` depth rows, one copy per face."""
    n, d, h, w, c = x.shape
    buf = torch.empty(n * (lo + hi) * h * w * c, dtype=x.dtype,
                      device=x.device)
    out = faces(buf, x.shape, lo, hi)
    if lo:
        out.to_next.copy_(x[:, d - lo:])
    if hi:
        out.to_prev.copy_(x[:, :hi])
    return out


def unpack(x: torch.Tensor, lo_buf: Optional[torch.Tensor],
           hi_buf: Optional[torch.Tensor]) -> torch.Tensor:
    """[lo_buf | x | hi_buf] along depth (dim 1), one copy per part;
    a None buffer is a width of 0."""
    n, d, h, w, c = x.shape
    lo = 0 if lo_buf is None else lo_buf.shape[1]
    hi = 0 if hi_buf is None else hi_buf.shape[1]
    out = torch.empty((n, lo + d + hi, h, w, c), dtype=x.dtype,
                      device=x.device)
    if lo:
        out[:, :lo].copy_(lo_buf)
    out[:, lo:lo + d].copy_(x)
    if hi:
        out[:, lo + d:].copy_(hi_buf)
    return out

