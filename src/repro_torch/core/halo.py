"""Halo exchange for spatially partitioned tensors (the reference's
``core/halo.py``, paper §III-A).

Every function here runs inside ``core.spmd.run``: it sees the local
shard of an activation partitioned contiguously along a mesh axis (shard
``i`` owns ``[i*W_loc, (i+1)*W_loc)``) and exchanges boundary slabs with
its neighbours through the axis group's ``ppermute``.

* ``halo_exchange`` — the blocking exchange: two ``ppermute``s, then the
  halos are concatenated onto the local block. The oracle of the packed
  path.
* ``start_halo_exchange`` / ``unpack_halo`` — the packed exchange behind
  the interior/boundary conv (``core/spatial_conv.py``). Along depth of
  an NDHWC tensor both send faces come out of ONE launch of the pack
  kernel (``kernels/halo_pack``) into one buffer, and the received slabs
  are stitched by one launch of the unpack kernel. The exchange uses the
  fewest ``ppermute``s: one swap of the whole pack buffer on a 2-way axis
  (both neighbours are the same shard), otherwise one shift in each
  direction.

A shard at the global boundary receives zeros (SAME-conv padding), as
``ppermute``'s unpaired destinations give them in the reference (whose
``wrap`` option, unused by any model, is not ported).
``halo.exchanges`` and ``halo.ppermutes`` are counted on the active
tracer (``obs/trace``) once per shard and call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import spmd
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.obs import trace as trace_lib


def _shift_perm(n: int, direction: int):
    """Pairs (src, dst) shifting data by ``direction`` (+1: to next rank)."""
    if direction > 0:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i + 1, i) for i in range(n - 1)]


def _rows(x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(dim, start, stop - start)


def halo_exchange(x: torch.Tensor, axis_name: str, dim: int, lo: int,
                  hi: int) -> torch.Tensor:
    """Pad local shard ``x`` along ``dim`` with neighbour boundary slabs:
    ``lo`` rows from the previous rank (its trailing slab) and ``hi``
    rows from the next rank (its leading slab). Returns the padded block
    of ``W_loc + lo + hi`` rows; global-boundary ranks receive zeros."""
    if lo == 0 and hi == 0:
        return x
    g = spmd.axis(axis_name)
    n = g.size
    parts = []
    if lo > 0:
        send = _rows(x, dim, x.shape[dim] - lo, x.shape[dim]).contiguous()
        parts.append(g.ppermute(send, _shift_perm(n, +1)))
    parts.append(x)
    if hi > 0:
        send = _rows(x, dim, 0, hi).contiguous()
        parts.append(g.ppermute(send, _shift_perm(n, -1)))
    return torch.cat(parts, dim)


class HaloSlabs:
    """Received boundary slabs along one dim: ``lo`` came from the
    previous rank (width = halo lo), ``hi`` from the next rank (width =
    halo hi). None means that side needs no halo. A slab from a peer is
    made ready on this shard's stream at its first read, so the work the
    shard enqueues before that read (the interior conv) does not wait for
    the peer."""

    __slots__ = ("_lo", "_hi")

    def __init__(self, lo, hi):
        self._lo, self._hi = lo, hi  # each None, a tensor or spmd.Received

    @property
    def lo(self) -> Optional[torch.Tensor]:
        return _ready(self._lo)

    @property
    def hi(self) -> Optional[torch.Tensor]:
        return _ready(self._hi)


def _ready(slab):
    return slab.wait() if isinstance(slab, spmd.Received) else slab


def _extract_faces(x: torch.Tensor, dim: int, lo: int, hi: int):
    """Send slabs: (pack buffer or None, to_next, to_prev). The trailing
    ``lo`` rows go to the next rank (its lo halo), the leading ``hi``
    rows to the previous rank. Along depth of an NDHWC tensor both come
    out of one launch of the pack kernel into one buffer; along another
    dim they are two contiguous copies."""
    if dim == 1 and x.dim() == 5:
        faces = pack_ops.pack(x, lo, hi)
        return faces.buf, faces.to_next, faces.to_prev
    to_next = (_rows(x, dim, x.shape[dim] - lo, x.shape[dim]).contiguous()
               if lo else None)
    to_prev = _rows(x, dim, 0, hi).contiguous() if hi else None
    return None, to_next, to_prev


def start_halo_exchange(x: torch.Tensor, axis_name: str, dim: int, lo: int,
                        hi: int) -> HaloSlabs:
    """Send ``x``'s boundary slabs along ``dim`` and return the received
    slabs without stitching them onto the local block — the comm half of
    the interior/boundary decomposition; this shard's stream waits for
    its neighbours at the first read of a slab. Zero ``ppermute``s when
    no halo is needed, ONE on a 2-way axis (the whole pack buffer
    swapped with the only neighbour), otherwise one per direction."""
    if lo == 0 and hi == 0:
        return HaloSlabs(None, None)
    g = spmd.axis(axis_name)
    n = g.size
    trace_lib.count("halo.exchanges")

    def zeros(width: int) -> torch.Tensor:
        shape = x.shape[:dim] + (width,) + x.shape[dim + 1:]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    if n == 1:
        return HaloSlabs(zeros(lo) if lo else None, zeros(hi) if hi else None)
    buf, to_next, to_prev = _extract_faces(x, dim, lo, hi)

    if n == 2:
        # both neighbours are the same peer: swap [to_next | to_prev]
        # whole; recv = [peer's trailing lo rows | peer's leading hi rows]
        if buf is None:
            parts = [p for p in (to_next, to_prev) if p is not None]
            buf = torch.cat([p.reshape(-1) for p in parts])
        trace_lib.count("halo.ppermutes")
        recv = g.ppermute_start(buf, [(0, 1), (1, 0)])
        row = x.numel() // x.shape[dim]
        shape = x.shape[:dim] + (-1,) + x.shape[dim + 1:]
        i = g.index

        def part(start, stop):
            return spmd.Received(lambda: recv.wait()[start:stop].view(shape))

        recv_lo = recv_hi = None
        if lo:
            # only rank 1 has a previous rank; rank 0 sits on the boundary
            recv_lo = part(0, lo * row) if i == 1 else zeros(lo)
        if hi:
            recv_hi = part(lo * row, None) if i == 0 else zeros(hi)
        return HaloSlabs(recv_lo, recv_hi)

    recv_lo = recv_hi = None
    if lo > 0:
        trace_lib.count("halo.ppermutes")
        recv_lo = g.ppermute_start(to_next, _shift_perm(n, +1))
    if hi > 0:
        trace_lib.count("halo.ppermutes")
        recv_hi = g.ppermute_start(to_prev, _shift_perm(n, -1))
    return HaloSlabs(recv_lo, recv_hi)


def unpack_halo(x: torch.Tensor, slabs: HaloSlabs, dim: int) -> torch.Tensor:
    """Stitch received slabs around the local block: [lo | x | hi]. Along
    depth of an NDHWC tensor one launch of the unpack kernel writes the
    padded buffer."""
    if slabs.lo is None and slabs.hi is None:
        return x
    if dim == 1 and x.dim() == 5:
        return pack_ops.unpack(x, slabs.lo, slabs.hi)
    parts = [p for p in (slabs.lo, x, slabs.hi) if p is not None]
    return torch.cat(parts, dim)


def conv_halo_widths(kernel: int, stride: int) -> Tuple[int, int]:
    """Halo widths (lo, hi) for a SAME conv with ``kernel``/``stride``.

    Assumes the global width and every local shard width are divisible by
    ``stride``. Matches XLA SAME padding: total = kernel - stride (k >= s),
    lo = total // 2, hi = total - lo.
    """
    total = max(kernel - stride, 0)
    lo = total // 2
    return lo, total - lo


def all_gather_dim(x: torch.Tensor, axis_name: str, dim: int
                   ) -> torch.Tensor:
    """All-gather shards along ``dim`` (the degenerate 'halo = whole
    domain' case: the CNN -> FC gather)."""
    return spmd.axis(axis_name).all_gather(x, dim)


__all__ = ["HaloSlabs", "all_gather_dim", "conv_halo_widths",
           "halo_exchange", "start_halo_exchange", "unpack_halo"]
