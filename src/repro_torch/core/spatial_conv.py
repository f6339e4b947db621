"""Spatially distributed 3-D convolution and pooling on NDHWC activations
(the reference's ``core/spatial_conv.py``).

Each op sees the local shard of an activation whose D (and optionally H,
W) dims are partitioned over named mesh axes (``SpatialPartitioning``)
and runs inside ``core.spmd.run``; an axis of size 1 is no partition, so
on one device ``conv3d`` is one launch of the direct conv kernel
(``kernels/conv3d``) with the SAME padding applied inside the kernel.

``conv3d`` has two lowerings for a partitioned dim, chosen per call with
``overlap=`` (None: ``core/flags.OVERLAP_HALO``):

* blocking (the oracle): exchange halos, concatenate them onto the local
  block, run one conv.
* overlapped (default): the packed halo sends are issued first, then the
  *interior* outputs — those whose input windows lie entirely on this
  shard — are computed, then the thin *boundary* pieces that need the
  received slabs, and the three outputs are stitched. The shard's stream
  waits for its neighbours' faces only at the first read of a slab,
  after the interior conv is enqueued, so the interior runs while the
  neighbours are still producing (or copying) them. The interior is
  the depth-VALID conv of the whole local block when the halo's lo width
  is a multiple of the stride (always so for CosmoFlow), so the kernel
  reads the block in place. Where a shard holds no interior (the deep
  layers of an over-decomposed model), the slabs are stitched onto the
  block by the unpack kernel and one conv runs over the result.

Both compute each output from the identical input window, so they agree
to float summation order. The stitch is a ``torch.cat``, one extra copy
of each partitioned block's output.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import flags
from repro_torch.core import halo as halo_lib
from repro_torch.core import spmd
from repro_torch.kernels.conv3d import ops as conv_ops

# dimension indices in NDHWC
_SPATIAL_DIMS = (1, 2, 3)


@dataclasses.dataclass(frozen=True)
class SpatialPartitioning:
    """Which mesh axes shard the D/H/W dims of NDHWC activations.

    ``axes[d]`` is the mesh-axis name sharding spatial dim ``d`` (0=D, 1=H,
    2=W) or None if that dim is unpartitioned."""

    axes: Tuple[Optional[str], Optional[str], Optional[str]] = (None, None, None)

    @property
    def active(self) -> Sequence[Tuple[int, str]]:
        return [(d, a) for d, a in enumerate(self.axes) if a is not None]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a is not None)


def _split_axes(part: SpatialPartitioning) -> List[Tuple[int, str]]:
    """The active (dim, axis) pairs whose axis has more than one shard
    in the current mesh."""
    return [(d, a) for d, a in part.active if spmd.axis(a).size > 1]


def overlap_split(d: int, k: int, s: int) -> Tuple[int, int, int]:
    """(n_out, n_lo, n_hi) of a SAME conv along a partitioned dim of
    local width ``d``: outputs in all, outputs that need the lo slab and
    outputs that need the hi slab. No interior when n_lo + n_hi >= n_out."""
    lo, hi = halo_lib.conv_halo_widths(k, s)
    n_out = (d + lo + hi - k) // s + 1
    n_lo = -(-lo // s)
    n_hi = n_out - 1 - (d - k + lo) // s
    return n_out, n_lo, n_hi


def _conv3d_blocking(x, w, part, stride):
    """The oracle: exchange, concatenate, then one conv."""
    lo, hi = halo_lib.conv_halo_widths(w.shape[0], stride)
    pads = [(lo, hi)] * 3
    for d, axis in _split_axes(part):
        x = halo_lib.halo_exchange(x, axis, _SPATIAL_DIMS[d], lo, hi)
        pads[d] = (0, 0)
    return conv_ops.conv3d_valid(x, w, stride, pads)


def _conv3d_overlap(x, w, part, stride):
    """Interior/boundary decomposition of the last partitioned dim, with
    the packed halo exchange. Earlier partitioned dims are exchanged and
    stitched up front, so the decomposed dim's boundary pieces carry the
    corner halos they need (the paper's configs partition depth only)."""
    k, s = w.shape[0], stride
    lo, hi = halo_lib.conv_halo_widths(k, s)
    active = _split_axes(part)
    pads = [(lo, hi)] * 3
    for d, axis in active:
        pads[d] = (0, 0)
    for d, axis in active[:-1]:
        dim = _SPATIAL_DIMS[d]
        x = halo_lib.unpack_halo(
            x, halo_lib.start_halo_exchange(x, axis, dim, lo, hi), dim)

    d, axis = active[-1]
    dim = _SPATIAL_DIMS[d]
    # comm first; the stream waits for the slabs at their first read,
    # after the interior conv
    slabs = halo_lib.start_halo_exchange(x, axis, dim, lo, hi)
    size = x.shape[dim]
    n_out, n_lo, n_hi = overlap_split(size, k, s)
    if n_lo + n_hi >= n_out:
        # no interior: one conv over the stitched block
        return conv_ops.conv3d_valid(halo_lib.unpack_halo(x, slabs, dim), w,
                                     s, pads)

    # interior: windows [o*s - lo, o*s - lo + k) for o in
    # [n_lo, n_out - n_hi) lie inside the local block
    int_lo = n_lo * s - lo
    int_hi = (n_out - n_hi - 1) * s - lo + k
    x_int = x if int_lo == 0 else x.narrow(dim, int_lo,
                                           int_hi - int_lo).contiguous()
    outs = [conv_ops.conv3d_valid(x_int, w, s, pads)]
    if n_lo > 0:
        x_lo = torch.cat([slabs.lo, x.narrow(dim, 0, (n_lo - 1) * s - lo + k)],
                         dim)
        outs.insert(0, conv_ops.conv3d_valid(x_lo, w, s, pads))
    if n_hi > 0:
        start = (n_out - n_hi) * s - lo
        x_hi = torch.cat([x.narrow(dim, start, size - start), slabs.hi], dim)
        outs.append(conv_ops.conv3d_valid(x_hi, w, s, pads))
    return torch.cat(outs, dim) if len(outs) > 1 else outs[0]


def conv3d(x: torch.Tensor, w: torch.Tensor, part: SpatialPartitioning,
           stride: int = 1, overlap: Optional[bool] = None) -> torch.Tensor:
    """SAME-padded distributed 3-D conv. x: (N, D, H, W, Cin) local shard;
    w: (k, k, k, Cin, Cout) replicated. ``overlap=None`` takes
    ``flags.OVERLAP_HALO``; True/False force the overlapped or blocking
    lowering."""
    if overlap is None:
        overlap = flags.OVERLAP_HALO
    lo, hi = halo_lib.conv_halo_widths(w.shape[0], stride)
    if not overlap or not _split_axes(part) or (lo == 0 and hi == 0):
        return _conv3d_blocking(x, w, part, stride)
    return _conv3d_overlap(x, w, part, stride)


def maxpool3d(x: torch.Tensor, part: SpatialPartitioning, window: int = 2,
              stride: int = 2) -> torch.Tensor:
    """VALID max pooling with window == stride (the paper's pooling), kept
    in NDHWC: a reshape to (N, D/s, s, H/s, s, W/s, s, C) and a max over
    the window dims, exact in every dtype. With window == stride no window
    crosses a shard whose local widths divide the stride, so partitioned
    dims need no halo. The reference computes it with XLA's
    ``reduce_window``, not in a Pallas kernel."""
    if window != stride:
        raise NotImplementedError(
            f"maxpool3d takes window == stride; got {window}, {stride}")
    s = stride
    n, d, h, w_, c = x.shape
    x = x[:, :d // s * s, :h // s * s, :w_ // s * s]
    x = x.reshape(n, d // s, s, h // s, s, w_ // s, s, c)
    return x.amax(dim=(2, 4, 6))


def spatial_allgather(x: torch.Tensor, part: SpatialPartitioning
                      ) -> torch.Tensor:
    """Gather a spatially partitioned activation to a full local copy
    (the CNN -> FC transition of the legacy plan)."""
    for d, axis in part.active:
        x = halo_lib.all_gather_dim(x, axis, _SPATIAL_DIMS[d])
    return x
