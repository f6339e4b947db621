"""3-D convolution and pooling on NDHWC activations.

The reference's ``core/spatial_conv.py`` is written for shards of a
spatially partitioned activation, with a halo exchange for every
partitioned dim. On one device every dim is unpartitioned: ``conv3d``
is the SAME-padded conv of the whole volume through the direct conv
kernel (``kernels/conv3d``), with the padding applied inside the kernel
as bounds checks, and ``maxpool3d`` the VALID 2x2x2 max pool. A
partitioned axis raises until the spatial slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import halo as halo_lib
from repro_torch.kernels.conv3d import ops as conv_ops


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


def _require_local(part: SpatialPartitioning, op: str) -> None:
    if part.active:
        raise NotImplementedError(
            f"{op} over partitioned axes {part.names} needs the halo "
            "exchange of the spatial slice of the port")


def conv3d(x: torch.Tensor, w: torch.Tensor, part: SpatialPartitioning,
           stride: int = 1) -> torch.Tensor:
    """SAME-padded 3-D conv. x: (N, D, H, W, Cin); w: (k, k, k, Cin,
    Cout)."""
    _require_local(part, "conv3d")
    lo, hi = halo_lib.conv_halo_widths(w.shape[0], stride)
    return conv_ops.conv3d_valid(x, w, stride=stride, pads=((lo, hi),) * 3)


def maxpool3d(x: torch.Tensor, part: SpatialPartitioning, window: int = 2,
              stride: int = 2) -> torch.Tensor:
    """VALID max pooling with window == stride (the paper's pooling),
    kept in NDHWC: a reshape to (N, D/s, s, H/s, s, W/s, s, C) and a max
    over the window dims, exact in every dtype. The reference computes it
    with XLA's ``reduce_window``, not in a Pallas kernel."""
    _require_local(part, "maxpool3d")
    if window != stride:
        raise NotImplementedError(
            f"maxpool3d takes window == stride; got {window}, {stride}")
    s = stride
    n, d, h, w_, c = x.shape
    x = x[:, :d // s * s, :h // s * s, :w_ // s * s]
    x = x.reshape(n, d // s, s, h // s, s, w_ // s, s, c)
    return x.amax(dim=(2, 4, 6))
