"""Halo widths for spatially-partitioned convolutions.

Only ``conv_halo_widths`` so far: on one device it gives the SAME zero
padding of every unpartitioned dim. The halo exchange over
``torch.distributed`` (and the ``halo_pack`` kernels) comes with the
spatial slice.
"""
from __future__ import annotations

from typing import Tuple


def conv_halo_widths(kernel: int, stride: int) -> Tuple[int, int]:
    """Halo widths (lo, hi) for a SAME conv with ``kernel``/``stride``.

    Assumes the global width and every local shard width are divisible by
    ``stride``. Matches XLA SAME padding: total = kernel - stride (k >= s),
    lo = total // 2, hi = total - lo.
    """
    total = max(kernel - stride, 0)
    lo = total // 2
    return lo, total - lo
