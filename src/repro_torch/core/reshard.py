"""Activation resharding at parallelism-plan stage boundaries (the
reference's ``core/reshard.py``).

When a ``ParallelPlan`` changes layout between two stages, the activation
moves from one partitioning to the other inside ``core.spmd.run``:

* **spatial -> replicated** (``spatial_to_replicated``): every shard
  gathers the full tensor and the following layers run redundantly
  across the spatial group — the legacy plan's gather before the deep
  blocks and the FC head.
* **replicated -> spatial** (``replicated_to_spatial``): a local slice.
* **spatial <-> batch** (the ``all_to_all`` repartitions of the planned
  layouts) raise: they come with the plans slice of the port. The fixed
  legacy plan never reaches them, whatever its data degree: every stage
  carries the data axes as batch axes.

Both transitions carry gradients: the gather's adjoint is a
reduce-scatter (``core/spmd.py``), and the slice's gradient is zero
outside the slab (autograd of ``narrow``).

``apply`` lowers the delta between two ``Stage``s to one transition per
spatial dim, in D/H/W order, and counts ``reshard.transitions`` on the
active tracer.
"""
from __future__ import annotations

import torch

from repro_torch.core import halo as halo_lib
from repro_torch.core import spmd
from repro_torch.obs import trace as trace_lib

# dimension indices in NDHWC (batch is 0)
_SPATIAL_DIMS = (1, 2, 3)


def spatial_to_replicated(x: torch.Tensor, axis_name: str, dim: int
                          ) -> torch.Tensor:
    """Gather spatial shards to a full local copy."""
    return halo_lib.all_gather_dim(x, axis_name, dim)


def replicated_to_spatial(x: torch.Tensor, axis_name: str, dim: int
                          ) -> torch.Tensor:
    """Slice this rank's slab out of a replicated tensor (local)."""
    g = spmd.axis(axis_name)
    if g.size == 1:
        return x
    w = x.shape[dim] // g.size
    return x.narrow(dim, g.index * w, w).contiguous()


def spatial_to_batch(x: torch.Tensor, axis_name: str, dim: int):
    raise NotImplementedError(
        "spatial -> batch resharding (an all_to_all, reached only by "
        "planned layouts) comes with the plans slice of the port")


def batch_to_spatial(x: torch.Tensor, axis_name: str, dim: int):
    raise NotImplementedError(
        "batch -> spatial resharding (an all_to_all, reached only by "
        "planned layouts) comes with the plans slice of the port")


def apply(h: torch.Tensor, src, dst) -> torch.Tensor:
    """Reshard ``h`` from stage ``src``'s layout to stage ``dst``'s
    (``core.plan.Stage``s). Per spatial dim, in D/H/W order: an axis that
    leaves the spatial side and joins ``dst.batch_axes`` is a
    spatial -> batch move, otherwise a gather; an axis that joins it
    from ``src.batch_axes`` is a batch -> spatial move, otherwise a
    local slice."""
    for d in range(3):
        a_src, a_dst = src.spatial_axes[d], dst.spatial_axes[d]
        dim = _SPATIAL_DIMS[d]
        if a_src == a_dst:
            continue
        if a_src is not None and a_dst is not None:
            raise ValueError(
                f"unsupported transition: dim {d} moves between spatial "
                f"axes {a_src!r} -> {a_dst!r} (re-partitioning a dim onto "
                "a different axis is not a plan transition)")
        if a_src is not None:
            if a_src in dst.batch_axes and a_src not in src.batch_axes:
                h = spatial_to_batch(h, a_src, dim)
            else:
                h = spatial_to_replicated(h, a_src, dim)
        elif a_dst in src.batch_axes and a_dst not in dst.batch_axes:
            h = batch_to_spatial(h, a_dst, dim)
        else:
            h = replicated_to_spatial(h, a_dst, dim)
        trace_lib.count("reshard.transitions")
    return h


__all__ = ["apply", "batch_to_spatial", "replicated_to_spatial",
           "spatial_to_batch", "spatial_to_replicated"]
