"""Activation resharding at parallelism-plan stage boundaries (the
reference's ``core/reshard.py``).

When a ``ParallelPlan`` changes layout between two stages, the activation
moves from one partitioning to the other inside ``core.spmd.run``:

* **spatial -> batch** (``spatial_to_batch``): the spatial group's slabs
  become batch shards by ONE ``all_to_all`` (``spmd.Group.all_to_all``):
  rank j keeps chunk j of its local batch and receives chunk j of every
  peer's, concatenated along the split dim in rank order, so that it
  holds the full volume of 1/n of the local batch and the following
  layers run data parallel with no redundant compute.
  ``spatial_to_batch_oracle`` lands the same block by a gather and a
  slice.
* **batch -> spatial** (``batch_to_spatial``): the reverse
  ``all_to_all``, which brings the U-Net's ascent back to its encoder
  level's layout so that the skip concat stays local.
* **spatial -> replicated** (``spatial_to_replicated``): every shard
  gathers the full tensor and the following layers run redundantly
  across the spatial group — the legacy plan's gather before the deep
  blocks and the FC head.
* **replicated -> spatial** (``replicated_to_spatial``): a local slice.

Every transition carries gradients: the all_to_all's adjoint is the
reverse all_to_all, the gather's a reduce-scatter (``core/spmd.py``),
and the slice's gradient is zero outside the slab (autograd of
``narrow``). On one device an all_to_all is a copy.

``apply`` lowers the delta between two ``Stage``s to one transition per
spatial dim, in D/H/W order, slices the per-sample ids through batch
moves (so that CosmoFlow's per-sample dropout masks do not depend on
the plan), and counts ``reshard.transitions`` on the active tracer.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, TypeVar

import torch

from repro_torch.core import halo as halo_lib
from repro_torch.core import spmd
from repro_torch.obs import trace as trace_lib

# dimension indices in NDHWC (batch is 0)
_SPATIAL_DIMS = (1, 2, 3)
Rows = TypeVar("Rows")  # a tensor or a sequence of sample ids


def spatial_to_batch(x: torch.Tensor, axis_name: str, dim: int
                     ) -> torch.Tensor:
    """Spatial shards along ``dim`` -> batch shards: rank j receives
    batch chunk j from every rank, concatenated along ``dim`` in rank
    order (the full extent of ``dim`` for 1/n of the local batch).
    Needs the local batch to divide by n."""
    g = spmd.axis(axis_name)
    if g.size == 1:
        return x
    if x.shape[0] % g.size:
        raise ValueError(
            f"spatial_to_batch: local batch {x.shape[0]} not divisible by "
            f"{g.size}-way axis {axis_name!r}")
    return g.all_to_all(x, 0, dim)


def batch_to_spatial(x: torch.Tensor, axis_name: str, dim: int
                     ) -> torch.Tensor:
    """The inverse of ``spatial_to_batch``: batch shards -> spatial
    slabs along ``dim``."""
    g = spmd.axis(axis_name)
    if g.size == 1:
        return x
    if x.shape[dim] % g.size:
        raise ValueError(
            f"batch_to_spatial: dim {dim} extent {x.shape[dim]} not "
            f"divisible by {g.size}-way axis {axis_name!r}")
    return g.all_to_all(x, dim, 0)


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


def spatial_to_batch_oracle(x: torch.Tensor, axis_name: str, dim: int
                            ) -> torch.Tensor:
    """``spatial_to_batch`` by a gather of the whole tensor and a slice
    of this rank's batch chunk: n times the bytes, the same block."""
    g = spmd.axis(axis_name)
    if g.size == 1:
        return x
    full = halo_lib.all_gather_dim(x, axis_name, dim)
    chunk = x.shape[0] // g.size
    return full.narrow(0, g.index * chunk, chunk).contiguous()


def shard_batch(rows: Rows, axes: Sequence[str]) -> Rows:
    """This rank's chunk of a tensor (or a sequence of sample ids) whose
    batch was never spatially sharded, after the batch was extended over
    ``axes`` (in transition order): the companion of
    ``spatial_to_batch`` for CosmoFlow's targets and sample ids."""
    for a in axes:
        g = spmd.axis(a)
        if g.size == 1:
            continue
        chunk = len(rows) // g.size
        rows = rows[g.index * chunk:(g.index + 1) * chunk]
    return rows


def apply(h: torch.Tensor, src, dst, *,
          sample_ids: Optional[Sequence[int]] = None,
          oracle: bool = False
          ) -> Tuple[torch.Tensor, Optional[Sequence[int]]]:
    """Reshard ``h`` from stage ``src``'s layout to stage ``dst``'s
    (``core.plan.Stage``s). Per spatial dim, in D/H/W order: an axis that
    leaves the spatial side and joins ``dst.batch_axes`` is a
    spatial -> batch move (the all-gather ``oracle`` if asked), and
    ``sample_ids`` are cut to the local chunk; otherwise a gather. An
    axis that joins the spatial side from ``src.batch_axes`` is a
    batch -> spatial move (the ids, which would need a gather, become
    None: nothing reads them past an ascent); otherwise a local slice.
    Returns ``(h, sample_ids)``."""
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
                move = spatial_to_batch_oracle if oracle else spatial_to_batch
                h = move(h, a_src, dim)
                if sample_ids is not None:
                    sample_ids = shard_batch(sample_ids, (a_src,))
            else:
                h = spatial_to_replicated(h, a_src, dim)
        elif a_dst in src.batch_axes and a_dst not in dst.batch_axes:
            h = batch_to_spatial(h, a_dst, dim)
            sample_ids = None
        else:
            h = replicated_to_spatial(h, a_dst, dim)
        trace_lib.count("reshard.transitions")
    return h, sample_ids


__all__ = ["apply", "batch_to_spatial", "replicated_to_spatial",
           "shard_batch", "spatial_to_batch", "spatial_to_batch_oracle",
           "spatial_to_replicated"]
