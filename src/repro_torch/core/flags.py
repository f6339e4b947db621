"""Lowering defaults (the reference's ``core/flags.py``, the part the port
reads so far).

* ``OVERLAP_HALO``: lower distributed convs through the interior/boundary
  decomposition with a packed halo exchange (``core/spatial_conv.py``)
  instead of the blocking exchange-concat-conv. On by default; the
  blocking path stays as the equivalence oracle. A run chooses with
  ``RunConfig.overlap_halo`` (None: this default), a call with
  ``conv3d(..., overlap=)``.
* ``REMAT``: rematerialize every conv block in training (each block's
  activations recomputed in the backward, ``core/spmd.checkpoint``).
  Off by default. The models read it only for a plan that marks no
  stage: a plan whose stages set ``remat`` wins outright
  (``ParallelPlan.uses_remat``), as in the reference. The language
  models read it through ``maybe_remat``, where the reference wraps a
  layer body in ``jax.checkpoint``: each Mamba2 block, each transformer
  layer (or local/global pair), not Zamba2's shared attention block.
* ``EP_ALLTOALL``: under the ``ep`` plan, a MoE layer whose experts cut
  over the model axis dispatches each shard's own tokens and moves them
  to and from their experts' shards by two ``all_to_all``s
  (``models/moe.moe_ffn_ep``); off, it routes the gathered global tokens
  as ``moe_ffn`` does. On by default.
* ``PIPELINE_LINK_LATENCY_S``: an emulated one-way latency (seconds) of
  the link between pipeline groups, slept on a link thread before each
  cross-group hand-off (``train/train_step.py``), so that a measurement
  can show how much of it each schedule hides. 0.0: no emulation.
"""
from __future__ import annotations

from typing import Callable

OVERLAP_HALO = True
REMAT = False
PIPELINE_LINK_LATENCY_S = 0.0
EP_ALLTOALL = True


def maybe_remat(fn: Callable) -> Callable:
    """``fn`` (tensors in; a tensor or a tuple of tensors out)
    rematerialized when ``REMAT`` is set (read at this call), else
    ``fn`` itself: its activations are dropped after the forward and
    recomputed, kernels included, when the backward reaches it. Inside
    an ``spmd.run`` through ``spmd.checkpoint``, whose recompute meets
    every shard's collectives again; outside one through
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
    whose recompute runs in the backward's thread, where every mesh axis
    has size 1 (inside a run, a psum after ``wo`` or cp_attention's
    gather would recompute as a local operation, with no error)."""
    if not REMAT:
        return fn
    from repro_torch.core import spmd

    def remat(*tensors):
        if spmd.current_mesh() is not None:
            return spmd.checkpoint(fn, *tensors)
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *tensors, use_reentrant=False)
    return remat


__all__ = ["EP_ALLTOALL", "OVERLAP_HALO", "PIPELINE_LINK_LATENCY_S", "REMAT",
           "maybe_remat"]
