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
  (``ParallelPlan.uses_remat``), as in the reference.
* ``PIPELINE_LINK_LATENCY_S``: an emulated one-way latency (seconds) of
  the link between pipeline groups, slept on a link thread before each
  cross-group hand-off (``train/train_step.py``), so that a measurement
  can show how much of it each schedule hides. 0.0: no emulation.
"""
from __future__ import annotations

OVERLAP_HALO = True
REMAT = False
PIPELINE_LINK_LATENCY_S = 0.0

__all__ = ["OVERLAP_HALO", "PIPELINE_LINK_LATENCY_S", "REMAT"]
