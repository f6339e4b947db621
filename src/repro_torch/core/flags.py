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
"""
from __future__ import annotations

OVERLAP_HALO = True
REMAT = False

__all__ = ["OVERLAP_HALO", "REMAT"]
