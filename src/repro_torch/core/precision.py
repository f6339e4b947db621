"""Precision policies (the reference's ``core/precision.py``, serving
part).

* ``fp32`` — the numerical oracle: no casts.
* ``bf16`` — activations and the compute copy of the parameters in
  bfloat16; the masters stay fp32.
* ``fp16`` — float16 compute. Its dynamic loss scaling only matters to
  training and comes with the training slice, as do ``MixedPrecision``
  and ``wrap_optimizer``.

Canonical params are always fp32 masters; ``cast_compute`` makes the
compute copy (a serving session does it once at load).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How a run represents activations and parameter compute copies."""

    name: str
    compute_dtype: torch.dtype              # activations + param copies
    master_dtype: torch.dtype = torch.float32

    @property
    def casts_params(self) -> bool:
        return self.compute_dtype != self.master_dtype

    def cast_compute(self, tree: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Float leaves -> compute dtype. Identity (the same dict) for
        fp32."""
        if not self.casts_params:
            return tree
        return {k: (v.to(self.compute_dtype) if v.is_floating_point()
                    else v) for k, v in tree.items()}


FP32 = PrecisionPolicy("fp32", torch.float32)
BF16 = PrecisionPolicy("bf16", torch.bfloat16)
FP16 = PrecisionPolicy("fp16", torch.float16)

POLICIES = {p.name: p for p in (FP32, BF16, FP16)}


def get(policy: Union[str, PrecisionPolicy, None]) -> PrecisionPolicy:
    """Resolve a policy name (or pass a policy through). None -> fp32."""
    if policy is None:
        return FP32
    if isinstance(policy, PrecisionPolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(
            f"precision={policy!r}; expected one of {sorted(POLICIES)}")
    return POLICIES[policy]


__all__ = ["PrecisionPolicy", "FP32", "BF16", "FP16", "POLICIES", "get"]
