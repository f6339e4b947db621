"""Guarded stepping: agreed non-finite detection (the reference's
``train/guard.py``).

fp16 already skips overflowed steps inside ``MixedPrecision``; the guard
gives every precision that net. A step whose loss or any gradient is not
finite is not applied: parameters and optimizer state are held exactly
(a select against the previous values, bitwise), and under fp16 the
verdict is routed through the skip machine by poisoning the gradients,
so that the loss scale still backs off. With finite values the guard
changes nothing: ``where(True, new, old)`` is ``new``.

The verdict is summed over the mesh axes given (``core/spmd.py``): the
train step passes every axis of its mesh, so that every shard takes the
same decision.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core import precision as precision_lib
from repro_torch.core import spmd
from repro_torch.core.tree import tree_map


def agreed_finite(loss: torch.Tensor, grads: Any,
                  axes: Sequence[str] = ()) -> torch.Tensor:
    """Scalar bool tensor, the same on every shard: the (already summed)
    loss is finite and no shard holds a non-finite gradient leaf."""
    ok_local = precision_lib.all_finite(grads).to(loss.device)
    bad = torch.where(ok_local, 0.0, 1.0)
    for ax in axes:
        bad = spmd.axis(ax).psum(bad)
    return torch.logical_and(torch.isfinite(loss), bad == 0.0)


def tree_select(flag: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where ``flag`` else ``old``, leafwise: the values of the
    branch taken pass through bitwise (NaNs of the other do not)."""
    return tree_map(lambda a, b: torch.where(flag, a, b), new, old)


def poison_unless(flag: torch.Tensor, grads: Any) -> Any:
    """NaN every gradient leaf unless ``flag``: hands a loss veto to
    ``MixedPrecision``'s own skip machine."""
    return tree_map(lambda g: torch.where(flag, g, torch.full_like(
        g, float("nan"))), grads)


__all__ = ["agreed_finite", "tree_select", "poison_unless"]
