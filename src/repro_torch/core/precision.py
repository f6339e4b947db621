"""Precision policies and the mixed-precision optimizer wrapper (the
reference's ``core/precision.py``).

* ``fp32`` — the numerical oracle: no casts, no scaling.
* ``bf16`` — activations and the compute copy of the parameters in
  bfloat16; the masters stay fp32. bf16 has fp32's exponent range, so
  there is no loss scaling; gradients come back fp32 through the casts.
* ``fp16`` — float16 compute with dynamic loss scaling: the loss is
  multiplied by a running power-of-two scale before the backward, the
  gradients are unscaled before clipping (``optim/adam.py``), and a
  non-finite gradient skips the step (parameters, moments and step count
  all held) and halves the scale; ``growth_interval`` finite steps in a
  row double it again.

Canonical params are always fp32 masters; ``cast_compute`` makes the
compute copy (a serving session does it once at load). ``MixedPrecision``
wraps an optimizer with the scale/skip machine; ``wrap_optimizer``
leaves fp32 and bf16 optimizers unwrapped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.core import spmd
from repro_torch.core.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How a run represents activations and parameter compute copies."""

    name: str
    compute_dtype: torch.dtype              # activations + param copies
    master_dtype: torch.dtype = torch.float32
    loss_scale: float = 1.0                 # initial (and static) scale
    dynamic_scale: bool = False             # halve on overflow, grow clean
    growth_interval: int = 200              # finite steps before doubling
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    max_loss_scale: float = 2.0 ** 24

    @property
    def uses_scaling(self) -> bool:
        return self.dynamic_scale or self.loss_scale != 1.0

    @property
    def act_bytes(self) -> int:
        """Bytes of one activation element (the compute dtype's)."""
        return self.compute_dtype.itemsize

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
FP16 = PrecisionPolicy("fp16", torch.float16, loss_scale=2.0 ** 15,
                       dynamic_scale=True)

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


def all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool tensor: every float leaf of ``tree`` is finite."""
    ok = None
    for leaf in leaves(tree):
        if leaf.is_floating_point():
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else torch.logical_and(ok, f)
    return torch.tensor(True) if ok is None else ok


class MPState(NamedTuple):
    """Optimizer state under ``MixedPrecision``: the inner optimizer's
    state and the dynamic loss-scale machine."""

    inner: Any
    loss_scale: torch.Tensor   # f32 scalar
    good_steps: torch.Tensor   # int32: finite steps since the last change


def current_scale(opt_state: Any, policy: PrecisionPolicy) -> torch.Tensor:
    """The loss scale a step applies: the state's running scale when the
    optimizer is wrapped, else the policy's static scale."""
    if isinstance(opt_state, MPState):
        return opt_state.loss_scale
    return torch.tensor(policy.loss_scale, dtype=torch.float32)


def next_scale(policy: PrecisionPolicy, state: MPState,
               finite: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_scale, new_good_steps) after one step with ``finite``
    gradients."""
    if not policy.dynamic_scale:
        return state.loss_scale, state.good_steps
    grown = state.good_steps + 1 >= policy.growth_interval
    scale_up = torch.where(
        grown, torch.clamp(state.loss_scale * policy.growth_factor,
                           max=policy.max_loss_scale),
        state.loss_scale)
    new_scale = torch.where(finite, scale_up, torch.clamp(
        state.loss_scale * policy.backoff_factor, min=1.0))
    new_good = torch.where(torch.logical_and(finite, ~grown),
                           state.good_steps + 1,
                           torch.zeros_like(state.good_steps))
    return new_scale, new_good.to(state.good_steps.dtype)


@dataclasses.dataclass(frozen=True)
class MixedPrecision:
    """Optimizer wrapper: unscale before the clip, skip on overflow.

    ``update`` hands the current loss scale to the inner optimizer as
    ``grad_scale``, then keeps the updated or the previous (params,
    inner state) by the finiteness of the incoming gradients, so an
    overflowed fp16 step advances nothing, not even the step count, and
    only moves the loss scale down. ``norm_axes`` are also the axes the
    finite verdict is agreed over."""

    inner: Any
    policy: PrecisionPolicy

    def init(self, params: Any) -> MPState:
        dev = leaves(params)[0].device
        return MPState(self.inner.init(params),
                       torch.tensor(self.policy.loss_scale,
                                    dtype=torch.float32, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, grads: Any, state: MPState, params: Any, *,
               norm_axes: Tuple[str, ...] = ()) -> Tuple[Any, MPState]:
        finite = all_finite(grads)
        for ax in norm_axes:
            bad = spmd.axis(ax).psum(1.0 - finite.float())
            finite = bad == 0.0
        scale = state.loss_scale if self.policy.uses_scaling else None
        new_params, new_inner = self.inner.update(
            grads, state.inner, params, norm_axes=norm_axes,
            grad_scale=scale)

        def keep(new, old):
            return tree_map(lambda a, b: torch.where(finite, a, b), new, old)

        new_scale, new_good = next_scale(self.policy, state, finite)
        return keep(new_params, params), MPState(
            keep(new_inner, state.inner), new_scale, new_good)


def wrap_optimizer(optimizer: Any,
                   policy: Union[str, PrecisionPolicy, None]) -> Any:
    """Wrap for policies that need the scale/skip machine (fp16); the
    identity for fp32/bf16 and for an optimizer already wrapped."""
    policy = get(policy)
    if not policy.uses_scaling or isinstance(optimizer, MixedPrecision):
        return optimizer
    return MixedPrecision(optimizer, policy)


__all__ = ["PrecisionPolicy", "FP32", "BF16", "FP16", "POLICIES", "get",
           "all_finite", "MPState", "MixedPrecision", "wrap_optimizer",
           "current_scale", "next_scale"]
