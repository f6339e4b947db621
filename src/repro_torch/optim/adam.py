"""Adam (paper §IV: beta1 0.9, beta2 0.999, eps 1e-8) and SGD with
momentum, as functions of trees of tensors (the reference's
``optim/adam.py``).

The update is functional: it returns new parameter and state tensors and
leaves its inputs as they were, so that a caller can still choose
between the old and the new values afterwards (``MixedPrecision`` skips
an overflowed step that way, ``train/guard.py`` a non-finite one). The
moments and the update arithmetic are fp32 whatever a parameter's
storage dtype; the result is cast back to that dtype.

The schedules map the step count (an int32 tensor) to the learning rate
as an fp32 tensor, in the reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import spmd
from repro_torch.core.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar: updates applied so far
    m: Any
    v: Any


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params: Any) -> torch.Tensor:
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _unscale(grads: Any, grad_scale: Optional[torch.Tensor]) -> Any:
    if grad_scale is None:
        return grads
    inv = 1.0 / grad_scale
    return tree_map(lambda g: g.float() * inv, grads)


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Callable[[torch.Tensor], torch.Tensor]  # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0

    def init(self, params: Any) -> AdamState:
        return AdamState(_step0(params), tree_map(_zeros_f32, params),
                         tree_map(_zeros_f32, params))

    def update(self, grads: Any, state: AdamState, params: Any, *,
               norm_axes: Tuple[str, ...] = (),
               grad_scale: Optional[torch.Tensor] = None,
               leaf_axes: Optional[Sequence[Tuple[str, ...]]] = None
               ) -> Tuple[Any, AdamState]:
        """``grad_scale``: the loss scale the gradients carry (fp16
        training); they are unscaled in fp32 BEFORE the clip norm, so a
        scaled tree is not clipped against an unscaled threshold.
        ``norm_axes``: mesh axes the gradient tree is sharded over; the
        clip norm is summed across them. ``leaf_axes`` (in the tree's
        leaf order): the axes that cut each leaf, where leaves are cut
        differently (``global_norm``)."""
        step = state.step + 1
        grads = _unscale(grads, grad_scale)
        if self.grad_clip > 0:
            gnorm = global_norm(grads, psum_axes=norm_axes,
                                leaf_axes=leaf_axes)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state.m, grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state.v, grads)
        t = step.float()
        mhat_c = 1.0 / (1 - torch.pow(b1, t))
        vhat_c = 1.0 / (1 - torch.pow(b2, t))
        lr = self.lr(step)

        def upd(p, m, v):
            u = (m * mhat_c) / (torch.sqrt(v * vhat_c) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), AdamState(step, m, v)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Callable[[torch.Tensor], torch.Tensor]
    momentum: float = 0.9

    def init(self, params: Any) -> AdamState:
        return AdamState(_step0(params), tree_map(_zeros_f32, params), None)

    def update(self, grads: Any, state: AdamState, params: Any, *,
               norm_axes: Tuple[str, ...] = (),
               grad_scale: Optional[torch.Tensor] = None,
               leaf_axes: Optional[Sequence[Tuple[str, ...]]] = None
               ) -> Tuple[Any, AdamState]:
        del norm_axes, leaf_axes  # SGD has no norm-dependent term
        step = state.step + 1
        grads = _unscale(grads, grad_scale)
        m = tree_map(lambda m, g: self.momentum * m + g.float(),
                     state.m, grads)
        lr = self.lr(step)
        new_params = tree_map(
            lambda p, m: (p.float() - lr * m).to(p.dtype), params, m)
        return new_params, AdamState(step, m, None)


def global_norm(tree: Any, psum_axes: Tuple[str, ...] = (),
                leaf_axes: Optional[Sequence[Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """The l2 norm of every leaf together, in fp32, the squares summed
    leaf by leaf in tree order; with ``psum_axes`` (every leaf a shard's
    block, cut over those axes) summed over them. ``leaf_axes``: each
    leaf's own axes (a shard's block of a tree cut by specs,
    ``core/sharding.py``): each leaf's squares are summed over the axes
    that cut it only, so a leaf whole on every shard counts once, not
    once a shard; the leaves that share axes are summed first, then
    each such sum over its axes (one ``psum`` each)."""
    if leaf_axes is None:
        sq = sum(torch.sum(torch.square(leaf.float()))
                 for leaf in leaves(tree))
        for ax in psum_axes:
            sq = spmd.axis(ax).psum(sq)
        return torch.sqrt(sq)
    sums: dict = {}
    for leaf, axes in zip(leaves(tree), leaf_axes):
        part = torch.sum(torch.square(leaf.float()))
        sums[axes] = part if axes not in sums else sums[axes] + part
    sq = None
    for axes, part in sums.items():
        part = spmd.axis(axes).psum(part) if axes else part
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


# ------------------------------------------------------------ schedules ---
def linear_decay(init_lr: float, total_steps: int,
                 final_frac: float = 0.01) -> Callable:
    """Paper §IV: linear decay to ``final_frac`` of the initial rate."""
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        return init_lr * (1.0 - (1.0 - final_frac) * t)
    return fn


def constant(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak_lr: float, warmup: int, total: int) -> Callable:
    def fn(step):
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * peak_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


__all__ = ["AdamState", "Adam", "SGD", "global_norm", "linear_decay",
           "constant", "warmup_cosine"]
