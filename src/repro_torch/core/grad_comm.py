"""Gradient reduction over the mesh (the reference's
``core/grad_comm.py``, DESIGN.md §4).

A shard's backward leaves each gradient a partial sum: its own samples,
its own depth slab. The train step (``train/train_step.py``) reduces
them over every mesh axis, in one of two lowerings:

* ``monolithic`` — after the backward, one ``psum`` of every leaf
  (``reduce_grads``); the equivalence oracle.
* ``overlap`` (the default) — reduction hooks inside the backward
  (``GradMarker``): the model marks each master parameter at its use,
  ahead of the compute-dtype cast, so that every reduction runs in fp32;
  a marked tensor's cotangent is summed over the mesh as soon as the
  backward has it. Leaves below ``BucketPolicy.small_thresh_elems`` (BN
  scales and biases, FC biases, the small first convs) are coalesced in
  flatten order into flat buckets closed at ``target_bucket_bytes``, so
  that one sum covers many tiny tensors; each big leaf is a bucket of
  its own, hooked at its use site.

Each bucket's hook is one autograd node over every shard
(``spmd.Group.psum_grad``): its backward sums the bucket's flat
cotangent once, in rank order. Both lowerings add the same numbers in
the same order, so they agree to the last bit; the reference's contract
between them is atol 1e-5, rtol 1e-4 after two steps
(``tests/test_grad_comm.py``). ``reduce_scatter`` (ZeRO-1: a sharded
optimizer state) comes with the gradient reduction slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import spmd
from repro_torch.obs import trace as trace_lib

MODES = ("monolithic", "overlap", "reduce_scatter")


def resolve(mode: Optional[str]) -> str:
    """The lowering a ``grad_comm`` setting names: None and ``"auto"``
    are ``overlap`` (the reference's default); ``reduce_scatter``
    raises."""
    mode = "overlap" if mode in (None, "auto") else mode
    if mode not in MODES:
        raise ValueError(f"grad_comm={mode!r}; expected one of {MODES}")
    if mode == "reduce_scatter":
        raise NotImplementedError(
            "grad_comm='reduce_scatter' (ZeRO-1) comes with the gradient "
            "reduction slice of the port")
    return mode


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Size-targeted coalescing: leaves below ``small_thresh_elems``
    share flat buckets, each closed once it holds
    ``target_bucket_bytes``."""

    small_thresh_elems: int = 1 << 15
    target_bucket_bytes: int = 4 << 20

    def is_small(self, size: int) -> bool:
        return size < self.small_thresh_elems


@dataclasses.dataclass(frozen=True)
class Bucket:
    names: Tuple[str, ...]   # leaf names, in flatten (sorted) order
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: torch.dtype
    flat: bool  # True: small leaves, reduced as one concatenated vector

    @property
    def size(self) -> int:
        return sum(math.prod(s) for s in self.shapes)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A parameter tree's leaves partitioned into reduction buckets."""

    buckets: Tuple[Bucket, ...]
    n_leaves: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def make_plan(tree: Mapping[str, torch.Tensor],
              policy: Optional[BucketPolicy] = None) -> Plan:
    """Partition the leaves of ``tree`` (name -> tensor), in
    ``jax.tree`` order (sorted names): a big leaf is a bucket of its
    own; small leaves coalesce, in order, into flat buckets closed at
    ``target_bucket_bytes`` or on a dtype change."""
    policy = policy or BucketPolicy()
    buckets: List[Bucket] = []
    pend: List[str] = []
    pend_shapes: List[Tuple[int, ...]] = []
    pend_bytes = 0
    pend_dtype = None

    def flush():
        nonlocal pend, pend_shapes, pend_bytes, pend_dtype
        if pend:
            buckets.append(Bucket(tuple(pend), tuple(pend_shapes),
                                  pend_dtype, True))
        pend, pend_shapes, pend_bytes, pend_dtype = [], [], 0, None

    for name in sorted(tree):
        leaf = tree[name]
        shape = tuple(leaf.shape)
        size = math.prod(shape)
        if policy.is_small(size):
            if pend and leaf.dtype != pend_dtype:
                flush()
            pend.append(name)
            pend_shapes.append(shape)
            pend_dtype = leaf.dtype
            pend_bytes += size * leaf.element_size()
            if pend_bytes >= policy.target_bucket_bytes:
                flush()
        else:
            buckets.append(Bucket((name,), (shape,), leaf.dtype, False))
    flush()
    return Plan(tuple(buckets), len(tree))


def mark_gradient(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` unchanged; its cotangent is summed over ``axes`` as soon as
    the backward has it. The identity when ``axes`` is empty."""
    axes = tuple(a for a in axes if a)
    if not axes:
        return x
    return spmd.axis(axes).psum_grad((x,))[0]


class GradMarker:
    """Threads the reduction hooks through the model. ``begin(params)``
    (model entry) hooks each flat bucket of small leaves with one node;
    ``mark(x)`` (each use) hooks a big leaf at its use site. Both are
    the identity when ``axes`` is empty. Every parameter the model
    consumes must flow through one of the two, or its gradient misses
    the reduction: ``assert_all_marked`` (the end of the forward)
    raises for a big leaf that never did."""

    def __init__(self, axes: Sequence[str],
                 policy: Optional[BucketPolicy] = None):
        self.axes = tuple(a for a in axes if a)
        self.policy = policy or BucketPolicy()
        self._pending: Dict[int, str] = {}  # id(big leaf) -> its name

    def begin(self, tree: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        if not self.axes:
            return dict(tree)
        plan = make_plan(tree, self.policy)
        trace_lib.count("grad_comm.buckets", plan.num_buckets)
        out = dict(tree)
        group = spmd.axis(self.axes)
        for b in plan.buckets:
            if not b.flat:
                self._pending[id(tree[b.names[0]])] = b.names[0]
                continue
            hooked = group.psum_grad([tree[n] for n in b.names])
            out.update(zip(b.names, hooked))
        return out

    def mark(self, x: torch.Tensor) -> torch.Tensor:
        if not self.axes or self.policy.is_small(x.numel()):
            return x  # no axes, or coalesced and hooked by begin()
        self._pending.pop(id(x), None)
        trace_lib.count("grad_comm.marks")
        return mark_gradient(x, self.axes)

    def assert_all_marked(self) -> None:
        if self._pending:
            raise AssertionError(
                "grad_comm: big parameter leaves never passed through "
                f"GradMarker.mark ({sorted(self._pending.values())}): "
                "their gradients would miss the reduction")


def reduce_grads(grads: Mapping[str, torch.Tensor],
                 axes: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The monolithic lowering: every leaf summed over ``axes`` in rank
    order, all in one exchange."""
    axes = tuple(a for a in axes if a)
    if not axes:
        return dict(grads)
    names = sorted(grads)
    summed = spmd.axis(axes).psum(tuple(grads[n] for n in names))
    return dict(zip(names, summed))


__all__ = ["MODES", "BucketPolicy", "Bucket", "GradMarker", "Plan",
           "make_plan", "mark_gradient", "reduce_grads", "resolve"]
