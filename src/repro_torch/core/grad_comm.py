"""Gradient reduction over the mesh (the reference's
``core/grad_comm.py``, DESIGN.md §4).

A shard's backward leaves each gradient a partial sum: its own samples,
its own depth slab. The train step (``train/train_step.py``) reduces
them over every mesh axis, in one of three lowerings:

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
* ``reduce_scatter`` — ZeRO-1: the hooks reduce over the spatial axes
  only; after the backward each bucket's gradient is flattened, padded
  to a multiple of N (the data degree) and reduce-scattered over the
  data axes (``spmd.Group.psum_scatter``, axis by axis, major first),
  so that data shard i holds the fully reduced chunk i. The optimizer
  updates that chunk of the parameters against its own 1/N of the
  state (``sharded_update``), and the chunks are gathered back
  (``all_gather_params``, the axes in reverse). Spatial peers with the
  same data index hold the same chunk. The flat layout — buckets of
  ``make_plan``, padded to N — is the reference's, element for
  element, so each package restores the other's ZeRO-1 checkpoints.

Each bucket's hook is one autograd node over every shard
(``spmd.Group.psum_grad``): its backward sums the bucket's flat
cotangent once, the spatial peers first, then those sums over the data
shards, each in rank order. ``reduce_grads`` sums in that order too,
and so does ZeRO-1 (its hooks over the spatial axes, then the data
reduce-scatter): the three lowerings add the same numbers in the same
order and agree to the last bit on one device, where the reference's
contract between them is atol 1e-5, rtol 1e-4 after two steps
(``tests/test_grad_comm.py``). (Summed in flat rank order over a 2 x 2
mesh instead, ZeRO-1 and ``overlap`` differed by one rounding of each
gradient, which Adam's normalization turned into differences beyond
that contract where a gradient's sum nearly cancels.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core import spmd
from repro_torch.core.tree import tree_map
from repro_torch.obs import trace as trace_lib

MODES = ("monolithic", "overlap", "reduce_scatter")


def resolve(mode: Optional[str]) -> str:
    """The lowering a ``grad_comm`` setting names: None and ``"auto"``
    are ``overlap`` (the reference's default)."""
    mode = "overlap" if mode in (None, "auto") else mode
    if mode not in MODES:
        raise ValueError(f"grad_comm={mode!r}; expected one of {MODES}")
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

    def padded_size(self, bucket: Bucket, shards: int) -> int:
        return -(-bucket.size // shards) * shards


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
    """The monolithic lowering: every leaf summed over ``axes``, one
    exchange an axis, the mesh's minor axis first (``psum_grad``'s
    order)."""
    axes = tuple(a for a in axes if a)
    if not axes:
        return dict(grads)
    mesh = spmd.current_mesh()
    order = ([a for a in reversed(mesh.axis_names) if a in axes]
             if mesh is not None else axes)
    names = sorted(grads)
    summed = tuple(grads[n] for n in names)
    for a in order:
        summed = spmd.axis(a).psum(summed)
    return dict(zip(names, summed))


# --------------------------------------------- reduce-scatter (ZeRO-1) ----
def _flat_bucket(tree: Mapping[str, torch.Tensor], b: Bucket
                 ) -> torch.Tensor:
    if len(b.names) == 1:
        return tree[b.names[0]].reshape(-1)
    return torch.cat([tree[n].reshape(-1) for n in b.names])


def _num_shards(data_axes: Sequence[str]) -> int:
    return math.prod(spmd.axis(a).size for a in data_axes)


def shard_index(data_axes: Sequence[str]) -> int:
    """This shard's index over the data axes, major first: the chunk
    ``psum_scatter`` over them, axis by axis, hands it."""
    idx = 0
    for a in data_axes:
        g = spmd.axis(a)
        idx = idx * g.size + g.index
    return idx


def _pad_to(flat: torch.Tensor, padded: int) -> torch.Tensor:
    pad = padded - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def reduce_scatter_grads(grads: Mapping[str, torch.Tensor], plan: Plan,
                         data_axes: Sequence[str]
                         ) -> Tuple[torch.Tensor, ...]:
    """Each bucket of this shard's gradients flattened in fp32, padded to
    the shard grid and reduce-scattered over the data axes (axis by
    axis, major first): shard i holds the fully reduced chunk i. A tuple
    of flat fp32 vectors, one a bucket."""
    n = _num_shards(data_axes)
    out = []
    for b in plan.buckets:
        flat = _pad_to(_flat_bucket(grads, b).float(),
                       plan.padded_size(b, n))
        for a in data_axes:
            flat = spmd.axis(a).psum_scatter(flat, 0)
        out.append(flat)
    return tuple(out)


def param_shards(params: Mapping[str, torch.Tensor], plan: Plan,
                 data_axes: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    """This shard's 1/N chunk of each (replicated) flat parameter
    bucket."""
    n = _num_shards(data_axes)
    idx = shard_index(data_axes)
    out = []
    for b in plan.buckets:
        padded = plan.padded_size(b, n)
        flat = _pad_to(_flat_bucket(params, b), padded)
        size = padded // n
        out.append(flat[idx * size:(idx + 1) * size])
    return tuple(out)


def all_gather_params(shards: Sequence[torch.Tensor], plan: Plan,
                      data_axes: Sequence[str],
                      template: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of the scatter: the chunks gathered over the data
    axes (in reverse order), the padding stripped, and the leaves
    rebuilt in ``template``'s shapes and dtypes."""
    out = dict(template)
    for b, flat in zip(plan.buckets, shards):
        for a in reversed(tuple(data_axes)):
            flat = spmd.axis(a).all_gather(flat, 0)
        off = 0
        for name, shape in zip(b.names, b.shapes):
            size = math.prod(shape)
            out[name] = flat[off:off + size].view(shape).to(
                template[name].dtype)
            off += size
    return out


def sharded_update(optimizer, grads: Mapping[str, torch.Tensor],
                   opt_state, params: Mapping[str, torch.Tensor],
                   plan: Plan, data_axes: Sequence[str]):
    """The ZeRO-1 step: reduce-scatter the gradients, update this
    shard's chunk of the parameters against its own state (from
    ``init_sharded_opt_state``, sliced), and gather the updated
    parameters. Returns (new parameters, new state)."""
    g_shards = reduce_scatter_grads(grads, plan, data_axes)
    p_shards = param_shards(params, plan, data_axes)
    new_shards, new_state = optimizer.update(
        g_shards, opt_state, p_shards, norm_axes=tuple(data_axes))
    return all_gather_params(new_shards, plan, data_axes, params), new_state


def init_sharded_opt_state(optimizer, plan: Plan, *, num_shards: int,
                           device=None):
    """The optimizer's state over the GLOBAL padded flat fp32 buckets:
    the reference's layout (and its checkpoints'). ``local_opt_state``
    cuts a shard's 1/``num_shards`` from it."""
    return optimizer.init(tuple(
        torch.zeros(plan.padded_size(b, num_shards), dtype=torch.float32,
                    device=device) for b in plan.buckets))


def _each_bucket(fn: Callable, *states):
    """``fn(k, *vectors)`` over each flat bucket vector ``k`` of one or
    more optimizer states of one structure (NamedTuples whose tuples are
    the buckets); every other leaf — a replicated scalar — is the first
    state's."""
    s0 = states[0]
    if s0 is None:
        return None
    if isinstance(s0, tuple) and hasattr(s0, "_fields"):
        return type(s0)(*(_each_bucket(fn, *(getattr(s, f) for s in states))
                          for f in s0._fields))
    if isinstance(s0, tuple):
        return tuple(fn(k, *(s[k] for s in states)) for k in range(len(s0)))
    return s0


def local_opt_state(state, plan: Plan, index: int, num_shards: int,
                    device=None):
    """Data shard ``index``'s own state from a global one (of any shard
    count: its padding is stripped and the shard grid of ``num_shards``
    laid anew), each chunk a tensor of its own on ``device``; scalars
    replicated."""
    def cut(k, flat):
        b = plan.buckets[k]
        size = plan.padded_size(b, num_shards) // num_shards
        flat = _pad_to(flat[:b.size], plan.padded_size(b, num_shards))
        chunk = flat[index * size:(index + 1) * size]
        return chunk.clone() if device is None else chunk.to(device,
                                                             copy=True)

    state = _each_bucket(cut, state)
    return state if device is None else tree_map(lambda t: t.to(device),
                                                 state)


def global_opt_state(states: Sequence[Any]):
    """The inverse of ``local_opt_state``: the states of data shards 0,
    1, ... in order, their chunks concatenated (the reference's global
    padded layout); scalars from the first."""
    return _each_bucket(lambda k, *chunks: torch.cat(chunks), *states)


__all__ = ["MODES", "BucketPolicy", "Bucket", "GradMarker", "Plan",
           "all_gather_params", "global_opt_state",
           "init_sharded_opt_state", "local_opt_state", "make_plan",
           "mark_gradient", "param_shards", "reduce_grads",
           "reduce_scatter_grads", "resolve", "shard_index",
           "sharded_update"]
