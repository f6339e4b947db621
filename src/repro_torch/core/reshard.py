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

Between pipeline groups (``train/train_step.py``'s pipelined step) a
boundary activation, or its cotangent on the way back, is no collective
inside one mesh: ``cross_group`` hands shard j of one group's tensors to
shard j of the next group (both shard only the batch, at one data
degree), across two meshes and so two sets of streams, and counts
``pipe.cross_group``. Over processes (each group's shards processes of
their own) a ``Courier`` carries them over the pipeline's links
(``launch.mesh.PipelineWorld.links``): the producer queues a header and
the tensor's bytes on its link, a receiver thread takes them in the
producer's order, and the consumer's ``wait`` puts them on its stream.
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, TypeVar)

import torch

from repro_torch.core import halo as halo_lib
from repro_torch.core import spmd
from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as mesh_lib
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


# ------------------------------------------- between pipeline groups ----
class GroupShard(NamedTuple):
    """Where shard r of a pipeline group holds an activation: its device
    and its slice ``index`` of ``count`` along the batch."""

    device: torch.device
    index: int
    count: int


def group_sharding(mesh, batch_axes: Sequence[str] = ("data",)
                   ) -> Tuple[GroupShard, ...]:
    """The layout every activation (and micro-batch input) holds inside
    one pipeline group's mesh: each shard's device and its slice of the
    batch over ``batch_axes`` (major first); every other dim whole."""
    out = []
    for r, device in enumerate(mesh.devices):
        at, index, count = mesh.coords(r), 0, 1
        for a in batch_axes:
            if a in mesh.shape:
                index = index * mesh.degree(a) + at[a]
                count *= mesh.degree(a)
        out.append(GroupShard(device, index, count))
    return tuple(out)


class Handoff:
    """One group's per-shard tensors on their way to the next group's
    shards: each with the event recorded on its producer's stream when it
    was handed off. ``wait()``, on the consumer's thread, returns them
    ready on the consumer's current streams."""

    def __init__(self, entries: List[Tuple[torch.Tensor, Any]],
                 dst: Sequence[GroupShard]):
        self._entries, self._dst = entries, dst

    def wait(self) -> List[torch.Tensor]:
        # the consumer's stream waits on the producer's event, and the
        # tensor is recorded on it for the caching allocator; a tensor on
        # another device is copied behind the same event
        return [spmd._read(e, s.device)
                for e, s in zip(self._entries, self._dst)]


def cross_group(values: Sequence[torch.Tensor],
                dst: Sequence[GroupShard]) -> Handoff:
    """Hand a stage-boundary activation (or its cotangent) from the
    producing group's shards to the group ``dst`` (``group_sharding`` of
    its mesh): shard j's tensor goes to shard j, the whole of it, the
    least the layouts need. Call it on the producer's thread, after the
    producer's ``spmd.run`` (whose caller stream has joined every shard
    stream): an event is recorded on that stream here, and the consumer
    waits on it in ``Handoff.wait``. Asynchronous: nothing blocks here,
    so 1F1B overlaps the hand-off with both groups' work."""
    if len(values) != len(dst):
        raise ValueError(f"{len(values)} shards hand off to a group of "
                         f"{len(dst)}")
    trace_lib.count("pipe.cross_group")
    return Handoff([spmd._mark(t) for t in values], dst)


# ------------------------------- between pipeline groups over processes ----
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64)
_HEADER = 12  # numbers: the slot, the node, the micro-batch, the dtype,
#               the rank, up to 7 dims


class ProcessHandoff:
    """A tensor a ``Courier`` received for this shard: ``wait()``, on the
    consumer's thread, returns it (a list of one, as ``Handoff``'s) on
    the consumer's current stream."""

    def __init__(self, staging, buf: torch.Tensor, like: torch.Tensor,
                 event):
        self._staging, self._buf, self._like = staging, buf, like
        self._event = event

    def wait(self) -> List[torch.Tensor]:
        if self._event is not None:  # a recv on the receiver's stream
            stream = torch.cuda.current_stream(self._buf.device)
            stream.wait_event(self._event)
            self._buf.record_stream(stream)
        return spmd._unpack(self._staging, self._buf, [self._like])


class Courier:
    """One step's hand-offs of this process's shard over its pipeline
    links (``links[h]``: a ``dist.Link`` to shard j of group h, this
    shard being shard j of its group; ``device`` this shard's).

    ``send(h, key, t)`` hands ``t`` to group h's shard j: a header (the
    ``key`` — slot, node, micro-batch — and ``t``'s dtype and shape),
    then ``t``'s bytes, both queued on the link's outgoing backend in
    this process's dispatch order, nothing waited for (a CUDA tensor
    under gloo is first copied into pinned host memory, after its
    stream). ``receive(h, count, deliver)`` starts a thread that takes
    ``count`` hand-offs from group h in the order its sender queued
    them and calls ``deliver(key, ProcessHandoff)`` for each; a failure
    there is ``deliver``'d as the exception. ``close()`` waits for every
    send and receiver."""

    def __init__(self, links: Dict[int, Any], device: torch.device):
        self._links, self._device = links, device
        self._sent: List[Tuple[Any, torch.Tensor]] = []
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def _staging(self, h: int):
        return mesh_lib.Staging.of(self._device, self._links[h].backend)

    def send(self, h: int, key: Tuple[int, int, int],
             t: torch.Tensor) -> None:
        trace_lib.count("pipe.cross_group")
        link, staging = self._links[h], self._staging(h)
        if t.dim() > _HEADER - 5:
            raise ValueError(f"a hand-off of rank {t.dim()} > {_HEADER - 5}")
        shape = list(t.shape) + [0] * (_HEADER - 5 - t.dim())
        head = spmd._pack(staging, [*key, _DTYPES.index(t.dtype), t.dim(),
                                    *shape])
        body = spmd._pack(staging, [t])
        for buf in (head, body):
            self._sent.append((link.send(buf), buf))

    def receive(self, h: int, count: int,
                deliver: Callable[[Any, Any], None]) -> None:
        if not count:
            return
        link, staging = self._links[h], self._staging(h)

        def main():
            try:
                with (torch.cuda.device(self._device)
                      if self._device.type == "cuda"
                      else contextlib.nullcontext()):
                    for _ in range(count):
                        head = spmd._wire_buffer(staging,
                                                 _HEADER * spmd._ALIGN)
                        link.recv(head).wait()
                        got = spmd._unpack(staging, head, [0] * _HEADER)
                        like = torch.empty(got[5:5 + got[4]],
                                           dtype=_DTYPES[got[3]],
                                           device="meta")
                        body = spmd._wire_buffer(staging, spmd._nbytes(like))
                        link.recv(body).wait()
                        event = None
                        if body.device.type == "cuda":
                            event = torch.cuda.Event()
                            event.record()
                        deliver(tuple(got[:3]), ProcessHandoff(
                            staging, body, like, event))
            except BaseException as e:  # noqa: BLE001 — the consumer raises
                self._errors.append(e)
                deliver(None, e)

        th = threading.Thread(target=main, name=f"pipe-recv-{h}",
                              daemon=True)
        th.start()
        self._threads.append(th)

    def close(self) -> None:
        for work, _ in self._sent:
            work.wait()
        self._sent = []
        for th in self._threads:
            th.join()
        self._threads = []
        if self._errors:
            raise self._errors[0]


def to_group(tree: Any, device: torch.device) -> Any:
    """A tree of tensors (a group's parameters or optimizer state) on the
    group's ``device``; leaves already there are kept as they are."""
    return tree_map(lambda t: t if t.device == device else t.to(device),
                    tree)


__all__ = ["Courier", "GroupShard", "Handoff", "ProcessHandoff", "apply",
           "batch_to_spatial",
           "cross_group", "group_sharding", "replicated_to_spatial",
           "shard_batch", "spatial_to_batch", "spatial_to_batch_oracle",
           "spatial_to_replicated", "to_group"]
