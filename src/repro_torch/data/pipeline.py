"""Spatially parallel input pipeline (the reference's ``data/pipeline.py``,
paper §III-B, Fig. 3).

What carries over from the reference:
 1. *Spatial-parallel reads*: each mesh rank reads exactly the hyperslab
    of every sample that it owns under the plan's entry stage — its
    slice of the batch, its depth slab (``train_step.block_index``, the
    layout ``Session.step`` splits its input by) — so the bytes a rank
    reads shrink with the spatial degree. Each read is counted to its
    rank (``IOStats.rank_pfs_bytes``).
 2. *Distributed in-memory cache*: epoch 0 fills a (sample, slab) ->
    (owner rank, array) cache; later epochs never touch the store. A hit
    served to another rank than the slab's owner counts as
    redistribution traffic.
 3. *Shuffle schedule*: ``schedule_for_epoch(e)`` is a pure function of
    ``(seed, e)``, the reference's permutation, so a resumed run replays
    the same batches.
 4. *Halo margin reads* (``halo_voxels``): a rank reads its slab widened
    by a margin on the partitioned dims (clamped at the volume); the
    served block is always the exact slab.

What the port does instead of ``jax.make_array_from_callback``: it
builds the ONE global ``(N, D, H, W, C)`` tensor that ``Session.step``
takes, on the mesh's first device, each rank's slab copied into its
place. On a card each slab goes through a pinned host buffer and is
copied with ``non_blocking=True`` on the loader's own copy stream; a
pinned buffer is reused only once its copy's event has completed, and
the global tensor is allocated on the copy stream. ``stage_batch``
returns the batch with the event that marks its copies done;
``ready`` makes the caller's current stream wait for that event (the
device is never synchronized) and tells the caching allocator about the
use. ``load_batch`` is the two together. The U-Net's voxel labels are
split and copied the same way; CosmoFlow's vector targets are cached as
the placed device tensor of the batch, for at most one epoch's worth of
batches (the least recently used goes first). On the CPU the slabs are
copied in place directly.

The loader is thread-safe: a ``PrefetchLoader`` (``data/prefetch.py``)
calls ``stage_batch`` from a worker thread. ``SampleParallelLoader`` is
the pre-paper baseline: one rank reads every sample whole.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.store import HyperslabStore
from repro_torch.obs import trace as trace_lib
from repro_torch.train import train_step

PINNED_PER_SHAPE = 2  # pinned staging buffers a slab shape: double buffering


@dataclasses.dataclass
class IOStats:
    """The reference's counters, plus the store bytes of each mesh rank."""

    pfs_bytes: int = 0
    cache_bytes_local: int = 0
    cache_bytes_redistributed: int = 0
    label_fetches: int = 0  # store.target() reads (not served by cache)
    rank_pfs_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)

    def reset(self):
        self.pfs_bytes = self.cache_bytes_local = 0
        self.cache_bytes_redistributed = 0
        self.label_fetches = 0
        self.rank_pfs_bytes = {}

    def cache_hit_ratio(self) -> float:
        """Fraction of loader bytes served from the distributed cache."""
        hit = self.cache_bytes_local + self.cache_bytes_redistributed
        total = hit + self.pfs_bytes
        return hit / total if total else 0.0


class Staged(NamedTuple):
    """A batch whose copies may still be in flight: ``event`` (None on
    the CPU) completes when they are done."""

    x: torch.Tensor
    y: torch.Tensor
    event: Optional[Any]


class _PinnedPool:
    """Pinned host buffers per (shape, dtype), each reused only after
    the event of the copy that last read it has completed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[Tuple, Deque] = collections.defaultdict(
            collections.deque)
        self._made: Dict[Tuple, int] = collections.defaultdict(int)

    def acquire(self, shape, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free[key]
            if free and (free[0][1] is None or free[0][1].query()):
                return free.popleft()[0]
            if self._made[key] < PINNED_PER_SHAPE:
                self._made[key] += 1
                return torch.empty(shape, dtype=dtype, pin_memory=True)
            buf, event = free.popleft()
        event.synchronize()  # the oldest copy from it, on the host only
        return buf

    def release(self, buf: torch.Tensor, event) -> None:
        with self._lock:
            self._free[(tuple(buf.shape), buf.dtype)].append((buf, event))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class SpatialParallelLoader:
    """Global batches for ``Session.step``: each mesh rank's block of the
    plan's entry ``stage`` read (or served from the cache) on its own,
    then copied into one tensor on ``mesh.devices[0]``."""

    def __init__(self, store: HyperslabStore, mesh, stage, global_batch: int,
                 seed: int = 0, cache: bool = True, halo_voxels: int = 0):
        self.store = store
        self.mesh = mesh
        self.stage = stage
        self.device = mesh.devices[0]
        self.global_batch = global_batch
        self.seed = seed
        self.cache_enabled = cache
        self.halo_voxels = halo_voxels
        # cache[(sample, what, slab)] = (owner_rank, ndarray)
        self._cache: Dict[Tuple, Tuple[int, np.ndarray]] = {}
        # batch ids -> placed targets, least recently used first; bounded
        # by one epoch's batches, since a shuffled epoch rarely repeats a
        # batch of an earlier one
        self._label_cache: Dict[Tuple[int, ...], torch.Tensor] = (
            collections.OrderedDict())
        self._label_cache_cap = max(-(-store.num_samples // global_batch), 1)
        self.stats = IOStats()
        self.epoch = 0
        self._lock = threading.Lock()
        self._pinned = _PinnedPool()
        self._copy_stream = None

    # ------------------------------------------------------------ sched ----
    def schedule_for_epoch(self, epoch: int) -> np.ndarray:
        """The epoch's sample permutation as a pure function of
        ``(seed, epoch)``: the reference's."""
        rng = np.random.default_rng([self.seed, int(epoch)])
        return rng.permutation(self.store.num_samples)

    def epoch_schedule(self) -> np.ndarray:
        order = self.schedule_for_epoch(self.epoch)
        self.epoch += 1
        return order

    # ------------------------------------------------------------ fetch ----
    def _expand(self, slab: Tuple[slice, ...], dims: Tuple[int, ...]):
        """Widen bounded spatial slices by the halo margin (clamped)."""
        if not self.halo_voxels:
            return slab
        out = []
        for s, dim in zip(slab, dims):
            lo = 0 if s.start is None else s.start
            hi = dim if s.stop is None else s.stop
            out.append(slice(max(lo - self.halo_voxels, 0),
                             min(hi + self.halo_voxels, dim)))
        return tuple(out) + slab[len(dims):]

    def _fetch(self, sample: int, slab: Tuple[slice, ...], rank: int,
               what: str = "x") -> np.ndarray:
        """One hyperslab, from the distributed cache or the store. The
        read (and the cache entry) covers the ``halo_voxels``-widened
        slab; the returned array is always the exact slab."""
        dims = self.store.sample_shape[:3]
        wide = self._expand(slab, dims)
        key = (sample, what) + tuple((s.start, s.stop) for s in wide)
        with self._lock:
            hit = self._cache.get(key) if self.cache_enabled else None
        if hit is not None:
            owner, arr = hit
            with self._lock:
                if owner == rank:
                    self.stats.cache_bytes_local += arr.nbytes
                else:
                    self.stats.cache_bytes_redistributed += arr.nbytes
        else:
            arr = self.store.read_hyperslab(sample, wide, what)
            with self._lock:
                self.stats.pfs_bytes += arr.nbytes
                self.stats.rank_pfs_bytes[rank] = (
                    self.stats.rank_pfs_bytes.get(rank, 0) + arr.nbytes)
                if self.cache_enabled:
                    self._cache[key] = (rank, arr)
        if wide is slab:
            return arr
        inner = tuple(slice(s.start - w.start, s.stop - w.start)
                      for s, w in zip(slab[:3], wide))
        return arr[inner]

    # ----------------------------------------------------------- device ----
    def _on_device(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def _stream(self):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        return self._copy_stream

    def _alloc(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A tensor on the loader's device; on a card, allocated on the
        copy stream that writes it."""
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype, device=self.device)
        with torch.cuda.stream(self._stream()):
            return torch.empty(shape, dtype=dtype, device=self.device)

    def _put(self, dst: torch.Tensor, parts: List[np.ndarray]) -> None:
        """Copy ``parts`` (one array per row of ``dst``) into ``dst``: on
        a card through a pinned buffer, on the copy stream."""
        if self.device.type != "cuda":
            for j, p in enumerate(parts):
                dst[j].copy_(torch.from_numpy(p))
            return
        buf = self._pinned.acquire(dst.shape, dst.dtype)
        host = buf.numpy()
        for j, p in enumerate(parts):
            np.copyto(host[j], p)
        stream = self._stream()
        with torch.cuda.stream(stream):
            if all(dst[j].is_contiguous() for j in range(dst.shape[0])):
                for j in range(dst.shape[0]):
                    dst[j].copy_(buf[j], non_blocking=True)
            else:
                dst.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        self._pinned.release(buf, done)

    def _place(self, ids: np.ndarray, sample_shape, what: str
               ) -> torch.Tensor:
        """The global (N, *sample_shape) tensor of ``ids``: every rank's
        block of the entry stage read on its own and copied into place
        (a block another rank also holds is read by each; copied once)."""
        shape = (len(ids),) + tuple(sample_shape)
        out, done = None, set()
        for rank in range(self.mesh.size):
            idx = train_step.block_index(shape, self.mesh, rank, self.stage)
            slab = idx[1:4] + tuple(slice(None) for _ in shape[4:])
            parts = [self._fetch(int(s), slab, rank, what)
                     for s in ids[idx[0]]]
            if out is None:
                out = self._alloc(shape, _torch_dtype(parts[0].dtype))
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                self._put(out[idx], parts)
        return out

    def _vector_labels(self, sample_ids: np.ndarray) -> torch.Tensor:
        """The batch's regression targets, cached as the placed tensor:
        ``store.target`` is re-read (and the batch copied) on a miss
        only."""
        key = tuple(int(s) for s in sample_ids)
        if self.cache_enabled:
            with self._lock:
                hit = self._label_cache.get(key)
                if hit is not None:
                    self._label_cache.move_to_end(key)
            if hit is not None:
                return hit
        tg = np.stack([self.store.target(int(s)) for s in sample_ids])
        with self._lock:
            self.stats.label_fetches += len(key)
        y = self._alloc(tg.shape, _torch_dtype(tg.dtype))
        self._put(y, list(tg))
        if self.cache_enabled:
            with self._lock:
                self._label_cache[key] = y
                while len(self._label_cache) > self._label_cache_cap:
                    self._label_cache.popitem(last=False)
        return y

    # ------------------------------------------------------------ batch ----
    def stage_batch(self, sample_ids: np.ndarray) -> Staged:
        """The batch of ``sample_ids`` with its copies enqueued (on a
        card: not yet waited for; ``ready`` does)."""
        ids = np.asarray(sample_ids)
        with self._on_device():
            x = self._place(ids, self.store.sample_shape, "x")
            if self.store.label_kind == "voxel":
                y = self._place(ids, self.store.sample_shape[:3], "y")
            else:
                y = self._vector_labels(ids)
            return self._staged(x, y)

    def _staged(self, x: torch.Tensor, y: torch.Tensor) -> Staged:
        """(x, y) with, on a card, an event after every copy enqueued so
        far on the copy stream (those of x and y among them)."""
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(self._stream())
        return Staged(x, y, event)

    def ready(self, staged: Staged) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, y) for use on the caller's current stream, which waits
        for the batch's copies (the host does not)."""
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            staged.x.record_stream(stream)
            staged.y.record_stream(stream)
        return staged.x, staged.y

    def load_batch(self, sample_ids: np.ndarray):
        """The global batch ``(x, y)`` of these samples, ready on the
        caller's current stream."""
        with trace_lib.span("io.load.sync", samples=len(sample_ids)):
            return self.ready(self.stage_batch(sample_ids))

    def close(self) -> None:
        """Sync loaders hold no threads; kept so every loader drains the
        same way (``PrefetchLoader.close`` is the real one)."""


class SampleParallelLoader(SpatialParallelLoader):
    """The baseline (paper Fig. 5): every sample read WHOLE by one rank
    and then scattered, so the bytes a rank reads do not shrink with the
    spatial degree. The reference's baseline, with its counters; nothing
in the port's training path builds it."""

    def stage_batch(self, sample_ids: np.ndarray) -> Staged:
        full = []
        for s in sample_ids:
            key = (int(s), "x", "full")
            with self._lock:
                hit = self._cache.get(key) if self.cache_enabled else None
            if hit is not None:
                arr = hit[1]
                with self._lock:
                    self.stats.cache_bytes_local += arr.nbytes
            else:
                arr = self.store.read_full(int(s))
                with self._lock:
                    self.stats.pfs_bytes += arr.nbytes
                    self.stats.rank_pfs_bytes[0] = (
                        self.stats.rank_pfs_bytes.get(0, 0) + arr.nbytes)
                    if self.cache_enabled:
                        self._cache[key] = (0, arr)
            full.append(arr)
        # the scatter to the shards: pure redistribution traffic
        with self._lock:
            self.stats.cache_bytes_redistributed += sum(a.nbytes
                                                        for a in full)
        with self._on_device():
            x = self._alloc((len(full),) + full[0].shape,
                            _torch_dtype(full[0].dtype))
            self._put(x, full)
            return self._staged(x, self._vector_labels(
                np.asarray(sample_ids)))


__all__ = ["IOStats", "SampleParallelLoader", "SpatialParallelLoader",
           "Staged"]
