"""Asynchronous double-buffered input pipeline (the reference's
``data/prefetch.py``, DESIGN.md §12).

``PrefetchLoader`` wraps a loader of ``data/pipeline.py`` and runs its
``stage_batch`` on a background worker through a bounded queue (depth
>= 2 = double buffering): while the card computes step N, the worker
reads step N+1's hyperslabs and enqueues their copies on the loader's
copy stream. The consumer's ``load_batch`` takes the queued batch and
makes its current stream wait for the copies' event (``inner.ready``):
the host never synchronizes the device for it.

**Prediction.** The wrapper cannot see future ``load_batch`` arguments,
so it predicts them from the schedule the consumer is visibly following:
``epoch_schedule()`` / ``schedule_for_epoch(e)`` anchor the current
order, and batches are assumed to be consecutive ``global_batch``-sized
chunks of it. A ``load_batch`` whose ids match the queue head is served
from the queue (a *hit*; the time it still waits is the stall); any
other ids fall back to a synchronous inner load and re-anchor the
predictor at the requested position. Speculative loads never cross an
epoch boundary.

**Equivalence contract.** Batch content is a pure function of the
sample ids, so prefetched and synchronous batch sequences (and loss
trajectories) are bitwise identical for the same seed; the synchronous
loader is the oracle. Cache and byte counters may differ: speculative
loads that are never consumed still warm the inner cache.

**Fault propagation.** A ``loader.read`` fault fires inside the worker;
the future carries the ``StoreReadError`` and ``load_batch`` raises it
on the consumer thread at the step that needed the batch. A failed
speculative entry that is superseded is drained with its exception
swallowed.

``close()`` cancels queued work, waits out the load in flight, and makes
further ``load_batch`` calls fail.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Deque, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as trace_lib

DEFAULT_DEPTH = 2


class PrefetchLoader:
    """Bounded-queue asynchronous wrapper over a synchronous loader."""

    def __init__(self, inner, depth: int = DEFAULT_DEPTH):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.inner = inner
        self.depth = depth
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="io-prefetch")
        self._queue: Deque[Tuple[Tuple[int, ...], Future]] = deque()
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self._pred_epoch: Optional[int] = None
        self._closed = False
        self._lock = threading.Lock()
        # telemetry: residual stall = time the consumer still blocked
        # waiting on a queued batch (its reads; the copies it waits for on
        # its stream); occupancy = queue depth observed at each serve
        # (2.0 = fully double-buffered)
        self.stall_s = 0.0
        self.served = 0
        self.queue_hits = 0
        self.sync_fallbacks = 0
        self._occupancy_sum = 0

    # ------------------------------------------------------- delegation ----
    def __getattr__(self, name):
        # store/stats/mesh/...: the wrapper IS a loader
        return getattr(self.inner, name)

    # -------------------------------------------------------- schedules ----
    def epoch_schedule(self) -> np.ndarray:
        order = self.inner.epoch_schedule()
        self._anchor(order, self.inner.epoch - 1)
        return order

    def schedule_for_epoch(self, epoch: int) -> np.ndarray:
        order = self.inner.schedule_for_epoch(epoch)
        if self._pred_epoch != epoch:
            self._anchor(order, epoch)
        return order

    def _anchor(self, order: np.ndarray, epoch: int) -> None:
        self._order = np.asarray(order)
        self._pos = 0
        self._pred_epoch = epoch
        self._drain()
        self._fill()

    # ------------------------------------------------------------ queue ----
    def _predict(self) -> Optional[np.ndarray]:
        """Next batch ids under the current anchor, or None (order
        exhausted / not anchored). Never crosses an epoch boundary."""
        gb = self.inner.global_batch
        if self._order is None or self._pos + gb > len(self._order):
            return None
        ids = self._order[self._pos:self._pos + gb]
        self._pos += gb
        return ids

    def _traced_load(self, ids: np.ndarray):
        # the worker's reads and the enqueueing of its copies, on its own
        # io-prefetch_* thread track
        with trace_lib.span("io.load", samples=len(ids)):
            return self.inner.stage_batch(ids)

    def _fill(self) -> None:
        while len(self._queue) < self.depth:
            ids = self._predict()
            if ids is None:
                return
            key = tuple(int(i) for i in ids)
            self._queue.append(
                (key, self._pool.submit(self._traced_load, ids)))

    @staticmethod
    def _discard(fut: Future) -> None:
        """Drop a speculative future; a failure it carries is swallowed
        (the consumer never asked for this batch)."""
        if not fut.cancel():
            fut.add_done_callback(lambda f: f.exception())

    def _drain(self) -> None:
        while self._queue:
            self._discard(self._queue.popleft()[1])

    def _resync(self, key: Tuple[int, ...]) -> None:
        """Re-anchor the predictor just past ``key``'s position in the
        current order (contiguous-chunk match), else stop predicting
        until the consumer pulls the next epoch schedule."""
        self._drain()
        if self._order is None:
            return
        gb = len(key)
        want = np.asarray(key)
        for j in range(0, len(self._order) - gb + 1):
            if np.array_equal(self._order[j:j + gb], want):
                self._pos = j + gb
                return
        self._pos = len(self._order)

    # ------------------------------------------------------------ serve ----
    def load_batch(self, sample_ids: np.ndarray):
        with self._lock:
            if self._closed:
                raise RuntimeError("PrefetchLoader is closed")
            key = tuple(int(i) for i in sample_ids)
            fut = None
            if self._queue and self._queue[0][0] == key:
                fut = self._queue.popleft()[1]
            self._occupancy_sum += len(self._queue) + (fut is not None)
            if fut is None:
                self.sync_fallbacks += 1
                self._resync(key)
            else:
                self.queue_hits += 1
            self.served += 1
        if fut is None:
            batch = self.inner.load_batch(sample_ids)
        else:
            t0 = time.perf_counter()
            with trace_lib.span("io.wait"):  # residual consumer stall
                try:
                    staged = fut.result()  # re-raises StoreReadError here
                except BaseException:
                    with self._lock:
                        self._drain()  # queued successors are suspect too
                    raise
            self.stall_s += time.perf_counter() - t0
            batch = self.inner.ready(staged)  # a stream wait, not a sync
        with self._lock:
            if not self._closed:
                self._fill()
        return batch

    # -------------------------------------------------------- telemetry ----
    def queue_occupancy(self) -> float:
        """Mean prefetch-queue depth observed at serve time."""
        return self._occupancy_sum / self.served if self.served else 0.0

    # -------------------------------------------------------- lifecycle ----
    def close(self) -> None:
        """Drain the queue and stop the worker (idempotent), so that a
        later session never races a half-finished speculative read."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._drain()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.inner.close()

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
