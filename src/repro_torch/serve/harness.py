"""Batched serving harness: bounded request queue + worker threads
feeding coalesced micro-batches into an ``InferenceSession``'s forward
(the reference's ``serve/harness.py``, on the port's session).

The shape is MaxText's ``offline_inference`` loop adapted to 3D
volumes: callers ``submit()`` single volumes and get back
``concurrent.futures.Future``s; worker threads pull the first waiting
request, then coalesce more until ``max_batch`` is reached or
``max_wait_ms`` expires, run ONE forward over the stacked batch, and
fan the rows back out to the futures. The queue is bounded
(``max_queue``), so a saturated server pushes back on producers by
blocking ``submit`` instead of growing without bound.

Two contracts worth stating explicitly:

* **Failure isolation** — a forward that raises (including the
  ``serve.forward`` injected fault of ``core/faults.py``) fails exactly
  that batch's futures and the worker moves on; a submitted request can
  never hang.
* **Batch-composition visibility** — the models normalize with BATCH
  statistics (``core/dist_norm.py``; there are no running stats), so a
  sample's output depends on what it was coalesced with, and on the
  padding rows added to reach a multiple of the plan's data degree.
  Outputs are bitwise-reproducible for a fixed batch composition —
  the parity tests pin harness-vs-direct-forward equality on identical
  batches — but not across compositions. At ``data degree == 1``
  (the common serving shape: spatial sharding for latency) no padding
  is ever added.

Over a process mesh (``launch.mesh.ProcessMesh``, one process a shard)
there is one front end: ``InferenceSession.serve()`` returns this
harness on rank 0 and a ``ServingFollower`` on every other rank. For
each batch rank 0 broadcasts a header (the padded batch's shape and
dtype, or stop) and then the batch over the mesh's world (gloo); every
rank fires ``serve.forward`` and the ranks agree on whether one failed
(one all-gather of each rank's status), run the sharded forward, and
agree again, after it; rank 0 resolves the futures from the gathered
output, or fails the batch with the failing rank's error. Batches must
reach every rank in one order, so over processes one batch at a time
goes from the broadcast through the forward (a lock the workers
share). ``close()`` on rank 0 sends stop and waits for the followers at
a barrier; a follower's ``close()`` waits for that stop. A forward that
raises on one rank after its first collective leaves its peers waiting
there: the agreement covers failures before and after the forward.

Observability: every stage is bracketed by spans on the
process-active tracer — ``serve.enqueue`` (submit), ``serve.batch``
(the coalescing window), ``serve.forward`` (the forward call),
``serve.reply`` (future fan-out) — and the owning session's registry
carries ``serve.*`` counters/gauges/histograms. All of it rides the
no-op path when the session isn't tracing.
"""
from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import faults, spmd
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.obs import trace as trace_lib
from repro_torch.serve.session import to_host

# raw latency samples retained for the p50/p95/p99 contract (the
# Histogram aggregates count/sum/min/max only); bounded so a long-lived
# server doesn't grow without bound
_MAX_LATENCY_SAMPLES = 16384


class _Request:
    __slots__ = ("x", "future", "t_enqueue")

    def __init__(self, x, future, t_enqueue):
        self.x = x
        self.future = future
        self.t_enqueue = t_enqueue


class ServingHarness:
    """Batched request front-end over one ``InferenceSession``. Build
    with ``InferenceSession.serve(...)``."""

    def __init__(self, session, *, max_batch: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 64,
                 workers: int = 1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._world = None
        if isinstance(session.mesh, ProcessMesh):
            if session.mesh.rank != 0:
                raise ValueError("the serving harness runs on rank 0 of a "
                                 "process mesh; the other ranks follow it "
                                 "(InferenceSession.serve())")
            self._world = session.mesh.world
        # over processes one batch at a time, broadcast through forward
        self._turn = (threading.Lock() if self._world is not None
                      else contextlib.nullcontext())
        self.session = session
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._accepting = True      # flips first: no submit after close
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._closed = False
        self._latencies: collections.deque = collections.deque(
            maxlen=_MAX_LATENCY_SAMPLES)
        self._requests_done = 0
        self._batches = 0
        self._fill_sum = 0
        self._worker_failures = 0
        m = session._metrics
        self._c_requests = m.counter("serve.requests")
        self._c_batches = m.counter("serve.batches")
        self._c_failures = m.counter("serve.worker_failures")
        self._g_depth = m.gauge("serve.queue_depth")
        self._h_fill = m.histogram("serve.batch_fill")
        self._h_latency = m.histogram("serve.latency_ms")
        # the caller's intra-op threads in each worker (the forward's
        # CPU products round as the caller's would: ``spmd.same_threads``)
        self._threads_n = torch.get_num_threads()
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"serve-worker-{i}", daemon=True)
            for i in range(workers)]
        for w in self._workers:
            w.start()

    # ---------------------------------------------------------- submit ----
    def submit(self, x) -> "Future":
        """Enqueue one volume; returns a Future resolving to its row of
        the batched forward's output — a host numpy array, one transfer
        per batch — or raising the batch's failure.
        Blocks — backpressure — while the queue is full. Raises
        ``RuntimeError`` after ``close()``."""
        if not self._accepting:
            raise RuntimeError("ServingHarness is closed")
        with trace_lib.span("serve.enqueue"):
            req = _Request(np.asarray(x), Future(), time.perf_counter())
            while True:
                try:
                    self._q.put(req, timeout=0.1)
                    break
                except queue.Full:
                    if not self._accepting:
                        raise RuntimeError("ServingHarness is closed")
        # depth gauge is maintained by the workers (once per batch):
        # a per-submit qsize() retakes the queue lock on the hot path
        return req.future

    def submit_many(self, xs) -> List["Future"]:
        """``submit`` each volume in ``xs``; one Future per volume."""
        return [self.submit(x) for x in xs]

    # ---------------------------------------------------------- worker ----
    def _worker_loop(self) -> None:
        spmd.same_threads(self._threads_n)
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            with trace_lib.span("serve.batch"):
                deadline = time.perf_counter() + self.max_wait_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
            self._g_depth.set(self._q.qsize())
            self._run_batch(batch)
            for _ in batch:
                self._q.task_done()

    def _run_batch(self, batch: List[_Request]) -> None:
        n = len(batch)
        try:
            if self._world is None:
                faults.fire("serve.forward")
            xs = np.stack([r.x for r in batch])
            d = self.session.plan.data_degree
            pad = (-n) % d
            if pad:
                # repeat the last row up to the next data-degree
                # multiple; padded rows are dropped from the reply (but
                # see the module docstring: batch-stat normalization
                # makes them visible in the real rows' values)
                xs = np.concatenate([xs, np.repeat(xs[-1:], pad, axis=0)])
            with self._turn, trace_lib.span("serve.forward", batch=n,
                                            padded=pad):
                if self._world is None:
                    out = self.session._forward_for(xs.shape[0])(
                        self.session.params, xs)
                else:
                    t = _wire_tensor(xs)
                    _send(self._world, t)
                    out = _shard_forward(self.session, self._world, t)
                # one host transfer for the whole batch: handing out
                # per-row device-tensor slices costs a copy per request
                # and erases the batching win at small volumes
                out = to_host(out)
        except Exception as e:  # fail THIS batch's futures, keep serving
            with self._lock:
                self._worker_failures += 1
                self._batches += 1
            self._c_failures.inc()
            self._c_batches.inc()
            for r in batch:
                r.future.set_exception(e)
            return
        with trace_lib.span("serve.reply", batch=n):
            now = time.perf_counter()
            for i, r in enumerate(batch):
                r.future.set_result(out[i])
                lat = now - r.t_enqueue
                self._latencies.append(lat)
                self._h_latency.observe(lat * 1e3)
            with self._lock:
                self._requests_done += n
                self._batches += 1
                self._fill_sum += n
            self._c_requests.inc(n)
            self._c_batches.inc()
            self._h_fill.observe(n)

    # ----------------------------------------------------------- stats ----
    def stats(self) -> Dict[str, float]:
        """Host-side counters: completed requests, batches, mean fill,
        current queue depth, worker failures."""
        with self._lock:
            return {
                "requests": float(self._requests_done),
                "batches": float(self._batches),
                "mean_fill": (self._fill_sum / self._batches
                              if self._batches else 0.0),
                "queue_depth": float(self._q.qsize()),
                "worker_failures": float(self._worker_failures),
            }

    def latencies_s(self) -> List[float]:
        """Raw enqueue->reply latencies (seconds) of completed requests
        (bounded: the newest ``_MAX_LATENCY_SAMPLES``)."""
        return list(self._latencies)

    # ----------------------------------------------------------- close ----
    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop accepting, then shut down. ``drain=True`` (default)
        serves every queued request before the workers exit;
        ``drain=False`` fails still-queued futures with
        ``RuntimeError``. Idempotent and thread-safe — the session's
        ``close()``, a ``with`` block, and user code may all call it."""
        with self._lock:
            already = self._closed
            self._closed = True
            self._accepting = False
        if already:
            # second closer still waits for the workers to be gone
            for w in self._workers:
                w.join(timeout=timeout)
            return
        if drain:
            self._q.join()   # every queued request got task_done
        self._stop.set()
        if not drain:
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                req.future.set_exception(
                    RuntimeError("ServingHarness closed before this "
                                 "request was served"))
                self._q.task_done()
        for w in self._workers:
            w.join(timeout=timeout)
        self._g_depth.set(self._q.qsize())
        if self._world is not None:  # the followers stop, then meet here
            _send(self._world, None)
            self._world.barrier()

    def __enter__(self) -> "ServingHarness":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------- over processes ----
# the dtypes a batch crosses the wire in (a header names one by index)
_WIRE_DTYPES = (torch.float32, torch.float16)
_HEADER = 8  # int64s: the batch's dims (N first, 0 = stop), then dtype


def _wire_tensor(xs: np.ndarray) -> torch.Tensor:
    """A stacked batch as the contiguous host tensor every rank gets
    (float64 as fp32, as ``InferenceSession._as_input`` makes it)."""
    t = torch.from_numpy(np.ascontiguousarray(xs))
    return t.float() if t.dtype == torch.float64 else t


def _send(world, t: Optional[torch.Tensor]) -> None:
    """Rank 0: the header (``t``'s shape and dtype, or stop for None),
    then ``t``, broadcast over the mesh's world."""
    head = torch.zeros(_HEADER, dtype=torch.int64)
    if t is not None:
        head[:t.dim()] = torch.tensor(t.shape)
        head[-1] = _WIRE_DTYPES.index(t.dtype)
    world.broadcast(head, 0)
    if t is not None:
        world.broadcast(t, 0)


def _receive(world) -> Optional[torch.Tensor]:
    """A follower: rank 0's next batch, or None at stop."""
    head = torch.zeros(_HEADER, dtype=torch.int64)
    world.broadcast(head, 0)
    dims = [int(v) for v in head[:-1] if v > 0]
    if not dims:
        return None
    t = torch.empty(dims, dtype=_WIRE_DTYPES[int(head[-1])])
    world.broadcast(t, 0)
    return t


def _agree(world, failure: Optional[BaseException]) -> None:
    """Every rank's status of one point of a batch (one exchange): raise
    this rank's own failure, else another rank's as a ``RuntimeError``
    naming it, else nothing."""
    mine = (None if failure is None
            else f"{type(failure).__name__}: {failure}")
    for r, status in enumerate(world.gather_objects(mine)):
        if status is not None:
            if failure is not None:
                raise failure
            raise RuntimeError(f"rank {r} of the serving mesh failed this "
                               f"batch: {status}")


def _shard_forward(session, world, t: torch.Tensor) -> torch.Tensor:
    """Every rank's part of one broadcast batch: the ``serve.forward``
    site, agreed on; the sharded forward (its output gathered on every
    rank); a second agreement, so that a rank whose forward failed
    after the collectives fails the batch everywhere."""
    failure = None
    try:
        faults.fire("serve.forward")
    except faults.InjectedFault as e:
        failure = e
    _agree(world, failure)
    out = None
    try:
        out = session._forward_for(t.shape[0])(session.params, t)
    except Exception as e:  # noqa: BLE001 — agreed on, then raised
        failure = e
    _agree(world, failure)
    return out


class ServingFollower:
    """A rank other than 0 of a process mesh while rank 0's harness
    serves: one thread that takes each batch rank 0 broadcasts and runs
    its shard of the forward, until rank 0 sends stop. Build with
    ``InferenceSession.serve(...)``; ``close()`` waits for the stop."""

    def __init__(self, session):
        if not isinstance(session.mesh, ProcessMesh):
            raise ValueError("a follower serves a process mesh's shard")
        self.session = session
        self._world = session.mesh.world
        self.batches = 0       # forwards run
        self.failed = 0        # batches a rank failed
        self.error: Optional[BaseException] = None  # what ended the loop
        self._threads_n = torch.get_num_threads()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serve-follower-{session.mesh.rank}")
        self._thread.start()

    def _loop(self) -> None:
        spmd.same_threads(self._threads_n)
        try:
            while True:
                t = _receive(self._world)
                if t is None:
                    break
                try:
                    _shard_forward(self.session, self._world, t)
                    self.batches += 1
                except Exception:  # noqa: BLE001 — rank 0 fails the batch
                    self.failed += 1
            self._world.barrier()
        except BaseException as e:  # noqa: BLE001 — kept for close()
            self.error = e

    def submit(self, x) -> "Future":
        raise RuntimeError(f"rank {self.session.mesh.rank} follows rank 0's "
                           "harness: submit requests on rank 0")

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Wait for rank 0's stop (``drain`` is rank 0's to choose);
        raise what ended the loop if it was not the stop."""
        self._thread.join(timeout=timeout)
        if self.error is not None:
            raise self.error

    def __enter__(self) -> "ServingFollower":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ServingFollower", "ServingHarness"]
