"""The process group behind a process mesh (``launch.mesh.ProcessMesh``):
one process per shard, collectives through ``torch.distributed``.

* ``init`` joins the world: from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or from an explicit
  ``init_method`` (a ``file://`` path, as the tests and ``spawn`` use,
  so that concurrent worlds never share a port). The world's own group
  is gloo: it carries the bookkeeping (barriers, the placement table);
  each mesh picks the transport of its collectives by placement.
* ``wanted()`` says whether an entry point should build a process mesh:
  the process group is initialized, or torchrun's ``WORLD_SIZE`` > 1.
* ``world()`` is the ranks a compile places its mesh over: every rank,
  or the ranks ``sub_world`` names (a pool's workers serve meshes of
  several sizes from one world).
* ``group(ranks, backend, tag)`` makes a subgroup once, with only its
  members taking part (its rendezvous keys in the world's store are named
  by its ranks, backend and tag), and keeps it.
* ``Link(peer, backend)`` is the hand-off link between this process and
  ``peer`` (a pipeline's shard j of two neighbouring groups): one
  two-rank backend a direction, each carrying nothing else, so that a
  send one way never waits behind a send the other way.
* ``Pool`` starts ``n`` processes by the ``spawn`` start method (forking
  a process that has initialized CUDA breaks the child), each with one
  intra-op thread, joined in one world over ``init_method``, and runs
  jobs ``fn(*args)`` on a set of its ranks; ``spawn`` is one job on a
  fresh pool. A job that raises, or a pool that does not answer within
  its limit, raises in the caller with the child's traceback; the pool's
  processes are stopped on ``close``.
"""
from __future__ import annotations

import contextlib
import datetime
import faulthandler
import io
import multiprocessing
import os
import queue as queue_lib
import signal
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_SUB_WORLD: Optional[Tuple[int, ...]] = None
_GROUPS: Dict[Tuple[Tuple[int, ...], str, str], "Subgroup"] = {}
_STORE = None  # the world's store (``init``)
_TIMEOUT = datetime.timedelta(seconds=600)


def env_world_size() -> int:
    """torchrun's ``WORLD_SIZE`` (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def wanted() -> bool:
    """Whether an entry point builds a process mesh: the process group
    is initialized, or torchrun started this process in a world of
    more than one."""
    return initialized() or env_world_size() > 1


def init(init_method: Optional[str] = None, *, rank: Optional[int] = None,
         world_size: Optional[int] = None, timeout_s: float = 600.0) -> None:
    """Join the world (once; later calls do nothing): ``rank`` and
    ``world_size`` default to torchrun's ``RANK`` / ``WORLD_SIZE``, and
    ``init_method`` to ``env://`` (its ``MASTER_ADDR`` / ``MASTER_PORT``).
    The world's group is gloo; its store keeps the subgroups'
    rendezvous (``group``)."""
    global _STORE, _TIMEOUT
    if initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = env_world_size() if world_size is None else world_size
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank, world_size, timeout=_TIMEOUT))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)
    _STORE = store


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK``; without it (a spawned world on one
    host) the rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank()


def world() -> Tuple[int, ...]:
    """The ranks a compile places its mesh over: ``sub_world``'s, else
    every rank of the world."""
    if _SUB_WORLD is not None:
        return _SUB_WORLD
    return tuple(range(dist.get_world_size()))


@contextlib.contextmanager
def sub_world(ranks: Sequence[int]):
    """Within the block, ``world()`` is ``ranks`` (this process among
    them): meshes compiled there span those ranks only."""
    global _SUB_WORLD
    ranks = tuple(int(r) for r in ranks)
    if dist.get_rank() not in ranks:
        raise ValueError(f"rank {dist.get_rank()} is not in {ranks}")
    before, _SUB_WORLD = _SUB_WORLD, ranks
    try:
        yield
    finally:
        _SUB_WORLD = before


class Subgroup:
    """A ``torch.distributed`` backend over ``ranks`` (world ranks,
    ascending; this process among them), its collectives addressed by
    member index (``index`` is this process's). Its rendezvous keys are
    named by its ranks, backend and ``tag`` alone, so its members make it
    whatever other groups each has made before, and two backends over
    the same ranks differ by their tags."""

    def __init__(self, ranks: Tuple[int, ...], backend: str, tag: str = ""):
        store = _STORE
        if store is None:  # joined by the caller's own init_process_group
            store = dist.distributed_c10d._get_default_store()
        self.ranks = ranks
        self.index = ranks.index(dist.get_rank())
        prefix = (f"repro_torch/{backend}/" + "_".join(map(str, ranks))
                  + (f"/{tag}" if tag else ""))
        store = dist.PrefixStore(prefix, store)
        if backend == "gloo":
            self._pg = dist.ProcessGroupGloo(store, self.index, len(ranks),
                                             _TIMEOUT)
        elif backend == "nccl":
            self._pg = dist.ProcessGroupNCCL(store, self.index, len(ranks))
        else:
            raise ValueError(f"transport {backend!r}: 'gloo' or 'nccl'")

    def all_gather_start(self, outs: Sequence[torch.Tensor],
                         buf: torch.Tensor):
        """Queue ``outs[i]`` = member i's ``buf``: the work, which
        ``wait()`` completes (collectives run in the order queued)."""
        return self._pg.allgather([list(outs)], [buf])

    def all_gather(self, outs: Sequence[torch.Tensor],
                   buf: torch.Tensor) -> None:
        """``outs[i]`` = member i's ``buf``."""
        self.all_gather_start(outs, buf).wait()

    def send(self, buf: torch.Tensor, dst: int):
        """Queue ``buf`` to member ``dst``: the work, which ``wait()``
        completes (keep ``buf`` alive until then)."""
        return self._pg.send([buf], dst, 0)

    def recv(self, buf: torch.Tensor, src: int):
        """Post ``buf`` for member ``src``'s next send: the work, which
        ``wait()`` completes."""
        return self._pg.recv([buf], src, 0)

    def broadcast(self, buf: torch.Tensor, root: int = 0) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = root, 0
        self._pg.broadcast([buf], opts).wait()

    def barrier(self) -> None:
        self._pg.barrier(dist.BarrierOptions()).wait()

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every member's picklable ``obj``, in member order (gloo)."""
        data = torch.frombuffer(bytearray(_encode(obj)), dtype=torch.uint8)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in self.ranks]
        self.all_gather(sizes, torch.tensor([data.numel()]))
        n = int(max(t.item() for t in sizes))
        buf = torch.zeros(n, dtype=torch.uint8)
        buf[:data.numel()] = data
        outs = [torch.empty(n, dtype=torch.uint8) for _ in self.ranks]
        self.all_gather(outs, buf)
        return [_decode(o[:int(k.item())].numpy().tobytes())
                for o, k in zip(outs, sizes)]


def group(ranks: Sequence[int], backend: str = "gloo",
          tag: str = "") -> Subgroup:
    """The subgroup of ``ranks`` over ``backend`` (``tag`` tells apart
    two over the same ranks), made at first use by its members only and
    kept for the process's life."""
    key = (tuple(ranks), backend, tag)
    g = _GROUPS.get(key)
    if g is None:
        g = _GROUPS[key] = Subgroup(key[0], backend, tag)
    return g


class Link:
    """The hand-off link between this process and world rank ``peer``
    over ``backend``: ``send`` queues a buffer on this process's
    outgoing backend, ``recv`` posts one on the peer's, two two-rank
    backends that carry nothing else (tagged by direction, made by both
    ranks in one order: the lower rank's direction first). Each
    direction delivers in the order its sender queued."""

    def __init__(self, peer: int, backend: str):
        me = dist.get_rank()
        pair = tuple(sorted((me, peer)))
        ways = {(a, b): group(pair, backend, tag=f"{a}>{b}")
                for a, b in (pair, pair[::-1])}
        self.peer, self.backend = peer, backend
        self._out, self._in = ways[(me, peer)], ways[(peer, me)]
        self._at = pair.index(peer)

    def send(self, buf: torch.Tensor):
        return self._out.send(buf, self._at)

    def recv(self, buf: torch.Tensor):
        return self._in.recv(buf, self._at)


# ------------------------------------------------------------ pools ----
def _encode(value: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(value, buf)
    return buf.getvalue()


def _decode(data: bytes) -> Any:
    return torch.load(io.BytesIO(data), weights_only=False)


def _worker(rank: int, world_size: int, init_method: str, inbox, outbox,
            env: Dict[str, str]) -> None:
    """A pool's process: join the world, then run jobs until ``None``.
    ``SIGUSR1`` prints every thread's stack (``Pool`` sends it to a
    child that does not answer)."""
    os.environ.update(env)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.set_num_threads(1)
    try:
        init(init_method, rank=rank, world_size=world_size)
    except BaseException:  # noqa: BLE001 — reported to the parent
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, None))
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args, ranks = _decode(job)
        try:
            with sub_world(ranks):
                out = (rank, True, _encode(fn(*args)))
        except BaseException:  # noqa: BLE001 — reported to the parent
            out = (rank, False, traceback.format_exc())
        outbox.put(out)
    dist.destroy_process_group()


class PoolError(RuntimeError):
    """A pool's job raised in a child, or the pool did not answer."""


class Pool:
    """``world_size`` spawned processes in one world (``init_method``: a
    ``file://`` path no other world uses). ``run(fn, *args, ranks=...)``
    runs ``fn(*args)`` on each of ``ranks`` (default: every rank) under
    ``sub_world(ranks)`` and returns their results in rank order; two
    ``submit``s on disjoint ranks run at once, ``result`` collects.
    ``env`` is set in each child before it imports anything of the
    job. A child that does not answer in time is asked for its threads'
    stacks (on its stderr) before the pool stops."""

    def __init__(self, world_size: int, init_method: str, *,
                 timeout_s: float = 600.0,
                 env: Optional[Dict[str, str]] = None):
        ctx = multiprocessing.get_context("spawn")
        self.world_size, self.timeout_s = world_size, timeout_s
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world_size)]
        self._done: Dict[int, Tuple[bool, Any]] = {}
        self._procs = [ctx.Process(
            target=_worker, name=f"procmesh-{r}", daemon=True,
            args=(r, world_size, init_method, self._inboxes[r],
                  self._outbox, dict(env or {})))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        try:
            self._collect(range(world_size), "joining the world")
        except BaseException:
            self.close()
            raise

    def _collect(self, ranks, what: str) -> List[Any]:
        want = set(ranks)
        deadline = time.monotonic() + self.timeout_s
        while not want <= set(self._done):
            left = deadline - time.monotonic()
            dead = [p.name for p in self._procs if not p.is_alive()]
            if left <= 0 or dead:
                for p in self._procs:  # where each child is stuck
                    if p.is_alive():
                        os.kill(p.pid, signal.SIGUSR1)
                time.sleep(2.0)
                self.close()
                raise PoolError(
                    f"{what}: ranks {sorted(want - set(self._done))} did not "
                    f"answer within {self.timeout_s:.0f} s"
                    + (f" (exited: {dead})" if dead else ""))
            try:
                rank, ok, value = self._outbox.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                continue
            self._done[rank] = (ok, value)
        got = [self._done.pop(r) for r in sorted(want)]
        failed = [(r, v) for r, (ok, v) in zip(sorted(want), got) if not ok]
        if failed:
            raise PoolError(f"{what} failed on rank {failed[0][0]}:\n"
                            f"{failed[0][1]}")
        return [v for _, v in got]

    def submit(self, fn: Callable, *args,
               ranks: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        ranks = tuple(range(self.world_size)) if ranks is None else tuple(
            ranks)
        job = _encode((fn, args, ranks))
        for r in ranks:
            self._inboxes[r].put(job)
        return ranks

    def result(self, ranks: Sequence[int], what: str = "job") -> List[Any]:
        return [_decode(v) for v in self._collect(ranks, what)]

    def run(self, fn: Callable, *args,
            ranks: Optional[Sequence[int]] = None) -> List[Any]:
        return self.result(self.submit(fn, *args, ranks=ranks),
                           getattr(fn, "__name__", "job"))

    def close(self) -> None:
        for q, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn: Callable, world_size: int, init_method: str, *args,
          timeout_s: float = 600.0,
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``fn(*args)`` on every rank of a fresh ``world_size``-process
    world (``Pool``); their results in rank order."""
    with Pool(world_size, init_method, timeout_s=timeout_s, env=env) as pool:
        return pool.run(fn, *args)


__all__ = ["Link", "Pool", "PoolError", "Subgroup", "env_world_size",
           "group",
           "init",
           "initialized", "local_rank", "spawn", "sub_world", "wanted",
           "world"]
