"""In-process SPMD over a ``launch.mesh.Mesh``: the port's counterpart of
``shard_map`` and of the ``lax`` collectives the reference reaches
through ``core/compat.py``.

``run(mesh, fn, *per_shard_args)`` calls ``fn`` once per shard, each in
a worker thread of its own, with the shard's device current and, on a
CUDA device, the shard's own stream current. Inside ``fn``,
``axis(name)`` is the shard's group along one mesh axis: ``index``,
``size``, ``ppermute``, ``psum`` and ``all_gather``, with the semantics
of ``lax.axis_index`` / ``lax.axis_size`` / ``lax.ppermute`` /
``lax.psum`` / ``lax.all_gather(tiled=True)``:

* ``ppermute`` gives each destination its source's tensor: the tensor
  itself where both lie on one device (a collective's inputs are
  read-only), else a copy into the destination's device; a destination
  no pair names gets zeros. ``ppermute_start`` does the same but hands
  back a ``Received``: the destination's stream waits for the source
  only at ``wait()``, so work enqueued before that does not.
* ``psum`` adds the group's tensors in rank order (0 + 1 + ...), on
  every shard alike, so a result does not vary from run to run. A tuple
  is summed element by element, each on its own, in one exchange.

The shards take turns on the host, in rank order: a shard runs until
its next collective, deposits its tensor and hands the turn on; when its
turn comes back every shard has deposited, and it reads its peers'.
Only one worker thread runs Python at a time, so the shards never
contend for the interpreter lock, and the order of every host-side
operation is the same on every run; the device work of the shards still
overlaps, each on its own stream. A peer's tensor is read on the
reader's stream after an event recorded on the writer's stream, and
``record_stream`` tells the caching allocator about that use. A shard
that raises ends the run: the others stop at their next turn and ``run``
raises its error.

Outside ``run`` every axis has size 1 (the one-device mesh). The
interface is kept narrow so that a ``torch.distributed`` group can stand
behind it for runs over several processes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

_LOCAL = threading.local()


class ShardAborted(RuntimeError):
    """Another shard of the run failed while this one waited."""


class _Run:
    """What the shards of one ``run`` share: whose turn it is, and two
    sets of deposit slots used alternately by successive collectives (a
    shard reads collective k's set in its next turn, before any shard
    can deposit collective k + 2 into it)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.turn = [threading.Event() for _ in range(mesh.size)]
        self.done = [False] * mesh.size
        self.failed = False
        self.slots = ([None] * mesh.size, [None] * mesh.size)

    def wait_turn(self, rank: int) -> None:
        self.turn[rank].wait()
        self.turn[rank].clear()
        if self.failed:
            raise ShardAborted("another shard of the run failed")

    def pass_turn(self, rank: int) -> None:
        self.turn[(rank + 1) % self.mesh.size].set()

    def abort(self) -> None:
        self.failed = True
        for ev in self.turn:
            ev.set()


def _mark(t):
    """(t, event recorded on t's current stream) for a CUDA tensor."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return t, ev
    return t, None


def _read(entry, device: torch.device):
    """A peer's tensor for use on ``device``'s current stream: the peer's
    own tensor when it lies there, else a copy."""
    t, ev = entry
    if not isinstance(t, torch.Tensor):
        return t
    if ev is None:  # CPU
        return t.to(device)
    torch.cuda.current_stream(device).wait_event(ev)
    if t.device == device:
        out = t
    else:
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        # a copy between cards runs on the source card's current stream
        # of this thread, after the destination's stream (which waited on
        # ``ev`` above); PyTorch orders the two streams around it
        out.copy_(t, non_blocking=True)
    t.record_stream(torch.cuda.current_stream(t.device))
    return out


class Received:
    """A tensor a collective delivers, made ready on the reader's
    current stream by the first ``wait()`` (later calls return it
    again)."""

    def __init__(self, get: Callable[[], Any]):
        self._get: Optional[Callable[[], Any]] = get
        self._value: Any = None

    def wait(self):
        if self._get is not None:
            self._value, self._get = self._get(), None
        return self._value


class Group:
    """One shard's view of its group along one mesh axis."""

    def __init__(self, axis: str, run: Optional[_Run], rank: int):
        self.axis = axis
        self._run = run
        self._rank = rank
        if run is None:
            self.ranks: Tuple[int, ...] = (0,)
            self.device: Optional[torch.device] = None
        else:
            self.ranks = run.mesh.group(rank, axis)
            self.device = run.mesh.devices[rank]

    @property
    def index(self) -> int:
        return self.ranks.index(self._rank) if self._run else 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _exchange(self, value) -> List[Any]:
        """Deposit ``value``, let every other shard reach this collective,
        and return the group's deposits in axis order."""
        run, shard = self._run, _LOCAL.shard
        slots = run.slots[shard.collectives % 2]
        shard.collectives += 1
        slots[self._rank] = value
        if any(run.done):
            raise RuntimeError("the shards of a run reached different "
                               "collectives")
        run.pass_turn(self._rank)
        run.wait_turn(self._rank)
        return [slots[r] for r in self.ranks]

    def ppermute(self, t: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Each (src, dst) pair sends src's ``t`` to dst (axis indices);
        a destination no pair names receives zeros."""
        return self.ppermute_start(t, perm).wait()

    def ppermute_start(self, t: torch.Tensor,
                       perm: Sequence[Tuple[int, int]]) -> Received:
        """``ppermute`` whose result this shard's stream waits for only
        at ``wait()``. The shards meet on the host here, at the call."""
        src = {d: s for s, d in perm}.get(self.index)
        if self.size == 1:
            return Received(lambda: t if src == 0 else torch.zeros_like(t))
        peers = self._exchange(_mark(t))
        if src is None:
            return Received(lambda: torch.zeros_like(t))
        entry, device = peers[src], self.device
        return Received(lambda: _read(entry, device))

    def psum(self, t):
        """The sum of the group's ``t`` in axis order: a tensor, a
        Python number, or a tuple of them summed element by element."""
        if self.size == 1:
            return t
        parts = tuple(t) if isinstance(t, tuple) else (t,)
        peers = self._exchange(tuple(_mark(p) for p in parts))
        out = []
        for i in range(len(parts)):
            acc = _read(peers[0][i], self.device)
            for p in peers[1:]:
                acc = acc + _read(p[i], self.device)
            out.append(acc)
        return tuple(out) if isinstance(t, tuple) else out[0]

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's ``t`` concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return t
        peers = self._exchange(_mark(t))
        shape = list(t.shape)
        w = shape[dim]
        shape[dim] = w * self.size
        out = torch.empty(shape, dtype=t.dtype, device=self.device)
        for i, p in enumerate(peers):
            out.narrow(dim, i * w, w).copy_(_read(p, self.device))
        return out


class _Shard:
    def __init__(self, run: _Run, rank: int):
        self.run = run
        self.rank = rank
        self.collectives = 0


def current_mesh():
    """The mesh of the ``run`` this thread is a shard of (None outside
    any run)."""
    shard = getattr(_LOCAL, "shard", None)
    return None if shard is None else shard.run.mesh


def axis(name: str) -> Group:
    """This shard's group along mesh axis ``name`` (size 1 outside a
    ``run``)."""
    shard = getattr(_LOCAL, "shard", None)
    if shard is None:
        return Group(name, None, 0)
    if name not in shard.run.mesh.axis_names:
        raise KeyError(f"mesh {shard.run.mesh.shape} has no axis {name!r}")
    return Group(name, shard.run, shard.rank)


def check_mesh(axes: Sequence[Tuple[str, int]], what: str) -> None:
    """Raise unless the current mesh (outside a run: one device) has
    every one of ``axes`` at its degree."""
    mesh = current_mesh()
    have = {} if mesh is None else mesh.shape
    for a, n in axes:
        if have.get(a, 1) != n:
            where = ("outside spmd.run, on one device" if mesh is None
                     else f"on mesh {have}")
            raise ValueError(
                f"{what} needs axis {a!r} of degree {n}, but runs {where}: "
                f"run it inside spmd.run over a mesh of its degrees "
                f"(train_step.make_convnet_forward_step does)")


@contextlib.contextmanager
def _as_shard(run: _Run, rank: int, grad: bool, inference: bool):
    """Enter shard ``rank``'s thread-local state: grad and inference
    mode, its device and its stream."""
    device = run.mesh.devices[rank]
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode(inference))
        stack.enter_context(torch.set_grad_enabled(grad))
        if device.type == "cuda":
            stack.enter_context(torch.cuda.device(device))
            stream = run.mesh.stream(rank)
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        _LOCAL.shard = _Shard(run, rank)
        try:
            yield
        finally:
            _LOCAL.shard = None


def run(mesh, fn: Callable, *per_shard_args: Sequence[Any]) -> List[Any]:
    """``[fn(*args of shard r) for r in shards]``, one thread per shard,
    the shards taking turns between collectives; ``per_shard_args`` are
    sequences with one entry per shard. A one-shard mesh runs ``fn`` in
    the calling thread on its current stream. Raises the first error a
    shard raised (by rank)."""
    for a in per_shard_args:
        if len(a) != mesh.size:
            raise ValueError(f"{len(a)} arguments for {mesh.size} shards")
    grad, inference = (torch.is_grad_enabled(),
                       torch.is_inference_mode_enabled())
    if mesh.size == 1:
        run_ = _Run(mesh)
        _LOCAL.shard = _Shard(run_, 0)
        try:
            return [fn(*(a[0] for a in per_shard_args))]
        finally:
            _LOCAL.shard = None
    results: List[Any] = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size
    with mesh.lock:
        run_ = _Run(mesh)
        cuda_devs = {d for d in mesh.devices if d.type == "cuda"}
        callers = {d: torch.cuda.current_stream(d) for d in cuda_devs}
        for r, d in enumerate(mesh.devices):
            if d.type == "cuda":  # the shard sees what the caller enqueued
                mesh.stream(r).wait_stream(callers[d])

        def shard_main(r: int) -> None:
            try:
                run_.wait_turn(r)
                with _as_shard(run_, r, grad, inference):
                    results[r] = fn(*(a[r] for a in per_shard_args))
                run_.done[r] = True
                run_.pass_turn(r)
            except BaseException as e:  # noqa: BLE001 — re-raised by run
                errors[r] = e
                run_.abort()

        threads = [threading.Thread(target=shard_main, args=(r,),
                                    name=f"spmd-shard-{r}", daemon=True)
                   for r in range(mesh.size)]
        for t in threads:
            t.start()
        run_.turn[0].set()
        for t in threads:
            t.join()
        for r, d in enumerate(mesh.devices):
            if d.type == "cuda":  # the caller sees what the shard enqueued
                callers[d].wait_stream(mesh.stream(r))
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed if not isinstance(e, ShardAborted)),
                     failed[0])
        raise first
    return results


__all__ = ["Group", "Received", "ShardAborted", "axis", "check_mesh",
           "current_mesh", "run"]
