"""In-process SPMD over a ``launch.mesh.Mesh``: the port's counterpart of
``shard_map`` and of the ``lax`` collectives the reference reaches
through ``core/compat.py``, with their gradients.

``run(mesh, fn, *per_shard_args)`` calls ``fn`` once per shard, each in
a worker thread of its own, with the shard's device current and, on a
CUDA device, the shard's own stream current. Inside ``fn``,
``axis(names)`` is the shard's group along one mesh axis or several
(the ranks that share every other coordinate, in rank order):
``index``, ``size``, ``ppermute``, ``psum``, ``psum_scatter``,
``all_gather``, ``all_to_all`` and ``psum_grad``, with the semantics of
``lax.axis_index`` / ``lax.axis_size`` / ``lax.ppermute`` /
``lax.psum`` / ``lax.psum_scatter(tiled=True)`` /
``lax.all_gather(tiled=True)`` / ``lax.all_to_all(tiled=True)``:

* ``ppermute`` gives each destination its source's tensor: the tensor
  itself where both lie on one device (a collective's inputs are
  read-only), else a copy into the destination's device; a destination
  no pair names gets zeros. ``ppermute_start`` does the same but hands
  back a ``Received``: the destination's stream waits for the source
  only at ``wait()``, so work enqueued before that does not.
* ``psum`` adds the group's tensors in rank order (0 + 1 + ...), on
  every shard alike, so a result does not vary from run to run. A tuple
  is summed element by element, each on its own, in one exchange.
  ``psum_scatter`` adds in the same order and hands shard ``index`` its
  chunk of the sum (ZeRO-1's gradient reduction; no gradient).
* ``psum_grad`` hands its tensors back unchanged; in the backward their
  cotangents, concatenated flat, are summed over the group once (the
  reference's gradient-reduction hooks, ``core/grad_comm.py``): over
  several axes axis by axis, the mesh's minor axis first (over a data
  x spatial group the spatial peers' sums, then those summed in data
  order), each axis in rank order — the order in which ZeRO-1's spatial
  hooks and its data reduce-scatter add, so that every gradient
  reduction adds the same numbers in the same order.

The shards take turns on the host, in rank order: a shard runs until
its next collective, deposits its tensor and hands the turn on. The
last to deposit (the highest rank) applies the collective once for the
whole mesh, computing each shard's result on that shard's stream, and
when a shard's turn comes back it takes its result. Only one worker
thread runs Python at a time, so the shards never contend for the
interpreter lock, and the order of every host-side operation is the
same on every run; the device work of the shards still overlaps, each
on its own stream. A peer's tensor is read on the reader's stream after
an event recorded on the writer's stream, and ``record_stream`` tells
the caching allocator about that use. A shard that raises ends the run:
the others stop at their next turn and ``run`` raises its error.

Gradients. Where autograd records, each collective is ONE autograd node
over the tensors of every shard of its group, so a backward over the
shards' losses run from one thread (``torch.autograd.grad(losses,
...)``, ``train/train_step.py``) meets each collective's adjoint as a
data dependency, with no rendezvous: ``ppermute``'s is the inverse
permutation, ``psum``'s the ``psum`` of the cotangents, ``all_gather``'s
the group's cotangents summed and sliced to each shard (a
reduce-scatter), ``all_to_all``'s the reverse ``all_to_all`` — the
transposes of the reference's ``shard_map``. (A backward per shard
thread, meeting its peers inside a collective's
backward, would hang on a card: PyTorch's autograd engine runs every
CUDA node of every caller on one worker thread per device, and a
blocked node starves the peers it waits for.) Autograd replays each
node on the stream its forward ran on and orders the streams by events.
Gradients through collectives are defined for groups on one device.

Rematerialization. ``checkpoint(fn, *args)`` runs a block ``fn`` with
autograd off on every shard, saving only its inputs, and is itself ONE
autograd node over every shard (deposited like a collective). Its
backward runs ``fn`` again with gradients on through ``run`` over the
same mesh, so the block's halo exchanges and statistics sums meet every
shard of their groups again, each one node as above, and then takes one
nested ``torch.autograd.grad`` over every shard's output. (A
``torch.utils.checkpoint`` per shard would recompute in the thread of
the backward, where every axis has size 1: with zero halos and local
statistics, and no error.)

Outside ``run`` every axis has size 1 (the one-device mesh).

Over processes. On a ``launch.mesh.ProcessMesh`` (one process per
shard) ``run`` calls ``fn`` once, for this process's shard, in the
calling thread on its current stream, and ``axis(names)`` hands back a
group whose collectives go through ``torch.distributed``, over the
mesh's subgroup of those axes. Each is an ``autograd.Function`` of the
local tensors whose backward is its adjoint's collective, so the train
step takes each process's own loss through one ``autograd.grad`` and
the adjoints meet their peers inside each process's own autograd engine
(the pattern of ``DistributedDataParallel``; the hang above needs
several shards in one engine). The sums are the in-process mesh's, to
the bit: ``psum``, ``psum_grad``, ``psum_scatter`` and the adjoint of
``all_gather`` gather every member's tensor and add them here in rank
order (``psum_grad`` the spatial peers first), never by a ring
all-reduce, whose order differs. ``all_to_all`` is a gather and a
slice, in the in-process mesh's block order (the planner's spatial ->
batch moves, ``core/reshard.py``: one node whose adjoint meets the
peers' in each rank's one backward, beside the halo and statistics
exchanges). ``ppermute`` is a gather too, queued at ``ppermute_start``
(asynchronous) and completed at ``Received.wait``: every exchange goes
through the group's queue of collectives, in the same order on every
rank, with no point-to-point message beside them (on one H100 over
gloo, sends and receives interleaved with the statistics' gathers hung
a 128^3 step). Every rank must issue every collective in the same
order (``ProcessMesh.log`` records it), so every rank builds the same
graph, and its engine meets the adjoints in the same order: a
ppermute's result passes through one node on every rank, zeros where
no pair sends to it, and a halo slab a boundary shard fills with zeros
is a node of the received buffer too (``Group.slab``).
With gloo a CUDA tensor is copied into a pinned host buffer after an
event on its stream, and what arrives is copied back onto the reader's
stream; with NCCL (every shard a card of its own) tensors go as they
are. ``checkpoint`` over processes is one autograd node of this
rank's block: its backward re-runs the block through ``run`` in the
autograd engine's thread, where the re-run's halo exchanges and
statistics sums meet the peers' re-runs, then takes one nested
``autograd.grad``; every rank builds the same graph, so every rank meets
its recompute at the same point of its backward (``ProcessMesh.log``
records ``checkpoint`` and ``recompute`` among the collectives).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as trace_lib

_LOCAL = threading.local()


class ShardAborted(RuntimeError):
    """Another shard of the run failed while this one waited."""


class _Run:
    """What the shards of one ``run`` share: whose turn it is, and two
    sets of deposit and result slots used alternately by successive
    collectives (a shard takes collective k's result in its next turn,
    before any shard can deposit collective k + 2)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.turn = [threading.Event() for _ in range(mesh.size)]
        self.done = [False] * mesh.size
        self.failed = False
        self.slots = ([None] * mesh.size, [None] * mesh.size)
        self.results: List[Optional[List[Any]]] = [None, None]

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

    def apply(self, slots: Sequence[Any], fn: Callable) -> List[Any]:
        """One result per rank: ``fn(ranks, deposits)`` for each group of
        the collective's axes, every deposit ``(kind, axes, value)``."""
        tags = {s[:2] for s in slots}
        if len(tags) != 1:
            raise RuntimeError(f"the shards of a run reached different "
                               f"collectives: {sorted(tags)}")
        axes = slots[0][1]
        out: List[Any] = [None] * self.mesh.size
        for ranks in sorted(set(self.mesh.groups(axes))):
            for r, v in zip(ranks, fn(ranks, [slots[r][2] for r in ranks])):
                out[r] = v
        return out


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


@contextlib.contextmanager
def _on(mesh, rank: int):
    """Shard ``rank``'s device and stream made current, so that work the
    applying shard enqueues for ``rank`` runs where ``rank``'s own
    would."""
    device = mesh.devices[rank]
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(mesh.stream(rank)):
        yield


def _records(ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


class _Route(torch.autograd.Function):
    """``ppermute``'s node: the i-th output is the i-th pair's source
    tensor, handed to its destination (a view: no copy on one device);
    the i-th cotangent goes back to the i-th source, the inverse
    permutation."""

    @staticmethod
    def forward(ctx, *srcs):
        return tuple(t.view_as(t) for t in srcs)

    @staticmethod
    def backward(ctx, *grads):
        return grads


class _Sum(torch.autograd.Function):
    """``psum``'s node over one group: ``xs`` member-major (member 0's
    ``n`` tensors, then member 1's, ...). Each member's sums are computed
    on its own stream, the members added in rank order; the cotangents
    of each element are summed over the members in rank order and handed
    to every member."""

    @staticmethod
    def forward(ctx, plan, *xs):
        ctx.n = plan[3]
        return _Sum.sums(plan, xs)

    @staticmethod
    def sums(plan, xs):
        mesh, ranks, events, n = plan
        outs = []
        for r in ranks:
            device = mesh.devices[r]
            with _on(mesh, r):
                for i in range(n):
                    acc = _read((xs[i], events[i]), device)
                    for m in range(1, len(ranks)):
                        j = m * n + i
                        acc = acc + _read((xs[j], events[j]), device)
                    outs.append(acc)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        totals = []
        for i in range(n):
            acc = grads[i]
            for j in range(i + n, len(grads), n):
                acc = acc + grads[j]
            totals.append(acc)
        return (None,) + tuple(totals[j % n] for j in range(len(grads)))


class _Gather(torch.autograd.Function):
    """``all_gather``'s node over one group: each member's output, the
    members' tensors concatenated along ``dim`` in rank order, written
    on its own stream. The adjoint sums the members' cotangents in rank
    order and hands each member its slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, plan, *xs):
        ctx.dim, ctx.w = plan[3], xs[0].shape[plan[3]]
        return _Gather.gathers(plan, xs)

    @staticmethod
    def gathers(plan, xs):
        mesh, ranks, events, dim = plan
        w = xs[0].shape[dim]
        shape = list(xs[0].shape)
        shape[dim] = w * len(xs)
        outs = []
        for r in ranks:
            device = mesh.devices[r]
            with _on(mesh, r):
                out = torch.empty(shape, dtype=xs[0].dtype, device=device)
                for i, (x, ev) in enumerate(zip(xs, events)):
                    out.narrow(dim, i * w, w).copy_(_read((x, ev), device))
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return (None,) + tuple(total.narrow(ctx.dim, i * ctx.w, ctx.w)
                               for i in range(len(grads)))


class _AllToAll(torch.autograd.Function):
    """``all_to_all``'s node over one group: member i's output is chunk
    i (along ``split``) of every member's tensor, concatenated along
    ``concat`` in rank order, written on its own stream. The adjoint is
    the reverse all_to_all: member j's cotangent is chunk j (along
    ``concat``) of every member's output cotangent, concatenated along
    ``split``."""

    @staticmethod
    def forward(ctx, plan, *xs):
        ctx.split, ctx.concat = plan[3], plan[4]
        return _AllToAll.exchange(plan, xs)

    @staticmethod
    def exchange(plan, xs):
        mesh, ranks, events, split, concat = plan
        c = xs[0].shape[split] // len(xs)
        w = xs[0].shape[concat]
        shape = list(xs[0].shape)
        shape[split], shape[concat] = c, w * len(xs)
        outs = []
        for i, r in enumerate(ranks):
            device = mesh.devices[r]
            with _on(mesh, r):
                out = torch.empty(shape, dtype=xs[0].dtype, device=device)
                for j, (x, ev) in enumerate(zip(xs, events)):
                    out.narrow(concat, j * w, w).copy_(
                        _read((x, ev), device).narrow(split, i * c, c))
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = len(grads)
        w = grads[0].shape[ctx.concat] // n
        return (None,) + tuple(
            torch.cat([g.narrow(ctx.concat, j * w, w) for g in grads],
                      ctx.split) for j in range(n))


def _nested_sum(xs: Sequence[torch.Tensor],
                degrees: Sequence[int]) -> torch.Tensor:
    """The sum of ``xs`` (row-major over axes of ``degrees``), the last
    axis first: each run of ``degrees[-1]`` added in order, then those
    sums over the axis before it, and so on."""
    if len(degrees) > 1:
        step = len(xs) // degrees[0]
        xs = [_nested_sum(xs[i:i + step], degrees[1:])
              for i in range(0, len(xs), step)]
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


class _PsumGrad(torch.autograd.Function):
    """``psum_grad``'s node over one group: the identity on every
    member's ``n`` tensors (member-major); the adjoint concatenates each
    member's cotangents flat, sums the members', once, the minor axis of
    the group's ``degrees`` first (``_nested_sum``), and hands every
    member the pieces. Each backward is one reduction, counted on the
    active tracer (``grad_comm.reductions``, and a ``grad_comm.reduce``
    instant)."""

    @staticmethod
    def forward(ctx, n, degrees, *xs):
        ctx.n, ctx.degrees = n, degrees
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        trace_lib.count("grad_comm.reductions")
        trace_lib.instant("grad_comm.reduce")
        n = ctx.n
        members = [grads[i:i + n] for i in range(0, len(grads), n)]
        flats = [torch.cat([g.reshape(-1) for g in gs]) if n > 1
                 else gs[0].reshape(-1) for gs in members]
        total = _nested_sum(flats, ctx.degrees)
        parts, off = [], 0
        for g in members[0]:
            parts.append(total[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return (None, None) + tuple(parts) * len(members)


class _Recompute(torch.autograd.Function):
    """``checkpoint``'s node over every shard of a mesh (``plan.mesh``;
    None outside ``run``): ``flat`` is every shard's inputs,
    member-major, saved as they are; the outputs are the shards' outputs
    of the forward, computed before with autograd off. The backward
    runs ``plan.fn`` again over the saved inputs with gradients on — on
    every shard together through ``run``, so its collectives are nodes
    over every shard again — and takes one nested ``autograd.grad`` of
    every shard's output."""

    @staticmethod
    def forward(ctx, plan, *flat):
        ctx.plan = plan
        ctx.save_for_backward(*flat)
        outs, plan.outs = plan.outs, None  # the node does not hold them
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        n = plan.n_args
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, plan.needs)]
        shards = [ins[r * n:(r + 1) * n] for r in range(len(grads))]

        def again(event, *args):
            if event is not None:  # the forward's output is written
                stream = torch.cuda.current_stream()  # the shard's
                stream.wait_event(event)
                for t in args:  # read on this stream, freed by the node
                    t.record_stream(stream)
            return plan.fn(*args)

        _log_block(plan.mesh, "recompute", ins)
        with torch.enable_grad():
            if plan.mesh is None:
                outs = [plan.fn(*shards[0])]
            else:
                outs = run(plan.mesh, again, plan.events, *zip(*shards))
        wrt = [t for t in ins if t.requires_grad]
        found = iter(torch.autograd.grad(outs, wrt, grads,
                                         allow_unused=True))
        out = []
        for t in ins:
            g = next(found) if t.requires_grad else None
            if g is not None and g.device.type == "cuda":
                # made on the shard's stream, read on the node's
                g.record_stream(torch.cuda.current_stream(g.device))
            out.append(g)
        return (None,) + tuple(out)


def _log_block(mesh, kind: str, tensors: Sequence[torch.Tensor]) -> None:
    """A rematerialized block's forward or recompute in a process mesh's
    log, beside its collectives."""
    if _over_processes(mesh):
        mesh.log.append((kind, mesh.axis_names,
                         tuple(tuple(t.shape) for t in tensors)))


class _CheckpointPlan:
    """What ``_Recompute`` needs: the mesh (None: no run), the block, its
    argument count per shard, which inputs need gradients, and the
    forward's outputs and their events (one per shard)."""

    def __init__(self, mesh, fn, n_args, needs, outs, events):
        self.mesh, self.fn, self.n_args = mesh, fn, n_args
        self.needs, self.outs, self.events = tuple(needs), outs, events


def checkpoint(fn: Callable[..., torch.Tensor],
               *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` (tensors in, one tensor out) rematerialized: where
    autograd records, ``fn`` runs with autograd off and only ``args``
    are saved; the backward runs ``fn`` again, on every shard of the
    current run together (the module docstring), before it takes the
    gradients. The same value as ``fn(*args)`` and the same gradients.
    Every shard of a run must reach it, as a collective. Elsewhere it is
    ``fn(*args)``."""
    if not _records(args):
        return fn(*args)
    if not all(isinstance(t, torch.Tensor) for t in args):
        raise TypeError("checkpoint takes tensor arguments only")
    shard = getattr(_LOCAL, "shard", None)
    with torch.no_grad():
        out = fn(*args)
    needs = [t.requires_grad for t in args]
    if (shard is None or shard.run.mesh.size == 1
            or isinstance(shard.run, _ProcRun)):
        mesh = None if shard is None else shard.run.mesh
        _log_block(mesh, "checkpoint", args)
        plan = _CheckpointPlan(mesh, fn, len(args), needs, [out],
                               [_mark(out)[1]])
        return _Recompute.apply(plan, *args)[0]
    mesh = shard.run.mesh

    def node(ranks, entries):
        plan = _CheckpointPlan(
            mesh, fn, len(args), [nd for e in entries for nd in e[1]],
            [e[2][0] for e in entries], [e[2][1] for e in entries])
        return list(_Recompute.apply(plan, *(t for e in entries
                                            for t in e[0])))

    group = Group(mesh.axis_names, shard.run, shard.rank)
    return group._collective("checkpoint", (args, needs, _mark(out)), node)


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
    """One shard's view of its group along one or more mesh axes."""

    def __init__(self, axes: Tuple[str, ...], run: Optional[_Run],
                 rank: int):
        self.axes = axes
        self._run = run
        self._rank = rank
        if run is None:
            self.ranks: Tuple[int, ...] = (0,)
            self.device: Optional[torch.device] = None
        else:
            self.ranks = run.mesh.group(rank, axes)
            self.device = run.mesh.devices[rank]

    @property
    def index(self) -> int:
        return self.ranks.index(self._rank) if self._run else 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _collective(self, kind: str, value, fn: Callable):
        """Deposit ``value``, let every other shard reach this
        collective, and return this shard's result. The last shard to
        deposit computes every shard's: ``fn(ranks, deposits)`` per
        group, one result per member."""
        run, shard = self._run, _LOCAL.shard
        k = shard.collectives % 2
        shard.collectives += 1
        run.slots[k][self._rank] = (kind, self.axes, value)
        if any(run.done):
            raise RuntimeError("the shards of a run reached different "
                               "collectives")
        if self._rank == run.mesh.size - 1:
            run.results[k] = run.apply(run.slots[k], fn)
        run.pass_turn(self._rank)
        run.wait_turn(self._rank)
        return run.results[k][self._rank]

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
        devices = self._run.mesh.devices
        pairs = list(perm)

        def route(ranks, entries):
            srcs = [entries[s][0] for s, _ in pairs]
            if _records(srcs):
                if any(devices[ranks[s]] != devices[ranks[d]]
                       for s, d in pairs):
                    raise NotImplementedError(
                        "gradients of a ppermute between devices come with "
                        "the cross-process shard group")
                srcs = _Route.apply(*srcs)
            out: List[Any] = [None] * len(ranks)
            for (s, d), moved in zip(pairs, srcs):
                out[d] = (moved, entries[s][1])
            return out

        entry = self._collective("ppermute", _mark(t), route)
        if entry is None:
            return Received(lambda: torch.zeros_like(t))
        device = self.device
        return Received(lambda: _read(entry, device))

    def slab(self, recv: Received, start: int, stop: Optional[int],
             shape: Sequence[int], keep: bool,
             zeros: Callable[[], torch.Tensor]):
        """A slab of a received flat buffer, ``recv.wait()[start:stop]``
        viewed as ``shape`` where this shard ``keep``s it, else
        ``zeros()`` (a shard on the boundary): a ``Received`` or the
        zeros."""
        if keep:
            return Received(lambda: recv.wait()[start:stop].view(shape))
        return zeros()

    def psum(self, t):
        """The sum of the group's ``t`` in axis order: a tensor, a
        Python number, or a tuple of them summed element by element."""
        if self.size == 1:
            return t
        is_tuple = isinstance(t, tuple)
        parts = tuple(t) if is_tuple else (t,)
        mesh = self._run.mesh

        def add(ranks, entries):
            rows = [[None] * len(parts) for _ in ranks]
            tensors = [i for i, (v, _) in enumerate(entries[0])
                       if isinstance(v, torch.Tensor)]
            for i in range(len(parts)):
                if i not in tensors:
                    total = entries[0][i][0]
                    for e in entries[1:]:
                        total = total + e[i][0]
                    for row in rows:
                        row[i] = total
            if tensors:
                flat = [e[i] for e in entries for i in tensors]
                plan = (mesh, ranks, [ev for _, ev in flat], len(tensors))
                xs = [v for v, _ in flat]
                sums = (_Sum.apply(plan, *xs) if _records(xs)
                        else _Sum.sums(plan, xs))
                for m, row in enumerate(rows):
                    for j, i in enumerate(tensors):
                        row[i] = sums[m * len(tensors) + j]
            return [tuple(row) if is_tuple else row[0] for row in rows]

        return self._collective("psum", tuple(_mark(p) for p in parts), add)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's ``t`` concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return t
        mesh = self._run.mesh

        def gather(ranks, entries):
            plan = (mesh, ranks, [ev for _, ev in entries], dim)
            xs = [v for v, _ in entries]
            return (_Gather.apply(plan, *xs) if _records(xs)
                    else _Gather.gathers(plan, xs))

        return self._collective("all_gather", _mark(t), gather)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``t`` cut along ``split_dim`` into ``size`` chunks, chunk i
        sent to the group's member i; this shard's result is the chunks
        it receives, concatenated along ``concat_dim`` in axis order
        (``lax.all_to_all(..., tiled=True)``)."""
        if self.size == 1:
            return t
        if split_dim == concat_dim:
            raise ValueError("all_to_all needs two different dims")
        if t.shape[split_dim] % self.size:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                             f"cut into {self.size} chunks")
        mesh = self._run.mesh

        def exchange(ranks, entries):
            plan = (mesh, ranks, [ev for _, ev in entries], split_dim,
                    concat_dim)
            xs = [v for v, _ in entries]
            return (_AllToAll.apply(plan, *xs) if _records(xs)
                    else _AllToAll.exchange(plan, xs))

        return self._collective("all_to_all", _mark(t), exchange)

    def psum_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's ``t`` summed in rank order, as ``psum`` adds them,
        cut along ``dim`` into ``size`` equal chunks: this shard gets
        chunk ``index`` (``lax.psum_scatter(..., tiled=True)``). Records
        no gradient: it reduces gradients after the backward."""
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {self.size} chunks")
        mesh = self._run.mesh

        def scatter(ranks, entries):
            w = entries[0][0].shape[dim] // len(ranks)
            outs = []
            with torch.no_grad():
                for i, r in enumerate(ranks):
                    device = mesh.devices[r]
                    with _on(mesh, r):
                        parts = [_read(e, device).narrow(dim, i * w, w)
                                 for e in entries]
                        acc = parts[0] + parts[1]
                        for p in parts[2:]:
                            acc = acc + p
                    outs.append(acc)
            return outs

        return self._collective("psum_scatter", _mark(t), scatter)

    def psum_grad(self, ts: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
        """``ts`` unchanged (views); in the backward their cotangents,
        concatenated flat, are summed over the group once, the mesh's
        minor axis first (the module docstring), and every shard
        receives the sum. The identity where autograd does not record."""
        ts = tuple(ts)
        if self.size == 1 or not _records(ts):
            return ts
        n = len(ts)
        mesh = self._run.mesh
        degrees = tuple(mesh.degree(a) for a in mesh.axis_names
                        if a in self.axes)

        def mark(ranks, entries):
            outs = _PsumGrad.apply(n, degrees,
                                   *(x for e in entries for x in e))
            return [outs[m * n:(m + 1) * n] for m in range(len(ranks))]

        return self._collective("psum_grad", ts, mark)


# ------------------------------------------------- over processes ----
_ALIGN = 16  # bytes: every part of a wire buffer starts on this


def _nbytes(p) -> int:
    n = p.numel() * p.element_size() if isinstance(p, torch.Tensor) else 8
    return -(-n // _ALIGN) * _ALIGN


def _wire_buffer(staging: mesh_lib.Staging, nbytes: int) -> torch.Tensor:
    """A byte buffer of ``nbytes`` for the transport: pinned host memory
    where ``staging`` pins, else on its device."""
    return torch.empty(max(nbytes, _ALIGN), dtype=torch.uint8,
                       device="cpu" if staging.pinned else staging.device,
                       pin_memory=staging.pinned)


def _pack(staging: mesh_lib.Staging, parts: Sequence[Any]) -> torch.Tensor:
    """``parts`` (tensors on this rank's device, or Python numbers, as 8
    bytes) in one byte buffer of the transport's (``staging``, a mesh's
    or a link's): pinned host memory, filled after an event on the
    current stream, where a CUDA tensor crosses gloo; else this rank's
    device."""
    buf = _wire_buffer(staging, sum(_nbytes(p) for p in parts))
    staged = staging.pinned
    off = 0
    for p in parts:
        if isinstance(p, torch.Tensor):
            n = p.numel() * p.element_size()
            src = p.detach().contiguous().reshape(-1).view(torch.uint8)
            buf[off:off + n].copy_(src, non_blocking=staged)
        else:
            kind = torch.int64 if isinstance(p, int) else torch.float64
            buf[off:off + 8].copy_(torch.tensor([p], dtype=kind).view(
                torch.uint8))
        off += _nbytes(p)
    if staged:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(staging.device))
        ev.synchronize()
    return buf


def _unpack(staging: mesh_lib.Staging, buf: torch.Tensor,
            like: Sequence[Any]) -> List[Any]:
    """The parts of a buffer ``_pack`` made from parts shaped as
    ``like`` (tensors, possibly on the meta device, or numbers): tensors
    on ``staging``'s device (one copy onto its current stream from a
    host buffer), numbers as Python numbers."""
    device = staging.device
    on_device = buf
    if buf.device != device and any(isinstance(p, torch.Tensor)
                                    for p in like):
        on_device = buf.to(device, non_blocking=True)
    host = None
    out, off = [], 0
    for p in like:
        if isinstance(p, torch.Tensor):
            n = p.numel() * p.element_size()
            out.append(on_device[off:off + n].view(p.dtype).view(p.shape))
        else:
            if host is None:
                host = buf if buf.device.type == "cpu" else buf.cpu()
            kind = torch.int64 if isinstance(p, int) else torch.float64
            v = host[off:off + 8].view(kind).item()
            out.append(int(v) if isinstance(p, int) else float(v))
        off += _nbytes(p)
    return out


def _gather_start(mesh, axes: Sequence[str], parts: Sequence[Any]
                  ) -> Callable[[], List[List[Any]]]:
    """Start gathering every member's ``parts`` of this rank's group over
    ``axes`` (its own among them): one all-gather of one buffer, queued
    on the group's backend. The function returned waits for it and
    gives the members' parts in rank order."""
    staging = mesh.staging
    buf = _pack(staging, parts)
    outs = [torch.empty(buf.shape, dtype=buf.dtype, device=buf.device,
                        pin_memory=buf.is_pinned())
            for _ in mesh.group(mesh.rank, axes)]
    work = mesh.subgroup(axes).all_gather_start(outs, buf)

    def finish() -> List[List[Any]]:
        work.wait()
        return [_unpack(staging, o, parts) for o in outs]

    return finish


def _gather(mesh, axes: Sequence[str], parts: Sequence[Any]
            ) -> List[List[Any]]:
    """``_gather_start``'s result, waited for."""
    return _gather_start(mesh, axes, parts)()


def _add(values: Sequence[Any]) -> Any:
    """``values`` summed in order: the in-process mesh's order."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


def _proc_sums(group, kind: str, parts: Sequence[Any]) -> List[Any]:
    """Each of ``parts`` (tensors or numbers) gathered from every member
    of ``group`` and added in rank order."""
    rows = group._gather(kind, list(parts))
    return [_add([row[i] for row in rows]) for i in range(len(parts))]


class _ProcSum(torch.autograd.Function):
    """``psum`` over processes (``_proc_sums`` of this rank's tensors
    ``xs`` and ``numbers``, the numbers' sums put in ``box``); the
    adjoint gathers the cotangents and adds them the same way."""

    @staticmethod
    def forward(ctx, group, numbers, box, *xs):
        ctx.group = group
        sums = _proc_sums(group, "psum", list(xs) + list(numbers))
        box.extend(sums[len(xs):])
        return tuple(sums[:len(xs)])

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            _proc_sums(ctx.group, "psum.grad", grads))


def _proc_cat(group, x, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in rank order."""
    return torch.cat([row[0] for row in group._gather("all_gather", [x])],
                     dim)


class _ProcGather(torch.autograd.Function):
    """``all_gather`` over processes: the members' tensors concatenated
    along ``dim`` in rank order; the adjoint adds the members'
    cotangents in rank order and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim, ctx.w = group, dim, x.shape[dim]
        return _proc_cat(group, x, dim)

    @staticmethod
    def backward(ctx, g):
        total = _add([row[0] for row in ctx.group._gather(
            "all_gather.grad", [g])])
        return None, None, total.narrow(ctx.dim, ctx.group.index * ctx.w,
                                        ctx.w)


def _proc_all_to_all(group, x, split: int, concat: int, kind: str):
    """Chunk ``index`` along ``split`` of every member's ``x``,
    concatenated along ``concat`` in rank order (a gather and a slice)."""
    c = x.shape[split] // group.size
    i = group.index
    return torch.cat([row[0].narrow(split, i * c, c)
                      for row in group._gather(kind, [x])], concat)


class _ProcAllToAll(torch.autograd.Function):
    """``all_to_all`` over processes; the adjoint is the reverse
    all_to_all."""

    @staticmethod
    def forward(ctx, group, split, concat, x):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _proc_all_to_all(group, x, split, concat, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _proc_all_to_all(
            ctx.group, g, ctx.concat, ctx.split, "all_to_all.grad")


class _ProcPermute(torch.autograd.Function):
    """What a ppermute delivered to this rank (``got``: its source's
    tensor, or zeros), as a node of ``x``, this rank's own tensor: the
    adjoint gathers every member's cotangent, and ``x``'s is its
    destination's (none where it sent nothing)."""

    @staticmethod
    def forward(ctx, group, pairs, x, got):
        ctx.group, ctx.pairs = group, pairs
        return got

    @staticmethod
    def backward(ctx, g):
        dst = {s: d for s, d in ctx.pairs}.get(ctx.group.index)
        rows = ctx.group._gather("ppermute.grad", [g])
        return None, None, (None if dst is None else rows[dst][0]), None


class _ProcSlab(torch.autograd.Function):
    """A slab of a received flat buffer ``r`` (``r[start:stop]`` viewed
    as ``shape``, copied), or zeros of ``shape`` where ``keep`` is False,
    as a node of ``r`` either way: a shard on the boundary and its peer
    then build the same graph, and their engines meet the exchange's
    adjoint at the same point. The adjoint puts the slab's cotangent in
    place in zeros the size of ``r`` (what autograd of the slice gives);
    the zeros' adjoint is nothing."""

    @staticmethod
    def forward(ctx, r, start, stop, shape, keep):
        ctx.keep, ctx.start, ctx.stop = keep, start, stop
        ctx.like = (r.shape, r.dtype, r.device)
        if keep:
            return r[start:stop].view(shape).clone()
        return torch.zeros(shape, dtype=r.dtype, device=r.device)

    @staticmethod
    def backward(ctx, g):
        if not ctx.keep:
            return None, None, None, None, None
        shape, dtype, device = ctx.like
        out = torch.zeros(shape, dtype=dtype, device=device)
        out[ctx.start:ctx.stop] = g.reshape(-1)
        return out, None, None, None, None


class _ProcPsumGrad(torch.autograd.Function):
    """``psum_grad`` over processes: the identity; the adjoint gathers
    every member's flat cotangent and sums them as the in-process node
    does (``_nested_sum``, the minor axis first)."""

    @staticmethod
    def forward(ctx, group, degrees, *xs):
        ctx.group, ctx.degrees = group, degrees
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        trace_lib.count("grad_comm.reductions")
        trace_lib.instant("grad_comm.reduce")
        flat = (torch.cat([g.reshape(-1) for g in grads]) if len(grads) > 1
                else grads[0].reshape(-1))
        total = _nested_sum([row[0] for row in ctx.group._gather(
            "psum_grad", [flat])], ctx.degrees)
        parts, off = [], 0
        for g in grads:
            parts.append(total[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return (None, None) + tuple(parts)


class _ProcGroup(Group):
    """This process's group along mesh axes of a ``ProcessMesh``: the
    collectives of ``Group`` through ``torch.distributed`` (the module
    docstring)."""

    def __init__(self, mesh, axes: Tuple[str, ...]):
        super().__init__(axes, None, mesh.rank)
        self._mesh = mesh
        self.ranks = mesh.group(mesh.rank, axes)
        self.device = mesh.devices[mesh.rank]

    @property
    def index(self) -> int:
        return self.ranks.index(self._rank)

    def _log(self, kind: str, *parts) -> None:
        self._mesh.log.append((kind, self.axes, tuple(
            tuple(p.shape) if isinstance(p, torch.Tensor) else type(p).__name__
            for p in parts)))

    def _gather(self, kind: str, parts: Sequence[Any]) -> List[List[Any]]:
        self._log(kind, *parts)
        return _gather(self._mesh, self.axes, parts)

    def ppermute_start(self, t: torch.Tensor,
                       perm: Sequence[Tuple[int, int]]) -> Received:
        """Every member's ``t`` gathered, started now (a queued
        all-gather: each rank takes its source's); ``wait()`` completes
        it."""
        if self.size == 1:
            return super().ppermute_start(t, perm)
        pairs = tuple(perm)
        src = {d: s for s, d in pairs}.get(self.index)
        self._log("ppermute", t)
        records = _records([t])
        finish = _gather_start(self._mesh, self.axes, [t])

        def get():
            rows = finish()
            out = torch.zeros_like(t) if src is None else rows[src][0]
            return _ProcPermute.apply(self, pairs, t, out) if records else out

        return Received(get)

    def slab(self, recv: Received, start: int, stop: Optional[int],
             shape: Sequence[int], keep: bool,
             zeros: Callable[[], torch.Tensor]) -> Received:
        """``Group.slab``, the boundary's zeros too a node of the
        received buffer (``_ProcSlab``), so that every rank's graph is
        the same."""
        def get():
            r = recv.wait()
            if not (torch.is_grad_enabled() and r.requires_grad):
                return (r[start:stop].view(shape) if keep else zeros())
            # the boundary's zeros: the shape ``zeros`` gives (``shape``
            # may hold a -1)
            return _ProcSlab.apply(r, start, stop, tuple(
                shape) if keep else tuple(zeros().shape), keep)
        return Received(get)

    def psum(self, t):
        if self.size == 1:
            return t
        parts = tuple(t) if isinstance(t, tuple) else (t,)
        tensors = [p for p in parts if isinstance(p, torch.Tensor)]
        if _records(tensors):
            numbers = [p for p in parts if not isinstance(p, torch.Tensor)]
            box: List[Any] = []
            sums = iter(_ProcSum.apply(self, numbers, box, *tensors))
            it_n = iter(box)
            out = tuple(next(sums) if isinstance(p, torch.Tensor)
                        else next(it_n) for p in parts)
        else:
            out = tuple(_proc_sums(self, "psum", parts))
        return out if isinstance(t, tuple) else out[0]

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.size == 1:
            return t
        if _records([t]):
            return _ProcGather.apply(self, dim, t)
        return _proc_cat(self, t, dim)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        if self.size == 1:
            return t
        if split_dim == concat_dim:
            raise ValueError("all_to_all needs two different dims")
        if t.shape[split_dim] % self.size:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                             f"cut into {self.size} chunks")
        if _records([t]):
            return _ProcAllToAll.apply(self, split_dim, concat_dim, t)
        return _proc_all_to_all(self, t, split_dim, concat_dim, "all_to_all")

    def psum_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {self.size} chunks")
        w = t.shape[dim] // self.size
        with torch.no_grad():
            return _add([row[0].narrow(dim, self.index * w, w)
                         for row in self._gather("psum_scatter", [t])])

    def psum_grad(self, ts: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
        ts = tuple(ts)
        if self.size == 1 or not _records(ts):
            return ts
        degrees = tuple(self._mesh.degree(a) for a in self._mesh.axis_names
                        if a in self.axes)
        return _ProcPsumGrad.apply(self, degrees, *ts)


class _ProcRun:
    """A process mesh's run: this rank's shard alone."""

    def __init__(self, mesh):
        self.mesh = mesh


def all_shards(mesh, outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's tensor of a ``run``'s per-shard results: ``outs``
    on an in-process mesh; over processes, each rank's tensor (the same
    shape on every rank) gathered onto this rank's device, so that every
    rank puts the whole result together."""
    if not _over_processes(mesh) or mesh.size == 1:
        return list(outs)
    group = _ProcGroup(mesh, mesh.axis_names)
    return [row[0] for row in group._gather("all_shards", list(outs))]


def all_shard_trees(mesh, trees: Sequence[Any]) -> List[Any]:
    """``all_shards`` of per-shard trees of tensors (``core/tree.py``; one
    structure and shapes on every rank): every shard's tree, in rank
    order, over processes each rank's gathered in one exchange."""
    if not _over_processes(mesh) or mesh.size == 1:
        return list(trees)
    (tree,) = trees
    group = _ProcGroup(mesh, mesh.axis_names)
    return [tree_lib.unflatten(tree, row) for row in group._gather(
        "all_shards", tree_lib.leaves(tree))]


def from_rank0(mesh, tensors: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], bool]:
    """Rank 0's ``tensors`` on every rank of a process mesh, or of a
    pipeline's world (``launch.mesh.PipelineWorld``): one broadcast over
    its transport; and whether this rank's own were the same bits. An
    in-process mesh's are its own."""
    if isinstance(mesh, mesh_lib.Mesh) and (not _over_processes(mesh)
                                            or mesh.size == 1):
        return list(tensors), True
    buf = _pack(mesh.staging, tensors)
    mine = buf.clone()
    mesh.wire.broadcast(buf, 0)
    return (_unpack(mesh.staging, buf, tensors),
            bool(torch.equal(buf, mine)))


def _over_processes(mesh) -> bool:
    return isinstance(mesh, mesh_lib.ProcessMesh)


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


def axis(names: Union[str, Sequence[str]]) -> Group:
    """This shard's group along mesh axis ``names`` (a name, or a tuple
    of names: their product); size 1 outside a ``run``."""
    axes = (names,) if isinstance(names, str) else tuple(names)
    shard = getattr(_LOCAL, "shard", None)
    if shard is None:
        return Group(axes, None, 0)
    for name in axes:
        if name not in shard.run.mesh.axis_names:
            raise KeyError(f"mesh {shard.run.mesh.shape} has no axis "
                           f"{name!r}")
    if isinstance(shard.run, _ProcRun):
        return _ProcGroup(shard.run.mesh, tuple(
            a for a in shard.run.mesh.axis_names if a in axes))
    return Group(axes, shard.run, shard.rank)


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


def same_threads(n: int) -> None:
    """Give this thread the caller's ``n`` intra-op threads. PyTorch sets
    MKL's thread count per thread, so a fresh thread would run its
    matrix products on every core and round them differently from the
    caller (and from one process a shard, which runs in its caller)."""
    torch.set_num_threads(n)


def run(mesh, fn: Callable, *per_shard_args: Sequence[Any]) -> List[Any]:
    """``[fn(*args of shard r) for r in shards]``, one thread per shard,
    the shards taking turns between collectives; ``per_shard_args`` are
    sequences with one entry per shard. A one-shard mesh runs ``fn`` in
    the calling thread on its current stream. Raises the first error a
    shard raised (by rank). Over processes (``ProcessMesh``) the
    arguments and results are this process's shard's alone: ``fn`` runs
    once, in the calling thread."""
    n = len(mesh.local_ranks)
    for a in per_shard_args:
        if len(a) != n:
            raise ValueError(f"{len(a)} arguments for {n} shards")
    if _over_processes(mesh):
        return _run_process(mesh, fn, per_shard_args)
    grad, inference = (torch.is_grad_enabled(),
                       torch.is_inference_mode_enabled())
    if mesh.size == 1:
        run_ = _Run(mesh)
        outer = getattr(_LOCAL, "shard", None)
        _LOCAL.shard = _Shard(run_, 0)
        try:
            return [fn(*(a[0] for a in per_shard_args))]
        finally:
            _LOCAL.shard = outer
    results: List[Any] = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size
    threads_n = torch.get_num_threads()
    with mesh.lock:
        run_ = _Run(mesh)
        cuda_devs = {d for d in mesh.devices if d.type == "cuda"}
        callers = {d: torch.cuda.current_stream(d) for d in cuda_devs}
        for r, d in enumerate(mesh.devices):
            if d.type == "cuda":  # the shard sees what the caller enqueued
                mesh.stream(r).wait_stream(callers[d])

        def shard_main(r: int) -> None:
            try:
                same_threads(threads_n)
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


def _run_process(mesh, fn: Callable, per_shard_args) -> List[Any]:
    device = mesh.devices[mesh.rank]
    outer = getattr(_LOCAL, "shard", None)
    _LOCAL.shard = _Shard(_ProcRun(mesh), mesh.rank)
    try:
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            return [fn(*(a[0] for a in per_shard_args))]
    finally:
        _LOCAL.shard = outer


__all__ = ["Group", "Received", "ShardAborted", "all_shard_trees",
           "all_shards", "axis",
           "check_mesh", "checkpoint", "current_mesh", "from_rank0", "run"]
