"""The mesh a run is placed on (the reference's ``launch/mesh.py``
``make_plan_mesh``).

A ``Mesh`` holds a plan's axis names and degrees and one ``torch.device``
per shard, shards in row-major order over the axes. A device may repeat:
``devices=["cuda:0"] * 2`` puts both shards of a 2-way run on one card,
and then a collective between them is a copy within that card. On a
host with S cards, ``cuda:0..S-1`` put each shard on a card of its own,
and the copies go card to card. The caller chooses: with ``devices=None``
an S-way mesh takes ``cuda:0..S-1`` and raises when fewer cards are
visible, so a multi-shard run never shares a card without being asked.

A ``ProcessMesh`` is the same mesh over one process per shard (the
reference's mesh of devices, placed the way PyTorch places one): its
rank in the mesh is the shard's row-major rank, ``devices`` holds every
rank's device, and ``local_ranks`` is this process's one shard (a
``Mesh``'s are all of them: every shard is a thread of this process).
It makes its ``torch.distributed`` subgroups once, one per group of
every set of its axes, over a transport chosen by placement: NCCL only
where every rank's device is a CUDA card of its own, gloo otherwise
(NCCL refuses two ranks on one card), with CUDA tensors staged through
pinned host buffers by ``core/spmd.py``. Nothing falls back from one
transport to the other.

A pipeline over processes (``make_pipeline_meshes(..., processes=True)``)
cuts the world into P disjoint, equal slices of ranks, one a group: this
process's group is a ``ProcessMesh`` over its slice, each other group a
``PeerGroup`` (its axes, devices and ranks, run by other processes), and
the groups share a ``PipelineWorld``: the world's gloo backend and this
process's hand-off links to shard j of the neighbouring groups.
"""
from __future__ import annotations

import collections
import itertools
import math
import socket
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none,
    naming the ``device`` argument. A bare ``"cuda"`` gets its index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "the port on the CPU (entry points default to the card)")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_devices(n: int, *, device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None
                 ) -> Tuple[torch.device, ...]:
    """The devices of an ``n``-shard mesh: ``devices`` as given (the
    caller checks the count), else ``device`` for one shard, else
    ``cuda:0..n-1``."""
    if device is not None and devices is not None:
        raise ValueError("give device= or devices=, not both")
    if devices is not None:
        return tuple(resolve_device(d) for d in devices)
    if n == 1:
        return (resolve_device(device),)
    if device is not None:
        raise ValueError(
            f"{n} shards need devices=[...], one per shard; to put every "
            f"shard on {device}, pass devices=[{str(device)!r}] * {n}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(
            f"{n} shards need {n} CUDA devices but {count} are visible: "
            f"pass devices=[...] to place them, e.g. devices=['cuda:0'] * "
            f"{n} for one card or ['cpu'] * {n}")
    return tuple(torch.device("cuda", i) for i in range(n))


class Mesh:
    """Named axes with degrees over one device per shard (row-major:
    the last axis varies fastest). Each shard on a CUDA device gets a
    stream of its own, made at first use and kept for the mesh's life."""

    def __init__(self, axes: Sequence[Tuple[str, int]],
                 devices: Sequence[DeviceLike]):
        self.axes: Tuple[Tuple[str, int], ...] = tuple(
            (str(a), int(n)) for a, n in axes)
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} shards but "
                             f"{len(self.devices)} devices were given")
        self._streams: Optional[Tuple] = None
        self._groups: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], ...]] = {}
        # one run at a time: the shards' streams and the collective
        # slots belong to the run in flight
        self.lock = threading.Lock()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)

    def degree(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The shards this process runs (each a thread): all of them."""
        return tuple(range(self.size))

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.devices[r] for r in self.local_ranks)

    @property
    def home(self) -> torch.device:
        """Where results come back: the first local shard's device."""
        return self.devices[self.local_ranks[0]]

    def coords(self, rank: int) -> Dict[str, int]:
        """Shard ``rank``'s index along each axis."""
        out = {}
        for a, n in reversed(self.axes):
            rank, out[a] = divmod(rank, n)
        return out

    def groups(self, axes: Union[str, Sequence[str]]
               ) -> Tuple[Tuple[int, ...], ...]:
        """Every rank's group over ``axes`` (one axis name or several),
        indexed by rank: the ranks that share every coordinate outside
        ``axes``, in rank order (row-major over ``axes``; for one axis,
        its order). Computed once per ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        table = self._groups.get(axes)
        if table is None:
            at = [self.coords(r) for r in range(self.size)]
            fixed = [a for a in self.axis_names if a not in axes]
            table = tuple(
                tuple(q for q in range(self.size)
                      if all(at[q][a] == at[r][a] for a in fixed))
                for r in range(self.size))
            self._groups[axes] = table
        return table

    def group(self, rank: int, axes: Union[str, Sequence[str]]
              ) -> Tuple[int, ...]:
        """``rank``'s group over ``axes`` (``groups``)."""
        return self.groups(axes)[rank]

    def stream(self, rank: int):
        """Shard ``rank``'s stream (None on a CPU device)."""
        if self._streams is None:
            self._streams = tuple(
                torch.cuda.Stream(device=d) if d.type == "cuda" else None
                for d in self.devices)
        return self._streams[rank]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


class Staging(NamedTuple):
    """Where this process's tensors cross a transport: its device, and
    whether a CUDA tensor goes through pinned host buffers (a card under
    gloo)."""

    device: torch.device
    pinned: bool

    @classmethod
    def of(cls, device: torch.device, transport: str) -> "Staging":
        return cls(device, device.type == "cuda" and transport == "gloo")


def placement_transport(hosts: Sequence[str],
                        devices: Sequence[torch.device]) -> str:
    """``"nccl"`` where two or more ranks each have a CUDA card of their
    own (distinct (host, device) pairs), else ``"gloo"`` (a mesh of one
    rank exchanges nothing: a pipeline group of one shard)."""
    cards = [(h, str(d)) for h, d in zip(hosts, devices)]
    if (len(cards) > 1 and all(d.type == "cuda" for d in devices)
            and len(set(cards)) == len(cards)):
        return "nccl"
    return "gloo"


class ProcessMesh(Mesh):
    """A ``Mesh`` whose shards are processes of a ``torch.distributed``
    world (``launch/dist.py``), this process one of them: ``ranks`` are
    the world ranks of the mesh's shards in row-major order (default
    ``dist.world()``), ``devices`` every shard's device (each rank gives
    the same list), or None: each rank's ``local_device``, gathered.
    ``transport`` is ``placement_transport``'s choice over every rank's
    (host, device). Subgroups: one per group of each non-empty set of
    axes that holds this rank and more than one shard, made now, every
    rank in the same order."""

    def __init__(self, axes: Sequence[Tuple[str, int]],
                 devices: Optional[Sequence[DeviceLike]] = None, *,
                 ranks: Optional[Sequence[int]] = None,
                 local_device: DeviceLike = None):
        import torch.distributed as dist

        from repro_torch.launch import dist as dist_lib

        ranks = dist_lib.world() if ranks is None else tuple(ranks)
        if list(ranks) != sorted(set(ranks)):
            raise ValueError(f"a mesh's ranks ascend: {ranks}")
        n = math.prod(int(d) for _, d in axes)
        if len(ranks) != n:
            raise ValueError(f"mesh {dict(axes)} has {n} shards but "
                             f"{len(ranks)} processes: data x spatial must "
                             f"equal the world size")
        rank = ranks.index(dist.get_rank())
        world = dist_lib.group(ranks, "gloo")
        mine = (torch.device(local_device) if devices is None
                else torch.device(devices[rank]))
        table = world.gather_objects((socket.gethostname(), str(mine)))
        if devices is None:
            devices = [d for _, d in table]
        super().__init__(axes, devices)
        for r, (_, dev) in enumerate(table):
            if dev != str(self.devices[r]):
                raise ValueError(f"rank {r} places its shard on {dev}, but "
                                 f"this rank was told {self.devices[r]}")
        self.ranks: Tuple[int, ...] = ranks
        self.rank, self.world = rank, world
        self.transport = placement_transport([h for h, _ in table],
                                             self.devices)
        if self.transport == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("every shard has a card of its own, but this "
                               "PyTorch has no NCCL")
        self.wire = (self.world if self.transport == "gloo"
                     else dist_lib.group(self.ranks, "nccl"))
        self._subgroups: Dict[Tuple[str, ...], object] = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes_ in itertools.combinations(names, k):
                members = self.group(self.rank, axes_)
                if len(members) > 1:
                    self._subgroups[axes_] = dist_lib.group(
                        [self.ranks[m] for m in members], self.transport)
        # the order of this rank's collectives (kind, axes), most recent
        # last: every rank must issue the same sequence
        self.log: collections.deque = collections.deque(maxlen=1 << 16)
        # a pipeline group's ``PipelineWorld`` (``make_pipeline_meshes``)
        self.pipeline: Optional[PipelineWorld] = None

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        return (self.rank,)

    def subgroup(self, axes: Sequence[str]):
        """The ``torch.distributed`` group of this rank's group over
        ``axes`` (in the mesh's axis order)."""
        return self._subgroups[tuple(a for a in self.axis_names
                                     if a in axes)]

    @property
    def staging(self) -> Staging:
        return Staging.of(self.devices[self.rank], self.transport)

    def barrier(self) -> None:
        self.world.barrier()

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank {self.rank} of ranks "
                f"{list(self.ranks)}, devices="
                f"{[str(d) for d in self.devices]}, {self.transport})")


def make_plan_mesh(plan, devices: Sequence[DeviceLike]) -> Mesh:
    """The mesh of exactly the axes (and degrees) ``plan`` records, over
    ``devices``, one per shard. For a pipelined plan (whose degrees are
    each group's), group 0's mesh of ``make_pipeline_meshes``."""
    if plan.n_groups > 1:
        return make_pipeline_meshes(plan, devices)[0]
    return Mesh(plan.mesh_axes, devices)


class PeerGroup(Mesh):
    """A pipeline group whose shards are other processes: its axes, its
    shards' devices and world ``ranks`` (what a hand-off to it needs);
    this process runs none of its shards."""

    def __init__(self, axes: Sequence[Tuple[str, int]],
                 devices: Sequence[DeviceLike], ranks: Sequence[int]):
        super().__init__(axes, devices)
        self.ranks: Tuple[int, ...] = tuple(ranks)

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        return ()


class PipelineWorld:
    """What the groups of a pipeline over processes share: ``ranks``
    (every group's world ranks, group after group, ``d`` a group), this
    process's ``group`` and ``rank`` (its index over ``ranks``), ``wire``
    (the world's gloo backend: barriers, the step's loss and guard
    flags, gathers onto every rank, the initial parameters' broadcast)
    and ``links[h]``, this process's ``dist.Link`` to shard ``rank % d``
    of group h = group +- 1."""

    def __init__(self, ranks: Tuple[int, ...], group: int, rank: int,
                 d: int, wire, links: Dict[int, object],
                 device: torch.device):
        self.ranks, self.group, self.rank, self.d = ranks, group, rank, d
        self.wire, self.links, self.device = wire, links, device

    @property
    def staging(self) -> Staging:
        return Staging.of(self.device, "gloo")

    def barrier(self) -> None:
        self.wire.barrier()

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        return self.wire.gather_objects(obj)


def make_pipeline_meshes(plan, devices: Optional[Sequence[DeviceLike]], *,
                         processes: bool = False,
                         local_device: DeviceLike = None
                         ) -> Tuple[Mesh, ...]:
    """One mesh per pipeline group: group g takes ``devices[g*d:(g+1)*d]``
    (d the product of the plan's degrees), disjoint equal slices in
    order, so group 0 has the devices ``make_plan_mesh`` gives. On one
    card the list is P*d entries of it (``mesh_devices``), and each
    group's shards still get streams of their own.

    ``processes=True``: over the world of processes (``dist.world()``,
    P*d ranks, ``devices`` every rank's or None: each rank's
    ``local_device``): group g is ranks ``[g*d, (g+1)*d)``, this
    process's group a ``ProcessMesh`` carrying the ``PipelineWorld`` as
    ``.pipeline``, every other a ``PeerGroup``. Made in one order on
    every rank: the world's backend, then each group's mesh by its
    members, then each link by its pair, the lower group's first."""
    d = math.prod(n for _, n in plan.mesh_axes)
    if not processes:
        if plan.n_groups * d > len(devices):
            raise ValueError(
                f"plan {plan.name!r} needs {plan.n_groups} groups x {d} "
                f"devices but {len(devices)} were given")
        return tuple(Mesh(plan.mesh_axes, devices[g * d:(g + 1) * d])
                     for g in range(plan.n_groups))
    import torch.distributed as dist

    from repro_torch.launch import dist as dist_lib

    ranks = dist_lib.world()
    if plan.n_groups * d != len(ranks):
        raise ValueError(
            f"plan {plan.name!r} has {plan.n_groups} groups x {d} shards "
            f"but the world has {len(ranks)} processes: pipeline x data x "
            f"spatial must equal the world size")
    me = ranks.index(dist.get_rank())
    g = me // d
    wire = dist_lib.group(ranks, "gloo")
    mine = torch.device(local_device if devices is None else devices[me])
    table = wire.gather_objects((socket.gethostname(), str(mine)))
    placed = [torch.device(dev) for _, dev in table]
    meshes = []
    for h in range(plan.n_groups):
        part = slice(h * d, (h + 1) * d)
        meshes.append(ProcessMesh(plan.mesh_axes, placed[part],
                                  ranks=ranks[part]) if h == g
                      else PeerGroup(plan.mesh_axes, placed[part],
                                     ranks[part]))
    links = {}
    for h in (g - 1, g + 1):
        if 0 <= h < plan.n_groups:
            peer = h * d + me % d
            links[h] = dist_lib.Link(ranks[peer], placement_transport(
                [table[me][0], table[peer][0]], [placed[me], placed[peer]]))
    meshes[g].pipeline = PipelineWorld(ranks, g, me, d, wire, links,
                                       placed[me])
    return tuple(meshes)


__all__ = ["DeviceLike", "Mesh", "PeerGroup", "PipelineWorld", "ProcessMesh",
           "Staging", "make_pipeline_meshes", "make_plan_mesh",
           "mesh_devices", "placement_transport", "resolve_device"]
