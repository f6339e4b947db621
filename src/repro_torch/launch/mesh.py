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
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

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

    def coords(self, rank: int) -> Dict[str, int]:
        """Shard ``rank``'s index along each axis."""
        out = {}
        for a, n in reversed(self.axes):
            rank, out[a] = divmod(rank, n)
        return out

    def group(self, rank: int, axis: str) -> Tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` but
        ``axis``'s, in ``axis`` order."""
        stride = math.prod(n for a, n in self.axes[
            self.axis_names.index(axis) + 1:])
        base = rank - self.coords(rank)[axis] * stride
        return tuple(base + i * stride for i in range(self.degree(axis)))

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


def make_plan_mesh(plan, devices: Sequence[DeviceLike]) -> Mesh:
    """The mesh of exactly the axes (and degrees) ``plan`` records, over
    ``devices``, one per shard."""
    if plan.n_groups > 1:
        raise NotImplementedError(
            f"plan {plan.name!r} is pipelined; pipeline groups come with "
            "the pipeline slice of the port")
    return Mesh(plan.mesh_axes, devices)


__all__ = ["DeviceLike", "Mesh", "make_plan_mesh", "mesh_devices",
           "resolve_device"]
