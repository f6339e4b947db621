"""Hyperslab sample store — the parallel-HDF5/MPI-IO analogue (paper §III-B);
the port's own copy of the reference's ``data/store.py``, numpy only, so
that each package reads the other's files.

Samples are stored one file per sample (``.npy``, NDHWC layout without the
N dim: (D, H, W, C)), memory-mapped on read so that
``read_hyperslab(sample, slices)`` touches ONLY the bytes of the requested
contiguous 3-D fragment — each (logical) rank reads exactly its hyperslab,
which is what lets I/O strong-scale with the spatial partitioning.

Byte counters are kept so the I/O benchmark can report per-rank PFS traffic
(the quantity that must shrink as spatial parallelism grows — paper Fig. 5).

Transient-failure handling (DESIGN.md §11): at the paper's scale a PFS
read fails routinely and transiently; every store read retries with
exponential backoff through a capped attempt count (the ``loader.read``
fault site fires inside the retry loop, so injected transients exercise
exactly this path). A read that exhausts its attempts raises
``StoreReadError`` naming the shard file — not a bare ``OSError`` three
layers down. ``retries`` counts absorbed failures for the §11 telemetry.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence, Tuple, TypeVar

import numpy as np

from repro_torch.core import faults

MAX_READ_ATTEMPTS = 4
BACKOFF_BASE_S = 0.005  # 5ms, 10ms, 20ms, ... between attempts

T = TypeVar("T")


class StoreReadError(IOError):
    """A store read failed every attempt; names the file and the count."""

    def __init__(self, path: str, attempts: int, last: BaseException):
        self.path = path
        self.attempts = attempts
        super().__init__(
            f"store read of {path!r} failed after {attempts} attempts "
            f"(last error: {last})")


class HyperslabStore:
    """The samples under ``root`` (``write_dataset``'s layout), read by
    hyperslab with the byte, read and retry counts kept."""

    def __init__(self, root: str):
        self.root = root
        self.bytes_read = 0
        self.reads = 0
        self.retries = 0
        with open(os.path.join(root, "index.json")) as f:
            self.index = json.load(f)
        self.num_samples = self.index["num_samples"]
        self.sample_shape = tuple(self.index["sample_shape"])  # (D,H,W,C)
        self.target_dim = self.index.get("target_dim", 0)
        self.label_kind = self.index.get("label_kind", "vector")
        self._targets = (
            self._retrying(os.path.join(root, "targets.npy"),
                           lambda: np.load(os.path.join(root, "targets.npy")))
            if os.path.exists(os.path.join(root, "targets.npy")) else None
        )

    def _path(self, i: int, what: str = "x") -> str:
        return os.path.join(self.root, f"{what}_{i:06d}.npy")

    def _retrying(self, path: str, read: Callable[[], T]) -> T:
        """Run ``read`` with capped exponential-backoff retries on I/O
        errors (missing files don't retry — they are config errors, and
        waiting on them would only mask the message)."""
        last: BaseException
        for attempt in range(MAX_READ_ATTEMPTS):
            try:
                faults.fire("loader.read", path=path)
                return read()
            except FileNotFoundError:
                raise
            except OSError as e:
                last = e
                if attempt + 1 < MAX_READ_ATTEMPTS:
                    self.retries += 1
                    time.sleep(BACKOFF_BASE_S * 2 ** attempt)
        raise StoreReadError(path, MAX_READ_ATTEMPTS, last)

    def read_hyperslab(self, i: int, slices: Tuple[slice, ...],
                       what: str = "x") -> np.ndarray:
        """Read one contiguous (D,H,W,C) fragment via memory map."""
        path = self._path(i, what)
        out = self._retrying(
            path, lambda: np.array(np.load(path, mmap_mode="r")[slices]))
        self.bytes_read += out.nbytes
        self.reads += 1
        return out

    def read_full(self, i: int, what: str = "x") -> np.ndarray:
        return self.read_hyperslab(
            i, tuple(slice(None) for _ in self.sample_shape), what)

    def target(self, i: int) -> np.ndarray:
        return self._targets[i]


def write_dataset(
    root: str,
    cubes: Sequence[np.ndarray],        # each (D, H, W, C)
    targets: Optional[np.ndarray] = None,  # (N, target_dim) regression
    labels: Optional[Sequence[np.ndarray]] = None,  # per-voxel seg labels
) -> None:
    os.makedirs(root, exist_ok=True)
    for i, c in enumerate(cubes):
        np.save(os.path.join(root, f"x_{i:06d}.npy"), c)
        if labels is not None:
            np.save(os.path.join(root, f"y_{i:06d}.npy"), labels[i])
    index = {
        "num_samples": len(cubes),
        "sample_shape": list(cubes[0].shape),
        "target_dim": 0 if targets is None else int(targets.shape[1]),
        "label_kind": "voxel" if labels is not None else "vector",
    }
    if targets is not None:
        np.save(os.path.join(root, "targets.npy"),
                targets.astype(np.float32))
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(index, f)
