"""Reader of the reference's checkpoint format.

A checkpoint directory holds one ``.npy`` per pytree leaf, named from
the leaf's path (``['params']['conv0_w']``), and ``manifest.json``
listing each leaf's path, file, dtype, shape and CRC32; half-float
leaves are widened to fp32 on disk (``stored_as``) and narrowed back on
restore unless the manifest records a precision policy (then the fp32
values are the canonical masters). A training run also writes
``run_config.json`` beside them. A retention root holds ``step_<n>``
checkpoint directories.

This module reads that format — ``restore``, ``validate``,
``list_steps``, ``latest_valid_step`` — so a checkpoint the reference
trained serves from the port. The writer comes with the training slice.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as trace_lib

MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")
_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class CheckpointError(RuntimeError):
    """A checkpoint could not be read."""


class CheckpointCorrupt(CheckpointError):
    """A checkpoint failed validation (missing/garbled leaf, bad CRC)."""

    def __init__(self, ckpt_dir: str, detail: str):
        self.ckpt_dir = ckpt_dir
        super().__init__(f"corrupt checkpoint {ckpt_dir}: {detail}")


def _load_manifest(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def _check_crc(ckpt_dir: str, entry: dict, arr: np.ndarray) -> None:
    want = entry.get("crc32")
    if want is None:  # manifest older than CRCs: nothing to check against
        return
    got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
    if got != want:
        raise CheckpointCorrupt(
            ckpt_dir, f"leaf {entry['path']!r} ({entry['file']}) CRC "
            f"{got:#010x} != manifest {want:#010x}")


def _key_path(keys: Tuple[str, ...]) -> str:
    """The reference's leaf path string for nested dict keys."""
    return "".join(f"[{k!r}]" for k in keys)


def restore(ckpt_dir: str, like: Mapping[str, Any], *,
            verify: bool = True) -> Dict[str, Any]:
    """Read the leaves named by the nested dict ``like`` (its leaf values
    are ignored; only its keys select) as CPU tensors, in the same
    nesting. ``verify`` checks each leaf against its manifest CRC and
    raises ``CheckpointCorrupt`` on mismatch."""
    with trace_lib.span("ckpt.restore", path=ckpt_dir):
        manifest = _load_manifest(ckpt_dir)
        by_path = {l["path"]: l for l in manifest["leaves"]}
        keep_masters = manifest.get("precision") is not None

        def load_leaf(keys: Tuple[str, ...]) -> torch.Tensor:
            path = _key_path(keys)
            entry = by_path.get(path)
            if entry is None:
                raise CheckpointError(f"{ckpt_dir} has no leaf {path}")
            try:
                arr = np.load(os.path.join(ckpt_dir, entry["file"]))
            except (OSError, ValueError) as e:
                raise CheckpointCorrupt(
                    ckpt_dir, f"leaf {path!r} ({entry['file']}) "
                    f"unreadable: {e}") from e
            if verify:
                _check_crc(ckpt_dir, entry, arr)
            t = torch.from_numpy(arr)
            if "stored_as" in entry and not keep_masters:
                # widened-for-npy leaf of a policy-less save: narrow back
                t = t.to(_HALF[entry["dtype"]])
            return t

        def walk(node: Mapping[str, Any], prefix: Tuple[str, ...]):
            return {k: (walk(v, prefix + (k,)) if isinstance(v, Mapping)
                        else load_leaf(prefix + (k,)))
                    for k, v in node.items()}

        return walk(like, ())


def validate(ckpt_dir: str) -> bool:
    """Whether ``ckpt_dir`` holds a complete, uncorrupted checkpoint:
    the manifest parses and every leaf file exists with a matching CRC."""
    try:
        manifest = _load_manifest(ckpt_dir)
    except (OSError, ValueError, KeyError):
        return False
    try:
        for entry in manifest["leaves"]:
            arr = np.load(os.path.join(ckpt_dir, entry["file"]))
            _check_crc(ckpt_dir, entry, arr)
    except (OSError, ValueError, KeyError, CheckpointCorrupt):
        return False
    return True


def list_steps(root: str) -> List[Tuple[int, str]]:
    """(step, path) for every published step directory under ``root``,
    ascending. Partial/temp/renamed-aside directories never match."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def latest_valid_step(root: str) -> Optional[Tuple[int, str]]:
    """The newest step checkpoint under ``root`` that validates — a
    corrupt or partial newest step falls back to its predecessor."""
    for step, path in reversed(list_steps(root)):
        if validate(path):
            return step, path
    return None


__all__ = ["CheckpointError", "CheckpointCorrupt", "MANIFEST", "restore",
           "validate", "list_steps", "latest_valid_step"]
