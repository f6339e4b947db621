"""Checkpoints in the reference's format: the reader and the writer.

A checkpoint directory holds one ``.npy`` per pytree leaf, named from
the leaf's path (``['params']['conv0_w']``, ``['opt'].m['conv0_w']``),
and ``manifest.json`` listing each leaf's path, file, dtype, shape and
CRC32; half-float leaves are widened to fp32 on disk (``stored_as``)
and narrowed back on restore unless the manifest records a precision
policy (then the fp32 values are the canonical masters). A training run
also writes ``run_config.json`` beside them. A retention root holds
``step_<n>`` checkpoint directories.

Both packages read and write the same files, so each restores the
other's checkpoints. A leaf may carry its ``PartitionSpec`` as the
reference writes it (``"spec": [["data"]]`` for ZeRO-1's optimizer
state, dim 0 sharded over the data axes; ``[]`` replicated), so that the
reference restores it sharded on its mesh. ``save`` never touches an
existing checkpoint in place: every file is written into a sibling ``<dir>.tmp-<nonce>``
directory, which is renamed into place once complete (a writer killed
between leaf writes — the ``checkpoint.write`` fault site fires there —
leaves the previous checkpoint intact and a stale ``.tmp`` directory
that discovery ignores). ``save_step``/``gc_steps``/``latest_step``
manage a retention root. Over processes rank 0 writes and the other
ranks wait at a barrier (``on_rank0``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import uuid
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.tree import key_paths
from repro_torch.obs import trace as trace_lib

MANIFEST = "manifest.json"
_TMP_MARK = ".tmp-"
_OLD_MARK = ".old-"
_STEP_RE = re.compile(r"^step_(\d+)$")
_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class CheckpointError(RuntimeError):
    """A checkpoint could not be read or written."""


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


def _publish(tmp: str, final: str) -> None:
    """Swap the complete ``tmp`` directory into place: one rename for a
    fresh target; an existing checkpoint is renamed aside first (both
    directories are valid throughout)."""
    with trace_lib.span("ckpt.publish", path=final):
        if not os.path.exists(final):
            os.rename(tmp, final)
            return
        old = f"{final}{_OLD_MARK}{uuid.uuid4().hex[:8]}"
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array written, the leaf's own dtype name): half floats are
    widened to fp32, exactly (``np.save`` has no bfloat16)."""
    t = leaf.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    return (t.float() if t.dtype in _HALF.values() else t).numpy(), name


def save(ckpt_dir: str, tree: Any, step: int = 0, *,
         precision: Optional[str] = None,
         extra_files: Optional[Dict[str, Any]] = None,
         specs: Optional[Mapping[str, List[Any]]] = None) -> None:
    """Write ``tree`` (dicts, NamedTuples, tuples, tensor leaves) as a
    checkpoint at ``ckpt_dir``, atomically. ``precision`` records the
    training policy in the manifest (then a restore keeps widened half
    leaves as the fp32 masters they are); ``extra_files`` maps file
    names to JSON-serializable objects written in the same publish;
    ``specs`` maps leaf paths to the manifest ``spec`` they record."""
    with trace_lib.span("ckpt.save", path=ckpt_dir, step=step):
        parent = os.path.dirname(os.path.abspath(ckpt_dir))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{ckpt_dir}{_TMP_MARK}{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        if precision is not None:
            manifest["precision"] = precision
        for path, leaf in key_paths(tree):
            name = _sanitize(path) + ".npy"
            arr, dtype = _host_array(leaf)
            np.save(os.path.join(tmp, name), arr)
            faults.fire("checkpoint.write", path=os.path.join(tmp, name))
            entry = {"path": path, "file": name, "dtype": dtype,
                     "shape": list(arr.shape),
                     "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())}
            if dtype != str(arr.dtype):
                entry["stored_as"] = str(arr.dtype)
            if specs and path in specs:
                entry["spec"] = specs[path]
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        for name, obj in (extra_files or {}).items():
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f, indent=1)
        _publish(tmp, ckpt_dir)


def on_rank0(mesh, write: Callable[[], Any]) -> None:
    """``write()`` (a ``save``) on a process mesh's rank 0 while the
    other ranks wait at a barrier, so that every rank returns once the
    checkpoint is published; on an in-process mesh, ``write()``. Every
    rank holds the same state, so rank 0's bytes are the run's."""
    if getattr(mesh, "barrier", None) is None:
        write()
        return
    if mesh.rank == 0:
        write()
    mesh.barrier()


def restore(ckpt_dir: str, like: Any, *, verify: bool = True) -> Any:
    """Read the leaves named by the tree ``like`` (dicts, NamedTuples and
    tuples; its leaf values are ignored, only its structure selects) as
    CPU tensors, in the same structure. ``verify`` checks each leaf against
    its manifest CRC and raises ``CheckpointCorrupt`` on mismatch."""
    with trace_lib.span("ckpt.restore", path=ckpt_dir):
        manifest = _load_manifest(ckpt_dir)
        by_path = {l["path"]: l for l in manifest["leaves"]}
        keep_masters = manifest.get("precision") is not None

        def load_leaf(path: str) -> torch.Tensor:
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

        def walk(node: Any, prefix: str):
            if isinstance(node, Mapping):
                return {k: walk(v, f"{prefix}[{k!r}]")
                        for k, v in node.items()}
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*(walk(getattr(node, f), f"{prefix}.{f}")
                                    for f in node._fields))
            if isinstance(node, tuple):
                return tuple(walk(v, f"{prefix}[{i}]")
                             for i, v in enumerate(node))
            return None if node is None else load_leaf(prefix)

        return walk(like, "")


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


def step_dir(root: str, step: int) -> str:
    """The per-step checkpoint directory under a retention root."""
    return os.path.join(root, f"step_{step:08d}")


def save_step(root: str, tree: Any, step: int, *,
              precision: Optional[str] = None,
              extra_files: Optional[Dict[str, Any]] = None,
              specs: Optional[Mapping[str, List[Any]]] = None,
              keep_last: Optional[int] = None) -> str:
    """``save`` into ``step_dir(root, step)``; with ``keep_last``, delete
    older step checkpoints (and stale temp dirs) afterwards."""
    path = step_dir(root, step)
    save(path, tree, step, precision=precision, extra_files=extra_files,
         specs=specs)
    if keep_last is not None:
        gc_steps(root, keep_last)
    return path


def gc_steps(root: str, keep_last: int) -> List[str]:
    """Delete all but the newest ``keep_last`` step checkpoints, and any
    stale ``.tmp``/``.old`` directories of interrupted saves. Returns the
    removed paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    removed = []
    steps = list_steps(root)
    for _, path in steps[:-keep_last] if len(steps) > keep_last else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    if os.path.isdir(root):
        for name in os.listdir(root):
            if _TMP_MARK in name or _OLD_MARK in name:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
                removed.append(os.path.join(root, name))
    return removed


def latest_step(ckpt_dir: str) -> int:
    """The step of the checkpoint at ``ckpt_dir``: its manifest's, or for
    a retention root the newest valid step's."""
    manifest = os.path.join(ckpt_dir, MANIFEST)
    if os.path.exists(manifest):
        with open(manifest) as f:
            return json.load(f)["step"]
    found = latest_valid_step(ckpt_dir)
    if found is None:
        raise FileNotFoundError(
            f"no checkpoint manifest or valid step_<n> dirs in {ckpt_dir}")
    return found[0]


def saved_precision(ckpt_dir: str) -> Optional[str]:
    """The precision policy the checkpointed run trained under, or None
    for a checkpoint that recorded none."""
    return _load_manifest(ckpt_dir).get("precision")


__all__ = ["CheckpointError", "CheckpointCorrupt", "MANIFEST", "save",
           "restore", "validate", "list_steps", "latest_valid_step",
           "step_dir", "save_step", "gc_steps", "latest_step",
           "saved_precision"]
