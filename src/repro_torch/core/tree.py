"""Trees of tensors: the port's counterpart of ``jax.tree``.

A tree is a dict (keys visited in sorted order, as ``jax.tree`` visits
them), a NamedTuple (fields in order), a tuple (items in order: the
flat buckets of a ZeRO-1 optimizer state, ``core/grad_comm.py``),
``None`` (an empty subtree, as in ``jax.tree``) or a leaf. The optimizer states (``optim/adam.py``,
``core/precision.py``) and the checkpoint's ``{"params", "opt"}`` tree are
such trees; ``key_paths`` names their leaves as ``jax.tree_util.keystr``
does (``['opt'].m['conv0_w']``), which is how a checkpoint names its
files.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over ``tree`` and the trees in ``rest``,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def key_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in ``jax.tree`` order, each path as
    ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in key_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in key_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, tuple):
        return [pair for i, t in enumerate(tree)
                for pair in key_paths(t, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in key_paths(tree)]


def structure(tree: Any) -> Any:
    """``tree``'s nodes without its leaves (the counterpart of a
    ``jax`` treedef): two trees compare equal here when they have the
    same dict keys, NamedTuple types, tuple lengths and ``None``s."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    if _is_namedtuple(tree):
        return (type(tree), tuple(structure(getattr(tree, f))
                                  for f in tree._fields))
    if isinstance(tree, tuple):
        return ("tuple", tuple(structure(t) for t in tree))
    return None if tree is None else "leaf"


__all__ = ["tree_map", "key_paths", "leaves", "structure"]
