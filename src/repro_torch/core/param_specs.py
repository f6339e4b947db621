"""Parameter specs by leaf name (the reference's
``core/param_specs.py``): every parameter leaf of the language models
mapped to a spec (``core/sharding.py``) under the policy's plan.

* tp: the head dims of the attention projections, d_ff of the MLP
  weights, the expert dim of the MoE stacks and the vocabulary of the
  (un)embeddings cut over the model axis, each where it divides, else
  the next candidate dim or none (e.g. llama3's 8 KV heads on a 16-way
  model axis stay whole, the standard GQA behaviour).
* cp/ep: attention and MLP weights not cut (the sequence is); the
  experts cut over model under ep; the embeddings' vocabulary cut.
* fsdp: also the first still-uncut dim of at least 1024 that divides
  over the data axes.

A leaf's name is the last key of its path; a leaf under ``layers``,
``blocks`` or ``block_norms`` has the layer stack's leading dim, which
is never cut.
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

from repro_torch.core.sharding import ShardingPolicy, Spec


def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0 and n >= by


def leaf_spec(path: str, shape: Sequence[int],
              policy: ShardingPolicy) -> Spec:
    """The spec of the leaf at ``path`` (``['layers']['wq']``, as
    ``core/tree.key_paths`` writes it) of ``shape`` under ``policy``."""
    m = policy.model_axis
    nm = policy.model_size
    plan = policy.plan
    spec = [None] * len(shape)
    stacked = len(shape) > 0 and ("layers" in path or "blocks" in path
                                  or "block_norms" in path)
    off = 1 if stacked else 0  # the layer stack's leading dim

    def nm_ok(d):
        return d < len(shape) and _divisible(shape[d], nm)

    name = path.split("'")[-2] if "'" in path else path

    if name in ("embed", "unembed") and _divisible(shape[0], nm):
        spec[0] = m
    elif plan == "tp":
        if name in ("wq", "wk", "wv"):           # (L, D, H, hd)
            if nm_ok(off + 1):
                spec[off + 1] = m
            elif nm_ok(off + 2):
                spec[off + 2] = m
        elif name in ("bq", "bk", "bv"):         # (L, H, hd)
            if nm_ok(off):
                spec[off] = m
            elif nm_ok(off + 1):
                spec[off + 1] = m
        elif name == "wo":                        # (L, H, hd, D)
            if nm_ok(off):
                spec[off] = m
            elif nm_ok(off + 1):
                spec[off + 1] = m
        elif name in ("w_gate", "w_up", "w_gate_r", "w_up_r"):  # (L, D, F)
            if nm_ok(off + 1):
                spec[off + 1] = m
        elif name in ("w_down", "w_down_r"):      # (L, F, D)
            if nm_ok(off):
                spec[off] = m
        elif name.endswith("_e"):                 # (L, E, D, F) experts
            if nm_ok(off):
                spec[off] = m
        elif name == "in_proj":                   # (L, D, dproj)
            if nm_ok(off + 1):
                spec[off + 1] = m
        elif name == "out_proj":                  # (L, di, D)
            if nm_ok(off):
                spec[off] = m
    elif plan in ("cp", "ep"):
        if name.endswith("_e") and plan == "ep" and nm_ok(off):
            spec[off] = m  # experts cut even under cp attention

    # FSDP over the data axes for big dims still whole
    if policy.fsdp and policy.mesh is not None:
        n_data = math.prod(policy.mesh.shape[a] for a in policy.data_axes)
        da = (policy.data_axes if len(policy.data_axes) > 1
              else policy.data_axes[0])
        for i in range(len(shape)):
            if spec[i] is None and _divisible(shape[i], n_data) \
                    and shape[i] >= 1024:
                spec[i] = da
                break
    return tuple(spec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def infer_param_specs(params: Any, policy: ShardingPolicy) -> Any:
    """A tree of specs matching ``params``: nested dicts whose leaves are
    tensors or shape tuples (a model's ``param_shapes(cfg)``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        return leaf_spec(path, _shape(node), policy)
    return walk(params, "")


__all__ = ["infer_param_specs", "leaf_spec"]
