"""Logical sharding policies (the reference's ``core/sharding.py``) over
the port's ``launch.mesh.Mesh``, and the helpers that cut a global
tree of tensors into per-shard blocks by spec and join them again.

A spec is a tuple with one entry per leading dimension of a tensor:
``None`` (not cut), a mesh axis name, or a tuple of names (cut over
their product, the first name major), the reference's
``PartitionSpec`` entry for entry; trailing dimensions it does not name
are not cut. ``ShardingPolicy.rules()`` maps each logical activation or
parameter name to its spec under a plan:

* ``tp``: batch over the data axes; heads, d_ff and vocab over the model
  axis.
* ``cp``: batch over the data axes, the sequence over the model axis
  (the paper's spatial partitioning on the sequence axis); weights not
  cut but for the vocabulary.
* ``ep``: as ``cp``, with the experts over the model axis.

The reference hands these specs to GSPMD, which chooses the
collectives. The port has no GSPMD: each model writes its plan's
dataflow out through ``core/spmd.py`` (``models/transformer.py``,
``models/ssm_lm.py``), reading the parameters' specs
(``core/param_specs.infer_param_specs``) to see which weights are cut,
and the residual stream's rule (``act_bsd``) to see whether the
sequence is cut (``ShardingPolicy.seq_split``) and which axes cut a
batch's rows (``data_spec``).
A policy whose mesh is None is no policy (the reference's
``NO_POLICY``): the models run unsharded under it.

``shard_tree`` cuts a global tree (nested dicts of tensors) into one
tree a shard, in rank order; ``join_shards`` puts such trees back
together; ``gather`` (inside ``spmd.run``) all-gathers a shard's block
along the dimensions its spec cuts, whose adjoint sums the cotangents
over those axes and hands each shard its block's (a reduce-scatter).
There is no generic resharding: each layout change is written where the
reference calls ``constrain``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import spmd

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _rules(plan: str, data_axes, model_axis: str) -> Dict[str, Spec]:
    da = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    d = da if len(da) > 1 else da[0]
    m = model_axis
    common = {
        "act_bsd": (d, None, None),
        "act_bsv": (d, None, m),           # logits: vocab cut
        "kv_cache": (d, None, m, None),    # (B, S, Hkv, hd) heads cut
        "emb_vd": (m, None),               # embedding table
        "pos": (d, None),
    }
    if plan == "tp":
        common.update({
            "act_bshd": (d, None, m, None),   # per-head activations
            "act_bsf": (d, None, m),          # ffn hidden
            "w_dhd": (None, m, None),         # qkv projection (D, H, hd)
            "w_hdd": (m, None, None),         # out projection
            "w_df": (None, m),
            "w_fd": (m, None),
            "w_edf": (m, None, None),         # experts (E, D, F)
            "w_efd": (m, None, None),
            "act_ecd": (m, d, None),          # expert buffers
            "ssm_state": (d, m, None, None),  # (B, H, P, N) heads cut
            "act_bshp": (d, None, m, None),   # ssd per head
        })
    elif plan in ("cp", "ep"):
        common.update({
            "act_bsd": (d, m, None),          # the sequence cut
            "act_bshd": (d, m, None, None),
            "act_bsf": (d, m, None),
            "act_bsv": (d, m, None),
            "kv_cache": (d, m, None, None),   # the cache cut on S
            "w_dhd": (None, None, None),
            "w_hdd": (None, None, None),
            "w_df": (None, None),
            "w_fd": (None, None),
            "w_edf": (m, None, None),
            "w_efd": (m, None, None),
            "act_ecd": (m, d, None),
            "ssm_state": (d, None, None, None),
            "act_bshp": (d, m, None, None),
        })
    else:
        raise ValueError(f"unknown plan {plan!r}")
    return common


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The reference's policy: a mesh (the port's ``launch.mesh.Mesh``,
    or None: no policy), a plan, the data axes, the model axis, and
    whether parameters are also cut over the data axes (FSDP)."""
    mesh: Any
    plan: str = "tp"
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = False

    def rules(self) -> Dict[str, Spec]:
        return _rules(self.plan, self.data_axes, self.model_axis)

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.model_axis]

    def spec(self, name: str) -> Spec:
        return self.rules().get(name, ())

    @property
    def seq_split(self) -> bool:
        """Whether the residual stream's sequence dim (``act_bsd``'s
        second entry) is cut over more than one model shard: ``cp`` and
        ``ep`` over a model axis of 2 or more."""
        return self.model_size > 1 and \
            self.spec("act_bsd")[1] == self.model_axis


NO_POLICY = ShardingPolicy(mesh=None)


def axes_of(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def named_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec cuts over."""
    return tuple(a for e in spec for a in axes_of(e))


def _index(mesh, rank: int, axes: Sequence[str]) -> Tuple[int, int]:
    """(shard ``rank``'s index along ``axes``, first major; their size)."""
    coords = mesh.coords(rank)
    i, n = 0, 1
    for a in axes:
        i = i * mesh.degree(a) + coords[a]
        n *= mesh.degree(a)
    return i, n


def block(t: torch.Tensor, spec: Spec, mesh, rank: int) -> torch.Tensor:
    """Shard ``rank``'s block of the global tensor ``t`` under ``spec``
    (a view); raises where a cut dimension does not divide."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        i, n = _index(mesh, rank, axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {n} over {axes}")
        w = t.shape[dim] // n
        t = t.narrow(dim, i * w, w)
    return t


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh,
               devices: Optional[Sequence[torch.device]] = None
               ) -> List[Any]:
    """One tree a shard of ``mesh`` (rank order): each leaf's block under
    its spec (``specs``: the same nesting, a spec at each leaf), a copy
    of its own on the shard's device."""
    devices = devices or mesh.devices
    return [_map(lambda t, s, r=r: block(t, s, mesh, r).to(
        devices[r], copy=True).contiguous(), tree, specs)
        for r in range(mesh.size)]


def join_shards(trees: Sequence[Any], specs: Any, mesh,
                device: Optional[torch.device] = None) -> Any:
    """The global tree of per-shard trees (rank order) under ``specs``,
    on ``device`` (shard 0's when None): each block put in its place
    (the replicas of a block are the same; the first is taken)."""
    device = device or mesh.devices[0]

    def join(leaves, spec):
        shape = list(leaves[0].shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= math.prod(mesh.degree(a) for a in axes_of(entry))
        out = torch.empty(shape, dtype=leaves[0].dtype, device=device)
        for r, leaf in enumerate(leaves):
            block(out, spec, mesh, r).copy_(leaf)
        return out

    def walk(nodes, spec):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], spec[k])
                    for k in nodes[0]}
        return join(nodes, spec)

    return walk(list(trees), specs)


def flat_specs(tree: Any, specs: Any) -> List[Spec]:
    """The specs of ``tree``'s leaves in ``core/tree.leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in flat_specs(tree[k],
                                                           specs[k])]
    return [specs]


def gather(t: torch.Tensor, spec: Spec, keep: Sequence[int] = (),
           model_axis: str = "model") -> torch.Tensor:
    """Inside ``spmd.run``: this shard's block ``t`` all-gathered along
    every dimension ``spec`` cuts, except the dimensions in ``keep``
    where it is cut over ``model_axis`` alone (a dimension the caller
    uses cut). The gather's adjoint sums the cotangents over the gather's
    axes and hands each shard its block's."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes or (dim in keep and axes == (model_axis,)):
            continue
        t = spmd.axis(axes).all_gather(t, dim)
    return t


def sharded_policy(policy=None, mesh=None) -> bool:
    """Whether a language model runs sharded: under a policy over a mesh
    (a policy whose mesh is None, or a mesh with no policy, is the
    reference's ``NO_POLICY``: unsharded). Raises for a process mesh
    (one process a shard: a later slice), a mesh that is not the
    policy's."""
    from repro_torch.launch.mesh import ProcessMesh

    pm = getattr(policy, "mesh", None) if policy is not None else None
    if isinstance(mesh, ProcessMesh) or isinstance(pm, ProcessMesh):
        raise NotImplementedError(
            "a language model over a ProcessMesh (one process a shard) "
            "comes with the next slice of the port, the LM over the process "
            "mesh; run it over an in-process launch.mesh.Mesh")
    if pm is None:
        return False
    if mesh is not None and mesh is not pm:
        raise ValueError("mesh is not the policy's mesh")
    return True


def check_policy(policy=None, mesh=None) -> bool:
    """``sharded_policy``, for a model's per-shard entry point: raises
    too for a sharded call outside ``spmd.run`` over the policy's
    mesh."""
    if not sharded_policy(policy, mesh):
        return False
    if spmd.current_mesh() is not policy.mesh:
        raise RuntimeError(
            "under a sharding policy the language models' entry points "
            "are per-shard functions: call them inside spmd.run(policy.mesh, "
            "...) on each shard's blocks (train_step.make_lm_train_step, "
            "serve.lm and launch.train do)")
    return True


def data_spec(policy: ShardingPolicy) -> Spec:
    """The spec of a batch's leading (rows) dim: ``act_bsd``'s first
    entry, the data axes."""
    return policy.spec("act_bsd")[:1]


def shard_rows(t, policy: ShardingPolicy) -> List[torch.Tensor]:
    """Each shard's rows of ``t`` (a batch's leading dim cut over the
    data axes), on its device, rank order."""
    mesh = policy.mesh
    t = torch.as_tensor(t)
    return [block(t, data_spec(policy), mesh, r).to(mesh.devices[r])
            for r in range(mesh.size)]


# the dimensions of a leaf (a layer's, without the stack's leading dim)
# that the models use cut over the model axis; every other cut dimension
# is gathered before use (``Layout.layer``)
LOCAL_DIMS = {
    "wq": (1,), "wk": (1,), "wv": (1,),      # (D, H, hd): the heads
    "bq": (0,), "bk": (0,), "bv": (0,),      # (H, hd)
    "wo": (0,),                              # (H, hd, D)
    "w_gate": (1,), "w_up": (1,), "w_gate_r": (1,), "w_up_r": (1,),  # F
    "w_down": (0,), "w_down_r": (0,),        # (F, D)
    "w_gate_e": (0,), "w_up_e": (0,), "w_down_e": (0,),  # the experts
    "embed": (0,), "unembed": (0,),          # the vocabulary
}


class Layout:
    """A policy's view inside ``spmd.run``: the plan, the calling shard's
    group along the model axis (looked up at each use, so a
    rematerialized block that holds a ``Layout`` recomputes on every
    shard with that shard's groups), and the parameters' specs
    (``core/param_specs.infer_param_specs`` of the model's shapes)."""

    def __init__(self, policy: ShardingPolicy, specs: Any):
        self.policy, self.specs = policy, specs
        self.axis = policy.model_axis
        self.seq_split = policy.seq_split

    @property
    def model(self) -> "spmd.Group":
        return spmd.axis(self.axis)

    def leaf(self, name: str, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This shard's block ``t`` of leaf ``name`` gathered along each
        dimension it is cut on, but those the models use cut
        (``LOCAL_DIMS``)."""
        return gather(t, spec, LOCAL_DIMS.get(name, ()), self.axis)

    def layer(self, stack: Dict[str, torch.Tensor], specs: Dict[str, Spec],
              i: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Layer ``i`` of a stacked tree (each leaf's leading dim the
        layer), or the tree itself (``i`` None), gathered by ``leaf``."""
        if i is None:
            return {n: self.leaf(n, t, specs[n]) for n, t in stack.items()}
        return {n: self.leaf(n, t[i], specs[n][1:])
                for n, t in stack.items()}

    def offset(self, s_loc: int) -> int:
        """The first global position of this shard's block of the
        sequence (0 where the plan does not cut it)."""
        return self.model.index * s_loc if self.seq_split else 0

    def positions(self, s_loc: int, device) -> torch.Tensor:
        return self.offset(s_loc) + torch.arange(s_loc, device=device)

    def local_rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This shard's block of the whole sequence ``t`` along ``dim``
        (all of it where the plan does not cut it)."""
        if not self.seq_split:
            return t
        n = self.model.size
        if t.shape[dim] % n:
            raise ValueError(f"{t.shape[dim]} positions do not cut into "
                             f"{n} blocks over {self.axis!r}")
        w = t.shape[dim] // n
        return t.narrow(dim, self.model.index * w, w)


__all__ = ["Entry", "LOCAL_DIMS", "Layout", "NO_POLICY", "ShardingPolicy",
           "Spec", "axes_of", "block", "check_policy", "data_spec",
           "flat_specs", "gather", "join_shards", "named_axes",
           "shard_rows", "shard_tree", "sharded_policy"]
