"""Step builders (the reference's ``train/train_step.py``): the
conv-net train step, its phase probes, the eval step, the plan-sharded
serving forward, and the pipelined train step over device groups
(``make_pipeline_train_step``: its docstring has the schedule, the
hand-offs and the equivalence contract).

The serving forward splits each input batch along the entry stage's
partitioned dims into the mesh's shards, each made contiguous on its
shard's device, and runs the model's forward (``models/cosmoflow`` or
``models/unet3d``, by ``cfg.arch``) once per shard through
``core.spmd.run``. CosmoFlow's predictions are put together from one
holder of each of the FC stage's batch slices, in order: the entry
stage's data slices where the head is replicated over the spatial
group, their chunks where a plan moved the spatial group into the
batch. The U-Net returns per-voxel logits in the entry stage's layout,
each shard's block put back in place on shard 0's device
(``gather_blocks``).

The train step (``make_convnet_train_step``) runs the reference's
hybrid step over a data x spatial mesh whose shards all lie on one
device (``["cuda:0"] * n`` on a card, ``["cpu"] * n`` in the tests):

1. each shard, in its thread, takes its batch slice (the entry stage's
   batch axes) and depth slab of x and its batch slice of y (the U-Net's
   voxel labels: its batch slice and depth slab, like x), and computes
   the loss: CosmoFlow's ``mse_loss`` with dropout masks drawn for the
   GLOBAL sample ids (so they do not depend on the mesh or the plan:
   ids and targets are cut with the rows at a batch move) and divided
   by the plan's ``loss_redundancy``, or the U-Net's
   ``segmentation_loss`` over ``global_batch * W^3`` voxels; batch-norm
   statistics summed over every mesh axis; under ``overlap`` the
   parameters' reduction hooks go into its graph
   (``core/grad_comm.py``; under ``reduce_scatter`` over the spatial
   axes only). Each shard has parameter leaves of its own (views of the
   same masters), so that its gradient is its own partial sum. Over a
   process mesh the step also takes this rank's blocks as they are (a
   ``RankBatch`` of ``Block``s, the per-rank loader's), each checked
   against ``block_index`` of the global shape it carries;
2. ONE backward over the shards' losses (fp16: each times the running
   loss scale), from the calling thread: each collective is one autograd
   node over every shard (``core/spmd.py``), so its adjoint is a data
   dependency of this backward and no backward node waits for a peer;
3. each shard, in its thread again: the global loss (a ``psum``), the
   ``monolithic`` reduction of every gradient (``overlap`` has reduced
   them inside the backward), the guard's verdict agreed over every
   shard, and the optimizer's update — the same on every shard, as
   every input to it is. Shard 0's results are returned. Under
   ``reduce_scatter`` (ZeRO-1) the update is ``grad_comm.sharded_update``:
   each shard reduce-scatters its buckets over the data axes, updates
   its chunk against its own 1/N of the optimizer state and gathers the
   parameters; the step takes and returns one state a shard (a list in
   rank order, ``make_convnet_opt_state``), spatial peers holding the
   same chunk.

With the reduced gradients the same on every shard, the fp16 skip
machine of ``MixedPrecision`` decides alike everywhere (under ZeRO-1 its
finite verdict is summed over the data axes), and the one loss scale is
the optimizer state's. Stages nest as the reference's probes
do: ``fwd`` returns the loss, ``bwd`` adds the backward (no reduction:
the loss and the sum of every shard's gradients), ``grad_comm`` the
reduction (the loss and the reduced gradients), ``step`` the update.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from concurrent import futures
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import flags
from repro_torch.core import grad_comm as grad_comm_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.core import tree as tree_lib
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import cosmoflow as cosmoflow_lib
from repro_torch.models import for_config
from repro_torch.models import unet3d as unet_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.train import guard as guard_lib

STAGES = ("fwd", "bwd", "grad_comm", "step")

Params = Dict[str, torch.Tensor]


def replicate(params: Mapping[str, torch.Tensor],
              devices: Sequence[torch.device]) -> List[Params]:
    """One parameter dict per shard: ``params`` itself on its own device,
    one copy for each other device (shared by the shards on it)."""
    home = next(iter(params.values())).device
    copies: Dict[torch.device, Params] = {home: dict(params)}
    for d in devices:
        if d not in copies:
            copies[d] = {k: v.to(d) for k, v in params.items()}
    return [copies[d] for d in devices]


def batch_slice(mesh, rank: int, stage: plan_lib.Stage) -> Tuple[int, int]:
    """(index, count) of shard ``rank``'s slice of the batch: ``stage``'s
    batch axes, major first."""
    at, index, count = mesh.coords(rank), 0, 1
    for a in stage.batch_axes:
        if a in mesh.shape:
            index = index * mesh.degree(a) + at[a]
            count *= mesh.degree(a)
    return index, count


def _rows(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    if t.shape[0] % count:
        raise ValueError(f"a batch of {t.shape[0]} does not divide over "
                         f"{count} data shards")
    n = t.shape[0] // count
    return t.narrow(0, index * n, n)


def block_index(shape: Sequence[int], mesh, rank: int,
                stage: plan_lib.Stage) -> Tuple[slice, ...]:
    """Shard ``rank``'s block of a tensor of ``shape`` (N, D, H, W, ...):
    its slice of the batch (``batch_slice``), and each dim ``stage``
    partitions cut into the mesh degree of its axis, the piece at
    ``rank``'s coordinate; every other dim whole."""
    index, count = batch_slice(mesh, rank, stage)
    if shape[0] % count:
        raise ValueError(f"a batch of {shape[0]} does not divide over "
                         f"{count} data shards")
    n = shape[0] // count
    out = [slice(index * n, (index + 1) * n)] + [
        slice(0, s) for s in shape[1:]]
    at = mesh.coords(rank)
    for d, a in stage.part.active:
        k = mesh.degree(a)
        if shape[d + 1] % k:
            raise ValueError(
                f"dim {d + 1} of the input ({shape[d + 1]}) does not "
                f"divide over the {k}-way axis {a!r}")
        w = shape[d + 1] // k
        out[d + 1] = slice(at[a] * w, (at[a] + 1) * w)
    return tuple(out)


class Block:
    """This process's block of a global batch tensor (a ``RankBatch``'s
    x or y, from the per-rank loader over a process mesh): ``t`` the
    block, ``shape`` the global tensor's (so ``shape[0]`` is the global
    batch), ``micro_batches`` how ``t``'s rows are laid out: M runs of
    equal length, run m the rank's rows of micro-batch m (a pipelined
    plan's; 1 otherwise)."""

    __slots__ = ("t", "shape", "micro_batches")

    def __init__(self, t: torch.Tensor, shape: Sequence[int],
                 micro_batches: int = 1):
        self.t = t
        self.shape = tuple(int(d) for d in shape)
        self.micro_batches = int(micro_batches)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Block":
        return Block(fn(self.t), self.shape, self.micro_batches)

    def __repr__(self) -> str:
        return (f"Block({tuple(self.t.shape)} of {self.shape}, "
                f"micro_batches={self.micro_batches})")


class RankBatch(NamedTuple):
    """A batch as the per-rank loader gives it over a process mesh: this
    rank's ``Block`` of x and of y (None where the rank's group does not
    take it: a pipeline's x goes to the entry group, y to the loss
    group). It unpacks as ``x, y``; ``Session.step`` takes it as it
    takes a global ``(x, y)``."""

    x: Optional[Block]
    y: Optional[Block]


def micro_rows(x, m: int, mb: int):
    """Micro-batch ``m`` (rows ``[m*mb, (m+1)*mb)``) of a global batch
    tensor, or of a rank's ``Block`` whose rows are laid out by
    micro-batch (its run m, as a ``Block`` of the micro-batch)."""
    if not isinstance(x, Block):
        return x[m * mb:(m + 1) * mb]
    M = x.shape[0] // mb
    if x.micro_batches != M:
        raise ValueError(f"{x} is laid out in {x.micro_batches} "
                         f"micro-batches; the step cuts {M}")
    n = x.t.shape[0] // M
    return Block(x.t[m * n:(m + 1) * n], (mb,) + x.shape[1:])


def _block_rank(b: Block, mesh) -> int:
    """The shard a rank's block feeds: its process mesh's one shard."""
    if not isinstance(mesh, ProcessMesh):
        raise ValueError(f"a rank's block ({b}) feeds a process mesh's "
                         f"one shard; {mesh} runs every shard: pass the "
                         "global batch")
    if b.micro_batches != 1:
        raise ValueError(f"{b} is laid out in {b.micro_batches} "
                         "micro-batches: a pipelined step takes it")
    return mesh.rank


def _taken(b: Block, mesh, want: Sequence[slice], what: str
           ) -> List[torch.Tensor]:
    """A rank's block as it is, once its shape is checked against its
    slice ``want`` of the global tensor, contiguous on its device."""
    shape = tuple(s.stop - s.start for s in want)
    if tuple(b.t.shape) != shape:
        raise ValueError(f"rank {mesh.rank}'s block of {what} is "
                         f"{tuple(b.t.shape)}, but its slice of the global "
                         f"{b.shape} is {shape}")
    return [b.t.to(mesh.devices[mesh.rank]).contiguous()]


def split_input(x, mesh, stage: plan_lib.Stage) -> List[torch.Tensor]:
    """Shard r's block of ``x`` (N, D, H, W, C) (``block_index``),
    contiguous on r's device, for each shard this process runs
    (``mesh.local_ranks``). A ``Block`` (the per-rank loader's) is this
    rank's already: taken as it is once its shape is ``block_index``'s."""
    if isinstance(x, Block):
        r = _block_rank(x, mesh)
        return _taken(x, mesh, block_index(x.shape, mesh, r, stage), "x")
    return [x[block_index(x.shape, mesh, r, stage)].to(
        mesh.devices[r]).contiguous() for r in mesh.local_ranks]


def split_batch(y, mesh, stage: plan_lib.Stage) -> List[torch.Tensor]:
    """Shard r's slice of ``y`` along the batch, on r's device (the
    local shards); a ``Block`` taken as it is once checked."""
    if isinstance(y, Block):
        index, count = batch_slice(mesh, _block_rank(y, mesh), stage)
        n = y.shape[0] // count
        want = [slice(index * n, (index + 1) * n)] + [
            slice(0, d) for d in y.shape[1:]]
        return _taken(y, mesh, want, "y")
    return [_rows(y, *batch_slice(mesh, r, stage)).to(
        mesh.devices[r]).contiguous() for r in mesh.local_ranks]


def split_targets(cfg: ConvNetConfig, y, mesh,
                  stage: plan_lib.Stage) -> List[torch.Tensor]:
    """Shard r's targets: CosmoFlow's batch slice of y (N, out_dim), or
    the U-Net's block of its voxel labels (N, D, H, W), split like x."""
    if cfg.arch == "unet3d":
        return split_input(y, mesh, stage)
    return split_batch(y, mesh, stage)


def gather_blocks(outs: Sequence[torch.Tensor], mesh,
                  stage: plan_lib.Stage) -> torch.Tensor:
    """The inverse of ``split_input``: the shards' blocks of a tensor
    split like ``stage``'s input put back in place, batch slices in
    order and each partitioned dim's pieces in axis order, on the mesh's
    home device (a shard whose block another shard also holds — a
    replica — is read once). ``outs``: the local shards' blocks (over
    processes, every rank's is gathered first)."""
    outs = spmd.all_shards(mesh, outs)
    active = list(stage.part.active)
    blocks = {}
    for r, t in enumerate(outs):
        at = mesh.coords(r)
        key = (batch_slice(mesh, r, stage)[0],) + tuple(
            at[a] for _, a in active)
        blocks.setdefault(key, t)
    home = mesh.home

    def join(prefix, dims):
        if not dims:
            return blocks[prefix].to(home)
        (d, a), rest = dims[0], dims[1:]
        parts = [join(prefix + (i,), rest) for i in range(mesh.degree(a))]
        return torch.cat(parts, d + 1) if len(parts) > 1 else parts[0]

    slices = sorted({key[0] for key in blocks})
    parts = [join((i,), active) for i in slices]
    return torch.cat(parts, 0) if len(parts) > 1 else parts[0]


def data_shards(mesh, stage: plan_lib.Stage) -> List[int]:
    """The first shard of each of ``stage``'s batch slices, the slices in
    order: one holder of each data index."""
    firsts = {batch_slice(mesh, r, stage)[0]: r
              for r in reversed(range(mesh.size))}
    return [firsts[i] for i in sorted(firsts)]


def sample_ids(batch: int, mesh, stage: plan_lib.Stage) -> List[range]:
    """Shard r's global sample ids: ``index * n_loc + arange(n_loc)``,
    the reference's, so that dropout masks do not depend on the mesh
    (the local shards)."""
    out = []
    for r in mesh.local_ranks:
        index, count = batch_slice(mesh, r, stage)
        n = batch // count
        out.append(range(index * n, (index + 1) * n))
    return out


def gather_rows(outs: Sequence[torch.Tensor], mesh,
                stage: plan_lib.Stage) -> torch.Tensor:
    """CosmoFlow's per-sample outputs of the shards, whose rows are
    ``stage``'s batch slices (the FC stage's), put together in batch
    order on the mesh's home device, one holder of each slice read
    (``outs``: the local shards'; over processes every rank's is
    gathered first)."""
    outs = spmd.all_shards(mesh, outs)
    home = mesh.home
    rows = [outs[r].to(home) for r in data_shards(mesh, stage)]
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def make_convnet_forward_step(
    cfg: ConvNetConfig,
    mesh,
    *,
    plan: plan_lib.ParallelPlan,
    overlap: Optional[bool] = None,
    precision=None,
) -> Callable[[Sequence[Params], torch.Tensor], torch.Tensor]:
    """Returns ``fwd(params_per_shard, x)``: CosmoFlow's (N, out_dim)
    predictions or the U-Net's (N, D, H, W, out_dim) logits, on shard 0's
    device. ``params_per_shard``: one dict per shard on its device
    (``replicate``); ``x``: the whole batch, on any device (split over
    the entry stage's batch axes and partitioned dims)."""
    unet = cfg.arch == "unet3d"
    if not unet and plan.stage_for(
            cosmoflow_lib.num_blocks(cfg)).part.active:
        raise NotImplementedError(
            f"plan {plan.name!r} partitions the FC head; the port serves "
            "plans whose FC stage is replicated")
    entry = plan.stages[0]
    model = for_config(cfg)

    def body(params: Params, x: torch.Tensor) -> torch.Tensor:
        return model.forward(params, x, cfg, plan=plan, overlap=overlap,
                             precision=precision)

    def fwd(params_per_shard: Sequence[Params],
            x: torch.Tensor) -> torch.Tensor:
        outs = spmd.run(mesh, body, params_per_shard,
                        split_input(x, mesh, entry))
        if unet:
            return gather_blocks(outs, mesh, entry)
        return gather_rows(outs, mesh, plan.final_stage)

    return fwd


def flat_plan(plan: plan_lib.ParallelPlan) -> plan_lib.ParallelPlan:
    """``plan`` without its pipeline: a pipelined plan's stages share one
    data-parallel layout, so the whole model runs as one group there
    (the eval step, on group 0's mesh). Other plans as they are."""
    if plan.n_groups == 1:
        return plan
    return dataclasses.replace(plan, pipeline=None)


def _check_mesh(cfg: ConvNetConfig, mesh, plan,
                grad_comm: Optional[str] = None) -> None:
    """``mesh`` is the plan's (a pipelined plan's: one group's), its
    shards on one device, or one process a shard (``ProcessMesh``)."""
    if cfg.arch not in ("cosmoflow", "unet3d"):
        raise NotImplementedError(f"no train step for arch {cfg.arch!r}")
    if mesh.shape != dict(plan.mesh_axes):
        raise ValueError(f"plan {plan.name!r} has mesh {dict(plan.mesh_axes)}"
                         f", but the step runs on {mesh.shape}")
    if isinstance(mesh, ProcessMesh):
        check_process_plan(plan, grad_comm)
        return
    if len(set(mesh.devices)) != 1:
        raise NotImplementedError(
            f"training puts every shard of an in-process mesh on one "
            f"device; {mesh} spans several: one process a shard "
            f"(launch.mesh.ProcessMesh, under torchrun) places shards on "
            f"cards of their own")


# ZeRO-1 and pipeline groups do not compose, in a process or over several
ZERO1_PIPELINE = ("grad_comm='reduce_scatter' does not compose with pipeline "
                  "groups (ZeRO-1 shards the full tree over one mesh); use "
                  "'overlap' or 'monolithic'")


def check_process_plan(plan: plan_lib.ParallelPlan,
                       grad_comm: Optional[str] = None) -> None:
    """Raise for what a process mesh does not train: ZeRO-1 with
    pipeline groups (``ValueError``, as in one process)."""
    if (plan.n_groups > 1 and grad_comm is not None
            and grad_comm_lib.resolve(grad_comm) == "reduce_scatter"):
        raise ValueError(ZERO1_PIPELINE)


def convnet_grad_plan(cfg: ConvNetConfig) -> grad_comm_lib.Plan:
    """The bucket plan of ``cfg``'s parameters (the reference's): the
    flat layout of ZeRO-1's gradients and optimizer state."""
    return grad_comm_lib.make_plan(
        {k: torch.empty(s, device="meta")
         for k, s in for_config(cfg).param_shapes(cfg).items()})


def data_degree(plan: plan_lib.ParallelPlan) -> int:
    """N of ZeRO-1: the product of the entry stage's batch axes'
    degrees."""
    return math.prod(plan.degree(a) for a in plan.stages[0].batch_axes)


def make_convnet_opt_state(cfg: ConvNetConfig, optimizer, params, *,
                           grad_comm: Optional[str] = None,
                           plan: Optional[plan_lib.ParallelPlan] = None,
                           mesh=None, precision=None):
    """Optimizer state matching ``make_convnet_train_step``: the
    optimizer wrapped for the policy (fp16 carries the loss-scale
    machine; fp32/bf16 are unwrapped), initialized on ``params``'
    device, the same for every shard. ``precision`` defaults to the
    plan's. Under ``reduce_scatter`` (which needs ``plan`` and its
    ``mesh``): a list of one state per shard of the mesh, in rank order,
    each its data index's 1/N of the padded flat buckets
    (``grad_comm.local_opt_state`` of ``init_sharded_opt_state`` over
    ``convnet_grad_plan``; N the data degree), its step count and loss
    scale replicated. Over processes (``ProcessMesh``) the list holds
    this rank's state alone (its ``local_ranks``)."""
    mode = grad_comm_lib.resolve(grad_comm)
    if precision is None and plan is not None:
        precision = plan.precision
    optimizer = precision_lib.wrap_optimizer(optimizer, precision)
    if mode != "reduce_scatter":
        return optimizer.init(params)
    if plan is None or mesh is None:
        raise ValueError("grad_comm='reduce_scatter' shards the optimizer "
                         "state over the plan's data axes: pass plan= "
                         "and mesh=")
    buckets = convnet_grad_plan(cfg)
    n = data_degree(plan)
    device = next(iter(params.values())).device
    whole = grad_comm_lib.init_sharded_opt_state(
        optimizer, buckets, num_shards=n, device=device)
    return [grad_comm_lib.local_opt_state(
        whole, buckets, batch_slice(mesh, r, plan.stages[0])[0], n)
        for r in mesh.local_ranks]


def _build_convnet_step(cfg: ConvNetConfig, mesh, optimizer, *,
                        global_batch: int, overlap: Optional[bool],
                        grad_comm: Optional[str], stage: str,
                        plan: plan_lib.ParallelPlan, precision=None,
                        guard: bool = False,
                        mask_source: Optional[
                            cosmoflow_lib.MaskSource] = None):
    """The train step and its phase probes (``stage``, one of
    ``STAGES``; the module docstring has the phases).

    ``precision`` (default: the plan's) casts the masters at each use in
    the model; fp16 scales each shard's loss by the running scale before
    the backward and hands the scale to the optimizer, which unscales
    before clipping and skips non-finite steps. ``guard`` adds the
    non-finite step guard for every precision, its verdict agreed over
    every shard, and a fourth output, 1.0 if the update applied and 0.0
    if not."""
    if stage not in STAGES:
        raise ValueError(f"stage={stage!r}; expected one of {STAGES}")
    mode = grad_comm_lib.resolve(grad_comm)
    if plan.n_groups > 1:
        raise ValueError(f"plan {plan.name!r} is pipelined; use "
                         "make_pipeline_train_step")
    _check_mesh(cfg, mesh, plan, mode)
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    optimizer = precision_lib.wrap_optimizer(optimizer, policy)
    entry = plan.stages[0]
    axes = plan.axis_names
    zero1 = mode == "reduce_scatter"
    data_axes = tuple(entry.batch_axes)
    buckets = convnet_grad_plan(cfg) if zero1 else None
    # where the backward reduces: every axis (overlap), the spatial axes
    # (ZeRO-1: the data axes are the buckets' reduce-scatter), none
    hook_axes = ()
    if stage in ("grad_comm", "step"):
        hook_axes = (axes if mode == "overlap" else
                     plan.spatial_axis_names if zero1 else ())
    n = len(mesh.local_ranks)

    def shard_loss(params, x, y, ids, seed, scale):
        if cfg.arch == "unet3d":
            loss = unet_lib.segmentation_loss(
                params, x, y, cfg, plan=plan, bn_axes=axes,
                global_voxels=global_batch * cfg.input_width ** 3,
                overlap=overlap, precision=policy, grad_axes=hook_axes)
        else:
            loss = cosmoflow_lib.mse_loss(
                params, x, y, cfg, plan=plan, bn_axes=axes,
                global_batch=global_batch, train=True, dropout_seed=seed,
                sample_ids=ids, mask_source=mask_source, overlap=overlap,
                precision=policy, grad_axes=hook_axes)
        # fp16: the loss times the running scale, so that small
        # cotangents survive; the unscaled loss is reported
        return loss, (loss if scale is None else loss * scale)

    def finish(grads, opt_state, params, loss):
        loss = spmd.axis(axes).psum(loss)
        if stage == "bwd":
            gsum = sum(g.sum() for g in grads.values())
            return loss, spmd.axis(axes).psum(gsum)
        if mode == "monolithic":
            grads = grad_comm_lib.reduce_grads(grads, axes)
        if stage == "grad_comm":
            if zero1:  # the scatter and the gather, no optimizer math
                grads = grad_comm_lib.all_gather_params(
                    grad_comm_lib.reduce_scatter_grads(grads, buckets,
                                                       data_axes),
                    buckets, data_axes, grads)
            return loss, grads
        applied = None
        if guard:
            applied = guard_lib.agreed_finite(loss, grads, axes)
            if policy.uses_scaling:
                grads = guard_lib.poison_unless(applied, grads)
        if zero1:
            new_params, new_opt = grad_comm_lib.sharded_update(
                optimizer, grads, opt_state, params, buckets, data_axes)
        else:
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        if guard and not policy.uses_scaling:
            new_params = guard_lib.tree_select(applied, new_params, params)
            new_opt = guard_lib.tree_select(applied, new_opt, opt_state)
        if guard:
            return new_params, new_opt, loss, applied.float()
        return new_params, new_opt, loss

    def step(params, opt_state, x, y, seed):
        xs = split_input(x, mesh, entry)
        ys = split_targets(cfg, y, mesh, entry)
        ids = sample_ids(x.shape[0], mesh, entry)
        seeds = [int(seed)] * n
        if stage == "fwd":
            def fwd(*args):
                return spmd.axis(axes).psum(shard_loss(*args)[0])

            with torch.no_grad():
                return spmd.run(mesh, fwd, [params] * n, xs, ys, ids, seeds,
                                [None] * n)[0]
        states = opt_state if zero1 else [opt_state] * n
        scale = (precision_lib.current_scale(states[0], policy).to(
            mesh.home) if policy.uses_scaling else None)
        leaves = [{k: v.detach().requires_grad_(True)
                   for k, v in params.items()} for _ in range(n)]
        with torch.enable_grad():
            out = spmd.run(mesh, shard_loss, leaves, xs, ys, ids, seeds,
                           [scale] * n)
            flat = [leaf for shard in leaves for leaf in shard.values()]
            found = torch.autograd.grad([s for _, s in out], flat)
        names = list(params)
        grads = [dict(zip(names, found[r * len(names):(r + 1) * len(names)]))
                 for r in range(n)]
        outs = spmd.run(mesh, finish, grads, states, [params] * n,
                        [v.detach() for v, _ in out])
        if zero1 and stage == "step":  # every shard's own state
            return (outs[0][0], [o[1] for o in outs]) + tuple(outs[0][2:])
        return outs[0]

    return step


def make_convnet_train_step(cfg: ConvNetConfig, mesh, optimizer, *,
                            global_batch: int,
                            plan: plan_lib.ParallelPlan,
                            overlap: Optional[bool] = None,
                            grad_comm: Optional[str] = None,
                            precision=None, guard: bool = False,
                            mask_source: Optional[
                                cosmoflow_lib.MaskSource] = None):
    """Returns ``step(params, opt_state, x, y, seed) -> (params, opt,
    loss)`` (``guard=True``: ``(params, opt, loss, applied)``). ``params``
    are the fp32 masters and ``opt_state`` comes from
    ``make_convnet_opt_state`` with the same policy and ``grad_comm``
    (under ``reduce_scatter``, one state a shard); neither is modified:
    the step returns new ones. ``y``: CosmoFlow's (N, out_dim) targets
    or the U-Net's (N, D, H, W) voxel labels. ``seed`` (the step count)
    seeds CosmoFlow's dropout masks (the U-Net has no dropout)."""
    return _build_convnet_step(
        cfg, mesh, optimizer, global_batch=global_batch, overlap=overlap,
        grad_comm=grad_comm, stage="step", plan=plan, precision=precision,
        guard=guard, mask_source=mask_source)


def make_convnet_phase_probes(cfg: ConvNetConfig, mesh, optimizer, *,
                              global_batch: int,
                              plan: plan_lib.ParallelPlan,
                              overlap: Optional[bool] = None,
                              grad_comm: Optional[str] = None,
                              precision=None,
                              mask_source=None) -> Dict[str, Callable]:
    """The ``fwd``, ``bwd``, ``grad_comm`` and ``step`` probes, each with
    the step's signature; successive differences of their times
    attribute a step to forward, backward, gradient reduction and
    optimizer. ``grad_comm`` returns ``(loss, reduced gradients)``."""
    return {stage: _build_convnet_step(
        cfg, mesh, optimizer, global_batch=global_batch, overlap=overlap,
        grad_comm=grad_comm, stage=stage, plan=plan, precision=precision,
        mask_source=mask_source) for stage in STAGES}


def make_convnet_eval_step(cfg: ConvNetConfig, mesh, *, global_batch: int,
                           plan: plan_lib.ParallelPlan,
                           overlap: Optional[bool] = None, precision=None
                           ) -> Callable[[Params, torch.Tensor,
                                          torch.Tensor], Tuple[Any, Any]]:
    """Returns ``eval(params, x, y) -> (loss, preds)`` over the step's
    mesh: the forward without dropout, no gradients recorded. CosmoFlow:
    the fp32 MSE over ``global_batch`` samples summed over every shard
    (each shard's targets cut to its FC stage's rows), and the
    predictions of every batch slice of the FC stage in order
    (``gather_rows``); the U-Net: the voxel cross-entropy over
    ``global_batch * W^3`` voxels (``segmentation_loss``'s operations)
    and the per-voxel logits put back together (``gather_blocks``). Both
    on shard 0's device. A pipelined plan evaluates on group 0's mesh
    as plain data parallelism (``flat_plan``)."""
    _check_mesh(cfg, mesh, plan)
    plan = flat_plan(plan)
    entry = plan.stages[0]
    axes = plan.axis_names
    n = len(mesh.local_ranks)
    unet = cfg.arch == "unet3d"

    def local_eval(params, x, y):
        if unet:
            pred = unet_lib.forward(params, x, cfg, plan=plan,
                                    overlap=overlap, precision=precision)
            loss = unet_lib.voxel_nll(
                pred, y, global_batch * cfg.input_width ** 3)
        else:
            pred = cosmoflow_lib.forward(params, x, cfg, plan=plan,
                                         overlap=overlap,
                                         precision=precision)
            y = reshard.shard_batch(y, plan.batch_extension_axes)
            loss = cosmoflow_lib.mse(pred, y,
                                     global_batch * plan.loss_redundancy)
        return spmd.axis(axes).psum(loss), pred

    def fn(params, x, y):
        with torch.no_grad():
            out = spmd.run(mesh, local_eval, [params] * n,
                           split_input(x, mesh, entry),
                           split_targets(cfg, y, mesh, entry))
        if unet:
            return out[0][0], gather_blocks([o[1] for o in out], mesh,
                                            entry)
        return out[0][0], gather_rows([o[1] for o in out], mesh,
                                      plan.final_stage)

    return fn


# ------------------------------------------------- pipeline groups ----
def pipeline_group_names(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan
                         ) -> Tuple[Tuple[str, ...], ...]:
    """The names of the parameters each pipeline group owns: group g
    those its layers ``plan.group_layer_ranges()[g]`` use
    (``segment_param_names``), disjoint sets covering the model."""
    seg = for_config(cfg).segment_param_names
    return tuple(tuple(seg(cfg, a, b)) for a, b in plan.group_layer_ranges())


def pipeline_group_params(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan,
                          params: Mapping[str, torch.Tensor]
                          ) -> Tuple[Params, ...]:
    """The parameters each pipeline group owns (``pipeline_group_names``),
    disjoint subsets whose union is ``params``."""
    return tuple({k: params[k] for k in names}
                 for names in pipeline_group_names(cfg, plan))


def local_groups(meshes) -> Tuple[int, ...]:
    """The pipeline groups this process runs: every group in one
    process; over processes its own (``launch.mesh.PeerGroup``s run
    elsewhere)."""
    return tuple(g for g, m in enumerate(meshes) if m.local_ranks)


def pipeline_loss_group(cfg: ConvNetConfig,
                        plan: plan_lib.ParallelPlan) -> int:
    """The pipeline group whose node computes the loss, and so takes y:
    CosmoFlow's last group, the U-Net's group 0 (its ascent ends where
    its descent began). Group 0 takes x."""
    return 0 if cfg.arch == "unet3d" else plan.n_groups - 1


def make_pipeline_opt_state(cfg: ConvNetConfig, optimizer, params, *,
                            plan: plan_lib.ParallelPlan, meshes=None,
                            precision=None) -> Tuple[Any, ...]:
    """The state of ``make_pipeline_train_step``: one optimizer state a
    group, over the group's parameters, each on its group's device when
    ``meshes`` are given; over processes (``make_pipeline_meshes(...,
    processes=True)``) None for every group but this process's, whose
    parameters ``params`` must hold. fp16 raises, as the step does."""
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    if policy.uses_scaling:
        raise ValueError("fp16 loss scaling is not supported under "
                         "pipeline groups; use fp32 or bf16")
    optimizer = precision_lib.wrap_optimizer(optimizer, policy)
    names = pipeline_group_names(cfg, plan)
    mine = range(len(names)) if meshes is None else local_groups(meshes)
    out = []
    for g, ns in enumerate(names):
        if g not in mine:
            out.append(None)
            continue
        pg = {k: params[k] for k in ns}
        if meshes is not None:
            pg = reshard.to_group(pg, meshes[g].home)
        out.append(optimizer.init(pg))
    return tuple(out)


def _schedule_order(K: int, M: int, schedule: str):
    """The host dispatch order of a K-node forward chain over M
    micro-batches, the reference's. ``sequential``, the GPipe-naive
    oracle: per micro-batch the whole forward chain, the loss node's
    fused forward and backward (``FB``), the backward chain, then a
    ``SYNC`` (nothing of the next micro-batch starts before this one has
    drained). ``1f1b``: node k runs ``min(K-1-k, M)`` warm-up forwards,
    then alternates forward and backward, the forward first in each
    pair, so that ``K-k`` micro-batches stay in flight; the nodes'
    streams merged by a dependency scan into a valid order. The order
    changes no value, only what overlaps."""
    if schedule == "sequential":
        out = []
        for m in range(M):
            out += [("F", k, m) for k in range(K - 1)]
            out.append(("FB", K - 1, m))
            out += [("B", k, m) for k in range(K - 2, -1, -1)]
            out.append(("SYNC", -1, m))
        return out
    per = []
    for k in range(K - 1):
        warm = min(K - 1 - k, M)
        seq = [("F", k, m) for m in range(warm)]
        f_next = warm
        for b in range(M):
            if f_next < M:
                seq.append(("F", k, f_next))
                f_next += 1
            seq.append(("B", k, b))
        per.append(seq)
    per.append([("FB", K - 1, m) for m in range(M)])
    done, order, pos = set(), [], [0] * K
    total = sum(len(s) for s in per)
    while len(order) < total:
        progressed = False
        for k in range(K):
            while pos[k] < len(per[k]):
                op, _, m = per[k][pos[k]]
                if op == "F" and k > 0 and ("F", k - 1, m) not in done:
                    break
                if op == "FB" and ("F", k - 1, m) not in done:
                    break
                if op == "B" and ("B", k + 1, m) not in done \
                        and ("FB", k + 1, m) not in done:
                    break
                done.add((op, k, m))
                order.append((op, k, m))
                pos[k] += 1
                progressed = True
        if not progressed:  # pragma: no cover — the schedule's invariant
            raise RuntimeError("1F1B dependency scan deadlocked")
    return order


class _Slots:
    """One-shot hand-off slots between dispatcher threads: ``set(key,
    value)`` once, ``take(key)`` once, blocking until the value is there
    (a ``Future`` value — an emulated link in flight — is resolved).
    ``fail(exc)`` makes every outstanding and later slot raise ``exc``,
    so that a dispatcher that died wakes its peers instead of leaving
    them blocked."""

    def __init__(self):
        self._d: Dict[Any, futures.Future] = {}
        self._lk = threading.Lock()
        self._exc: Optional[BaseException] = None

    def _fut(self, key) -> futures.Future:
        with self._lk:
            if self._exc is not None:
                f = futures.Future()
                f.set_exception(self._exc)
                return f
            f = self._d.get(key)
            if f is None:
                f = self._d[key] = futures.Future()
            return f

    def set(self, key, val) -> None:
        self._fut(key).set_result(val)

    def take(self, key):
        v = self._fut(key).result()
        if isinstance(v, futures.Future):
            v = v.result()
        with self._lk:
            self._d.pop(key, None)
        return v

    def fail(self, exc: BaseException) -> None:
        with self._lk:
            self._exc = exc
            for f in self._d.values():
                if not f.done():
                    f.set_exception(exc)


class _Node:
    """One node of the pipelined forward chain: its group, what it is
    (``seg``, CosmoFlow's last ``loss``; the U-Net's ``down``, ``core``,
    ``up`` and ``uploss``), the parameters it uses, its per-shard body
    (``body(params, *inputs)``) and, for an up node, its down partner."""

    def __init__(self, kind: str, group: int, names: Sequence[str],
                 body: Callable, partner: Optional[int] = None):
        self.kind, self.group, self.names = kind, group, tuple(names)
        self.body, self.partner = body, partner

    @property
    def is_loss(self) -> bool:
        return self.kind in ("loss", "uploss")


def _flat(outs) -> List[torch.Tensor]:
    """A shard's outputs (a tensor, or a tensor and a tuple of skips) as
    a list of tensors."""
    if isinstance(outs, torch.Tensor):
        return [outs]
    return [outs[0], *outs[1]]


def make_pipeline_train_step(cfg: ConvNetConfig, meshes, optimizer, *,
                             plan: plan_lib.ParallelPlan, global_batch: int,
                             grad_comm: Optional[str] = None,
                             precision=None, guard: bool = False,
                             schedule: Optional[str] = None,
                             stage: str = "step",
                             overlap: Optional[bool] = None,
                             mask_source: Optional[
                                 cosmoflow_lib.MaskSource] = None):
    """The pipelined train step over ``plan``'s groups (``meshes``, one a
    group, ``launch.mesh.make_pipeline_meshes``; each a data-parallel
    mesh on one device). Returns ``step(params, opt_states, x, y, seed)
    -> (params, opt_states, loss[, applied])``: ``params`` the whole
    fp32 tree (each leaf on its group's device), ``opt_states``
    ``make_pipeline_opt_state``'s tuple, ``x``/``y`` the global batch,
    cut here into the plan's M micro-batches. ``stage`` (``STAGES``)
    builds the probes as ``_build_convnet_step`` does: ``fwd`` the loss,
    ``bwd`` the loss and the sum of every shard's gradients unreduced,
    ``grad_comm`` the loss and the reduced gradients of every group
    merged into one tree (before the update), ``step`` the update.

    The forward is a chain of K nodes: CosmoFlow's one segment a group
    (``forward_range``), the last fused with the loss; the U-Net's
    down_0 .. down_{P-2}, core_{P-1} (the deepest group's descent,
    bottleneck and ascent), up_{P-2} .. up_1 and up_0 fused with the
    loss, each group's skips staying on it. Each node runs over its
    group's mesh through ``spmd.run``. A non-loss node's forward runs
    under ``no_grad`` and keeps only its input; its backward runs the
    segment again with gradients on (``spmd.run``, so its batch-norm
    sums and reduction hooks are single autograd nodes over the group's
    shards again) and takes ONE ``torch.autograd.grad`` over every
    shard's output. ``schedule`` (default the plan's) gives the dispatch
    order (``_schedule_order``); ONE dispatcher thread a group walks its
    part of it, on a stream of its own on a card. Activations and
    cotangents cross groups as ``reshard.cross_group`` hand-offs through
    one-shot slots (``_Slots``), after ``flags.PIPELINE_LINK_LATENCY_S``
    on a link thread when set; a dispatcher waits for another group only
    there, between nodes, never inside a backward (the autograd engine
    runs every CUDA node of every caller on one thread a device, and a
    node blocked on a peer would starve it). A dispatcher that raises
    breaks the barrier and poisons the slots, so the step ends with its
    error.

    Each node's gradients accumulate over the micro-batches in
    micro-batch order; after the drain each group updates its own
    parameters and state. The reduction is ``grad_comm``'s within each
    group: ``overlap`` hooks the bucketed sums into each node's backward
    (``GradMarker``), ``monolithic`` sums after it; ``reduce_scatter``
    raises. ``guard`` multiplies every group's finiteness flag (the loss
    group's with the loss), so every group holds its values unless all
    are finite. The local loss is ``sum(per-sample)/global_batch`` (the
    U-Net's over ``global_batch * W^3`` voxels), so the micro-batches'
    losses and gradients sum to the whole batch's; dropout masks are
    drawn for the global row ids (``m * micro-batch`` + the shard's
    offset); batch-norm statistics span one micro-batch. fp16 and
    ``grad_clip`` raise. The two schedules are bitwise equal.

    Over processes (``make_pipeline_meshes(..., processes=True)``: this
    process a shard of one group's ``ProcessMesh``, the others
    ``PeerGroup``s) the process walks its own group's ops alone, on its
    one shard: ``params`` and ``opt_states`` hold its group's (the
    others' states None) and so does the step's result. A hand-off to
    another group goes over the ``PipelineWorld``'s link to the same
    shard index there (``reshard.Courier``: queued, never waited for
    inside a node; a receiver thread a link fills the slots); ``SYNC``
    is a barrier over the world after the group's stream has drained;
    the loss group's shards gather their losses; and the loss, every
    group's guard flag (and the ``grad_comm`` probe's merged tree, the
    ``bwd`` probe's sums) reach every rank from each group's shard 0.
    The values are the in-process step's, to the bit."""
    if stage not in STAGES:
        raise ValueError(f"stage={stage!r}; expected one of {STAGES}")
    mode = grad_comm_lib.resolve(grad_comm)
    if mode == "reduce_scatter":
        raise ValueError(ZERO1_PIPELINE)
    spec, n_grp = plan.pipeline, plan.n_groups
    if spec is None or n_grp < 2:
        raise ValueError(f"plan {plan.name!r} has no pipeline axis; use "
                         "make_convnet_train_step")
    if len(meshes) != n_grp:
        raise ValueError(f"plan {plan.name!r} has {n_grp} groups but "
                         f"{len(meshes)} meshes were given")
    world = next((m.pipeline for m in meshes
                  if getattr(m, "pipeline", None) is not None), None)
    mine = local_groups(meshes)
    for g in mine:
        _check_mesh(cfg, meshes[g], plan, mode)
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    if policy.uses_scaling:
        raise ValueError("fp16 loss scaling is not supported under "
                         "pipeline groups; use fp32 or bf16")
    if getattr(optimizer, "grad_clip", 0.0):
        raise ValueError("grad_clip needs the global grad norm across "
                         "groups; set grad_clip=0 under pipelined plans")
    sched = schedule if schedule is not None else spec.schedule
    if sched not in plan_lib.PIPELINE_SCHEDULES:
        raise ValueError(f"schedule={sched!r}; expected one of "
                         f"{plan_lib.PIPELINE_SCHEDULES}")
    M = spec.micro_batches
    if global_batch % M:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"micro_batches={M}")
    mb = global_batch // M
    if mb % plan.data_degree:
        raise ValueError(f"micro-batch {mb} not divisible by the per-group "
                         f"data degree {plan.data_degree}")
    axes = plan.axis_names
    entry = plan.stages[0]
    hooks = stage in ("grad_comm", "step")
    gx = axes if hooks and mode == "overlap" else ()
    reduce_after = hooks and mode == "monolithic"
    ranges = plan.group_layer_ranges()
    group_names = pipeline_group_names(cfg, plan)
    layouts = [reshard.group_sharding(m, entry.batch_axes) for m in meshes]
    kw = dict(bn_axes=axes, precision=policy, overlap=overlap)

    def hooked():
        # the reduction hooks only where autograd records (a backward's
        # recompute), so that a forward counts no buckets
        return gx if torch.is_grad_enabled() else ()

    loss_group = pipeline_loss_group(cfg, plan)
    nodes: List[_Node] = []
    if cfg.arch == "cosmoflow":
        for g, (a, b) in enumerate(ranges):
            names = cosmoflow_lib.segment_param_names(cfg, a, b)
            if g < n_grp - 1:
                def seg(p, h, _a=a, _b=b):
                    return cosmoflow_lib.forward_range(
                        p, h, cfg, _a, _b, train=True,
                        grad_axes=hooked(), **kw)
                nodes.append(_Node("seg", g, names, seg))
            else:
                def loss(p, h, y, seed, ids, _a=a, _b=b):
                    pred = cosmoflow_lib.forward_range(
                        p, h, cfg, _a, _b, train=True, dropout_seed=seed,
                        sample_ids=ids, mask_source=mask_source,
                        grad_axes=hooked(), **kw)
                    return cosmoflow_lib.mse(pred, y, global_batch)
                nodes.append(_Node("loss", g, names, loss))
    else:
        voxels = global_batch * cfg.input_width ** 3

        for g in range(n_grp - 1):
            a, b = ranges[g]

            def down(p, h, _a=a, _b=b):
                return unet_lib.down_range(p, h, cfg, _a, _b,
                                           grad_axes=hooked(), **kw)
            nodes.append(_Node("down", g,
                               unet_lib.down_param_names(cfg, a, b), down))
        a, b = ranges[-1]
        dn = unet_lib.down_param_names(cfg, a, b)
        up = unet_lib.up_param_names(cfg, a, b)

        def core(p, h, _a=a, _b=b):
            h, sk = unet_lib.down_range({k: p[k] for k in dn}, h, cfg, _a,
                                        _b, grad_axes=hooked(), **kw)
            return unet_lib.up_range({k: p[k] for k in up}, h, sk, cfg, _a,
                                     _b, grad_axes=hooked(), **kw)
        nodes.append(_Node("core", n_grp - 1, dn + up, core))
        for g in range(n_grp - 2, -1, -1):
            a, b = ranges[g]
            names = unet_lib.up_param_names(cfg, a, b)
            if g > 0:
                def up_node(p, h, sk, _a=a, _b=b):
                    return unet_lib.up_range(p, h, sk, cfg, _a, _b,
                                             grad_axes=hooked(), **kw)
                nodes.append(_Node("up", g, names, up_node, partner=g))
            else:
                def uploss(p, h, sk, y, _a=a, _b=b):
                    logits = unet_lib.up_range(p, h, sk, cfg, _a, _b,
                                               grad_axes=hooked(), **kw)
                    return unet_lib.voxel_nll(logits, y, voxels)
                nodes.append(_Node("uploss", 0, names, uploss, partner=0))
    K = len(nodes)
    if stage == "fwd":
        order = [("F", k, m) for m in range(M) for k in range(K)]
    else:
        order = _schedule_order(K, M, sched)
    group_ops: Tuple[List, ...] = tuple([] for _ in range(n_grp))
    for op in order:
        for g in (range(n_grp) if op[0] == "SYNC"
                  else (nodes[op[1]].group,)):
            group_ops[g].append(op)

    def dest(op: str, k: int) -> Optional[int]:
        """The node to which ``op`` on node k hands a value (None:
        none)."""
        if op == "F":
            return None if nodes[k].is_loss else k + 1
        if op in ("FB", "B") and k > 0:
            return k - 1
        return None

    # over processes: the hand-offs each neighbouring group sends this
    # one a step (shard j to shard j), in that group's dispatch order
    incoming = {} if world is None else {h: sum(
        1 for op, k, _ in group_ops[h] if dest(op, k) is not None
        and nodes[dest(op, k)].group == world.group) for h in world.links}
    optimizer = precision_lib.wrap_optimizer(optimizer, policy)
    streams: Dict[int, Any] = {}

    def group_stream(g: int):
        """Group g's dispatcher stream on a card (None on the CPU)."""
        device = meshes[g].home
        if device.type != "cuda":
            return None
        if g not in streams:
            streams[g] = torch.cuda.Stream(device=device)
        return streams[g]

    def forward(nd: _Node, pg: Params, *ins):
        """``nd``'s forward over its group, no gradients recorded: each
        local shard's outputs (``ins``: the arguments after the
        parameters, one list of local shards each)."""
        mesh = meshes[nd.group]
        with torch.no_grad():
            return spmd.run(mesh, nd.body, [pg] * len(mesh.local_ranks),
                            *ins)

    def backward(nd: _Node, pg: Params, ins: Sequence[Sequence[Any]],
                 needs: Sequence[bool], gouts):
        """``nd``'s segment again with gradients on, then one backward
        over every local shard's outputs (the loss nodes': their losses;
        the others': against the cotangents ``gouts``, a list of tensors
        a shard). ``ins``: the arguments after the parameters, one list
        of local shards each (a tuple of skips is one argument);
        ``needs``: which need a gradient. Returns (a loss node's shards'
        losses, the first local shard's parameter gradients reduced as
        ``grad_comm`` says — or, in the ``bwd`` probe, the sum of every
        shard's —, each shard's input gradients, one list an argument
        that needs one)."""
        mesh = meshes[nd.group]
        d = len(mesh.local_ranks)
        leaves = [{n: pg[n].detach().requires_grad_(True) for n in nd.names}
                  for _ in range(d)]

        def fresh(t, need):
            if isinstance(t, tuple):
                return tuple(fresh(u, need) for u in t)
            return t.detach().requires_grad_(need) if need else t

        args = [[fresh(t, need) for t in arg] for arg, need in zip(ins, needs)]
        with torch.enable_grad():
            outs = spmd.run(mesh, nd.body, leaves, *args)
        wrt_in = [arg for arg, need in zip(args, needs) if need]
        flat_in = [t for arg in wrt_in for shard in arg
                   for t in (shard if isinstance(shard, tuple) else (shard,))]
        flat_p = [leaf for shard in leaves for leaf in shard.values()]
        if nd.is_loss:
            found = torch.autograd.grad(outs, flat_p + flat_in)
        else:
            ys = [t for o in outs for t in _flat(o)]
            gs = [t for shard in gouts for t in shard]
            found = torch.autograd.grad(ys, flat_p + flat_in, gs)
        n_p = len(nd.names)
        grads = [dict(zip(nd.names, found[r * n_p:(r + 1) * n_p]))
                 for r in range(d)]
        if reduce_after:
            grads = spmd.run(mesh, lambda g_: grad_comm_lib.reduce_grads(
                g_, axes), grads)
        if stage == "bwd":
            sums = [g_.sum() for shard in grads for g_ in shard.values()]
            if world is not None:  # every shard's, in rank order
                sums = [v for row in spmd.all_shards(
                    mesh, [torch.stack(sums)]) for v in row]
            gp = sum(sums)
        else:
            gp = grads[0]
        it = iter(found[d * n_p:])
        gins = []
        for arg in wrt_in:
            gins.append([tuple(next(it) for _ in shard)
                         if isinstance(shard, tuple) else next(it)
                         for shard in arg])
        return ([o.detach() for o in outs] if nd.is_loss else None), gp, gins

    def step(params, opt_states, x, y, seed):
        with trace_lib.span("pipe.place", micro_batches=M):
            pgs = {g: reshard.to_group({k: params[k] for k in
                                        group_names[g]}, meshes[g].home)
                   for g in mine}
            opts = {g: reshard.to_group(opt_states[g], meshes[g].home)
                    for g in mine}
            if 0 in mine:
                xs = [split_input(micro_rows(x, m, mb), meshes[0], entry)
                      for m in range(M)]
            if loss_group in mine:
                ys = [split_targets(cfg, micro_rows(y, m, mb),
                                    meshes[loss_group], entry)
                      for m in range(M)]
        lmesh = meshes[loss_group]

        def loss_extra(m):
            if cfg.arch == "unet3d":
                return [ys[m]]
            ids = [range(m * mb + r.start, m * mb + r.stop)
                   for r in sample_ids(mb, lmesh, entry)]
            return [ys[m], [int(seed)] * len(lmesh.local_ranks), ids]

        carry, gcar = _Slots(), _Slots()
        if 0 in mine:
            for m in range(M):
                carry.set((0, m), xs[m])
        courier = None
        if world is not None:
            courier = reshard.Courier(world.links, meshes[world.group].home)

            def deliver(key, value):
                if key is None:  # the receiver failed: wake the dispatcher
                    carry.fail(value)
                    gcar.fail(value)
                else:
                    (carry, gcar)[key[0]].set(tuple(key[1:]), value)
            for h, count in incoming.items():
                courier.receive(h, count, deliver)
        # each key is written and read by one dispatcher: skips stay on
        # their group, a node's saved input backs its own recompute, and
        # acc[k] belongs to k's group
        saved: Dict[Any, Any] = {}
        stash: Dict[Any, Any] = {}
        gskips: Dict[Any, Any] = {}
        acc: List[Any] = [None] * K
        losses: List[Any] = [None] * M
        barrier = threading.Barrier(len(mine))
        # the caller's stream on each local group's device (None: CPU)
        caller = {g: torch.cuda.current_stream(meshes[g].home)
                  if meshes[g].home.type == "cuda" else None for g in mine}
        lat = flags.PIPELINE_LINK_LATENCY_S if world is None else 0.0
        links = (futures.ThreadPoolExecutor(
            max_workers=min(32, max(2 * (n_grp - 1) * M, 1)),
            thread_name_prefix="pipe-link") if lat else None)

        def link(handoff):
            # the emulated latency burns on a link thread, as a NIC would
            # carry it: a schedule pays it only where a consumer has
            # nothing else to dispatch
            with trace_lib.span("pipe.link", latency_s=lat):
                time.sleep(lat)
                return handoff

        def route(vals, dst_k, slot, m):
            # consecutive nodes of the chain lie on different groups
            h = nodes[dst_k].group
            if h not in mine:  # another process's: over the link
                courier.send(h, (int(slot is gcar), dst_k, m), vals[0])
                return
            handoff = reshard.cross_group(vals, layouts[h])
            slot.set((dst_k, m), links.submit(link, handoff) if links
                     else handoff)

        def take(slot, key):  # node 0's inputs come as the caller put them
            v = slot.take(key)
            return (v.wait() if isinstance(
                v, (reshard.Handoff, reshard.ProcessHandoff)) else v)

        def bump(k, gp):
            if acc[k] is None:
                acc[k] = gp
            elif isinstance(gp, dict):
                for n, v in gp.items():
                    acc[k][n] += v
            else:
                acc[k] = acc[k] + gp

        def micro_loss(outs):  # the shards' losses in rank order
            return sum(outs[1:], outs[0])

        threads_n = torch.get_num_threads()

        def run_group(g: int):
            spmd.same_threads(threads_n)
            s = group_stream(g)
            ctx = (torch.cuda.stream(s) if s is not None
                   else contextlib.nullcontext())
            with ctx:
                if s is not None:  # the group sees what the caller enqueued
                    s.wait_stream(caller[g])
                dispatch(g)
                if s is not None:
                    return s.record_event()
            return None

        def sync(g: int):
            # GPipe-naive: nothing of micro-batch m + 1 starts anywhere
            # before micro-batch m has drained
            s = group_stream(g)
            if world is not None:  # this group's work, then every process
                if s is not None:
                    s.synchronize()
                world.barrier()
                return
            barrier.wait()
            if s is not None:
                s.synchronize()
            barrier.wait()

        def dispatch(g: int):
            pg = pgs[g]
            for op, k, m in group_ops[g]:
                if op == "SYNC":
                    with trace_lib.span("pipe.sync", group=g, micro=m):
                        sync(g)
                    continue
                nd = nodes[k]
                if op == "F":
                    with trace_lib.span("pipe.wait", group=g, node=k,
                                        micro=m, op="F"):
                        h = take(carry, (k, m))
                    with trace_lib.span("pipe.F", group=g, node=k, micro=m):
                        if nd.is_loss:  # the fwd probe: the loss alone
                            sk = ([stash[(nd.partner, m)]]
                                  if nd.kind == "uploss" else [])
                            losses[m] = micro_loss(forward(
                                nd, pg, h, *sk, *loss_extra(m)))
                            continue
                        if nd.kind == "up":
                            sk = stash[(nd.partner, m)]
                            outs = forward(nd, pg, h, sk)
                            saved[(k, m)] = (h, sk)
                        else:
                            outs = forward(nd, pg, h)
                            saved[(k, m)] = (h,)
                        if nd.kind == "down":
                            stash[(k, m)] = [o[1] for o in outs]
                            outs = [o[0] for o in outs]
                        route(outs, k + 1, carry, m)
                elif op == "FB":
                    with trace_lib.span("pipe.wait", group=g, node=k,
                                        micro=m, op="FB"):
                        h = take(carry, (k, m))
                    with trace_lib.span("pipe.FB", group=g, node=k,
                                        micro=m):
                        if nd.kind == "uploss":
                            sk = stash[(nd.partner, m)]
                            outs, gp, (gh, gsk) = backward(
                                nd, pg, [h, sk, *loss_extra(m)],
                                [True, True, False], None)
                            gskips[(nd.partner, m)] = gsk
                        else:
                            outs, gp, (gh,) = backward(
                                nd, pg, [h, *loss_extra(m)],
                                [True, False, False, False], None)
                        losses[m] = micro_loss(outs)
                        bump(k, gp)
                        route(gh, k - 1, gcar, m)
                else:  # B
                    with trace_lib.span("pipe.wait", group=g, node=k,
                                        micro=m, op="B"):
                        gout = take(gcar, (k, m))
                    with trace_lib.span("pipe.B", group=g, node=k,
                                        micro=m):
                        if nd.kind == "down":
                            gsk = gskips.pop((k, m))
                            (h,) = saved.pop((k, m))
                            stash.pop((k, m))
                            gouts = [[go, *gs] for go, gs in zip(gout, gsk)]
                            _, gp, gins = backward(nd, pg, [h], [k > 0],
                                                   gouts)
                        elif nd.kind == "up":
                            h, sk = saved.pop((k, m))
                            _, gp, (gh, gsk) = backward(
                                nd, pg, [h, sk], [True, True],
                                [[go] for go in gout])
                            gskips[(nd.partner, m)] = gsk
                            gins = [gh]
                        else:
                            (h,) = saved.pop((k, m))
                            _, gp, gins = backward(nd, pg, [h], [k > 0],
                                                   [[go] for go in gout])
                        bump(k, gp)
                        if k > 0:
                            route(gins[0], k - 1, gcar, m)

        try:
            with futures.ThreadPoolExecutor(
                    max_workers=len(mine),
                    thread_name_prefix="pipe-dispatch") as pool:
                futs = [pool.submit(run_group, g) for g in mine]
                done, _ = futures.wait(futs,
                                       return_when=futures.FIRST_EXCEPTION)
                errs = [f.exception() for f in done
                        if f.exception() is not None]
                if errs:
                    # wake every peer (a blocked take raises, a blocked
                    # barrier breaks) before raising the first error
                    barrier.abort()
                    carry.fail(errs[0])
                    gcar.fail(errs[0])
                    futures.wait(futs)
                    raise errs[0]
                ends = [f.result() for f in futs]
        finally:
            if links is not None:
                links.shutdown()
        if courier is not None:
            courier.close()
        for g, ev in zip(mine, ends):  # the caller sees every group's work
            if ev is not None:
                caller[g].wait_event(ev)

        total = None
        if loss_group in mine:
            if world is not None:  # every shard's loss, a micro-batch each
                rows = spmd.all_shards(lmesh, [torch.stack(losses)])
                losses = [micro_loss([row[m] for row in rows])
                          for m in range(M)]
            total = losses[0]
            for v in losses[1:]:
                total = total + v
        merged: Dict[int, Params] = {}
        for g in (mine if stage in ("grad_comm", "step") else ()):
            merged[g] = {}
            for k, nd in enumerate(nodes):
                if nd.group == g:
                    merged[g].update(acc[k])
        fin: Dict[int, Any] = {}
        if guard and stage == "step":
            fin = {g: precision_lib.all_finite(merged[g]) for g in mine}
            if loss_group in mine:
                fin[loss_group] = torch.logical_and(
                    fin[loss_group], torch.isfinite(total))
        if world is not None:
            # the loss group's loss, each group's flag (and, in the bwd
            # probe, each node's sum) from each group's shard 0 to every
            # rank: the in-process step's values, on this rank's device
            here = meshes[world.group].home
            own = world.gather_objects({
                "loss": None if total is None else total.detach().cpu(),
                "finite": fin[world.group].cpu() if fin else None,
                "acc": {k: acc[k].cpu() for k, nd in enumerate(nodes)
                        if nd.group == world.group} if stage == "bwd"
                else {}})
            firsts = [own[h * world.d] for h in range(n_grp)]
            total = firsts[loss_group]["loss"].to(here)
            if fin:
                fin = {h: firsts[h]["finite"].to(here)
                       for h in range(n_grp)}
            if stage == "bwd":
                acc = [firsts[nodes[k].group]["acc"][k].to(here)
                       for k in range(K)]
            home = here
        else:
            home = meshes[loss_group].home
        if stage == "fwd":
            return total
        if stage == "bwd":
            return total, sum(a.to(home) for a in acc)
        if stage == "grad_comm":
            if world is not None:  # every group's, from its shard 0
                own = world.gather_objects({n: v.cpu() for n, v in
                                            merged[world.group].items()})
                return total, {n: v.to(home) for h in range(n_grp)
                               for n, v in own[h * world.d].items()}
            return total, {n: v for g in mine for n, v in merged[g].items()}
        with trace_lib.span("pipe.update"):
            flags_ = ({h: f.float() for h, f in fin.items()} if guard
                      else None)

            def agreed(g, dev):
                # group g's flag times every other group's
                f = flags_[g].to(dev)
                for j in range(n_grp):
                    if j != g:
                        f = f * flags_[j].to(dev)
                return f

            new_p: Params = {}
            new_opt: Dict[int, Any] = {}
            for g in mine:
                dev = meshes[g].home
                p2, s2 = optimizer.update(merged[g], opts[g], pgs[g])
                if guard:
                    ok = agreed(g, dev) > 0.5
                    p2 = guard_lib.tree_select(ok, p2, pgs[g])
                    s2 = guard_lib.tree_select(ok, s2, opts[g])
                new_p.update(p2)
                new_opt[g] = s2
            new_opt = tuple(new_opt.get(g) for g in range(n_grp))
        if guard:
            applied = agreed(0, meshes[0].home if 0 in mine else home)
            return new_p, new_opt, total, applied
        return new_p, new_opt, total

    return step


# ------------------------------------------------------ sequence models ---
def lm_value_and_grad(loss_fn: Callable, params: Any, batch: Any, cfg
                      ) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(loss_fn)(params, batch, cfg)``: (the loss,
    detached; the gradient tree, ``params``'s structure, zeros for a
    leaf the loss does not use). Each leaf is differentiated through a
    detached alias of it (no copy), so the caller's tensors record no
    graph; one ``torch.autograd.grad`` over every leaf."""
    alias = [t.detach().requires_grad_() for t in tree_lib.leaves(params)]
    loss = loss_fn(tree_lib.unflatten(params, alias), batch, cfg)
    grads = torch.autograd.grad(loss, alias, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_lib.unflatten(params, grads)


def mark_shard_params(params: Any, specs: Any) -> Any:
    """Inside ``spmd.run``: a shard's parameter tree with each leaf passed
    through ``psum_grad`` over the mesh axes its spec does not name (its
    gradient is then the sum over the shards that hold the same block;
    the axes it names come back summed through ``all_gather``'s adjoint
    where a model gathers the leaf, and need no sum where it uses its
    block), the leaves that share those axes in one node."""
    from repro_torch.core import sharding

    mesh = spmd.current_mesh()
    leaves = tree_lib.leaves(params)
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(sharding.flat_specs(params, specs)):
        named = sharding.named_axes(spec)
        axes = tuple(a for a in mesh.axis_names if a not in named)
        groups.setdefault(axes, []).append(i)
    out = list(leaves)
    for axes, idx in groups.items():
        if axes:
            for i, t in zip(idx, spmd.axis(axes).psum_grad(
                    [leaves[i] for i in idx])):
                out[i] = t
    return tree_lib.unflatten(params, out)


def lm_sharded_value_and_grad(loss_fn: Callable, params: Sequence[Any],
                              batches: Sequence[Any], cfg, policy,
                              specs: Any) -> Tuple[torch.Tensor, List[Any]]:
    """``lm_value_and_grad`` over ``policy``'s mesh: each shard's loss
    (``loss_fn(params[r], batches[r], cfg, policy, mesh)``, the global
    mean on every shard) in its thread, its leaves marked by
    ``mark_shard_params``, then ONE ``torch.autograd.grad`` over every
    shard's loss, each weighted 1 / (number of shards): every shard's
    loss is the same value, so without the weight every gradient would
    be that many times too large. Returns (shard 0's loss, detached; the
    shards' gradient trees, rank order)."""
    mesh = policy.mesh
    alias = [[t.detach().requires_grad_() for t in tree_lib.leaves(p)]
             for p in params]

    def shard(p, leaves, batch):
        marked = mark_shard_params(tree_lib.unflatten(p, leaves), specs)
        return loss_fn(marked, batch, cfg, policy, mesh)

    losses = spmd.run(mesh, shard, params, alias, batches)
    flat = [t for a in alias for t in a]
    grads = iter(torch.autograd.grad(
        losses, flat, [torch.full_like(l, 1.0 / mesh.size) for l in losses],
        allow_unused=True, materialize_grads=True))
    return losses[0].detach(), [
        tree_lib.unflatten(p, [next(grads) for _ in a])
        for p, a in zip(params, alias)]


def make_lm_train_step(loss_fn: Callable, cfg, mesh, policy,
                       optimizer) -> Callable:
    """The reference's train step for the transformer, SSM and hybrid
    models (``repro.train.train_step.make_lm_train_step``):
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    Unsharded (``mesh`` None and no policy over a mesh): the loss and
    gradients of ``loss_fn(params, batch, cfg)`` (``lm_value_and_grad``)
    and then ``optimizer.update``, which needs no graph. The update is
    functional: the parameters and state passed in stay as they were.

    Over ``policy``'s in-process mesh: ``params`` and ``opt_state`` are
    per-shard trees in rank order (``core/sharding.shard_tree`` by
    ``infer_param_specs`` of the model's shapes, the layout the models'
    dataflow reads: the reference's ``param_specs`` default, which the
    port always takes); ``batch`` is global, each shard taking its rows
    cut over the data axes and every position (the reference's
    ``batch_specs`` default; a plan that cuts the sequence cuts it in
    the model). The gradients
    (``lm_sharded_value_and_grad``) and then, in each shard's thread,
    ``optimizer.update`` with each leaf's axes (``leaf_axes``), so the
    clip norm sums each leaf's squares over the axes that cut it
    only. A ``ProcessMesh`` raises (a later slice)."""
    from repro_torch.core import sharding
    from repro_torch.core.param_specs import infer_param_specs
    from repro_torch.models import lm_module

    if not sharding.sharded_policy(policy, mesh):
        if mesh is not None:
            raise ValueError(
                "a sharded LM train step needs a ShardingPolicy over the "
                "mesh (policy.mesh); call with mesh=None for the unsharded "
                "step")

        def step(params, opt_state, batch):
            loss, grads = lm_value_and_grad(loss_fn, params, batch, cfg)
            with torch.no_grad():
                new_params, new_opt = optimizer.update(grads, opt_state,
                                                       params)
            return new_params, new_opt, loss

        return step

    mesh = policy.mesh
    shapes = lm_module(cfg).param_shapes(cfg)
    specs = infer_param_specs(shapes, policy)
    leaf_axes = [sharding.named_axes(s)
                 for s in sharding.flat_specs(shapes, specs)]

    def update(grads, state, params):
        with torch.no_grad():
            return optimizer.update(grads, state, params,
                                    leaf_axes=leaf_axes)

    def step(params, opt_state, batch):
        cut = {n: sharding.shard_rows(v, policy) for n, v in batch.items()}
        batches = [{n: v[r] for n, v in cut.items()}
                   for r in range(mesh.size)]
        loss, grads = lm_sharded_value_and_grad(
            loss_fn, params, batches, cfg, policy, specs)
        outs = spmd.run(mesh, update, grads, opt_state, params)
        return [p for p, _ in outs], [s for _, s in outs], loss

    return step


__all__ = ["Block", "RankBatch", "STAGES", "batch_slice", "block_index",
           "convnet_grad_plan",
           "data_degree", "data_shards", "flat_plan", "gather_blocks",
           "gather_rows", "make_convnet_forward_step",
           "make_convnet_opt_state", "make_convnet_train_step",
           "make_convnet_phase_probes", "make_convnet_eval_step",
           "lm_sharded_value_and_grad", "lm_value_and_grad", "local_groups",
           "make_lm_train_step", "mark_shard_params",
           "make_pipeline_opt_state",
           "make_pipeline_train_step", "micro_rows", "pipeline_group_names",
           "pipeline_group_params", "pipeline_loss_group", "replicate",
           "sample_ids",
           "split_batch", "split_input", "split_targets"]
