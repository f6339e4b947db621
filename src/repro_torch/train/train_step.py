"""Step builders (the reference's ``train/train_step.py``): the
conv-net train step, its phase probes, the eval step and the
plan-sharded serving forward.

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
   same masters), so that its gradient is its own partial sum;
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

import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import grad_comm as grad_comm_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.models import cosmoflow as cosmoflow_lib
from repro_torch.models import for_config
from repro_torch.models import unet3d as unet_lib
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


def split_input(x: torch.Tensor, mesh, stage: plan_lib.Stage
                ) -> List[torch.Tensor]:
    """Shard r's block of ``x`` (N, D, H, W, C) (``block_index``),
    contiguous on r's device."""
    return [x[block_index(x.shape, mesh, r, stage)].to(device).contiguous()
            for r, device in enumerate(mesh.devices)]


def split_batch(y: torch.Tensor, mesh, stage: plan_lib.Stage
                ) -> List[torch.Tensor]:
    """Shard r's slice of ``y`` along the batch, on r's device."""
    return [_rows(y, *batch_slice(mesh, r, stage)).to(d).contiguous()
            for r, d in enumerate(mesh.devices)]


def split_targets(cfg: ConvNetConfig, y: torch.Tensor, mesh,
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
    order and each partitioned dim's pieces in axis order, on shard 0's
    device (a shard whose block another shard also holds — a replica —
    is read once)."""
    active = list(stage.part.active)
    blocks = {}
    for r, t in enumerate(outs):
        at = mesh.coords(r)
        key = (batch_slice(mesh, r, stage)[0],) + tuple(
            at[a] for _, a in active)
        blocks.setdefault(key, t)
    home = mesh.devices[0]

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
    the reference's, so that dropout masks do not depend on the mesh."""
    out = []
    for r in range(mesh.size):
        index, count = batch_slice(mesh, r, stage)
        n = batch // count
        out.append(range(index * n, (index + 1) * n))
    return out


def gather_rows(outs: Sequence[torch.Tensor], mesh,
                stage: plan_lib.Stage) -> torch.Tensor:
    """CosmoFlow's per-sample outputs of the shards, whose rows are
    ``stage``'s batch slices (the FC stage's), put together in batch
    order on shard 0's device, one holder of each slice read."""
    home = mesh.devices[0]
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


def _check_mesh(cfg: ConvNetConfig, mesh, plan) -> None:
    if cfg.arch not in ("cosmoflow", "unet3d"):
        raise NotImplementedError(f"no train step for arch {cfg.arch!r}")
    if plan.n_groups != 1:
        raise NotImplementedError(
            f"plan {plan.name!r} is pipelined; the pipeline axis comes "
            "with its slice of the port")
    if mesh.shape != dict(plan.mesh_axes):
        raise ValueError(f"plan {plan.name!r} has mesh {dict(plan.mesh_axes)}"
                         f", but the step runs on {mesh.shape}")
    if len(set(mesh.devices)) != 1:
        raise NotImplementedError(
            f"training puts every shard on one device; {mesh} spans "
            f"several: shards on several cards come with the cross-process "
            f"shard group")


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
    scale replicated."""
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
        for r in range(mesh.size)]


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
    _check_mesh(cfg, mesh, plan)
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
    n = mesh.size

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
            mesh.devices[0]) if policy.uses_scaling else None)
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
    on shard 0's device."""
    _check_mesh(cfg, mesh, plan)
    entry = plan.stages[0]
    axes = plan.axis_names
    n = mesh.size
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


__all__ = ["STAGES", "batch_slice", "block_index", "convnet_grad_plan",
           "data_degree", "data_shards", "gather_blocks", "gather_rows",
           "make_convnet_forward_step", "make_convnet_opt_state",
           "make_convnet_train_step", "make_convnet_phase_probes",
           "make_convnet_eval_step", "replicate", "sample_ids",
           "split_batch", "split_input", "split_targets"]
