"""Step builders (the reference's ``train/train_step.py``): the
conv-net train step, its phase probes, the eval step and the
plan-sharded serving forward.

The serving forward splits each input batch along the entry stage's
partitioned dims into the mesh's shards, each made contiguous on its
shard's device, and runs the model's forward (``models/cosmoflow`` or
``models/unet3d``, by ``cfg.arch``) once per shard through
``core.spmd.run``. CosmoFlow returns shard 0's predictions: the FC stage
of a plan with data degree 1 is replicated, so every shard holds them.
The U-Net returns per-voxel logits, each shard's block put back in
place on shard 0's device (``gather_blocks``).

The train step (``make_convnet_train_step``) runs the reference's
hybrid step over a data x spatial mesh whose shards all lie on one
device (``["cuda:0"] * n`` on a card, ``["cpu"] * n`` in the tests):

1. each shard, in its thread, takes its batch slice (the entry stage's
   batch axes) and depth slab of x and its batch slice of y (the U-Net's
   voxel labels: its batch slice and depth slab, like x), and computes
   the loss: CosmoFlow's ``mse_loss`` with dropout masks drawn for the
   GLOBAL sample ids (so they do not depend on the mesh) and divided by
   the plan's ``loss_redundancy``, or the U-Net's
   ``segmentation_loss`` over ``global_batch * W^3`` voxels; batch-norm
   statistics summed over every mesh axis; under ``overlap`` the
   parameters' reduction hooks go into its graph
   (``core/grad_comm.py``). Each shard has parameter leaves of its own
   (views of the same masters), so that its gradient is its own partial
   sum;
2. ONE backward over the shards' losses (fp16: each times the running
   loss scale), from the calling thread: each collective is one autograd
   node over every shard (``core/spmd.py``), so its adjoint is a data
   dependency of this backward and no backward node waits for a peer;
3. each shard, in its thread again: the global loss (a ``psum``), the
   ``monolithic`` reduction of every gradient (``overlap`` has reduced
   them inside the backward), the guard's verdict agreed over every
   shard, and the optimizer's update — the same on every shard, as
   every input to it is. Shard 0's results are returned.

With the reduced gradients the same on every shard, the fp16 skip
machine of ``MixedPrecision`` decides alike everywhere, and the one loss
scale is the optimizer state's. Stages nest as the reference's probes
do: ``fwd`` returns the loss, ``bwd`` adds the backward (no reduction:
the loss and the sum of every shard's gradients), ``grad_comm`` the
reduction (the loss and the reduced gradients), ``step`` the update.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import grad_comm as grad_comm_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import spmd
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


def split_input(x: torch.Tensor, mesh, stage: plan_lib.Stage
                ) -> List[torch.Tensor]:
    """Shard r's block of ``x`` (N, D, H, W, C): its slice of the batch
    (``batch_slice``), each dim ``stage`` partitions cut into the mesh
    degree of its axis and the piece at r's coordinate, contiguous on
    r's device."""
    out = []
    for r, device in enumerate(mesh.devices):
        t, at = _rows(x, *batch_slice(mesh, r, stage)), mesh.coords(r)
        for d, a in stage.part.active:
            k = mesh.degree(a)
            if t.shape[d + 1] % k:
                raise ValueError(
                    f"dim {d + 1} of the input ({t.shape[d + 1]}) does not "
                    f"divide over the {k}-way axis {a!r}")
            w = t.shape[d + 1] // k
            t = t.narrow(d + 1, at[a] * w, w)
        out.append(t.to(device).contiguous())
    return out


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


def sample_ids(batch: int, mesh, stage: plan_lib.Stage) -> List[range]:
    """Shard r's global sample ids: ``index * n_loc + arange(n_loc)``,
    the reference's, so that dropout masks do not depend on the mesh."""
    out = []
    for r in range(mesh.size):
        index, count = batch_slice(mesh, r, stage)
        n = batch // count
        out.append(range(index * n, (index + 1) * n))
    return out


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
    (``replicate``); ``x``: the whole batch, on any device."""
    if plan.data_degree != 1:
        raise NotImplementedError(
            f"plan {plan.name!r} has data degree {plan.data_degree}; "
            "batch-sharded serving comes with the plans slice of the port")
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
        return gather_blocks(outs, mesh, entry) if unet else outs[0]

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


def make_convnet_opt_state(cfg: ConvNetConfig, optimizer, params, *,
                           grad_comm: Optional[str] = None,
                           plan: Optional[plan_lib.ParallelPlan] = None,
                           precision=None):
    """Optimizer state matching ``make_convnet_train_step``: the
    optimizer wrapped for the policy (fp16 carries the loss-scale
    machine; fp32/bf16 are unwrapped), initialized on ``params``'
    device, the same for every shard. ``precision`` defaults to the
    plan's."""
    grad_comm_lib.resolve(grad_comm)
    if precision is None and plan is not None:
        precision = plan.precision
    return precision_lib.wrap_optimizer(optimizer, precision).init(params)


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
    hook_axes = axes if mode == "overlap" and stage in ("grad_comm",
                                                        "step") else ()
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
            return loss, grads
        applied = None
        if guard:
            applied = guard_lib.agreed_finite(loss, grads, axes)
            if policy.uses_scaling:
                grads = guard_lib.poison_unless(applied, grads)
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
        scale = (precision_lib.current_scale(opt_state, policy).to(
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
        return spmd.run(mesh, finish, grads, [opt_state] * n, [params] * n,
                        [v.detach() for v, _ in out])[0]

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
    ``make_convnet_opt_state`` with the same policy; neither is modified:
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
    the fp32 MSE over ``global_batch`` samples summed over every shard,
    and the predictions of every batch slice in order (from the first
    shard of each); the U-Net: the voxel cross-entropy over
    ``global_batch * W^3`` voxels (``segmentation_loss``'s operations)
    and the per-voxel logits put back together (``gather_blocks``). Both
    on shard 0's device."""
    _check_mesh(cfg, mesh, plan)
    entry = plan.stages[0]
    axes = plan.axis_names
    n = mesh.size
    unet = cfg.arch == "unet3d"
    firsts = sorted({batch_slice(mesh, r, entry)[0]: r
                     for r in reversed(range(n))}.items())

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
        preds = [out[r][1] for _, r in firsts]
        return out[0][0], preds[0] if len(preds) == 1 else torch.cat(preds)

    return fn


__all__ = ["STAGES", "batch_slice", "gather_blocks",
           "make_convnet_forward_step", "make_convnet_opt_state",
           "make_convnet_train_step", "make_convnet_phase_probes",
           "make_convnet_eval_step", "replicate", "sample_ids",
           "split_batch", "split_input", "split_targets"]
