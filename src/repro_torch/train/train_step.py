"""Step builders (the reference's ``train/train_step.py``): the
conv-net train step, its phase probes, the eval step and the
plan-sharded serving forward.

The serving forward splits each input batch along the entry stage's
partitioned dims into the mesh's shards, each made contiguous on its
shard's device, runs ``models/cosmoflow.forward`` once per shard through
``core.spmd.run``, and returns shard 0's predictions: the FC stage of a
plan with data degree 1 is replicated, so every shard holds them.

The train step (``make_convnet_train_step``) runs on a one-device mesh
so far (data, spatial and pipeline degrees 1; more comes with the
spatial/data-parallel slice): the loss through ``mse_loss`` with
dropout, ``torch.autograd.grad`` of it (fp16: of the loss times the
running loss scale) with respect to the fp32 masters, then the
optimizer's update. With one device every gradient reduction mode is the
identity. Stages nest as the reference's probes do: ``fwd`` returns the
loss, ``bwd`` adds the backward, ``step`` the update.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import spmd
from repro_torch.models import cosmoflow as cosmoflow_lib
from repro_torch.train import guard as guard_lib

GRAD_COMM_MODES = ("monolithic", "overlap", "reduce_scatter")

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


def split_input(x: torch.Tensor, mesh, stage: plan_lib.Stage
                ) -> List[torch.Tensor]:
    """Shard r's block of ``x`` (N, D, H, W, C): each dim ``stage``
    partitions cut into the mesh degree of its axis and the piece at r's
    coordinate, contiguous on r's device."""
    out = []
    for r, device in enumerate(mesh.devices):
        t, at = x, mesh.coords(r)
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


def make_convnet_forward_step(
    cfg: ConvNetConfig,
    mesh,
    *,
    plan: plan_lib.ParallelPlan,
    overlap: Optional[bool] = None,
    precision=None,
) -> Callable[[Sequence[Params], torch.Tensor], torch.Tensor]:
    """Returns ``fwd(params_per_shard, x) -> (N, out_dim)`` predictions
    on shard 0's device. ``params_per_shard``: one dict per shard on its
    device (``replicate``); ``x``: the whole batch, on any device."""
    if cfg.arch != "cosmoflow":
        raise NotImplementedError(
            f"{cfg.arch} comes with the U-Net slice of the port")
    if plan.data_degree != 1:
        raise NotImplementedError(
            f"plan {plan.name!r} has data degree {plan.data_degree}; "
            "batch sharding comes with the data-parallel slice of the port")
    head = plan.stage_for(cosmoflow_lib.num_blocks(cfg))
    if head.part.active:
        raise NotImplementedError(
            f"plan {plan.name!r} partitions the FC head; the port serves "
            "plans whose FC stage is replicated")
    entry = plan.stages[0]

    def body(params: Params, x: torch.Tensor) -> torch.Tensor:
        return cosmoflow_lib.forward(params, x, cfg, plan=plan,
                                     overlap=overlap, precision=precision)

    def fwd(params_per_shard: Sequence[Params],
            x: torch.Tensor) -> torch.Tensor:
        return spmd.run(mesh, body, params_per_shard,
                        split_input(x, mesh, entry))[0]

    return fwd


def _resolve_grad_comm(grad_comm: Optional[str]) -> str:
    mode = "overlap" if grad_comm in (None, "auto") else grad_comm
    if mode not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm={mode!r}; expected one of "
                         f"{GRAD_COMM_MODES}")
    if mode == "reduce_scatter":
        raise NotImplementedError(
            "grad_comm='reduce_scatter' (ZeRO-1) comes with the gradient "
            "reduction slice of the port")
    return mode


def _check_one_device(cfg: ConvNetConfig, mesh, plan) -> None:
    if cfg.arch != "cosmoflow":
        raise NotImplementedError(
            f"{cfg.arch} comes with the U-Net slice of the port")
    if plan.device_count != 1 or mesh.size != 1:
        raise NotImplementedError(
            f"plan {plan.name!r} spans {plan.device_count} devices; "
            "training over several comes with the spatial/data-parallel "
            "slice of the port")


def make_convnet_opt_state(cfg: ConvNetConfig, optimizer, params, *,
                           grad_comm: Optional[str] = None,
                           plan: Optional[plan_lib.ParallelPlan] = None,
                           precision=None):
    """Optimizer state matching ``make_convnet_train_step``: the
    optimizer wrapped for the policy (fp16 carries the loss-scale
    machine; fp32/bf16 are unwrapped), initialized on ``params``'
    device. ``precision`` defaults to the plan's."""
    _resolve_grad_comm(grad_comm)
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
    """The train step and its phase probes. ``stage``: ``fwd`` (the
    loss), ``bwd`` (loss, and the sum of every gradient: the backward
    without the update) or ``step`` (the update).

    ``precision`` (default: the plan's) casts the masters at each use in
    the model; fp16 scales the loss by the running scale before the
    backward and hands the scale to the optimizer, which unscales before
    clipping and skips non-finite steps. ``guard`` adds the non-finite
    step guard for every precision and a fourth output, 1.0 if the
    update applied and 0.0 if not."""
    _resolve_grad_comm(grad_comm)
    _check_one_device(cfg, mesh, plan)
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    optimizer = precision_lib.wrap_optimizer(optimizer, policy)
    axes = plan.axis_names

    def local_step(params, opt_state, x, y, seed):
        sample_ids = range(x.shape[0])  # one device: the global ids

        def loss_fn(p):
            return cosmoflow_lib.mse_loss(
                p, x, y, cfg, plan=plan, bn_axes=axes,
                global_batch=global_batch, train=True, dropout_seed=seed,
                sample_ids=sample_ids, mask_source=mask_source,
                overlap=overlap, precision=policy)

        if stage == "fwd":
            with torch.no_grad():
                loss = loss_fn(params)
            return loss
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves)
            if policy.uses_scaling:
                # fp16: the loss times the running scale, so that small
                # cotangents survive; unscaled again for reporting
                scale = precision_lib.current_scale(opt_state, policy).to(
                    loss.device)
                loss = loss * scale
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        loss = loss.detach()
        if policy.uses_scaling:
            loss = loss / scale
        if stage == "bwd":
            return loss, sum(g.sum() for g in grads.values())
        applied = None
        if guard:
            applied = guard_lib.agreed_finite(loss, grads)
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
        return spmd.run(mesh, local_step, [params], [opt_state], [x], [y],
                        [int(seed)])[0]

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
    the step returns new ones. ``seed`` (the step count) seeds the
    dropout masks."""
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
    """The ``fwd``, ``bwd`` and ``step`` probes, each with the step's
    signature; successive differences of their times attribute a step
    to forward, backward and optimizer."""
    return {stage: _build_convnet_step(
        cfg, mesh, optimizer, global_batch=global_batch, overlap=overlap,
        grad_comm=grad_comm, stage=stage, plan=plan, precision=precision,
        mask_source=mask_source) for stage in ("fwd", "bwd", "step")}


def make_convnet_eval_step(cfg: ConvNetConfig, mesh, *, global_batch: int,
                           plan: plan_lib.ParallelPlan,
                           overlap: Optional[bool] = None, precision=None
                           ) -> Callable[[Params, torch.Tensor,
                                          torch.Tensor], Tuple[Any, Any]]:
    """Returns ``eval(params, x, y) -> (loss, preds)``: the forward
    without dropout and the fp32 MSE over ``global_batch`` samples, with
    no gradients recorded."""
    _check_one_device(cfg, mesh, plan)

    def local_eval(params, x, y):
        with torch.no_grad():
            pred = cosmoflow_lib.forward(params, x, cfg, plan=plan,
                                         overlap=overlap,
                                         precision=precision)
            return cosmoflow_lib.mse(pred, y, global_batch), pred

    def fn(params, x, y):
        return spmd.run(mesh, local_eval, [params], [x], [y])[0]

    return fn


__all__ = ["make_convnet_forward_step", "make_convnet_opt_state",
           "make_convnet_train_step", "make_convnet_phase_probes",
           "make_convnet_eval_step", "replicate", "split_input"]
