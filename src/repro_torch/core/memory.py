"""The per-device memory model (the reference's ``core/memory.py``) and
the CUDA allocator's measured peak beside it.

* **Model** — ``plan_peak_bytes`` walks a ``ParallelPlan`` layer by
  layer and predicts the peak bytes a device holds in one training step:
  every saved-for-backward residual under its stage's batch and spatial
  sharding, the backward's working set, the fp32 masters and the
  policy's compute copy, the gradients and the optimizer state (ZeRO-1
  divides it by the data degree, ``perf_model.opt_state_bytes``). A
  ``remat`` stage keeps only each block's input and rebuilds the rest
  inside its backward (``workspace``). ``infer_peak_bytes`` does the
  same for a forward-only serving call, ``data_parallel_peak_bytes``
  for pure data parallelism. The coefficients and the integer
  arithmetic are the reference's, fitted there to XLA's liveness on the
  TPU program; they are kept as they are, so that the port gives the
  reference's numbers, not the CUDA allocator's.
* **Measurement** — ``measured_peak_bytes(fn, *args)`` runs ``fn`` on a
  card and returns the caching allocator's peak, allocated and reserved
  apart. (The reference's counterpart scans a jaxpr's liveness; the
  port has no such program, so it measures.)

The layer walk is ``perf_model``'s (``cosmoflow_layers``,
``unet_layers``), the one the plans are built from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import perf_model
from repro_torch.core import precision as precision_lib

# The reference's structural coefficients: the float residuals a conv
# block keeps per output-sized tensor beyond its input (the conv output
# for the BN backward, the activation output for the next backward),
# and the output-sized copies alive while one block's forward and
# backward are in flight.
_SAVED_PER_BLOCK = 2.0
_WORKING_SET_COPIES = 4.25


@dataclasses.dataclass(frozen=True)
class MemoryBreakdown:
    """Predicted peak bytes per device, by source. ``activations`` is the
    resident saved-for-backward sum, ``workspace`` the transient
    maximum (the backward's working set, a remat recompute)."""

    params: int
    param_copy: int      # the compute copy of a casting policy (0 in fp32)
    grads: int
    opt_state: int
    activations: int
    workspace: int

    @property
    def total(self) -> int:
        """Activations and gradients do not peak together (the gradient
        tree is whole only once the residuals are freed), so they meet
        under a max; masters, the copy and the optimizer state stay
        resident throughout."""
        return (self.params + self.param_copy + self.opt_state
                + max(self.activations + self.workspace, self.grads))

    @property
    def gib(self) -> float:
        return self.total / 2 ** 30

    def describe(self) -> str:
        g = 2.0 ** 30
        return (f"total={self.total / g:.3f}GiB "
                f"(act={self.activations / g:.3f}"
                f" ws={self.workspace / g:.3f} params={self.params / g:.3f}"
                f" copy={self.param_copy / g:.3f} grads={self.grads / g:.3f}"
                f" opt={self.opt_state / g:.3f})")


def _plan_entries(cfg: ConvNetConfig, plan) -> List[Tuple[Any, Any]]:
    """(ConvLayer or None, Stage) per priced entry: CosmoFlow's conv
    blocks and then its FC head (None); the U-Net's encoder, bottleneck
    and decoder convs, each up-convolution charged to the deeper level's
    stage and never rematerialized (the models keep it outside the
    checkpointed pairs)."""
    if cfg.arch == "cosmoflow":
        layers = perf_model.cosmoflow_layers(cfg)
        out = [(l, plan.stage_for(i)) for i, l in enumerate(layers)]
        out.append((None, plan.stage_for(len(layers))))
        return out
    layers = perf_model.unet_layers(cfg)

    def no_remat(st):
        return dataclasses.replace(st, remat=False) if st.remat else st

    stages = []
    for lvl in range(cfg.depth):            # encoder: 2 convs a level
        stages += [plan.stage_for(lvl)] * 2
    stages += [plan.stage_for(cfg.depth)] * 2   # bottleneck
    for lvl in reversed(range(cfg.depth)):  # decoder: deconv + 2 convs
        stages += [no_remat(plan.stage_for(lvl + 1))] \
            + [plan.stage_for(lvl)] * 2
    return list(zip(layers, stages))


def _stage_divisors(plan, st) -> Tuple[int, int]:
    """(spatial divisor of the voxel volume, batch divisor) of ``st``."""
    vox = 1
    for a in st.spatial_names:
        vox *= plan.degree(a)
    batch = 1
    for a in st.batch_axes:
        batch *= plan.degree(a)
    return vox, batch


def _fc_width(cfg: ConvNetConfig) -> int:
    """Elements a sample of CosmoFlow's FC head holds: the flattened
    features and the small FC intermediates."""
    last = perf_model.cosmoflow_layers(cfg)[-1]
    w_out = last.width // last.stride // (2 if last.pooled else 1)
    return w_out ** 3 * last.cout + 2 * sum(cfg.fc_dims)


def _policy(precision, plan) -> precision_lib.PrecisionPolicy:
    return precision_lib.get(precision if precision is not None
                             else getattr(plan, "precision", "fp32"))


def plan_peak_bytes(
    cfg: ConvNetConfig,
    plan,
    *,
    global_batch: int,
    grad_comm: str = "overlap",
    precision: Union[str, precision_lib.PrecisionPolicy, None] = None,
    group: Optional[int] = None,
) -> MemoryBreakdown:
    """Predicted peak bytes per device of one training step under
    ``plan``: each conv block's input plus ``_SAVED_PER_BLOCK``
    output-sized residuals, under its stage's sharding, resident at once
    (a ``remat`` stage: the input only, the rest transient), plus
    ``_WORKING_SET_COPIES`` of the in-flight block's output; activations
    in the compute dtype (``precision``, default the plan's), masters,
    gradients and optimizer state in fp32, and a parameter-sized compute
    copy for a casting policy. A pipelined plan: ``_pipeline_peak_bytes``
    (``group``: that group's, else the largest)."""
    pol = _policy(precision, plan)
    act_bytes = pol.act_bytes
    if getattr(plan, "pipeline", None) is not None and plan.n_groups > 1:
        return _pipeline_peak_bytes(cfg, plan, pol,
                                    global_batch=global_batch,
                                    grad_comm=grad_comm, group=group)

    resident = 0.0   # saved-for-backward residuals
    transient = 0.0  # the largest recompute / backward working set
    for l, st in _plan_entries(cfg, plan):
        vox_div, batch_div = _stage_divisors(plan, st)
        b_local = global_batch / max(batch_div, 1)
        if l is None:
            resident += _fc_width(cfg) * b_local * act_bytes
            continue
        n_in = l.width ** 3 / vox_div
        n_out = (l.width // l.stride) ** 3 / vox_div
        saved_in = n_in * l.cin * b_local * act_bytes
        internals = _SAVED_PER_BLOCK * n_out * l.cout * b_local * act_bytes
        working = _WORKING_SET_COPIES * n_out * l.cout * b_local * act_bytes
        resident += saved_in
        if getattr(st, "remat", False):
            transient = max(transient, working + internals)
        else:
            resident += internals
            transient = max(transient, working)

    n_params = cfg.param_count()
    params = n_params * 4                       # fp32 masters
    param_copy = n_params * act_bytes if pol.casts_params else 0
    grads = n_params * 4                        # fp32 through the casts
    _, entry_batch = _stage_divisors(plan, plan.stages[0])
    opt = int(perf_model.opt_state_bytes(
        n_params, grad_comm=grad_comm, data_degree=entry_batch))
    return MemoryBreakdown(
        params=int(params), param_copy=int(param_copy), grads=int(grads),
        opt_state=opt, activations=int(resident), workspace=int(transient))


def _pipeline_peak_bytes(cfg: ConvNetConfig, plan,
                         pol: precision_lib.PrecisionPolicy, *,
                         global_batch: int, grad_comm: str,
                         group: Optional[int] = None) -> MemoryBreakdown:
    """The peak of a pipelined plan: the largest over its groups (or
    group ``group``'s: a process of that group's), each
    charged its own layers and its parameters' share of the step state
    (``perf_model.group_param_counts``). A node's backward recomputes its
    segment from the node's saved input, so per micro-batch in flight a
    group holds its entry activation (and the U-Net's down groups their
    skips until the ascent, under the reference's ``arch == "unet"``
    test, kept); 1F1B keeps ``min(P - g, M)`` micro-batches in flight on
    group g, the sequential oracle one. The segment's residuals at one
    micro-batch and one block's working set are the recompute's
    workspace."""
    act_bytes = pol.act_bytes
    m = max(plan.pipeline.micro_batches, 1)
    n_grp = plan.n_groups
    sched = plan.pipeline.schedule
    entries = _plan_entries(cfg, plan)
    depth = cfg.depth if cfg.arch == "unet" else 0
    per_group: List[List[Tuple[int, Any, Any]]] = [[] for _ in range(n_grp)]
    for idx, (l, st) in enumerate(entries):
        per_group[plan.stages.index(st)].append((idx, l, st))

    group_params = perf_model.group_param_counts(
        cfg, plan.group_layer_ranges())
    best = None
    for g, sub in enumerate(per_group):
        if not sub:
            continue
        vox_div, batch_div = _stage_divisors(plan, sub[0][2])
        b_micro = global_batch / m / max(batch_div, 1)
        win = 1 if sched == "sequential" else min(n_grp - g, m)
        resident = 0.0
        transient = 0.0   # the segment's residuals, rebuilt by the recompute
        work_max = 0.0    # one block's backward working set
        entry_l = sub[0][1]
        if entry_l is None:  # the group holds only the FC head
            last = perf_model.cosmoflow_layers(cfg)[-1]
            w_out = last.width // last.stride // (2 if last.pooled else 1)
            resident += w_out ** 3 * last.cout * b_micro * act_bytes * win
        else:
            resident += (entry_l.width ** 3 / vox_div * entry_l.cin
                         * b_micro * act_bytes * win)
        for idx, l, st in sub:
            if l is None:
                transient += _fc_width(cfg) * b_micro * act_bytes
                continue
            n_in = l.width ** 3 / vox_div
            n_out = (l.width // l.stride) ** 3 / vox_div
            transient += (n_in * l.cin + _SAVED_PER_BLOCK * n_out
                          * l.cout) * b_micro * act_bytes
            work_max = max(work_max, _WORKING_SET_COPIES * n_out
                           * l.cout * b_micro * act_bytes)
            if cfg.arch == "unet" and idx < 2 * depth and idx % 2 == 1:
                resident += n_out * l.cout * b_micro * act_bytes * win
        n_params = group_params[g]
        cand = MemoryBreakdown(
            params=int(n_params * 4),
            param_copy=int(n_params * act_bytes if pol.casts_params else 0),
            grads=int(n_params * 4),
            opt_state=int(perf_model.opt_state_bytes(
                int(n_params), grad_comm=grad_comm,
                data_degree=max(batch_div, 1))),
            activations=int(resident), workspace=int(transient + work_max))
        if g == group:
            return cand
        if best is None or cand.total > best.total:
            best = cand
    return best


def infer_peak_bytes(
    cfg: ConvNetConfig,
    plan,
    *,
    global_batch: int,
    precision: Union[str, precision_lib.PrecisionPolicy, None] = None,
) -> MemoryBreakdown:
    """Predicted peak bytes per device of one forward-only call: nothing
    is saved for a backward, so the peak is the largest block's input
    and ``_SAVED_PER_BLOCK`` outputs under its stage's sharding, plus
    the parameters in the serving dtype (cast once at load); no
    gradients, no optimizer state. The U-Net's encoder skips would be
    resident, but the reference counts them under ``cfg.arch == "unet"``
    (src/repro/core/memory.py:343,358; its pipelined model too, :253,
    :295, and ``_pipeline_peak_bytes`` here) while the U-Net's configs
    say ``"unet3d"``: the test is kept as it is, so that the port gives
    the reference's bytes."""
    pol = _policy(precision, plan)
    act_bytes = pol.act_bytes
    resident = 0.0   # encoder skips parked across the descent
    working = 0.0    # the largest block in flight
    depth = cfg.depth if cfg.arch == "unet" else 0
    for idx, (l, st) in enumerate(_plan_entries(cfg, plan)):
        vox_div, batch_div = _stage_divisors(plan, st)
        b_local = global_batch / max(batch_div, 1)
        if l is None:
            working = max(working, _fc_width(cfg) * b_local * act_bytes)
            continue
        n_in = l.width ** 3 / vox_div
        n_out = (l.width // l.stride) ** 3 / vox_div
        block = (n_in * l.cin + _SAVED_PER_BLOCK * n_out * l.cout) \
            * b_local * act_bytes
        working = max(working, block)
        if cfg.arch == "unet" and idx < 2 * depth and idx % 2 == 1:
            resident += n_out * l.cout * b_local * act_bytes
    n_params = cfg.param_count()
    params = n_params * (act_bytes if pol.casts_params else 4)
    return MemoryBreakdown(
        params=int(params), param_copy=0, grads=0, opt_state=0,
        activations=int(resident), workspace=int(working))


def data_parallel_peak_bytes(
    cfg: ConvNetConfig,
    *,
    global_batch: int,
    num_gpus: int = 1,
    grad_comm: str = "overlap",
    precision: Union[str, None] = "fp32",
) -> MemoryBreakdown:
    """Peak bytes per device under pure data parallelism (the paper's
    baseline): spatial degree 1, the batch split ``num_gpus`` ways, no
    remat."""
    from repro_torch.core import plan as plan_lib  # plan imports perf_model

    plan = plan_lib.uniform_plan(
        cfg, spatial_axes=("model", None, None), spatial_degrees=(1, 1, 1),
        data_degrees=(num_gpus,))
    return plan_peak_bytes(cfg, plan, global_batch=global_batch,
                           grad_comm=grad_comm, precision=precision)


class MeasuredPeak(NamedTuple):
    """The caching allocator's peaks over one call, in bytes: tensors
    alive (``allocated``) and segments held from the driver
    (``reserved``, which also holds cached free blocks)."""

    allocated: int
    reserved: int


def measured_peak_bytes(fn: Callable, *args, device=None) -> MeasuredPeak:
    """Run ``fn(*args)`` on a card and return the allocator's peaks over
    it: the peak statistics are reset after a synchronize, and read after
    another. ``device`` defaults to the current CUDA device; anything
    other than a CUDA device raises (there is no peak to read)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        raise ValueError(f"measured_peak_bytes reads the CUDA caching "
                         f"allocator; {dev} has none")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    return MeasuredPeak(torch.cuda.max_memory_allocated(dev),
                        torch.cuda.max_memory_reserved(dev))


__all__ = ["MeasuredPeak", "MemoryBreakdown", "data_parallel_peak_bytes",
           "infer_peak_bytes", "measured_peak_bytes", "plan_peak_bytes"]
