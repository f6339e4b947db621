"""CosmoFlow network (paper Table I), inference forward, spatially
partitioned by a ``ParallelPlan``.

n = len(conv_channels) conv blocks, 3^3 SAME convs (stride 1 except
block 4, stride 2), batch-norm fused with leaky-ReLU (slope 0.01),
2x2x2 max pooling after the first log2(W)-2 blocks, no conv biases,
then the FC head 2048 -> 256 -> out_dim with leaky-ReLU between layers.
Activations are contiguous (N, D, H, W, C) tensors and conv weights
(k, k, k, Cin, Cout), the reference's layouts, so its parameters carry
over unchanged (``params_from_numpy``) and the FC flatten order
matches. Batch-norm uses the batch's statistics, as in the reference.
``forward`` is the per-shard body of the plan-sharded forward
(``core/spmd.py``); on one device it is the whole forward.

Training (dropout, the backward kernels) comes with the training slice;
``forward(train=True)`` raises until then.
"""
from __future__ import annotations

import math
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import dist_norm
from repro_torch.core import halo as halo_lib
from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.core.spatial_conv import (SpatialPartitioning, conv3d,
                                           maxpool3d, overlap_split)

Params = Dict[str, torch.Tensor]


def num_blocks(cfg: ConvNetConfig) -> int:
    """All variants keep the full conv stack (paper Table I)."""
    return len(cfg.conv_channels)


def num_pools(cfg: ConvNetConfig) -> int:
    """The first log2(W)-2 blocks are pooled (paper §IV)."""
    return min(int(math.log2(cfg.input_width)) - 2, num_blocks(cfg))


def param_shapes(cfg: ConvNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter, in ``init_params`` order."""
    n = num_blocks(cfg)
    k = cfg.kernel_size
    shapes: Dict[str, Tuple[int, ...]] = {}
    cin = cfg.in_channels
    for i, c in enumerate(cfg.conv_channels[:n]):
        shapes[f"conv{i}_w"] = (k, k, k, cin, c)
        if cfg.batchnorm:
            shapes[f"bn{i}_scale"] = (c,)
            shapes[f"bn{i}_bias"] = (c,)
        cin = c
    w = cfg.input_width
    for i in range(n):
        if i == 3:
            w //= 2  # stride-2 conv in block 4
        if i < num_pools(cfg):
            w //= 2
    flat = cin * w ** 3
    for j, dout in enumerate(list(cfg.fc_dims) + [cfg.out_dim]):
        shapes[f"fc{j}_w"] = (flat, dout)
        shapes[f"fc{j}_b"] = (dout,)
        flat = dout
    return shapes


def init_params(cfg: ConvNetConfig, generator: torch.Generator,
                device) -> Params:
    """fp32 masters: He-normal conv weights, unit BN scales, zero biases,
    and 1/sqrt(fan_in)-scaled FC weights — the reference's initialization
    law, drawn from ``generator`` (a CPU generator, so a seed gives the
    same weights on every device)."""
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_scale"):
            t = torch.ones(shape)
        elif name.endswith("_bias") or name.endswith("_b"):
            t = torch.zeros(shape)
        else:
            fan_in = math.prod(shape[:-1])
            gain = 2.0 if name.startswith("conv") else 1.0
            t = torch.randn(shape, generator=generator) * math.sqrt(
                gain / fan_in)
        params[name] = t.to(device)
    return params


def params_from_numpy(tree: Mapping[str, object], device,
                      dtype: Optional[torch.dtype] = None, *,
                      cfg: ConvNetConfig) -> Params:
    """The reference's parameters (``{name: np.asarray(leaf)}`` of
    ``repro.models.cosmoflow.init_params``, or arrays read from its
    checkpoints) as the port's: the layouts are identical, so this is a
    device and dtype move with name and shape checks against ``cfg``.
    ``dtype=None`` keeps each array's dtype."""
    want = param_shapes(cfg)
    if set(tree) != set(want):
        raise ValueError(
            f"parameter names differ from {cfg.name}'s: missing "
            f"{sorted(set(want) - set(tree))}, unexpected "
            f"{sorted(set(tree) - set(want))}")
    out: Params = {}
    for name, shape in want.items():
        v = tree[name]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))  # a copy: reference arrays are read-only
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape} for {cfg.name}")
        out[name] = t.to(device=device, dtype=dtype or t.dtype).contiguous()
    return out


def _default_plan(cfg: ConvNetConfig) -> plan_lib.ParallelPlan:
    return plan_lib.legacy_convnet_plan(cfg, SpatialPartitioning())


def forward(params: Params, x: torch.Tensor, cfg: ConvNetConfig, *,
            plan: Optional[plan_lib.ParallelPlan] = None,
            bn_axes: Optional[Sequence[str]] = None,
            overlap: Optional[bool] = None,
            precision=None, train: bool = False) -> torch.Tensor:
    """x: local shard (N, D_loc, H_loc, W_loc, Cin) -> (N, out_dim).

    The per-shard body of a plan-sharded forward: run it inside
    ``core.spmd.run`` over a mesh of the plan's degrees
    (``train.train_step.make_convnet_forward_step`` does), or directly
    for a plan that spans one device. Each stage runs its layout; a stage
    boundary reshards (``core/reshard.py``). ``bn_axes`` (default: every
    axis of the plan) are the mesh axes the batch-norm statistics are
    summed over; ``overlap`` picks the conv lowering (None:
    ``core/flags.OVERLAP_HALO``). ``precision`` (or the plan's recorded policy)
    casts the input and, at each use, the parameters to the policy's
    compute dtype; a tree already cast once at load makes those casts
    the identity."""
    if train:
        raise NotImplementedError(
            "the training forward (dropout) comes with the training slice "
            "of the port")
    plan = plan if plan is not None else _default_plan(cfg)
    spmd.check_mesh(plan.mesh_axes,
                    f"plan {plan.name!r} ({plan.device_count} devices)")
    bn_axes = plan.axis_names if bn_axes is None else tuple(bn_axes)
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    cdt = policy.compute_dtype
    cst = (lambda t: t.to(cdt)) if policy.casts_params else (lambda t: t)
    h = x
    if policy.casts_params and h.is_floating_point():
        h = h.to(cdt)
    h = h.contiguous()
    n = num_blocks(cfg)
    npool = num_pools(cfg)
    cur = plan.stage_for(0)
    for i in range(n):
        st = plan.stage_for(i)
        if st != cur:
            h = reshard.apply(h, cur, st)
            cur = st
        h = conv3d(h, cst(params[f"conv{i}_w"]), cur.part,
                   stride=2 if i == 3 else 1, overlap=overlap)
        if cfg.batchnorm:
            h = dist_norm.distributed_batchnorm(
                h, cst(params[f"bn{i}_scale"]), cst(params[f"bn{i}_bias"]),
                bn_axes, activation_slope=0.01)
        else:
            h = F.leaky_relu(h, negative_slope=0.01)
        if i < npool:
            h = maxpool3d(h, cur.part, window=2, stride=2)
    # CNN -> FC stage boundary: the legacy plan gathers, and the FC head
    # runs replicated on every shard
    fc_stage = plan.stage_for(n)
    if fc_stage != cur:
        h = reshard.apply(h, cur, fc_stage)
    h = h.reshape(h.shape[0], -1)
    n_fc = len(cfg.fc_dims) + 1
    for j in range(n_fc):
        h = torch.matmul(h, cst(params[f"fc{j}_w"])) + cst(params[f"fc{j}_b"])
        if j < n_fc - 1:
            h = F.leaky_relu(h, negative_slope=0.01)
    return h


class SplitConv(NamedTuple):
    """One conv block whose depth a plan splits over several shards."""

    block: int
    shape: Tuple[int, ...]   # each shard's input (N, D_loc, H, W, Cin)
    lo: int                  # halo rows from the previous shard
    hi: int                  # halo rows from the next shard
    n_lo: int                # outputs that need the lo slab
    n_hi: int                # outputs that need the hi slab
    no_interior: bool        # the overlapped conv stitches (unpack)


def split_convs(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan,
                batch: int) -> List[SplitConv]:
    """Every conv block whose depth ``plan`` splits over more than one
    shard, with the shard-local shape the pack kernel reads (each shard
    alike) and whether the overlapped conv falls back to the unpack
    kernel there. Only depth may be split."""
    out = []
    for i, layer in enumerate(perf_model.cosmoflow_layers(cfg)):
        part = plan.stage_for(i).part
        split = [(d, a) for d, a in part.active if plan.degree(a) > 1]
        if any(d != 0 for d, _ in split):
            raise NotImplementedError("split_convs of H/W partitions")
        lo, hi = halo_lib.conv_halo_widths(layer.kernel, layer.stride)
        if not split or lo == hi == 0:
            continue
        local = layer.width // plan.degree(split[0][1])
        n_out, n_lo, n_hi = overlap_split(local, layer.kernel, layer.stride)
        out.append(SplitConv(
            i, (batch, local, layer.width, layer.width, layer.cin), lo, hi,
            n_lo, n_hi, n_lo + n_hi >= n_out))
    return out


def kernel_launches(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan
                    ) -> Dict[str, int]:
    """Launches of each kernel in one forward over every shard of
    ``plan``'s mesh, with the overlapped conv (the default lowering),
    derived from the plan's stages and the blocks' widths: per shard and
    block one bn_act and one conv, except that the overlapped conv of a
    depth-split block launches one pack and
    then either the interior conv plus one conv per boundary piece, or
    (no interior) one unpack and one conv. Every shard runs every block
    (a gathered stage runs replicated)."""
    shards = plan.device_count
    n = num_blocks(cfg)
    out = {"conv3d": shards * n, "bn_act": shards * n if cfg.batchnorm
           else 0, "pack": 0, "unpack": 0}
    for sc in split_convs(cfg, plan, 1):
        out["pack"] += shards
        if sc.no_interior:
            out["unpack"] += shards
        else:
            out["conv3d"] += shards * ((sc.n_lo > 0) + (sc.n_hi > 0))
    return out


def mse_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: ConvNetConfig, *,
             plan: Optional[plan_lib.ParallelPlan] = None,
             precision=None, global_batch: int = 0) -> torch.Tensor:
    """Mean over samples of the per-sample mean squared error, in fp32
    whatever the compute precision (the reference's ``mse_loss`` with
    one device and no dropout)."""
    pred = forward(params, x, cfg, plan=plan, precision=precision)
    return mse(pred, y, global_batch or x.shape[0])


def mse(pred: torch.Tensor, y: torch.Tensor,
        global_batch: int) -> torch.Tensor:
    """Sum over samples of the per-sample mean squared error, divided by
    ``global_batch``, in fp32."""
    per_sample = torch.mean(torch.square(pred.float() - y.float()), dim=-1)
    return torch.sum(per_sample) / global_batch


def conv_shapes(cfg: ConvNetConfig, batch: int):
    """``(input shape, weight shape, stride, pads)`` of every conv of one
    forward at ``batch`` — the shapes the conv kernel sees on the main
    path (pads are the SAME padding the kernel applies)."""
    out = []
    w = cfg.input_width
    shapes = param_shapes(cfg)
    for i in range(num_blocks(cfg)):
        ws = shapes[f"conv{i}_w"]
        stride = 2 if i == 3 else 1
        lo, hi = halo_lib.conv_halo_widths(ws[0], stride)
        out.append(((batch, w, w, w, ws[3]), ws, stride, ((lo, hi),) * 3))
        w = w // stride // (2 if i < num_pools(cfg) else 1)
    return out
