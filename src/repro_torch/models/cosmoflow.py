"""CosmoFlow network (paper Table I), spatially partitioned by a
``ParallelPlan``.

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

``forward(train=True)`` applies dropout (keep 0.8) after each hidden FC
layer with one mask per (step seed, FC layer j, global sample id), so
that every shard computing a sample draws the same mask. The masks come
from a mask source (``MaskSource``): by default ``generator_masks``, an
explicit ``torch.Generator`` on the device seeded from (seed, j, sample
id). JAX's random bits cannot be reproduced here, so a caller that must
match the reference passes the reference's masks as the source.
"""
from __future__ import annotations

import functools
import math
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import dist_norm
from repro_torch.core import grad_comm
from repro_torch.core import halo as halo_lib
from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.core.spatial_conv import (SpatialPartitioning, conv3d,
                                           maxpool3d, overlap_split)

Params = Dict[str, torch.Tensor]
# (seed, FC layer j, global sample ids, width, device) -> bool (N, width)
MaskSource = Callable[[int, int, Sequence[int], int, torch.device],
                      torch.Tensor]
KEEP = 0.8  # dropout keep probability (paper §IV)


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
    return checked_tree(tree, param_shapes(cfg), device, dtype, cfg.name)


def checked_tree(tree: Mapping[str, object],
                 want: Mapping[str, Tuple[int, ...]], device,
                 dtype: Optional[torch.dtype], model: str) -> Params:
    """``tree``'s arrays or tensors as tensors on ``device`` (in ``dtype``,
    None: each its own), after checking that its names and shapes are
    ``want``'s, those of ``model``."""
    if set(tree) != set(want):
        raise ValueError(
            f"parameter names differ from {model}'s: missing "
            f"{sorted(set(want) - set(tree))}, unexpected "
            f"{sorted(set(tree) - set(want))}")
    out: Params = {}
    for name, shape in want.items():
        v = tree[name]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))  # a copy: reference arrays are read-only
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)} for {model}")
        out[name] = t.to(device=device, dtype=dtype or t.dtype).contiguous()
    return out


def opt_state_from_numpy(state: Any, device, *, cfg: ConvNetConfig,
                         convert=None):
    """The reference's optimizer state (its ``AdamState(step, m, v)``, or
    ``MPState(inner, loss_scale, good_steps)`` under fp16, with numpy or
    tensor leaves) as the port's: m and v through ``convert`` (default
    ``params_from_numpy``; the U-Net passes its own) in fp32, the
    counters as int32 and the loss scale as fp32 scalars on
    ``device``."""
    from repro_torch.core.precision import MPState
    from repro_torch.optim.adam import AdamState

    convert = convert or params_from_numpy

    def scalar(v, dtype):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return t.to(device=device, dtype=dtype).reshape(())

    if hasattr(state, "inner"):
        return MPState(opt_state_from_numpy(state.inner, device, cfg=cfg,
                                            convert=convert),
                       scalar(state.loss_scale, torch.float32),
                       scalar(state.good_steps, torch.int32))
    return AdamState(
        scalar(state.step, torch.int32),
        convert(state.m, device, torch.float32, cfg=cfg),
        None if state.v is None else convert(
            state.v, device, torch.float32, cfg=cfg))


def generator_masks(seed: int, layer: int, sample_ids: Sequence[int],
                    width: int, device) -> torch.Tensor:
    """The default mask source: row i keeps each unit with probability
    ``KEEP``, drawn by a ``torch.Generator`` on ``device`` seeded from
    (seed, layer, sample_ids[i]) alone."""
    rows = []
    for sid in sample_ids:
        g = torch.Generator(device=device)
        g.manual_seed(((int(seed) * 1_000_003 + int(layer)) * 1_000_003
                       + int(sid)) % (2 ** 63))
        rows.append(torch.rand(width, generator=g, device=device) < KEEP)
    return torch.stack(rows)


def _default_plan(cfg: ConvNetConfig) -> plan_lib.ParallelPlan:
    return plan_lib.legacy_convnet_plan(cfg, SpatialPartitioning())


def _block(h: torch.Tensor, w: torch.Tensor, *bn: torch.Tensor, part,
           stride: int, pool: bool, bn_axes: Sequence[str],
           overlap: Optional[bool]) -> torch.Tensor:
    """One conv block: the conv, batch-norm fused with leaky-ReLU (or the
    leaky-ReLU alone without ``bn``), then max pooling if ``pool``."""
    h = conv3d(h, w, part, stride=stride, overlap=overlap)
    if bn:
        h = dist_norm.distributed_batchnorm(h, bn[0], bn[1], bn_axes,
                                            activation_slope=0.01)
    else:
        h = F.leaky_relu(h, negative_slope=0.01)
    if pool:
        h = maxpool3d(h, part, window=2, stride=2)
    return h


def forward(params: Params, x: torch.Tensor, cfg: ConvNetConfig, *,
            plan: Optional[plan_lib.ParallelPlan] = None,
            bn_axes: Optional[Sequence[str]] = None,
            overlap: Optional[bool] = None,
            precision=None, train: bool = False,
            dropout_seed: Optional[int] = None,
            sample_ids: Optional[Sequence[int]] = None,
            mask_source: Optional[MaskSource] = None,
            grad_axes: Sequence[str] = (),
            reshard_oracle: bool = False) -> torch.Tensor:
    """x: local shard (N, D_loc, H_loc, W_loc, Cin) -> (N_fc, out_dim),
    N_fc the FC stage's local batch: N, or N / n after a batch move over
    an n-way axis.

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
    the identity.

    ``train=True`` with a ``dropout_seed`` applies dropout after each
    hidden FC layer: masks from ``mask_source`` (default
    ``generator_masks``) for the rows' global ``sample_ids`` (default
    0..N-1), kept units scaled by 1/``KEEP``. Gradients flow where the
    caller's tensors require them; ``grad_axes`` hooks the parameters'
    gradient reduction over those mesh axes into the backward
    (``core/grad_comm.GradMarker``: each master marked at its use, ahead
    of the compute-dtype cast, so that the sums run in fp32).

    Rematerialization: a conv block whose stage sets ``remat`` (every
    block under ``core/flags.REMAT`` when the plan marks no stage) runs
    through ``spmd.checkpoint``: only its input and its cast parameters
    are saved, and the backward recomputes it on every shard together.
    The parameters are marked and cast outside the checkpointed body."""
    plan = plan if plan is not None else _default_plan(cfg)
    spmd.check_mesh(plan.mesh_axes,
                    f"plan {plan.name!r} ({plan.device_count} devices)")
    bn_axes = plan.axis_names if bn_axes is None else tuple(bn_axes)
    policy = precision_lib.get(
        precision if precision is not None else plan.precision)
    cdt = policy.compute_dtype
    marker = grad_comm.GradMarker(grad_axes)
    params = marker.begin(params)
    cast = (lambda t: t.to(cdt)) if policy.casts_params else (lambda t: t)

    def cst(t):
        return cast(marker.mark(t))

    h = x
    if policy.casts_params and h.is_floating_point():
        h = h.to(cdt)
    h = h.contiguous()
    n = num_blocks(cfg)
    npool = num_pools(cfg)
    ids = sample_ids
    if ids is None and train and dropout_seed is not None:
        ids = range(h.shape[0])
    cur = plan.stage_for(0)
    for i in range(n):
        st = plan.stage_for(i)
        if st != cur:
            h, ids = reshard.apply(h, cur, st, sample_ids=ids,
                                   oracle=reshard_oracle)
            cur = st
        # marked and cast here, outside a checkpointed body, so that a
        # reduction hook fires once per leaf, not again in the recompute
        args = [cst(params[f"conv{i}_w"])]
        if cfg.batchnorm:
            args += [cst(params[f"bn{i}_scale"]), cst(params[f"bn{i}_bias"])]
        body = functools.partial(_block, part=cur.part,
                                 stride=2 if i == 3 else 1, pool=i < npool,
                                 bn_axes=bn_axes, overlap=overlap)
        if plan_lib.stage_remat(plan, st):
            h = spmd.checkpoint(body, h, *args)
        else:
            h = body(h, *args)
    # CNN -> FC stage boundary: a batch move (each sample's head on one
    # shard), or the legacy gather (the head replicated on every shard)
    fc_stage = plan.stage_for(n)
    if fc_stage != cur:
        h, ids = reshard.apply(h, cur, fc_stage, sample_ids=ids,
                               oracle=reshard_oracle)
    h = h.reshape(h.shape[0], -1)
    n_fc = len(cfg.fc_dims) + 1
    for j in range(n_fc):
        h = torch.matmul(h, cst(params[f"fc{j}_w"])) + cst(params[f"fc{j}_b"])
        if j < n_fc - 1:
            h = F.leaky_relu(h, negative_slope=0.01)
            if train and dropout_seed is not None:
                mask = (mask_source or generator_masks)(
                    dropout_seed, j, ids, h.shape[1], h.device)
                h = torch.where(mask.to(h.device), h / KEEP, 0.0)
    marker.assert_all_marked()
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


def kernel_launches(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan,
                    train: bool = False) -> Dict[str, int]:
    """Launches of each kernel over every shard of ``plan``'s mesh in one
    forward (``train=True``: one training step), with the overlapped
    conv (the default lowering), derived from the plan's stages and the
    blocks' widths. Per shard and block one bn_act and one conv, except
    that the overlapped conv of a depth-split block launches one pack and
    then either the interior conv plus one conv per boundary piece, or
    (no interior) one unpack and one conv. Every shard runs every block
    (a gathered stage runs replicated). A training step adds the
    backward's: the input gradient of each conv launch of every block
    but the first (whose input needs none) on the conv kernel
    (``conv3d_dgrad``), one pack for the adjoint of each such block's
    unpack, and each rematerialized block's forward launches once more
    (its recompute)."""
    n = num_blocks(cfg)
    return count_launches(
        n, split_convs(cfg, plan, 1), plan.device_count, cfg.batchnorm,
        train, [plan_lib.stage_remat(plan, plan.stage_for(i))
                for i in range(n)])


def count_launches(n: int, splits: Sequence[SplitConv], shards: int,
                   batchnorm: bool, train: bool,
                   remat: Sequence[bool] = ()) -> Dict[str, int]:
    """``kernel_launches`` of a model with ``n`` convs in forward order,
    of which ``splits`` are depth-split, over ``shards`` shards;
    ``remat[i]``: conv i's block is rematerialized."""
    convs, packs, unpacks = [1] * n, [0] * n, [0] * n
    for sc in splits:
        packs[sc.block] = 1
        if sc.no_interior:
            unpacks[sc.block] = 1
        else:
            convs[sc.block] += (sc.n_lo > 0) + (sc.n_hi > 0)
    out = {"conv3d": shards * sum(convs),
           "bn_act": shards * n if batchnorm else 0,
           "pack": shards * sum(packs), "unpack": shards * sum(unpacks)}
    if train:
        out["conv3d_dgrad"] = shards * sum(convs[1:])
        out["pack"] += shards * sum(unpacks[1:])
        again = [i for i, r in enumerate(remat) if r]
        out["conv3d"] += shards * sum(convs[i] for i in again)
        out["bn_act"] += shards * len(again) if batchnorm else 0
        out["pack"] += shards * sum(packs[i] for i in again)
        out["unpack"] += shards * sum(unpacks[i] for i in again)
    return out


def mse_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: ConvNetConfig, *,
             plan: Optional[plan_lib.ParallelPlan] = None,
             bn_axes: Optional[Sequence[str]] = None,
             precision=None, global_batch: int = 0, train: bool = True,
             dropout_seed: Optional[int] = None,
             sample_ids: Optional[Sequence[int]] = None,
             mask_source: Optional[MaskSource] = None,
             overlap: Optional[bool] = None,
             grad_axes: Sequence[str] = (),
             reshard_oracle: bool = False) -> torch.Tensor:
    """The local loss: the per-sample mean squared errors of the local
    samples summed and divided by ``global_batch`` (default: the local
    batch) times the plan's ``loss_redundancy``, in fp32 whatever the
    compute precision — the reference's ``mse_loss``: summed over every
    shard of the mesh it is the global loss, also where a gathered FC
    head computes each sample on every shard of the spatial group (a
    batch-moved head computes each once: redundancy 1). ``y`` is the
    entry stage's batch slice of the targets, cut here to the FC stage's
    chunk (``plan.batch_extension_axes``). ``train``/``dropout_seed``/
    ``sample_ids``/``mask_source``/``grad_axes``/``reshard_oracle`` are
    ``forward``'s."""
    plan = plan if plan is not None else _default_plan(cfg)
    pred = forward(params, x, cfg, plan=plan, bn_axes=bn_axes,
                   overlap=overlap, precision=precision, train=train,
                   dropout_seed=dropout_seed, sample_ids=sample_ids,
                   mask_source=mask_source, grad_axes=grad_axes,
                   reshard_oracle=reshard_oracle)
    y = reshard.shard_batch(y, plan.batch_extension_axes)
    return mse(pred, y, (global_batch or x.shape[0]) * plan.loss_redundancy)


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
