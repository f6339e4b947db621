"""3D U-Net (Çiçek et al. 2016; paper §II-C), spatially partitioned by a
``ParallelPlan`` (the reference's ``models/unet3d.py``).

Per encoder level a conv pair — conv(ch), batch norm + ReLU, conv(2ch),
batch norm + ReLU — then 2^3 max pooling; the bottleneck's conv pair;
per decoder level the 2^3 stride-2 up-convolution (purely local under
spatial partitioning), the channel concat ``[skip, up]`` with the
encoder level's output (the same layout at the same resolution, so a
local concat) and a conv pair; then the 1^3 head to per-voxel class
logits. Every 3^3 conv is SAME, stride 1, without bias, through
``core/spatial_conv.conv3d`` (the conv3d kernel, with the halo exchange
and the pack/unpack kernels where depth is split); every batch norm
through ``core/dist_norm`` with the ReLU folded into the bn_act kernel
(slope 0). The reference computes the up-convolution and the head in
XLA, not in Pallas kernels: here ``spatial_conv.deconv3d`` (one
``torch.matmul`` and one permuting copy) and one ``torch.matmul``, each
fp32 with TF32 off.

Activations are contiguous (N, D, H, W, C) and weights (k, k, k, Cin,
Cout), the reference's layouts, so its parameters carry over unchanged
(``params_from_numpy``). ``forward`` is the per-shard body of the
plan-sharded forward (``core/spmd.py``); the logits come back in the
input's layout (every reshard on the way down is undone on the way up),
so labels split like the input line up with them.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import dist_norm
from repro_torch.core import grad_comm
from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.core.spatial_conv import (SpatialPartitioning, conv3d,
                                           deconv3d, maxpool3d,
                                           overlap_split)
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.models import cosmoflow

Params = Dict[str, torch.Tensor]
_PAIR = ("w0", "s0", "b0", "w1", "s1", "b1")


def param_shapes(cfg: ConvNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter, in the reference's
    ``init_params`` order."""
    k = cfg.kernel_size
    shapes: Dict[str, Tuple[int, ...]] = {}

    def pair(prefix, cin, c0, c1):
        shapes.update({f"{prefix}_w0": (k, k, k, cin, c0),
                       f"{prefix}_s0": (c0,), f"{prefix}_b0": (c0,),
                       f"{prefix}_w1": (k, k, k, c0, c1),
                       f"{prefix}_s1": (c1,), f"{prefix}_b1": (c1,)})

    cin, ch = cfg.in_channels, cfg.base_channels
    enc_out = []
    for lvl in range(cfg.depth):
        pair(f"enc{lvl}", cin, ch, 2 * ch)
        enc_out.append(2 * ch)
        cin, ch = 2 * ch, 2 * ch
    pair("mid", cin, ch, 2 * ch)
    up_in = 2 * ch
    for lvl in reversed(range(cfg.depth)):
        skip = enc_out[lvl]
        shapes[f"dec{lvl}_up"] = (2, 2, 2, up_in, skip)
        pair(f"dec{lvl}", 2 * skip, skip, skip)
        up_in = skip
    shapes["head_w"] = (1, 1, 1, up_in, cfg.out_dim)
    return shapes


def init_params(cfg: ConvNetConfig, generator: torch.Generator,
                device) -> Params:
    """fp32 masters, the reference's initialization law: He-normal
    weights (every conv, up-convolution and the head: normal times
    sqrt(2 / (k^3 Cin))), unit BN scales, zero BN biases, drawn from
    ``generator`` (a CPU generator, so a seed gives the same weights on
    every device)."""
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if len(shape) == 1:
            t = (torch.ones if name.split("_")[1].startswith("s")
                 else torch.zeros)(shape)
        else:
            t = torch.randn(shape, generator=generator) * math.sqrt(
                2.0 / math.prod(shape[:4]))
        params[name] = t.to(device)
    return params


def params_from_numpy(tree: Mapping[str, object], device,
                      dtype: Optional[torch.dtype] = None, *,
                      cfg: ConvNetConfig) -> Params:
    """The reference's parameters (``{name: np.asarray(leaf)}`` of
    ``repro.models.unet3d.init_params``, or arrays read from its
    checkpoints) as the port's: the layouts are identical, so this is a
    device and dtype move with name and shape checks against ``cfg``
    (``dtype=None`` keeps each array's dtype)."""
    return cosmoflow.checked_tree(tree, param_shapes(cfg), device, dtype,
                                  cfg.name)


def opt_state_from_numpy(state: Any, device, *, cfg: ConvNetConfig):
    """The reference's optimizer state for a U-Net tree as the port's
    (``cosmoflow.opt_state_from_numpy`` with this model's names)."""
    return cosmoflow.opt_state_from_numpy(state, device, cfg=cfg,
                                          convert=params_from_numpy)


def _default_plan(cfg: ConvNetConfig) -> plan_lib.ParallelPlan:
    return plan_lib.legacy_convnet_plan(cfg, SpatialPartitioning())


def _conv_bn_relu(h, w, s, b, part, bn_axes, overlap):
    h = conv3d(h, w, part, stride=1, overlap=overlap)
    # ReLU (slope 0) folded into the normalize pass (the bn_act kernel)
    return dist_norm.distributed_batchnorm(h, s, b, bn_axes,
                                           activation_slope=0.0)


def _pair(h, w0, s0, b0, w1, s1, b1, *, part, bn_axes, overlap):
    """A conv pair: conv, batch norm + ReLU, twice."""
    h = _conv_bn_relu(h, w0, s0, b0, part, bn_axes, overlap)
    return _conv_bn_relu(h, w1, s1, b1, part, bn_axes, overlap)


def head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 1^3 conv to per-voxel logits: one (voxels, Cin) @ (Cin, Cout)
    product, fp32 with TF32 off."""
    with conv_ops.no_tf32():
        return torch.matmul(h, w.reshape(w.shape[3], w.shape[4]))


def forward(params: Params, x: torch.Tensor, cfg: ConvNetConfig, *,
            plan: Optional[plan_lib.ParallelPlan] = None,
            bn_axes: Optional[Sequence[str]] = None,
            overlap: Optional[bool] = None, precision=None,
            grad_axes: Sequence[str] = (),
            reshard_oracle: bool = False) -> torch.Tensor:
    """x: local shard (N, D_loc, H_loc, W_loc, Cin) -> per-voxel logits
    (N, D_loc, H_loc, W_loc, out_dim), in the input's layout.

    The per-shard body of a plan-sharded forward (run it inside
    ``core.spmd.run`` over a mesh of the plan's degrees, or directly for
    a plan that spans one device). Levels ``0..depth-1`` and the
    bottleneck (plan layer ``depth``) each run their stage's layout;
    each decoder level runs its encoder level's, so a stage boundary
    reshards on the way down and back on the way up (after the
    up-convolution): a batch move down is a ``batch_to_spatial`` up, so
    that the skip concats stay local and the logits come back in the
    input's layout, where voxel labels split like the input line up
    with them. ``reshard_oracle`` lowers batch moves by a gather and a
    slice. ``bn_axes`` (default: every axis of the plan) are
    the axes the batch-norm statistics are summed over; ``overlap``
    picks the conv lowering; ``precision`` (or the plan's policy) casts
    the input and, at each use, the parameters. ``grad_axes`` hooks the
    parameters' gradient reduction into the backward: each master,
    the up-convolutions' and the head's included, marked ahead of the
    compute-dtype cast.

    Rematerialization is per level, as in the reference: a stage with
    ``remat`` (every stage under ``core/flags.REMAT`` when the plan marks
    none) checkpoints its encoder pair, its decoder pair or the
    bottleneck (``spmd.checkpoint``), so that only the pairs' inputs are
    saved. The up-convolutions, the skip concat and the head stay
    outside; each pair's parameters are marked and cast outside its
    body."""
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

    def conv_pair(h, prefix, st):
        args = [cst(params[f"{prefix}_{k}"]) for k in _PAIR]
        body = functools.partial(_pair, part=st.part, bn_axes=bn_axes,
                                 overlap=overlap)
        if plan_lib.stage_remat(plan, st):
            return spmd.checkpoint(body, h, *args)
        return body(h, *args)

    h = x
    if policy.casts_params and h.is_floating_point():
        h = h.to(cdt)
    h = h.contiguous()
    skips = []
    cur = plan.stage_for(0)
    for lvl in range(cfg.depth):
        st = plan.stage_for(lvl)
        if st != cur:
            h, _ = reshard.apply(h, cur, st, oracle=reshard_oracle)
            cur = st
        h = conv_pair(h, f"enc{lvl}", cur)
        skips.append(h)
        h = maxpool3d(h, cur.part, window=2, stride=2)
    st = plan.stage_for(cfg.depth)
    if st != cur:
        h, _ = reshard.apply(h, cur, st, oracle=reshard_oracle)
        cur = st
    h = conv_pair(h, "mid", cur)
    for lvl in reversed(range(cfg.depth)):
        h = deconv3d(h, cst(params[f"dec{lvl}_up"]), cur.part, stride=2)
        st = plan.stage_for(lvl)
        if st != cur:
            h, _ = reshard.apply(h, cur, st, oracle=reshard_oracle)
            cur = st
        # the skip and the up-convolution's output die at the concat
        # (the conv saves the concat): at 256^3 they are 8.6 GB
        cat = torch.cat([skips[lvl], h], dim=-1)
        skips[lvl] = h = None
        h = conv_pair(cat, f"dec{lvl}", cur)
        del cat
    out = head(h, cst(params["head_w"]))
    marker.assert_all_marked()
    return out


def voxel_nll(logits: torch.Tensor, labels: torch.Tensor,
              denominator: int) -> torch.Tensor:
    """The per-voxel softmax cross-entropy summed over the local voxels
    and divided by ``denominator``, in fp32 whatever the logits' dtype:
    ``log_softmax`` of the fp32 logits, the label's entry taken."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.sum() / denominator


def segmentation_loss(params: Params, x: torch.Tensor, labels: torch.Tensor,
                      cfg: ConvNetConfig, *,
                      plan: Optional[plan_lib.ParallelPlan] = None,
                      bn_axes: Optional[Sequence[str]] = None,
                      global_voxels: int = 0,
                      overlap: Optional[bool] = None, precision=None,
                      grad_axes: Sequence[str] = (),
                      reshard_oracle: bool = False) -> torch.Tensor:
    """The LOCAL cross-entropy contribution: summed over the local voxels
    and divided by ``global_voxels`` (default: the local voxel count),
    so that its sum over every shard of the mesh is the global mean.
    ``labels`` (N, D_loc, H_loc, W_loc) of integer classes, split like
    ``x``. The other arguments are ``forward``'s."""
    logits = forward(params, x, cfg, plan=plan, bn_axes=bn_axes,
                     overlap=overlap, precision=precision,
                     grad_axes=grad_axes, reshard_oracle=reshard_oracle)
    return voxel_nll(logits, labels, global_voxels or labels.numel())


def conv_shapes(cfg: ConvNetConfig, batch: int):
    """``(input shape, weight shape, stride, pads)`` of every 3^3 conv of
    one unsharded forward at ``batch``, in forward order — the shapes the
    conv kernel sees on the main path."""
    out = []
    for layer in perf_model.unet_layers(cfg):
        if layer.kernel != 3:
            continue  # the up-convolutions
        w = layer.width
        out.append(((batch, w, w, w, layer.cin),
                    (3, 3, 3, layer.cin, layer.cout), 1, ((1, 1),) * 3))
    return out


def split_convs(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan,
                batch: int) -> List[cosmoflow.SplitConv]:
    """Every 3^3 conv (index in ``conv_shapes`` order) whose depth
    ``plan`` splits over more than one shard, with the shard-local shape
    the pack kernel reads and whether the overlapped conv falls back to
    the unpack kernel there (``cosmoflow.SplitConv``). Only depth may be
    split."""
    out = []
    for i, (layer, lvl) in enumerate(zip(_convs(cfg), _levels(cfg))):
        split = [(d, a) for d, a in plan.stage_for(lvl).part.active
                 if plan.degree(a) > 1]
        if any(d != 0 for d, _ in split):
            raise NotImplementedError("split_convs of H/W partitions")
        if not split:
            continue
        local = layer.width // plan.degree(split[0][1])
        n_out, n_lo, n_hi = overlap_split(local, 3, 1)
        out.append(cosmoflow.SplitConv(
            i, (batch, local, layer.width, layer.width, layer.cin), 1, 1,
            n_lo, n_hi, n_lo + n_hi >= n_out))
    return out


def kernel_launches(cfg: ConvNetConfig, plan: plan_lib.ParallelPlan,
                    train: bool = False) -> Dict[str, int]:
    """Launches of each kernel over every shard of ``plan``'s mesh in one
    forward (``train=True``: one training step), with the overlapped conv
    (the default lowering), derived from the plan's stages and the convs'
    widths as ``cosmoflow.kernel_launches`` derives them: per shard and
    3^3 conv one bn_act and one conv, a depth-split conv one pack and
    either the interior conv plus its boundary pieces or (no interior)
    one unpack and one conv; a step adds the input gradient of each conv
    launch but the first conv's, and one pack for each such unpack's
    adjoint, and each conv of a rematerialized pair launches its forward
    once more (its recompute). The up-convolutions and the head are
    ``torch.matmul``s: no kernel."""
    return cosmoflow.count_launches(
        len(_convs(cfg)), split_convs(cfg, plan, 1), plan.device_count,
        True, train, [plan_lib.stage_remat(plan, plan.stage_for(lvl))
                      for lvl in _levels(cfg)])


def _convs(cfg: ConvNetConfig):
    return [l for l in perf_model.unet_layers(cfg) if l.kernel == 3]


def _levels(cfg: ConvNetConfig):
    """The plan layer (resolution level; ``depth`` the bottleneck) of
    each 3^3 conv, in forward order."""
    d = cfg.depth
    return ([lvl for lvl in range(d) for _ in range(2)] + [d, d]
            + [lvl for lvl in reversed(range(d)) for _ in range(2)])


__all__ = ["conv_shapes", "forward", "head", "init_params",
           "kernel_launches", "opt_state_from_numpy", "param_shapes",
           "params_from_numpy", "segmentation_loss", "split_convs",
           "voxel_nll"]
