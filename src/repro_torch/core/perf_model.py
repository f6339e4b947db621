"""Per-layer width bookkeeping of CosmoFlow and the 3D U-Net, from the
reference's ``core/perf_model.py``: the single holder of CosmoFlow's
pool-count / stride-2 structure that ``core/plan.py`` derives its
stages from and ``core/memory.py`` walks, and of the U-Net's conv and
deconv shapes (its conv shapes and launch counts, ``models/unet3d.py``);
the optimizer state's bytes (``opt_state_bytes``, shared with the memory
model) and the paper's activation bytes per sample
(``memory_per_sample_bytes``); and the reference's layer-wise time
model (the paper's §III-C), with the reference's arithmetic:

    FP_l  = max{ Comp_l(D_main), sum_d 2*SR(D_halo_d) } + Comp_l(D_halo)
    Cost  = sum_l FP_l + max{ sum_l (BD_l + BF_l), sum_l AR_l(theta_l) }

priced per layer layout (``_scheduled_fp_times``: spatial, batch or
replicated, with the stage-boundary reshards between them) for the
cost-model planner (``core/plan.py``), and a pipelined plan's
iteration (``pipeline_iteration_time``: per micro-batch each group's
forward and recompute backward, the 1F1B fill and drain or the
sequential drain, the boundary transfers). ``Hardware`` records hold
roofline constants and an efficiency curve ``_eff`` for small local
domains: ``V100`` is the reference's record (its sessions price with
it, and the planner's parity with the reference is checked on it);
``H100`` is the port's card. Both price a mesh whose shards sit on
separate accelerators."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ConvNetConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator and its fabric, as the time model sees it.
    ``half_flops`` is the peak for 16-bit activations (None: the
    reference's single ``peak_flops`` for every precision)."""

    name: str
    peak_flops: float      # FLOP/s (per accelerator, fp32)
    mem_bw: float          # B/s HBM
    link_bw: float         # B/s P2P (halo, reshards)
    ar_bw: float           # B/s allreduce effective per-rank bandwidth
    latency: float = 5e-6  # s per message
    base_eff: float = 0.45  # kernel fraction of peak on big domains
    bytes_per_elt: int = 4
    half_flops: Optional[float] = None


# the reference's record, verbatim
V100 = Hardware("V100-16GB", peak_flops=15.7e12, mem_bw=900e9,
                link_bw=75e9, ar_bw=10e9)

# NVIDIA H100 SXM5 80GB, the port's card
H100 = Hardware(
    "H100-SXM5-80GB",
    # fp32 convs run as 3xTF32 on the tensor cores: 494.7 TFLOP/s dense
    # TF32 (NVIDIA H100 datasheet) over the 3 products, the rate PERF.md's
    # conv3d bounds use
    peak_flops=495e12 / 3,
    # HBM3, 3.35 TB/s (datasheet)
    mem_bw=3.35e12,
    # NVLink 4: 900 GB/s bidirectional over 18 links, 450 GB/s each way
    # (datasheet); halos, reshards and allreduces all ride it
    link_bw=450e9,
    ar_bw=450e9,
    # the port's conv3d kernel over its bound at the U-Net's shapes:
    # 144.74 ms bound / 384.59 ms measured a 256^3 b1 fp32 forward
    # (PERF.md's kernel table, chip_smoke.py, H100 80GB HBM3 at 700 W)
    base_eff=144.74 / 384.59,
    # dense bf16/fp16, 989.4 TFLOP/s (datasheet)
    half_flops=989e12,
)


def _eff(hw: Hardware, voxels: int) -> float:
    """Kernel efficiency falls off on small local domains (the paper's
    Table II)."""
    return hw.base_eff * (1.0 - math.exp(-voxels / 1.5e5))


def _sr(hw: Hardware, nbytes: float) -> float:
    return hw.latency + nbytes / hw.link_bw


def _allreduce(hw: Hardware, nbytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return hw.latency * math.log2(n) + 2 * (n - 1) / n * nbytes / hw.ar_bw


def _reduce_scatter(hw: Hardware, nbytes: float, n: int) -> float:
    """One half of a ring allreduce (RS and AG each move (n-1)/n bytes)."""
    if n <= 1:
        return 0.0
    return hw.latency * math.log2(n) + (n - 1) / n * nbytes / hw.ar_bw


def reshard_time(hw: Hardware, nbytes: float, n: int,
                 kind: str = "all_to_all") -> float:
    """One stage-boundary reshard of a ``nbytes`` local activation over
    an ``n``-way spatial group: ``all_to_all`` (spatial <-> batch) sends
    (n-1)/n of the local bytes, ``all_gather`` (spatial -> replicated)
    receives (n-1) x them, ``reduce_scatter`` (the gather's adjoint)
    sends (n-1)/n; over the P2P link."""
    if n <= 1:
        return 0.0
    lat = hw.latency * math.log2(n)
    if kind == "all_to_all":
        return lat + (n - 1) / n * nbytes / hw.link_bw
    if kind == "all_gather":
        return lat + (n - 1) * nbytes / hw.link_bw
    if kind == "reduce_scatter":
        return lat + (n - 1) / n * nbytes / hw.link_bw
    raise ValueError(f"reshard kind {kind!r}")


@dataclasses.dataclass
class ConvLayer:
    cin: int
    cout: int
    width: int      # global input width (cubic)
    stride: int
    kernel: int
    pooled: bool


def cosmoflow_layers(cfg: ConvNetConfig) -> List[ConvLayer]:
    layers, w, cin = [], cfg.input_width, cfg.in_channels
    npool = min(int(math.log2(cfg.input_width)) - 2,
                len(cfg.conv_channels))
    for i, c in enumerate(cfg.conv_channels):
        stride = 2 if i == 3 else 1
        pooled = i < npool
        layers.append(ConvLayer(cin, c, w, stride, cfg.kernel_size, pooled))
        w = w // stride // (2 if pooled else 1)
        cin = c
    return layers


def unet_layers(cfg: ConvNetConfig) -> List[ConvLayer]:
    """The U-Net's convs in forward order: per encoder level two k = 3
    convs (the second one pooled after), the bottleneck's two, then per
    decoder level the 2^3 deconv and two k = 3 convs. The 1^3 head is
    not listed (the reference's)."""
    layers, w, cin, ch = [], cfg.input_width, cfg.in_channels, \
        cfg.base_channels
    enc = []
    for _ in range(cfg.depth):
        layers.append(ConvLayer(cin, ch, w, 1, 3, False))
        layers.append(ConvLayer(ch, 2 * ch, w, 1, 3, True))
        enc.append(2 * ch)
        cin, ch, w = 2 * ch, 2 * ch, w // 2
    layers.append(ConvLayer(cin, ch, w, 1, 3, False))
    layers.append(ConvLayer(ch, 2 * ch, w, 1, 3, False))
    up = 2 * ch
    for skip in reversed(enc):
        w *= 2
        layers.append(ConvLayer(up, skip, w, 1, 2, False))        # deconv
        layers.append(ConvLayer(2 * skip, skip, w, 1, 3, False))
        layers.append(ConvLayer(skip, skip, w, 1, 3, False))
        up = skip
    return layers


def _layer_fp_time(hw: Hardware, l: ConvLayer, ways: int,
                   per_gpu_batch: float, overlap: bool = True,
                   act_bytes: Optional[int] = None) -> Tuple[float, float]:
    """(fp_time, comp_time_only) of one forward conv over ``ways``
    depth shards. ``overlap=True``: the halo hides behind the interior,
    ``max{Comp(D_main), halo} + Comp(D_halo)``; ``False``: the blocking
    lowering, ``Comp(D_main) + halo + Comp(D_halo)``."""
    peak = (hw.half_flops if act_bytes == 2 and hw.half_flops
            else hw.peak_flops)
    out_w = l.width // l.stride
    local_vox = out_w ** 3 / max(ways, 1)
    flops = 2 * l.kernel ** 3 * l.cin * l.cout * out_w ** 3 / max(ways, 1) \
        * per_gpu_batch
    comp_main = flops / (peak * _eff(hw, int(local_vox)))
    if ways > 1 and l.width // ways >= 1:
        halo_elems = (l.kernel - l.stride) * (l.width // l.stride) ** 2 \
            * l.cin * per_gpu_batch
        halo_bytes = max(halo_elems, 0) * (act_bytes or hw.bytes_per_elt)
        halo_time = 2 * _sr(hw, halo_bytes)
        # halo-region compute: one boundary plane each side
        halo_flops = 2 * l.kernel ** 3 * l.cin * l.cout \
            * (l.width // l.stride) ** 2 * max(l.kernel - l.stride, 0) \
            * per_gpu_batch
        comp_halo = halo_flops / (peak * _eff(hw, int(local_vox)))
        if overlap:
            fp = max(comp_main, halo_time) + comp_halo
        else:
            fp = comp_main + halo_time + comp_halo
    else:
        fp = comp_main
    return fp, comp_main


def _scheduled_fp_times(
    cfg: ConvNetConfig,
    hw: Hardware,
    layers: List[ConvLayer],
    schedule: Sequence[str],
    *,
    num_gpus: int,
    ways: int,
    global_batch: int,
    overlap: bool,
    remat_schedule: Optional[Sequence[bool]] = None,
    act_bytes: Optional[int] = None,
) -> Tuple[float, float, float]:
    """(fp_total, bp_total, reshard_total) under a per-layer layout
    ``schedule``: ``"spatial"`` (the ``ways``-way depth partition),
    ``"batch"`` (the spatial group moved into the batch: the batch a
    device shrinks by ``ways``, no halo) or ``"replicated"`` (the whole
    group batch computed on every device of the group). CosmoFlow's
    schedule carries one trailing entry for the FC head (unpriced
    compute; it places the CNN -> FC reshard).

    A change of layout between entries is a reshard of the incoming
    activation: an ``all_to_all`` each way where the batch is involved,
    an ``all_gather`` forward and a ``reduce_scatter`` backward for
    spatial -> replicated, free for replicated -> spatial (a slice).
    ``remat_schedule`` entries pay their forward again in the backward;
    ``act_bytes`` (2 for bf16/fp16) sets the halo and reshard element
    width."""
    n_entries = len(layers) + (1 if cfg.arch == "cosmoflow" else 0)
    if len(schedule) != n_entries:
        raise ValueError(
            f"schedule has {len(schedule)} entries; {cfg.arch} needs "
            f"{n_entries}")
    bad = set(schedule) - {"spatial", "batch", "replicated"}
    if bad:
        raise ValueError(f"unknown schedule modes {sorted(bad)}")
    if remat_schedule is not None and len(remat_schedule) != n_entries:
        raise ValueError(
            f"remat_schedule has {len(remat_schedule)} entries; "
            f"expected {n_entries}")
    groups = max(num_gpus // ways, 1)
    pg_group = global_batch / groups   # per-device batch, spatial/replicated
    pg_batch = global_batch / num_gpus  # per-device batch, batch layers
    # the activation entering each entry: (layer, width, channels); the
    # FC entry sees the final feature map
    entries: List[Tuple[Optional[ConvLayer], int, int]] = [
        (l, l.width, l.cin) for l in layers]
    if cfg.arch == "cosmoflow":
        last = layers[-1]
        w_out = last.width // last.stride // (2 if last.pooled else 1)
        entries.append((None, w_out, last.cout))

    fp_total = bp_total = reshard_total = 0.0
    prev = schedule[0]
    for k, ((l, w_in, c_in), mode) in enumerate(zip(entries, schedule)):
        if mode != prev:
            # the local activation at the boundary: a spatial or batch
            # layout holds 1/ways of the group's tensor, a replicated one
            # all of it
            local_elems = w_in ** 3 * c_in * pg_group
            if prev in ("spatial", "batch"):
                local_elems /= ways
            nbytes = local_elems * (act_bytes or hw.bytes_per_elt)
            if "batch" in (prev, mode):
                fwd = bwd = reshard_time(hw, nbytes, ways, "all_to_all")
            elif mode == "replicated":
                fwd = reshard_time(hw, nbytes, ways, "all_gather")
                bwd = reshard_time(hw, nbytes, ways, "reduce_scatter")
            else:  # replicated -> spatial: a local slice
                fwd = bwd = 0.0
            fp_total += fwd
            bp_total += bwd
            reshard_total += fwd + bwd
            prev = mode
        if l is None:
            continue  # the FC head: compute unpriced, reshard above
        if mode == "spatial":
            fp, _ = _layer_fp_time(hw, l, ways, pg_group, overlap=overlap,
                                   act_bytes=act_bytes)
        elif mode == "batch":
            fp, _ = _layer_fp_time(hw, l, 1, pg_batch, overlap=overlap,
                                   act_bytes=act_bytes)
        else:
            fp, _ = _layer_fp_time(hw, l, 1, pg_group, overlap=overlap,
                                   act_bytes=act_bytes)
        fp_total += fp
        bp_total += 2 * fp
        if remat_schedule is not None and remat_schedule[k]:
            bp_total += fp  # the forward again, inside the backward
    return fp_total, bp_total, reshard_total


def iteration_time(
    cfg: ConvNetConfig,
    hw: Hardware,
    *,
    num_gpus: int,
    ways: int,
    global_batch: int,
    overlap: bool = True,
    grad_comm: str = "overlap",
    schedule: Optional[Sequence[str]] = None,
    remat_schedule: Optional[Sequence[bool]] = None,
    act_bytes: Optional[int] = None,
) -> Dict[str, float]:
    """Predicted seconds a training iteration (the paper's Cost) over
    ``num_gpus`` devices, ``ways``-way spatial groups. ``grad_comm``:
    ``"overlap"`` hides the allreduce behind the backward (the Cost
    equation's max), ``"monolithic"`` adds it after the backward,
    ``"reduce_scatter"`` (ZeRO-1) hides the spatial allreduce and the
    reduce-scatter half and adds the parameters' all-gather after the
    update. ``schedule`` prices a per-layer layout (``core.plan.
    plan_schedule``) instead of one network-wide ``ways``, reshards
    included (``"reshard"``)."""
    layers = (cosmoflow_layers(cfg) if cfg.arch == "cosmoflow"
              else unet_layers(cfg))
    groups = max(num_gpus // ways, 1)
    per_gpu_batch = global_batch / groups
    reshard_total = 0.0
    if schedule is not None:
        fp_total, bp_total, reshard_total = _scheduled_fp_times(
            cfg, hw, layers, schedule, num_gpus=num_gpus, ways=ways,
            global_batch=global_batch, overlap=overlap,
            remat_schedule=remat_schedule, act_bytes=act_bytes)
    else:
        if remat_schedule is not None:
            raise ValueError("remat_schedule requires schedule=")
        fp_total, bp_total = 0.0, 0.0
        for l in layers:
            fp, _ = _layer_fp_time(hw, l, ways, per_gpu_batch,
                                   overlap=overlap, act_bytes=act_bytes)
            fp_total += fp
            bp_total += 2 * fp  # BD + BF, the same halo structure
    n_params = cfg.param_count()
    grad_bytes = n_params * 4
    ar = _allreduce(hw, grad_bytes, num_gpus)
    opt_bytes = opt_state_bytes(n_params, grad_comm=grad_comm,
                                data_degree=groups)
    if grad_comm == "monolithic":
        gc_time, total = ar, fp_total + bp_total + ar
    elif grad_comm == "reduce_scatter":
        spatial_ar = _allreduce(hw, grad_bytes, ways)
        half = _reduce_scatter(hw, grad_bytes, groups)
        gc_time = spatial_ar + 2 * half
        total = fp_total + max(bp_total, spatial_ar + half) + half
    else:  # "overlap"
        gc_time, total = ar, fp_total + max(bp_total, ar)
    return {
        "fp": fp_total, "bp": bp_total, "allreduce": ar,
        "grad_comm": gc_time, "opt_state_bytes": opt_bytes,
        "reshard": reshard_total,
        "total": total,
        "samples_per_s": global_batch / total,
        "per_gpu_batch": per_gpu_batch,
    }


def _plan_layer_map(
        cfg: ConvNetConfig,
        layers: List[ConvLayer]) -> List[Tuple[Tuple[int, ...], int, int]]:
    """Per plan layer (``core/plan.py``'s indexing): the time-model layers
    it covers and its entry activation's ``(width, channels)``.
    CosmoFlow's plan layer i is conv block i, its last (the FC head)
    covers no conv (unpriced) but places the CNN -> FC boundary. The
    U-Net's plan layer is a resolution level: its two encoder convs and
    its decoder's up-convolution and two convs (a level's descent and
    ascent run on one group); the last is the bottleneck."""
    if cfg.arch == "cosmoflow":
        out: List[Tuple[Tuple[int, ...], int, int]] = [
            ((i,), l.width, l.cin) for i, l in enumerate(layers)]
        last = layers[-1]
        w_out = last.width // last.stride // (2 if last.pooled else 1)
        out.append(((), w_out, last.cout))
        return out
    depth = cfg.depth
    out = []
    for lvl in range(depth):
        dec0 = 2 * depth + 2 + 3 * (depth - 1 - lvl)
        idxs = (2 * lvl, 2 * lvl + 1, dec0, dec0 + 1, dec0 + 2)
        out.append((idxs, layers[2 * lvl].width, layers[2 * lvl].cin))
    out.append(((2 * depth, 2 * depth + 1),
                layers[2 * depth].width, layers[2 * depth].cin))
    return out


def group_param_counts(
        cfg: ConvNetConfig,
        group_ranges: Sequence[Tuple[int, int]]) -> List[float]:
    """Parameters of each group of a pipelined split: the conv kernels of
    its plan layers, every other parameter (the FC head, batch norm's
    scales and biases) charged to CosmoFlow's FC layer or the U-Net's
    level 0. The allreduce pricing and the memory model share it."""
    layers = (cosmoflow_layers(cfg) if cfg.arch == "cosmoflow"
              else unet_layers(cfg))
    pmap = _plan_layer_map(cfg, layers)
    conv_params = [float(sum(layers[i].kernel ** 3 * layers[i].cin
                             * layers[i].cout for i in idxs))
                   for idxs, _, _ in pmap]
    rem = max(cfg.param_count() - sum(conv_params), 0.0)
    conv_params[-1 if cfg.arch == "cosmoflow" else 0] += rem
    return [sum(conv_params[a:b]) for a, b in group_ranges]


def pipeline_iteration_time(
    cfg: ConvNetConfig,
    hw: Hardware,
    *,
    group_ranges: Sequence[Tuple[int, int]],
    data_degree: int,
    micro_batches: int,
    global_batch: int,
    schedule: str = "1f1b",
    grad_comm: str = "overlap",
    act_bytes: Optional[int] = None,
) -> Dict[str, float]:
    """Predicted seconds an iteration of a pipelined plan: P =
    ``len(group_ranges)`` groups, each ``data_degree``-way data parallel,
    over ``micro_batches`` micro-batches. A group's time per micro-batch
    is its forward plus the recomputing backward (4x the forward: the
    segment's forward again inside it) and its gradient allreduce,
    hidden behind the 3x backward under ``"overlap"``, after it under
    ``"monolithic"``. ``"1f1b"`` takes (M + P - 1) slots of the slowest
    group (the bubble ``(P-1)/(M+P-1)``), ``"sequential"`` M times the
    groups' sum. Each boundary sends each device's activation shard, 2
    directions (CosmoFlow) or 4 (the U-Net's ascent crosses back)."""
    layers = (cosmoflow_layers(cfg) if cfg.arch == "cosmoflow"
              else unet_layers(cfg))
    pmap = _plan_layer_map(cfg, layers)
    d = max(data_degree, 1)
    m = max(micro_batches, 1)
    p = len(group_ranges)
    per_dev = global_batch / m / d
    elt = act_bytes or hw.bytes_per_elt
    fp_layer: List[float] = []
    for idxs, _, _ in pmap:
        fp_layer.append(sum(
            _layer_fp_time(hw, layers[i], 1, per_dev,
                           act_bytes=act_bytes)[0] for i in idxs))
    group_params = group_param_counts(cfg, group_ranges)

    stage_times: List[float] = []
    ar_max = 0.0
    for (a, b), gparams in zip(group_ranges, group_params):
        fp = sum(fp_layer[a:b])
        ar = _allreduce(hw, gparams * 4, d)
        ar_max = max(ar_max, ar)
        if grad_comm == "monolithic":
            stage_times.append(4 * fp + ar)
        else:  # overlap: the hooks hide the reduction behind the 3x bwd
            stage_times.append(fp + max(3 * fp, ar))
    if schedule == "sequential":
        compute = m * sum(stage_times)
    else:  # 1f1b: fill P - 1 slots, then the slowest group paces each
        compute = (m + p - 1) * max(stage_times)
    dirs = 2 if cfg.arch == "cosmoflow" else 4
    transfer = 0.0
    for a, _ in group_ranges[1:]:
        _, w, c = pmap[a]
        transfer += m * dirs * _sr(hw, w ** 3 * c * per_dev * elt)
    total = compute + transfer
    return {
        "total": total,
        "compute": compute,
        "transfer": transfer,
        "grad_comm": ar_max,
        "stage_times": tuple(stage_times),
        "bubble_fraction": (p - 1) / (m + p - 1),
        "samples_per_s": global_batch / total,
        "per_gpu_batch": per_dev,
    }


def opt_state_bytes(n_params: int, *, grad_comm: str = "overlap",
                    data_degree: int = 1) -> float:
    """Adam's m and v in fp32; ZeRO-1 (``reduce_scatter``) shards them
    over the data-parallel degree."""
    total = 2.0 * n_params * 4
    if grad_comm == "reduce_scatter":
        total /= max(data_degree, 1)
    return total


def memory_per_sample_bytes(cfg: ConvNetConfig,
                            batchnorm: Optional[bool] = None) -> float:
    """Activation memory per sample (forward stores and gradients), the
    paper's Table I: every layer's input and output in fp32, times 3.8
    (stored activations, gradient buffers and cuDNN's workspace: 0.82 /
    6.56 / 52.6 GiB at 128^3 / 256^3 / 512^3 against the paper's 0.824 /
    6.59 / 52.7), doubled with batch norm (the paper's §IV)."""
    layers = (cosmoflow_layers(cfg) if cfg.arch == "cosmoflow"
              else unet_layers(cfg))
    total = 0.0
    for l in layers:
        out_w = l.width // l.stride
        total += (l.width ** 3 * l.cin + out_w ** 3 * l.cout) * 4
    total *= 3.8
    if cfg.batchnorm if batchnorm is None else batchnorm:
        total *= 2
    return total
