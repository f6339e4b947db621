#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out details.json]

Phases, each printing one line; any failure raises and exits non-zero:

1. card     — the card's name and power limit (nvidia-smi); TF32 off.
2. build    — build every kernel from ``src/repro_torch/csrc`` (one nvcc
              per source, in parallel).
3. kernels  — each kernel against its plain PyTorch version on the card:
              conv3d over the shape grid of ``tests/test_kernels.py`` and
              every conv of cosmoflow-128 at batch 4, bn_act over the same
              rows x C shapes, fp32 and bf16; halo pack and unpack, bit
              for bit, at every face of the depth-split convs of
              cosmoflow-128 batch 4 (S = 2, 4, and all 7 blocks split at
              S = 2) and cosmoflow-512 batch 1 (S = 4), plus k = 5
              (lo = hi = 2) and a row of 180 bytes, fp32 and bf16.
4. serve    — ``repro_torch.api.compile(RunConfig(model="cosmoflow-128",
              mode="infer", global_batch=4))`` at fp32 and bf16: predict
              on a seeded batch, held against the same forward through the
              plain versions; exactly 7 conv3d + 7 bn_act launches.
5. serve512 — cosmoflow-512 (512^3 x 4 input, 7 blocks), batch 1, fp32,
              also held against the plain forward; peak device memory.
6. harness  — ``serve(max_batch=4, max_wait_ms=50)`` on 16 cosmoflow-128
              requests; every future resolves.
7. spatial  — the same models with depth split over S shards, every
              shard on this card (``devices=["cuda:0"] * S``, one stream
              each): cosmoflow-128 batch 4 S=2 fp32 and bf16, S=4 fp32,
              cosmoflow-512 batch 1 S=4 fp32 (peak memory), and
              cosmoflow-128 S=2 under a plan that splits all 7 blocks
              (the path that launches unpack). Each is held against the
              unsharded forward of phases 4-5 (same seed, same input) and
              against its own forward through the plain versions, and
              its launches of conv3d, bn_act, pack and unpack per forward
              against the counts ``kernel_launches`` derives from its
              plan.
8. harness  — ``serve()`` on the cosmoflow-128 S=2 session, 8 requests.
9. timings  — per kernel at the main paths' shapes (CUDA events, median):
              kernel, bound, plain version and library call; end-to-end
              predict time per batch, unsharded and spatial; the
              overlapped conv lowering against the blocking one
              (``overlap_halo=False``) at cosmoflow-128 S=2, S=4 and
              cosmoflow-512 S=4; one profiled predict per config (device
              busy time, idle share, time by kernel name).

Phases 4-6 and 7-8 are the main paths: the launch counters are zeroed
just before each and read just after. The next-to-last line is the
``{"kernels": [...]}`` summary and the last line the device record.
Exits non-zero without a CUDA device or without the repository beside
it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
# published H100 SXM peaks (dense): fp32 on the CUDA cores, bf16 on the
# tensor cores, and HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
PEAKS_USED = ("bound = max(FLOPs / peak, bytes / 3.35 TB/s); peak = "
              "67 TFLOP/s fp32 (CUDA cores), 989 TFLOP/s bf16 (tensor "
              "cores); each input read once, each output written once")
CONV_GRID = [((2, 10, 10, 10, 3), 3, 8, 1), ((1, 9, 9, 9, 4), 3, 16, 2),
             ((2, 12, 8, 8, 8), 5, 4, 1), ((1, 6, 6, 6, 2), 1, 8, 1),
             ((1, 7, 7, 7, 16), 3, 32, 1)]
BN_GRID = [(2, 5, 5, 5, 16), (4, 7, 3, 3, 32), (1, 128, 8)]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (model, batch, spatial degree, precision, plan): "deep" splits depth in
# every conv block; "fixed" is the legacy plan (gathered where a block's
# local width would drop below 4)
SPATIAL = (("cosmoflow-128", 4, 2, "fp32", "fixed"),
           ("cosmoflow-128", 4, 2, "bf16", "fixed"),
           ("cosmoflow-128", 4, 4, "fp32", "fixed"),
           ("cosmoflow-512", 1, 4, "fp32", "fixed"),
           ("cosmoflow-128", 4, 2, "fp32", "deep"))
# extra halo cases beyond the main path's: k = 5 (lo = hi = 2), and a
# depth row of 3*5*3 fp32 = 180 bytes, not a multiple of 16
HALO_EXTRA = (((2, 8, 16, 16, 8), 2, 2), ((2, 6, 3, 5, 3), 1, 1))
KERNELS = ("conv3d", "bn_act", "pack", "unpack")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event-timed calls, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``, for work too short to hide its own
    launch cost: ``n`` calls enqueued behind a spin kernel
    (``torch.cuda._sleep``, about 3x the time the host takes to enqueue
    them), so the card runs them back to back; CUDA events around the
    ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_s * 2e9) + 100_000)  # cycles at <= 2 GHz
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` + synchronize (end to end)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn) -> dict:
    """One traced call of ``fn`` (after a warm-up): its wall time, the
    time some kernel ran on the card (union of kernel intervals), the
    idle share, and device time by kernel name (top 8). ``busy_ms`` is
    None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name: dict = {}
    busy, end = 0.0, float("-inf")
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "busy_ms": busy / 1e3 if spans else None,
            "idle_share": 1 - busy / 1e3 / wall if spans else None,
            "by_kernel_ms": dict(top)}


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    return (got.float() - want.float()).abs().max().item()


# ------------------------------------------------------------------ bounds --
def conv_work(x_shape, w_shape, out_shape, dtype):
    k3cin = math.prod(w_shape[:4])
    flops = 2.0 * math.prod(out_shape) * k3cin
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (math.prod(x_shape) + math.prod(w_shape)
                     + math.prod(out_shape))
    return flops, nbytes


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ phases --
def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi listed no card")
    print(out[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}; TF32 off")
    return out[0]


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    secs = build.build_all()
    total = time.perf_counter() - t0
    for name in secs:
        regs = sorted({line.split(":", 1)[1].strip()
                       for line in build.build_log(name).splitlines()
                       if "registers" in line})
        log("build", f"{name}: {regs}")
    log("build", f"ok in {total:.1f}s {json.dumps(secs)}")
    return {"seconds": total, "per_source": secs}


def phase_kernels(conv_ops, conv_ref, bn_ops, bn_ref, conv_shapes) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"conv3d": 0.0, "bn_act": 0.0}
    rows = []

    def conv_case(xs, ws, stride, pads, dt, wscale, tol_fn, tag):
        x = torch.randn(xs, generator=g, device="cuda").to(dt)
        w = (torch.randn(ws, generator=g, device="cuda") * wscale).to(dt)
        got = conv_ops.conv3d_valid(x, w, stride, pads)
        torch.cuda.synchronize()
        want = conv_ref.conv3d_valid(x, w, stride, pads)
        err = max_err(got, want)
        tol = tol_fn(want)
        check(err <= tol, f"conv3d {tag} {xs} {dt}: err {err} > tol {tol}")
        rows.append(("conv3d", tag, xs, str(dt), err, tol))
        return err

    for name, dt in DTYPES.items():
        # test_kernels.py's grid and tolerances (weights scaled by 0.1)
        base = 2e-5 if dt == torch.float32 else 2e-2
        for xs, k, cout, s in CONV_GRID:
            conv_case(xs, (k, k, k, xs[-1], cout), s, ((0, 0),) * 3, dt, 0.1,
                      lambda want: base * (
                          1 + want.float().abs().max().item()), "grid")
        # every conv of cosmoflow-128 at batch 4, He-scaled weights. fp32:
        # kernel and plain version sum the same k^3*Cin products in another
        # order, an error growing like sqrt(k^3*Cin) * 6e-8 of the output
        # scale — 1e-6 * sqrt(k^3*Cin) leaves a wide margin. bf16: both
        # round the same fp32 sum once, so they differ by at most one bf16
        # ulp, 2^-7 of the largest output.
        for xs, ws, s, pads in conv_shapes:
            kc = math.prod(ws[:4])
            rel = 1e-6 * math.sqrt(kc) if dt == torch.float32 else 2 ** -7
            err = conv_case(
                xs, ws, s, pads, dt, math.sqrt(2.0 / kc),
                lambda want, rel=rel: rel * max(
                    1.0, want.float().abs().max().item()), "cosmoflow-128")
            if dt == torch.float32:
                worst["conv3d"] = max(worst["conv3d"], err)
    bn_shapes = BN_GRID + [conv_ref.output_shape(xs, ws, s, pads)
                           for xs, ws, s, pads in conv_shapes]
    for name, dt in DTYPES.items():
        for shape in bn_shapes:
            c = shape[-1]
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            mean, scale, bias = (torch.randn(c, generator=g, device="cuda")
                                 for _ in range(3))
            var = F.softplus(torch.randn(c, generator=g, device="cuda"))
            for slope in (0.01, 1.0):
                got = bn_ops.bn_leaky_relu(x, mean, var, scale, bias,
                                           negative_slope=slope)
                torch.cuda.synchronize()
                want = bn_ref.bn_leaky_relu(x, mean, var, scale, bias,
                                            negative_slope=slope)
                err = max_err(got, want)
                # elementwise, fp32 math in both: 2e-5 (test_kernels.py);
                # bf16 rounds once: half an ulp, within 2^-8 of |y|
                tol = (2e-5 * (1 + want.float().abs().max().item())
                       if dt == torch.float32 else
                       2 ** -8 * max(1.0, want.float().abs().max().item()))
                check(err <= tol, f"bn_act {shape} {dt} slope {slope}: err "
                      f"{err} > tol {tol}")
                rows.append(("bn_act", "grid+cosmoflow-128", shape, str(dt),
                             err, tol))
                if dt == torch.float32 and shape in bn_shapes[len(BN_GRID):]:
                    worst["bn_act"] = max(worst["bn_act"], err)
    log("kernels", f"ok: {len(rows)} comparisons; worst fp32 error at the "
        f"main path's shapes {worst}")
    return {"worst_fp32_main": worst, "cases": rows}


def halo_cases(cosmoflow, plan_lib, part, cfgs) -> list:
    """(shard input shape, lo, hi) of every depth-split conv of the
    spatial configs, and the extra cases, each once."""
    cases = set(HALO_EXTRA)
    for name, batch, S, _, kind in SPATIAL:
        cfg = cfgs[name]
        plan = spatial_plan(plan_lib, part, cfg, S, kind)
        cases |= {(sc.shape, sc.lo, sc.hi)
                  for sc in cosmoflow.split_convs(cfg, plan, batch)}
    return sorted(cases)


def spatial_plan(plan_lib, part, cfg, S, kind):
    n = len(cfg.conv_channels)
    if kind == "fixed":
        return plan_lib.legacy_convnet_plan(cfg, part, (S, 1, 1))
    return plan_lib.ParallelPlan(
        (plan_lib.Stage(0, n, ("model", None, None)),
         plan_lib.Stage(n, n + 1, (None, None, None))),
        (("data", 1), ("model", S)), n + 1, name="deep")


def phase_halo_kernels(pack_ops, pack_ref, cases) -> dict:
    """pack and unpack against their plain versions, bit for bit; the
    largest absolute difference seen is kept for the summary."""
    g = torch.Generator(device="cuda").manual_seed(4)
    n_cmp = 0
    worst = {"pack": 0.0, "unpack": 0.0}
    for dt in DTYPES.values():
        for shape, lo, hi in cases:
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            got = pack_ops.pack(x, lo, hi)
            n, _, h, w, c = shape
            bufs = [torch.randn((n, k, h, w, c), generator=g,
                                device="cuda").to(dt) if k else None
                    for k in (lo, hi)]
            out = pack_ops.unpack(x, *bufs)
            torch.cuda.synchronize()
            for name, a, b in (("pack", got.buf, pack_ref.pack(x, lo, hi).buf),
                               ("unpack", out, pack_ref.unpack(x, *bufs))):
                check(a.shape == b.shape, f"{name} {shape} lo={lo} hi={hi} "
                      f"{dt}: shape {tuple(a.shape)} != {tuple(b.shape)}")
                worst[name] = max(worst[name], max_err(a, b))
                check(torch.equal(a, b),
                      f"{name} {shape} lo={lo} hi={hi} {dt} differs")
            n_cmp += 2
            del x, got, bufs, out
    log("kernels", f"halo_pack ok: {n_cmp} comparisons over {len(cases)} "
        f"shapes x {len(DTYPES)} dtypes, all bit-exact; largest abs "
        f"difference {worst}")
    return {"comparisons": n_cmp, "max_abs_err": worst,
            "cases": [list(map(str, c)) for c in cases]}


@contextlib.contextmanager
def plain_versions(k):
    """Route the forward through the plain versions (for comparison)."""
    with mock.patch.object(k.conv_ops, "conv3d_valid",
                           k.conv_ref.conv3d_valid), \
            mock.patch.object(k.bn_ops, "bn_leaky_relu",
                              k.bn_ref.bn_leaky_relu), \
            mock.patch.object(k.pack_ops, "pack", k.pack_ref.pack), \
            mock.patch.object(k.pack_ops, "unpack", k.pack_ref.unpack):
        yield


def wrappers(k) -> dict:
    return {"conv3d": k.conv_ops.conv3d_valid,
            "bn_act": k.bn_ops.bn_leaky_relu,
            "pack": k.pack_ops.pack, "unpack": k.pack_ops.unpack}


def counts(k) -> dict:
    return {name: fn.launches for name, fn in wrappers(k).items()}


def zero_counts(k) -> None:
    for fn in wrappers(k).values():
        fn.launches = 0


def delta(after: dict, before: dict) -> dict:
    return {n: after[n] - before[n] for n in KERNELS}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def serve_and_compare(sess, x, k, rel, tag, expect):
    """One predict: its launches equal ``expect``, its output finite and
    within ``rel`` of the same forward through the plain versions."""
    c0 = counts(k)
    pred = sess.predict(x)
    torch.cuda.synchronize()
    c1 = counts(k)
    check(delta(c1, c0) == expect, f"{tag}: launches per forward "
          f"{delta(c1, c0)}, expected {expect}")
    check(tuple(pred.shape) == (x.shape[0], sess.cfg.out_dim),
          f"{tag}: prediction shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred).all()), f"{tag}: non-finite predictions")
    with plain_versions(k):
        want = sess.predict(x)
    torch.cuda.synchronize()
    check(counts(k) == c1, f"{tag}: the plain forward launched a kernel")
    err = rel_err(pred, want)
    check(err <= rel, f"{tag}: kernel forward vs plain forward {err} > {rel}")
    return pred, err


def halo_rows(k, cases, reps) -> dict:
    """pack and unpack at each (shape, lo, hi, dtype): kernel, plain
    version and library call (one ``torch.cat`` of the same views), each
    timed as device time per call (``queued_ms``: one call alone is
    shorter than its launch), and the byte bound (each input read once,
    each output written once)."""
    gt = torch.Generator(device="cuda").manual_seed(5)
    rows = {"pack": {}, "unpack": {}}
    for shape, lo, hi, prec in cases:
        dt = DTYPES[prec]
        x = torch.randn(shape, generator=gt, device="cuda").to(dt)
        n, d, h, w, c = shape
        face = n * (lo + hi) * h * w * c * x.element_size()
        nxt, prv = x[:, d - lo:], x[:, :hi]
        bufs = [torch.randn((n, m, h, w, c), generator=gt,
                            device="cuda").to(dt) if m else None
                for m in (lo, hi)]
        parts = [b for b in (bufs[0], x, bufs[1]) if b is not None]
        key = (tuple(shape), lo, hi, prec)
        rows["pack"][key] = {
            "x": list(shape), "lo": lo, "hi": hi, "dtype": prec,
            "ms": queued_ms(lambda: k.pack_ops.pack(x, lo, hi), reps),
            "plain_ms": queued_ms(lambda: k.pack_ref.pack(x, lo, hi),
                                  reps),
            "library_ms": queued_ms(lambda: torch.cat((nxt, prv), 1),
                                    reps),
            "bound_ms": 2 * face / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        rows["unpack"][key] = {
            "x": list(shape), "lo": lo, "hi": hi, "dtype": prec,
            "ms": queued_ms(lambda: k.pack_ops.unpack(x, *bufs), reps),
            "plain_ms": queued_ms(lambda: k.pack_ref.unpack(x, *bufs),
                                  reps),
            "library_ms": queued_ms(lambda: torch.cat(parts, 1), reps),
            "bound_ms": 2 * (face + x.numel() * x.element_size())
            / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        for name in ("pack", "unpack"):
            log("timings", f"{name} " + json.dumps(rows[name][key]))
        del x, nxt, prv, bufs, parts
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement as JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.api import RunConfig, compile
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.kernels import _build
    from repro_torch.kernels.bn_act import ops as bn_ops
    from repro_torch.kernels.bn_act import ref as bn_ref
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.conv3d import ref as conv_ref
    from repro_torch.kernels.halo_pack import ops as pack_ops
    from repro_torch.kernels.halo_pack import ref as pack_ref
    from repro_torch.models import cosmoflow

    t_start = time.perf_counter()
    k = argparse.Namespace(conv_ops=conv_ops, conv_ref=conv_ref,
                           bn_ops=bn_ops, bn_ref=bn_ref, pack_ops=pack_ops,
                           pack_ref=pack_ref)
    report = {"card": phase_card()}
    report["build"] = phase_build(_build)
    cf128, cf512 = get_config("cosmoflow-128"), get_config("cosmoflow-512")
    cfgs = {"cosmoflow-128": cf128, "cosmoflow-512": cf512}
    depth = SpatialPartitioning(("model", None, None))
    shapes128 = cosmoflow.conv_shapes(cf128, 4)
    report["kernels"] = phase_kernels(conv_ops, conv_ref, bn_ops, bn_ref,
                                      shapes128)
    report["halo_kernels"] = phase_halo_kernels(
        pack_ops, pack_ref, halo_cases(cosmoflow, plan_lib, depth, cfgs))

    # ------------------------------------------- main path 1: 4-6 ----
    n128, n512 = cosmoflow.num_blocks(cf128), cosmoflow.num_blocks(cf512)
    g = torch.Generator(device="cuda").manual_seed(1)
    x128 = torch.randn((4, 128, 128, 128, 4), generator=g, device="cuda")
    zero_counts(k)
    forwards = 0
    sessions = {}
    preds = {}
    serve = {}
    for prec, rel in (("fp32", 1e-4), ("bf16", 5e-2)):
        sess = compile(RunConfig(model="cosmoflow-128", mode="infer",
                                 global_batch=4, precision=prec))
        check(sess.device.type == "cuda", "session not on the card")
        expect = dict(conv3d=n128, bn_act=n128, pack=0, unpack=0)
        preds[("cosmoflow-128", prec)], err = serve_and_compare(
            sess, x128, k, rel, f"cosmoflow-128 {prec}", expect)
        forwards += 1
        sessions[prec] = sess
        serve[f"cosmoflow-128/{prec}"] = {"rel_err_vs_plain": err,
                                          "tol": rel}
        log("serve", f"cosmoflow-128 {prec} batch 4: {n128} conv3d + {n128} "
            f"bn_act launches; vs plain forward {err:.3g} <= {rel}")

    x512 = torch.randn((1, 512, 512, 512, 4), generator=g, device="cuda")
    sess512 = compile(RunConfig(model="cosmoflow-512", mode="infer",
                                global_batch=1, precision="fp32"))
    torch.cuda.reset_peak_memory_stats()
    c0 = counts(k)
    pred512 = sess512.predict(x512)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(delta(counts(k), c0) == dict(conv3d=n512, bn_act=n512, pack=0,
                                       unpack=0),
          "cosmoflow-512: launches per forward")
    check(tuple(pred512.shape) == (1, 4)
          and bool(torch.isfinite(pred512).all()), "cosmoflow-512 output")
    forwards += 1
    preds[("cosmoflow-512", "fp32")] = pred512
    with plain_versions(k):
        want512 = sess512.predict(x512)
    err512 = rel_err(pred512, want512)
    check(err512 <= 1e-4, f"cosmoflow-512 vs plain forward {err512}")
    del want512
    serve["cosmoflow-512/fp32"] = {"rel_err_vs_plain": err512, "tol": 1e-4,
                                   "peak_bytes": peak}
    log("serve512", f"cosmoflow-512 fp32 batch 1: finite "
        f"{tuple(pred512.shape)}; vs plain forward {err512:.3g}; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)")

    sess = sessions["fp32"]
    reqs = np.random.default_rng(2).standard_normal(
        (16, 128, 128, 128, 4), dtype=np.float32)
    with sess.serve(max_batch=4, max_wait_ms=50) as h:
        futs = h.submit_many(list(reqs))
        rows = [f.result(timeout=300) for f in futs]
    check(all(r.shape == (4,) and np.all(np.isfinite(r)) for r in rows),
          "harness replies")
    tele = sess.telemetry()
    check(tele["serve.requests"] == 16 and tele["serve.worker_failures"] == 0,
          f"harness telemetry {tele}")
    forwards += int(tele["serve.batches"])
    log("harness", f"16/16 futures resolved; telemetry {json.dumps(tele)}")

    launches = counts(k)
    check(launches == dict(conv3d=7 * forwards, bn_act=7 * forwards, pack=0,
                           unpack=0),
          f"{launches} launches on the unsharded path, expected 7 conv3d "
          f"and 7 bn_act per forward x {forwards} forwards")
    log("main path", f"unsharded: {forwards} forwards; launches {launches}")
    main_paths = {"unsharded": {"forwards": forwards, "launches": launches}}

    # ------------------------------------------- main path 2: 7-8 ----
    zero_counts(k)
    expected = dict.fromkeys(KERNELS, 0)
    spatial = {}
    spatial_sessions = {}
    for name, batch, S, prec, kind in SPATIAL:
        cfg = cfgs[name]
        tag = f"{name}/{prec}/S{S}/{kind}"
        plan = "fixed" if kind == "fixed" else spatial_plan(
            plan_lib, depth, cfg, S, kind)
        sess = compile(RunConfig(model=name, mode="infer",
                                 global_batch=batch, precision=prec,
                                 spatial=S, plan=plan),
                       devices=["cuda:0"] * S)
        check(sess.mesh.shape == {"data": 1, "model": S}
              and len(set(map(id, (sess.mesh.stream(r)
                                   for r in range(S))))) == S,
              f"{tag}: mesh {sess.mesh}")
        x = x128 if name == "cosmoflow-128" else x512
        per_fwd = cosmoflow.kernel_launches(cfg, sess.plan)
        if name == "cosmoflow-512":
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        rel_plain = 1e-4 if prec == "fp32" else 5e-2
        pred, err_plain = serve_and_compare(sess, x, k, rel_plain, tag,
                                            per_fwd)
        for kname in KERNELS:
            expected[kname] += per_fwd[kname]
        row = {"launches_per_forward": per_fwd,
               "rel_err_vs_plain": err_plain, "tol_vs_plain": rel_plain}
        if name == "cosmoflow-512":
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            row["resident_bytes_before"] = resident
        tol = 1e-5 if prec == "fp32" else 5e-2
        err = rel_err(pred, preds[(name, prec)])
        check(err <= tol, f"{tag}: vs the unsharded forward {err} > {tol}")
        row.update(rel_err_vs_unsharded=err, tol_vs_unsharded=tol)
        spatial[tag] = row
        spatial_sessions[tag] = (sess, x)
        log("spatial", f"{tag} batch {batch}: launches {json.dumps(per_fwd)}"
            f"; vs unsharded {err:.3g} <= {tol}; vs plain {err_plain:.3g}"
            + (f"; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB "
               f"({resident / 2 ** 30:.2f} GiB resident before)"
               if "peak_bytes" in row else ""))

    sess2 = spatial_sessions["cosmoflow-128/fp32/S2/fixed"][0]
    with sess2.serve(max_batch=4, max_wait_ms=50) as h:
        rows = [f.result(timeout=300) for f in h.submit_many(list(reqs[:8]))]
    check(all(r.shape == (4,) and np.all(np.isfinite(r)) for r in rows),
          "spatial harness replies")
    tele2 = sess2.telemetry()
    check(tele2["serve.requests"] == 8 and tele2["serve.worker_failures"] == 0,
          f"spatial harness telemetry {tele2}")
    per_fwd = spatial["cosmoflow-128/fp32/S2/fixed"]["launches_per_forward"]
    for kname in KERNELS:
        expected[kname] += per_fwd[kname] * int(tele2["serve.batches"])
    log("harness", f"spatial S=2: 8/8 futures resolved; telemetry "
        f"{json.dumps(tele2)}")
    got = counts(k)
    check(got == expected, f"spatial path launches {got}, derived from the "
          f"plans {expected}")
    check(got["pack"] > 0 and got["unpack"] > 0, "pack/unpack never ran")
    log("main path", f"spatial: launches {got} = derived from the plans")
    main_paths["spatial"] = {"launches": got, "expected": expected}
    launches = {n: main_paths["unsharded"]["launches"][n] + got[n]
                for n in KERNELS}

    # ------------------------------------------------------- timings ----
    timing = {"conv3d": [], "bn_act": []}
    log("timings", PEAKS_USED)
    gt = torch.Generator(device="cuda").manual_seed(3)
    for cfg, batch, prec, reps in ((cf128, 4, "fp32", 5),
                                   (cf128, 4, "bf16", 3),
                                   (cf512, 1, "fp32", 2)):
        dt = DTYPES[prec]
        for i, (xs, ws, s, pads) in enumerate(cosmoflow.conv_shapes(cfg,
                                                                    batch)):
            x = torch.randn(xs, generator=gt, device="cuda").to(dt)
            w = (torch.randn(ws, generator=gt, device="cuda") * 0.05).to(dt)
            y = conv_ops.conv3d_valid(x, w, s, pads)
            flops, nbytes = conv_work(xs, ws, tuple(y.shape), dt)
            b_ms, b_by = bound(flops, nbytes, dt)
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
            (pd, qd), (ph, qh), (pw, qw) = pads
            lib = (lambda: F.conv3d(xc, wc, stride=s, padding=pd)) \
                if (pd, ph, pw) == (qd, qh, qw) else \
                (lambda: F.conv3d(F.pad(xc, (pw, qw, ph, qh, pd, qd)), wc,
                                  stride=s))
            row = {"config": cfg.name, "batch": batch, "dtype": prec,
                   "layer": i, "x": list(xs), "w": list(ws), "stride": s,
                   "ms": median_ms(lambda: conv_ops.conv3d_valid(
                       x, w, s, pads), reps),
                   "plain_ms": median_ms(lambda: conv_ref.conv3d_valid(
                       x, w, s, pads), reps),
                   "library_ms": median_ms(lib, reps),
                   "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9}
            timing["conv3d"].append(row)
            log("timings", "conv3d " + json.dumps(row))
            c = ws[4]
            yv = torch.randn(y.shape, generator=gt, device="cuda").to(dt)
            del x, y
            vec = [torch.randn(c, generator=gt, device="cuda")
                   for _ in range(4)]
            vec[1] = F.softplus(vec[1])
            nbytes = 2 * yv.numel() * yv.element_size() + 16 * c
            b_ms, b_by = bound(5.0 * yv.numel(), nbytes, dt)
            row = {"config": cfg.name, "batch": batch, "dtype": prec,
                   "layer": i, "x": list(yv.shape),
                   "ms": median_ms(lambda: bn_ops.bn_leaky_relu(yv, *vec),
                                   reps),
                   "plain_ms": median_ms(lambda: bn_ref.bn_leaky_relu(
                       yv, *vec), reps),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            timing["bn_act"].append(row)
            log("timings", "bn_act " + json.dumps(row))
            del yv
    # pack and unpack at every shape the spatial path gave them
    halo_keys = set()
    for name, batch, S, prec, kind in SPATIAL:
        for sc in cosmoflow.split_convs(
                cfgs[name], spatial_plan(plan_lib, depth, cfgs[name], S,
                                         kind), batch):
            halo_keys.add((sc.shape, sc.lo, sc.hi, prec))
    halo = halo_rows(k, sorted(halo_keys), 20)
    timing["pack"] = list(halo["pack"].values())
    timing["unpack"] = list(halo["unpack"].values())

    e2e = {
        "cosmoflow-128/fp32/b4": host_ms(lambda: sessions["fp32"].predict(
            x128), 5),
        "cosmoflow-128/bf16/b4": host_ms(lambda: sessions["bf16"].predict(
            x128), 5),
        "cosmoflow-512/fp32/b1": host_ms(lambda: sess512.predict(x512), 2),
    }
    for tag, (sess, x) in spatial_sessions.items():
        e2e[tag] = host_ms(lambda: sess.predict(x),
                           2 if tag.startswith("cosmoflow-512") else 5)
    log("timings", f"end-to-end predict ms per batch {json.dumps(e2e)}")
    # the two conv lowerings against each other: each legacy fp32 spatial
    # session (overlapped) and the same config compiled with
    # overlap_halo=False (blocking), timed overlapped, blocking,
    # blocking, overlapped, before any profiler has run
    lowering, blocking = {}, {}
    for tag in ("cosmoflow-128/fp32/S2/fixed", "cosmoflow-128/fp32/S4/fixed",
                "cosmoflow-512/fp32/S4/fixed"):
        sess, x = spatial_sessions[tag]
        name, S = tag.split("/")[0], int(tag.split("/")[2][1:])
        blk = compile(RunConfig(model=name, mode="infer",
                                global_batch=x.shape[0], precision="fp32",
                                spatial=S, plan="fixed", overlap_halo=False),
                      devices=["cuda:0"] * S)
        err = rel_err(blk.predict(x), preds[(name, "fp32")])
        check(err <= 1e-5, f"{tag} blocking: vs the unsharded forward {err}")
        reps = 2 if name == "cosmoflow-512" else 5
        fns = (lambda: sess.predict(x), lambda: blk.predict(x))
        t = [host_ms(fns[i], reps) for i in (0, 1, 1, 0)]
        lowering[tag] = {"overlap_ms": [t[0], t[3]],
                         "blocking_ms": [t[1], t[2]],
                         "blocking_rel_err_vs_unsharded": err}
        blocking[tag] = blk
        log("timings", f"lowering {tag} {json.dumps(lowering[tag])}")
    profiles = {
        "cosmoflow-128/fp32/b4": device_profile(
            lambda: sessions["fp32"].predict(x128)),
        "cosmoflow-512/fp32/b1": device_profile(
            lambda: sess512.predict(x512)),
    }
    for tag, blk in blocking.items():
        sess, x = spatial_sessions[tag]
        profiles[tag] = device_profile(lambda: sess.predict(x))
        profiles[tag + "/blocking"] = device_profile(lambda: blk.predict(x))
    for key, prof in profiles.items():
        log("profile", f"{key} {json.dumps(prof)}")
    for s in (*sessions.values(), sess512, *blocking.values(),
              *(v[0] for v in spatial_sessions.values())):
        s.close()

    # the summary: one forward's worth of each kernel at its main path's
    # first config — cosmoflow-128 batch-4 fp32: conv3d and bn_act of the
    # unsharded forward (7 calls each), pack of the S=2 forward (4 blocks
    # x 2 shards), unpack of the S=2 forward that splits all 7 blocks
    # (blocks 4-6 x 2 shards)
    def total(rows, key):
        sel = [r[key] for r in rows if r["config"] == "cosmoflow-128"
               and r["dtype"] == "fp32"]
        return None if any(v is None for v in sel) else sum(sel)

    def halo_total(name, kind, key):
        plan = spatial_plan(plan_lib, depth, cf128, 2, kind)
        return sum(2 * halo[name][(sc.shape, sc.lo, sc.hi, "fp32")][key]
                   for sc in cosmoflow.split_convs(cf128, plan, 4)
                   if name == "pack" or sc.no_interior)

    summary = []
    for name, kname, src, replaces in (
            ("conv3d", "conv3d_valid", "src/repro_torch/csrc/conv3d.cu",
             "src/repro/kernels/conv3d/kernel.py:43"),
            ("bn_act", "bn_leaky_relu", "src/repro_torch/csrc/bn_act.cu",
             "src/repro/kernels/bn_act/kernel.py:31"),
            ("pack", "pack_depth", "src/repro_torch/csrc/halo_pack.cu",
             "src/repro/kernels/halo_pack/kernel.py:26"),
            ("unpack", "unpack_depth", "src/repro_torch/csrc/halo_pack.cu",
             "src/repro/kernels/halo_pack/kernel.py:69")):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name]}
        if name in ("pack", "unpack"):
            kind = "fixed" if name == "pack" else "deep"
            entry.update(
                max_abs_err=report["halo_kernels"]["max_abs_err"][name],
                **{key: halo_total(name, kind, key) for key in
                   ("ms", "plain_ms", "bound_ms", "library_ms")},
                bound_by="bytes")
        else:
            rows = timing[name]
            by = {r["bound_by"] for r in rows
                  if r["config"] == "cosmoflow-128" and r["dtype"] == "fp32"}
            entry.update(
                max_abs_err=report["kernels"]["worst_fp32_main"][name],
                ms=total(rows, "ms"), plain_ms=total(rows, "plain_ms"),
                bound_ms=total(rows, "bound_ms"),
                bound_by="operations" if "operations" in by else "bytes",
                library_ms=total(rows, "library_ms"))
        summary.append(entry)
    report.update(serve=serve, spatial=spatial, timing=timing, e2e_ms=e2e,
                  lowering=lowering, profile=profiles, bounds=PEAKS_USED,
                  main_paths=main_paths,
                  seconds=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log("done", f"all phases ok in {report['seconds']:.0f}s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
