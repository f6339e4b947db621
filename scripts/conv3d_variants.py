#!/usr/bin/env python3
"""Time design variants of the implicit-GEMM conv3d kernel on one NVIDIA card.

    python3 scripts/conv3d_variants.py [--reps 5] [--config cosmoflow-128]
        [--only NAME | --beside NAME ...]

Each variant is ``src/repro_torch/csrc/conv3d.cu`` with a tuning constant
rewritten, or the wrapper's plan with another K split; every one is built
with the port's own ``nvcc`` flags into ``build/conv3d_variants/`` (one
``nvcc`` each, in parallel) and run through ``ops.conv3d_valid`` at every
conv layer of the config (batch 4 at 128^3, 1 at 512^3), fp32 and bf16:
its time per call (CUDA events around one call, median: what
``chip_smoke.py`` reports, host included), its device time per call (20
calls queued behind a spin kernel), and its largest difference from the
variant as built. The variant as built is also profiled once per layer
(device time of each of its kernels) and timed for the host alone, with
``F.conv3d`` (cuDNN, TF32 off) beside it. Prints the card's name and power
limit first, one JSON line per measurement after.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> ({text in the source: its replacement}, {plan constant: value})
IN_FLIGHT = ("      wgmma_wait_one();\n    }\n    __syncthreads();  // every warpgroup",
             "      wgmma_wait_all();\n    }\n    __syncthreads();  // every warpgroup")
FOUR_PRODUCTS = ("        mma_tf32_rs<BN>(part, lo[ks], bh);\n      }\n",
                 "        mma_tf32_rs<BN>(part, lo[ks], bh);\n"
                 "        mma_tf32_rs<BN>(part, lo[ks], bl);\n      }\n")
CARVEOUT = ("  return cudaFuncSetAttribute(kernel, "
            "cudaFuncAttributePreferredSharedMemoryCarveout,",
            "  return e;\n  return cudaFuncSetAttribute(kernel, "
            "cudaFuncAttributePreferredSharedMemoryCarveout,")
VARIANTS = {
    "as built": ({}, {}),
    "the gather kernel at every layer": ({}, {"PATCH_STAGES": ()}),
    "patch kernel, no wgmma group in flight": (dict([IN_FLIGHT]), {}),
    "patch kernel, ring of 2 stages": ({}, {"PATCH_STAGES": (2,)}),
    "patch kernel, ring of 3 stages": ({}, {"PATCH_STAGES": (3,)}),
    "patch kernel, 16-bit boxes 8 high": (
        {"kTiles = std::is_same<T, float>::value ? 1 : 2;": "kTiles = 1;"},
        {"BOX_H": {4: 8, 2: 8}}),
    "N tiles of at most 32 channels": ({}, {"N_TILES": (16, 32)}),
    "gather kernel, 4 stages": (
        {"constexpr int kStages = 3;": "constexpr int kStages = 4;"},
        {"PATCH_STAGES": ()}),
    "the default shared-memory carveout": (dict([CARVEOUT]), {}),
    "fp32 four products": (dict([FOUR_PRODUCTS]), {}),
}


def build(build_lib, out_dir):
    src = open(os.path.join(build_lib.CSRC, "conv3d.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = {}, {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (so, subprocess.Popen(
            [build_lib.nvcc_path(), *build_lib.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def entry_from(ops, lib):
    def _entry(dtype):
        fn = getattr(lib, ops._ENTRY[dtype])
        fn.argtypes = ops._ARGTYPES
        fn.restype = ctypes.c_int
        return fn
    return _entry


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
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


def queued_ms(fn, n=20):
    """Device time per call: ``n`` calls queued behind a spin kernel long
    enough for the host to enqueue them all."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_s * 2e9) + 100_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n=20):
    """Host time per call, the card kept busy behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


def kernel_ms(fn):
    """Device time of each kernel of one call (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "")
            key = key.split("(")[0].replace("void ", "")[:48]
            out[key] = out.get(key, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--config", default="cosmoflow-128",
                    choices=("cosmoflow-128", "cosmoflow-512"))
    ap.add_argument("--only", help="run this variant alone")
    ap.add_argument("--beside", action="append", default=[],
                    help="run this variant beside the one as built (and "
                    "no other); may repeat")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv3d_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv3d import ops
    from repro_torch.models import cosmoflow

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if args.only:
        VARIANTS.update({"as built": VARIANTS[args.only]})
        for name in list(VARIANTS)[1:]:
            del VARIANTS[name]
    elif args.beside:
        for name in list(VARIANTS)[1:]:
            if name not in args.beside:
                del VARIANTS[name]
    libs = build(_build, os.path.join(ROOT, "build", "conv3d_variants"))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    batch = 4 if args.config == "cosmoflow-128" else 1
    shapes = cosmoflow.conv_shapes(get_config(args.config), batch)
    g = torch.Generator(device="cuda").manual_seed(0)
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for layer, (xs, ws, s, pads) in enumerate(shapes):
            x = torch.randn(xs, generator=g, device="cuda").to(dt)
            w = (torch.randn(ws, generator=g, device="cuda")
                 * math.sqrt(2 / math.prod(ws[:4]))).to(dt)
            base = None
            for name, (_, consts) in VARIANTS.items():
                with mock.patch.object(ops, "_entry",
                                       entry_from(ops, libs[name])), \
                        (mock.patch.multiple(ops, **consts) if consts
                         else contextlib.nullcontext()):
                    ops._launch.cache_clear()  # plans of another variant
                    fn = lambda: ops.conv3d_valid(x, w, s, pads)  # noqa
                    y = fn()
                    if base is None:
                        base = y
                    row = {"variant": name, "config": args.config,
                           "dtype": prec, "layer": layer,
                           "ms": event_ms(fn, args.reps),
                           "device_ms": queued_ms(fn),
                           "max_diff_vs_built": (y.float() - base.float())
                           .abs().max().item()}
                    if name == "as built":
                        row["host_ms"] = host_ms(fn)
                        row["kernels_ms"] = kernel_ms(fn)
                        out = ops.ref.output_shape(xs, ws, s, pads)
                        p = ops.plan(xs, ws, out, dt, ops._sms(0),
                                     x.data_ptr(), s)
                        row["plan"] = {"bn": p.bn, "splits": p.splits,
                                       "vec": p.vec, "stages": p.stages}
                print(json.dumps(row), flush=True)
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
            (pd, qd), (ph, qh), (pw, qw) = pads
            lib = (lambda: F.conv3d(xc, wc, stride=s, padding=pd)) \
                if (pd, ph, pw) == (qd, qh, qw) else \
                (lambda: F.conv3d(F.pad(xc, (pw, qw, ph, qh, pd, qd)), wc,
                                  stride=s))
            print(json.dumps({"variant": "F.conv3d", "config": args.config,
                              "dtype": prec, "layer": layer,
                              "ms": event_ms(lib, args.reps),
                              "device_ms": queued_ms(lib)}), flush=True)
            del x, w, base
    return 0


if __name__ == "__main__":
    sys.exit(main())
