#!/usr/bin/env python3
"""Time design variants of the SSD scan kernel on one NVIDIA card.

    python3 scripts/ssd_variants.py [--reps 10]

Each variant is ``src/repro_torch/csrc/ssd_scan.cu`` with its tuning
constants rewritten: the heads that share C Bᵀ in the output pass
(``kHeads``), the blocks per SM its register cap allows
(``__launch_bounds__``), the chunk states the state pass loads at once
(``kCarry``) and the slab depth (``kDepth``). Every variant is built with
the port's own ``nvcc`` flags into ``build/ssd_variants/`` (one ``nvcc``
each, in parallel) and run at mamba2-370m's layer shape (B=4, L=4096,
H=32, P=64, N=128, chunk 256) in fp32 and bf16, in turns, twice: its time
per call (CUDA events, median), its time per launch of each of its three
kernels (one profiled call), and its largest difference from the variant
as built. Prints the card's name and power limit first, one JSON line
per measurement after.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 4096, 32, 64, 128, 256)  # B, L, H, P, N, chunk
BOUNDS = "__launch_bounds__(kThreads, 2)\nchunk_output_kernel"
# name -> {text in the source: its replacement}
VARIANTS = {
    "as built (2 heads, 2 blocks/SM, 8 carried, depth 32)": {},
    "4 heads, 1 block/SM (the first design)": {
        "constexpr int kHeads = 2;": "constexpr int kHeads = 4;",
        BOUNDS: "__launch_bounds__(kThreads, 1)\nchunk_output_kernel"},
    "4 heads, 2 blocks/SM": {
        "constexpr int kHeads = 2;": "constexpr int kHeads = 4;"},
    "2 heads, 1 block/SM": {
        BOUNDS: "__launch_bounds__(kThreads, 1)\nchunk_output_kernel"},
    "state pass one chunk at a time": {
        "constexpr int kCarry = 8;": "constexpr int kCarry = 1;"},
    "slab depth 64": {
        "constexpr int kDepth = 32;": "constexpr int kDepth = 64;"},
}


def build(build_lib, out_dir):
    src = open(os.path.join(build_lib.CSRC, "ssd_scan.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (so, subprocess.Popen(
            [build_lib.nvcc_path(), *build_lib.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                       if "registers" in line})
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def entry(lib, dtype):
    fn = getattr(lib, "ssd_scan_f32" if dtype == torch.float32 else "ssd_scan_bf16")
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(_build, os.path.join(ROOT, "build", "ssd_variants"))
    B, L, H, P, N, Q = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt)
        d = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")).to(dt)
        A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.5)
        Bm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
        Cm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
        y = torch.empty_like(x)
        state = torch.empty((B, H, P, N), device="cuda")
        states = torch.empty((B, L // Q, H, P, N), device="cuda")
        decay = torch.empty((B, L // Q, H), device="cuda")
        built = None
        for name in list(VARIANTS) * 2:
            fn = entry(libs[name], dt)

            def call():
                err = fn(x.data_ptr(), d.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                         Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                         states.data_ptr(), decay.data_ptr(), B, L, H, P, N, Q,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            if built is None:
                built = y.clone()
            diff = (y.float() - built.float()).abs().max().item()
            times = []
            for _ in range(args.reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            per = {}
            for e in prof.events():
                m = re.search(r"(\w+_kernel)", e.name)
                if e.device_type.name == "CUDA" and m:
                    per[m.group(1)] = (e.time_range.end
                                       - e.time_range.start) / 1e3
            print(json.dumps({"variant": name, "dtype": str(dt).split(".")[1],
                              "ms": statistics.median(times),
                              "ms_by_kernel": per,
                              "max_abs_diff_vs_built": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
