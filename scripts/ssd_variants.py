#!/usr/bin/env python3
"""Time design variants of the SSD scan kernel on one NVIDIA card.

    python3 scripts/ssd_variants.py [--reps 10] [--parent REV]

Each variant is ``src/repro_torch/csrc/ssd_scan.cu`` with its tuning
constants rewritten: the bf16 parts a computed operand is split into
(``kBf16Parts``), the heads a block of the output launch
serves (``kHeads``), the slab depth (``kDepth``), the chunk states the
state pass loads at once (``kCarry``), and the register caps of the first
and last launches (``__launch_bounds__``). One more variant
is the kernel of another commit: ``--parent REV`` writes ``git show
REV:src/repro_torch/csrc/ssd_scan.cu`` to
``build/ssd_variants/parent.cu`` (in a git checkout), and a
``parent.cu`` found there is built and timed beside the rest, with the
entry point of that commit's design (contiguous x, B, C; no C Bᵀ
scratch). Every variant is built with the port's own ``nvcc`` flags into
``build/ssd_variants/`` (one ``nvcc`` each, in parallel) and run at
mamba2-370m's layer shape (B=4, L=4096, H=32, P=64, N=128, chunk 256) in
fp32 and bf16, in turns, twice: its time per call (CUDA events, median),
its time per launch of each of its kernels (one profiled call), and its
largest difference from the variant as built. Prints the card's name and
power limit first, one JSON line per measurement after.
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
OUT_DIR = os.path.join(ROOT, "build", "ssd_variants")
SRC = "src/repro_torch/csrc/ssd_scan.cu"
SHAPE = (4, 4096, 32, 64, 128, 256)  # B, L, H, P, N, chunk
PARENT = "the parent commit's kernel"
# name -> {text in the source: its replacement}
VARIANTS = {
    "as built": {},
    "bf16: computed operands in two parts": {
        "constexpr int kBf16Parts = 3;": "constexpr int kBf16Parts = 2;"},
    "bf16: computed operands rounded once": {
        "constexpr int kBf16Parts = 3;": "constexpr int kBf16Parts = 1;"},
    "launch 3 serves two heads a block": {
        "constexpr int kHeads = 1;": "constexpr int kHeads = 2;",
        "__launch_bounds__(kThreadsOut, 3)": "__launch_bounds__(kThreadsOut, 1)"},
    "launch 3 at two blocks per SM": {
        "__launch_bounds__(kThreadsOut, 3)": "__launch_bounds__(kThreadsOut, 2)"},
    "slab depth 64": {
        "constexpr int kDepth = 32;": "constexpr int kDepth = 64;"},
    "state pass one chunk at a time": {
        "constexpr int kCarry = 8;": "constexpr int kCarry = 1;"},
    "launch 1 at one block per SM": {
        "__launch_bounds__(kThreads1, 2)": "__launch_bounds__(kThreads1, 1)"},
}


def sources(parent_rev):
    """{variant: source text}; the parent's from ``parent.cu``."""
    src = open(os.path.join(ROOT, SRC)).read()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    parent = os.path.join(OUT_DIR, "parent.cu")
    if parent_rev:
        text = subprocess.run(["git", "show", f"{parent_rev}:{SRC}"], cwd=ROOT,
                              capture_output=True, text=True, check=True).stdout
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(parent, "w") as f:
            f.write(text)
    if os.path.exists(parent):
        out[PARENT] = open(parent).read()
    return out


def build(build_lib, texts):
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(OUT_DIR, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT_DIR, f"v{i}.so")
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


def caller(lib, name, dtype, args, out):
    """A function that launches variant ``name`` once on ``args``."""
    fn = getattr(lib, "ssd_scan_f32" if dtype == torch.float32 else "ssd_scan_bf16")
    x, d, A, Bm, Cm = args
    B, L, H, P, N, Q = SHAPE
    y, state, states, decay, cb = out
    stream = torch.cuda.current_stream().cuda_stream
    if name == PARENT:  # contiguous x, B, C; no C Bᵀ scratch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        ptrs = (x, d, A, Bm, Cm, y, state, states, decay)
        tail = (B, L, H, P, N, Q, stream)
    else:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
                       + [ctypes.c_void_p])
        ptrs = (x, d, A, Bm, Cm, y, state, states, decay, cb)
        tail = (B, L, H, P, N, Q, L * H * P, H * P, L * N, N, stream)
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in ptrs]

    def call():
        err = fn(*ptrs, *tail)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", default=None,
                    help="git revision whose ssd_scan.cu to time beside")
    args = ap.parse_args()
    texts = sources(args.parent)
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(_build, texts)
    B, L, H, P, N, Q = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    f32 = dict(device="cuda", dtype=torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt)
        d = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")).to(dt)
        A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.5)
        Bm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
        Cm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
        out = (torch.empty_like(x), torch.empty((B, H, P, N), **f32),
               torch.empty((B, L // Q, H, P, N), **f32),
               torch.empty((B, L // Q, H), **f32),
               torch.empty((B, L // Q, Q, Q), **f32))
        y = out[0]
        built = None
        for name in list(libs) * 2:
            call = caller(libs[name], name, dt, (x, d, A, Bm, Cm), out)
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
