#!/usr/bin/env python3
"""Where the time of a sharded CosmoFlow training step goes, on one
NVIDIA card, every shard on that card.

    python3 scripts/spatial_train_timing.py [--src DIR] [--reps 5]
        [--profile]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so that two commits can be timed in one call on one card: run
it with ``--src`` pointing at an unpacked copy of the other commit, in
turns (parent, change, change, parent). On cosmoflow-128 batch 4 fp32,
seeded inputs, it prints one JSON line each for: ``predict`` at S = 1, 2
and 4 (host clock around predict + synchronize, median of ``--reps``
after a warm-up), the training step unsharded and, where the source
trains over a mesh, at 1 x 2, 1 x 4 and 2 x 2 (the same clock), with
the kernels' launches per step. ``--profile`` adds, for the unsharded
and the 1 x 2 step, one step and one forward (the train step's ``fwd``
probe) under ``torch.profiler``: the device's busy time and idle share,
and the ten operators with the most host time (self CPU time, every
thread). Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))


def host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:10]
    return {"wall_ms": wall, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e3 / wall,
            "host_self_ms_top10": [list(r) for r in host]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spatial_train_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.api import RunConfig, RunConfigError, compile
    from repro_torch.kernels.bn_act import ops as bn_ops
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.halo_pack import ops as pack_ops
    from repro_torch.train import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"conv3d": conv_ops.conv3d_valid,
                "conv3d_dgrad": conv_ops.conv3d_input_grad,
                "bn_act": bn_ops.bn_leaky_relu, "pack": pack_ops.pack,
                "unpack": pack_ops.unpack}

    def counts():
        return {k: f.launches for k, f in wrappers.items()}

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 128, 128, 128, 4), generator=g, device="cuda")
    y = torch.randn((4, 4), generator=g, device="cuda")
    tag = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
           "card": card}
    for S in (1, 2, 4):
        sess = compile(RunConfig(model="cosmoflow-128", mode="infer",
                                 global_batch=4, spatial=S),
                       devices=["cuda:0"] * S)
        print(json.dumps(dict(tag, what="predict", spatial=S,
                              ms=host_ms(lambda: sess.predict(x),
                                         args.reps))), flush=True)
        sess.close()
    for D, S in MESHES:
        try:
            sess = compile(RunConfig(model="cosmoflow-128", mode="train",
                                     global_batch=4, data=D, spatial=S),
                           devices=["cuda:0"] * (D * S))
        except RunConfigError as e:
            print(json.dumps(dict(tag, what="train", data=D, spatial=S,
                                  ms=None, error=str(e))), flush=True)
            continue
        c0 = counts()
        sess.step(x, y)
        torch.cuda.synchronize()
        per_step = {k: v - c0[k] for k, v in counts().items()}
        row = dict(tag, what="train", data=D, spatial=S,
                   ms=host_ms(lambda: sess.step(x, y), args.reps),
                   launches_per_step=per_step)
        if args.profile and (D, S) in ((1, 1), (1, 2)):
            row["profile"] = profile(lambda: sess.step(x, y))
            fwd = train_step.make_convnet_phase_probes(
                sess.cfg, sess.mesh, sess.optimizer, global_batch=4,
                plan=sess.plan)["fwd"]
            row["fwd_ms"] = host_ms(
                lambda: fwd(sess.params, sess.opt_state, x, y, 0), args.reps)
            row["fwd_profile"] = profile(
                lambda: fwd(sess.params, sess.opt_state, x, y, 0))
        print(json.dumps(row), flush=True)
        sess.close()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
