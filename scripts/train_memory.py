#!/usr/bin/env python3
"""Where a training step's peak device memory lies, on one NVIDIA card.

    python3 scripts/train_memory.py [--out FILE]

For each of cosmoflow-512 b1 and b2 and unet3d-256 b1, each without
and with every stage rematerialized (fp32, seeded input, in a fresh
session after the cached memory is released), records the caching
allocator's history over one step
(``torch.cuda.memory._record_memory_history``) and prints one JSON
line: the peak of allocated bytes it replays (and
``max_memory_allocated`` / ``max_memory_reserved``), the blocks alive
at that peak grouped by the first three frames of ``repro_torch`` that
allocated them (file:line), largest first, and the host time of a
second step, recording off, with the loss read (``step_ms``). A step
that runs out of memory is reported with what was alive when it did.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
GIB = 2 ** 30
RUNS = (("cosmoflow-512", 1, False), ("cosmoflow-512", 1, True),
        ("cosmoflow-512", 2, False), ("cosmoflow-512", 2, True),
        ("unet3d-256", 1, False), ("unet3d-256", 1, True))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def live_at_peak(trace, top: int):
    """(peak bytes, [(frames, blocks, bytes)]) of the blocks the
    allocator's trace holds at its highest point."""
    cur = best = 0
    at = -1
    sizes = {}
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            sizes[ev["addr"]] = ev["size"]
            cur += ev["size"]
        elif ev["action"] == "free_completed" and ev["addr"] in sizes:
            cur -= sizes.pop(ev["addr"])
        if cur > best:
            best, at = cur, i
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = {}
    for ev in live.values():
        frames = [f for f in ev.get("frames", [])
                  if "repro_torch" in f["filename"]]
        key = " < ".join(f"{os.path.relpath(f['filename'], ROOT)}:"
                         f"{f['line']}" for f in frames[:3]) or "(other)"
        n, b = groups.get(key, (0, 0))
        groups[key] = (n + 1, b + ev["size"])
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return best, [(key, n, b) for key, (n, b) in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import RunConfig, compile
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning

    name = card()
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for model, batch, remat in RUNS:
        cfg = get_config(model)
        plan = plan_lib.legacy_convnet_plan(
            cfg, SpatialPartitioning(("model", None, None)))
        plan = dataclasses.replace(plan, stages=tuple(
            dataclasses.replace(st, remat=remat) for st in plan.stages))
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:  # cuBLAS's workspaces pin cached segments
            clear()
        torch.cuda.empty_cache()
        w = cfg.input_width
        x = torch.randn((batch, w, w, w, cfg.in_channels), generator=g,
                        device="cuda")
        y = (torch.randint(0, cfg.out_dim, (batch, w, w, w), generator=g,
                           device="cuda") if cfg.arch == "unet3d" else
             torch.randn((batch, cfg.out_dim), generator=g, device="cuda"))
        sess = compile(RunConfig(model=cfg, mode="train",
                                 global_batch=batch, plan=plan))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=400_000,
                                                 stacks="python")
        oom = None
        try:
            sess.step(x, y).item()
        except torch.OutOfMemoryError as e:
            oom = str(e).splitlines()[0][:300]
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        peak, live = live_at_peak(snap["device_traces"][0], args.top)
        step_ms = None
        if oom is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.step(x, y).item()
            step_ms = (time.perf_counter() - t0) * 1e3
        row = {"model": model, "batch": batch, "remat": remat, "card": name,
               "resident_gib": before / GIB,
               "step_peak_gib": (before + peak) / GIB,
               "max_allocated_gib": torch.cuda.max_memory_allocated() / GIB,
               "max_reserved_gib": torch.cuda.max_memory_reserved() / GIB,
               "oom": oom, "step_ms": step_ms,
               "live_at_peak_gib": [(k, n, b / GIB) for k, n, b in live]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        sess.close()
        del sess, x, y, snap
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
