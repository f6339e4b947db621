#!/usr/bin/env python3
"""Host time per call of the halo pack and unpack wrappers on one NVIDIA card.

    python3 scripts/halo_host_timing.py [--src DIR] [--calls 2000]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``;
to compare with another commit, unpack it with ``git archive`` into a
directory that ``.gitignore`` lists and point ``--src`` at its ``src``).
At every face of a cosmoflow-128 b4 S=2 fp32 forward (pack, the legacy
plan) and of the all-blocks S=2 forward (unpack, where a shard has no
interior), calls the wrapper ``--calls`` times back to back and prints
the host's wall time per call, in microseconds, as the median of three
rounds: the kernel takes ~2-3 us on the card, less than the host takes
to launch it, so the loop runs at the host's pace. Each is timed twice,
without autograd (serving) and with x requiring grad (training, through
the autograd Function). Prints the card's name and power limit first,
then one JSON line per face and a last line with the sums per forward.
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


def host_us(fn, calls: int) -> float:
    """Median over three rounds of the wall time per call of ``calls``
    calls of ``fn``, the card synchronized before and after."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(rounds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("halo_host_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.kernels.halo_pack import ops
    from repro_torch.models import cosmoflow

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    src = os.path.relpath(os.path.abspath(args.src), ROOT)
    cfg = get_config("cosmoflow-128")
    depth = SpatialPartitioning(("model", None, None))
    g = torch.Generator(device="cuda").manual_seed(0)
    sums = {}
    for kind, plan_kind in (("pack", "fixed"), ("unpack", "deep")):
        plan = cs.spatial_plan(plan_lib, depth, cfg, 2, plan_kind)
        for sc in cosmoflow.split_convs(cfg, plan, 4):
            if kind == "unpack" and not sc.no_interior:
                continue
            n, d, h, w, c = sc.shape
            x = torch.randn(sc.shape, generator=g, device="cuda")
            bufs = [torch.randn((n, m, h, w, c), generator=g, device="cuda")
                    if m else None for m in (sc.lo, sc.hi)]
            xg = x.clone().requires_grad_(True)
            if kind == "pack":
                calls = (lambda: ops.pack(x, sc.lo, sc.hi),
                         lambda: ops.pack(xg, sc.lo, sc.hi))
            else:
                calls = (lambda: ops.unpack(x, *bufs),
                         lambda: ops.unpack(xg, *bufs))
            r = {"src": src, "card": card, "kind": kind,
                 "x": list(sc.shape), "lo": sc.lo, "hi": sc.hi,
                 "host_us": host_us(calls[0], args.calls),
                 "host_us_autograd": host_us(calls[1], args.calls)}
            print(json.dumps(r), flush=True)
            tot = sums.setdefault(f"{kind} cosmoflow-128 b4 S=2 "
                                  f"{plan_kind}", {"calls": 0, "host_us": 0.0,
                                                   "host_us_autograd": 0.0})
            tot["calls"] += 2  # each face on each of the 2 shards
            tot["host_us"] += 2 * r["host_us"]
            tot["host_us_autograd"] += 2 * r["host_us_autograd"]
    print(json.dumps({"src": src, "card": card, "per_forward": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
