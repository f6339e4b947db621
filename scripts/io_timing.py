#!/usr/bin/env python3
"""Where the time of a training step fed by the input pipeline goes, on
one NVIDIA card, every shard on that card.

    python3 scripts/io_timing.py [--samples 16] [--steps 12]
        [--out FILE]

Writes ``--samples`` synthetic cosmoflow-128 volumes (4 x 128^3 fp32,
32 MiB each) to a temporary store, then, at 1 x 1 and 1 x 2 (batch 4,
fp32, seeded), prints one JSON line for each of:

* ``step``: the training step on a batch already on the card;
* ``load``: ``load_batch`` alone, then a synchronize, with the store
  read every time (``cache=False``) and from the distributed cache
  (``cache=True``, every batch after the first epoch), and its host time
  split into the store reads (``read_ms``: mmap'd hyperslab copies) and
  the copies into pinned buffers (``pin_ms``);
* ``step+load``: a step on each batch the loader gives, synchronous
  (``prefetch=0``) and prefetched (``prefetch=2``), cache off and on,
  with ``io_stall_s``.

Times are host clock around the work and a synchronize (the step reads
its loss), each the median over ``--steps`` calls after one warm-up
epoch. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Clock:
    """Host time spent in a function, summed over its calls."""

    def __init__(self, obj, name):
        self.total, fn = 0.0, getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.total += time.perf_counter() - t0

        setattr(obj, name, timed)


def batches(ld, steps, batch):
    """``steps`` batches of ids in schedule order, after the first
    epoch (the warm-up)."""
    n = ld.store.num_samples
    out = []
    while len(out) < steps + n // batch:
        order = ld.epoch_schedule()
        out += [order[i:i + batch] for i in range(0, n, batch)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("io_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import RunConfig, compile
    from repro_torch.configs import get_config
    from repro_torch.data import store, synthetic

    name = card()
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("cosmoflow-128")
    batch = 4
    rows = []
    with tempfile.TemporaryDirectory(prefix="io_timing_") as root:
        cubes, targets = synthetic.make_cosmology_dataset(
            args.samples, cfg.input_width, channels=cfg.in_channels, seed=0)
        store.write_dataset(root, cubes, targets)
        del cubes
        for S in (1, 2):
            def session(prefetch=0):
                return compile(RunConfig(model=cfg, mode="train",
                                         global_batch=batch, spatial=S,
                                         data_dir=root, prefetch=prefetch),
                               devices=["cuda:0"] * S)

            def emit(what, **kw):
                row = dict(what=what, mesh=f"1x{S}", card=name, **kw)
                rows.append(row)
                print(json.dumps(row), flush=True)

            sess = session()
            x, y = sess.make_loader(prefetch=0).load_batch(list(range(batch)))
            ms = []
            for i in range(args.steps + 1):
                t0 = time.perf_counter()
                sess.step(x, y).item()
                ms.append((time.perf_counter() - t0) * 1e3)
            emit("step", ms=statistics.median(ms[1:]))
            for cache in (False, True):
                ld = sess.make_loader(prefetch=0, cache=cache)
                read = Clock(ld.store, "read_hyperslab")
                pin = Clock(ld, "_put")
                ids = batches(ld, args.steps, batch)
                warm = len(ids) - args.steps
                ms = []
                for i, b in enumerate(ids):
                    if i == warm:
                        read.total = pin.total = 0.0
                    t0 = time.perf_counter()
                    ld.load_batch(b)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                emit("load", cache=cache, ms=statistics.median(ms[warm:]),
                     read_ms=read.total * 1e3 / args.steps,
                     pin_ms=pin.total * 1e3 / args.steps,
                     mib_per_batch=batch * cfg.input_width ** 3
                     * cfg.in_channels * 4 / 2 ** 20)
            sess.close()
            for prefetch in (0, 2):
                for cache in (False, True):
                    sess = session(prefetch)
                    ld = sess.make_loader(cache=cache)
                    ms = []
                    order, pos, taken = None, 0, 0
                    n = ld.store.num_samples
                    warm = n // batch
                    stall0 = 0.0
                    while taken < warm + args.steps:
                        if order is None or pos >= n:
                            order, pos = ld.epoch_schedule(), 0
                        if taken == warm:
                            stall0 = getattr(ld, "stall_s", 0.0)
                        t0 = time.perf_counter()
                        sess.step(*ld.load_batch(order[pos:pos + batch]))\
                            .item()
                        ms.append((time.perf_counter() - t0) * 1e3)
                        pos += batch
                        taken += 1
                    stall = getattr(ld, "stall_s", None)
                    emit("step+load", prefetch=prefetch, cache=cache,
                         ms=statistics.median(ms[warm:]),
                         io_stall_ms_per_step=(
                             None if stall is None
                             else (stall - stall0) * 1e3 / args.steps))
                    sess.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
