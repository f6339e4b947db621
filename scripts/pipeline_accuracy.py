#!/usr/bin/env python3
"""Step 1's gradients of the U-Net's pipelined step against the plain
versions and fp64 on one NVIDIA card, over seeds: how often phase 10q's
decision-aware bf16 gate (``chip_smoke.py::step1_vs_plain``) holds.

    python3 scripts/pipeline_accuracy.py [--seeds 3] [--width 64]

At unet3d-256's widths and depth on a ``--width``^3 input, for each
seed and precision (fp32, bf16), three steps, each with every decision
(ReLU signs, pool winners) the kernel step's (``chip_smoke.decisions``):
the unpipelined step at b1 and at b2 (phase 10e's setting), and the
oracle of a two-group pipelined step at b2, M = 2 (each micro-batch of 1
its own forward: ``chip_smoke.loss_and_grads(micro=2)``), plus that
pipelined step's ``grad_comm`` probe against its oracle. For each: per
parameter the kernel step's distance from the fp64 step and the plain
step's (shares of the leaf's max-abs), their ratio, and which leaves lie
past ``chip_smoke.STEP1_BF16`` times the plain step's. Prints the card's
name and power limit first; one JSON line a step and precision.
"""
import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.api import RunConfig, compile
from repro_torch.configs import get_config
from repro_torch.core import memory, perf_model, spmd
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import _build
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.halo_pack import ref as pack_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cosmoflow, for_config, unet3d
from repro_torch.train import train_step

torch = cs.torch


def rel(a, b) -> float:
    return ((a.double() - b.double()).abs().max().item()
            / max(1e-30, b.double().abs().max().item()))


def gate_rows(k, sess, x, y, micro: int, step=None) -> dict:
    """Each leaf's distances from the fp64 step taking the kernel step's
    decisions: the kernel step (``step``, default the oracle through the
    kernels) and the plain oracle."""
    taken = []
    with cs.decisions(k, taken):
        _, grads = cs.loss_and_grads(k, sess, x, y, micro=micro)
    if step is not None:
        _, grads = step(x, y)
    with cs.plain_training(k), cs.decisions(k, taken, replay=True):
        _, pinned = cs.loss_and_grads(k, sess, x, y, micro=micro)
    _, exact = cs.fp64_grads(k, sess, x, y, lambda: cs.decisions(
        k, taken, replay=True), micro)
    out = {}
    for n in grads:
        kern, plain = rel(grads[n], exact[n]), rel(pinned[n], exact[n])
        out[n] = (kern, plain, kern / max(plain, 1e-30))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--width", type=int, default=cs.UNET_CHECK_WIDTH)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_accuracy: no CUDA device available", file=sys.stderr)
        return 2
    print(cs.phase_card())
    cs.phase_build(_build)
    k = argparse.Namespace(
        conv_ops=conv_ops, conv_ref=conv_ref, bn_ops=bn_ops, bn_ref=bn_ref,
        pack_ops=pack_ops, pack_ref=pack_ref, ssd_ops=ssd_ops,
        cosmoflow=cosmoflow, unet3d=unet3d, for_config=for_config,
        train_step=train_step, spmd=spmd, memory=memory, mesh_lib=mesh_lib)
    ucfg = get_config("unet3d-256")
    small = dataclasses.replace(ucfg, name=f"{ucfg.name}@{args.width}",
                                input_width=args.width)
    for seed in range(args.seeds):
        g = torch.Generator(device="cuda").manual_seed(14 + seed)
        x, y = cs.train_batch(small, 2, g)
        for prec in ("fp32", "bf16"):
            runs = {}
            for tag, batch in (("unpipelined b1", 1), ("unpipelined b2", 2)):
                with compile(RunConfig(model=small, mode="train",
                                       global_batch=batch,
                                       precision=prec)) as sess:
                    runs[tag] = gate_rows(k, sess, x[:batch], y[:batch], 1)
            plan = cs.pipe_plan(plan_lib, perf_model, small, 2, 1, 2)
            with compile(cs.pipe_config(RunConfig, plan, small, 2, prec),
                         devices=["cuda:0"] * 2) as sess:
                probe = cs.pipe_probe(k, sess)
                runs["pipelined oracle b2 M2"] = gate_rows(k, sess, x, y, 2)
                runs["pipelined step b2 M2"] = gate_rows(k, sess, x, y, 2,
                                                         step=probe)
                _, got = probe(x, y)
                _, want = cs.loss_and_grads(k, sess, x, y, micro=2)
                vs_oracle = max(rel(got[n], want[n]) for n in got)
            for tag, rows in runs.items():
                worst = max(rows, key=lambda n: rows[n][2])
                print(json.dumps({
                    "seed": seed, "precision": prec, "step": tag,
                    "plan": plan.name, "worst_leaf": worst,
                    "worst": rows[worst],
                    "over_gate": sorted(n for n, r in rows.items()
                                        if r[2] > cs.STEP1_BF16),
                    "pipelined_vs_oracle": vs_oracle}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
