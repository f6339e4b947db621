#!/usr/bin/env python3
"""Why every gradient reduction sums the spatial peers first: ZeRO-1
against ``overlap`` on one card with the gradient hooks' sum in flat rank
order and in the nested order the port uses.

    python3 scripts/zero1_order.py [--out chiprun_out/zero1_order.json]

At unet3d-256's widths and depth on a 64^3 input, batch 2, 2 x 2 shards
on one card (fp32, TF32 off): for each order, an ``overlap`` and a
``reduce_scatter`` session take 2 steps from the same parameters on one
seeded batch, and step 1's reduced gradients are taken by the
``grad_comm`` probe. Per leaf: the largest difference of the parameters,
the elements beyond atol 1e-5, rtol 1e-4, the gradients' relative
difference and, for the elements out of tolerance, their step-1 gradient
as a share of the leaf's largest. The flat order is had by patching
``core/spmd._nested_sum``. Needs a CUDA device.
"""
import argparse
import dataclasses
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def flat_sum(xs, degrees):
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def run(cfg, x, y, RunConfig, compile, train_step) -> dict:
    params, grads = {}, {}
    for mode in ("overlap", "reduce_scatter"):
        sess = compile(RunConfig(model=cfg, mode="train", global_batch=2,
                                 data=2, spatial=2, grad_comm=mode),
                       devices=["cuda:0"] * 4)
        probe = train_step.make_convnet_phase_probes(
            sess.cfg, sess.mesh, sess.optimizer, global_batch=2,
            plan=sess.plan, grad_comm=mode)["grad_comm"]
        grads[mode] = probe(sess.params, sess.opt_state, x, y, 0)[1]
        for _ in range(2):
            sess.step(x, y)
        params[mode] = sess.params
        sess.close()
    rows = {}
    for n, ov in params["overlap"].items():
        rs = params["reduce_scatter"][n]
        bad = ~torch.isclose(rs, ov, atol=1e-5, rtol=1e-4)
        g1 = grads["overlap"][n]
        row = {"max_abs_diff": (rs - ov).abs().max().item(),
               "out_of_tol": int(bad.sum()), "numel": rs.numel(),
               "grad_rel_err": ((grads["reduce_scatter"][n] - g1).abs().max()
                                / g1.abs().max()).item()}
        if bad.any():
            share = g1[bad].abs() / g1.abs().max()
            row["grad_share_of_max_out_of_tol"] = [share.min().item(),
                                                   share.max().item()]
        rows[n] = row
    return {"bitwise": all(torch.equal(params["reduce_scatter"][n],
                                       params["overlap"][n])
                           for n in params["overlap"]),
            "leaves_out_of_tol": sum(r["out_of_tol"] > 0
                                     for r in rows.values()),
            "elements_out_of_tol": sum(r["out_of_tol"]
                                       for r in rows.values()),
            "worst_grad_rel_err": max(r["grad_rel_err"]
                                      for r in rows.values()),
            "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("zero1_order: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.api import RunConfig, compile
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.train import train_step

    cfg = dataclasses.replace(get_config("unet3d-256"),
                              name="unet3d-256@64", input_width=64)
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((2, 64, 64, 64, 1), generator=g, device="cuda")
    y = torch.randint(0, cfg.out_dim, (2, 64, 64, 64), generator=g,
                      device="cuda")
    nested = spmd._nested_sum
    out = {}
    try:
        for order, fn in (("flat", flat_sum), ("nested", nested)):
            spmd._nested_sum = fn
            out[order] = run(cfg, x, y, RunConfig, compile, train_step)
            print(order, json.dumps({k: v for k, v in out[order].items()
                                     if k != "rows"}), flush=True)
    finally:
        spmd._nested_sum = nested
    print(torch.cuda.get_device_name(0))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
