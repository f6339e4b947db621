#!/usr/bin/env python3
"""The accuracy of one CosmoFlow training step's gradients on one NVIDIA
card: through the kernels, through the plain versions, and in fp64.

    python3 scripts/train_accuracy.py [--config cosmoflow-128] [--batch 4]
        [--precision fp32|bf16] [--variant NAME]

Step 1 of ``compile(RunConfig(model=..., mode="train"))`` at fp32 (TF32
off) or bf16, on a seeded batch with the session's seeded dropout masks,
three ways: (1) through the conv3d and bn_act kernels, as the session
trains; (2) through their plain versions, autograd through
``ref.conv3d_valid`` and ``ref.bn_leaky_relu`` directly
(``chip_smoke.py::plain_training``); (3) in fp64
(``chip_smoke.py::fp64_grads``): the same parameters, batch and masks,
the convs by ``F.conv3d`` and the batch norm and the loss in fp64. For
every parameter it prints, as one JSON line, the largest error of (1)
and (2) from (3) and of (1) from (2), each as a share of the fp64
gradient's max-abs, with that max-abs beside the largest max-abs of
any conv weight's gradient: a leaf whose gradient is a small difference
of large terms (a batch-norm bias feeding the next layer's batch norm,
which removes any constant shift) shows its rounding as a larger share
of itself.

A step's gradient jumps where rounding flips one of its discrete
decisions: the sign of a batch norm + leaky-ReLU output, the winner of a
max pool window. So it also prints, block by block, how many decisions
(1) and (2) each take otherwise than (3), and, for every parameter, the
errors of (1) from (2) and from (3) when those two take (1)'s decisions
(``chip_smoke.py::decisions``); and, to attribute (1)'s error, the
error from (2) of three mixed steps that take (1)'s decisions, each with
one kernel on and the other two plain: the forward's convs, the input
gradients (else the plain conv over the flipped filter), bn_act; and six
more with the input gradient of one layer at a time on the kernel. And
for each conv layer on seeded
inputs, the forward's largest error from fp64 (``F.conv3d``) as a share
of its max-abs, through the kernel and through the plain version, and the
same for the input gradient (dy zero-mean per channel, as a batch norm's
backward leaves it), with the error's rms and its sum over the voxels,
channel by channel, as shares of the gradient's rms and of its absolute
sum.
``--variant`` runs a design variant of ``scripts/conv3d_variants.py``
(built the same way) in place of the conv3d kernel as built. Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="cosmoflow-128")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--variant", help="a variant of scripts/conv3d_variants"
                    ".py in place of the conv3d kernel as built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_accuracy: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from repro_torch.api import RunConfig, compile
    from repro_torch.kernels import _build
    from repro_torch.kernels.bn_act import ops as bn_ops
    from repro_torch.kernels.bn_act import ref as bn_ref
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.conv3d import ref as conv_ref
    from repro_torch.models import cosmoflow

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.ExitStack() as stack:
        if args.variant:
            import conv3d_variants as cv
            cv.VARIANTS = {args.variant: cv.VARIANTS[args.variant]}
            lib = cv.build(_build, os.path.join(ROOT, "build",
                                                "conv3d_variants"))
            stack.enter_context(mock.patch.object(
                conv_ops, "_entry", cv.entry_from(conv_ops,
                                                  lib[args.variant])))
            conv_ops._launch.cache_clear()
            print(json.dumps({"variant": args.variant}), flush=True)
        return run(args, chip_smoke, RunConfig, compile, conv_ops, conv_ref,
                   bn_ops, bn_ref, cosmoflow)


def forward_errors(args, cfg, conv_ops, conv_ref, cosmoflow) -> None:
    """Each conv layer's forward on seeded inputs (He-scaled weights):
    the kernel's and the plain version's largest error from fp64."""
    import chip_smoke
    g = torch.Generator(device="cuda").manual_seed(3)
    for i, (xs, ws, s, pads) in enumerate(cosmoflow.conv_shapes(
            cfg, args.batch)):
        x = torch.randn(xs, generator=g, device="cuda")
        w = torch.randn(ws, generator=g, device="cuda") * math.sqrt(
            2 / math.prod(ws[:4]))
        want = chip_smoke.conv64(x.double(), w.double(), s, pads)
        scale = want.abs().max().item()
        row = {"layer": i, "K": math.prod(ws[:4]), "max_abs": scale}
        for name, fn in (("kernel", conv_ops.conv3d_valid),
                         ("plain", conv_ref.conv3d_valid)):
            row[f"{name}_vs_fp64"] = (fn(x, w, s, pads).double() - want
                                      ).abs().max().item() / scale
        print(json.dumps(row), flush=True)
        if i == 0:
            continue
        ys = conv_ref.output_shape(xs, ws, s, pads)
        dy = torch.randn(ys, generator=g, device="cuda")
        dy -= dy.mean(dim=(0, 1, 2, 3))
        x64 = x.double().requires_grad_(True)
        chip_smoke.conv64(x64, w.double(), s, pads).backward(dy.double())
        want = x64.grad
        row = {"layer": i, "input_grad": True}
        kernel_ig = conv_ops.conv3d_input_grad

        def plain_ig(dy, w, xs, s, pads):
            with mock.patch.object(conv_ops, "_run_kernel",
                                   lambda x, w, st, p, o:
                                   conv_ref.conv3d_valid(x, w, st, p)):
                return kernel_ig(dy, w, xs, s, pads)

        def autograd_ig(dy, w, xs, s, pads):
            xr = x.requires_grad_(True)
            conv_ref.conv3d_valid(xr, w, s, pads).backward(dy)
            return xr.grad

        for name, fn in (("kernel", kernel_ig), ("plain", plain_ig),
                         ("autograd", autograd_ig)):
            e = fn(dy, w, xs, s, pads).double() - want
            row[f"{name}_max"] = e.abs().max().item() / want.abs().max().item()
            row[f"{name}_rms"] = (e.square().mean().sqrt()
                                  / want.square().mean().sqrt()).item()
            row[f"{name}_channel_sum"] = (
                e.sum(dim=(0, 1, 2, 3)).abs().max()
                / want.abs().sum(dim=(0, 1, 2, 3)).min()).item()
        print(json.dumps(row), flush=True)
        del x, w, want, dy, x64


def run(args, chip_smoke, RunConfig, compile, conv_ops, conv_ref, bn_ops,
        bn_ref, cosmoflow) -> int:
    k = argparse.Namespace(conv_ops=conv_ops, conv_ref=conv_ref,
                           bn_ops=bn_ops, bn_ref=bn_ref, cosmoflow=cosmoflow)
    sess = compile(RunConfig(model=args.config, mode="train",
                             global_batch=args.batch,
                             precision=args.precision))
    cfg = sess.cfg
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    w = cfg.input_width
    x = torch.randn((args.batch, w, w, w, cfg.in_channels), generator=g,
                    device="cuda")
    y = torch.randn((args.batch, cfg.out_dim), generator=g, device="cuda")
    forward_errors(args, cfg, conv_ops, conv_ref, cosmoflow)
    taken, plain_taken, exact_taken = [], [], []
    with chip_smoke.decisions(k, taken):
        loss_k, gk = chip_smoke.loss_and_grads(k, sess, x, y)
    with chip_smoke.plain_training(k), chip_smoke.decisions(k, plain_taken):
        loss_p, gp = chip_smoke.loss_and_grads(k, sess, x, y)
    with chip_smoke.plain_training(k), chip_smoke.decisions(
            k, taken, replay=True):
        _, gp_same = chip_smoke.loss_and_grads(k, sess, x, y)

    def plain_kernel(x, w, stride, pads, out_shape):
        return conv_ref.conv3d_valid(x, w, stride, pads)

    kernel_ig = conv_ops.conv3d_input_grad

    def plain_ig(*a, **kw):
        with mock.patch.object(conv_ops, "_run_kernel", plain_kernel):
            return kernel_ig(*a, **kw)

    plain_ig.launches = 0  # the wrapper counts into its module name
    plain = {"forward_conv": (conv_ops, "conv3d_valid",
                              conv_ref.conv3d_valid),
             "input_grad": (conv_ops, "conv3d_input_grad", plain_ig),
             "bn_act": (bn_ops, "bn_leaky_relu", bn_ref.bn_leaky_relu)}
    g_only = {}
    for layer in range(1, len(cosmoflow.conv_shapes(cfg, args.batch))):
        calls = [0]  # the backward reaches the last layer's first

        def one_ig(*a, layer=layer, **kw):
            calls[0] += 1
            n = len(cosmoflow.conv_shapes(cfg, args.batch))
            fn = kernel_ig if n - calls[0] == layer else plain_ig
            return fn(*a, **kw)

        one_ig.launches = 0  # the wrapper counts into its module name

        with mock.patch.object(conv_ops, "conv3d_valid",
                               conv_ref.conv3d_valid), \
                mock.patch.object(bn_ops, "bn_leaky_relu",
                                  bn_ref.bn_leaky_relu), \
                mock.patch.object(conv_ops, "conv3d_input_grad", one_ig), \
                chip_smoke.decisions(k, taken, replay=True):
            _, g_only[f"input_grad_{layer}"] = chip_smoke.loss_and_grads(
                k, sess, x, y)
    for on in plain:
        with contextlib.ExitStack() as stack:
            for name, (mod, attr, fn) in plain.items():
                if name != on:
                    stack.enter_context(mock.patch.object(mod, attr, fn))
            stack.enter_context(chip_smoke.decisions(k, taken, replay=True))
            _, g_only[on] = chip_smoke.loss_and_grads(k, sess, x, y)
    loss_64, g64 = chip_smoke.fp64_grads(
        k, sess, x, y, lambda: chip_smoke.decisions(k, exact_taken))
    _, g64_same = chip_smoke.fp64_grads(
        k, sess, x, y, lambda: chip_smoke.decisions(k, taken, replay=True))
    print(json.dumps({"loss": loss_k.item(), "plain_loss": loss_p.item(),
                      "fp64_loss": loss_64.item()}), flush=True)
    # in call order: per block its BN signs, then its pool's winners
    print(json.dumps({"decisions": [int(t.numel()) for t in taken],
                      "kernel_flips_vs_fp64": chip_smoke.flips(
                          taken, exact_taken),
                      "plain_flips_vs_fp64": chip_smoke.flips(
                          plain_taken, exact_taken)}), flush=True)
    conv_scale = max(g64[n].abs().max().item() for n in g64
                     if n.startswith("conv"))
    for n in g64:
        ref = g64[n]
        scale = ref.abs().max().item()

        def err(a, b):
            return (a.double() - b.double()).abs().max().item() / scale

        print(json.dumps({
            "leaf": n, "fp64_max_abs": scale,
            "conv_grad_max_abs": conv_scale,
            "kernel_vs_fp64": err(gk[n], ref),
            "plain_vs_fp64": err(gp[n], ref),
            "kernel_vs_plain": err(gk[n], gp[n]),
            "kernel_vs_plain_same_decisions": err(gk[n], gp_same[n]),
            "kernel_vs_fp64_same_decisions": err(gk[n], g64_same[n]),
            "plain_vs_fp64_same_decisions": err(gp_same[n], g64_same[n]),
            **{f"{on}_kernel_only_vs_plain_same_decisions":
               err(g_only[on][n], gp_same[n]) for on in g_only}}),
            flush=True)
    sess.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
