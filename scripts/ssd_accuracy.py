#!/usr/bin/env python3
"""The SSD scan kernel's accuracy on one NVIDIA card, beside another commit's.

    python3 scripts/ssd_accuracy.py [--seeds 7 11 12 13]

At mamba2-370m's layer shape (B=4, L=4096, H=32, P=64, N=128, chunk 256),
on seeded inputs drawn as ``chip_smoke.py::ssd_inputs`` draws them, in fp32
and bf16: the kernel's y, the y of the kernel in
``build/ssd_variants/parent.cu`` (``scripts/ssd_variants.py --parent REV``
writes it; without it that row is left out) and the plain chunked scan's
(``mamba2.ssd_chunked``), each against the chunked scan in fp64 (mean and
largest error, mean signed error), and the share of y's elements that
differ from the plain chunked scan's (in bf16: whose bf16 rounding
differs). Then mamba2-370m at its published widths on seeded weights, in
bf16, on 4 x 4096 tokens from each seed: the forward through each kernel
against the forward through the plain chunked scan, as a share of the
logits' scale (``chip_smoke.py`` holds the kernel forward to 0.25 of it at
seed 7). Prints the card's name and power limit first, one JSON line per
measurement after.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 4096, 32, 64, 128, 256)  # B, L, H, P, N, chunk


def parent_scan(build_lib, ssd_ops):
    """The scan of ``build/ssd_variants/parent.cu`` (contiguous x, B, C; no
    C Bᵀ scratch) behind ``ssd_scan``'s signature, or None."""
    src = os.path.join(ROOT, "build", "ssd_variants", "parent.cu")
    if not os.path.exists(src):
        return None
    so = os.path.join(ROOT, "build", "ssd_variants", "parent_accuracy.so")
    subprocess.run([build_lib.nvcc_path(), *build_lib.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)

    def scan(x, dt, A, Bm, Cm, *, chunk):
        x, dt, Bm, Cm = (v.contiguous() for v in (x, dt, Bm, Cm))
        B, L, H, P = x.shape
        N = Bm.shape[-1]
        Q = ssd_ops.chunk_len(L, chunk)
        fn = getattr(lib, "ssd_scan_f32" if x.dtype == torch.float32
                     else "ssd_scan_bf16")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        f32 = dict(device=x.device, dtype=torch.float32)
        y, state = torch.empty_like(x), torch.empty((B, H, P, N), **f32)
        states = torch.empty((B, L // Q, H, P, N), **f32)
        decay = torch.empty((B, L // Q, H), **f32)
        err = fn(*(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, state, states,
                                          decay)),
                 B, L, H, P, N, Q, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent kernel: CUDA error {err}")
        return y, state
    return scan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 11, 12, 13])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_accuracy: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import mamba2, ssm_lm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    def plain(x, dt, A, Bm, Cm, *, chunk):
        y, extras = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        return y, extras.final_state

    scans = {"kernel": ssd_ops.ssd_scan}
    parent = parent_scan(_build, ssd_ops)
    if parent is not None:
        scans["parent"] = parent
    B, L, H, P, N, Q = SHAPE
    g = torch.Generator(device="cuda").manual_seed(9)
    for dt_ in (torch.float32, torch.bfloat16):
        x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt_)
        d = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")).to(dt_)
        A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.5)
        Bm = torch.randn((B, L, N), generator=g, device="cuda").to(dt_)
        Cm = torch.randn((B, L, N), generator=g, device="cuda").to(dt_)
        ys = {name: fn(x, d, A, Bm, Cm, chunk=Q)[0] for name, fn in scans.items()}
        ys["chunked"] = plain(x, d, A, Bm, Cm, chunk=Q)[0]
        exact = plain(*(v.double() for v in (x, d, A, Bm, Cm)), chunk=Q)[0]
        for name, y in ys.items():
            err = y.double() - exact
            row = {"layer": list(SHAPE), "dtype": str(dt_).split(".")[1],
                   "scan": name, "mean_abs_err_vs_fp64": err.abs().mean().item(),
                   "max_abs_err_vs_fp64": err.abs().max().item(),
                   "mean_err_vs_fp64": err.mean().item()}
            if name != "chunked":
                row["share_differing_from_chunked"] = (
                    y != ys["chunked"]).float().mean().item()
            print(json.dumps(row), flush=True)
        del x, d, A, Bm, Cm, ys, exact

    cfg = get_config("mamba2-370m")
    p32 = ssm_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    # the weights chip_smoke.py scores in bf16: drawn in fp32, then rounded
    params = {n: ({m: t.bfloat16() for m, t in v.items()}
                  if isinstance(v, dict) else v.bfloat16())
              for n, v in p32.items()}
    del p32
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size, (4, 4097), generator=gen,
                               device="cuda")[:, :-1]
        with mock.patch.object(ssd_ops, "ssd_scan", plain):
            want = ssm_lm.forward(params, tokens, cfg).float()
        scale = want.abs().max().item()
        row = {"lm": "mamba2-370m/bf16/4x4096", "seed": seed}
        for name, fn in scans.items():
            with mock.patch.object(ssd_ops, "ssd_scan", fn):
                got = ssm_lm.forward(params, tokens, cfg).float()
            row[f"{name}_vs_plain"] = (got - want).abs().max().item() / scale
            del got
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
