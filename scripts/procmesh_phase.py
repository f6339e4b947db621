#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 10w (the process mesh: one process a
shard, collectives through ``torch.distributed`` over gloo, every rank
on this card; ZeRO-1, remat and pipeline groups over it; the per-rank
loader, the harness and the supervisor over it, ``PROCMESH_IO``) alone,
after its card and build phases.

    python3 scripts/procmesh_phase.py [--only TAG ...] [--limit SECONDS]

Writes the phase's report to ``chiprun_out/procmesh_phase.json``. Needs
a CUDA device.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.api import RunConfig, compile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import perf_model  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core.spatial_conv import SpatialPartitioning  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bn_act import ops as bn_ops  # noqa: E402
from repro_torch.kernels.conv3d import ops as conv_ops  # noqa: E402
from repro_torch.kernels.conv3d import ref as conv_ref  # noqa: E402
from repro_torch.kernels.bn_act import ref as bn_ref  # noqa: E402
from repro_torch.kernels.halo_pack import ops as pack_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import cosmoflow, unet3d  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", help="the PROCMESH_TRAIN, "
                    "PROCMESH_COMPOSE and PROCMESH_IO runs of these tags "
                    "only (the fixed U-Net and serving runs then skipped; "
                    "io-s the PROCMESH_IO harness, io-sup its supervisor)")
    ap.add_argument("--limit", type=float, default=cs.PROCMESH_LIMIT_S,
                    help="seconds a child may take to answer")
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        sys.exit("procmesh_phase: no CUDA device available")
    cs.PROCMESH_LIMIT_S = args.limit
    if args.only:
        cs.PROCMESH_TRAIN = tuple(r for r in cs.PROCMESH_TRAIN
                                  if r[0] in args.only)
        cs.PROCMESH_COMPOSE = tuple(r for r in cs.PROCMESH_COMPOSE
                                    if r[0] in args.only)
        cs.PROCMESH_UNET = cs.PROCMESH_SERVE = ()
        cs.PROCMESH_IO = tuple(r for r in cs.PROCMESH_IO
                               if r[0] in args.only)
        if "io-s" not in args.only:
            cs.PROCMESH_IO_SERVE = None
        if "io-sup" not in args.only:
            cs.PROCMESH_IO_SUPERVISE = None
    t0 = time.perf_counter()
    card = cs.phase_card()
    cs.phase_build(_build)
    k = argparse.Namespace(conv_ops=conv_ops, conv_ref=conv_ref,
                           bn_ops=bn_ops, bn_ref=bn_ref, pack_ops=pack_ops,
                           ssd_ops=ssd_ops, cosmoflow=cosmoflow,
                           unet3d=unet3d, train_step=train_step)
    ucfg = get_config("unet3d-256")
    ucfg64 = dataclasses.replace(
        ucfg, name=f"{ucfg.name}@{cs.UNET_CHECK_WIDTH}",
        input_width=cs.UNET_CHECK_WIDTH)
    out, launches = cs.phase_procmesh(
        k, get_config("cosmoflow-128"), ucfg, ucfg64, RunConfig, compile,
        plan_lib, SpatialPartitioning(("model", None, None)), perf_model,
        card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "procmesh_phase.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    print("launches", json.dumps(launches))
    print(f"done in {time.perf_counter() - t0:.0f} s")
