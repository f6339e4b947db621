#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 10p (the planner's layouts on the card)
alone, after its card and build phases.

    python3 scripts/plans_phase.py [--halo]

``--halo`` first runs phase 3's halo kernel sweep over every face of the
main paths (the planned runs' included). Writes the phase's report to
``chiprun_out/plans_phase.json``. Needs a CUDA device.
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
from repro_torch.api import RunConfig, compile
from repro_torch.configs import get_config
from repro_torch.core import memory, spmd
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.kernels import _build
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.halo_pack import ref as pack_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import cosmoflow, for_config, mamba2, ssm_lm, unet3d
from repro_torch.serve import lm
from repro_torch.train import train_step

if not cs.torch.cuda.is_available():
    sys.exit("plans_phase: no CUDA device available")
t0 = time.perf_counter()
card = cs.phase_card()
cs.phase_build(_build)
# chip_smoke.main's namespace of the kernels and models
k = argparse.Namespace(conv_ops=conv_ops, conv_ref=conv_ref, bn_ops=bn_ops,
                       bn_ref=bn_ref, pack_ops=pack_ops, pack_ref=pack_ref,
                       ssd_ops=ssd_ops, ssd_ref=ssd_ref, mamba2=mamba2,
                       ssm_lm=ssm_lm, lm=lm, cosmoflow=cosmoflow,
                       unet3d=unet3d, for_config=for_config,
                       train_step=train_step, spmd=spmd, memory=memory)
cf128, ucfg = get_config("cosmoflow-128"), get_config("unet3d-256")
ucfg64 = dataclasses.replace(ucfg, name=f"{ucfg.name}@{cs.UNET_CHECK_WIDTH}",
                             input_width=cs.UNET_CHECK_WIDTH)
depth = SpatialPartitioning(("model", None, None))
if "--halo" in sys.argv:
    cs.phase_halo_kernels(pack_ops, pack_ref, sorted(
        set(cs.halo_cases(cosmoflow, plan_lib, depth,
                          {"cosmoflow-128": cf128,
                           "cosmoflow-512": get_config("cosmoflow-512")}))
        | cs.unet_halo_cases(unet3d, plan_lib, depth, ucfg, ucfg64)))
out, launches = cs.phase_plans(k, cf128, ucfg, ucfg64, RunConfig, compile,
                               plan_lib, depth, card)
os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
with open(os.path.join(HERE, "chiprun_out", "plans_phase.json"), "w") as f:
    json.dump(out, f, indent=1, default=str)
print("launches", json.dumps(launches))
print(f"done in {time.perf_counter() - t0:.0f} s")
