#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 10s (the supervisor, the drift report and
the drivers on the card) alone, after its card and build phases and
phase 3's kernel checks (which hold the quickstart's shapes too).

    python3 scripts/supervise_phase.py

Writes the phase's report to ``chiprun_out/supervise_phase.json``. Needs
a CUDA device.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.api import RunConfig, compile
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.kernels import _build
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.bn_act import ref as bn_ref
from repro_torch.kernels.conv3d import ops as conv_ops
from repro_torch.kernels.conv3d import ref as conv_ref
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import cosmoflow

if not cs.torch.cuda.is_available():
    sys.exit("supervise_phase: no CUDA device available")
t0 = time.perf_counter()
card = cs.phase_card()
cs.phase_build(_build)
cf128 = get_config("cosmoflow-128")
cs.phase_kernels(conv_ops, conv_ref, bn_ops, bn_ref,
                 cosmoflow.conv_shapes(cf128, 4) + cosmoflow.conv_shapes(
                     get_smoke_config("cosmoflow-512"), 4))
# the wrappers chip_smoke.counts reads
k = argparse.Namespace(conv_ops=conv_ops, bn_ops=bn_ops, pack_ops=pack_ops,
                       ssd_ops=ssd_ops, cosmoflow=cosmoflow)
out, launches = cs.phase_supervise(
    k, cf128, RunConfig, compile, plan_lib,
    SpatialPartitioning(("model", None, None)), card)
os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
with open(os.path.join(HERE, "chiprun_out", "supervise_phase.json"),
          "w") as f:
    json.dump(out, f, indent=1, default=str)
print("launches", json.dumps(launches))
print(f"done in {time.perf_counter() - t0:.0f} s")
