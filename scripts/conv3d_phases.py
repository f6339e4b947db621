#!/usr/bin/env python3
"""Where a block of the conv3d patch kernel spends its time, on one NVIDIA card.

    python3 scripts/conv3d_phases.py

Builds an instrumented copy of ``src/repro_torch/csrc/conv3d.cu`` into
``build/conv3d_phases/`` (the port's own ``nvcc`` flags): thread 0 of every
block of ``conv3d_patch`` records the global timer at its start and end and
the SM clocks spent loading the patch (with the K table), in the K loop and
in the epilogue. Runs it through ``ops.conv3d_valid`` at the layers of
cosmoflow-128 batch 4 that take the patch kernel (fp32 layers 0-2, bf16
layers 1-2) and prints, per layer, one JSON line: the call's time (CUDA
events), the blocks, the span from the first block's start to the last
block's end, a block's mean life, its mean clocks per phase, and the
blocks resident per SM that the life and the span imply. Prints the card's
name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BLOCKS = 1 << 16
# (text in the source, the same with the probes added)
PROBES = [
    ("""template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
conv3d_patch(""", """__device__ long long g_phase[%d * 6];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
conv3d_patch(""" % MAX_BLOCKS),
    ("""  const int tid = threadIdx.x;
  const int b = blockIdx.x;""", """  const int tid = threadIdx.x;
  const long long t0 = gtime(), c0 = clock64();
  const int b = blockIdx.x;"""),
    ("""  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid / 128;""", """  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const long long c1 = clock64();

  const int wg = tid / 128;"""),
    ("""#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) fence_regs<BN / 2>(acc[mt]);
  // the epilogue, from the registers""", """#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) fence_regs<BN / 2>(acc[mt]);
  __syncthreads();
  const long long c2 = clock64();
  // the epilogue, from the registers"""),
    ("""          if (col + 1 < s.cout) row[col + 1] = from_f32<T>(v1);
        }
      }
    }
  }
}""", """          if (col + 1 < s.cout) row[col + 1] = from_f32<T>(v1);
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0 && b < %d) {
    long long* o = g_phase + 6 * b;
    o[0] = t0; o[1] = c1 - c0; o[2] = c2 - c1; o[3] = clock64() - c2;
    o[4] = gtime();
  }
}""" % MAX_BLOCKS),
]
COPY_OUT = """
extern "C" int conv3d_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * %d * 6);
}
""" % MAX_BLOCKS


def build(build_lib):
    src = open(os.path.join(build_lib.CSRC, "conv3d.cu")).read()
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"{old[:60]!r}... is not in the source once")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "build", "conv3d_phases")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv3d.cu"), "w") as f:
        f.write(src + COPY_OUT)
    so = os.path.join(out, "conv3d.so")
    r = subprocess.run([build_lib.nvcc_path(), *build_lib.NVCC_FLAGS, "-o",
                        so, os.path.join(out, "conv3d.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"the instrumented copy did not build:\n{r.stdout}"
                         f"{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.conv3d_phases.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3d_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv3d import ops, ref
    from repro_torch.models import cosmoflow

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build(_build)

    def entry(dtype):
        fn = getattr(lib, ops._ENTRY[dtype])
        fn.argtypes = ops._ARGTYPES
        fn.restype = ctypes.c_int
        return fn

    sms = ops._sms(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = cosmoflow.conv_shapes(get_config("cosmoflow-128"), 4)
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for layer, (xs, ws, s, pads) in enumerate(shapes):
            out = ref.output_shape(xs, ws, s, pads)
            p = ops.plan(xs, ws, out, dt, sms, 0, s)
            if not p.stages:
                continue  # the gather kernel
            x = torch.randn(xs, generator=g, device="cuda").to(dt)
            w = (torch.randn(ws, generator=g, device="cuda")
                 * math.sqrt(2 / math.prod(ws[:4]))).to(dt)
            with mock.patch.object(ops, "_entry", entry):
                ops._launch.cache_clear()
                for _ in range(3):
                    ops.conv3d_valid(x, w, s, pads)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                ops.conv3d_valid(x, w, s, pads)
                b.record()
                b.synchronize()
            ops._launch.cache_clear()
            buf = np.zeros(MAX_BLOCKS * 6, dtype=np.int64)
            if lib.conv3d_phases(buf.ctypes.data) != 0:
                raise SystemExit("could not read the probes")
            box_h = ops.BOX_H[x.element_size()]
            blocks = (out[0] * out[1] * -(-out[2] // box_h)
                      * -(-out[3] // ops.BOX_W) * -(-ws[4] // p.bn))
            t = buf.reshape(-1, 6)[:min(blocks, MAX_BLOCKS)]
            span_us = (t[:, 4].max() - t[:, 0].min()) / 1e3
            life_us = float((t[:, 4] - t[:, 0]).mean()) / 1e3
            print(json.dumps({
                "config": "cosmoflow-128", "batch": 4, "dtype": prec,
                "layer": layer, "ms": a.elapsed_time(b), "blocks": blocks,
                "span_us": span_us, "block_life_us": life_us,
                "clocks": {"patch": float(t[:, 1].mean()),
                           "k_loop": float(t[:, 2].mean()),
                           "epilogue": float(t[:, 3].mean())},
                "resident_per_sm": blocks * life_us / (sms * span_us)}),
                flush=True)
            del x, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
