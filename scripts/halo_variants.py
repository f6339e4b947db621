#!/usr/bin/env python3
"""Time the halo pack and unpack kernel's designs side by side on one NVIDIA card.

    python3 scripts/halo_variants.py [--reps 20] [--out FILE]

At every face of ``chip_smoke.py``'s halo timing sweep (the depth-split
convs of its spatial CosmoFlow configs, and of unet3d-256 b1 at S = 2, 4
in fp32 and bf16), pack and unpack run as:

- "grid-stride": the kernel's earlier design, whose source this script
  carries (``GRID_STRIDE_CU``, so that it needs no git history): one run of
  a sample per ``blockIdx.y``, each thread copying its 16-byte vectors one
  after another in a grid-stride loop, at most 2,048 blocks a run;
- "as built": ``kernels/halo_pack/ops.py`` with its own vector count;
- "4 vectors", "2 vectors", "1 vector": the same kernel held to one
  vector count a thread (``ops.REG_VECTORS`` patched; no rebuild);
- "bulk": bulk asynchronous copies through a ring in shared memory over
  the same chunk list, a design that lost to the built one (``BULK_CU``,
  carried here);
- "torch.cat" of the same views.

Each variant's output is held bit for bit against the plain version once
per face. Each is timed two ways, in two rounds (the second in the
opposite order; a row keeps both, and their difference is the run-to-run
spread): "hot", device time per call with the calls queued back to back
(``chip_smoke.queued_ms``: a face of up to ~16 MB then stays in the
50 MB L2 from call to call), and "cold", the median over ``--reps``
calls of CUDA events around one call, each call after a 256 MB write
that evicts the L2, all queued behind a spin kernel (the events add a
constant, ``cold_floor_ms``, the same for every variant). Prints the card's name and power limit first,
one JSON line per face and kernel after, then per-forward sums (pack
over the 8 calls of a cosmoflow-128 b4 S=2 fp32 forward, unpack over the
6 of the all-blocks S=2 forward, both at unet3d-256 b1 S = 2, 4) and the
faces where "as built" is slower than "grid-stride" or "torch.cat"
beyond the spread (its faster round slower than their slower round).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "halo_variants")
# name -> the ops.py constants it patches (None: another design's source
# or torch.cat)
VARIANTS = {
    "grid-stride": None,
    "as built": {},
    "4 vectors": {"REG_VECTORS": (4,), "REG_STREAM_BYTES": 1 << 62},
    "2 vectors": {"REG_VECTORS": (2,), "REG_STREAM_BYTES": 1 << 62},
    "1 vector": {"REG_VECTORS": (1,)},
    "bulk": None,
    "torch.cat": None,
}
BULK_CHUNK = 32 << 10          # bytes a chunk on the bulk design
BULK_STAGES = 4                # chunks in a block's ring
SMEM_PER_SM = 228 << 10        # an H100 SM's shared memory
SMEM_PER_BLOCK = 1 << 10       # reserved by the card for each block
L2_FLUSH_BYTES = 256 << 20     # written before each cold call
GRID_STRIDE_CU = r"""// Halo pack and unpack along depth for NDHWC activations, for Hopper
// (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/halo_pack/kernel.py:
//   pack_depth   (:26) -> halo_pack:   the trailing `lo` depth rows of each
//                        sample (sent to the next shard) and the leading
//                        `hi` rows (sent to the previous shard), written in
//                        one launch into ONE allocation:
//                        [to_next (N,lo,H,W,C) | to_prev (N,hi,H,W,C)].
//   unpack_depth (:69) -> halo_unpack: [lo_buf | x | hi_buf] along depth,
//                        written in one launch into one (N,D+lo+hi,H,W,C)
//                        buffer.
//
// Both are pure data movement, so they are bound by bytes: each byte is
// read once and written once. One depth row of one sample is H*W*C
// contiguous elements, so each sample's face (or body) is ONE contiguous
// run of bytes, at most 3N runs per launch. Each run is spread over all
// blocks that share blockIdx.y and copied in 16-byte vectors when both of
// its addresses are 16-byte aligned (4-byte words, else 2-byte halves,
// otherwise), with the ragged tail masked. The copy is byte-exact, so one
// kernel serves every float type of at least 2 bytes. Offsets are 64-bit:
// a shard at 512^3 holds more than 2^31 elements. A width of 0 (lo = 0 or
// hi = 0) launches no block for that face.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRun = 2048;

// Copy `bytes` (a multiple of 2) from src to dst with every thread of the
// blocks that share this blockIdx.y.
__device__ __forceinline__ void copy_run(const char* __restrict__ src,
                                         char* __restrict__ dst,
                                         int64_t bytes) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(dst);
  int64_t done = 0;
  if ((mis & 15) == 0) {
    const int64_t n = bytes >> 4;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int64_t i = tid; i < n; i += stride) d[i] = __ldg(s + i);
    done = n << 4;
  } else if ((mis & 3) == 0) {
    const int64_t n = bytes >> 2;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int64_t i = tid; i < n; i += stride) d[i] = __ldg(s + i);
    done = n << 2;
  }
  // the tail of the vector paths, or the whole run when only 2-aligned
  const int64_t n = (bytes - done) >> 1;
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src + done);
  uint16_t* d = reinterpret_cast<uint16_t*>(dst + done);
  for (int64_t i = tid; i < n; i += stride) d[i] = __ldg(s + i);
}

// blockIdx.y < n_next: to_next of sample blockIdx.y; else to_prev of
// sample blockIdx.y - n_next. `row` is one depth row in bytes.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const char* __restrict__ x, char* __restrict__ out, int64_t n,
            int64_t d, int64_t row, int lo, int hi, int64_t n_next) {
  const int64_t seg = blockIdx.y;
  if (seg < n_next) {
    copy_run(x + (seg * d + d - lo) * row, out + seg * lo * row, lo * row);
  } else {
    const int64_t s = seg - n_next;
    copy_run(x + s * d * row, out + (n * lo + s * hi) * row, hi * row);
  }
}

// blockIdx.y = 3 * sample + part; part 0 = lo_buf, 1 = x, 2 = hi_buf.
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const char* __restrict__ lo_buf, const char* __restrict__ x,
              const char* __restrict__ hi_buf, char* __restrict__ out,
              int64_t d, int64_t row, int lo, int hi) {
  const int64_t s = blockIdx.y / 3;
  const int part = blockIdx.y % 3;
  char* base = out + s * (lo + d + hi) * row;
  if (part == 0) {
    copy_run(lo_buf + s * lo * row, base, lo * row);
  } else if (part == 1) {
    copy_run(x + s * d * row, base + lo * row, d * row);
  } else {
    copy_run(hi_buf + s * hi * row, base + (lo + d) * row, hi * row);
  }
}

// Blocks along x for runs of up to `bytes`: about four 16-byte vectors a
// thread, at most kMaxBlocksPerRun.
unsigned blocks_for(int64_t bytes) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * 16 * 4;
  int64_t b = (bytes + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocksPerRun) b = kMaxBlocksPerRun;
  return static_cast<unsigned>(b);
}

}  // namespace

extern "C" int halo_pack(const void* x, void* out, long long n, long long d,
                         long long row_bytes, int lo, int hi, void* stream) {
  const int64_t n_next = lo > 0 ? n : 0;
  const int64_t n_seg = n_next + (hi > 0 ? n : 0);
  if (n_seg == 0) return static_cast<int>(cudaSuccess);
  const int64_t widest = static_cast<int64_t>(lo > hi ? lo : hi) * row_bytes;
  const dim3 grid(blocks_for(widest), static_cast<unsigned>(n_seg));
  pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(out), n, d, row_bytes,
      lo, hi, n_next);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int halo_unpack(const void* lo_buf, const void* x,
                           const void* hi_buf, void* out, long long n,
                           long long d, long long row_bytes, int lo, int hi,
                           void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(blocks_for(d * row_bytes), static_cast<unsigned>(3 * n));
  unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(lo_buf), static_cast<const char*>(x),
      static_cast<const char*>(hi_buf), static_cast<char*>(out), d,
      row_bytes, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
"""


BULK_CU = r"""// The halo copy's bulk design: bulk asynchronous copies through a ring in
// shared memory, kept here to be timed beside the kernel as built
// (src/repro_torch/csrc/halo_pack.cu), which it lost to at every size on
// an H100. The same flat chunk list a launch (Part, Work, piece, the
// ragged-edge copies are the built kernel's); a persistent grid (as many
// blocks as fit on the SMs), each walking its chunks. One thread keeps
// `stages - 1` chunks of loads in flight through a ring in dynamic shared
// memory (cp.async.bulk global -> shared, completing on an mbarrier) and
// stores each arrived chunk with cp.async.bulk shared -> global, reusing a
// stage once its store has read it (wait_group.read). A chunk's ragged
// head and tail (under 16 bytes each), or the whole chunk where source
// and destination are not 16-byte aligned alike, go by the other warps.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBulkThreads = 128;  // bulk path: thread 0 drives the copies,
                                   // warps 1-3 the ragged edges
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;   // 227 KB, a block's dynamic maximum

// One part of a launch: the run of sample s is `bytes` from
// src + s * src_stride to dst + s * dst_stride, cut into `chunks` chunks.
struct Part {
  const char* src;
  char* dst;
  int64_t src_stride;
  int64_t dst_stride;
  int64_t bytes;
  uint32_t chunks;
};

struct Work {
  Part part[3];
  uint32_t per_sample;  // chunks of one sample, every part
  uint32_t total;       // chunks of the launch
  uint32_t chunk;       // bytes a chunk (a multiple of 16)
};

struct Piece {
  const char* src;
  char* dst;
  uint32_t bytes;
};

// Chunk i of the flat index: its sample, its part (empty parts have no
// chunk and are stepped over), its place in the run.
__device__ __forceinline__ Piece piece(const Work& w, uint32_t i) {
  const uint32_t s = i / w.per_sample;
  uint32_t j = i - s * w.per_sample;
  Part q = w.part[0];
  if (j >= q.chunks) {
    j -= q.chunks;
    q = w.part[1];
    if (j >= q.chunks) {
      j -= q.chunks;
      q = w.part[2];
    }
  }
  const int64_t off = static_cast<int64_t>(j) * w.chunk;
  const int64_t left = q.bytes - off;
  return {q.src + s * q.src_stride + off, q.dst + s * q.dst_stride + off,
          static_cast<uint32_t>(left < w.chunk ? left : w.chunk)};
}

// `bytes` (a multiple of sizeof(T)) from src to dst, both aligned to
// sizeof(T), by threads t of nt, four vectors a thread at a time.
template <typename T>
__device__ __forceinline__ void copy_vectors(const char* __restrict__ src,
                                             char* __restrict__ dst,
                                             uint32_t bytes, int t, int nt) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const uint32_t n = bytes / sizeof(T);
  for (uint32_t base = t; base < n; base += 4 * nt) {
    T r[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (base + v * nt < n) r[v] = __ldg(s + base + v * nt);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (base + v * nt < n) d[base + v * nt] = r[v];
    }
  }
}

// The 2-byte halves of [0, bytes) (bytes < 32), one a thread.
__device__ __forceinline__ void copy_halves(const char* src, char* dst,
                                            uint32_t bytes, int t) {
  if (t < static_cast<int>(bytes / 2)) {
    reinterpret_cast<uint16_t*>(dst)[t] =
        __ldg(reinterpret_cast<const uint16_t*>(src) + t);
  }
}

// How a piece splits for the widest vector g (16, 4 or 2 bytes) that its
// source and destination are aligned to alike: `head` bytes up to the
// first g-aligned source byte, `body` bytes of whole g-vectors.
struct Cut {
  uint32_t g;
  uint32_t head;
  uint32_t body;
};

__device__ __forceinline__ Cut cut(const Piece& p) {
  const uint32_t a = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.src));
  const uint32_t b = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.dst));
  const uint32_t g = ((a ^ b) & 15) == 0 ? 16 : ((a ^ b) & 3) == 0 ? 4 : 2;
  uint32_t head = (g - (a & (g - 1))) & (g - 1);
  if (head > p.bytes) head = p.bytes;
  return {g, head, (p.bytes - head) & ~(g - 1)};
}

// A piece in any alignment by threads t of nt: its ragged head and tail
// as 2-byte halves, the rest in the widest vectors it allows. Out of line:
// the aligned path's code stays small.
__device__ __noinline__ void copy_any(Piece p, int t, int nt) {
  const Cut c = cut(p);
  const uint32_t tail = c.head + c.body;
  copy_halves(p.src, p.dst, c.head, t);
  copy_halves(p.src + tail, p.dst + tail, p.bytes - tail, t);
  const char* s = p.src + c.head;
  char* d = p.dst + c.head;
  if (c.g == 16) {
    copy_vectors<int4>(s, d, c.body, t, nt);
  } else if (c.g == 4) {
    copy_vectors<uint32_t>(s, d, c.body, t, nt);
  } else {
    copy_vectors<uint16_t>(s, d, c.body, t, nt);
  }
}

// ------------------------------------------ barriers and bulk copies --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// a barrier that has not completed after ~10 s of spinning traps: the
// launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1LL << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}

// The bytes of a piece the bulk copies take: [head, head + body) when
// source and destination are 16-byte aligned alike, else none.
__device__ __forceinline__ Cut bulk_part(const Piece& p) {
  Cut c = cut(p);
  if (c.g != 16) c.body = 0;
  return c;
}

// the flat index of this block's k-th chunk: blocks take chunks in turn,
// so the resident blocks sweep one window of the runs together
__device__ __forceinline__ uint32_t chunk_of(uint32_t k) {
  return blockIdx.x + k * gridDim.x;
}

__device__ __forceinline__ uint32_t chunks_of_block(const Work& w) {
  return blockIdx.x < w.total ? (w.total - 1 - blockIdx.x) / gridDim.x + 1
                              : 0;
}

__global__ void __launch_bounds__(kBulkThreads)
bulk_kernel(Work w, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * w.chunk);
  const uint32_t mine = chunks_of_block(w);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // chunk k of this block lies in stage k % stages; a chunk with nothing
    // for the bulk copies still arrives (0 bytes) and commits an empty
    // group, so every stage's phase and the group count stay in step
    auto issue = [&](uint32_t k) {
      const uint32_t st = k % stages;
      const Piece p = piece(w, chunk_of(k));
      const Cut c = bulk_part(p);
      const uint32_t bar = smem_u32(bars + st);
      mbar_expect_tx(bar, c.body);
      if (c.body) {
        bulk_load(smem_u32(ring + st * w.chunk), p.src + c.head, c.body,
                  bar);
      }
    };
    const uint32_t ahead = stages - 1;
    for (uint32_t k = 0; k < ahead && k < mine; ++k) issue(k);
    for (uint32_t k = 0; k < mine; ++k) {
      const uint32_t st = k % stages;
      mbar_wait(smem_u32(bars + st), (k / stages) & 1);
      const Piece p = piece(w, chunk_of(k));
      const Cut c = bulk_part(p);
      if (c.body) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_store(p.dst + c.head, smem_u32(ring + st * w.chunk), c.body);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (k + ahead < mine) {
        // the stage of chunk k - 1 is free once its store has read it:
        // every group but the newest (chunk k's store)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        issue(k + ahead);
      }
    }
    // every store complete before the block's shared memory goes
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  } else if (threadIdx.x >= 32) {
    const int t = threadIdx.x - 32;
    const int nt = kBulkThreads - 32;
    for (uint32_t k = 0; k < mine; ++k) {
      const Piece p = piece(w, chunk_of(k));
      const Cut c = bulk_part(p);
      if (c.g == 16) {  // the ragged edges around the bulk bytes
        const uint32_t tail = c.head + c.body;
        copy_halves(p.src, p.dst, c.head, t);
        copy_halves(p.src + tail, p.dst + tail, p.bytes - tail, t);
      } else {
        copy_any(p, t, nt);
      }
    }
  }
}

cudaError_t launch(Work w, int64_t n, int64_t chunk, int grid, int stages,
                   cudaStream_t stream) {
  const int64_t per_sample = static_cast<int64_t>(w.part[0].chunks) +
                             w.part[1].chunks + w.part[2].chunks;
  if (n * per_sample == 0) return cudaSuccess;
  // the flat index is 32-bit: at most 2^32 - 1 chunks a launch
  if (chunk <= 0 || chunk % 16 != 0 || chunk > kMaxSmem || grid < 1 ||
      n * per_sample > UINT32_MAX || stages < 2 || stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  w.chunk = static_cast<uint32_t>(chunk);
  w.per_sample = static_cast<uint32_t>(per_sample);
  w.total = static_cast<uint32_t>(n * per_sample);
  const int64_t smem = stages * chunk + stages * 8;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // above 48 KB only once the function allows it, once per device
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit);
  }
  bulk_kernel<<<grid, kBulkThreads, static_cast<size_t>(smem), stream>>>(
      w, stages);
  return cudaGetLastError();
}

}  // namespace

// halo_copy's layout (geom: 5 numbers a part, 3 parts), with the ring's
// chunk, stages and the grid.
extern "C" int halo_bulk(const void* src0, const void* src1,
                         const void* src2, void* dst, const long long* geom,
                         long long n, long long chunk, int grid, int stages,
                         void* stream) {
  if (n < 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* srcs[3] = {src0, src1, src2};
  Work w{};
  for (int p = 0; p < 3; ++p) {
    const long long* g = geom + 5 * p;
    if (g[4] < 0 || g[4] % 2 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long chunks = (g[4] + chunk - 1) / chunk;
    if (chunks > UINT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    w.part[p] = {static_cast<const char*>(srcs[p]) + g[0],
                 static_cast<char*>(dst) + g[2], g[1], g[3], g[4],
                 static_cast<uint32_t>(chunks)};
  }
  return static_cast<int>(launch(w, n, chunk, grid, stages,
                                 static_cast<cudaStream_t>(stream)));
}
"""


def patched(ops, patches):
    """``ops`` with ``patches`` of its constants for the block."""
    if not patches:
        return contextlib.nullcontext()
    return mock.patch.multiple(ops, **patches)


def build(build_lib):
    """Start ``nvcc`` on the carried designs; returns {name: (so,
    process)}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out = {}
    for name, src in (("grid_stride", GRID_STRIDE_CU), ("bulk", BULK_CU)):
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT_DIR, f"{name}.so")
        out[name] = so, subprocess.Popen(
            [build_lib.nvcc_path(), *build_lib.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out


def bulk_design(lib, build_lib, ops, sms):
    """pack and unpack through the bulk design, over ``ops.parts``."""
    fn = lib.halo_bulk
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ring = BULK_STAGES * (BULK_CHUNK + 8) + SMEM_PER_BLOCK
    per_sm = max(1, SMEM_PER_SM // ring)

    def copy(kind, srcs, dst, n, d, row, lo, hi):
        ps = ops.parts(kind, n, d, row, lo, hi)
        total = n * sum(-(-p.bytes // BULK_CHUNK) for p in ps)
        geom = [v for p in ps for v in p] + [0] * (5 * (3 - len(ps)))
        ptrs = [None if t is None else t.data_ptr() for t in srcs]
        ptrs += [None] * (3 - len(ptrs))
        build_lib.check(fn(*ptrs, dst.data_ptr(),
                           (ctypes.c_longlong * 15)(*geom), n, BULK_CHUNK,
                           max(1, min(total, sms * per_sm)), BULK_STAGES,
                           torch.cuda.current_stream().cuda_stream),
                        f"bulk {kind}")

    def pack(x, lo, hi):
        n, d = x.shape[:2]
        row = math.prod(x.shape[2:]) * x.element_size()
        buf = torch.empty(n * (lo + hi) * math.prod(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        copy("pack", (x, x), buf, n, d, row, lo, hi)
        return buf

    def unpack(x, lo_buf, hi_buf):
        n, d = x.shape[:2]
        row = math.prod(x.shape[2:]) * x.element_size()
        lo = 0 if lo_buf is None else lo_buf.shape[1]
        hi = 0 if hi_buf is None else hi_buf.shape[1]
        out = torch.empty((n, lo + d + hi) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        copy("unpack", (lo_buf, x, hi_buf), out, n, d, row, lo, hi)
        return out

    return pack, unpack


def cold_ms(fn, flush, reps):
    """Median device time of one call of ``fn`` after an L2-evicting
    write, from CUDA events around the call. As in ``queued_ms``, the
    ``reps`` (write, call) pairs are queued behind a spin kernel, so
    the host's time between them never reaches the events."""
    def one():
        flush.zero_()
        fn()
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(3 * host_s * 2e9) + 100_000)  # cycles at <= 2 GHz
    for a, b in evs:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def grid_stride(lib, build_lib):
    """pack and unpack through the grid-stride design's entry points."""
    pk, up = lib.halo_pack, lib.halo_unpack
    pk.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    up.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    pk.restype = up.restype = ctypes.c_int

    def pack(x, lo, hi):
        n, d = x.shape[:2]
        row = math.prod(x.shape[2:]) * x.element_size()
        buf = torch.empty(n * (lo + hi) * math.prod(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        build_lib.check(pk(x.data_ptr(), buf.data_ptr(), n, d, row, lo, hi,
                           torch.cuda.current_stream().cuda_stream),
                        "grid-stride pack")
        return buf

    def unpack(x, lo_buf, hi_buf):
        n, d = x.shape[:2]
        row = math.prod(x.shape[2:]) * x.element_size()
        lo = 0 if lo_buf is None else lo_buf.shape[1]
        hi = 0 if hi_buf is None else hi_buf.shape[1]
        out = torch.empty((n, lo + d + hi) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        build_lib.check(up(None if lo_buf is None else lo_buf.data_ptr(),
                           x.data_ptr(),
                           None if hi_buf is None else hi_buf.data_ptr(),
                           out.data_ptr(), n, d, row, lo, hi,
                           torch.cuda.current_stream().cuda_stream),
                        "grid-stride unpack")
        return out

    return pack, unpack


def faces(cs, cosmoflow, unet3d, plan_lib, depth, get_config):
    """(shape, lo, hi, precision) of every face of the sweep."""
    cfgs = {n: get_config(n) for n in ("cosmoflow-128", "cosmoflow-512")}
    keys = set()
    for name, batch, S, prec, kind in cs.SPATIAL:
        plan = cs.spatial_plan(plan_lib, depth, cfgs[name], S, kind)
        keys |= {(sc.shape, sc.lo, sc.hi, prec)
                 for sc in cosmoflow.split_convs(cfgs[name], plan, batch)}
    ucfg = get_config("unet3d-256")
    for S, prec in cs.UNET_HALO:
        plan = plan_lib.legacy_convnet_plan(ucfg, depth, (S, 1, 1))
        keys |= {(sc.shape, sc.lo, sc.hi, prec)
                 for sc in unet3d.split_convs(ucfg, plan, 1)}
    return sorted(keys), cfgs["cosmoflow-128"], ucfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.json"),
                    help="where to write every row as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("halo_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.kernels import _build
    from repro_torch.kernels.halo_pack import ops, ref
    from repro_torch.models import cosmoflow, unet3d

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    procs = build(_build)
    _build.build_all(("halo_pack",))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"the {name} design did not build:\n{out}")
        libs[name] = ctypes.CDLL(so)
    designs = {"grid-stride": grid_stride(libs["grid_stride"], _build),
               "bulk": bulk_design(libs["bulk"], _build, ops, ops._sms(0))}
    depth = SpatialPartitioning(("model", None, None))
    keys, cf128, ucfg = faces(cs, cosmoflow, unet3d, plan_lib, depth,
                              get_config)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    floor = cs.queued_ms(lambda: torch.cuda._sleep(0))
    cold_floor = cold_ms(lambda: None, flush, args.reps)
    print(json.dumps({"launch_floor_ms": floor,
                      "cold_floor_ms": cold_floor}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = {"pack": {}, "unpack": {}}
    for shape, lo, hi, prec in keys:
        x = torch.randn(shape, generator=g, device="cuda").to(
            cs.DTYPES[prec])
        n, d, h, w, c = shape
        row = h * w * c * x.element_size()
        bufs = [torch.randn((n, m, h, w, c), generator=g, device="cuda").to(
            x.dtype) if m else None for m in (lo, hi)]
        nxt, prv = x[:, d - lo:], x[:, :hi]
        parts = [b for b in (bufs[0], x, bufs[1]) if b is not None]
        calls = {
            "pack": (lambda: ops.pack(x, lo, hi).buf,
                     {k: (lambda f=f: f[0](x, lo, hi))
                      for k, f in designs.items()},
                     lambda: torch.cat((nxt, prv), 1),
                     ref.pack(x, lo, hi).buf),
            "unpack": (lambda: ops.unpack(x, *bufs),
                       {k: (lambda f=f: f[1](x, *bufs))
                        for k, f in designs.items()},
                       lambda: torch.cat(parts, 1), ref.unpack(x, *bufs))}
        for kind, (port, carried, cat, want) in calls.items():
            def fn(name):
                if name in carried:
                    return carried[name]
                if name == "torch.cat":
                    return cat
                patches = VARIANTS[name]

                def call():
                    with patched(ops, patches):
                        return port()
                return call if patches else port
            vectors = {}
            for name in VARIANTS:
                got = fn(name)()
                torch.cuda.synchronize()
                # torch.cat of the faces lays pack's out sample by sample
                if name == "torch.cat" and kind == "pack":
                    continue
                if not torch.equal(got.reshape(-1), want.reshape(-1)):
                    raise SystemExit(f"{name} {kind} {shape} lo={lo} "
                                     f"hi={hi} {prec} differs")
                if VARIANTS[name] is not None:
                    with patched(ops, VARIANTS[name]):
                        vectors[name] = ops.split(
                            ops.parts(kind, n, d, row, lo, hi), n,
                            ops._sms(0)).vectors
            hot = {name: [] for name in VARIANTS}
            cold = {name: [] for name in VARIANTS}
            for name in list(VARIANTS) + list(reversed(VARIANTS)):
                hot[name].append(cs.queued_ms(fn(name), args.reps))
                cold[name].append(cold_ms(fn(name), flush, args.reps))
            work = n * sum(p.bytes for p in ops.parts(kind, n, d, row, lo,
                                                      hi))
            r = {"kind": kind, "x": list(shape), "lo": lo, "hi": hi,
                 "dtype": prec, "bytes_read": work,
                 "bound_ms": 2 * work / cs.PEAK_BYTES * 1e3,
                 "launch_floor_ms": floor, "cold_floor_ms": cold_floor,
                 "vectors": vectors["as built"], "ms": hot, "cold_ms": cold}
            rows[kind][(shape, lo, hi, prec)] = r
            print(json.dumps(r), flush=True)
        del x, bufs, nxt, prv, parts, calls
        torch.cuda.empty_cache()

    # per-forward sums, as chip_smoke.py's summary and PERF.md row 3-4
    sums = {}
    for kind, plan_kind in (("pack", "fixed"), ("unpack", "deep")):
        plan = cs.spatial_plan(plan_lib, depth, cf128, 2, plan_kind)
        sel = [rows[kind][(sc.shape, sc.lo, sc.hi, "fp32")]
               for sc in cosmoflow.split_convs(cf128, plan, 4)
               if kind == "pack" or sc.no_interior]
        sums[f"{kind} cosmoflow-128 b4 S=2 {plan_kind}"] = (2, sel)
        for S, prec in cs.UNET_HALO:
            plan = plan_lib.legacy_convnet_plan(ucfg, depth, (S, 1, 1))
            sel = [rows[kind][(sc.shape, sc.lo, sc.hi, prec)]
                   for sc in unet3d.split_convs(ucfg, plan, 1)
                   if kind == "pack" or sc.no_interior]
            if sel:
                sums[f"{kind} unet3d-256 b1 S={S} {prec}"] = (S, sel)
    for tag, (S, sel) in list(sums.items()):
        sums[tag] = {t: {name: [sum(S * r[t][name][i] for r in sel)
                                for i in (0, 1)] for name in VARIANTS}
                     for t in ("ms", "cold_ms")}
        print(json.dumps({"per_forward": tag, **sums[tag]}), flush=True)
    # faces where the kernel as built is slower than another beyond the
    # rounds' spread: its faster round slower than their slower round
    misses = {}
    for t in ("ms", "cold_ms"):
        for other in ("grid-stride", "torch.cat"):
            bad = [{"kind": r["kind"], "x": r["x"], "lo": r["lo"],
                    "hi": r["hi"], "dtype": r["dtype"],
                    "as built": r[t]["as built"], other: r[t][other]}
                   for k in rows.values() for r in k.values()
                   if min(r[t]["as built"]) > max(r[t][other])]
            misses[f"{t} vs {other}"] = bad
            print(json.dumps({"slower_than": other, "timing": t,
                              "faces": len(bad), "of": sum(
                                  len(k) for k in rows.values()),
                              "rows": bad}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"launch_floor_ms": floor, "cold_floor_ms": cold_floor,
                   "per_forward": sums, "misses": misses,
                   "rows": [r for k in rows.values() for r in k.values()]},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
