// Halo pack and unpack along depth for NDHWC activations, for Hopper
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
