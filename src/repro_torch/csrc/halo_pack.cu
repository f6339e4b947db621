// Halo pack and unpack along depth for NDHWC activations, for Hopper
// (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/halo_pack/kernel.py:
//   pack_depth   (:26) -> ops.pack:   the trailing `lo` depth rows of each
//                        sample (sent to the next shard) and the leading
//                        `hi` rows (sent to the previous shard), written in
//                        one launch into ONE allocation:
//                        [to_next (N,lo,H,W,C) | to_prev (N,hi,H,W,C)].
//   unpack_depth (:69) -> ops.unpack: [lo_buf | x | hi_buf] along depth,
//                        written in one launch into one (N,D+lo+hi,H,W,C)
//                        buffer.
//
// Both are pure data movement: each byte is read once and written once.
// One depth row of one sample is H*W*C contiguous elements, so each
// sample's face (or body) is ONE contiguous run of bytes: 2 runs a sample
// for pack (to_next, to_prev), 3 for unpack (lo_buf, x, hi_buf). What
// bounds a call depends on its size:
//   - at the main path's faces (a few MB a launch) the launch and ONE
//     DRAM round trip: the time is set by latency, not by bytes;
//   - at the largest faces and bodies (hundreds of MB) the bytes, at
//     3.35 TB/s.
//
// One copy engine serves both entry points. A launch's runs are cut into
// fixed chunks; ONE flat chunk index spans every run of every sample, so
// face runs and body runs share the blocks evenly and no block idles
// (samples do not ride on blockIdx.y, so their number is not capped).
// One block copies one chunk and the grid is just the launch's chunks, so
// the resident blocks sweep the runs in order as a memcpy does. Each
// thread issues ALL its loads (1, 2 or 4 vectors of 16 bytes, unrolled)
// before any store, so a call pays one DRAM round trip, not one a vector.
// The host (kernels/halo_pack/ops.py, `split`) picks the vectors a thread,
// and so the chunk, from the launch's total bytes: the widest that still
// give every SM a block, and one a thread once a launch streams past the
// L2.
// A design with bulk asynchronous copies (cp.async.bulk through a ring in
// shared memory, a persistent grid) lost to this one at every size on an
// H100, by ~1 us a call to 8 MB and 1-3% from 8 MB to 4 GB; its source is
// kept in scripts/halo_variants.py, which times it beside this one.
// A chunk whose source and destination are not 16-byte aligned alike, or
// whose size is not a multiple of 16, goes in 16-, 4- or 2-byte vectors
// with its ragged head and tail as 2-byte halves: a depth row need not be
// a multiple of 16 bytes (3*5*3 fp32, odd bf16 rows) and a view may start
// anywhere. The copy is byte-exact, so one kernel serves every float type
// of at least 2 bytes. Offsets are 64-bit: a shard at 512^3 holds more
// than 2^31 elements. A width of 0 (lo = 0 or hi = 0) gives its face no
// chunk.
//
// Plain C interface (loaded with ctypes): ONE entry point, halo_copy, for
// both; it launches on the given stream and returns cudaGetLastError()
// (cudaErrorInvalidValue, without launching, for a split it cannot take).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one chunk a block

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

// n 16-byte vectors from s to d by the block's threads: each thread
// issues its V loads before its V stores.
template <int V>
__device__ __forceinline__ void copy16(const int4* __restrict__ s,
                                       int4* __restrict__ d, uint32_t n,
                                       uint32_t t) {
  for (uint32_t base = t; base < n; base += V * kThreads) {
    int4 r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t i = base + v * kThreads;
      if (i < n) r[v] = __ldg(s + i);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t i = base + v * kThreads;
      if (i < n) d[i] = r[v];
    }
  }
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

__device__ __forceinline__ bool aligned16(const Piece& p) {
  return ((reinterpret_cast<uintptr_t>(p.src) |
           reinterpret_cast<uintptr_t>(p.dst) | p.bytes) & 15) == 0;
}

// one block a chunk: the grid is the launch's chunks
template <int V>
__global__ void __launch_bounds__(kThreads) copy_kernel(Work w) {
  const Piece p = piece(w, blockIdx.x);
  if (aligned16(p)) {
    copy16<V>(reinterpret_cast<const int4*>(p.src),
              reinterpret_cast<int4*>(p.dst), p.bytes / 16, threadIdx.x);
  } else {
    copy_any(p, threadIdx.x, kThreads);
  }
}

// One block a chunk, `vectors` 16-byte vectors a thread; `grid` must be
// the launch's chunks.
cudaError_t launch(Work w, int64_t n, int64_t chunk, int grid, int vectors,
                   cudaStream_t stream) {
  const int64_t per_sample = static_cast<int64_t>(w.part[0].chunks) +
                             w.part[1].chunks + w.part[2].chunks;
  if (n * per_sample == 0) return cudaSuccess;
  // the flat index is 32-bit: at most 2^31 - 1 chunks (blocks) a launch
  if (chunk % 16 != 0 || chunk > (1LL << 30) ||
      n * per_sample > INT32_MAX || grid != n * per_sample) {
    return cudaErrorInvalidValue;
  }
  w.chunk = static_cast<uint32_t>(chunk);
  w.per_sample = static_cast<uint32_t>(per_sample);
  w.total = static_cast<uint32_t>(n * per_sample);
  switch (vectors) {
    case 1: copy_kernel<1><<<grid, kThreads, 0, stream>>>(w); break;
    case 2: copy_kernel<2><<<grid, kThreads, 0, stream>>>(w); break;
    case 4: copy_kernel<4><<<grid, kThreads, 0, stream>>>(w); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One launch over the parts the host laid out (kernels/halo_pack/ops.py,
// `parts`): part p copies, for every sample s < n, geom[5p + 4] bytes from
// src_p + geom[5p] + s * geom[5p + 1] to dst + geom[5p + 2] + s *
// geom[5p + 3]. pack has two parts (to_next, to_prev; both read x),
// unpack three (lo_buf, x, hi_buf); an unused part has 0 bytes.
extern "C" int halo_copy(const void* src0, const void* src1,
                         const void* src2, void* dst, const long long* geom,
                         long long n, long long chunk, int grid, int vectors,
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
  return static_cast<int>(launch(w, n, chunk, grid, vectors,
                                 static_cast<cudaStream_t>(stream)));
}
