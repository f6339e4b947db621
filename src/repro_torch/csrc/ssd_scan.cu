// SSD (Mamba2 state-space duality) chunked scan, forward, on Hopper's tensor
// cores, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan_chunked (body
// _ssd_kernel), reached through src/repro/kernels/ssd_scan/ops.py::ssd_scan;
// the same chunk mathematics as src/repro/models/mamba2.py::ssd_chunked, which
// the port's Mamba2 block replaces with this kernel. Inputs x (B, L, H, P),
// dt (B, L, H), A (H,) fp32, Bm and Cm (B, L, N) (one group shared by all
// heads); per chunk of Q steps, with sig = cumsum(dt * A):
//   y     = ((C Bᵀ) ⊙ exp(sig_q - sig_k) ⊙ dt_k ⊙ [k <= q]) x
//           + exp(sig_q) (C stateᵀ)
//   state = exp(sig_Q) state + (w ⊙ x)ᵀ B,  w = exp(sig_Q - sig) dt,  from zero.
// y comes back in x's dtype and the final state in fp32. x, Bm and Cm are
// read in place: x's rows (tokens) and batches at strides the caller gives,
// heads packed at P, p contiguous; Bm and Cm share one row and one batch
// stride (views of the Mamba2 block's conv output need no copy). dt and A
// are contiguous.
//
// What bounds it on this card: operations. At Mamba2-370m's layer shape
// (B=4, L=4096, H=32, P=64, N=128, Q=256) one call needs ~26 GFLOP against
// ~0.29 GB (fp32) moved; in fp32 the products run as 3xTF32 (3 x 26 GFLOP at
// 495 TFLOP/s: 0.156 ms), in bf16 the bytes bound it (0.044 ms).
//
// The design: every product on the tensor cores through mma.sync (m16n8k8
// TF32, m16n8k16 bf16, fp32 accumulators). Operand tiles are copied into
// shared memory as they lie in device memory by cp.async, 16 bytes a copy,
// two stages deep: a block's copies of the next slab or tile are in flight
// while it computes on the current one, and hold no registers. A warp builds
// its fragments from the tiles by hand, in whichever layout a tile has (K- or
// M/N-contiguous), so the MN-major operands (x and B of the chunk state, x of
// the intra-chunk term) need no transposed copy; row paddings keep the
// fragment loads free of bank conflicts. A "unit" is what one 32-bit
// fragment register covers along k: one element in TF32, two in bf16. Three
// launches, as the TPU's sequential chunk axis has no counterpart on blocks
// that run in no order:
//   1. chunk_state: two kinds of block in one grid.
//      - C Bᵀ, once per (b, chunk), for the 64 x 64 tiles on and below the
//        diagonal, into an fp32 (B, nc, Q, Q) scratch: it does not depend
//        on the head (the Pallas kernel recomputes it per head).
//      - per (b, chunk, kStateHeads heads, 64-wide p tile, 128-wide n tile)
//        the state the chunk adds, (w ⊙ x)ᵀ B, the B tile staged once for
//        the heads; w scales x as its fragments are built; chunk_decay =
//        sig_Q.
//   2. state_pass: per (b, head, state element), the short sequential pass
//      over the chunks (fp32, CUDA cores), leaving in place the state that
//      ENTERS each chunk, and the final state.
//   3. chunk_output: per (b, chunk, 64-row query tile, kHeads heads, 64-wide
//      p tile): the inter-chunk term C s_inᵀ scaled by exp(sig_q), then the
//      intra-chunk term over the key tiles at or below the diagonal. The
//      scores are made in registers, in the A fragment's layout, from the C
//      Bᵀ scratch: masked BEFORE the exponential (the upper triangle of
//      sig_q - sig_k is positive and overflows); tiles above the diagonal,
//      and the k steps of the diagonal tile above a warp's rows, are skipped.
//      The longest rows of tiles go first.
// The decays are ex2.approx of a difference of cumulative sums, scaled by
// log2(e) after the subtraction (about 2 ulp); exp(sig_q) is expf. In
// launch 3 and the C Bᵀ tiles each slab's or tile's products are
// accumulated on the tensor cores and then added to the result in fp32,
// rounded to nearest (the chunk states keep one accumulator: their
// registers are spent). A row that does not start on 16 bytes is copied
// element by element, in order.
//
// Which operands round, and how:
// - fp32: 3xTF32 on every product. v = hi + lo with hi = cvt.rna.tf32(v)
//   and lo = v - hi (the tensor core reads lo truncated to TF32); each
//   product is lo·hi + hi·lo + hi·hi, lo·lo left out. ~2^-21 of each
//   operand is lost, the accuracy of an fp32 sum (ref.ssd_scan_tc emulates
//   it).
// - bf16: x, B and C are exact bf16 operands. The fp32 values the kernel
//   makes — w ⊙ x, the scores, the entering state — are split into three
//   bf16 parts (kBf16Parts: hi, mid, lo, each the rounding of what the
//   parts before it left; 24 bits, an fp32 value's own) that multiply the
//   exact operand in turn, so C Bᵀ is one product and the other three are
//   three each. Two parts (16 bits) flip ~100x more of y's bf16 roundings,
//   which 48 layers amplify: the scoring check against the plain-scan
//   forward fails with them.
//
// No float atomics: the same bits on every run. Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;         // query rows and key columns of a score tile; p columns
constexpr int kDepth = 32;        // k elements of a slab: keys of the state, n of C Bᵀ and C s_inᵀ
constexpr int kStateN = 128;      // n columns of a chunk-state tile
constexpr int kThreads1 = 256;    // launch 1: 8 warps, 4 a head in the chunk-state tiles
constexpr int kStateHeads = kThreads1 / 128;  // heads a chunk-state tile serves, sharing B
constexpr int kHeads = 1;         // heads a launch-3 block serves, sharing C and C Bᵀ
constexpr int kThreadsOut = 128 * kHeads;  // launch 3: 4 warps of 16 query rows a head
constexpr int kThreadsPass = 256;
constexpr int kCarry = 8;         // chunk states the state pass loads at once
constexpr int kPadMN = 8;         // elements a row of an M/N-contiguous tile is padded by
constexpr int kBf16Parts = 3;     // bf16: the bf16 parts of a computed operand (hi, mid, lo)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct Shape {
  int64_t B, L;
  int H, P, N, Q;
  int64_t nc;      // chunks per sequence
  int64_t xb, xl;  // x's batch and row strides, in elements
  int64_t bb, bl;  // Bm's and Cm's
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// kE: k elements a unit; kWIn / kWMade: the parts (32-bit words) a unit of
// an input / of a value the kernel computed is split into (TF32: hi and lo;
// bf16: an input is exact); kPadK: elements a row of a K-contiguous tile is
// padded by.
template <typename T> struct Prec {  // 3xTF32: every operand split
  static constexpr int kE = 1, kWIn = 2, kWMade = 2, kPadK = 4;
};
template <> struct Prec<__nv_bfloat16> {
  static constexpr int kE = 2, kWIn = 1, kWMade = kBf16Parts, kPadK = 8;
};

__device__ __forceinline__ uint32_t pack_bf16(float k0, float k1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(k0, k1);  // k0 in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// the W parts of the unit v[0..E) as the tensor core takes it: TF32 hi and
// lo; bf16 hi, then each part the rounding of what the parts before it left
template <typename T, int W>
__device__ __forceinline__ void encode(const float* v, uint32_t* w) {
  if constexpr (std::is_same<T, float>::value) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(w[0]) : "f"(v[0]));
    w[1] = __float_as_uint(v[0] - __uint_as_float(w[0]));  // read truncated to TF32
  } else {
    float r0 = v[0], r1 = v[1];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = pack_bf16(r0, r1);
      r0 -= __uint_as_float(w[i] << 16);
      r1 -= __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// ------------------------------------------------------------ copies --
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_prev() {  // all but the latest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of a row into shared memory, the elements at or past `valid` as
// zero: one cp.async where the row allows it.
template <typename S>
__device__ __forceinline__ void copy_chunk(S* dst, const S* src, int valid) {
  constexpr int V = 16 / sizeof(S);
  if (valid <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int bytes = valid >= V ? 16 : valid * (int)sizeof(S);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = i < valid ? src[i] : from_f32<S>(0.f);
  }
}

// R rows by K contiguous elements of a source (row r at src + r * rs; rows
// past `rows` and elements past `ks` as zero) into a tile of row pitch ld.
template <int R, int K, int NT, typename S>
__device__ __forceinline__ void copy_tile(S* dst, int ld, const S* src, int64_t rs, int rows,
                                          int ks) {
  constexpr int V = 16 / sizeof(S), CH = K / V;
  for (int c = threadIdx.x; c < R * CH; c += NT) {
    const int r = c / CH, k = (c % CH) * V;
    copy_chunk(dst + r * ld + k, src + r * rs + k, r < rows ? ks - k : 0);
  }
}

// ------------------------------------------------------ tensor cores --
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One step is 8 units of k (k8 in TF32, k16 in bf16). A lane (g = lane / 4,
// t = lane % 4) holds the A units (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of a 16-row tile and the B units (t, g), (t + 4, g) of an
// 8-column tile: the PTX fragment layouts of mma.m16n8k8 .tf32 and
// mma.m16n8k16 .bf16 alike. The accumulator is the m16n8 C fragment: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA { uint32_t w[3][4]; };  // [part][register]
struct FragB { uint32_t w[3][2]; };

// The E elements of unit (r, u) of a tile: element (r, k) at tile[r * ld + k]
// (KC, K-contiguous) or at tile[k * ld + r].
template <typename T, bool KC, typename S>
__device__ __forceinline__ void unit_vals(const S* tile, int ld, int r, int u,
                                          float (&v)[Prec<T>::kE]) {
  constexpr int E = Prec<T>::kE;
  if constexpr (KC && E == 2 && std::is_same<S, float>::value) {
    const float2 f = *reinterpret_cast<const float2*>(tile + r * ld + 2 * u);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = to_f32(KC ? tile[r * ld + u * E + e] : tile[(u * E + e) * ld + r]);
  }
}

// The W parts of unit (r, u) into w[i][reg], its elements scaled by
// scale[k] where given; an exact bf16 unit is its two elements as they lie.
template <typename T, bool KC, int W, typename S, int R>
__device__ __forceinline__ void unit_words(const S* tile, int ld, int r, int u,
                                           const float* scale, uint32_t (&w)[3][R], int reg) {
  if constexpr (W == 1 && std::is_same<S, __nv_bfloat16>::value) {
    if (scale == nullptr) {
      if constexpr (KC) {
        w[0][reg] = *reinterpret_cast<const uint32_t*>(tile + r * ld + 2 * u);
      } else {
        w[0][reg] = __byte_perm(__bfloat16_as_ushort(tile[2 * u * ld + r]),
                                __bfloat16_as_ushort(tile[(2 * u + 1) * ld + r]), 0x5410);
      }
      return;
    }
  }
  constexpr int E = Prec<T>::kE;
  float v[E];
  unit_vals<T, KC>(tile, ld, r, u, v);
  if (scale != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] *= scale[u * E + e];
  }
  uint32_t parts[W];
  encode<T, W>(v, parts);
#pragma unroll
  for (int i = 0; i < W; ++i) w[i][reg] = parts[i];
}

template <typename T, bool KC, int W, typename S>
__device__ __forceinline__ FragA frag_a(const S* tile, int ld, int r0, int u0, int g, int t,
                                        const float* scale) {
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    unit_words<T, KC, W>(tile, ld, r0 + g + 8 * (i & 1), u0 + t + 4 * (i >> 1), scale, a.w, i);
  return a;
}

template <typename T, bool KC, int W, typename S>
__device__ __forceinline__ FragB frag_b(const S* tile, int ld, int n0, int u0, int g, int t) {
  FragB b;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    unit_words<T, KC, W>(tile, ld, n0 + g, u0 + t + 4 * i, nullptr, b.w, i);
  return b;
}

// c += a b for one step; WA / WB: the parts of a unit. The small products
// go first: TF32 lo·hi, hi·lo, hi·hi; bf16 each lower part of the computed
// operand against the exact one, then hi·hi.
template <typename T, int WA, int WB>
__device__ __forceinline__ void mma_step(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (std::is_same<T, float>::value) {
    mma_tf32(c, a.w[1], b.w[0]);
    mma_tf32(c, a.w[0], b.w[1]);
    mma_tf32(c, a.w[0], b.w[0]);
  } else {
#pragma unroll
    for (int i = WA - 1; i > 0; --i) mma_bf16(c, a.w[i], b.w[0]);
#pragma unroll
    for (int i = WB - 1; i > 0; --i) mma_bf16(c, a.w[0], b.w[i]);
    mma_bf16(c, a.w[0], b.w[0]);
  }
}

// acc[m][n] += A(rows ar + 16 m.., units) B(units, columns bc + 8 n..) over
// KU units of two tiles (KU a multiple of 8); A's elements scaled by
// scale[k] where given.
template <typename T, int MT, int NT, bool AKC, int WA, bool BKC, int WB, typename SA,
          typename SB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const SA* As, int lda, int ar,
                                         const SB* Bs, int ldb, int bc, int KU, int g, int t,
                                         const float* scale) {
#pragma unroll
  for (int u0 = 0; u0 < KU; u0 += 8) {
    if constexpr (MT == 1) {  // one A fragment: each B fragment is used once
      const FragA a = frag_a<T, AKC, WA>(As, lda, ar, u0, g, t, scale);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_step<T, WA, WB>(acc[0][n], a, frag_b<T, BKC, WB>(Bs, ldb, bc + 8 * n, u0, g, t));
    } else {
      FragB b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = frag_b<T, BKC, WB>(Bs, ldb, bc + 8 * n, u0, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const FragA a = frag_a<T, AKC, WA>(As, lda, ar + 16 * m, u0, g, t, scale);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_step<T, WA, WB>(acc[m][n], a, b[n]);
      }
    }
  }
}

// acc += part, element by element, in fp32 rounded to nearest
template <int MT, int NT>
__device__ __forceinline__ void add(float (&acc)[MT][NT][4], const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] += part[m][n][r];
}

// One warp: sd[q] = (sig_q = sum_{i <= q} dt_i * a, dt_q) for the chunk's Q
// steps of one head (dt at base + q * stride). Each lane sums a run of
// consecutive steps; the runs' totals are scanned across the warp.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ dt, int64_t base, int64_t stride, float a,
                             int Q, float2* sd, int lane) {
  const int per = cdiv(Q, 32);
  const int q0 = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    const int q = q0 + i;
    if (q < Q) {
      const float d = to_f32(dt[base + (int64_t)q * stride]);
      run += d * a;
      sd[q] = make_float2(run, d);
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int i = 0; i < per; ++i) {
    const int q = q0 + i;
    if (q < Q) sd[q].x += excl;
  }
}

// Tile geometry, in elements; every tile starts on 16 bytes.
template <typename T>
struct CbTile {  // launch 1, C Bᵀ: a stage holds a C slab and a B slab
  static constexpr int kLd = kDepth + Prec<T>::kPadK;
  static constexpr int kSlab = kTile * kLd, kStage = 2 * kSlab;
  static constexpr size_t kBytes = 2 * kStage * sizeof(T);
};

template <typename T>
struct StateTile {  // launch 1, chunk states: a stage holds each head's x slab and a B slab
  static constexpr int kLdX = kTile + kPadMN, kLdB = kStateN + kPadMN;
  static constexpr int kX = kDepth * kLdX, kStage = kStateHeads * kX + kDepth * kLdB;
  static constexpr size_t kBytes = 2 * kStage * sizeof(T);
};

template <typename T>
struct OutTile {  // launch 3: a stage holds an inter slab or an intra tile
  static constexpr int kE = Prec<T>::kE;
  static constexpr int kLdK = kDepth + Prec<T>::kPadK;  // C and s_in slabs, n-contiguous
  static constexpr int kLdS = kTile + 4 * kE;           // C Bᵀ rows (fp32), key-contiguous
  static constexpr int kLdX = kTile + kPadMN;           // x of the key tile, key-major
  // bytes: the C slab, then each head's s_in slab; or the C Bᵀ tile, then each head's x
  static constexpr size_t kC = kTile * kLdK * sizeof(T), kS = kTile * kLdK * sizeof(float);
  static constexpr size_t kCB = kTile * kLdS * sizeof(float), kX = kTile * kLdX * sizeof(T);
  static constexpr size_t kInter = kC + kHeads * kS, kIntra = kCB + kHeads * kX;
  static constexpr size_t kStage = kInter > kIntra ? kInter : kIntra;
  static constexpr size_t kBytes = 2 * kStage;
};

// 1a. cb[b, c, q, k] = sum_n C[q, n] B[k, n] for the 64 x 64 tile (i, j <= i)
//     of chunk c (q, k < Q). 8 warps: 2 x 32 rows by 4 x 16 columns.
template <typename T>
__device__ void cb_tile(const T* __restrict__ Bm, const T* __restrict__ Cm,
                        float* __restrict__ cb, const Shape& s, int64_t bid, char* smem) {
  using L = CbTile<T>;
  T* buf = reinterpret_cast<T*>(smem);  // [2 stages][C slab, B slab]
  const int itiles = cdiv(s.Q, kTile);
  const int tri = itiles * (itiles + 1) / 2;
  int j = (int)(bid % tri), i = 0;
  while (j > i) j -= ++i;  // (i, j): the triangle's tiles row by row
  const int64_t bc = bid / tri, b = bc / s.nc, c = bc % s.nc;
  const int q0 = i * kTile, k0 = j * kTile;
  const T* Cb = Cm + b * s.bb + (c * s.Q + q0) * s.bl;
  const T* Bb = Bm + b * s.bb + (c * s.Q + k0) * s.bl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 16;
  const int slabs = cdiv(s.N, kDepth);
  auto issue = [&](int sl) {
    T* st = buf + (sl & 1) * L::kStage;
    const int n0 = sl * kDepth;
    copy_tile<kTile, kDepth, kThreads1>(st, L::kLd, Cb + n0, s.bl, s.Q - q0, s.N - n0);
    copy_tile<kTile, kDepth, kThreads1>(st + L::kSlab, L::kLd, Bb + n0, s.bl, s.Q - k0,
                                        s.N - n0);
  };
  float acc[2][2][4] = {};
  issue(0);
  cp_commit();
  for (int sl = 0; sl < slabs; ++sl) {
    if (sl + 1 < slabs) issue(sl + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // every thread's copies of this slab have landed
    const T* st = buf + (sl & 1) * L::kStage;
    float part[2][2][4] = {};  // added in fp32, as launch 3 does
    warp_mma<T, 2, 2, true, Prec<T>::kWIn, true, Prec<T>::kWIn>(
        part, st, L::kLd, wr, st + L::kSlab, L::kLd, wc, kDepth / Prec<T>::kE, g, t, nullptr);
    add(acc, part);
    __syncthreads();  // the slab is consumed before its stage is refilled
  }
  float* out = cb + bc * (int64_t)s.Q * s.Q;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = q0 + wr + 16 * m + g + 8 * (r >> 1);
        const int k = k0 + wc + 8 * n + 2 * t + (r & 1);
        if (q < s.Q && k < s.Q) out[(int64_t)q * s.Q + k] = acc[m][n][r];
      }
}

// 1b. states[b, c, h, p, n] = sum_k w_k x[k, p] B[k, n] for kStateHeads
//     heads' 64 x 128 (p, n) tiles, w = exp(sig_Q - sig) dt, and
//     chunk_decay[b, c, h] = sig_Q. 4 warps a head, each 64 rows (p) by 32
//     columns (n).
template <typename T>
__device__ void state_tile(const T* __restrict__ x, const T* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ Bm,
                           float* __restrict__ states, float* __restrict__ chunk_decay,
                           const Shape& s, int64_t bid, char* smem) {
  using L = StateTile<T>;
  T* buf = reinterpret_cast<T*>(smem);  // [2 stages][x slab a head, B slab]
  float2* sd = reinterpret_cast<float2*>(smem + L::kBytes);      // [heads][Q]: (sig, dt)
  const int qs = cdiv(s.Q, kDepth) * kDepth;                      // whole slabs
  float* w = reinterpret_cast<float*>(sd + kStateHeads * s.Q);   // [heads][qs], 0 past Q
  const int ptiles = cdiv(s.P, kTile), ntiles = cdiv(s.N, kStateN);
  const int nt = (int)(bid % ntiles); bid /= ntiles;
  const int pt = (int)(bid % ptiles); bid /= ptiles;
  const int groups = cdiv(s.H, kStateHeads);
  const int h0 = (int)(bid % groups) * kStateHeads; bid /= groups;
  const int64_t c = bid % s.nc, b = bid / s.nc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int hh = warp / 4, h = h0 + hh;  // this warp's head
  const int64_t tok0 = c * s.Q;  // the chunk's first step
  const int p0 = pt * kTile, n0 = nt * kStateN;
  const T* xb = x + b * s.xb + tok0 * s.xl + (int64_t)h0 * s.P + p0;
  const T* Bb = Bm + b * s.bb + tok0 * s.bl + n0;
  const int slabs = cdiv(s.Q, kDepth);
  auto issue = [&](int sl) {
    T* st = buf + (sl & 1) * L::kStage;
    const int k0 = sl * kDepth;
#pragma unroll
    for (int e = 0; e < kStateHeads; ++e)
      copy_tile<kDepth, kTile, kThreads1>(st + e * L::kX, L::kLdX, xb + k0 * s.xl + e * s.P,
                                          s.xl, s.Q - k0, h0 + e < s.H ? s.P - p0 : 0);
    copy_tile<kDepth, kStateN, kThreads1>(st + kStateHeads * L::kX, L::kLdB, Bb + k0 * s.bl,
                                          s.bl, s.Q - k0, s.N - n0);
  };
  issue(0);
  cp_commit();

  if (warp % 4 == 0 && h < s.H)
    chunk_cumsum(dt, (b * s.L + tok0) * s.H + h, s.H, A[h], s.Q, sd + hh * s.Q, lane);
  __syncthreads();
  for (int e = tid; e < kStateHeads * qs; e += kThreads1) {
    const int q = e % qs;
    const float2* sdh = sd + (e / qs) * s.Q;
    w[e] = q < s.Q ? ex2((sdh[s.Q - 1].x - sdh[q].x) * kLog2e) * sdh[q].y : 0.f;
  }
  if (tid % 128 == 0 && h < s.H && pt == 0 && nt == 0)
    chunk_decay[(b * s.nc + c) * s.H + h] = sd[hh * s.Q + s.Q - 1].x;

  float acc[4][4][4] = {};
  for (int sl = 0; sl < slabs; ++sl) {
    if (sl + 1 < slabs) issue(sl + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // the slab has landed (and w is complete)
    const T* st = buf + (sl & 1) * L::kStage;
    warp_mma<T, 4, 4, false, Prec<T>::kWMade, false, Prec<T>::kWIn>(
        acc, st + hh * L::kX, L::kLdX, 0, st + kStateHeads * L::kX, L::kLdB, (warp % 4) * 32,
        kDepth / Prec<T>::kE, g, t, w + hh * qs + sl * kDepth);
    __syncthreads();  // the slab is consumed before its stage is refilled
  }
  if (h >= s.H) return;
  float* out = states + ((b * s.nc + c) * s.H + h) * (int64_t)s.P * s.N;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + 16 * m + g + 8 * (r >> 1);
        const int nn = n0 + (warp % 4) * 32 + 8 * n + 2 * t + (r & 1);
        if (p < s.P && nn < s.N) out[(int64_t)p * s.N + nn] = acc[m][n][r];
      }
}

// 1. The first cb_blocks blocks compute C Bᵀ tiles, the rest chunk states.
template <typename T>
__global__ void __launch_bounds__(kThreads1, 2)
chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, float* __restrict__ states,
                   float* __restrict__ chunk_decay, float* __restrict__ cb, Shape s,
                   int64_t cb_blocks) {
  extern __shared__ __align__(16) char smem[];
  const int64_t bid = blockIdx.x;
  if (bid < cb_blocks)
    cb_tile<T>(Bm, Cm, cb, s, bid, smem);
  else
    state_tile<T>(x, dt, A, Bm, states, chunk_decay, s, bid - cb_blocks, smem);
}

// 2. In place: states[b, c, h] <- the state entering chunk c,
//    s_0 = 0, s_{c+1} = exp(chunk_decay[b, c, h]) s_c + states[b, c, h];
//    final[b, h] = s_nc. One thread per (b, h, p, n).
//    The loads of kCarry chunks are issued before their stores, so the pass
//    moves its bytes instead of waiting on one load per chunk.
__global__ void __launch_bounds__(kThreadsPass)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ chunk_decay,
                  float* __restrict__ final_state, Shape s) {
  const int64_t pn = (int64_t)s.P * s.N;
  const int64_t per_bh = (pn + kThreadsPass - 1) / kThreadsPass;
  const int64_t bh = blockIdx.x / per_bh;
  const int64_t e = (blockIdx.x % per_bh) * kThreadsPass + threadIdx.x;
  if (e >= pn) return;
  const int64_t b = bh / s.H;
  const int h = (int)(bh % s.H);
  const int64_t step = s.H * pn;  // from one chunk's state to the next
  float* p = states + ((b * s.nc) * s.H + h) * pn + e;
  const float* dec = chunk_decay + (b * s.nc) * s.H + h;
  float st = 0.f;
  for (int64_t c0 = 0; c0 < s.nc; c0 += kCarry) {
    float add[kCarry];
#pragma unroll
    for (int u = 0; u < kCarry; ++u)
      if (c0 + u < s.nc) add[u] = p[(c0 + u) * step];
#pragma unroll
    for (int u = 0; u < kCarry; ++u) {
      if (c0 + u < s.nc) {
        p[(c0 + u) * step] = st;
        st = expf(dec[(c0 + u) * s.H]) * st + add[u];
      }
    }
  }
  final_state[bh * pn + e] = st;
}

// 3. y for one (b, c, 64-row query tile i, kHeads heads, 64-wide p tile):
//    4 warps a head, each 16 query rows by 64 p columns. The heads share the
//    C slabs and C Bᵀ tiles. Phases: the slabs of n of the inter-chunk term
//    (chunk 0 enters at zero, so it has none), then the key tiles j <= i.
template <typename T>
__global__ void __launch_bounds__(kThreadsOut, 3)
chunk_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Cm,
                    const float* __restrict__ states, const float* __restrict__ cb,
                    T* __restrict__ y, Shape s) {
  using L = OutTile<T>;
  constexpr int E = L::kE, kWIn = Prec<T>::kWIn, kWMade = Prec<T>::kWMade;
  extern __shared__ __align__(16) char smem[];
  float2* sd = reinterpret_cast<float2*>(smem + L::kBytes);  // [heads][Q]: (sig, dt)
  const int itiles = cdiv(s.Q, kTile), ptiles = cdiv(s.P, kTile), groups = cdiv(s.H, kHeads);
  int64_t bid = blockIdx.x;
  const int pt = (int)(bid % ptiles); bid /= ptiles;
  const int h0 = (int)(bid % groups) * kHeads; bid /= groups;
  const int64_t bc = bid % (s.B * s.nc); bid /= s.B * s.nc;
  const int i = itiles - 1 - (int)bid;  // the longest rows of tiles go first
  const int64_t b = bc / s.nc, c = bc % s.nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int hh = warp / 4, h = h0 + hh;  // this warp's head
  const int64_t tok0 = c * s.Q;
  const int q0 = i * kTile, p0 = pt * kTile, wr = (warp % 4) * 16;
  const T* xb = x + b * s.xb + tok0 * s.xl + (int64_t)h0 * s.P + p0;
  const T* Cb = Cm + b * s.bb + (tok0 + q0) * s.bl;
  const int64_t pn = (int64_t)s.P * s.N;
  const float* s_in = states + (bc * s.H + h0) * pn + (int64_t)p0 * s.N;
  const float* cbp = cb + bc * (int64_t)s.Q * s.Q + (int64_t)q0 * s.Q;
  const float2* sdh = sd + hh * s.Q;
  const int inter = c > 0 ? cdiv(s.N, kDepth) : 0, phases = inter + i + 1;
  auto issue = [&](int ph) {
    char* st = smem + (ph & 1) * L::kStage;
    if (ph < inter) {
      const int n0 = ph * kDepth;
      copy_tile<kTile, kDepth, kThreadsOut>(reinterpret_cast<T*>(st), L::kLdK, Cb + n0, s.bl,
                                            s.Q - q0, s.N - n0);
#pragma unroll
      for (int e = 0; e < kHeads; ++e)
        copy_tile<kTile, kDepth, kThreadsOut>(reinterpret_cast<float*>(st + L::kC + e * L::kS),
                                              L::kLdK, s_in + e * pn + n0, s.N,
                                              h0 + e < s.H ? s.P - p0 : 0, s.N - n0);
    } else {
      const int k0 = (ph - inter) * kTile;
      copy_tile<kTile, kTile, kThreadsOut>(reinterpret_cast<float*>(st), L::kLdS, cbp + k0,
                                           s.Q, s.Q - q0, s.Q - k0);
#pragma unroll
      for (int e = 0; e < kHeads; ++e)
        copy_tile<kTile, kTile, kThreadsOut>(reinterpret_cast<T*>(st + L::kCB + e * L::kX),
                                             L::kLdX, xb + k0 * s.xl + e * s.P, s.xl, s.Q - k0,
                                             h0 + e < s.H ? s.P - p0 : 0);
    }
  };
  issue(0);
  cp_commit();
  if (warp % 4 == 0 && h < s.H)
    chunk_cumsum(dt, (b * s.L + tok0) * s.H + h, s.H, A[h], s.Q, sd + hh * s.Q, lane);

  // Each phase's products go to a fresh accumulator on the tensor cores and
  // are added to y's in fp32, rounded to nearest: the tensor cores' own
  // fp32 accumulation does not round to nearest, and its error grows with
  // the products chained into one accumulator.
  float acc[1][8][4] = {};
  for (int ph = 0; ph < phases; ++ph) {
    float part[1][8][4] = {};
    if (ph + 1 < phases) issue(ph + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // the phase's tiles have landed; sd is complete
    const char* st = smem + (ph & 1) * L::kStage;
    if (ph < inter) {
      warp_mma<T, 1, 8, true, kWIn, true, kWMade>(
          part, reinterpret_cast<const T*>(st), L::kLdK, wr,
          reinterpret_cast<const float*>(st + L::kC + hh * L::kS), L::kLdK, 0, kDepth / E, g, t,
          nullptr);
      add(acc, part);
      if (ph == inter - 1) {  // the inter-chunk term, times exp(sig_q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = q0 + wr + g + 8 * half;
          const float f = q < s.Q ? expf(sdh[q].x) : 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[0][n][2 * half] *= f;
            acc[0][n][2 * half + 1] *= f;
          }
        }
      }
    } else {
      const int j = ph - inter, k0 = j * kTile;
      const float* cbs = reinterpret_cast<const float*>(st);
      const T* xs = reinterpret_cast<const T*>(st + L::kCB + hh * L::kX);
      float sq[2];  // sig of the lane's two rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + wr + g + 8 * half;
        sq[half] = q < s.Q ? sdh[q].x : 0.f;
      }
#pragma unroll
      for (int u0 = 0; u0 < kTile / E; u0 += 8) {
        if (j == i && u0 * E > wr + 15) break;  // every key above this warp's rows
        FragA a;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = wr + g + 8 * (ii & 1), u = u0 + t + 4 * (ii >> 1), q = q0 + r;
          float v[E];
          unit_vals<T, true>(cbs, L::kLdS, r, u, v);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int k = k0 + u * E + e;
            const float2 kd = sdh[k < s.Q ? k : 0];
            // mask BEFORE the exponential: sig_q - sig_k > 0 above the diagonal
            v[e] = (k <= q && q < s.Q) ? v[e] * ex2((sq[ii & 1] - kd.x) * kLog2e) * kd.y
                                       : 0.f;
          }
          uint32_t parts[kWMade];
          encode<T, kWMade>(v, parts);
#pragma unroll
          for (int w = 0; w < kWMade; ++w) a.w[w][ii] = parts[w];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma_step<T, kWMade, kWIn>(part[0][n], a,
                                    frag_b<T, false, kWIn>(xs, L::kLdX, 8 * n, u0, g, t));
      }
      add(acc, part);
    }
    __syncthreads();  // the phase is consumed before its stage is refilled
  }

  if (h >= s.H) return;
  T* out = y + ((b * s.L + tok0) * s.H + h) * (int64_t)s.P + p0;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + wr + g + 8 * (r >> 1), p = 8 * n + 2 * t + (r & 1);
      if (q < s.Q && p0 + p < s.P) out[(int64_t)q * s.H * s.P + p] = from_f32<T>(acc[0][n][r]);
    }
}

template <typename T>
size_t state_smem(int Q) {  // bytes
  const size_t tiles = StateTile<T>::kBytes > CbTile<T>::kBytes ? StateTile<T>::kBytes
                                                                 : CbTile<T>::kBytes;
  return tiles + kStateHeads * (8 * (size_t)Q + 4 * (size_t)cdiv(Q, kDepth) * kDepth);
}

template <typename T>
size_t output_smem(int Q) {
  return OutTile<T>::kBytes + 8 * kHeads * (size_t)Q;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* final_state, void* states, void* chunk_decay, void* cb, int64_t B,
           int64_t L, int H, int P, int N, int Q, int64_t xb, int64_t xl, int64_t bb,
           int64_t bl, void* stream) {
  const Shape s{B, L, H, P, N, Q, L / Q, xb, xl, bb, bl};
  cudaStream_t st = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(chunk_decay);
  float* cbs = static_cast<float*>(cb);
  cudaError_t err;

  const int itiles = cdiv(Q, kTile);
  const size_t smem1 = state_smem<T>(Q);
  err = cudaFuncSetAttribute(chunk_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const int64_t cb_blocks = B * s.nc * (itiles * (itiles + 1) / 2);
  const int64_t blocks1 =
      cb_blocks + B * s.nc * cdiv(H, kStateHeads) * cdiv(P, kTile) * cdiv(N, kStateN);
  chunk_state_kernel<T><<<(unsigned)blocks1, kThreads1, smem1, st>>>(xt, dtt, Af, Bt, Ct, sts,
                                                                     dec, cbs, s, cb_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t blocks2 = B * H * (((int64_t)P * N + kThreadsPass - 1) / kThreadsPass);
  state_pass_kernel<<<(unsigned)blocks2, kThreadsPass, 0, st>>>(
      sts, dec, static_cast<float*>(final_state), s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem3 = output_smem<T>(Q);
  err = cudaFuncSetAttribute(chunk_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks3 = B * s.nc * itiles * cdiv(H, kHeads) * cdiv(P, kTile);
  chunk_output_kernel<T><<<(unsigned)blocks3, kThreadsOut, smem3, st>>>(
      xt, dtt, Af, Ct, sts, cbs, static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* x, const void* dt, const void* A, const void* Bm,       \
                      const void* Cm, void* y, void* final_state, void* states,           \
                      void* chunk_decay, void* cb, int64_t B, int64_t L, int H, int P,    \
                      int N, int Q, int64_t xb, int64_t xl, int64_t bb, int64_t bl,       \
                      void* stream) {                                                      \
    return launch<T>(x, dt, A, Bm, Cm, y, final_state, states, chunk_decay, cb, B, L, H, \
                     P, N, Q, xb, xl, bb, bl, stream);                                     \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
