// SSD (Mamba2 state-space duality) chunked scan, forward, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan_chunked (body
// _ssd_kernel), reached through src/repro/kernels/ssd_scan/ops.py::ssd_scan;
// the same chunk mathematics as src/repro/models/mamba2.py::ssd_chunked, which
// the port's Mamba2 block replaces with this kernel. Inputs x (B, L, H, P),
// dt (B, L, H), A (H,) fp32, Bm and Cm (B, L, N) (one group shared by all
// heads); per chunk of Q steps, with sig = cumsum(dt * A):
//   y     = ((C Bᵀ) ⊙ exp(sig_q - sig_k) ⊙ dt_k ⊙ [k <= q]) x
//           + exp(sig_q) (C stateᵀ)
//   state = exp(sig_Q) state + xᵀ (B ⊙ exp(sig_Q - sig) dt),  from zero.
// y comes back in x's dtype and the final state in fp32; all arithmetic is
// fp32 on the CUDA cores (no TF32), for fp32 and bf16 inputs.
//
// What bounds it on this card: operations. At Mamba2-370m's layer shape
// (B=4, L=4096, H=32, P=64, N=128, Q=256) one call needs ~26 GFLOP against
// ~0.29 GB moved: ~90 FLOP per byte, above the ~20 FLOP/byte fp32 ridge.
//
// What this design does about it. The TPU runs the chunk axis of its grid in
// order and carries the (P, N) state in VMEM; Hopper's blocks run in no order,
// so the scan is split, as ssd_chunked is, into three launches:
//   1. chunk_state: per (b, chunk, head), the state the chunk adds,
//      xᵀ (B ⊙ w), with w = exp(sig_Q - sig) dt; parallel over all chunks.
//   2. state_pass: per (b, head, state element), the short sequential pass
//      over the chunks, leaving in place the state that ENTERS each chunk,
//      and the final state.
//   3. chunk_output: per (b, chunk, 64-row query tile, 2 heads), the
//      inter-chunk term from the entering state, then the intra-chunk term
//      over the key tiles at or below the diagonal (tiles above it are
//      skipped). C Bᵀ does not depend on the head: a block computes each
//      64 x 64 tile of it once and uses it for its 2 heads (the Pallas
//      kernel recomputes it per head). Two heads, not four, keep the
//      block's accumulators within 128 registers a thread, so two blocks
//      share an SM and one computes while the other waits on its loads:
//      2.50 ms a call against 3.15 ms for four heads and one block per SM
//      (fp32, H100 SXM at 700 W, scripts/ssd_variants.py).
// The Pallas block's Q x Q scores and Q x N operands (512 KB at Q = 256) do
// not fit in 227 KB of shared memory, so every product is tiled: 64 x 64
// output tiles, 4 x 4 per thread in registers, operands staged 32 deep in
// shared memory as fp32. The decay is masked before the exponential (the
// upper triangle of sig_q - sig_k is positive and overflows). Offsets are
// 64-bit. Tensor cores (wgmma, with a TF32 or bf16 contract) are the later,
// fast design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;       // rows and columns of an output tile
constexpr int kLd = kTile + 4;  // shared row stride in floats (16-byte rows)
constexpr int kDepth = 32;      // depth of one staged operand slab
constexpr int kHeads = 2;       // heads per output block, sharing C Bᵀ
constexpr int kCarry = 8;       // chunk states loaded at once by the state pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int64_t B, L;
  int H, P, N, Q;
  int64_t nc;  // chunks per sequence
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[r][c] += sum_k As[k][4 ty + r] * Bs[k][4 tx + c] over DEPTH rows of
// two k-major operands in shared memory (row stride kLd).
template <int DEPTH>
__device__ __forceinline__ void mma_tile(const float* As, const float* Bs, float acc[4][4],
                                         int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < DEPTH; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * kLd + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * kLd + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// One warp: sig[q] = sum_{i <= q} dt_i * a and dts[q] = dt_q for the chunk's
// Q steps of one head (dt at base + q * stride). Each lane sums a run of
// consecutive steps; the runs' totals are scanned across the warp.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ dt, int64_t base, int64_t stride, float a,
                             int Q, float* sig, float* dts, int lane) {
  const int per = cdiv(Q, 32);
  const int q0 = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    const int q = q0 + i;
    if (q < Q) {
      const float d = to_f32(dt[base + (int64_t)q * stride]);
      dts[q] = d;
      run += d * a;
      sig[q] = run;
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
    if (q < Q) sig[q] += excl;
  }
}

// 1. states[b, c, h, p, n] = sum_k x[k, p] * exp(sig_Q - sig_k) dt_k * B[k, n]
//    and chunk_decay[b, c, h] = sig_Q (the chunk's summed dt * A).
//    One block per (b, c, h, 64-wide p tile, 64-wide n tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ chunk_decay, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // [kDepth][kLd]: x, k-major
  float* Bs = As + kDepth * kLd;       // [kDepth][kLd]: w * B, k-major
  float* sig = Bs + kDepth * kLd;      // [Q]
  float* w = sig + s.Q;                // [Q]: dt, then exp(sig_Q - sig) dt
  const int ptiles = cdiv(s.P, kTile), ntiles = cdiv(s.N, kTile);
  int64_t bid = blockIdx.x;
  const int nt = (int)(bid % ntiles); bid /= ntiles;
  const int pt = (int)(bid % ptiles); bid /= ptiles;
  const int h = (int)(bid % s.H); bid /= s.H;
  const int64_t c = bid % s.nc;
  const int64_t b = bid / s.nc;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int64_t row0 = b * s.L + c * s.Q;  // token index of the chunk's first step

  if (t < 32) chunk_cumsum(dt, row0 * s.H + h, s.H, A[h], s.Q, sig, w, t);
  __syncthreads();
  const float last = sig[s.Q - 1];
  for (int q = t; q < s.Q; q += kThreads) w[q] = expf(last - sig[q]) * w[q];
  if (t == 0 && pt == 0 && nt == 0) chunk_decay[(b * s.nc + c) * s.H + h] = last;

  const int p0 = pt * kTile, n0 = nt * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < s.Q; k0 += kDepth) {
    __syncthreads();  // w is complete; the previous slab is consumed
    for (int e = t; e < kDepth * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile;
      const int q = k0 + kk, p = p0 + col, n = n0 + col;
      const int64_t row = row0 + q;
      As[kk * kLd + col] = (q < s.Q && p < s.P) ? to_f32(x[(row * s.H + h) * s.P + p]) : 0.f;
      Bs[kk * kLd + col] = (q < s.Q && n < s.N) ? w[q] * to_f32(Bm[row * s.N + n]) : 0.f;
    }
    __syncthreads();
    mma_tile<kDepth>(As, Bs, acc, ty, tx);
  }
  float* out = states + ((b * s.nc + c) * s.H + h) * (int64_t)s.P * s.N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty * 4 + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx * 4 + cc;
      if (p < s.P && n < s.N) out[(int64_t)p * s.N + n] = acc[r][cc];
    }
  }
}

// 2. In place: states[b, c, h] <- the state entering chunk c,
//    s_0 = 0, s_{c+1} = exp(chunk_decay[b, c, h]) s_c + states[b, c, h];
//    final[b, h] = s_nc. One thread per (b, h, p, n).
//    The loads of kCarry chunks are issued before their stores, so the pass
//    moves its bytes instead of waiting on one load per chunk.
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ chunk_decay,
                  float* __restrict__ final_state, Shape s) {
  const int64_t pn = (int64_t)s.P * s.N;
  const int64_t per_bh = (pn + kThreads - 1) / kThreads;
  const int64_t bh = blockIdx.x / per_bh;
  const int64_t e = (blockIdx.x % per_bh) * kThreads + threadIdx.x;
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

// 3. y for one (b, c, 64-row query tile i, group of kHeads heads, 64-wide p
//    tile): exp(sig_q) C_q · s_in, then the masked-decay products over the
//    key tiles j <= i. C Bᵀ of each (i, j) tile is computed once for the
//    group's heads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ states,
                    T* __restrict__ y, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [kDepth][kLd]: C of the query tile, n-major
  float* Bs = Cs + kDepth * kLd;     // [kDepth][kLd]: B of the key tile, or s_in, n-major
  float* CBt = Bs + kDepth * kLd;    // [kTile][kLd]: (C Bᵀ)ᵀ, key-major
  float* St = CBt + kTile * kLd;     // [kTile][kLd]: one head's masked scores, key-major
  float* xs = St + kTile * kLd;      // [kTile][kLd]: one head's x of the key tile
  float* sig = xs + kTile * kLd;     // [kHeads][Q]
  float* dts = sig + kHeads * s.Q;   // [kHeads][Q]
  const int itiles = cdiv(s.Q, kTile), groups = cdiv(s.H, kHeads), ptiles = cdiv(s.P, kTile);
  int64_t bid = blockIdx.x;
  const int pt = (int)(bid % ptiles); bid /= ptiles;
  const int g = (int)(bid % groups); bid /= groups;
  const int64_t bc = bid % (s.B * s.nc); bid /= s.B * s.nc;
  const int i = itiles - 1 - (int)bid;  // the longest rows of tiles go first
  const int64_t b = bc / s.nc, c = bc % s.nc;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16, warp = t / 32, lane = t % 32;
  const int h0 = g * kHeads;
  const int nh = min(kHeads, s.H - h0);
  const int64_t row0 = b * s.L + c * s.Q;
  const int q0 = i * kTile, p0 = pt * kTile;

  if (warp < nh)
    chunk_cumsum(dt, row0 * s.H + h0 + warp, s.H, A[h0 + warp], s.Q, sig + warp * s.Q,
                 dts + warp * s.Q, lane);

  float acc[kHeads][4][4] = {};
  // ---- inter-chunk: acc = exp(sig_q) * C_q . s_in[p, :] (chunk 0 enters at zero)
  if (c > 0) {
    const float* s_in = states + (bc * s.H + h0) * (int64_t)s.P * s.N;
    for (int n0 = 0; n0 < s.N; n0 += kDepth) {
      __syncthreads();
      for (int e = t; e < kDepth * kTile; e += kThreads) {
        const int nn = e % kDepth, qq = e / kDepth;
        const int q = q0 + qq, n = n0 + nn;
        Cs[nn * kLd + qq] = (q < s.Q && n < s.N) ? to_f32(Cm[(row0 + q) * s.N + n]) : 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh < nh) {
          if (hh > 0) __syncthreads();  // the previous head's product is done with Bs
          const float* sh = s_in + (int64_t)hh * s.P * s.N;
          for (int e = t; e < kDepth * kTile; e += kThreads) {
            const int nn = e % kDepth, pp = e / kDepth;
            const int p = p0 + pp, n = n0 + nn;
            Bs[nn * kLd + pp] = (p < s.P && n < s.N) ? sh[(int64_t)p * s.N + n] : 0.f;
          }
          __syncthreads();
          mma_tile<kDepth>(Cs, Bs, acc[hh], ty, tx);
        }
      }
    }
    __syncthreads();  // sig is complete (and read below)
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh < nh) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = q0 + ty * 4 + r;
          const float f = q < s.Q ? expf(sig[hh * s.Q + q]) : 0.f;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[hh][r][cc] *= f;
        }
      }
    }
  }

  // ---- intra-chunk: the key tiles at or below the diagonal
  for (int j = 0; j <= i; ++j) {
    const int k0 = j * kTile;
    float cb[4][4] = {};
    for (int n0 = 0; n0 < s.N; n0 += kDepth) {
      __syncthreads();  // the previous slab (or head's scores) is consumed
      for (int e = t; e < kDepth * kTile; e += kThreads) {
        const int nn = e % kDepth, rr = e / kDepth;
        const int n = n0 + nn, q = q0 + rr, k = k0 + rr;
        Cs[nn * kLd + rr] = (q < s.Q && n < s.N) ? to_f32(Cm[(row0 + q) * s.N + n]) : 0.f;
        Bs[nn * kLd + rr] = (k < s.Q && n < s.N) ? to_f32(Bm[(row0 + k) * s.N + n]) : 0.f;
      }
      __syncthreads();
      mma_tile<kDepth>(Cs, Bs, cb, ty, tx);
    }
    // cb[r][cc] = (C Bᵀ)[q = 4 ty + r][k = 4 tx + cc]; store it key-major
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float4*>(CBt + (tx * 4 + cc) * kLd + ty * 4) =
          make_float4(cb[0][cc], cb[1][cc], cb[2][cc], cb[3][cc]);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh < nh) {
        __syncthreads();  // CBt is complete; the previous head is done with St and xs
        const float* sg = sig + hh * s.Q;
        const float* dd = dts + hh * s.Q;
        for (int e = t; e < kTile * kTile; e += kThreads) {
          const int kl = e / kTile, ql = e % kTile;
          const int k = k0 + kl, q = q0 + ql;
          // mask BEFORE the exponential: sig_q - sig_k > 0 above the diagonal
          St[kl * kLd + ql] =
              (k <= q && q < s.Q) ? CBt[kl * kLd + ql] * expf(sg[q] - sg[k]) * dd[k] : 0.f;
          const int p = p0 + ql;
          xs[kl * kLd + ql] = (k < s.Q && p < s.P)
                                  ? to_f32(x[((row0 + k) * s.H + h0 + hh) * s.P + p])
                                  : 0.f;
        }
        __syncthreads();
        mma_tile<kTile>(St, xs, acc[hh], ty, tx);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh < nh) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = q0 + ty * 4 + r;
        if (q >= s.Q) continue;
        T* out = y + ((row0 + q) * s.H + h0 + hh) * s.P;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int p = p0 + tx * 4 + cc;
          if (p < s.P) out[p] = from_f32<T>(acc[hh][r][cc]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* final_state, void* states, void* chunk_decay, int64_t B, int64_t L,
           int H, int P, int N, int Q, void* stream) {
  const Shape s{B, L, H, P, N, Q, L / Q};
  cudaStream_t st = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(chunk_decay);
  cudaError_t err;

  const size_t smem1 = sizeof(float) * (2 * kDepth * kLd + 2 * (size_t)Q);
  err = cudaFuncSetAttribute(chunk_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks1 = B * s.nc * H * cdiv(P, kTile) * cdiv(N, kTile);
  chunk_state_kernel<T><<<(unsigned)blocks1, kThreads, smem1, st>>>(xt, dtt, Af, Bt, sts, dec, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t blocks2 = B * H * (((int64_t)P * N + kThreads - 1) / kThreads);
  state_pass_kernel<<<(unsigned)blocks2, kThreads, 0, st>>>(sts, dec,
                                                            static_cast<float*>(final_state), s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem3 =
      sizeof(float) * (2 * kDepth * kLd + 3 * kTile * kLd + 2 * (size_t)kHeads * Q);
  err = cudaFuncSetAttribute(chunk_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks3 =
      B * s.nc * cdiv(Q, kTile) * cdiv(H, kHeads) * cdiv(P, kTile);
  chunk_output_kernel<T><<<(unsigned)blocks3, kThreads, smem3, st>>>(
      xt, dtt, Af, Bt, Ct, sts, static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* x, const void* dt, const void* A, const void* Bm,        \
                      const void* Cm, void* y, void* final_state, void* states,            \
                      void* chunk_decay, int64_t B, int64_t L, int H, int P, int N, int Q, \
                      void* stream) {                                                       \
    return launch<T>(x, dt, A, Bm, Cm, y, final_state, states, chunk_decay, B, L, H, P, N, \
                     Q, stream);                                                            \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
