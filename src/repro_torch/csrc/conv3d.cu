// Direct 3-D convolution, NDHWC activations by DHWIO weights, for sm_90a.
//
// Replaces: src/repro/kernels/conv3d/kernel.py::conv3d_offset_matmul (body
// _conv3d_kernel), reached through src/repro/kernels/conv3d/ops.py::
// conv3d_valid from core/spatial_conv.py::_conv_piece. It computes the same
// function: the sum over the k^3 filter offsets of (voxels x Cin) @
// (Cin x Cout), accumulated in fp32, written in the input's dtype.
//
// What bounds it on this card: operations. A CosmoFlow conv does
// 2*27*Cin*Cout FLOPs per output voxel against (Cin + Cout) activation
// elements moved, i.e. hundreds of FLOPs per byte at every layer but the
// first, far above the H100's ~20 FLOP/byte fp32 ridge.
//
// What this first design does about it: little yet, on purpose. It is a
// direct convolution on the CUDA cores (no tensor cores): one thread computes
// one output voxel for a tile of kCoutTile output channels, looping over
// kd, kh, kw and the input channels with fp32 accumulators in registers. The
// weight slice (k^3 x Cin-chunk x Cout-tile) is staged in shared memory as
// fp32, so every thread of a block reads it as a broadcast. The input is read
// in place: SAME zero padding is a bounds check (no padded copy, and none of
// the k^3 shifted views ops.py materialises), ragged Cout edges are masked,
// and all offsets are 64-bit (a 512^3 x 16 activation has 2^31 elements).
// Implicit GEMM on wgmma with TMA-fed tiles is the later, fast design.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // output voxels per block
constexpr int kCoutTile = 16;        // output channels per thread
constexpr int kSmemFloats = 8192;    // 32 KB of staged weights per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

struct ConvShape {
  int n, din, hin, win, cin;     // input (unpadded)
  int dout, hout, wout, cout;    // output
  int k, stride;
  int pad_d, pad_h, pad_w;       // leading zero padding per spatial dim
  int cin_chunk;                 // input channels staged per pass
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3d_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, ConvShape s) {
  extern __shared__ __align__(16) float w_s[];  // [k^3][cin_chunk][kCoutTile]
  const int64_t voxels = (int64_t)s.n * s.dout * s.hout * s.wout;
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = v < voxels;
  const int co0 = blockIdx.y * kCoutTile;

  int ow = 0, oh = 0, od = 0, nn = 0;
  if (active) {
    int64_t t = v;
    ow = (int)(t % s.wout); t /= s.wout;
    oh = (int)(t % s.hout); t /= s.hout;
    od = (int)(t % s.dout);
    nn = (int)(t / s.dout);
  }
  const int id0 = od * s.stride - s.pad_d;
  const int ih0 = oh * s.stride - s.pad_h;
  const int iw0 = ow * s.stride - s.pad_w;
  const int k3 = s.k * s.k * s.k;

  float acc[kCoutTile];
#pragma unroll
  for (int j = 0; j < kCoutTile; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < s.cin; c0 += s.cin_chunk) {
    const int cc = min(s.cin_chunk, s.cin - c0);
    const int n_w = k3 * cc * kCoutTile;
    __syncthreads();  // the previous chunk's readers are done with w_s
    for (int e = threadIdx.x; e < n_w; e += kThreads) {
      const int j = e % kCoutTile;
      const int rest = e / kCoutTile;
      const int ci = rest % cc;
      const int off = rest / cc;
      const int co = co0 + j;
      w_s[(off * s.cin_chunk + ci) * kCoutTile + j] =
          co < s.cout ? to_f32(w[((int64_t)off * s.cin + c0 + ci) * s.cout + co]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int kd = 0; kd < s.k; ++kd) {
      const int id = id0 + kd;
      if (id < 0 || id >= s.din) continue;
      for (int kh = 0; kh < s.k; ++kh) {
        const int ih = ih0 + kh;
        if (ih < 0 || ih >= s.hin) continue;
        for (int kw = 0; kw < s.k; ++kw) {
          const int iw = iw0 + kw;
          if (iw < 0 || iw >= s.win) continue;
          const T* xp = x + ((((int64_t)nn * s.din + id) * s.hin + ih) * s.win + iw) * s.cin + c0;
          const float* wp = w_s + ((kd * s.k + kh) * s.k + kw) * s.cin_chunk * kCoutTile;
          for (int ci = 0; ci < cc; ++ci) {
            const float xv = to_f32(xp[ci]);
            const float4* w4 = reinterpret_cast<const float4*>(wp + ci * kCoutTile);
#pragma unroll
            for (int q = 0; q < kCoutTile / 4; ++q) {
              const float4 ww = w4[q];
              acc[4 * q + 0] = fmaf(xv, ww.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(xv, ww.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(xv, ww.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(xv, ww.w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
  T* yp = y + v * s.cout + co0;
#pragma unroll
  for (int j = 0; j < kCoutTile; ++j)
    if (co0 + j < s.cout) yp[j] = from_f32<T>(acc[j]);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int n, int din, int hin,
           int win, int cin, int dout, int hout, int wout, int cout, int k,
           int stride, int pad_d, int pad_h, int pad_w, void* stream) {
  const int k3 = k * k * k;
  ConvShape s{n, din, hin, win, cin, dout, hout, wout, cout, k, stride,
              pad_d, pad_h, pad_w, 1};
  s.cin_chunk = max(1, min(cin, kSmemFloats / (k3 * kCoutTile)));
  const size_t smem = (size_t)k3 * s.cin_chunk * kCoutTile * sizeof(float);
  const int64_t voxels = (int64_t)n * dout * hout * wout;
  if (voxels == 0 || cout == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((voxels + kThreads - 1) / kThreads),
                  (unsigned)((cout + kCoutTile - 1) / kCoutTile));
  conv3d_direct_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

#define CONV3D_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* x, const void* w, void* y, int n, int din,    \
                      int hin, int win, int cin, int dout, int hout, int wout,  \
                      int cout, int k, int stride, int pad_d, int pad_h,        \
                      int pad_w, void* stream) {                                \
    return launch<T>(x, w, y, n, din, hin, win, cin, dout, hout, wout, cout, k, \
                     stride, pad_d, pad_h, pad_w, stream);                      \
  }

CONV3D_ENTRY(conv3d_direct_f32, float)
CONV3D_ENTRY(conv3d_direct_bf16, __nv_bfloat16)
CONV3D_ENTRY(conv3d_direct_f16, __half)
