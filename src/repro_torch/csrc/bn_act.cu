// Fused batch-norm normalize + leaky-ReLU, forward, for sm_90a.
//
// Replaces: src/repro/kernels/bn_act/kernel.py::bn_leaky_relu (body
// _bn_act_kernel), reached through src/repro/kernels/bn_act/ops.py::
// bn_leaky_relu from core/dist_norm.py::distributed_batchnorm. Same function:
// y = (x - mean) * (rsqrt(var + eps) * scale) + bias, then leaky-ReLU with
// `slope` (1.0 is the identity), fp32 math, output in x's dtype. The
// statistics are not computed here: they are a (cross-device) reduction and
// stay in core/dist_norm.py.
//
// What bounds it on this card: bytes. Each element is read once and written
// once for ~5 FLOPs, two orders of magnitude under the H100's ridge point, so
// the least time is (bytes in + bytes out) / 3.35 TB/s.
//
// What this first design does about it: one pass, nothing extra in device
// memory. The (C,) vectors are folded once per block into shared memory as
// mean, a = rsqrt(var + eps) * scale and bias; a grid-stride loop then moves
// 16 bytes per thread per step (4 fp32 or 8 bf16/fp16 elements) whenever C
// and both pointers allow it, else one element at a time. Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // enough to fill every SM several times

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int64_t rows,
              int c, float eps, float slope) {
  extern __shared__ float p_s[];  // [3][c]: mean, a, bias
  float* m_s = p_s;
  float* a_s = p_s + c;
  float* b_s = p_s + 2 * c;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    m_s[i] = mean[i];
    a_s[i] = rsqrtf(var[i] + eps) * scale[i];
    b_s[i] = bias[i];
  }
  __syncthreads();
  const int64_t n_vec = rows * c / VEC;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_vec; i += step) {
    const Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[i];
    const int ch = (int)((i * VEC) % c);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float o = (to_f32(in.v[j]) - m_s[ch + j]) * a_s[ch + j] + b_s[ch + j];
      o = o >= 0.f ? o : o * slope;
      out.v[j] = from_f32<T>(o);
    }
    reinterpret_cast<Pack<T, VEC>*>(y)[i] = out;
  }
}

template <typename T>
int launch(const void* x, const float* mean, const float* var,
           const float* scale, const float* bias, void* y, int64_t rows, int c,
           float eps, float slope, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int64_t n_vec = rows * c / (vec ? kVec : 1);
  if (n_vec == 0) return (int)cudaGetLastError();
  const int blocks = (int)std::min<int64_t>((n_vec + kThreads - 1) / kThreads, kMaxBlocks);
  const size_t smem = 3 * (size_t)c * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    bn_act_kernel<T, kVec><<<blocks, kThreads, smem, st>>>(
        static_cast<const T*>(x), mean, var, scale, bias, static_cast<T*>(y), rows, c, eps, slope);
  else
    bn_act_kernel<T, 1><<<blocks, kThreads, smem, st>>>(
        static_cast<const T*>(x), mean, var, scale, bias, static_cast<T*>(y), rows, c, eps, slope);
  return (int)cudaGetLastError();
}

}  // namespace

#define BN_ACT_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* x, const void* mean, const void* var,          \
                      const void* scale, const void* bias, void* y, int64_t rows, \
                      int c, float eps, float slope, void* stream) {             \
    return launch<T>(x, static_cast<const float*>(mean),                         \
                     static_cast<const float*>(var),                             \
                     static_cast<const float*>(scale),                           \
                     static_cast<const float*>(bias), y, rows, c, eps, slope,    \
                     stream);                                                    \
  }

BN_ACT_ENTRY(bn_act_f32, float)
BN_ACT_ENTRY(bn_act_bf16, __nv_bfloat16)
BN_ACT_ENTRY(bn_act_f16, __half)
