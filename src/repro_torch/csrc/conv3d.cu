// Implicit-GEMM 3-D convolution on Hopper's tensor cores, NDHWC activations
// by DHWIO weights, for sm_90a.
//
// Replaces: src/repro/kernels/conv3d/kernel.py::conv3d_offset_matmul (body
// _conv3d_kernel), reached through src/repro/kernels/conv3d/ops.py::
// conv3d_valid from core/spatial_conv.py::_conv_piece. It computes the same
// function: the sum over the k^3 filter offsets of (voxels x Cin) @
// (Cin x Cout), accumulated in fp32, written in the input's dtype. The
// padding stays a bounds check: no padded copy of x is made.
//
// The GEMM: M = N*Do*Ho*Wo output voxels, N = Cout, K = k^3*Cin in
// (kd, kh, kw, ci) order, which is the row order of the DHWIO weight. Row m
// of A is voxel m's receptive field, gathered from x in place; B is the
// weight viewed as a (K x Cout) matrix.
//
// What bounds it on this card (CosmoFlow, fp32 run as 3xTF32, below):
// operations at layers 1-6, hundreds of FLOPs per byte; bytes at layer 0
// in bf16 (K = 108 products per voxel against a 16-channel output written
// once); fp32 layer 0 sits near the ridge. What holds it back in practice
// is moving operands: a receptive field re-reads each x element k^3 times.
//
// What the design does about it:
// - Tensor cores through wgmma (sm_90a), fp32 accumulators in registers;
//   a block is two warpgroups of 64-row tiles by an N tile of BN = 16..128
//   channels (the smallest that holds Cout, 128 above).
// - bf16/fp16: wgmma ...k16, A and B read from shared memory.
// - fp32 as 3xTF32: a = hi + lo with hi = cvt.rna.tf32(a) and lo = a - hi
//   truncated to TF32; the A fragment is split in registers and the
//   register-A form of wgmma ...tf32 runs three times per K step, hi*B_hi
//   + hi*B_lo + lo*B_hi. 1xTF32 keeps ~1e-3 of the output scale, 3xTF32
//   the accuracy of an fp32 sum, if the tensor cores' chopped adds are
//   kept small. They add a product group to the accumulator with its low
//   bits chopped, an error of the accumulator's size each time that leans
//   one way (in place, ~7e-6 of the scale at K = 864). So each stage's 12
//   wgmma sum onto a zeroed tile of their own, the small products
//   (hi*B_lo, lo*B_hi) first, then hi*B_hi, and the tile is added to the
//   accumulators by an fp32 add, which rounds to nearest. TF32 wants B
//   K-major, so a first launch writes the weight transposed to (Cout, K),
//   split into B_hi and B_lo (one copy for 16-bit types).
// - The weight streams by TMA from a 2-D tensor map with the 128-byte
//   swizzle, 128 bytes of K a stage (32 fp32 or 64 bf16 values), through a
//   ring of stages completing on mbarriers.
// - Two ways to A, chosen per call by the wrapper (ops.plan):
//   * conv3d_patch (stride 1, taps of whole 16-byte chunks, enough output
//     boxes for the card: layers 0-2): a block's output box and the input
//     patch its windows cover, loaded once into shared memory (zeros
//     outside x: the SAME padding). Every tap's A is a view of the patch
//     (no swizzle, descriptors only), so x is read ~6x less than by a
//     gather; one wgmma group stays in flight across stages; the
//     epilogue stores from the registers.
//   * conv3d_igemm (everything else: stride 2, small Cin, the deep
//     layers): each stage's A rows gathered with cp.async into the
//     swizzled layout, pieces of 16, 8 or 4 bytes that never straddle two
//     taps (2-byte 16-bit pieces through registers), out-of-bounds taps by
//     the zero-fill form. Where the M x N tiles would leave SMs idle, K is
//     split across blocks: fp32 partial sums to a workspace, then a last
//     launch adds them in split order and casts (no float atomics: the
//     same bits every run).
// - The gather kernel stages its tile in shared memory and writes output
//   rows with 16-byte stores; ragged M, boxes and Cout are masked; offsets
//   are 64-bit (layer 0 at 512^3 has 2^31 output elements).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;        // output rows per block: 2 warpgroups x 64
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;  // K bytes per tile row and stage
constexpr int kStages = 3;
// error codes beside cudaError_t's (all below 1000)
constexpr int kNoEncoder = 5001;     // no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 6000;  // + the CUresult

// n / d for 0 <= n < 2^31 as one multiply-high and a shift (the divisor's
// magic number comes from the host)
struct FastDiv {
  uint32_t mul;
  int shr, d;
};

FastDiv fast_div(int d) {
  FastDiv f{0, 0, d};
  if (d > 1) {
    int c = 0;  // ceil(log2(d))
    while ((1LL << c) < d) ++c;
    f.mul = static_cast<uint32_t>(((1ULL << (31 + c)) + d - 1) / d);
    f.shr = c - 1;
  }
  return f;
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.mul) >> f.shr);
}

struct Shape {
  int d, h, w, cin;              // input (unpadded); the batch is in m
  int dout, hout, wout, cout;    // output
  int k, stride, pad_d, pad_h, pad_w;
  int K;                         // k^3 * Cin
  int k_tiles;                   // stages of K
  int tiles_per_split;           // stages of K per split
  int vec;                       // bytes per gathered piece: 16, 8, 4 or 2
  int m;                         // output voxels (< 2^31)
  FastDiv by_cin, by_k, by_wout, by_hout, by_dout;
  // the patch kernel's (stages = 0: the gather kernel's launch)
  int stages;                    // weight stages in the ring
  int pw;                        // patch columns
  int chunks, plane;             // 16-byte chunks a voxel, bytes a chunk plane
  int tiles_w, tiles_h;          // output boxes along w, along h
  FastDiv by_chunks, by_tiles_w, by_tiles_h;
};

template <typename T, int BN>
struct Cfg {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kBK = kRowBytes / static_cast<int>(sizeof(T));
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + (kTf32 ? 2 : 1) * kBBytes;
  static constexpr int kPitch = BN + 8;  // floats per staged output row
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kBM * (16 + 8) + kStages * 8;
  // two blocks an SM where shared memory allows (227 KB a block at most)
  static constexpr int kMinBlocks = 2 * kSmem <= 232448 ? 2 : 1;
  static_assert(kBM * kPitch * 4 <= kStages * kStageBytes,
                "the staged output tile must fit in the stages");
};

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

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------- barriers and copies --
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int n);
template <>
__device__ __forceinline__ void cp_async<16>(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(n) : "memory");
}
template <>
__device__ __forceinline__ void cp_async<8>(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(n) : "memory");
}
template <>
__device__ __forceinline__ void cp_async<4>(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- wgmma --
// A shared-memory matrix descriptor for a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B). A K step inside the span
// advances the start address by its bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO: 8-row groups
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving register reads or writes across a wgmma
// that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x N, fp32) += A(64 x 8, tf32, registers) * B(8 x N, tf32, shared)
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float* d, const uint32_t* a,
                                            uint64_t b);
// D(64 x N, fp32) += A(64 x 16, shared) * B(16 x N, shared), 16-bit types
template <int N, typename T>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b);

// The instructions for each N, written out: the accumulator is N / 2
// registers a thread.

template <> __device__ __forceinline__ void mma_tf32_rs<16>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<16, __nv_bfloat16>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<16, __half>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_tf32_rs<32>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<32, __nv_bfloat16>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<32, __half>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_tf32_rs<64>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<64, __nv_bfloat16>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<64, __half>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_tf32_rs<128>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<128, __nv_bfloat16>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void mma_ss<128, __half>(
    float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// --------------------------------------------------------- the gather --
// Per output row of the tile: where its receptive field starts in x. A row
// past the end of M gets a depth that no tap brings inside x, so it reads
// zeros.
struct RowStart {
  int d0, h0, w0, pad_;
};

// Gathers the A tile of K stage kt: 128 bytes of each row, in pieces of V
// bytes (V divides Cin * sizeof(T), so a piece lies inside one tap's
// channel run). Thread t copies piece t % (128 / V) of every
// (256 / (128 / V))-th row: neighbouring threads read neighbouring
// addresses of x. The 16-byte chunk c of row r lands at chunk c ^ (r % 8):
// the 128-byte swizzle.
template <typename T, int V>
__device__ __forceinline__ void gather(uint32_t a_tile, const T* __restrict__ x,
                                       const Shape& s, const RowStart* rows,
                                       const long long* row_base, int kt,
                                       int tid) {
  constexpr int kPieces = kRowBytes / V;
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kElems = V / static_cast<int>(sizeof(T));
  const int j = tid % kPieces;
  const int kk = kt * (kRowBytes / static_cast<int>(sizeof(T))) + j * kElems;
  const bool live = kk < s.K;
  int kd = 0, kh = 0, kw = 0;
  long long off = 0;
  if (live) {
    const int tap = kk / s.by_cin;
    const int ci = kk - tap * s.cin;
    const int q = tap / s.by_k;
    kw = tap - q * s.k;
    kd = q / s.by_k;
    kh = q - kd * s.k;
    off = (static_cast<long long>(kd * s.h + kh) * s.w + kw) * s.cin + ci;
  }
  const int chunk = (j * V) >> 4;
  const int within = (j * V) & 15;
  for (int r = tid / kPieces; r < kBM; r += kRowsPerPass) {
    const RowStart p = rows[r];
    const bool in = live &&
                    static_cast<unsigned>(p.d0 + kd) < static_cast<unsigned>(s.d) &&
                    static_cast<unsigned>(p.h0 + kh) < static_cast<unsigned>(s.h) &&
                    static_cast<unsigned>(p.w0 + kw) < static_cast<unsigned>(s.w);
    const T* src = in ? x + row_base[r] + off : x;
    const uint32_t dst = a_tile + r * kRowBytes + ((chunk ^ (r & 7)) << 4) + within;
    if constexpr (V >= 4) {
      cp_async<V>(dst, src, in ? V : 0);
    } else {  // 2-byte pieces: no cp.async that small, so through registers
      const unsigned short v = in ? *reinterpret_cast<const unsigned short*>(src) : 0;
      asm volatile("st.shared.u16 [%0], %1;" ::"r"(dst), "h"(v) : "memory");
    }
  }
}

// ---------------------------------------------------------- the store --
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* src);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* src) {
  uint4 v;
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T lo = from_f32<T>(src[2 * i]), hi = from_f32<T>(src[2 * i + 1]);
    u[i] = static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&lo)) |
           (static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&hi)) << 16);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// Two neighbouring output elements as one store (8 or 4 bytes, aligned).
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  const T lo = from_f32<T>(a), hi = from_f32<T>(b);
  *reinterpret_cast<uint32_t*>(dst) =
      static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&lo)) |
      (static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&hi)) << 16);
}

// Writes the staged tile (kBM x BN floats, pitch BN + 8) to rows m0.. and
// channels n0.. of out (row pitch Cout): 16 bytes a store where Cout
// allows, element by element otherwise.
template <typename OutT, int BN>
__device__ __forceinline__ void store_tile(const float* c, OutT* __restrict__ out,
                                           long long m0, int n0, long long m,
                                           int cout, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));
  constexpr int kPitch = BN + 8;
  const int rows = static_cast<int>(m - m0 < kBM ? m - m0 : kBM);
  const int cols = cout - n0 < BN ? cout - n0 : BN;
  if (cout % kVec == 0) {
    const int per_row = cols / kVec;
    for (int e = tid; e < rows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int v = (e - r * per_row) * kVec;
      store16<OutT>(out + (m0 + r) * cout + n0 + v, c + r * kPitch + v);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int v = e - r * cols;
      out[(m0 + r) * cout + n0 + v] = from_f32<OutT>(c[r * kPitch + v]);
    }
  }
}

// -------------------------------------------------- the gather kernel --
// grid (M tiles, Cout tiles, K splits). With one split the block writes y;
// with more it writes its fp32 partial sums to partial[split].
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, Cfg<T, BN>::kMinBlocks)
conv3d_igemm(const __grid_constant__ CUtensorMap w_hi,
             const __grid_constant__ CUtensorMap w_lo,
             const T* __restrict__ x, T* __restrict__ y,
             float* __restrict__ partial, Shape s) {
  using C = Cfg<T, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  RowStart* rows = reinterpret_cast<RowStart*>(smem + kStages * C::kStageBytes);
  long long* row_base = reinterpret_cast<long long*>(rows + kBM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_base + kBM);

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * s.tiles_per_split;
  const int kt_end =
      kt0 + s.tiles_per_split < s.k_tiles ? kt0 + s.tiles_per_split : s.k_tiles;
  const int nk = kt_end - kt0;

  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    RowStart p{-(1 << 30), 0, 0, 0};
    long long base = 0;
    if (m < s.m) {
      const int t0 = static_cast<int>(m), t1 = t0 / s.by_wout;
      const int t2 = t1 / s.by_hout, nn = t2 / s.by_dout;
      const int ow = t0 - t1 * s.wout, oh = t1 - t2 * s.hout;
      const int od = t2 - nn * s.dout;
      p = RowStart{od * s.stride - s.pad_d, oh * s.stride - s.pad_h,
                   ow * s.stride - s.pad_w, 0};
      base = (((static_cast<long long>(nn) * s.d + p.d0) * s.h + p.h0) * s.w + p.w0) *
             s.cin;
    }
    rows[r] = p;
    row_base[r] = base;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage i of this split: its weight tiles by TMA, its A tile by cp.async
  auto load = [&](int i) {
    uint8_t* st = smem + (i % kStages) * C::kStageBytes;
    const int kt = kt0 + i;
    if (tid == 0) {
      const uint32_t bar = smem_u32(&bars[i % kStages]);
      mbar_expect_tx(bar, (C::kTf32 ? 2 : 1) * C::kBBytes);
      tma_load_2d(smem_u32(st + C::kABytes), &w_hi, kt * C::kBK, n0, bar);
      if (C::kTf32)
        tma_load_2d(smem_u32(st + C::kABytes + C::kBBytes), &w_lo, kt * C::kBK, n0, bar);
    }
    const uint32_t a = smem_u32(st);
    if (s.vec == 16) {
      gather<T, 16>(a, x, s, rows, row_base, kt, tid);
    } else if (s.vec == 8) {
      gather<T, 8>(a, x, s, rows, row_base, kt, tid);
    } else if (C::kTf32 || s.vec == 4) {
      gather<T, 4>(a, x, s, rows, row_base, kt, tid);
    } else if constexpr (!C::kTf32) {
      gather<T, 2>(a, x, s, rows, row_base, kt, tid);
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }

  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int slot = i % kStages;
    mbar_wait(smem_u32(&bars[slot]), (i / kStages) & 1);
    const uint8_t* st = smem + slot * C::kStageBytes;
    const uint32_t a_addr = smem_u32(st) + wg * 64 * kRowBytes;
    const uint32_t b_addr = smem_u32(st + C::kABytes);
    if constexpr (C::kTf32) {
      // this thread's A fragments of the stage's 4 K steps of 8: rows
      // g and g + 8 of its warp's 16, columns t and t + 4 of each step
      const int g = lane >> 2, t = lane & 3;
      const uint8_t* arow = st + (wg * 64 + warp * 16 + g) * kRowBytes + 4 * t;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int chunk = 2 * ks + (v >> 1);
          const float a = *reinterpret_cast<const float*>(
              arow + (v & 1) * 8 * kRowBytes + ((chunk ^ g) << 4));
          hi[ks][v] = tf32_rna(a);
          lo[ks][v] = __float_as_uint(a - __uint_as_float(hi[ks][v])) & 0xFFFFE000u;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) part[j] = 0.f;
      fence_regs<BN / 2>(part);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t bh = sw128_desc(b_addr + 32 * ks);
        const uint64_t bl = sw128_desc(b_addr + C::kBBytes + 32 * ks);
        mma_tf32_rs<BN>(part, hi[ks], bl);
        mma_tf32_rs<BN>(part, lo[ks], bh);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_tf32_rs<BN>(part, hi[ks], sw128_desc(b_addr + 32 * ks));
      wgmma_commit();
      if (i + kStages - 1 < nk) load(i + kStages - 1);
      cp_async_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(part);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
    } else {
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_ss<BN, T>(acc, sw128_desc(a_addr + 32 * ks), sw128_desc(b_addr + 32 * ks));
      wgmma_commit();
      if (i + kStages - 1 < nk) load(i + kStages - 1);
      cp_async_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(acc);
    }
  }

  // the epilogue: accumulators -> shared memory (the stages are free now)
  // -> rows of the output
  cp_async_wait<0>();
  __syncthreads();
  float* c = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(c + r0 * C::kPitch + 8 * j + 2 * t) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(c + (r0 + 8) * C::kPitch + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  if (partial != nullptr)
    store_tile<float, BN>(c, partial + static_cast<long long>(blockIdx.z) * s.m * s.cout,
                          m0, n0, s.m, s.cout, tid);
  else
    store_tile<T, BN>(c, y, m0, n0, s.m, s.cout, tid);
}

// -------------------------------------------------- the patch kernel --
// Stride 1, channel runs of whole 16-byte chunks, enough output boxes to
// fill the card (layers 0-2). A block computes a box of kH x 16 output
// voxels in one depth plane (Box below), each warpgroup 8-row tiles of its
// 8-column half. Its input patch, the k planes, kH + k - 1 rows and
// 16 + k - 1 columns its windows cover with all their channels, is loaded
// once into shared memory (zeros outside x): 16-byte chunk c of patch
// voxel v at c * plane + 16 * v. A tap's A operand is then a view of the
// patch, with no copy: a 64-row tile is 8 rows of 8 voxels along w, each
// one 128-byte core matrix per chunk, the rows one patch row apart. Only
// the weight streams, by TMA through a ring of s.stages stages. x is read
// ~6x less than by the gather (972 patch voxels for 256 windows of 27 at
// k = 3 in bf16), and one wgmma group stays in flight across stages.
constexpr int kBoxW = 16;

// Output rows (h) of the patch kernel's box: two m64 tiles a warpgroup for
// 16-bit types (one weight stage feeds twice the rows), one for TF32, whose
// A fragments take registers of their own.
template <typename T>
struct Box {
  static constexpr int kTiles = std::is_same<T, float>::value ? 1 : 2;
  static constexpr int kH = 8 * kTiles;
};

// A shared-memory matrix descriptor without swizzle (K-major): 8-row core
// matrices of 16-byte rows, the next core matrix along K lbo bytes on, the
// next along M sbo bytes on.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Where the patch kernel keeps things in shared memory, from the 1024-byte
// aligned base: the weight ring, the patch, 128 zero bytes (the A operand
// of K steps past K), the K table (the patch offset of every K column at
// the box's first voxel, -1 past K), the barriers.
struct PatchLayout {
  int patch_at, zero_at, table_at, bars_at, bytes;
};

template <typename T, int BN>
__host__ __device__ PatchLayout patch_layout(const Shape& s) {
  const int stage = (std::is_same<T, float>::value ? 2 : 1) * BN * kRowBytes;
  const int ring = s.stages * stage;
  const int body = ring + s.chunks * s.plane;
  PatchLayout l;
  l.patch_at = ring;
  l.zero_at = (body + 127) / 128 * 128;
  l.table_at = l.zero_at + 128;
  l.bars_at = l.table_at + s.k_tiles * (kRowBytes / static_cast<int>(sizeof(T))) * 4;
  l.bars_at = (l.bars_at + 7) / 8 * 8;
  l.bytes = 1024 + l.bars_at + s.stages * 8;
  return l;
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
conv3d_patch(const __grid_constant__ CUtensorMap w_hi,
             const __grid_constant__ CUtensorMap w_lo,
             const T* __restrict__ x, T* __restrict__ y, Shape s) {
  constexpr bool kTf32 = std::is_same<T, float>::value;
  constexpr int kMT = Box<T>::kTiles;
  constexpr int kBoxH = Box<T>::kH;
  constexpr int kBK = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // per chunk
  constexpr int kBBytes = BN * kRowBytes;
  constexpr int kStageBytes = (kTf32 ? 2 : 1) * kBBytes;
  const PatchLayout lay = patch_layout<T, BN>(s);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t patch = smem_u32(smem + lay.patch_at);
  const uint32_t zero = smem_u32(smem + lay.zero_at);
  int* table = reinterpret_cast<int*>(smem + lay.table_at);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars_at);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int b1 = b / s.by_tiles_w, b2 = b1 / s.by_tiles_h, nn = b2 / s.by_dout;
  const int ow0 = (b - b1 * s.tiles_w) * kBoxW;
  const int oh0 = (b1 - b2 * s.tiles_h) * kBoxH;
  const int od = b2 - nn * s.dout;
  const int n0 = blockIdx.y * BN;
  const int nk = s.k_tiles;

  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_b = [&](int i) {  // stage i of the weight, by thread 0
    const uint32_t st = smem_u32(smem + (i % s.stages) * kStageBytes);
    const uint32_t bar = smem_u32(&bars[i % s.stages]);
    mbar_expect_tx(bar, kStageBytes);
    tma_load_2d(st, &w_hi, i * kBK, n0, bar);
    if (kTf32) tma_load_2d(st + kBBytes, &w_lo, i * kBK, n0, bar);
  };
  if (tid == 0)
    for (int i = 0; i < s.stages && i < nk; ++i) load_b(i);

  // the patch, a warp to a patch row (pd, ph): the row's voxels and their
  // channels are one run of x, read 16 bytes a lane, chunk index fastest
  const int ph_rows = kBoxH + s.k - 1;
  for (int row = tid / 32; row < s.k * ph_rows; row += kThreads / 32) {
    const int pd = row / ph_rows;
    const int id = od - s.pad_d + pd, ih = oh0 - s.pad_h + row - pd * ph_rows;
    const bool row_in = static_cast<unsigned>(id) < static_cast<unsigned>(s.d) &&
                        static_cast<unsigned>(ih) < static_cast<unsigned>(s.h);
    const T* xrow =
        row_in ? x + (static_cast<long long>(nn * s.d + id) * s.h + ih) * s.w * s.cin : x;
    const uint32_t dst = patch + row * s.pw * 16;
    for (int j = tid % 32; j < s.pw * s.chunks; j += 32) {
      const int pw = j / s.by_chunks;
      const int c = j - pw * s.chunks;
      const int iw = ow0 - s.pad_w + pw;
      const bool in = row_in && static_cast<unsigned>(iw) < static_cast<unsigned>(s.w);
      cp_async<16>(dst + c * s.plane + pw * 16,
                   in ? xrow + static_cast<long long>(iw) * s.cin + c * kElems : x,
                   in ? 16 : 0);
    }
  }
  cp_async_commit();
  if (tid < 32) reinterpret_cast<float*>(smem + lay.zero_at)[tid] = 0.f;
  for (int kk = tid; kk < nk * kBK; kk += kThreads) {
    int off = -1;
    if (kk < s.K) {
      const int tap = kk / s.by_cin;
      const int ci = kk - tap * s.cin;
      const int q = tap / s.by_k;
      const int kw = tap - q * s.k;
      const int kd = q / s.by_k;
      const int kh = q - kd * s.k;
      off = (ci / kElems) * s.plane + ((kd * (kBoxH + s.k - 1) + kh) * s.pw + kw) * 16 +
            (ci % kElems) * static_cast<int>(sizeof(T));
    }
    table[kk] = off;
  }
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  float acc[kMT][BN / 2], part[BN / 2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    fence_regs<BN / 2>(acc[mt]);
  }

  // stage i: its wgmma group is issued and left in flight; the group of
  // stage i - 1 is waited for, and its weight slot refilled. Nothing but
  // wgmma touches the accumulators until the last wait. A TF32 group is
  // waited for at once instead, and its stage's tile added to the
  // accumulators.
  uint32_t hi[4][4], lo[4][4];  // a TF32 stage's A fragments
  auto stage = [&](int i) {
    const int slot = i % s.stages;
    mbar_wait(smem_u32(&bars[slot]), (i / s.stages) & 1);
    const uint32_t b_addr = smem_u32(smem + slot * kStageBytes);
    if constexpr (kTf32) {
      // rows g and g + 8 of the warp's 16: voxels (2 * warp, g) and
      // (2 * warp + 1, g) of the warpgroup's 8 x 8 half
      const int g = lane >> 2, t = lane & 3;
      const uint8_t* base =
          smem + lay.patch_at + ((2 * warp) * s.pw + wg * 8 + g) * 16;
      const int down = s.pw * 16;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = table[i * kBK + ks * 8 + t + 4 * half];
          const float a0 = off < 0 ? 0.f : *reinterpret_cast<const float*>(base + off);
          const float a1 =
              off < 0 ? 0.f : *reinterpret_cast<const float*>(base + off + down);
          hi[ks][2 * half] = tf32_rna(a0);
          hi[ks][2 * half + 1] = tf32_rna(a1);
          lo[ks][2 * half] =
              __float_as_uint(a0 - __uint_as_float(hi[ks][2 * half])) & 0xFFFFE000u;
          lo[ks][2 * half + 1] =
              __float_as_uint(a1 - __uint_as_float(hi[ks][2 * half + 1])) & 0xFFFFE000u;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) part[j] = 0.f;
      fence_regs<BN / 2>(part);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t bh = sw128_desc(b_addr + 32 * ks);
        const uint64_t bl = sw128_desc(b_addr + kBBytes + 32 * ks);
        mma_tf32_rs<BN>(part, hi[ks], bl);
        mma_tf32_rs<BN>(part, lo[ks], bh);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_tf32_rs<BN>(part, hi[ks], sw128_desc(b_addr + 32 * ks));
    } else {
      // k16 steps; K is a multiple of 16 here, so a step is two chunks of
      // one tap, one chunk plane apart. A step past K reads the zero bytes
      // (every row and chunk of them), so no branch splits the group.
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int off = table[i * kBK + ks * 16];
        const uint64_t bd = sw128_desc(b_addr + 32 * ks);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint64_t ad =
              off < 0 ? plain_desc(zero, 0, 0)
                      : plain_desc(patch + off + (mt * 8 * s.pw + wg * 8) * 16, s.plane,
                                   s.pw * 16);
          mma_ss<BN, T>(acc[mt], ad, bd);
        }
      }
    }
    wgmma_commit();
    if constexpr (kTf32) {
      wgmma_wait_all();
      fence_regs<BN / 2>(part);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[0][j] += part[j];
    } else {
      wgmma_wait_one();
    }
    __syncthreads();  // every warpgroup is done with stage i - 1
    if (tid == 0 && i >= 1 && i - 1 + s.stages < nk) load_b(i - 1 + s.stages);
  };
#pragma unroll 1
  for (int i = 0; i < nk; ++i) stage(i);
  wgmma_wait_all();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) fence_regs<BN / 2>(acc[mt]);
  // the epilogue, from the registers: the column pair 8 jj + 2 t of rows
  // (mt * 8 + 2 * warp + dh, r) of the warpgroup's half, one store of two
  // elements where Cout is even
  const int r = lane >> 2, t = lane & 3;
  const bool pairs = s.cout % 2 == 0;
  T* const y0 = y + ((static_cast<long long>(nn) * s.dout + od) * s.hout * s.wout) * s.cout;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      const int oh = oh0 + mt * 8 + 2 * warp + dh, ow = ow0 + wg * 8 + r;
      if (oh >= s.hout || ow >= s.wout) continue;
      T* row = y0 + (static_cast<long long>(oh) * s.wout + ow) * s.cout;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = n0 + 8 * jj + 2 * t;
        const float v0 = acc[mt][4 * jj + 2 * dh], v1 = acc[mt][4 * jj + 2 * dh + 1];
        if (pairs && col + 1 < s.cout) {
          store2<T>(row + col, v0, v1);
        } else {
          if (col < s.cout) row[col] = from_f32<T>(v0);
          if (col + 1 < s.cout) row[col + 1] = from_f32<T>(v1);
        }
      }
    }
  }
}

// Adds the splits' partial sums in split order and casts: the same bits on
// every run.
template <typename T>
__global__ void splitk_sum(const float* __restrict__ partial, T* __restrict__ y,
                           long long count, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) a += partial[sp * count + i];
    y[i] = from_f32<T>(a);
  }
}

// The weight as B wants it: (K, Cout) -> (Cout, Kp), rows padded with
// zeros to Kp (a multiple of 8). fp32 is split into hi = TF32(w) rounded
// to nearest and lo = w - hi truncated to TF32; 16-bit types are copied.
template <typename T>
__global__ void prep_weights(const T* __restrict__ w, T* __restrict__ hi,
                             T* __restrict__ lo, int K, int kp, int cout) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int kk = k0 + i, co = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        kk < K && co < cout ? to_f32(w[static_cast<long long>(kk) * cout + co]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int co = c0 + i, kk = k0 + threadIdx.x;
    if (co >= cout || kk >= kp) continue;
    const float v = tile[threadIdx.x][i];
    const long long o = static_cast<long long>(co) * kp + kk;
    if constexpr (std::is_same<T, float>::value) {
      const float h = __uint_as_float(tf32_rna(v));
      hi[o] = h;
      lo[o] = __uint_as_float(__float_as_uint(v - h) & 0xFFFFE000u);
    } else {
      hi[o] = from_f32<T>(v);
    }
  }
}

// ----------------------------------------------------------- the host --
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime has loaded (no
// link flag)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T> CUtensorMapDataType map_type();
template <> CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// a (Cout, Kp) weight matrix, read in (BN rows x 128 bytes) boxes with the
// 128-byte swizzle; boxes past Cout or Kp read zeros
template <typename T>
int encode(CUtensorMap* map, void* ptr, int kp, int cout, int bn) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / sizeof(T)),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, map_type<T>(), 2, ptr, dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// Lets a kernel take up to `bytes` of dynamic shared memory, and asks for
// the largest shared-memory carveout: left to itself, CUDA may keep L1
// large and fit one block an SM where two would fit.
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int BN>
int launch_tiles(const CUtensorMap& hi, const CUtensorMap& lo, const T* x,
                 T* y, float* partial, const Shape& s, int splits,
                 cudaStream_t stream) {
  using C = Cfg<T, BN>;
  static bool ready[64] = {};  // per device: the shared-memory attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !ready[dev]) {
    e = set_smem(conv3d_igemm<T, BN>, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((s.m + kBM - 1) / kBM),
                  static_cast<unsigned>((s.cout + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  conv3d_igemm<T, BN><<<grid, kThreads, C::kSmem, stream>>>(
      hi, lo, x, y, splits > 1 ? partial : nullptr, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_patch(const CUtensorMap& hi, const CUtensorMap& lo, const T* x, T* y,
                 Shape s, int n, cudaStream_t stream) {
  s.pw = kBoxW + s.k - 1;
  s.chunks = s.cin * static_cast<int>(sizeof(T)) / 16;
  s.plane = (s.k * (Box<T>::kH + s.k - 1) * s.pw * 16 + 127) / 128 * 128 + 16;
  s.tiles_w = (s.wout + kBoxW - 1) / kBoxW;
  s.tiles_h = (s.hout + Box<T>::kH - 1) / Box<T>::kH;
  s.by_chunks = fast_div(s.chunks);
  s.by_tiles_w = fast_div(s.tiles_w); s.by_tiles_h = fast_div(s.tiles_h);
  const PatchLayout l = patch_layout<T, BN>(s);
  if (l.bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64] = {};  // per device: the shared-memory attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !ready[dev]) {
    e = set_smem(conv3d_patch<T, BN>, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(n * s.dout * s.tiles_h * s.tiles_w),
                  static_cast<unsigned>((s.cout + BN - 1) / BN));
  conv3d_patch<T, BN><<<grid, kThreads, l.bytes, stream>>>(hi, lo, x, y, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* w_hi, void* w_lo, void* y,
           void* partial, int n, int din, int hin, int win, int cin,
           int dout, int hout, int wout, int cout, int k, int stride,
           int pad_d, int pad_h, int pad_w, int bn, int tiles_per_split,
           int vec, int patch_stages, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Shape s{};
  s.d = din; s.h = hin; s.w = win; s.cin = cin;
  s.dout = dout; s.hout = hout; s.wout = wout; s.cout = cout;
  s.k = k; s.stride = stride; s.pad_d = pad_d; s.pad_h = pad_h; s.pad_w = pad_w;
  s.K = k * k * k * cin;
  s.tiles_per_split = tiles_per_split;
  s.vec = vec;
  s.m = n * dout * hout * wout;
  s.by_cin = fast_div(cin); s.by_k = fast_div(k);
  s.by_wout = fast_div(wout); s.by_hout = fast_div(hout); s.by_dout = fast_div(dout);
  constexpr int bk = kRowBytes / static_cast<int>(sizeof(T));
  s.k_tiles = (s.K + bk - 1) / bk;
  if (s.m == 0 || cout == 0) return static_cast<int>(cudaGetLastError());
  if (tiles_per_split < 1 || (vec != 16 && vec != 8 && vec != 4 && vec != 2) ||
      vec < static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (patch_stages > 0) {  // what the patch kernel takes
    if (stride != 1 || vec != 16 || tiles_per_split < s.k_tiles ||
        (!std::is_same<T, float>::value && cin % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    s.stages = patch_stages;
  }
  const int splits = (s.k_tiles + tiles_per_split - 1) / tiles_per_split;
  const int kp = (s.K + 7) / 8 * 8;

  prep_weights<T><<<dim3((kp + 31) / 32, (cout + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(w_hi), static_cast<T*>(w_lo),
      s.K, kp, cout);
  CUtensorMap hi, lo;
  int err = encode<T>(&hi, w_hi, kp, cout, bn);
  if (err != 0) return err;
  if (std::is_same<T, float>::value) {
    err = encode<T>(&lo, w_lo, kp, cout, bn);
    if (err != 0) return err;
  } else {
    lo = hi;
  }
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  float* pp = static_cast<float*>(partial);
  if (patch_stages > 0) {
    switch (bn) {
      case 16: err = launch_patch<T, 16>(hi, lo, xp, yp, s, n, stream); break;
      case 32: err = launch_patch<T, 32>(hi, lo, xp, yp, s, n, stream); break;
      case 64: err = launch_patch<T, 64>(hi, lo, xp, yp, s, n, stream); break;
      case 128: err = launch_patch<T, 128>(hi, lo, xp, yp, s, n, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  switch (bn) {
    case 16: err = launch_tiles<T, 16>(hi, lo, xp, yp, pp, s, splits, stream); break;
    case 32: err = launch_tiles<T, 32>(hi, lo, xp, yp, pp, s, splits, stream); break;
    case 64: err = launch_tiles<T, 64>(hi, lo, xp, yp, pp, s, splits, stream); break;
    case 128: err = launch_tiles<T, 128>(hi, lo, xp, yp, pp, s, splits, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  if (splits > 1) {
    const long long count = static_cast<long long>(s.m) * cout;
    long long blocks = (count + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    splitk_sum<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(pp, yp, count,
                                                                   splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_hi: (Cout, Kp) in T; w_lo: the same in fp32 (fp32 only, else unused);
// partial: (splits, M, Cout) fp32 when tiles_per_split < the K stages;
// patch_stages > 0 takes the patch kernel with that many weight stages.
#define CONV3D_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* x, const void* w, void* w_hi, void* w_lo,    \
                      void* y, void* partial, int n, int din, int hin,         \
                      int win, int cin, int dout, int hout, int wout,          \
                      int cout, int k, int stride, int pad_d, int pad_h,       \
                      int pad_w, int bn, int tiles_per_split, int vec,         \
                      int patch_stages, void* stream) {                        \
    return launch<T>(x, w, w_hi, w_lo, y, partial, n, din, hin, win, cin,      \
                     dout, hout, wout, cout, k, stride, pad_d, pad_h, pad_w,   \
                     bn, tiles_per_split, vec, patch_stages, stream);          \
  }

CONV3D_ENTRY(conv3d_igemm_f32, float)
CONV3D_ENTRY(conv3d_igemm_bf16, __nv_bfloat16)
CONV3D_ENTRY(conv3d_igemm_f16, __half)
