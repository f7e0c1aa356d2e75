// A probe of the tensor cores' TF32 arithmetic on Hopper (sm_90a), run by
// chip_smoke.py beside the fp32 flash kernels (the `tf32x3` route of K2
// and K3): one warpgroup computes D (64 x 64) = A (64 x 32) B^T, B 64 x
// 32, with wgmma m64n64k8 on fp32 operands in the tiles' 128-byte
// swizzle, in one of three modes:
//   0: one TF32 product of the raw fp32 values (the tensor cores read the
//      top 19 bits of each operand by their own rule: truncated or
//      rounded, which the caller finds from chosen operands);
//   1: 3xTF32 from shared memory (hi = x with its 13 low mantissa bits
//      cleared, lo = x - hi rounded to TF32; lo.hi + hi.lo + hi.hi), as
//      `gemm_ss`;
//   2: 3xTF32 with A from registers, as `gemm_rs` takes P and dS: A's
//      values stand in an accumulator's layout and `to_a_frags` repacks
//      them, B's columns are stored in tf32_key's order within each group
//      of 8, as split_kernel stores the transposed copies.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kN = 64, kK = 32;  // one 128-byte panel per row

// element (r, c) of a 32-column fp32 tile in the 128-byte swizzle
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kK + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

__global__ void __launch_bounds__(128)
tf32_probe_kernel(const float* a, const float* b, float* d, int mode) {
  __shared__ __align__(1024) float sa[2][64 * kK];  // hi (or raw), lo
  __shared__ __align__(1024) float sb[2][kN * kK];
  for (int i = threadIdx.x; i < 64 * kK; i += 128) {
    const int r = i / kK, c = i % kK;
    const float x = a[i], hi = mode == 0 ? x : tf32_hi(x);
    sa[0][swizzled(r, c)] = hi;
    sa[1][swizzled(r, c)] = mode == 0 ? 0.f : tf32_lo(x, hi);
  }
  for (int i = threadIdx.x; i < kN * kK; i += 128) {
    const int r = i / kK, c = i % kK;
    // mode 2: column slot c holds key (c & ~7) + tf32_key(c & 7)
    const int src = mode == 2 ? (c & ~7) + tf32_key(c & 7) : c;
    const float x = b[r * kK + src], hi = mode == 0 ? x : tf32_hi(x);
    sb[0][swizzled(r, c)] = hi;
    sb[1][swizzled(r, c)] = mode == 0 ? 0.f : tf32_lo(x, hi);
  }
  // the threads' stores become visible to the tensor cores' reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  using LA = Tile<float, 64, kK>;
  using LB = Tile<float, kN, kK>;
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  Frags<float, kK> fa;
  if (mode == 2) {
    float x[kK / 2];  // A's values in an accumulator's layout
#pragma unroll
    for (int i = 0; i < kK / 2; ++i) {
      const int c = i >> 2, j = (i >> 1) & 1, e = i & 1;
      x[i] = a[(16 * w + g + 8 * j) * kK + 8 * c + 2 * t + e];
    }
    to_a_frags(fa, x);
  }
  wgmma_fence();
  if (mode == 0) {
    const uint64_t da = kdesc<LA>(sa[0], 0), db = kdesc<LB>(sb[0], 0);
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk)
      WgmmaTf32<kN>::ss(acc, da + kstep<LA>(kk), db + kstep<LB>(kk), kk > 0);
  } else if (mode == 1) {
    gemm_ss<float, kN, kK, 64>(acc, sa[0], 0, sb[0]);
  } else {
    gemm_rs<float, kN, kK>(acc, fa, sb[0]);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs<kN / 2>(acc);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int c = i >> 2, j = (i >> 1) & 1, e = i & 1;
    d[(16 * w + g + 8 * j) * kN + 8 * c + 2 * t + e] = acc[i];
  }
}

}  // namespace

// C entry for ctypes: a (64 x 32), b (64 x 32), d (64 x 64), fp32
// row-major on the device; mode 0, 1 or 2 (see the top). Launches one
// block on `stream`; returns cudaGetLastError().
extern "C" int tf32_probe_launch(const void* a, const void* b, void* d,
                                 int mode, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d), mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
