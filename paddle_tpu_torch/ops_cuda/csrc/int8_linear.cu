// Kernel K7: fused int8 GEMV for few-row decode, hand-written for Hopper
// (sm_90a).
//
// Replaces `_int8_fused_kernel` of paddle_tpu/quantization/__init__.py
// (one Pallas program per N block: quantize x in the prologue, int8 MXU
// dot with int32 accumulation, fp32 dequant and bias epilogue, cast on
// store). Computes, for m <= 4 rows of x (m, k) and int8 weights
// qweight (k, n):
//
//   qx  = clip(round_half_even(float(x) / sx), -127, 127)      (int8)
//   acc = qx . qweight                                          (int32)
//   y   = float(acc) * (float(ws[n]) * sx) + float(bias[n])    (fp32)
//   out = y cast to x's dtype (fp32, or bf16 rounding to nearest even)
//
// What bounds it on the card: bytes. Each weight byte is used m <= 4
// times, so the k * n int8 weights dominate (GPT-small: 0.6-38.6 MB per
// call against a few KB of activations); the bound is k * n bytes over
// 3.35 TB/s, and at the smaller shapes the launch latency.
//
// Design, kept simple:
// - Grid: one CTA per block of kCols = 16 output columns. The weight
//   keeps JAX's (k, n) row-major layout, so the 16 columns of one k-row
//   are 16 contiguous bytes: one 16-byte load per thread and k-row.
//   16 columns put 48 CTAs on the 132 SMs at the smallest GPT-small
//   shape (768 x 768); the LM head (768 x 50304) gets 3144.
// - The 256 threads of a CTA split k: thread t takes rows t, t + 256,
//   ..., four loads in flight at a time.
// - Prologue: every CTA quantizes the m x k activations into shared
//   memory as int8 codes (<= 12 KiB at k = 3072).
// - MAC: plain int32 multiply-add of sign-extended bytes; each thread
//   keeps m x 16 int32 partial sums.
// - Reduction: warp shuffles, then one shared-memory slot per warp.
//   Integer addition is associative, so the sum is exact and does not
//   depend on the order.
// - Epilogue: one thread per (row, column): scale, bias, cast, store.
//
// Rounding points are pinned one by one, so the kernel, its plain
// version and the TPU kernel give the same bits: the quantize divides
// with an IEEE divide (__fdiv_rn) and rounds half to even (rintf); the
// epilogue spells out each rounding (__fmul_rn / __fadd_rn never fuse
// into an FMA); bf16 output rounds to nearest even. The build uses no
// fast-math flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;      // columns per CTA: one 16-byte weight load
constexpr int kUnroll = 4;     // weight loads in flight per thread
constexpr int kMaxRows = 4;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  return dtype == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// byte b of w, sign-extended
__device__ __forceinline__ int sbyte(unsigned w, int b) {
  return static_cast<int>(w << (24 - 8 * b)) >> 24;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const void* __restrict__ x, int x_dtype,
                   const int8_t* __restrict__ qw,
                   const void* __restrict__ ws, int ws_dtype,
                   const float* __restrict__ sx_ptr,
                   const void* __restrict__ bias, int bias_dtype,
                   void* __restrict__ out, int k, int n) {
  extern __shared__ int8_t qx[];                 // M * k codes
  __shared__ int red[kWarps][M][kCols];
  const float sx = *sx_ptr;
  for (int i = threadIdx.x; i < M * k; i += kThreads) {
    float v = rintf(__fdiv_rn(load_f32(x, x_dtype, i), sx));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    qx[i] = static_cast<int8_t>(static_cast<int>(v));
  }
  __syncthreads();

  const int c0 = blockIdx.x * kCols;
  int acc[M][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0;

  for (int r0 = threadIdx.x; r0 < k; r0 += kThreads * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kThreads;
      w[u] = r < k ? __ldg(reinterpret_cast<const uint4*>(
                         qw + static_cast<long long>(r) * n + c0))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kThreads;
      if (r >= k) break;
      const unsigned words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int a = qx[m * k + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] += a * sbyte(words[c >> 2], c & 3);
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      int v = acc[m][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][m][c] = v;
    }
  __syncthreads();

  if (threadIdx.x < M * kCols) {
    const int m = threadIdx.x / kCols, c = threadIdx.x % kCols;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    const int col = c0 + c;
    float y = __fmul_rn(__int2float_rn(s),
                        __fmul_rn(load_f32(ws, ws_dtype, col), sx));
    if (bias != nullptr)
      y = __fadd_rn(y, load_f32(bias, bias_dtype, col));
    const long long o = static_cast<long long>(m) * n + col;
    if (x_dtype == kBF16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[o] = y;
  }
}

template <int M>
cudaError_t launch_rows(const void* x, int x_dtype, const int8_t* qw,
                        const void* ws, int ws_dtype, const float* sx,
                        const void* bias, int bias_dtype, void* out, int k,
                        int n, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * k;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_linear_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int8_linear_kernel<M><<<n / kCols, kThreads, smem, stream>>>(
      x, x_dtype, qw, ws, ws_dtype, sx, bias, bias_dtype, out, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) fp32/bf16, qw (k, n) int8 row-major, ws (n,) fp32/bf16, sx one
// fp32 on the device, bias (n,) fp32/bf16 or null, out (m, n) in x's
// dtype. m in [1, 4]; n a multiple of 16; qw 16-byte aligned. Returns a
// cudaError_t (0 on success).
int int8_linear_launch(const void* x, const void* qw, const void* ws,
                       const void* sx, const void* bias, void* out, int m,
                       int k, int n, int x_dtype, int ws_dtype,
                       int bias_dtype, void* stream) {
  if (m < 1 || m > kMaxRows || k < 1 || n < kCols || n % kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* q = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_rows<1>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                  bias_dtype, out, k, n, st);
    case 2: return launch_rows<2>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                  bias_dtype, out, k, n, st);
    case 3: return launch_rows<3>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                  bias_dtype, out, k, n, st);
    default: return launch_rows<4>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                   bias_dtype, out, k, n, st);
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
