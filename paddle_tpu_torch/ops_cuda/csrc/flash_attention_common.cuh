// Shared pieces of the flash-attention kernels K2 (forward) and K3
// (backward): tensor-core products through mma.sync m16n8k16 (bf16
// operands, fp32 accumulation), ldmatrix fragment loads from shared
// memory, 16-byte cp.async tile copies, and the one causal rule.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..2t+1)
//                           a2: (g, 2t+8..)     a3: (g+8, 2t+8..)
//   B (16 x 8, k x n)       b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0 c1: (g, 2t..2t+1)   c2 c3: (g+8, 2t..2t+1)
// The element at the lower column sits in the low half of a 32-bit
// register. Tiles live in shared memory as rows of D bf16 values padded
// by 8 (16 bytes), so the 8 row addresses of one ldmatrix fall in 8
// different 16-byte bank groups and never conflict.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr int kThreads = 128;      // four warps per CTA
constexpr int kPad = 8;            // bf16 elements of padding per smem row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid` false writes 16 zero bytes and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy (zero when not valid).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b (16 x 8 x 16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major smem
// tile with row stride `ld` elements.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld,
                                       int row0, int col0, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles where B[k][n] = tile[n][k] (B is the
// transpose of rows n0..n0+15, columns k0..k0+15 of the tile): r[0..1]
// for n0..n0+7, r[2..3] for n0+8..n0+15.
__device__ __forceinline__ void load_b_rows(uint32_t* r, const bf16* tile,
                                            int ld, int n0, int k0,
                                            int lane) {
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = tile[k][n] (rows k0..k0+15,
// columns n0..n0+15 of the tile): r[0..1] for n0..n0+7, r[2..3] for
// n0+8..n0+15.
__device__ __forceinline__ void load_b_cols(uint32_t* r, const bf16* tile,
                                            int ld, int k0, int n0,
                                            int lane) {
  ldsm_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                       n0 + (lane >> 4) * 8);
}

// Copy rows [r0, r0 + ROWS) of one head (row i at base + i * row_stride,
// D contiguous bf16 values) into a padded smem tile; rows at or past
// `rows_valid` are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          long long row_stride, int r0,
                                          int rows_valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool ok = r0 + r < rows_valid;
    const bf16* src = base + (long long)(ok ? r0 + r : 0) * row_stride + col;
    cp_async16(tile + r * (D + kPad) + col, src, ok);
  }
}

// Copy `n` fp32 values [r0, r0 + n) of a row (zero past `valid`).
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n, int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = r0 + i < valid;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

// Bottom-right-aligned causal rule of `_causal_keep`: query row q sees
// key j iff q + (sk - sq) >= j.
__device__ __forceinline__ bool causal_keep(int q, int j, int off) {
  return q + off >= j;
}

}  // namespace flash
