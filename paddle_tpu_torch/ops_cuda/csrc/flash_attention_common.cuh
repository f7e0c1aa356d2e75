// Shared pieces of the flash-attention kernels K2 (forward) and K3
// (backward) on Hopper (sm_90a): TMA tile loads through 4-D tensor maps
// with the 128-byte swizzle, mbarrier rings, warpgroup matrix products
// (wgmma.mma_async) on shared-memory descriptors, and the one causal
// rule.
//
// Tiles in shared memory. A tile of R rows of D bf16 values is stored as
// D / 64 column panels; panel p holds columns [64p, 64p + 64) of every
// row as R rows of 128 bytes in TMA's 128-byte swizzle (the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8)). Every panel starts on a
// 1024-byte boundary, so the swizzle that TMA writes and the one the
// wgmma descriptors name agree on absolute address bits. One TMA box
// is (64 columns, 1 head, R rows, 1 batch) of the (d, h, s, b) map, so
// d = 128 takes two boxes per tile.
//
// wgmma operands from such a tile (descriptor: start >> 4, leading and
// stride byte offsets >> 4, layout 1 = 128-byte swizzle):
//   K-major (the tile's columns are the product's k): 8-row groups are
//     1024 bytes apart (stride offset); the k step of 16 columns moves
//     the start by 32 bytes inside a panel, and to the next panel every
//     4 steps.
//   MN-major (the tile's rows are the product's k, its columns n): the
//     k step of 16 rows moves the start by 2048 bytes; 8-row groups are
//     1024 bytes apart (stride offset) and the 64-column chunks of n
//     one panel apart (leading offset).
//
// Accumulator layout of wgmma m64nNk16 (f32), thread i of a warpgroup,
// warp w = i / 32, g = (i % 32) / 4, t = i % 4: d[4c + 2j + e] is row
// 16w + g + 8j, column 8c + 2t + e. A from registers (m64 k16 bf16) uses
// the same rows: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..), so an accumulator over k columns repacks into the A
// fragments of a product over those columns without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPanelCols = 64;     // bf16 columns in one 128-byte row
// A CTA is two consumer warpgroups and one producer warpgroup, of which
// one thread issues the copies and the rest exit after giving up their
// registers. One CTA per SM: 384 threads enter with 168 registers each
// (65,536 / 384, rounded down to 8); the producer keeps 24 and the
// consumers take 240, 128 x 24 + 256 x 240 = 64,512 <= 384 x 168.
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------------------
// mbarriers
// ----------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of kStages buffers: round r of stage s is tile r * kStages + s,
// counted over the whole life of the CTA. `full` completes when the
// producer's copies of a tile have landed (one arrival with the byte
// count, then the bytes); `empty` when every consumer warp has finished
// reading it (kConsumers * 4 arrivals). The swept tiles use a ring of
// several stages; the tiles a work item keeps resident use a ring of 2,
// so the next item's tiles load while this one finishes.
template <int kStages>
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];

  __device__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
  }
  // producer: wait until tile `it`'s buffer is free
  __device__ void wait_empty(int it) {
    if (it >= kStages) mbar_wait(&empty[it % kStages], (it / kStages - 1) & 1);
  }
  // consumer: wait until tile `it` has landed
  __device__ void wait_full(int it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
  }
  // consumer: lane 0 of each warp releases tile `it` once its products
  // have completed
  __device__ void release(int it, int lane) {
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  }
};

// ----------------------------------------------------------------------------
// TMA
// ----------------------------------------------------------------------------

// Copy one box (64 columns at d0, head h, rows [s0, s0 + box rows),
// batch b) of a 4-D (d, h, s, b) map into shared memory, completing
// `bytes` on `bar`. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h,
                                         int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// One tile of ROWS rows and D columns: D / 64 boxes, one per panel.
template <int ROWS, int D>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s0,
                                         int b) {
#pragma unroll
  for (int p = 0; p < D / kPanelCols; ++p)
    tma_load(tile + p * ROWS * kPanelCols, map, bar, p * kPanelCols, h, s0,
             b);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing them on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Rows of the fp32 logsumexp and delta, (b, h, lse_rows(sq)): sq rounded
// up to 128 (the kernels' row block), so that every 32- or 64-row slice
// the backward copies in bulk starts 16-byte aligned and lies inside its
// row. The forward writes 0 past sq and so does the delta kernel.
__host__ __device__ constexpr int lse_rows(int sq) {
  return (sq + 127) / 128 * 128;
}

// The kernels index work items, lse and delta rows with 32-bit ints:
// batch * heads * lse_rows(max(sq, sk)) must stay below 2^31. Neither
// grid dimension of K2/K3 depends on batch * heads (the grids are
// persistent); the generic kernels' grid x, 64-row tiles x batch x
// heads, stays below the same bound.
inline bool indices_fit(int batch, int nh, int sq, int sk) {
  return (long long)batch * nh * lse_rows(sq > sk ? sq : sk) < (1ll << 31);
}

template <int ROWS, int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return ROWS * D * sizeof(bf16);
}

// ----------------------------------------------------------------------------
// wgmma
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor offsets (16-byte units) of k step `kk` (16 columns) of a
// K-major tile of ROWS rows, and of k step `kk` (16 rows) of an MN-major
// tile. Adding one to a descriptor moves its start address, so each
// product builds its base descriptors once.
template <int ROWS>
__host__ __device__ constexpr uint64_t kmajor_step(int kk) {
  return ((kk >> 2) * ROWS * 128 + (kk & 3) * 32) >> 4;
}
__host__ __device__ constexpr uint64_t mnmajor_step(int kk) {
  return kk * 16 * 128 >> 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight (the
// oldest complete first)
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator or
// A-fragment registers across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KSTEPS>
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < KSTEPS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// 2^x on the special-function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) (+)= A (64 x 16, smem desc) * B (16 x 32, smem desc)
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  // d (64 x 32, fp32) (+)= A (64 x 16, bf16 registers) * B (smem desc)
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) (+)= A (64 x 16, smem desc) * B (16 x 64, smem desc)
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  // d (64 x 64, fp32) (+)= A (64 x 16, bf16 registers) * B (smem desc)
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) (+)= A (64 x 16, smem desc) * B (16 x 128, smem desc)
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  // d (64 x 128, fp32) (+)= A (64 x 16, bf16 registers) * B (smem desc)
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
};

// d (64 x N) (+)= A (rows [a_row0, a_row0 + 64) of a K-major tile of
// ROWS_A rows) * B^T (the N rows of a K-major tile) over KSTEPS x 16
// columns; the first step overwrites d.
template <int N, int KSTEPS, int ROWS_A, int ROWS_B>
__device__ __forceinline__ void gemm_ss(float* d, const bf16* a, int a_row0,
                                        const bf16* b) {
  const uint64_t da = make_desc(a + a_row0 * kPanelCols, 16, 1024);
  const uint64_t db = make_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    Wgmma<N>::template ss<0>(d, da + kmajor_step<ROWS_A>(kk),
                             db + kmajor_step<ROWS_B>(kk), kk > 0);
}

// d (64 x N) += A (registers, KSTEPS x 4 packed bf16x2) * B (MN-major
// tile of ROWS rows, n over its N columns)
template <int N, int KSTEPS, int ROWS>
__device__ __forceinline__ void gemm_rs(float* d, const uint32_t (*a)[4],
                                        const bf16* b) {
  const uint64_t db = make_desc(b, ROWS * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    Wgmma<N>::template rs<1>(d, a[kk], db + mnmajor_step(kk), 1);
}

// two fp32 values rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a product over the N columns of accumulator `d`.
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Store a warpgroup's 64 x D fp32 accumulator as bf16 rows
// (row i at base + i * row_stride), rows at or past `rows_valid` skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           const float* d, int row0,
                                           int rows_valid, float mul) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 16 * w + (lane >> 2) + 8 * j;
    if (row >= rows_valid) continue;
    bf16* r = base + row * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(r + 8 * c) =
          pack_bf16(d[4 * c + 2 * j] * mul, d[4 * c + 2 * j + 1] * mul);
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// Bottom-right-aligned causal rule of `_causal_keep`: query row q sees
// key j iff q + (sk - sq) >= j.
__device__ __forceinline__ bool causal_keep(int q, int j, int off) {
  return q + off >= j;
}

// ----------------------------------------------------------------------------
// host: tensor maps
// ----------------------------------------------------------------------------

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (d, h, s, b) map of a (b, s, h, d) bf16 tensor with element strides
// `st` (head dim contiguous), boxes of 64 columns x `rows` rows, 128-byte
// swizzle, zero fill past the ends. False if the driver refuses it
// (base not 16-byte aligned, a stride not a multiple of 16 bytes).
inline bool make_map(CUtensorMap* map, const void* base, int batch, int seq,
                     int nh, int d, Strides st, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nh, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kPanelCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Persistent grids: one CTA per SM. The producer thread of each CTA takes
// the next work item from a global counter (zeroed by the launcher before
// the kernel) and hands its index to the consumers in shared memory,
// beside the item's resident tiles; -1 ends the CTA. Work item i maps to
// (head bh, rank of its tile, 0 for the tile with the most work): heads
// go in groups of kHeadGroup, and inside a group all heads' rank-0 tiles
// come first, then their rank-1 tiles and so on. So the tiles that read
// one head's K and V (or Q and G) run close together and find them in L2,
// the long tiles start early and the short ones fill the end.
constexpr int kHeadGroup = 32;

__device__ __forceinline__ void schedule(int i, int nbh, int ntiles, int& bh,
                                         int& rank) {
  const int group = i / (kHeadGroup * ntiles);
  const int r = i - group * kHeadGroup * ntiles;
  const int heads = min(kHeadGroup, nbh - group * kHeadGroup);
  rank = r / heads;
  bh = group * kHeadGroup + r % heads;
}

// The producer's side of the hand-over: slot j & 1 of `ring` (whose full
// barrier also carries the item's resident tiles) receives the next item
// index, or -1 and a plain arrival when the work is done. Returns the
// index.
__device__ __forceinline__ int take_item(int* counter, int items,
                                         int* slot_item, Ring<2>& ring,
                                         int j) {
  ring.wait_empty(j);
  const int i = atomicAdd(counter, 1);
  slot_item[j & 1] = i < items ? i : -1;
  if (i >= items) mbar_arrive(&ring.full[j & 1]);
  return i < items ? i : -1;
}

// The consumers' side: wait for slot j & 1 and read its item index.
__device__ __forceinline__ int wait_item(const int* slot_item, Ring<2>& ring,
                                         int j) {
  ring.wait_full(j);
  return *reinterpret_cast<const volatile int*>(&slot_item[j & 1]);
}

// Persistent grids: one CTA per SM.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n > 0 ? n : 1;
}

// The kernel's shared-memory layout at the first 1024-byte boundary of
// the dynamic shared memory (which is only 16-byte aligned; the tiles
// need 1024). Pointer arithmetic on `raw` keeps the shared address
// space visible to the compiler.
template <typename T>
__device__ __forceinline__ T& smem_layout(unsigned char* raw) {
  const uint32_t pad = (1024 - (smem_addr(raw) & 1023)) & 1023;
  return *reinterpret_cast<T*>(raw + pad);
}

}  // namespace flash
