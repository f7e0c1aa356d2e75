// Shared pieces of the flash-attention kernels K2 (forward) and K3
// (backward) on Hopper (sm_90a): TMA tile loads through 4-D tensor maps
// with the 64- or 128-byte swizzle, mbarrier rings, warpgroup matrix
// products (wgmma.mma_async) on shared-memory descriptors, the 3xTF32
// split of fp32 operands, and the one causal rule.
//
// Two element types take the same kernels: bf16 (one product per
// product, k16 steps) and fp32 through 3xTF32 (`tf32x3`: each operand x
// is split into hi = x with its 13 low mantissa bits cleared and lo =
// x - hi rounded to TF32, nearest, both read by the tensor cores
// exactly; a product is lo.hi + hi.lo + hi.hi, k8 steps, summed in the
// fp32 accumulator; the dropped lo.lo and lo's rounding leave about
// 2^-21 of each term, without the bias a truncated lo would add).
//
// Tiles in shared memory. A tile of R rows of C values is stored as
// column panels of one swizzle row each: 128 bytes (64 bf16 or 32 fp32
// columns), or 64 bytes where a whole row is 64 bytes (bf16 at 32
// columns, fp32 at 16). Panel p holds R rows of its columns in TMA's
// swizzle (the 16-byte chunk c of row r sits at chunk c ^ (r % 8) for
// 128 bytes, c ^ ((r / 2) % 4) for 64). Every tile starts on a 1024-byte
// boundary, so the swizzle that TMA writes and the one the wgmma
// descriptors name agree on absolute address bits. One TMA box is one
// panel of R rows of one (head, batch) of a 4-D (cols, h, rows, b) map.
//
// wgmma operands from such a tile (descriptor: start >> 4, leading and
// stride byte offsets >> 4, layout 1 = 128-byte, 2 = 64-byte swizzle):
//   K-major (the tile's columns are the product's k): 8-row groups are
//     8 swizzle rows apart (stride offset); a k step is 32 bytes (16
//     bf16 or 8 fp32 columns) inside a panel, then the next panel.
//   MN-major (bf16 only; the tile's rows are the product's k, its
//     columns n): the k step of 16 rows moves the start by 16 swizzle
//     rows; 8-row groups are 8 swizzle rows apart (stride offset) and
//     the panels of n one panel apart (leading offset).
// TF32 wgmma reads both shared-memory operands K-major only, so the fp32
// kernels read the B operand of P V, P^T G, dS^T Q and dS K from
// transposed copies that `split_kernel` writes (d by rows). The tensor
// cores read an fp32 operand as TF32 by clearing its 13 low mantissa
// bits (chip_smoke.py's phase 3b checks the rule), which is hi: where
// TMA can read an input as it lies, its rows are their own hi part and
// the split writes only their lo part.
//
// The tensor cores add each step into the fp32 accumulator with a
// truncation, so a running sum over many tiles of 3xTF32 steps drifts
// one way (past 1e-5 of the plain fp32 version for dk and dv at s 1024;
// tests/test_torch_tf32x3.py models it). The fp32 backward sums each
// swept tile into a fresh accumulator and adds that to the running sum
// with an fp32 add, which rounds. The forward keeps one running sum of
// P V: the same model puts it 8x inside 1e-5 at the longest preset rows
// (d 128, s 2048), and chip_smoke.py's phase 3 holds it there.
//
// Accumulator layout of wgmma m64nN (f32), thread i of a warpgroup,
// warp w = i / 32, g = (i % 32) / 4, t = i % 4: d[4c + 2j + e] is row
// 16w + g + 8j, column 8c + 2t + e. A from registers uses the same rows:
//   bf16 (m64 k16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..), so an accumulator over k columns repacks into
//     the A fragments of a product over those columns in place;
//   tf32 (m64 k8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
//     The accumulator holds columns 2t and 2t+1 instead, so fragment
//     slot s of each 8-column step carries column tf32_key(s) (0, 2, 4,
//     6, 1, 3, 5, 7), and the transposed B copies store the keys of each
//     group of 8 in that order: the sum over k is the same sum.
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
// A CTA is C consumer warpgroups (C = 2 for bf16; 1 or 2 for fp32, whose
// hi and lo tiles take four times the shared memory) and one producer
// warpgroup, of which one thread issues the copies and the rest exit
// after giving up their registers. One CTA per SM: every kernel is
// compiled for 384 threads (168 registers each at entry, 65,536 / 384
// rounded down to 8); the producer keeps 24 and the consumers take 240,
// 128 x 24 + 256 x 240 = 64,512 <= 384 x 168.
constexpr int kMaxThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

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
// count, then the bytes); `empty` when every consumer warp (C warpgroups)
// has finished reading it. The swept tiles use a ring of several stages;
// the tiles a work item keeps resident a ring of 2 (the next item's
// tiles load while this one finishes) or 1 where shared memory is short.
template <int kStages, int C>
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];

  __device__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C * 4);
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
// tile layout
// ----------------------------------------------------------------------------

// A tile of ROWS rows and COLS columns of T in panels of one swizzle row
template <typename T, int ROWS, int COLS>
struct Tile {
  static constexpr int kRowBytes = COLS * (int)sizeof(T);
  static constexpr int kSwizzle = kRowBytes < 128 ? kRowBytes : 128;
  static_assert(kSwizzle == 64 || kSwizzle == 128, "64- or 128-byte rows");
  static constexpr int kPanelCols = kSwizzle / (int)sizeof(T);
  static constexpr int kPanels = COLS / kPanelCols;
  static constexpr int kPanelElems = ROWS * kPanelCols;
  static constexpr int kPanelBytes = ROWS * kSwizzle;
  static constexpr int kElems = ROWS * COLS;
  static constexpr uint32_t kBytes = ROWS * COLS * sizeof(T);
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
};

// ----------------------------------------------------------------------------
// TMA
// ----------------------------------------------------------------------------

// Copy one box (one panel's columns at c0, head h, rows [r0, r0 + box
// rows), batch b) of a 4-D (cols, h, rows, b) map into shared memory,
// completing its bytes on `bar`. Rows and columns past the tensor's end
// arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h,
                                         int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(r0), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// One tile of ROWS rows from r0 and COLS columns from c0: one box per
// panel.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void tma_tile(T* tile, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h,
                                         int r0, int b) {
  using L = Tile<T, ROWS, COLS>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(tile + p * L::kPanelElems, map, bar, c0 + p * L::kPanelCols, h,
             r0, b);
}

// An operand's tensor maps: `hi` over its values (bf16: the only one),
// `lo`, fp32 only, over split_kernel's residuals. Both take the same
// coordinates.
struct Op {
  CUtensorMap hi, lo;
};

// tma_tile of every part of T's operand into consecutive tiles: hi, then
// (fp32) lo.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void tma_op(T* tile, const Op& op, uint64_t* bar,
                                       int c0, int h, int r0, int b) {
  tma_tile<T, ROWS, COLS>(tile, &op.hi, bar, c0, h, r0, b);
  if constexpr (is_f32<T>())
    tma_tile<T, ROWS, COLS>(tile + Tile<T, ROWS, COLS>::kElems, &op.lo, bar,
                            c0, h, r0, b);
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
// up to 128 (the kernels' row block), so that every 16- to 64-row slice
// the backward copies in bulk starts 16-byte aligned and lies inside its
// row. The forward writes 0 past sq and so does the delta kernel.
__host__ __device__ constexpr int lse_rows(int sq) {
  return (sq + 127) / 128 * 128;
}

// The kernels index work items, lse and delta rows with 32-bit ints:
// batch * heads * lse_rows(max(sq, sk)) must stay below 2^31. No grid
// dimension of K2/K3 depends on batch * heads (the grids are
// persistent); the split kernel's grid x, 32-row tiles x batch x heads,
// stays below the same bound.
inline bool indices_fit(int batch, int nh, int sq, int sk) {
  return (long long)batch * nh * lse_rows(sq > sk ? sq : sk) < (1ll << 31);
}

// ----------------------------------------------------------------------------
// wgmma
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Descriptors of a tile L = Tile<T, ROWS, COLS>. K-major: rows [row0,
// row0 + 64) of the tile, k over its columns; k step `kk` (32 bytes)
// adds kstep(kk). MN-major: k over its rows, n over its columns; k step
// `kk` (16 rows) adds mnstep(kk). Adding to a descriptor moves its start
// address, so each product builds its base descriptors once.
template <typename L, typename T>
__device__ __forceinline__ uint64_t kdesc(const T* tile, int row0) {
  return make_desc(tile + row0 * L::kPanelCols, 16, 8 * L::kSwizzle,
                   L::kLayout);
}
template <typename L>
__host__ __device__ constexpr uint64_t kstep(int kk) {
  return ((kk * 32 / L::kSwizzle) * L::kPanelBytes +
          (kk * 32) % L::kSwizzle) >> 4;
}
template <typename L, typename T>
__device__ __forceinline__ uint64_t mndesc(const T* tile) {
  return make_desc(tile, L::kPanelBytes, 8 * L::kSwizzle, L::kLayout);
}
template <typename L>
__host__ __device__ constexpr uint64_t mnstep(int kk) {
  return (kk * 16 * L::kSwizzle) >> 4;
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

template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<16> {
  // d (64 x 16, fp32) (+)= A (64 x 8, smem desc) * B (8 x 16, smem desc)
  static __device__ __forceinline__ void ss(float* d,
      uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<32> {
  // d (64 x 32, fp32) (+)= A (64 x 8, smem desc) * B (8 x 32, smem desc)
  static __device__ __forceinline__ void ss(float* d,
      uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (64 x 32, fp32) (+)= A (64 x 8, tf32 registers) * B (smem desc)
  static __device__ __forceinline__ void rs(float* d,
      const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  // d (64 x 64, fp32) (+)= A (64 x 8, smem desc) * B (8 x 64, smem desc)
  static __device__ __forceinline__ void ss(float* d,
      uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (64 x 64, fp32) (+)= A (64 x 8, tf32 registers) * B (smem desc)
  static __device__ __forceinline__ void rs(float* d,
      const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  // d (64 x 128, fp32) (+)= A (64 x 8, tf32 registers) * B (smem desc)
  static __device__ __forceinline__ void rs(float* d,
      const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};


// A fragments of a product over K columns, taken from registers
template <typename T, int K>
struct Frags;
template <int K>
struct Frags<bf16, K> {
  uint32_t a[K / 16][4];
};
template <int K>
struct Frags<float, K> {  // 3xTF32: the hi and lo parts
  uint32_t hi[K / 8][4];
  uint32_t lo[K / 8][4];
};

template <typename T, int K>
__device__ __forceinline__ void zero_frags(Frags<T, K>& f) {
  uint32_t* r = reinterpret_cast<uint32_t*>(&f);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(f) / 4); ++i) r[i] = 0u;
}

template <int K>
__device__ __forceinline__ void fence_frags(Frags<bf16, K>& f) {
  fence_regs<K / 16>(f.a);
}
template <int K>
__device__ __forceinline__ void fence_frags(Frags<float, K>& f) {
  fence_regs<K / 8>(f.hi);
  fence_regs<K / 8>(f.lo);
}

// d (64 x N) (+)= A (rows [a_row0, a_row0 + 64) of a K-major tile of
// ROWS_A rows and KC columns) * B^T (a K-major tile of N rows and KC
// columns); the first product overwrites d. bf16: KC / 16 k steps. fp32:
// 3xTF32, each tile's lo part right after its hi part, three passes of
// KC / 8 k steps (lo.hi, hi.lo, hi.hi: the small terms first).
template <typename T, int N, int KC, int ROWS_A>
__device__ __forceinline__ void gemm_ss(float* d, const T* a, int a_row0,
                                        const T* b) {
  using LA = Tile<T, ROWS_A, KC>;
  using LB = Tile<T, N, KC>;
  const uint64_t da = kdesc<LA>(a, a_row0), db = kdesc<LB>(b, 0);
  if constexpr (!is_f32<T>()) {
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      Wgmma<N>::template ss<0>(d, da + kstep<LA>(kk), db + kstep<LB>(kk),
                               kk > 0);
  } else {
    const uint64_t dal = kdesc<LA>(a + LA::kElems, a_row0);
    const uint64_t dbl = kdesc<LB>(b + LB::kElems, 0);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      WgmmaTf32<N>::ss(d, dal + kstep<LA>(kk), db + kstep<LB>(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      WgmmaTf32<N>::ss(d, da + kstep<LA>(kk), dbl + kstep<LB>(kk), 1);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      WgmmaTf32<N>::ss(d, da + kstep<LA>(kk), db + kstep<LB>(kk), 1);
  }
}

// d (64 x N) (+)= A (registers, 64 x K) * B; with `overwrite` the first
// product overwrites d. bf16: B is a tile of K rows and N columns read
// MN-major. fp32: B^T, a transposed copy of N rows and K columns (keys
// in tf32_key's order) read K-major, 3xTF32.
template <typename T, int N, int K>
__device__ __forceinline__ void gemm_rs(float* d, const Frags<T, K>& a,
                                        const T* b, bool overwrite = false) {
  const int first = overwrite ? 0 : 1;
  if constexpr (!is_f32<T>()) {
    using LB = Tile<T, K, N>;
    const uint64_t db = mndesc<LB>(b);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      Wgmma<N>::template rs<1>(d, a.a[kk], db + mnstep<LB>(kk),
                               kk > 0 ? 1 : first);
  } else {
    using LB = Tile<T, N, K>;
    const uint64_t db = kdesc<LB>(b, 0), dbl = kdesc<LB>(b + LB::kElems, 0);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
      WgmmaTf32<N>::rs(d, a.lo[kk], db + kstep<LB>(kk), kk > 0 ? 1 : first);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
      WgmmaTf32<N>::rs(d, a.hi[kk], dbl + kstep<LB>(kk), 1);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
      WgmmaTf32<N>::rs(d, a.hi[kk], db + kstep<LB>(kk), 1);
  }
}

// two fp32 values rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x with its 13 low mantissa bits cleared: exact in TF32, and x - hi is
// exact in fp32
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// lo = x - hi rounded to TF32 (nearest, ties away from zero)
__device__ __forceinline__ float tf32_lo(float x, float hi) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x - hi));
  return __uint_as_float(y);
}

// The key (column of an 8-column k step) that tf32 fragment slot `slot`
// carries: 0, 2, 4, 6, 1, 3, 5, 7
__host__ __device__ constexpr int tf32_key(int slot) {
  return slot < 4 ? 2 * slot : 2 * slot - 7;
}

// The A fragments of a product over the K columns of accumulator `d`.
template <int K>
__device__ __forceinline__ void to_a_frags(Frags<bf16, K>& f,
                                           const float* d) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    f.a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    f.a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f.a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f.a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}
template <int K>
__device__ __forceinline__ void to_a_frags(Frags<float, K>& f,
                                           const float* d) {
#pragma unroll
  for (int c = 0; c < K / 8; ++c) {
    // slots t and t + 4 of rows g and g + 8: columns 2t and 2t + 1
    const float x[4] = {d[4 * c], d[4 * c + 2], d[4 * c + 1], d[4 * c + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hi = tf32_hi(x[i]);
      f.hi[c][i] = __float_as_uint(hi);
      f.lo[c][i] = __float_as_uint(tf32_lo(x[i], hi));
    }
  }
}

// two adjacent values of a row, stored in T
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Store a warpgroup's 64 x D fp32 accumulator as rows of T (row i at
// base + i * row_stride, times `mul`), rows at or past `rows_valid`
// skipped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           const float* d, int row0,
                                           int rows_valid, float mul) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 16 * w + (lane >> 2) + 8 * j;
    if (row >= rows_valid) continue;
    T* r = base + row * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2(r + 8 * c, d[4 * c + 2 * j] * mul, d[4 * c + 2 * j + 1] * mul);
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
  long long b, s, h;  // element strides; the last dim is contiguous
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

// The (cols, h, rows, b) map of a (b, rows, h, cols) tensor of T with
// element strides `st` (cols contiguous), boxes of one panel of TILE
// (its swizzle row of columns) x TILE's rows, zero fill past the ends.
// False if the driver refuses it (base not 16-byte aligned, a stride not
// a multiple of 16 bytes).
template <typename TILE, typename T>
inline bool make_map(CUtensorMap* map, const T* base, int batch, int rows,
                     int nh, int cols, Strides st) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  constexpr cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)nh,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * e, (cuuint64_t)st.s * e,
                                 (cuuint64_t)st.b * e};
  const cuuint32_t box[4] = {(cuuint32_t)TILE::kPanelCols, 1,
                             (cuuint32_t)(TILE::kPanelElems /
                                          TILE::kPanelCols),
                             1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map,
             is_f32<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<T*>(base), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             TILE::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ----------------------------------------------------------------------------
// the fp32 route's operands: hi and lo, as rows and transposed
// ----------------------------------------------------------------------------

// split_kernel reads an fp32 tensor x (b, s, h, D) with any (b, s, h)
// strides and a contiguous head dim and writes its hi and lo parts:
// `nat` (2, b, h, s, D) row-major, the hi half (only if `nat_hi`: an x
// that TMA reads in place is its own hi, see `row_op`) then the lo half,
// and `tr` (2, b, h, D, pad8(s)) the same transposed, the keys of each
// group of 8 in tf32_key's order and 0 past s. Either may be null. One
// block: 32 rows of one (batch, head) of one operand (blockIdx.y). Plain
// loads, so any strides go.
struct SplitOp {
  const float* x;
  float* nat;
  float* tr;
  Strides st;
  int seq;
  bool nat_hi;
};
struct SplitArgs {
  SplitOp op[4];
  int nbh, nh;
};
constexpr int kSplitRows = 32;
constexpr int kSplitThreads = 256;

__host__ __device__ constexpr int pad8(int s) { return (s + 7) / 8 * 8; }

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const __grid_constant__ SplitArgs a) {
  __shared__ float tile[kSplitRows][D + 1];
  const SplitOp& op = a.op[blockIdx.y];
  const int s8 = pad8(op.seq);
  const int ntiles = (s8 + kSplitRows - 1) / kSplitRows;
  if ((int)blockIdx.x >= ntiles * a.nbh) return;
  const int bh = blockIdx.x / ntiles, r0 = (blockIdx.x % ntiles) * kSplitRows;
  const int b = bh / a.nh, h = bh % a.nh;
  const float* x = op.x + b * op.st.b + h * op.st.h;
  for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    tile[r][c] = s < op.seq ? x[(long long)s * op.st.s + c] : 0.f;
  }
  __syncthreads();
  if (op.nat != nullptr) {
    const long long lo = (long long)a.nbh * op.seq * D;
    for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
      const int r = i / D, c = i % D, s = r0 + r;
      if (s >= op.seq) break;  // i only grows
      const float v = tile[r][c], hi = tf32_hi(v);
      const long long o = ((long long)bh * op.seq + s) * D + c;
      if (op.nat_hi) op.nat[o] = hi;
      op.nat[o + lo] = tf32_lo(v, hi);
    }
  }
  if (op.tr != nullptr) {
    const long long lo = (long long)a.nbh * D * s8;
    for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
      const int c = i / kSplitRows, r = i % kSplitRows, s = r0 + r;
      if (s >= s8) continue;
      const float v = tile[(r & ~7) + tf32_key(r & 7)][c], hi = tf32_hi(v);
      const long long o = ((long long)bh * D + c) * s8 + s;
      op.tr[o] = hi;
      op.tr[o + lo] = tf32_lo(v, hi);
    }
  }
}

// Floats of one operand's hi and lo pieces (row-major or transposed),
// rounded up to 64 (256 bytes) so that every piece of a scratch buffer
// starts 256-byte aligned.
inline long long nat_floats(int nbh, int seq, int d) {
  return (2ll * nbh * seq * d + 63) / 64 * 64;
}
inline long long tr_floats(int nbh, int seq, int d) {
  return (2ll * nbh * d * pad8(seq) + 63) / 64 * 64;
}

// Launch split_kernel over `n` operands of up to `max_seq` rows.
template <int D>
cudaError_t launch_split(const SplitArgs& a, int n, int max_seq,
                         cudaStream_t stream) {
  const int ntiles = (pad8(max_seq) + kSplitRows - 1) / kSplitRows;
  split_kernel<D><<<dim3(ntiles * a.nbh, n), kSplitThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Maps over part `part` (0 hi, 1 lo) of split_kernel's pieces: rows,
// read as ROWS x D tiles, and transposed, read as ROWS x COLS tiles (ROWS
// of the D rows, from r0) from key k0 (coordinates: c0 = k0, r0).
template <int D, int ROWS>
inline bool nat_map(CUtensorMap* map, const float* base, int batch, int nh,
                    int seq, int part) {
  const long long n = (long long)batch * nh * seq * D;
  return make_map<Tile<float, ROWS, D>>(
      map, base + part * n, batch, seq, nh, D,
      Strides{(long long)nh * seq * D, D, (long long)seq * D});
}
template <int D, int COLS, int ROWS = D>
inline bool tr_map(CUtensorMap* map, const float* base, int batch, int nh,
                   int seq, int part) {
  const int s8 = pad8(seq);
  const long long n = (long long)batch * nh * D * s8;
  return make_map<Tile<float, ROWS, COLS>>(
      map, base + part * n, batch, D, nh, s8,
      Strides{(long long)nh * D * s8, s8, (long long)D * s8});
}

// Whether TMA reads an fp32 tensor with element strides `st` as it lies:
// a 16-byte aligned base and (b, s, h) strides of whole 16 bytes.
inline bool in_place(const float* x, Strides st) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && st.b % 4 == 0 &&
         st.s % 4 == 0 && st.h % 4 == 0;
}

// The maps of fp32 operand x (b, seq, h, D) read as ROWS x D row tiles:
// hi over x itself where TMA reads it in place (the tensor cores read it
// as hi), else over split_kernel's hi copy in `nat`; lo over `nat`.
template <int D, int ROWS>
inline bool row_op(Op* op, const float* x, Strides st, const float* nat,
                   int batch, int nh, int seq) {
  const bool hi = in_place(x, st)
                      ? make_map<Tile<float, ROWS, D>>(&op->hi, x, batch, seq,
                                                       nh, D, st)
                      : nat_map<D, ROWS>(&op->hi, nat, batch, nh, seq, 0);
  return hi && nat_map<D, ROWS>(&op->lo, nat, batch, nh, seq, 1);
}
// The maps of a transposed copy `tr`, read as ROWS x COLS tiles.
template <int D, int COLS, int ROWS = D>
inline bool tr_op(Op* op, const float* tr, int batch, int nh, int seq) {
  return tr_map<D, COLS, ROWS>(&op->hi, tr, batch, nh, seq, 0) &&
         tr_map<D, COLS, ROWS>(&op->lo, tr, batch, nh, seq, 1);
}
// The map of a bf16 operand, over the tensor itself.
template <int ROWS, int D>
inline bool bf16_op(Op* op, const bf16* x, Strides st, int batch, int nh,
                    int seq) {
  return make_map<Tile<bf16, ROWS, D>>(&op->hi, x, batch, seq, nh, D, st);
}

// ----------------------------------------------------------------------------
// persistent grids
// ----------------------------------------------------------------------------

// One CTA per SM. The producer thread of each CTA takes the next work
// item from a global counter (zeroed by the launcher before the kernel)
// and hands its index to the consumers in shared memory, beside the
// item's resident tiles; -1 ends the CTA. Work item i maps to (head bh,
// rank of its tile, 0 for the tile with the most work): heads go in
// groups of kHeadGroup, and inside a group all heads' rank-0 tiles come
// first, then their rank-1 tiles and so on. So the tiles that read one
// head's K and V (or Q and G) run close together and find them in L2,
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

// The producer's side of the hand-over: slot j % S of `ring` (whose full
// barrier also carries the item's resident tiles) receives the next item
// index, or -1 and a plain arrival when the work is done. Returns the
// index.
template <int S, int C>
__device__ __forceinline__ int take_item(int* counter, int items,
                                         int* slot_item, Ring<S, C>& ring,
                                         int j) {
  ring.wait_empty(j);
  const int i = atomicAdd(counter, 1);
  slot_item[j % S] = i < items ? i : -1;
  if (i >= items) mbar_arrive(&ring.full[j % S]);
  return i < items ? i : -1;
}

// The consumers' side: wait for slot j % S and read its item index.
template <int S, int C>
__device__ __forceinline__ int wait_item(const int* slot_item,
                                         Ring<S, C>& ring, int j) {
  ring.wait_full(j);
  return *reinterpret_cast<const volatile int*>(&slot_item[j % S]);
}

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
