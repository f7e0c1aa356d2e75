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
// times, so the k * n int8 weights dominate; the bound is k * n bytes
// over 3.35 TB/s. `__dp4a` does 4 MACs per instruction on the CUDA
// cores (about 60 T MAC/s on 132 SMs by the instruction rate), so at m <= 4
// the products stay under the byte bound without the tensor cores. At
// GPT-small's block shapes (0.6-2.4 MB) a call is as short as a few
// DRAM round trips, so its latency chain sets the time.
//
// Design (the plan's numbers come from `launch_plan` in the wrapper):
// - Tiles of 16 * G output columns (G = 1, 2 or 4 groups of 16). The
//   weight keeps JAX's (k, n) row-major layout: thread (g, kl) of a CTA
//   reads 16 contiguous bytes (16 columns) of a k-row, and the G threads
//   of one k-lane read 16 * G contiguous bytes, so every 32-byte sector
//   a warp touches is used whole.
// - Along k the weight rows go in quads (4 rows). A thread loads the 4
//   rows of a quad (4 x 16 bytes) and `__byte_perm` turns each 4 row
//   words of 4 columns into 4 column words of 4 k-codes (2 permutes per
//   word); `__dp4a` multiplies a column word with the activation's 4
//   codes of the same quad, packed in one int32 and read from shared
//   memory as a broadcast. About 1.5 integer instructions per weight
//   byte at m = 4.
// - The k-lanes of a CTA take the quads of its k-range in turn; the
//   CTAs of one thread-block cluster (up to 8, for the narrow shapes)
//   take consecutive k-ranges of the same tiles (split-k). The wide
//   shapes run one cluster of 1 CTA per tile slot and stride over the
//   tiles (persistent), so each CTA quantizes x once.
// - No weight load waits on the quantize: a thread starts its first
//   quad's loads and the tile's weight-scale and bias loads, then
//   quantizes its CTA's k-range of x into packed words; the next quad
//   (or the next tile's first) is in flight while a quad is multiplied.
// - Reduction: each thread stores its m x 16 sums to shared memory in
//   one pass (k-lane stride padded and 16-byte chunks rotated by g, so
//   no two threads of an 8-thread phase share a bank), one thread per
//   output adds the k-lanes. Across the cluster each rank owns a slice
//   of the tile's outputs: every rank stores its partials of that slice
//   into the owner's shared memory (distributed shared memory), and
//   after one cluster barrier the owner adds them in rank order and runs
//   the epilogue. Integer addition is exact and associative, so the sum
//   does not depend on the split: |acc| <= 127^2 * k < 2^31 for k <=
//   133,144.
//
// Rounding points are pinned one by one, so the kernel, its plain
// version and the TPU kernel give the same bits: the quantize divides
// with an IEEE divide (__fdiv_rn) and rounds half to even (rintf); the
// epilogue spells out each rounding (__fmul_rn / __fadd_rn never fuse
// into an FMA); bf16 output rounds to nearest even. The build uses no
// fast-math flag.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "timer_floor.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 4;
constexpr int kMaxCluster = 8;   // the portable thread-block cluster size
constexpr int kMaxGroups = 4;    // column groups of 16 per tile
constexpr int kSmemLimit = 232448;
constexpr int kPrologue = 4;     // packed words per thread per load batch

enum DType { kF32 = 0, kBF16 = 1 };
// timing variants (phase 8 only): skip the quantize prologue, skip the
// shared-memory and cluster reduction, skip only the cluster merge
enum Parts { kAll = 0, kNoPrologue = 1, kNoReduction = 2, kNoMerge = 4 };

// The launch plan, chosen by the wrapper (`launch_plan`).
struct Plan {
  int groups;         // G: column groups of 16 per tile
  int cluster;        // S: CTAs per cluster, one k-range each
  int quads_per_cta;  // quads (4 k-rows) per k-range
  int threads;        // G x k-lanes
  int grid;           // clusters x S
};

// shared memory, in int32 words: the packed codes, the reduction
// buffer (k-lane stride padded by 4 G words), and two buffers each of
// cluster partials and of the tile's weight scales and biases
__host__ __device__ inline int xq_words(int m, int qpc) {
  return (qpc * m + 3) / 4 * 4;
}
__host__ __device__ inline int red_stride(int m, int g) {
  return 16 * m * g + 4 * g;
}
inline size_t smem_bytes(int m, const Plan& p) {
  const int lanes = p.threads / p.groups;
  return 4 * static_cast<size_t>(xq_words(m, p.quads_per_cta) +
                                 lanes * red_stride(m, p.groups) +
                                 2 * (m * 16 * p.groups + kMaxCluster) +
                                 4 * 16 * p.groups);
}

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  return dtype == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* out, int dtype, long long i,
                                          float y) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the 4 rows of quad q at column `col` (16 bytes each); rows past k and
// dead items read as zero
__device__ __forceinline__ void load_quad(uint4 (&w)[4],
                                          const int8_t* __restrict__ qw,
                                          int k, int n, int col, int q,
                                          bool live) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * q + i;
    w[i] = live && r < k
               ? __ldg(reinterpret_cast<const uint4*>(
                     qw + static_cast<long long>(r) * n + col))
               : make_uint4(0, 0, 0, 0);
  }
}

// the weight scale and bias of column `col` (0 past n or without a bias)
__device__ __forceinline__ float2 load_epilogue(const void* ws, int ws_dtype,
                                                const void* bias,
                                                int bias_dtype, int col,
                                                int n) {
  float2 e = make_float2(0.f, 0.f);
  if (col < n) {
    e.x = load_f32(ws, ws_dtype, col);
    if (bias != nullptr) e.y = load_f32(bias, bias_dtype, col);
  }
  return e;
}

// out[m][col] = the int32 sum s scaled by ws * sx, plus the bias, in x's
// dtype; `epi` holds the tile's weight scales, then its biases
__device__ __forceinline__ void epilogue(void* out, int dtype, int n,
                                         int tile_cols, int m, int col,
                                         int c, int s, const float* epi,
                                         float sx, bool has_bias) {
  if (col >= n) return;
  float y = __fmul_rn(__int2float_rn(s), __fmul_rn(epi[c], sx));
  if (has_bias) y = __fadd_rn(y, epi[tile_cols + c]);
  store_out(out, dtype, static_cast<long long>(m) * n + col, y);
}

// acc[m][c] += sum_i code(x[m], 4q + i) * qw[4q + i][col + c]: the 4 row
// words holding columns 4j..4j+3 become 4 column words along k
//   t0 = {a0 b0 a1 b1} = prmt(a, b, 0x5140)   t1 = {a2 b2 a3 b3} = 0x7362
//   t2, t3 the same of (c, d)
//   col 4j   = {a0 b0 c0 d0} = prmt(t0, t2, 0x5410), col 4j+1 = 0x7632
//   col 4j+2 = prmt(t1, t3, 0x5410),                 col 4j+3 = 0x7632
// (byte i of a column word is k-row 4q + i, as in the packed codes)
template <int M>
__device__ __forceinline__ void mac_quad(const uint4 (&w)[4],
                                         const int* __restrict__ xw,
                                         int (&acc)[M][16]) {
  int xv[M];
  if constexpr (M == 4) {
    const int4 v = *reinterpret_cast<const int4*>(xw);
    xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) xv[m] = xw[m];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned t0 = __byte_perm(word(w[0], j), word(w[1], j), 0x5140);
    const unsigned t1 = __byte_perm(word(w[0], j), word(w[1], j), 0x7362);
    const unsigned t2 = __byte_perm(word(w[2], j), word(w[3], j), 0x5140);
    const unsigned t3 = __byte_perm(word(w[2], j), word(w[3], j), 0x7362);
    const int col[4] = {static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                        static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                        static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                        static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[m][4 * j + e] = __dp4a(col[e], xv[m], acc[m][4 * j + e]);
  }
}

// x's codes for quads q0.. as packed words, word i = (q, m) = (q0 + i /
// M, i % M) holding k-rows 4q..4q+3 of row m (a code past k meets a zero
// weight row). A thread takes its words kPrologue at a time and starts
// all their x loads before the first divide, so a long k-range costs one
// DRAM round trip per batch, not one per word.
template <int M>
__device__ __forceinline__ void quantize_range(int* xq, const void* x,
                                               int x_dtype, int k, int q0,
                                               int words, float sx) {
  for (int i0 = threadIdx.x; i0 < words; i0 += kPrologue * blockDim.x) {
    float v[kPrologue][4];
#pragma unroll
    for (int u = 0; u < kPrologue; ++u) {
      const int i = i0 + u * blockDim.x, q = q0 + i / M, m = i % M;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 4 * q + b;
        v[u][b] = i < words && r < k
                      ? load_f32(x, x_dtype, static_cast<long long>(m) * k + r)
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPrologue; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= words) break;
      unsigned packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float c = fminf(fmaxf(rintf(__fdiv_rn(v[u][b], sx)), -127.0f),
                              127.0f);
        packed |= (static_cast<unsigned>(static_cast<int>(c)) & 0xffu)
                  << (8 * b);
      }
      xq[i] = static_cast<int>(packed);
    }
  }
}

// the position of tile column c (0..16G) in a reduction row: each
// 16-column group's 4-word chunks are rotated by (g + g / 4) mod 4
__device__ __forceinline__ int red_pos(int c) {
  const int g = c >> 4, chunk = (c >> 2) & 3;
  return 16 * g + 4 * ((chunk + g + (g >> 2)) & 3) + (c & 3);
}

// sum of src[l * stride] over the k-lanes l < lanes
__device__ __forceinline__ int sum_lanes(const int* src, int lanes,
                                         int stride) {
  int s = 0;
  for (int l = 0; l < lanes; ++l) s += src[l * stride];
  return s;
}

template <int M, int kParts>
__global__ void __launch_bounds__(kMaxThreads, 2)
int8_gemv_kernel(const void* __restrict__ x, int x_dtype,
                 const int8_t* __restrict__ qw,
                 const void* __restrict__ ws, int ws_dtype,
                 const float* __restrict__ sx_ptr,
                 const void* __restrict__ bias, int bias_dtype,
                 void* __restrict__ out, int k, int n, int groups,
                 int cluster_size, int quads_per_cta) {
  namespace cg = cooperative_groups;
  extern __shared__ int4 smem4[];
  const int G = groups, tile_cols = 16 * G;
  const int tid = threadIdx.x, g = tid % G, kl = tid / G;
  const int lanes = blockDim.x / G;
  const int S = cluster_size, rank = blockIdx.x % S;
  const int n_clusters = gridDim.x / S;
  const int tiles = (n / 16 + G - 1) / G;
  const int quads = (k + 3) >> 2;
  const int q0 = rank * quads_per_cta;
  const int q1 = min(quads, q0 + quads_per_cta);
  const int rs = red_stride(M, G);
  int* xq = reinterpret_cast<int*>(smem4);           // [q1 - q0][M]
  int* red = xq + xq_words(M, quads_per_cta);        // [lanes][rs]
  int* part = red + lanes * rs;     // 2 x [S][per]: the cluster's partials
  // 2 x [ws, bias][tile_cols]: the tile's epilogue operands
  float* epi2 = reinterpret_cast<float*>(part + 2 * (M * tile_cols +
                                                     kMaxCluster));

  // the thread's items: tiles t0, t0 + n_clusters, ...; in each, quads
  // qa, qa + lanes, ... < q1. `nt`, `nq`: the next item to load.
  const int t0 = blockIdx.x / S, qa = q0 + kl;
  int nt = t0, nq = qa;
  uint4 cur[4];
  load_quad(cur, qw, k, n, nt * tile_cols + 16 * g, nq,
            qa < q1 && nt < tiles && nt * tile_cols + 16 * g < n);
  nq += lanes;
  if (nq >= q1) { nq = qa; nt += n_clusters; }
  // the first tile's epilogue operands, one column per thread (tid <
  // 16 G), stored to shared memory at the prologue's barrier
  float2 e = make_float2(0.f, 0.f);
  if (tid < tile_cols && t0 < tiles)
    e = load_epilogue(ws, ws_dtype, bias, bias_dtype, t0 * tile_cols + tid, n);
  const float sx = *sx_ptr;

  // prologue: this CTA's k-range of x as packed codes
  const int words = (q1 - q0) * M;
  if (kParts & kNoPrologue) {
    for (int i = tid; i < words; i += blockDim.x) xq[i] = 0x01010101;
  } else {
    quantize_range<M>(xq, x, x_dtype, k, q0, words, sx);
  }
  if (tid < tile_cols) {
    epi2[tid] = e.x;
    epi2[tile_cols + tid] = e.y;
  }
  __syncthreads();

  // the cluster partials and the epilogue operands alternate between two
  // buffers by tile, so a rank that starts the next tile early never
  // writes what this tile's epilogue still reads
  for (int tile = t0, parity = 0; tile < tiles;
       tile += n_clusters, parity ^= 1) {
    const int c0 = tile * tile_cols;
    float* epi = epi2 + parity * 2 * tile_cols;
    const int tn = tile + n_clusters;   // the next tile's operands
    if (tid < tile_cols && tn < tiles)
      e = load_epilogue(ws, ws_dtype, bias, bias_dtype, tn * tile_cols + tid,
                        n);
    int acc[M][16];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0;
    for (int q = qa; q < q1; q += lanes) {
      uint4 nxt[4];
      load_quad(nxt, qw, k, n, nt * tile_cols + 16 * g, nq,
                nt < tiles && nt * tile_cols + 16 * g < n);
      nq += lanes;
      if (nq >= q1) { nq = qa; nt += n_clusters; }
      mac_quad<M>(cur, xq + (q - q0) * M, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }

    if (kParts & kNoReduction) {   // timing variant: k-lane 0 stores its sums
      if (kl == 0 && c0 + 16 * g < n)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int c = 0; c < 16; ++c)
            store_out(out, x_dtype,
                      static_cast<long long>(m) * n + c0 + 16 * g + c,
                      __int2float_rn(acc[m][c]));
      continue;
    }

    // one pass of the sums into shared memory: 16-byte chunk j of group
    // g goes to slot (j + g + g / 4) mod 4 (red_pos)
    const int rot = g + (g >> 2);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int4*>(red + kl * rs + m * tile_cols + 16 * g +
                                 4 * ((j + rot) & 3)) =
            make_int4(acc[m][4 * j], acc[m][4 * j + 1], acc[m][4 * j + 2],
                      acc[m][4 * j + 3]);
    __syncthreads();
    // every thread is past the previous tile's epilogue, the last reader
    // of the other buffer
    if (tid < tile_cols && tn < tiles) {
      float* nxt_epi = epi2 + (parity ^ 1) * 2 * tile_cols;
      nxt_epi[tid] = e.x;
      nxt_epi[tile_cols + tid] = e.y;
    }

    const int outs = M * tile_cols;
    if (S == 1 || (kParts & kNoMerge)) {
      for (int o = tid; o < outs; o += blockDim.x) {
        const int m = o / tile_cols, c = o % tile_cols;
        epilogue(out, x_dtype, n, tile_cols, m, c0 + c, c,
                 sum_lanes(red + m * tile_cols + red_pos(c), lanes, rs), epi,
                 sx, bias != nullptr);
      }
      __syncthreads();   // red and epi are rewritten by the next tile
      continue;
    }
    // the cluster's merge: rank r owns the outputs [r per, (r + 1) per);
    // every rank stores its partial of them into the owner's slot for it,
    // and after one cluster barrier each owner adds its S slots in rank
    // order and runs the epilogue (the alternating buffers need no
    // second barrier: a slot of this parity is written again only after
    // the next tile's barrier, which the owner reaches after this
    // epilogue)
    cg::cluster_group cluster = cg::this_cluster();
    const int per = (outs + S - 1) / S;
    const int buf = parity * (outs + kMaxCluster);
    for (int o = tid; o < outs; o += blockDim.x) {
      const int m = o / tile_cols, c = o % tile_cols;
      cluster.map_shared_rank(part, o / per)[buf + rank * per + o % per] =
          sum_lanes(red + m * tile_cols + red_pos(c), lanes, rs);
    }
    cluster.sync();
    const int o_end = min(outs, (rank + 1) * per);
    for (int o = rank * per + tid; o < o_end; o += blockDim.x) {
      const int m = o / tile_cols, c = o % tile_cols;
      int s = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < S) s += part[buf + r * per + o % per];
      epilogue(out, x_dtype, n, tile_cols, m, c0 + c, c, s, epi, sx,
               bias != nullptr);
    }
  }
}

bool plan_ok(int m, int k, int n, const Plan& p) {
  const int quads = (k + 3) / 4;
  const int G = p.groups, S = p.cluster;
  return (G == 1 || G == 2 || G == kMaxGroups) && S >= 1 &&
         S <= kMaxCluster && p.quads_per_cta >= 1 &&
         static_cast<long long>(S) * p.quads_per_cta >= quads &&
         static_cast<long long>(S - 1) * p.quads_per_cta < quads &&
         p.threads >= 32 && p.threads <= kMaxThreads && p.threads % 32 == 0 &&
         p.threads >= 16 * G && p.grid >= S && p.grid % S == 0 &&
         smem_bytes(m, p) <= static_cast<size_t>(kSmemLimit);
}

template <int M, int kParts>
cudaError_t launch(const void* x, int x_dtype, const int8_t* qw,
                   const void* ws, int ws_dtype, const float* sx,
                   const void* bias, int bias_dtype, void* out, int k, int n,
                   const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(M, p);
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemv_kernel<M, kParts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    opted_in = kSmemLimit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemv_kernel<M, kParts>, x, x_dtype,
                            qw, ws, ws_dtype, sx, bias, bias_dtype, out, k,
                            n, p.groups, p.cluster, p.quads_per_cta);
}

cudaError_t launch_rows(int m, const void* x, int x_dtype, const int8_t* qw,
                        const void* ws, int ws_dtype, const float* sx,
                        const void* bias, int bias_dtype, void* out, int k,
                        int n, const Plan& p, cudaStream_t st) {
  switch (m) {
    case 1: return launch<1, kAll>(x, x_dtype, qw, ws, ws_dtype, sx, bias,
                                   bias_dtype, out, k, n, p, st);
    case 2: return launch<2, kAll>(x, x_dtype, qw, ws, ws_dtype, sx, bias,
                                   bias_dtype, out, k, n, p, st);
    case 3: return launch<3, kAll>(x, x_dtype, qw, ws, ws_dtype, sx, bias,
                                   bias_dtype, out, k, n, p, st);
    default: return launch<4, kAll>(x, x_dtype, qw, ws, ws_dtype, sx, bias,
                                    bias_dtype, out, k, n, p, st);
  }
}

}  // namespace

extern "C" {

// x (m, k) fp32/bf16, qw (k, n) int8 row-major, ws (n,) fp32/bf16, sx one
// fp32 on the device, bias (n,) fp32/bf16 or null, out (m, n) in x's
// dtype. m in [1, 4]; n a multiple of 16; qw 16-byte aligned; the plan
// (groups, cluster, quads_per_cta, threads, grid) from the wrapper's
// `launch_plan`. `parts` 0 is the kernel; a timing variant otherwise
// (kNoPrologue, kNoReduction, both, or kNoMerge; its output is not the
// function).
// Returns a cudaError_t (0 on success).
int int8_linear_launch(const void* x, const void* qw, const void* ws,
                       const void* sx, const void* bias, void* out, int m,
                       int k, int n, int x_dtype, int ws_dtype,
                       int bias_dtype, int groups, int cluster,
                       int quads_per_cta, int threads, int grid, int parts,
                       void* stream) {
  const Plan p{groups, cluster, quads_per_cta, threads, grid};
  if (m < 1 || m > kMaxRows || k < 1 || n < 16 || n % 16 ||
      !plan_ok(m, k, n, p) || (parts && m != kMaxRows) ||
      reinterpret_cast<uintptr_t>(qw) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* q = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case kAll:
      return launch_rows(m, x, x_dtype, q, ws, ws_dtype, s, bias,
                         bias_dtype, out, k, n, p, st);
    case kNoPrologue:
      return launch<4, kNoPrologue>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                    bias_dtype, out, k, n, p, st);
    case kNoReduction:
      return launch<4, kNoReduction>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                     bias_dtype, out, k, n, p, st);
    case kNoMerge:
      return launch<4, kNoMerge>(x, x_dtype, q, ws, ws_dtype, s, bias,
                                 bias_dtype, out, k, n, p, st);
    case kNoPrologue | kNoReduction:
      return launch<4, kNoPrologue | kNoReduction>(
          x, x_dtype, q, ws, ws_dtype, s, bias, bias_dtype, out, k, n, p,
          st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
