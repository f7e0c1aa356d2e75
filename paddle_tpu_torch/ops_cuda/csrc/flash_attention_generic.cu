// Flash attention for the inputs K2/K3's wgmma kernels do not take: fp32
// at head dim 32, 64 or 128, and bf16 at head dim 32 (sm_90a).
//
// Replaces, for those inputs, the same TPU kernels as K2 and K3:
// `_fwd_kernel` and `_bwd_merged_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py (launched there through
// pl.pallas_call by `_flash_forward_flat` / `_flash_backward_flat`), with
// the fp32 delta = rowsum(out * g) pass of `_flash_backward_flat`. Those
// run their products in the input dtype, so an fp32 model takes them in
// fp32. The functions are the plain versions' (`flash_forward_plain`,
// `flash_backward_plain`, `flash_delta_plain`):
//   forward:  s = (q . k) scale, the bottom-right causal rule masking with
//             -1e30, p = exp(s - m) in fp32 (online over key tiles), p
//             rounded to v's dtype before p . v, out = acc / l (l == 0 ->
//             1), lse = m + log l in the natural log;
//   backward: p = exp(s - lse), dv = T(p)^T g, dp = g v^T,
//             ds = T(p (dp - delta) scale), dq = ds k, dk = ds^T q,
//             with T the input type;
// every product of exact operand values, summed in fp32. Rows with no
// visible key (causal sq > sk) follow the reference: out = mean of v,
// lse = -1e30, p = 1 / sk on every key and ds = 0 in the backward.
//
// Bound on an H100 SXM: the same bytes and products as K2/K3 (the
// operations over the 67 TFLOP/s fp32 rate, not the tensor cores, since
// every product is an FFMA here). Why no tensor cores: TF32 (wgmma or
// mma.sync) rounds fp32 operands to 10 mantissa bits, which cannot hold
// the plain fp32 version at 1e-5, and TF32 wgmma takes both operands
// K-major while P . V's B operand is MN-major.
//
// Design, simple first: a CTA of 256 threads (16 x 16) owns one 64-row
// tile of one (batch, head) and sweeps 64-row tiles of the other side.
// Tiles sit in shared memory as fp32 rows padded to D + 1 columns, so a
// thread's column reads fall in distinct banks; each thread keeps a 4 x 4
// block of the 64 x 64 scores (rows ty + 16 i, columns tx + 16 j) and a
// 4 x D/16 block of the 64 x D accumulators in registers. The score
// rows' max and sum reduce over the 16 threads of a row with shuffles.
//   forward:  Q resident; K, V swept; P through shared memory into P . V.
//   dk/dv:    K, V resident; Q, G swept (every query tile that sees the
//             keys; every tile when causal sq > sk), lse and delta rows
//             beside them; P^T and dS^T through shared memory.
//   dq:       Q, G resident; K, V swept; dS through shared memory.
//   delta:    one warp per row.
// Every gradient element is summed by one thread in one fixed order, so
// two runs give the same bits. Work items go heaviest first; the grid's
// x extent is tiles x batch x heads, so batch x heads has no 65535 limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// lse_rows, indices_fit and neg_inf: the (b, h, lse_rows(sq)) lse and
// delta buffers and their 32-bit limit are K2/K3's
#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::indices_fit;
using flash::lse_rows;
using flash::neg_inf;

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr int kTile = 64;          // rows of a query or key tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kP = kTile + 1;      // padded row of a 64 x 64 score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and widened back (the plain versions' `.to(v.dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

struct Params {
  int nh, sq, sk, causal;
  int nbh;         // batch * heads
  float scale;
  float inv_sk;    // 1 / sk: an empty row's p
};

// rows [r0, r0 + 64) of one (batch, head) of a (b, s, h, d) tensor into a
// padded fp32 tile, 0 past `n` rows
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    tile[r * (D + 1) + c] =
        r0 + r < n ? to_f(base[(long long)(r0 + r) * row_stride + c]) : 0.f;
  }
}

// acc[i][j] = sum_k A[ty + 16 i][k] * B[tx + 16 j][k] over D columns of
// two padded tiles
template <int D>
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n P[ty + 16 i][n] * B[n][tx + 16 j] over the 64 rows
// of a padded score tile P and a padded D-column tile B
template <int D>
__device__ __forceinline__ void mm_ab(float (&acc)[4][D / 16],
                                      const float* pt, const float* b,
                                      int ty, int tx) {
#pragma unroll 4
  for (int n = 0; n < kTile; ++n) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = pt[(ty + 16 * i) * kP + n];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[n * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// store a 4 x D/16 accumulator block as rows r0 + ty + 16 i of one
// (batch, head) of a (b, s, h, d) tensor, rows at or past n skipped
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           const float (&acc)[4][D / 16],
                                           int r0, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      base[(long long)r * row_stride + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// sum or max over the 16 threads that hold one score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ bool causal_keep(int q, int j, int off) {
  return q + off >= j;
}

// key tiles that query rows [first, last] see: all when one of them sees
// none (causal sq > sk: such a row takes the mean of every v)
__device__ __forceinline__ int fwd_tiles(const Params& p, int first,
                                         int last) {
  const int all = (p.sk + kTile - 1) / kTile;
  const int off = p.sk - p.sq;
  if (!p.causal || first + off < 0) return all;
  return min(all, (last + off) / kTile + 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_generic_fwd(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                  Strides os, Params p) {
  extern __shared__ float smem[];
  float* sq_t = smem;                       // Q tile
  float* sk_t = sq_t + kTile * (D + 1);     // K tile
  float* sv_t = sk_t + kTile * (D + 1);     // V tile
  float* sp = sv_t + kTile * (D + 1);       // P, rounded to T
  const int ntq = (p.sq + kTile - 1) / kTile;
  const int rank = blockIdx.x / p.nbh, bh = blockIdx.x % p.nbh;
  const int q0 = (ntq - 1 - rank) * kTile;  // the last tiles first
  const int b = bh / p.nh, h = bh % p.nh, off = p.sk - p.sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D>(sq_t, q + b * qs.b + h * qs.h, qs.s, q0, p.sq);
  const int nkt = fwd_tiles(p, q0, min(q0 + kTile, p.sq) - 1);

  float o[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[i][j] = 0.f;
  }
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's P . V has read sk_t, sv_t, sp
    load_tile<T, D>(sk_t, kb, ks.s, k0, p.sk);
    load_tile<T, D>(sv_t, vb, vs.s, k0, p.sk);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(s, sq_t, sk_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const bool empty = p.causal && row + off < 0;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep =
            col < p.sk && (!p.causal || causal_keep(row, col, off));
        // an empty row scores 0 on each key and -inf past sk: p = 1 on
        // each of the sk keys, as the reference's equal -1e30 scores give
        s[i][j] = empty ? (col < p.sk ? 0.f : neg_inf())
                        : (keep ? s[i][j] * p.scale : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        ls += pe;
        sp[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(pe);
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<D>(o, sp, sv_t, ty, tx);
  }

  // normalise, write out and the natural-log logsumexp
  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float lt = row_sum(l[i]);
    const float l_safe = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[i][j] = o[i][j] / l_safe;
    if (tx == 0 && row < p.sq)
      lse[(long long)bh * lse_rows(p.sq) + row] =
          p.causal && row + off < 0 ? kNegInf : m[i] + logf(l_safe);
  }
  store_rows<T, D>(ob, os.s, o, q0, p.sq, ty, tx);
}

// ---------------------------------------------------------------------------
// backward: delta = rowsum(out * g) in fp32, one warp per row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_generic_delta(const T* __restrict__ out, const T* __restrict__ g,
                    float* __restrict__ delta, Strides os, Strides gs,
                    int nh, int sq, int rows) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp
  const int s = r % sq, bh = r / sq, b = bh / nh, h = bh % nh;
  const T* orow = out + b * os.b + s * os.s + h * os.h;
  const T* grow = g + b * gs.b + s * gs.s + h * gs.h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(orow[c]), to_f(grow[c]),
                                                acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[(long long)bh * lse_rows(sq) + s] = acc;
}

// ---------------------------------------------------------------------------
// backward: dk, dv for one key tile, sweeping the query tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_generic_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                   Strides gs, Strides dks, Strides dvs, Params p) {
  extern __shared__ float smem[];
  float* sk_t = smem;
  float* sv_t = sk_t + kTile * (D + 1);
  float* sq_t = sv_t + kTile * (D + 1);
  float* sg_t = sq_t + kTile * (D + 1);
  float* spt = sg_t + kTile * (D + 1);      // P^T, rounded to T
  float* sdst = spt + kTile * kP;           // dS^T, rounded to T
  float* slse = sdst + kTile * kP;
  float* sdelta = slse + kTile;
  const int rank = blockIdx.x / p.nbh, bh = blockIdx.x % p.nbh;
  const int k0 = rank * kTile;  // the first keys, seen by most rows, first
  const int b = bh / p.nh, h = bh % p.nh, off = p.sk - p.sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ntq = (p.sq + kTile - 1) / kTile;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const float* lrow = lse + (long long)bh * lse_rows(p.sq);
  const float* drow = delta + (long long)bh * lse_rows(p.sq);
  load_tile<T, D>(sk_t, k + b * ks.b + h * ks.h, ks.s, k0, p.sk);
  load_tile<T, D>(sv_t, v + b * vs.b + h * vs.h, vs.s, k0, p.sk);
  // the first query tile that sees key k0; every tile when causal sq > sk
  // (the empty rows add g / sk to every key's dv)
  const int qt0 = p.causal && off >= 0 ? max(k0 - off, 0) / kTile : 0;

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dka[i][j] = dva[i][j] = 0.f;
  for (int qt = qt0; qt < ntq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's products have read the tiles
    load_tile<T, D>(sq_t, qb, qs.s, q0, p.sq);
    load_tile<T, D>(sg_t, gb, gs.s, q0, p.sq);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      slse[threadIdx.x] = r < p.sq ? lrow[r] : 0.f;
      sdelta[threadIdx.x] = r < p.sq ? drow[r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    mm_abt<D>(st, sk_t, sq_t, ty, tx);   // S^T: keys x queries
    mm_abt<D>(dpt, sv_t, sg_t, ty, tx);  // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, qr = q0 + qc;
        const bool empty = p.causal && qr + off < 0;
        const bool keep = qr < p.sq && key < p.sk &&
                          (!p.causal || causal_keep(qr, key, off));
        float pv = keep ? expf(st[i][j] * p.scale - slse[qc]) : 0.f;
        pv = empty ? (key < p.sk ? p.inv_sk : 0.f) : pv;
        const float ds =
            empty ? 0.f : pv * (dpt[i][j] - sdelta[qc]) * p.scale;
        spt[(ty + 16 * i) * kP + qc] = round_to<T>(pv);
        sdst[(ty + 16 * i) * kP + qc] = round_to<T>(ds);
      }
    }
    __syncthreads();
    mm_ab<D>(dva, spt, sg_t, ty, tx);
    mm_ab<D>(dka, sdst, sq_t, ty, tx);
  }
  store_rows<T, D>(dk + b * dks.b + h * dks.h, dks.s, dka, k0, p.sk, ty, tx);
  store_rows<T, D>(dv + b * dvs.b + h * dvs.h, dvs.s, dva, k0, p.sk, ty, tx);
}

// ---------------------------------------------------------------------------
// backward: dq for one query tile, sweeping the key tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_generic_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs,
                 Params p) {
  extern __shared__ float smem[];
  float* sq_t = smem;
  float* sg_t = sq_t + kTile * (D + 1);
  float* sk_t = sg_t + kTile * (D + 1);
  float* sv_t = sk_t + kTile * (D + 1);
  float* sds = sv_t + kTile * (D + 1);      // dS, rounded to T
  const int ntq = (p.sq + kTile - 1) / kTile;
  const int rank = blockIdx.x / p.nbh, bh = blockIdx.x % p.nbh;
  const int q0 = (ntq - 1 - rank) * kTile;
  const int b = bh / p.nh, h = bh % p.nh, off = p.sk - p.sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D>(sq_t, q + b * qs.b + h * qs.h, qs.s, q0, p.sq);
  load_tile<T, D>(sg_t, g + b * gs.b + h * gs.h, gs.s, q0, p.sq);
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < p.sq ? lse[(long long)bh * lse_rows(p.sq) + r] : 0.f;
    dr[i] = r < p.sq ? delta[(long long)bh * lse_rows(p.sq) + r] : 0.f;
  }
  // key tiles the tile's rows see; none when its last row sees no key
  const int last = min(q0 + kTile, p.sq) - 1;
  const int all = (p.sk + kTile - 1) / kTile;
  const int nkt = !p.causal       ? all
                  : last + off < 0 ? 0
                                   : min(all, (last + off) / kTile + 1);

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqa[i][j] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(sk_t, kb, ks.s, k0, p.sk);
    load_tile<T, D>(sv_t, vb, vs.s, k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt<D>(s, sq_t, sk_t, ty, tx);
    mm_abt<D>(dp, sg_t, sv_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        // an empty row (row + off < 0) keeps no key: p = 0, ds = 0
        const bool keep =
            col < p.sk && (!p.causal || causal_keep(row, col, off));
        const float pv = keep ? expf(s[i][j] * p.scale - lr[i]) : 0.f;
        sds[(ty + 16 * i) * kP + tx + 16 * j] =
            round_to<T>(pv * (dp[i][j] - dr[i]) * p.scale);
      }
    }
    __syncthreads();
    mm_ab<D>(dqa, sds, sk_t, ty, tx);
  }
  store_rows<T, D>(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, q0, p.sq, ty, tx);
}

template <int D>
constexpr int smem_fwd() {
  return (3 * kTile * (D + 1) + kTile * kP) * 4;
}
template <int D>
constexpr int smem_dkdv() {
  return (4 * kTile * (D + 1) + 2 * kTile * kP + 2 * kTile) * 4;
}
template <int D>
constexpr int smem_dq() {
  return (4 * kTile * (D + 1) + kTile * kP) * 4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const Strides* st, const Params& p,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = set_smem(flash_generic_fwd<T, D>, smem_fwd<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // grid x: 64-row tiles x batch x heads, below 2^31 by indices_fit
  const int ntq = (p.sq + kTile - 1) / kTile;
  flash_generic_fwd<T, D><<<ntq * p.nbh, kThreads, smem_fwd<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), st[0], st[1], st[2], st[3], p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* g, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const Strides* st, const Params& p,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = set_smem(flash_generic_dkdv<T, D>, smem_dkdv<D>());
    if (err == cudaSuccess)
      err = set_smem(flash_generic_dq<T, D>, smem_dq<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int ntq = (p.sq + kTile - 1) / kTile;
  const int ntk = (p.sk + kTile - 1) / kTile;
  // st: q, k, v, out, g, dq, dk, dv
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const int rows = p.nbh * p.sq;
  const int per_block = kThreads / 32;
  flash_generic_delta<T, D>
      <<<(rows + per_block - 1) / per_block, kThreads, 0, stream>>>(
          static_cast<const T*>(out), tg, fd, st[3], st[4], p.nh, p.sq,
          rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_generic_dkdv<T, D><<<ntk * p.nbh, kThreads, smem_dkdv<D>(), stream>>>(
      tq, tk, tv, tg, fl, fd, static_cast<T*>(dk), static_cast<T*>(dv), st[0],
      st[1], st[2], st[4], st[6], st[7], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_generic_dq<T, D><<<ntq * p.nbh, kThreads, smem_dq<D>(), stream>>>(
      tq, tk, tv, tg, fl, fd, static_cast<T*>(dq), st[0], st[1], st[2], st[4],
      st[5], p);
  return cudaGetLastError();
}

}  // namespace

// The instantiations: float32 (dtype 0) at d 32, 64, 128 and bfloat16
// (dtype 1) at d 32; bfloat16 at d 64 and 128 goes to K2/K3.
#define GENERIC_DISPATCH(CALL)                          \
  do {                                                  \
    if (dtype == 0 && d == 32) return CALL(float, 32);  \
    if (dtype == 0 && d == 64) return CALL(float, 64);  \
    if (dtype == 0 && d == 128) return CALL(float, 128); \
    if (dtype == 1 && d == 32) return CALL(bf16, 32);   \
    return static_cast<int>(cudaErrorInvalidValue);     \
  } while (0)

// C entries for ctypes. q, out (b, sq, h, d), k, v (b, sk, h, d) of one
// dtype (GENERIC_DISPATCH) with a contiguous head dim and the given
// element strides (b, s, h of q, k, v, out); lse (b, h, lse_rows(sq))
// fp32 contiguous (rows past sq left as they are). Launch on `stream`
// without synchronising; return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or type the kernels do not take).
extern "C" int flash_generic_fwd_launch(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int batch, int nh, int sq, int sk,
                                        int d, int dtype,
                                        const long long* strides, int causal,
                                        float scale, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Params p{nh, sq, sk, causal, batch * nh, scale, 1.f / sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) static_cast<int>(fwd<T, D>(q, k, v, out, lse, st, p, s))
  GENERIC_DISPATCH(CALL);
#undef CALL
}

// The backward: q, out, g, dq (b, sq, h, d), k, v, dk, dv (b, sk, h, d)
// with the strides (b, s, h) of q, k, v, out, g, dq, dk, dv in that order;
// lse as the forward writes it; `delta` (b, h, lse_rows(sq)) fp32 scratch
// that the delta kernel fills for the dk/dv and dq kernels. Three kernels
// in order on `stream`.
extern "C" int flash_generic_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int nh, int sq, int sk, int d, int dtype,
    const long long* strides, int causal, float scale, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Params p{nh, sq, sk, causal, batch * nh, scale, 1.f / sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D)                                                           \
  static_cast<int>(                                                          \
      bwd<T, D>(q, k, v, out, g, lse, delta, dq, dk, dv, st, p, s))
  GENERIC_DISPATCH(CALL);
#undef CALL
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
