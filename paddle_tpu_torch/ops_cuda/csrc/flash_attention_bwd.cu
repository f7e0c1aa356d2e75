// Flash-attention backward for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the TPU kernel `_bwd_merged_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_backward_flat`. Same function: with the
// forward's fp32 logsumexp it recomputes p = exp(s - lse) (s scaled in
// fp32, -1e30 where the bottom-right causal rule hides a key) and emits
//   dv = bf16(p)^T g,   dp = g v^T,   ds = bf16(p * (dp - delta) * scale),
//   dk = ds^T q,        dq = ds k,
// every product on bf16 operands with fp32 accumulation, every gradient
// stored in bf16. delta = rowsum(out * g) in fp32 comes from the caller,
// as in the TPU version.
//
// The design choice. The TPU kernel walks key tiles in order on one core
// and keeps one fp32 dq block resident across the sweep. CTAs on an H100
// run concurrently in no order, so that cannot carry over. Of the two
// ways out, fp32 atomicAdd of dq partials into a zeroed buffer, or a
// second kernel that recomputes p for dq, this file takes the second:
//   - `flash_bwd_dkdv_kernel`, one CTA per (key tile, batch * head),
//     sweeps the query tiles that can see its keys and keeps dk and dv
//     in registers;
//   - `flash_bwd_dq_kernel`, one CTA per (query tile, batch * head),
//     sweeps the key tiles its rows can see and keeps dq in registers.
// Both are deterministic: every gradient element is summed by one thread
// in one order, so two runs give the same bits. The price is the second
// recomputation of s and p and the second dp product: 7 products per
// live tile pair instead of 5, and K, V, q, g read twice.
//
// Bound on an H100 SXM at the training shape (b 18, h 12, s 1024, d 64,
// causal): the 5 products of the merged function, 5 x 2 s^2 d flops per
// head halved by the mask, 72.5 GFLOP over 989 TFLOP/s = 0.073 ms;
// q, k, v, out, g read and dq, dk, dv written once, 227 MB over
// 3.35 TB/s = 0.068 ms. The bound is the operations.
//
// What the design does about it: each warp owns 16 rows (keys in the
// dk/dv kernel, queries in the dq kernel) for the whole sweep, so all
// accumulators stay in registers and the warps never exchange data; all
// products run on the tensor cores through mma.sync; the tiles that the
// sweep reads are double-buffered in shared memory with 16-byte
// cp.async; p and ds go from the score accumulators straight into A
// fragments without touching shared memory. Under the causal rule each
// sweep visits only the live tiles:
//   dk/dv: the first query tile that sees any key of key tile [k0, k0+BK)
//          is floor((k0 - off) / BQ), a FLOOR: its later rows see the
//          tile's first keys even when its first row does not (a ceiling
//          here would drop those gradients when BQ != BK);
//   dq:    the last key tile is the one holding key q_last + off.
// Inputs are read through (batch, seq, head) strides, so the fused qkv
// projection needs no flatten copies.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

struct Args {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta;  // (b, h, sq) fp32, contiguous
  bf16 *dq, *dk, *dv;
  int nh, sq, sk, causal;
  float scale;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
};

// Tile sizes. The warp dimension is always 4 x 16 rows; the swept tile
// shrinks for d = 128 to keep the accumulators in registers.
template <int D>
struct Tiles {
  static constexpr int kRows = 64;                // rows a CTA owns
  static constexpr int kSweep = D <= 64 ? 64 : 32;  // rows a step reads
};

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (key tile, batch * head)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int BK = Tiles<D>::kRows;
  constexpr int BQ = Tiles<D>::kSweep;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* sV = sK + BK * LD;                       // BK x LD
  bf16* sQ = sV + BK * LD;                       // 2 stages x BQ x LD
  bf16* sG = sQ + 2 * BQ * LD;                   // 2 stages x BQ x LD
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ * LD);  // 2 x BQ
  float* sD = sL + 2 * BQ;                                 // 2 x BQ

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.nh, h = bh % a.nh;
  const int sq = a.sq, sk = a.sk, off = sk - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* gb = a.g + b * a.gs.b + h * a.gs.h;
  const float* lb = a.lse + (long long)bh * sq;
  const float* db = a.delta + (long long)bh * sq;

  const int nqt = (sq + BQ - 1) / BQ;
  // first query tile with any row that sees key k0 (floor; see the note).
  // qt0 < nqt: k0 < sk, so k0 - off < sq (the last query sees every key)
  const int qt0 = a.causal ? max(k0 - off, 0) / BQ : 0;

  load_tile<BK, D>(sK, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, k0, sk);
  load_tile<BK, D>(sV, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, k0, sk);
  load_tile<BQ, D>(sQ, qb, a.qs.s, qt0 * BQ, sq);
  load_tile<BQ, D>(sG, gb, a.gs.s, qt0 * BQ, sq);
  load_vec(sL, lb, qt0 * BQ, BQ, sq);
  load_vec(sD, db, qt0 * BQ, BQ, sq);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: +0 and +8

  for (int qt = qt0; qt < nqt; ++qt) {
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < nqt) {
      const int n0 = (qt + 1) * BQ;
      load_tile<BQ, D>(sQ + (stage ^ 1) * BQ * LD, qb, a.qs.s, n0, sq);
      load_tile<BQ, D>(sG + (stage ^ 1) * BQ * LD, gb, a.gs.s, n0, sq);
      load_vec(sL + (stage ^ 1) * BQ, lb, n0, BQ, sq);
      load_vec(sD + (stage ^ 1) * BQ, db, n0, BQ, sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQs = sQ + stage * BQ * LD;
    const bf16* sGs = sG + stage * BQ * LD;
    const float* sLs = sL + stage * BQ;
    const float* sDs = sD + stage * BQ;
    const int q0 = qt * BQ;

    // s^T = k q^T and dp^T = v g^T for this warp's 16 keys
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, LD, warp * 16, kk * 16, lane);
      load_a(va, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        uint32_t bq[4], bg[4];
        load_b_rows(bq, sQs, LD, n2 * 16, kk * 16, lane);
        load_b_rows(bg, sGs, LD, n2 * 16, kk * 16, lane);
        mma16816(st[2 * n2], ka, bq[0], bq[1]);
        mma16816(st[2 * n2 + 1], ka, bq[2], bq[3]);
        mma16816(dpt[2 * n2], va, bg[0], bg[1]);
        mma16816(dpt[2 * n2 + 1], va, bg[2], bg[3]);
      }
    }

    // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta) scale
    const bool need_mask = q0 + BQ > sq ||
                           (a.causal && q0 + off < k0 + BK - 1);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + 2 * t + (i & 1);  // query column in tile
        float x = st[n][i] * a.scale;
        if (need_mask) {
          const int key = key_a + (i >> 1) * 8;
          if (q0 + qc >= sq || (a.causal && !causal_keep(q0 + qc, key, off)))
            x = kNegInf;
        }
        const float p = expf(x - sLs[qc]);
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - sDs[qc]) * a.scale;
      }
    }

    // dv += bf16(p)^T g and dk += bf16(ds)^T q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t bg[4], bq[4];
        load_b_cols(bg, sGs, LD, kk * 16, d2 * 16, lane);
        load_b_cols(bq, sQs, LD, kk * 16, d2 * 16, lane);
        mma16816(dv[2 * d2], pa, bg[0], bg[1]);
        mma16816(dv[2 * d2 + 1], pa, bg[2], bg[3]);
        mma16816(dk[2 * d2], sa, bq[0], bq[1]);
        mma16816(dk[2 * d2 + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + r * 8;
    if (key < sk) {
      bf16* dkr = a.dk + b * a.dks.b + (long long)key * a.dks.s + h * a.dks.h;
      bf16* dvr = a.dv + b * a.dvs.b + (long long)key * a.dvs.s + h * a.dvs.h;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + n * 8 + 2 * t) =
            pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + n * 8 + 2 * t) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (query tile, batch * head)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int BQ = Tiles<D>::kRows;
  constexpr int BK = Tiles<D>::kSweep;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* sG = sQ + BQ * LD;                       // BQ x LD
  bf16* sK = sG + BQ * LD;                       // 2 stages x BK x LD
  bf16* sV = sK + 2 * BK * LD;                   // 2 stages x BK x LD

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.nh, h = bh % a.nh;
  const int sq = a.sq, sk = a.sk, off = sk - sq;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;

  int nkt = (sk + BK - 1) / BK;
  if (a.causal) {
    const int last_q = min(q0 + BQ, sq) - 1 + off;
    nkt = min(nkt, last_q / BK + 1);
  }

  load_tile<BQ, D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, sq);
  load_tile<BQ, D>(sG, a.g + b * a.gs.b + h * a.gs.h, a.gs.s, q0, sq);
  load_tile<BK, D>(sK, kb, a.ks.s, 0, sk);
  load_tile<BK, D>(sV, vb, a.vs.s, 0, sk);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g;  // this thread's rows: +0 and +8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row_a + r * 8, sq - 1);
    lse_r[r] = a.lse[(long long)bh * sq + row];
    delta_r[r] = a.delta[(long long)bh * sq + row];
  }

  uint32_t qf[D / 16][4], gf[D / 16][4];
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nkt) {
      load_tile<BK, D>(sK + (stage ^ 1) * BK * LD, kb, a.ks.s,
                       (kt + 1) * BK, sk);
      load_tile<BK, D>(sV + (stage ^ 1) * BK * LD, vb, a.vs.s,
                       (kt + 1) * BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);
        load_a(gf[kk], sG, LD, warp * 16, kk * 16, lane);
      }
    }
    const bf16* sKs = sK + stage * BK * LD;
    const bf16* sVs = sV + stage * BK * LD;

    // s = q k^T and dp = g v^T over this key tile
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t bk[4], bv[4];
        load_b_rows(bk, sKs, LD, n2 * 16, kk * 16, lane);
        load_b_rows(bv, sVs, LD, n2 * 16, kk * 16, lane);
        mma16816(s[2 * n2], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
        mma16816(dp[2 * n2], gf[kk], bv[0], bv[1]);
        mma16816(dp[2 * n2 + 1], gf[kk], bv[2], bv[3]);
      }
    }

    // ds = exp(s * scale - lse) (dp - delta) scale
    const int k0 = kt * BK;
    const bool need_mask =
        k0 + BK > sk || (a.causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * a.scale;
        if (need_mask) {
          const int row = row_a + (i >> 1) * 8;
          const int col = k0 + n * 8 + 2 * t + (i & 1);
          if (col >= sk || (a.causal && !causal_keep(row, col, off)))
            x = kNegInf;
        }
        const float p = expf(x - lse_r[i >> 1]);
        s[n][i] = p * (dp[n][i] - delta_r[i >> 1]) * a.scale;
      }
    }

    // dq += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t bk[4];
        load_b_cols(bk, sKs, LD, kk * 16, d2 * 16, lane);
        mma16816(dq[2 * d2], sa, bk[0], bk[1]);
        mma16816(dq[2 * d2 + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row < sq) {
      bf16* dqr = a.dq + b * a.dqs.b + (long long)row * a.dqs.s + h * a.dqs.h;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqr + n * 8 + 2 * t) =
            pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr int R = Tiles<D>::kRows, S = Tiles<D>::kSweep;
  constexpr int smem_dkdv =
      (2 * R + 4 * S) * LD * sizeof(bf16) + 4 * S * sizeof(float);
  constexpr int smem_dq = (2 * R + 4 * S) * LD * sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_dq);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_k((a.sk + R - 1) / R, batch * a.nh);
  flash_bwd_dkdv_kernel<D><<<grid_k, kThreads, smem_dkdv, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.sq + R - 1) / R, batch * a.nh);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_dq, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. q, g, dq (b, sq, h, d), k, v, dk, dv (b, sk, h, d),
// all bf16 with a contiguous head dim and the given element strides;
// lse and delta (b, h, sq) fp32 contiguous. Launches both kernels on
// `stream` without synchronising; returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int flash_bwd_launch(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int nh, int sq, int sk, int d, const long long* strides,
    int causal, float scale, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 || batch * nh > 65535 ||
      (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  // strides: (b, s, h) for q, k, v, g, dq, dk, dv in that order
  const long long* st = strides;
  Args a{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
         static_cast<const bf16*>(v),   static_cast<const bf16*>(g),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<bf16*>(dq),        static_cast<bf16*>(dk),
         static_cast<bf16*>(dv),        nh, sq, sk, causal, scale,
         {st[0], st[1], st[2]},         {st[3], st[4], st[5]},
         {st[6], st[7], st[8]},         {st[9], st[10], st[11]},
         {st[12], st[13], st[14]},      {st[15], st[16], st[17]},
         {st[18], st[19], st[20]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(a, batch, s);
  else if (d == 128)
    err = launch<128>(a, batch, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
