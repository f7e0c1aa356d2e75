// Flash-attention backward for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the TPU kernel `_bwd_merged_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_backward_flat`, together with the fp32
// delta = rowsum(out * g) pass that `_flash_backward_flat` runs before
// it. Same function: with the forward's fp32 logsumexp it recomputes
// p = exp(s - lse) (s scaled in fp32, masked where the bottom-right
// causal rule hides a key) and emits
//   dv = bf16(p)^T g,   dp = g v^T,   ds = bf16(p * (dp - delta) * scale),
//   dk = ds^T q,        dq = ds k,
// every product on bf16 operands with fp32 accumulation, every gradient
// stored in bf16.
//
// Three kernels, launched in order on one stream:
//   - `flash_bwd_delta_kernel`: delta = rowsum(out * g) in fp32, out and
//     g read once in bf16 with 16-byte loads, d / 8 lanes per row; it
//     also writes lse log2 e beside delta for the other two;
//   - `flash_bwd_dkdv_kernel`: work items of (128 keys, batch * head);
//     an item sweeps the query tiles that can see its keys and keeps dk
//     and dv in registers;
//   - `flash_bwd_dq_kernel`: work items of (128 queries, batch * head);
//     an item sweeps the key tiles its rows can see and keeps dq in
//     registers.
// The TPU kernel keeps one fp32 dq block resident across a sequential
// sweep of key tiles; CTAs on an H100 run concurrently in no order, so
// dq gets its own kernel instead of atomics. Every gradient element is
// summed by one thread in one fixed order, so two runs give the same
// bits. The price is the second recomputation of s and p and the second
// dp product: 7 products per live tile pair instead of 5.
//
// Bound on an H100 SXM at the training shape (b 18, h 12, s 1024, d 64,
// causal): the 5 products of the merged function, 5 x 2 s^2 d flops per
// head halved by the mask, 72.5 GFLOP over 989 TFLOP/s = 0.073 ms
// (the 7 products run here: 0.103 ms); q, k, v, out, g read and dq, dk,
// dv written once, 227 MB over 3.35 TB/s = 0.068 ms. The bound is the
// operations.
//
// What the design does about it: every product is a wgmma. Both sweep
// kernels are persistent (one CTA per SM walking its work items, the
// longest first) with two consumer warpgroups of 64 rows (keys in dk/dv,
// queries in dq) and a producer warp; `setmaxnreg` moves the producer's
// registers to the consumers. The tiles an item owns (K and V, or Q and
// G) come once by TMA into one of two resident slots, so the next item's
// load overlaps this one's sweep; the swept tiles stream through TMA
// into a ring of kStages buffers with full/empty mbarriers.
//   dk/dv: S^T = K Q^T and dP^T = V G^T shared x shared; P^T and dS^T
//          repack in registers into bf16 A fragments; dV += P^T G and
//          dK += dS^T Q register x shared, G and Q through MN-major
//          descriptors. The tile's delta and lse log2 e rows come by
//          bulk copy on the same barrier as its Q and G tiles.
//   dq:    S = Q K^T and dP = G V^T shared x shared; dQ += dS K register
//          x shared, K through an MN-major descriptor.
// The products of tile i - 1 that write dk, dv or dq run while tile i's
// S and dP are issued, and p is computed while dP is in flight.
// p = exp2(s * scale log2 e - lse log2 e), one FFMA into exp2, and ds is
// stored as p (dp - delta) with the scale applied to dk and dq once at
// the end (for d = 64 the scale is 1/8, so the bf16 ds is the same
// number). Under the causal rule each warpgroup visits only its live
// tiles:
//   dk/dv: the first query tile that sees any key of [k0, k0 + 64) is
//          floor((k0 - off) / BQ), a FLOOR: its later rows see the
//          tile's first keys even when its first row does not;
//   dq:    the last key tile is the one holding key q_last + off.
// Only tiles that cross the diagonal or a ragged end are masked, and a
// masked p and ds are exactly 0 (TMA zero-fills rows past sq and sk).
// Causal sq > sk leaves the first sq - sk query rows with no visible key;
// as in the reference (`jax.grad` of its uniform softmax) such a row has
// p = 1 / sk on every key and ds = 0: the dk/dv kernel then sweeps every
// query tile, and the dq kernel writes 0 for the row.
// Inputs are read through (batch, seq, head) byte strides in the tensor
// maps, so the fused qkv projection needs no flatten copies.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = 64 * kConsumers;  // rows a work item owns
constexpr int kStages = 4;

// The swept tile shrinks for d = 128 to keep the accumulators in
// registers.
template <int D>
struct Tiles {
  static constexpr int kSweep = D <= 64 ? 64 : 32;
};

struct Params {
  const float* lse;  // (b, h, lse_rows(sq)) fp32, 0 past sq
  // (b, h, 2, lse_rows(sq)) fp32: delta, then lse log2 e, both written
  // by the delta kernel (0 past sq) for the other two to read
  float* rows;
  bf16 *dq, *dk, *dv;
  int nh, sq, sk, causal;
  int nbh;        // batch * heads
  int* counters;  // the next work item of dk/dv and of dq, zeroed first
  float scale;
  float inv_sk;   // 1 / sk: an empty row's p (causal sq > sk)
  Strides dqs, dks, dvs;
};

// ---------------------------------------------------------------------------
// delta = rowsum(out * g) in fp32
// ---------------------------------------------------------------------------
constexpr int kDeltaThreads = 256;

template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ g,
                       const float* __restrict__ lse, float* __restrict__ rows,
                       int nh, int sq, int n, Strides os, Strides gs) {
  constexpr int L = D / 8;  // lanes per row, 8 values each
  const int r = blockIdx.x * (kDeltaThreads / L) + threadIdx.x / L;
  const int c = (threadIdx.x % L) * 8;
  const int pad = lse_rows(sq);
  // r = (b * nh + h) * pad + s: the writes coalesce along s
  const int s = r % pad, bh = r / pad;
  float acc = 0.f;
  if (r < n && s < sq) {
    const int b = bh / nh, h = bh % nh;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        out + b * os.b + s * os.s + h * os.h + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        g + b * gs.b + s * gs.s + h * gs.h + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (r < n && threadIdx.x % L == 0) {  // both 0 past sq
    float* row = rows + (long long)bh * 2 * pad + s;
    row[0] = acc;
    row[pad] = s < sq ? lse[r] * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: work item (128 keys, batch * head), the first keys (which the
// most queries see under the causal rule) of every head first
// ---------------------------------------------------------------------------
template <int D>
struct SmemKV {
  static constexpr int BQ = Tiles<D>::kSweep;
  bf16 k[2][kRows * D];  // this item's K and V tiles and the next one's
  bf16 v[2][kRows * D];
  bf16 q[kStages][BQ * D];
  bf16 g[kStages][BQ * D];
  float delta[kStages][BQ];
  float lse2[kStages][BQ];  // lse log2 e
  Ring<kStages> ring;
  Ring<2> kv_ring;
  int item[2];  // the work item in each K/V slot (-1: done)
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mg,
                      const Params p) {
  constexpr int BQ = Tiles<D>::kSweep;
  extern __shared__ unsigned char smem_raw[];
  SmemKV<D>& sm = smem_layout<SmemKV<D>>(smem_raw);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nqt = (sq + BQ - 1) / BQ;
  const int nkt = (sk + kRows - 1) / kRows;  // key tiles of a head
  const int items = nkt * p.nbh;
  // first query tile with any row that sees key `key` (floor; see the
  // note); < nqt while key < sk, since the last query sees every key.
  // With causal sq > sk every tile: the empty rows add g / sk to dv.
  auto first_tile = [&](int key) {
    return p.causal && off >= 0 ? max(key - off, 0) / BQ : 0;
  };

  if (threadIdx.x == 0) {
    sm.ring.init();
    sm.kv_ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * kConsumers) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i = take_item(p.counters, items, sm.item, sm.kv_ring, j);
      if (i < 0) break;
      int bh, rank;
      schedule(i, p.nbh, nkt, bh, rank);
      const int k0 = rank * kRows, b = bh / p.nh, h = bh % p.nh;
      uint64_t* kvbar = &sm.kv_ring.full[j & 1];
      mbar_expect_tx(kvbar, 2 * tile_bytes<kRows, D>());
      tma_tile<kRows, D>(sm.k[j & 1], &mk, kvbar, h, k0, b);
      tma_tile<kRows, D>(sm.v[j & 1], &mv, kvbar, h, k0, b);
      const float* row = p.rows + (long long)bh * 2 * lse_rows(sq);
      for (int qt = first_tile(k0); qt < nqt; ++qt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages, q0 = qt * BQ;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar, 2 * tile_bytes<BQ, D>() + 2 * BQ * 4);
        tma_tile<BQ, D>(sm.q[s], &mq, bar, h, q0, b);
        tma_tile<BQ, D>(sm.g[s], &mg, bar, h, q0, b);
        bulk_load(sm.delta[s], row + q0, BQ * 4, bar);
        bulk_load(sm.lse2[s], row + lse_rows(sq) + q0, BQ * 4, bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [kw, kw + 64) of each item ----
  consumer_regs();
  const int w4 = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;
  int it0 = 0;
  for (int j = 0;; ++j) {
    const int i = wait_item(sm.item, sm.kv_ring, j);
    if (i < 0) break;
    int bh, rank;
    schedule(i, p.nbh, nkt, bh, rank);
    const int k0 = rank * kRows, b = bh / p.nh, h = bh % p.nh;
    const int qt0 = first_tile(k0);
    const int n = nqt - qt0;  // tiles the item sweeps
    const int kw = k0 + 64 * wg;
    const int skip = kw < sk ? first_tile(kw) - qt0 : n;  // dead tiles
    const int key_a = kw + 16 * w4 + g;  // this thread's keys: +0 and +8
    const bf16* sk_tile = sm.k[j & 1];
    const bf16* sv_tile = sm.v[j & 1];

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
    for (int x = 0; x < skip; ++x) {  // tiles none of its keys see
      sm.ring.wait_full(it0 + x);
      sm.ring.release(it0 + x, lane);
    }
    // dV and dK of tile it - 1 run on the tensor cores while S^T and dP^T
    // of tile it are issued; p is computed while dP^T is in flight
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    for (int x = skip; x < n; ++x) {
      const int it = it0 + x;
      sm.ring.wait_full(it);
      const int s = it % kStages;
      const int q0 = (qt0 + x) * BQ;
      wgmma_fence();
      gemm_ss<BQ, D / 16, kRows, BQ>(st, sk_tile, 64 * wg, sm.q[s]);
      wgmma_commit();
      gemm_ss<BQ, D / 16, kRows, BQ>(dpt, sv_tile, 64 * wg, sm.g[s]);
      wgmma_commit();
      wgmma_wait<1>();  // S^T, and the previous tile's dV and dK
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 16>(pa);
      fence_regs<BQ / 16>(sa);
      if (x > skip) sm.ring.release(it - 1, lane);

      // p^T = exp2(s^T sl2 - lse log2 e), masked p exactly 0; only a tile
      // that crosses the diagonal or the ragged end takes the mask
      auto exp_tile = [&](auto masked) {
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c) {
          const int qc = 8 * c + 2 * t;  // this thread's queries: +0, +1
          const float2 l2 =
              *reinterpret_cast<const float2*>(&sm.lse2[s][qc]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv =
                ex2(fmaf(st[4 * c + e], sl2, (e & 1) ? -l2.y : -l2.x));
            if constexpr (decltype(masked)::value) {
              const int q = q0 + qc + (e & 1), key = key_a + 8 * (e >> 1);
              const bool keep =
                  (q < sq) & (!p.causal | causal_keep(q, key, off));
              const bool empty = p.causal & (q + off < 0);
              pv = empty ? (key < sk ? p.inv_sk : 0.f) : (keep ? pv : 0.f);
            }
            st[4 * c + e] = pv;
          }
        }
      };
      if (q0 + BQ > sq || (p.causal && q0 + off < kw + 63))
        exp_tile(std::true_type{});
      else
        exp_tile(std::false_type{});
      to_a_frags<BQ>(pa, st);
      wgmma_wait<0>();
      fence_regs<BQ / 2>(dpt);
      // ds^T / scale = p^T (dp^T - delta); dk takes the scale at the end
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 dl =
            *reinterpret_cast<const float2*>(&sm.delta[s][8 * c + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * c + e] =
              st[4 * c + e] * (dpt[4 * c + e] - ((e & 1) ? dl.y : dl.x));
      }
      if (p.causal && q0 + off < 0) {  // an empty row's ds is 0
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q0 + 8 * c + 2 * t + (e & 1) + off < 0) dpt[4 * c + e] = 0.f;
      }
      to_a_frags<BQ>(sa, dpt);

      // dv += bf16(p)^T g and dk += bf16(ds)^T q
      wgmma_fence();
      gemm_rs<D, BQ / 16, BQ>(dv, pa, sm.g[s]);
      gemm_rs<D, BQ / 16, BQ>(dk, sa, sm.q[s]);
      wgmma_commit();
    }
    wgmma_wait();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    fence_regs<BQ / 16>(pa);
    fence_regs<BQ / 16>(sa);
    if (n > skip) sm.ring.release(it0 + n - 1, lane);
    sm.kv_ring.release(j, lane);
    it0 += n;
    store_rows<D>(p.dk + b * p.dks.b + h * p.dks.h, p.dks.s, dk, kw, sk,
                  p.scale);
    store_rows<D>(p.dv + b * p.dvs.b + h * p.dvs.h, p.dvs.s, dv, kw, sk, 1.f);
  }
}

// ---------------------------------------------------------------------------
// dq: work item (128 queries, batch * head), the last queries (which see
// the most keys under the causal rule) of every head first
// ---------------------------------------------------------------------------
template <int D>
struct SmemQ {
  static constexpr int BK = Tiles<D>::kSweep;
  bf16 q[2][kRows * D];  // this item's Q and G tiles and the next one's
  bf16 g[2][kRows * D];
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  Ring<kStages> ring;
  Ring<2> qg_ring;
  int item[2];  // the work item in each Q/G slot (-1: done)
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mg, const Params p) {
  constexpr int BK = Tiles<D>::kSweep;
  extern __shared__ unsigned char smem_raw[];
  SmemQ<D>& sm = smem_layout<SmemQ<D>>(smem_raw);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nqt = (sq + kRows - 1) / kRows;
  const int items = nqt * p.nbh;
  const int nkt_all = (sk + BK - 1) / BK;
  // key tiles rows up to `last_row` see; 0 when even the last row sees
  // no key (causal sq > sk: the empty rows' p and dq are 0)
  auto live_tiles = [&](int last_row) {
    if (!p.causal) return nkt_all;
    return last_row + off < 0 ? 0 : min(nkt_all, (last_row + off) / BK + 1);
  };

  if (threadIdx.x == 0) {
    sm.ring.init();
    sm.qg_ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * kConsumers) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i =
          take_item(p.counters + 1, items, sm.item, sm.qg_ring, j);
      if (i < 0) break;
      int bh, rank;
      schedule(i, p.nbh, nqt, bh, rank);
      const int q0 = (nqt - 1 - rank) * kRows, b = bh / p.nh, h = bh % p.nh;
      uint64_t* qbar = &sm.qg_ring.full[j & 1];
      mbar_expect_tx(qbar, 2 * tile_bytes<kRows, D>());
      tma_tile<kRows, D>(sm.q[j & 1], &mq, qbar, h, q0, b);
      tma_tile<kRows, D>(sm.g[j & 1], &mg, qbar, h, q0, b);
      const int nkt = live_tiles(min(q0 + kRows, sq) - 1);
      for (int kt = 0; kt < nkt; ++kt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar, 2 * tile_bytes<BK, D>());
        tma_tile<BK, D>(sm.k[s], &mk, bar, h, kt * BK, b);
        tma_tile<BK, D>(sm.v[s], &mv, bar, h, kt * BK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [qw, qw + 64) of each item ----
  consumer_regs();
  const int w4 = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;
  int it0 = 0;
  for (int j = 0;; ++j) {
    const int i = wait_item(sm.item, sm.qg_ring, j);
    if (i < 0) break;
    int bh, rank;
    schedule(i, p.nbh, nqt, bh, rank);
    const int q0 = (nqt - 1 - rank) * kRows, b = bh / p.nh, h = bh % p.nh;
    const int nkt = live_tiles(min(q0 + kRows, sq) - 1);
    const int qw = q0 + 64 * wg;
    const int nkt_w = qw < sq ? live_tiles(min(qw + 64, sq) - 1) : 0;
    const int row_a = qw + 16 * w4 + g;  // this thread's rows: +0 and +8
    const bf16* sq_tile = sm.q[j & 1];
    const bf16* sg_tile = sm.g[j & 1];
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows < lse_rows(sq)
      const float* row = p.rows + (long long)bh * 2 * lse_rows(sq) + row_a +
                         8 * r;
      delta[r] = row[0];
      lse2[r] = row[lse_rows(sq)];
    }

    float dq[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;

    // dQ of tile kt - 1 runs on the tensor cores while S and dP of tile
    // kt are issued; p is computed while dP is in flight
    float sc[BK / 2], dp[BK / 2];
    uint32_t sa[BK / 16][4];
    for (int kt = 0; kt < nkt_w; ++kt) {
      const int it = it0 + kt;
      sm.ring.wait_full(it);
      const int s = it % kStages;
      wgmma_fence();
      gemm_ss<BK, D / 16, kRows, BK>(sc, sq_tile, 64 * wg, sm.k[s]);
      wgmma_commit();
      gemm_ss<BK, D / 16, kRows, BK>(dp, sg_tile, 64 * wg, sm.v[s]);
      wgmma_commit();
      wgmma_wait<1>();  // S, and the previous tile's dQ
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 16>(sa);
      if (kt > 0) sm.ring.release(it - 1, lane);

      // p = exp2(s sl2 - lse2), masked p exactly 0; only a tile that
      // crosses the diagonal or the ragged end takes the mask
      const int k0 = kt * BK;
      auto exp_tile = [&](auto masked) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = (e >> 1) & 1;
          float pv = ex2(fmaf(sc[e], sl2, -lse2[r]));
          if constexpr (decltype(masked)::value) {
            const int col = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const bool keep = (col < sk) &
                              (!p.causal | causal_keep(row_a + 8 * r, col,
                                                       off));
            pv = keep ? pv : 0.f;
          }
          sc[e] = pv;
        }
      };
      if (k0 + BK > sk || (p.causal && k0 + BK - 1 > qw + off))
        exp_tile(std::true_type{});
      else
        exp_tile(std::false_type{});
      wgmma_wait<0>();
      fence_regs<BK / 2>(dp);
      // ds / scale = p (dp - delta); dq takes the scale at the end
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] = sc[e] * (dp[e] - delta[(e >> 1) & 1]);
      to_a_frags<BK>(sa, sc);

      // dq += bf16(ds) k
      wgmma_fence();
      gemm_rs<D, BK / 16, BK>(dq, sa, sm.k[s]);
      wgmma_commit();
    }
    wgmma_wait();
    fence_regs<D / 2>(dq);
    fence_regs<BK / 16>(sa);
    if (nkt_w > 0) sm.ring.release(it0 + nkt_w - 1, lane);
    sm.qg_ring.release(j, lane);
    for (int kt = nkt_w; kt < nkt; ++kt) {  // tiles only the other rows see
      sm.ring.wait_full(it0 + kt);
      sm.ring.release(it0 + kt, lane);
    }
    it0 += nkt;
    store_rows<D>(p.dq + b * p.dqs.b + h * p.dqs.h, p.dqs.s, dq, qw, sq,
                  p.scale);
  }
}

template <int D>
constexpr int smem_kv() {
  return sizeof(SmemKV<D>) + 1024;  // + alignment slack
}
template <int D>
constexpr int smem_q() {
  return sizeof(SmemQ<D>) + 1024;
}

// parts of the backward a launch runs (the wrapper runs all three; the
// timing in chip_smoke.py runs them one at a time)
enum : int { kDelta = 1, kDkDv = 2, kDq = 4 };

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* g, const Strides st[8],
                   const Params& p, int batch, int parts,
                   cudaStream_t stream) {
  cudaError_t err0 = cudaMemsetAsync(p.counters, 0, 2 * sizeof(int), stream);
  if (err0 != cudaSuccess) return err0;
  constexpr int S = Tiles<D>::kSweep;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_kv<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // st: q, k, v, out, g, dq, dk, dv
  if (parts & kDelta) {
    const int n = batch * p.nh * lse_rows(p.sq);
    const int per_block = kDeltaThreads / (D / 8);
    flash_bwd_delta_kernel<D>
        <<<(n + per_block - 1) / per_block, kDeltaThreads, 0, stream>>>(
            static_cast<const bf16*>(out), static_cast<const bf16*>(g), p.lse,
            p.rows, p.nh, p.sq, n, st[3], st[4]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int bh = batch * p.nh;
  if (parts & kDkDv) {
    CUtensorMap mq, mk, mv, mg;
    if (!make_map(&mq, q, batch, p.sq, p.nh, D, st[0], S) ||
        !make_map(&mk, k, batch, p.sk, p.nh, D, st[1], kRows) ||
        !make_map(&mv, v, batch, p.sk, p.nh, D, st[2], kRows) ||
        !make_map(&mg, g, batch, p.sq, p.nh, D, st[4], S))
      return cudaErrorInvalidValue;
    const int items = (p.sk + kRows - 1) / kRows * bh;
    const int grid = items < sm_count() ? items : sm_count();
    flash_bwd_dkdv_kernel<D>
        <<<grid, kThreads, smem_kv<D>(), stream>>>(mq, mk, mv, mg, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kDq) {
    CUtensorMap mq, mk, mv, mg;
      if (!make_map(&mq, q, batch, p.sq, p.nh, D, st[0], kRows) ||
        !make_map(&mk, k, batch, p.sk, p.nh, D, st[1], S) ||
        !make_map(&mv, v, batch, p.sk, p.nh, D, st[2], S) ||
        !make_map(&mg, g, batch, p.sq, p.nh, D, st[4], kRows))
      return cudaErrorInvalidValue;
    const int items = (p.sq + kRows - 1) / kRows * bh;
    const int grid = items < sm_count() ? items : sm_count();
    flash_bwd_dq_kernel<D>
        <<<grid, kThreads, smem_q<D>(), stream>>>(mq, mk, mv, mg, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
void info(int kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (kernel == 0)
    err = cudaFuncGetAttributes(&a, flash_bwd_delta_kernel<D>);
  else if (kernel == 1)
    err = cudaFuncGetAttributes(&a, flash_bwd_dkdv_kernel<D>);
  else
    err = cudaFuncGetAttributes(&a, flash_bwd_dq_kernel<D>);
  if (err != cudaSuccess) return;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = kernel == 0 ? 0 : kernel == 1 ? smem_kv<D>() : smem_q<D>();
  out[3] = kernel == 0 ? kDeltaThreads : kThreads;
}

}  // namespace

// C entry for ctypes. q, g, out, dq (b, sq, h, d), k, v, dk, dv
// (b, sk, h, d), all bf16 with a contiguous head dim, 16-byte aligned
// bases and element strides that are multiples of 8; lse
// (b, h, lse_rows(sq)) fp32 contiguous as the forward writes it; `rows`
// (b, h, 2, lse_rows(sq)) fp32 scratch, which the delta kernel fills
// (delta, and lse log2 e) for the other two to read; `counters` two int32
// of scratch (zeroed here, then the work queues). `parts` selects the
// kernels (1 delta, 2 dk/dv, 4 dq; 7 for the whole backward). Launches on
// `stream` without
// synchronising; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or layout the kernels do not take).
extern "C" int flash_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, const void* lse, void* rows, void* counters, void* dq,
    void* dk, void* dv, int batch, int nh, int sq, int sk, int d,
    const long long* strides, int causal, float scale, int parts,
    void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  // strides: (b, s, h) for q, k, v, out, g, dq, dk, dv in that order
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Params p{static_cast<const float*>(lse),
                 static_cast<float*>(rows),
                 static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv),
                 nh, sq, sk, causal, batch * nh,
                 static_cast<int*>(counters), scale, 1.f / sk, st[5], st[6],
                 st[7]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(q, k, v, out, g, st, p, batch, parts, s);
  else if (d == 128)
    err = launch<128>(q, k, v, out, g, st, p, batch, parts, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// {registers, local (spill) bytes, dynamic shared bytes, threads} of
// kernel 0 (delta), 1 (dk/dv) or 2 (dq) for head dim d.
extern "C" void flash_bwd_info(int d, int kernel, int* out) {
  if (d == 64) info<64>(kernel, out);
  if (d == 128) info<128>(kernel, out);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
