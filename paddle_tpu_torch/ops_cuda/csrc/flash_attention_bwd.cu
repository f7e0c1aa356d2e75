// Flash-attention backward for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the TPU kernel `_bwd_merged_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_backward_flat`, together with the fp32
// delta = rowsum(out * g) pass that `_flash_backward_flat` runs before
// it. Same function: with the forward's fp32 logsumexp it recomputes
// p = exp(s - lse) (s scaled in fp32, masked where the bottom-right
// causal rule hides a key) and emits
//   dv = T(p)^T g,   dp = g v^T,   ds = T(p * (dp - delta) * scale),
//   dk = ds^T q,     dq = ds k,
// every product with fp32 accumulation, every gradient stored in the
// input type T. Three routes, fixed by dtype, one set of kernel bodies:
// bf16 at head dim 32, 64 or 128 (`wgmma`, bf16 products), fp16 at the
// same head dims (`wgmma_f16`, fp16 products; the bf16 kernels
// instantiated for `__half`) and fp32 at 32, 64 or 128 (`tf32x3`, every
// product three TF32 products; see flash_attention_common.cuh). fp16
// rounds ds = p (dp - delta) scale with the scale applied, where the
// plain version rounds it: fp16's range ends at 65504, and a gradient
// under a loss scale of 2^15 can reach it, so the scale may not wait
// for the end as it does for bf16 (whose range is fp32's).
//
// The kernels, launched in order on one stream:
//   - fp32 only, `split_kernel`: the lo parts of q, k, v, g as rows
//     (and their hi parts where TMA cannot read the input in place; an
//     input it reads is its own hi part) and both parts of q, g, k
//     transposed (TF32 wgmma reads B K-major only, and the B operands of
//     dV += P^T G, dK += dS^T Q and dQ += dS K are G, Q and K reduced
//     over their rows);
//   - `flash_bwd_delta_kernel`: delta = rowsum(out * g) in fp32, d / 8
//     lanes per row; it also writes lse log2 e beside delta for the
//     other two;
//   - `flash_bwd_dkdv_kernel`: work items of (64 C keys, batch * head);
//     an item sweeps the query tiles that can see its keys and keeps dk
//     and dv in registers;
//   - `flash_bwd_dq_kernel`: work items of (64 C queries, batch * head);
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
// head halved by the mask, 72.5 GFLOP. bf16: over 989 TFLOP/s 0.073 ms
// (the 7 products run here: 0.103 ms); q, k, v, out, g read and dq, dk,
// dv written once, 227 MB over 3.35 TB/s = 0.068 ms: the operations.
// fp32: 3 x 72.5 GFLOP over the 495 TFLOP/s of TF32 = 0.440 ms.
//
// What the design does about it: every product is a wgmma. Both sweep
// kernels are persistent (one CTA per SM walking its work items, the
// longest first) with C consumer warpgroups of 64 rows (keys in dk/dv,
// queries in dq; C = 2 for bf16 and fp16, 1 or 2 for fp32, whose hi and
// lo tiles fill shared memory four times as fast) and a producer warp;
// `setmaxnreg` moves the producer's registers to the consumers. The
// tiles an item owns (K and V, or Q and G) come once by TMA into one of
// kSlots resident slots, so the next item's load overlaps this one's
// sweep; the swept tiles stream through TMA into a ring of kStages
// buffers with full/empty mbarriers.
//   dk/dv: S^T = K Q^T and dP^T = V G^T shared x shared; P^T and dS^T
//          repack in registers into A fragments; dV += P^T G and
//          dK += dS^T Q register x shared, G and Q through MN-major
//          descriptors (bf16) or their transposed copies (fp32). The
//          tile's delta and lse log2 e rows come by bulk copy on the same
//          barrier as its Q and G tiles.
//   dq:    S = Q K^T and dP = G V^T shared x shared; dQ += dS K register
//          x shared, K through an MN-major descriptor (bf16) or K^T
//          (fp32).
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
// maps, so the fused qkv projection needs no flatten copies (fp32 ones as
// their hi parts); fp32 ones TMA does not take go through split_kernel's
// plain loads.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Per kernel, type and head dim: consumer warpgroups, rows of a swept
// tile, ring stages (at least 2: a tile is released only once the next
// one has landed), resident slots, tile parts (hi and lo for fp32) and,
// for dk/dv, the columns of dk and dv one work item writes (fp32 d 128
// splits them in two halves, each item recomputing S^T and dP^T, to keep
// the running sums and the tile's fresh ones in registers). Shared
// memory, fp32: dk/dv d 32 2 x 64 + 4 x 16 KB, d 64 128 + 3 x 32, d 128
// 128 + 2 x 48; dq d 32 2 x 32 + 4 x 24, d 64 64 + 3 x 48, d 128 128 +
// 2 x 48. fp32 dk/dv at d 32 and 64 runs two consumer warpgroups (128
// keys share each swept tile), the other fp32 kernels one (two would
// leave the dq ring two stages, which measured slower).
template <typename T, int D>
struct CfgKV;
template <int D>
struct CfgKV<bf16, D> {
  static constexpr int C = 2, S = D <= 64 ? 64 : 32, kStages = 4,
                       kSlots = 2, kParts = 1, DV = D;
};
template <int D>
struct CfgKV<f16, D> : CfgKV<bf16, D> {};
template <int D>
struct CfgKV<float, D> {
  static constexpr int C = D <= 64 ? 2 : 1, S = 16,
                       kStages = D == 32 ? 4 : D == 64 ? 3 : 2,
                       kSlots = D == 32 ? 2 : 1, kParts = 2,
                       DV = D <= 64 ? D : 64;
};
template <typename T, int D>
struct CfgQ;
template <int D>
struct CfgQ<bf16, D> : CfgKV<bf16, D> {};
template <int D>
struct CfgQ<f16, D> : CfgKV<bf16, D> {};
template <int D>
struct CfgQ<float, D> {
  static constexpr int C = 1, S = D == 128 ? 16 : 32,
                       kStages = D == 32 ? 4 : D == 64 ? 3 : 2,
                       kSlots = D == 32 ? 2 : 1, kParts = 2;
};

template <typename T>
struct Params {
  const float* lse;  // (b, h, lse_rows(sq)) fp32, 0 past sq
  // (b, h, 2, lse_rows(sq)) fp32: delta, then lse log2 e, both written
  // by the delta kernel (0 past sq) for the other two to read
  float* rows;
  T *dq, *dk, *dv;
  int batch, nh, sq, sk, causal;
  int nbh;        // batch * heads
  int* counters;  // the next work item of dk/dv and of dq, zeroed first
  float scale;
  float inv_sk;   // 1 / sk: an empty row's p (causal sq > sk)
  Strides dqs, dks, dvs;
};

// The tensor maps of a sweep kernel: q, k, v, g as rows and, fp32 only,
// the transposed copies: q^T and g^T for dk/dv, k^T for dq.
struct Maps {
  Op q, k, v, g, t0, t1;
};

// ---------------------------------------------------------------------------
// delta = rowsum(out * g) in fp32
// ---------------------------------------------------------------------------
constexpr int kDeltaThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ g,
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
    const T* orow = out + b * os.b + s * os.s + h * os.h + c;
    const T* grow = g + b * gs.b + s * gs.s + h * gs.h + c;
    if constexpr (is_f32<T>()) {  // plain loads: any fp32 strides
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(orow[i], grow[i], acc);
    } else {  // 16-byte loads: TMA's layout rules hold
      const uint4 ov = *reinterpret_cast<const uint4*>(orow);
      const uint4 gv = *reinterpret_cast<const uint4*>(grow);
      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
      const uint32_t* g2 = reinterpret_cast<const uint32_t*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = unpack2<T>(o2[i]);
        const float2 gf = unpack2<T>(g2[i]);
        acc = fmaf(of.x, gf.x, acc);
        acc = fmaf(of.y, gf.y, acc);
      }
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
// dk, dv: work item (64 C keys, batch * head), the first keys (which the
// most queries see under the causal rule) of every head first
// ---------------------------------------------------------------------------
template <typename T, int D>
struct SmemKV {
  using F = CfgKV<T, D>;
  static constexpr int R = 64 * F::C, BQ = F::S, P = F::kParts;
  // the transposed copies' DV rows (fp32); one 16-byte filler for bf16
  static constexpr int kT = is_f32<T>() ? P * BQ * F::DV : 8;
  T k[F::kSlots][P * R * D];  // this item's K and V tiles (and the next's)
  T v[F::kSlots][P * R * D];
  T q[F::kStages][P * BQ * D];
  T g[F::kStages][P * BQ * D];
  T qt[F::kStages][kT];
  T gt[F::kStages][kT];
  float delta[F::kStages][BQ];
  float lse2[F::kStages][BQ];  // lse log2 e
  Ring<F::kStages, F::C> ring;
  Ring<F::kSlots, F::C> kv_ring;
  int item[F::kSlots];  // the work item in each K/V slot (-1: done)
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ Maps m, const Params<T> p) {
  using F = CfgKV<T, D>;
  constexpr int C = F::C, R = 64 * C, BQ = F::S, P = F::kParts, DV = F::DV;
  constexpr int kStages = F::kStages, kSlots = F::kSlots;
  constexpr int kSplits = D / DV;  // column blocks of dk and dv
  constexpr bool kF32 = is_f32<T>(), kF16 = is_f16<T>();
  static_assert(kStages >= 2, "a tile is released after the next lands");
  using LR = Tile<T, R, D>;
  using LS = Tile<T, BQ, D>;
  using LT = Tile<T, DV, BQ>;  // fp32: DV rows of q^T and g^T
  extern __shared__ unsigned char smem_raw[];
  SmemKV<T, D>& sm = smem_layout<SmemKV<T, D>>(smem_raw);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nqt = (sq + BQ - 1) / BQ;
  const int nkt = (sk + R - 1) / R;  // key tiles of a head
  const int items = nkt * p.nbh * kSplits;
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

  if (wg == C) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * C) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i = take_item(p.counters, items, sm.item, sm.kv_ring, j);
      if (i < 0) break;
      int bh, rank;
      schedule(i / kSplits, p.nbh, nkt, bh, rank);
      const int k0 = rank * R, b = bh / p.nh, h = bh % p.nh;
      const int c0 = (i % kSplits) * DV;  // the item's dk, dv columns
      uint64_t* kvbar = &sm.kv_ring.full[j % kSlots];
      mbar_expect_tx(kvbar, 2 * P * LR::kBytes);
      tma_op<T, R, D>(sm.k[j % kSlots], m.k, kvbar, 0, h, k0, b);
      tma_op<T, R, D>(sm.v[j % kSlots], m.v, kvbar, 0, h, k0, b);
      const float* row = p.rows + (long long)bh * 2 * lse_rows(sq);
      for (int qt = first_tile(k0); qt < nqt; ++qt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages, q0 = qt * BQ;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar, 2 * P * LS::kBytes +
                                (kF32 ? 2 * P * LT::kBytes : 0) + 2 * BQ * 4);
        tma_op<T, BQ, D>(sm.q[s], m.q, bar, 0, h, q0, b);
        tma_op<T, BQ, D>(sm.g[s], m.g, bar, 0, h, q0, b);
        if constexpr (kF32) {
          tma_op<T, DV, BQ>(sm.qt[s], m.t0, bar, q0, h, c0, b);
          tma_op<T, DV, BQ>(sm.gt[s], m.t1, bar, q0, h, c0, b);
        }
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
    schedule(i / kSplits, p.nbh, nkt, bh, rank);
    const int k0 = rank * R, b = bh / p.nh, h = bh % p.nh;
    const int c0 = (i % kSplits) * DV;
    const int qt0 = first_tile(k0);
    const int n = nqt - qt0;  // tiles the item sweeps
    const int kw = k0 + 64 * wg;
    const int skip = kw < sk ? first_tile(kw) - qt0 : n;  // dead tiles
    const int key_a = kw + 16 * w4 + g;  // this thread's keys: +0 and +8
    const T* sk_tile = sm.k[j % kSlots];
    const T* sv_tile = sm.v[j % kSlots];

    // dk, dv: the sums over the swept tiles; fp32 sums each tile's
    // products in tk, tv first (the accumulator truncates) and adds them
    // here, bf16 accumulates in place
    float dk[DV / 2], dv[DV / 2];
    float tk_[kF32 ? DV / 2 : 1], tv_[kF32 ? DV / 2 : 1];
    float* tk = kF32 ? tk_ : dk;
    float* tv = kF32 ? tv_ : dv;
#pragma unroll
    for (int x = 0; x < DV / 2; ++x) dk[x] = dv[x] = 0.f;
    auto add_tile = [&]() {
      fence_regs<DV / 2>(tv);
      fence_regs<DV / 2>(tk);
      if constexpr (kF32) {
#pragma unroll
        for (int x = 0; x < DV / 2; ++x) {
          dk[x] += tk[x];
          dv[x] += tv[x];
        }
      }
    };
    for (int x = 0; x < skip; ++x) {  // tiles none of its keys see
      sm.ring.wait_full(it0 + x);
      sm.ring.release(it0 + x, lane);
    }
    // dV and dK of tile it - 1 run on the tensor cores beside S^T and
    // dP^T of tile it; p is computed while dP^T is in flight. bf16 issues
    // them at the end of iteration it - 1. fp32 issues them at the top of
    // iteration it and waits for them there, since it reads their fresh
    // sums (bf16 in that order: K3 3.9% slower in scripts/flash_ab.py,
    // PERF.md). ptxas serializes every wgmma of the loop when an
    // accumulator is read while its product may still be in flight across
    // the back edge, or when a product or a wait sits behind a branch
    // (each doubled the fp32 backward or cost bf16 17%), so every
    // iteration issues the same products (fp32's first tile: zero A
    // fragments over its own B tiles, adding zero) and the last wait is
    // unconditional.
    float st[BQ / 2], dpt[BQ / 2];
    Frags<T, BQ> pa, sa;
    zero_frags(pa);
    zero_frags(sa);
    // dv += T(p)^T g and dk += T(ds)^T q (columns [c0, c0 + DV)) of the
    // tile in stage `s`
    auto issue_dvdk = [&](int s) {
      gemm_rs<T, DV, BQ>(tv, pa, kF32 ? sm.gt[s] : sm.g[s], kF32);
      gemm_rs<T, DV, BQ>(tk, sa, kF32 ? sm.qt[s] : sm.q[s], kF32);
    };
    for (int x = skip; x < n; ++x) {
      const int it = it0 + x;
      sm.ring.wait_full(it);
      const int s = it % kStages;
      const int q0 = (qt0 + x) * BQ;
      wgmma_fence();
      if constexpr (kF32) {
        issue_dvdk(x > skip ? (it - 1) % kStages : s);
        wgmma_commit();
      }
      gemm_ss<T, BQ, D, R>(st, sk_tile, 64 * wg, sm.q[s]);
      wgmma_commit();
      gemm_ss<T, BQ, D, R>(dpt, sv_tile, 64 * wg, sm.g[s]);
      wgmma_commit();
      if constexpr (kF32) {
        wgmma_wait<2>();  // the previous tile's dV and dK
        fence_frags(pa);
        fence_frags(sa);
        add_tile();
      }
      wgmma_wait<1>();  // S^T (bf16: and the previous tile's dV and dK)
      fence_regs<BQ / 2>(st);
      fence_frags(pa);
      fence_frags(sa);
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
      to_a_frags(pa, st);
      wgmma_wait<0>();
      fence_regs<BQ / 2>(dpt);
      // ds^T / scale = p^T (dp^T - delta); dk takes the scale at the end
      // (fp16: ds^T itself, see the note at the top)
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 dl =
            *reinterpret_cast<const float2*>(&sm.delta[s][8 * c + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[4 * c + e] =
              st[4 * c + e] * (dpt[4 * c + e] - ((e & 1) ? dl.y : dl.x));
          if constexpr (kF16) dpt[4 * c + e] *= p.scale;
        }
      }
      if (p.causal && q0 + off < 0) {  // an empty row's ds is 0
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q0 + 8 * c + 2 * t + (e & 1) + off < 0) dpt[4 * c + e] = 0.f;
      }
      to_a_frags(sa, dpt);
      if constexpr (!kF32) {
        wgmma_fence();
        issue_dvdk(s);
        wgmma_commit();
      }
    }
    if constexpr (kF32) {  // the last tile's dV and dK
      if (n > skip) {
        wgmma_fence();
        issue_dvdk((it0 + n - 1) % kStages);
        wgmma_commit();
      }
    }
    // a wait behind a branch would serialize every product of the loop
    wgmma_wait();
    fence_frags(pa);
    fence_frags(sa);
    if (n > skip) {
      sm.ring.release(it0 + n - 1, lane);
      add_tile();
    }
    sm.kv_ring.release(j, lane);
    it0 += n;
    store_rows<DV>(p.dk + b * p.dks.b + h * p.dks.h + c0, p.dks.s, dk, kw,
                   sk, kF16 ? 1.f : p.scale);
    store_rows<DV>(p.dv + b * p.dvs.b + h * p.dvs.h + c0, p.dvs.s, dv, kw,
                   sk, 1.f);
  }
}

// ---------------------------------------------------------------------------
// dq: work item (64 C queries, batch * head), the last queries (which see
// the most keys under the causal rule) of every head first
// ---------------------------------------------------------------------------
template <typename T, int D>
struct SmemQ {
  using F = CfgQ<T, D>;
  static constexpr int R = 64 * F::C, BK = F::S, P = F::kParts;
  static constexpr int kT = is_f32<T>() ? P * BK * D : 8;  // k^T (fp32)
  T q[F::kSlots][P * R * D];  // this item's Q and G tiles (and the next's)
  T g[F::kSlots][P * R * D];
  T k[F::kStages][P * BK * D];
  T v[F::kStages][P * BK * D];
  T kt[F::kStages][kT];
  Ring<F::kStages, F::C> ring;
  Ring<F::kSlots, F::C> qg_ring;
  int item[F::kSlots];  // the work item in each Q/G slot (-1: done)
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps m, const Params<T> p) {
  using F = CfgQ<T, D>;
  constexpr int C = F::C, R = 64 * C, BK = F::S, P = F::kParts;
  constexpr int kStages = F::kStages, kSlots = F::kSlots;
  constexpr bool kF32 = is_f32<T>(), kF16 = is_f16<T>();
  static_assert(kStages >= 2, "a tile is released after the next lands");
  using LR = Tile<T, R, D>;
  using LS = Tile<T, BK, D>;
  using LT = Tile<T, D, BK>;  // fp32: k^T
  extern __shared__ unsigned char smem_raw[];
  SmemQ<T, D>& sm = smem_layout<SmemQ<T, D>>(smem_raw);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nqt = (sq + R - 1) / R;
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

  if (wg == C) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * C) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i =
          take_item(p.counters + 1, items, sm.item, sm.qg_ring, j);
      if (i < 0) break;
      int bh, rank;
      schedule(i, p.nbh, nqt, bh, rank);
      const int q0 = (nqt - 1 - rank) * R, b = bh / p.nh, h = bh % p.nh;
      uint64_t* qbar = &sm.qg_ring.full[j % kSlots];
      mbar_expect_tx(qbar, 2 * P * LR::kBytes);
      tma_op<T, R, D>(sm.q[j % kSlots], m.q, qbar, 0, h, q0, b);
      tma_op<T, R, D>(sm.g[j % kSlots], m.g, qbar, 0, h, q0, b);
      const int nkt = live_tiles(min(q0 + R, sq) - 1);
      for (int kt = 0; kt < nkt; ++kt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar,
                       2 * P * LS::kBytes + (kF32 ? P * LT::kBytes : 0));
        tma_op<T, BK, D>(sm.k[s], m.k, bar, 0, h, kt * BK, b);
        tma_op<T, BK, D>(sm.v[s], m.v, bar, 0, h, kt * BK, b);
        if constexpr (kF32)
          tma_op<T, D, BK>(sm.kt[s], m.t0, bar, kt * BK, h, 0, b);
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
    const int q0 = (nqt - 1 - rank) * R, b = bh / p.nh, h = bh % p.nh;
    const int nkt = live_tiles(min(q0 + R, sq) - 1);
    const int qw = q0 + 64 * wg;
    const int nkt_w = qw < sq ? live_tiles(min(qw + 64, sq) - 1) : 0;
    const int row_a = qw + 16 * w4 + g;  // this thread's rows: +0 and +8
    const T* sq_tile = sm.q[j % kSlots];
    const T* sg_tile = sm.g[j % kSlots];
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows < lse_rows(sq)
      const float* row = p.rows + (long long)bh * 2 * lse_rows(sq) + row_a +
                         8 * r;
      delta[r] = row[0];
      lse2[r] = row[lse_rows(sq)];
    }

    // dq: the sum over the swept tiles (fp32: each tile's products in tq
    // first, added here; bf16 in place)
    float dq[D / 2], tq_[kF32 ? D / 2 : 1];
    float* tq = kF32 ? tq_ : dq;
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
    auto add_tile = [&]() {
      fence_regs<D / 2>(tq);
      if constexpr (kF32) {
#pragma unroll
        for (int x = 0; x < D / 2; ++x) dq[x] += tq[x];
      }
    };

    // dQ of tile kt - 1 runs beside S and dP of tile kt; p is computed
    // while dP is in flight. As in dk/dv: bf16 issues it at the end of
    // iteration kt - 1, fp32 at the top of iteration kt (the first tile's
    // dQ: zero A fragments over its own K tile).
    float sc[BK / 2], dp[BK / 2];
    Frags<T, BK> sa;
    zero_frags(sa);
    // dq += T(ds) k of the tile in stage `s`
    auto issue_dq = [&](int s) {
      gemm_rs<T, D, BK>(tq, sa, kF32 ? sm.kt[s] : sm.k[s], kF32);
    };
    for (int kt = 0; kt < nkt_w; ++kt) {
      const int it = it0 + kt;
      sm.ring.wait_full(it);
      const int s = it % kStages;
      wgmma_fence();
      if constexpr (kF32) {
        issue_dq(kt > 0 ? (it - 1) % kStages : s);
        wgmma_commit();
      }
      gemm_ss<T, BK, D, R>(sc, sq_tile, 64 * wg, sm.k[s]);
      wgmma_commit();
      gemm_ss<T, BK, D, R>(dp, sg_tile, 64 * wg, sm.v[s]);
      wgmma_commit();
      if constexpr (kF32) {
        wgmma_wait<2>();  // the previous tile's dQ
        fence_frags(sa);
        add_tile();
      }
      wgmma_wait<1>();  // S (bf16: and the previous tile's dQ)
      fence_regs<BK / 2>(sc);
      fence_frags(sa);
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
      // ds / scale = p (dp - delta); dq takes the scale at the end (fp16:
      // ds itself)
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        sc[e] = sc[e] * (dp[e] - delta[(e >> 1) & 1]);
        if constexpr (kF16) sc[e] *= p.scale;
      }
      to_a_frags(sa, sc);
      if constexpr (!kF32) {
        wgmma_fence();
        issue_dq(s);
        wgmma_commit();
      }
    }
    if constexpr (kF32) {  // the last tile's dQ
      if (nkt_w > 0) {
        wgmma_fence();
        issue_dq((it0 + nkt_w - 1) % kStages);
        wgmma_commit();
      }
    }
    wgmma_wait();  // unconditional, as in dk/dv
    fence_frags(sa);
    if (nkt_w > 0) {
      sm.ring.release(it0 + nkt_w - 1, lane);
      add_tile();
    }
    sm.qg_ring.release(j, lane);
    for (int kt = nkt_w; kt < nkt; ++kt) {  // tiles only the other rows see
      sm.ring.wait_full(it0 + kt);
      sm.ring.release(it0 + kt, lane);
    }
    it0 += nkt;
    store_rows<D>(p.dq + b * p.dqs.b + h * p.dqs.h, p.dqs.s, dq, qw, sq,
                  kF16 ? 1.f : p.scale);
  }
}

template <typename T, int D>
constexpr int smem_kv() {
  return sizeof(SmemKV<T, D>) + 1024;  // + alignment slack
}
template <typename T, int D>
constexpr int smem_q() {
  return sizeof(SmemQ<T, D>) + 1024;
}

// parts of the backward a launch runs (the wrapper runs all of them; the
// timing in chip_smoke.py runs them one at a time)
enum : int { kDelta = 1, kDkDv = 2, kDq = 4, kSplit = 8 };

// The delta, dk/dv and dq kernels over ready maps (`kv` for dk/dv, `qm`
// for dq). in: out, g and their strides.
template <typename T, int D>
cudaError_t launch_kernels(const Maps& kv, const Maps& qm, const T* out,
                           const T* g, Strides os, Strides gs,
                           const Params<T>& p, int parts,
                           cudaStream_t stream) {
  using FK = CfgKV<T, D>;
  using FQ = CfgQ<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv<T, D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q<T, D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (parts & kDelta) {
    const int n = p.nbh * lse_rows(p.sq);
    const int per_block = kDeltaThreads / (D / 8);
    flash_bwd_delta_kernel<T, D>
        <<<(n + per_block - 1) / per_block, kDeltaThreads, 0, stream>>>(
            out, g, p.lse, p.rows, p.nh, p.sq, n, os, gs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kDkDv) {
    const int items =
        (p.sk + 64 * FK::C - 1) / (64 * FK::C) * p.nbh * (D / FK::DV);
    const int grid = items < sm_count() ? items : sm_count();
    flash_bwd_dkdv_kernel<T, D>
        <<<grid, 128 * (FK::C + 1), smem_kv<T, D>(), stream>>>(kv, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kDq) {
    const int items = (p.sq + 64 * FQ::C - 1) / (64 * FQ::C) * p.nbh;
    const int grid = items < sm_count() ? items : sm_count();
    flash_bwd_dq_kernel<T, D>
        <<<grid, 128 * (FQ::C + 1), smem_q<T, D>(), stream>>>(qm, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// bf16, fp16: tensor maps straight over the inputs (st: q, k, v, out, g,
// dq, dk, dv)
template <typename T, int D>
cudaError_t run_16(const T* q, const T* k, const T* v, const T* out,
                   const T* g, const Strides* st, const Params<T>& p,
                   int parts, cudaStream_t stream) {
  constexpr int R = 64 * CfgKV<T, D>::C, S = CfgKV<T, D>::S;
  const int bt = p.batch, nh = p.nh, sq = p.sq, sk = p.sk;
  Maps kv{}, qm{};
  if ((parts & kDkDv) && (!op16<S, D>(&kv.q, q, st[0], bt, nh, sq) ||
                          !op16<R, D>(&kv.k, k, st[1], bt, nh, sk) ||
                          !op16<R, D>(&kv.v, v, st[2], bt, nh, sk) ||
                          !op16<S, D>(&kv.g, g, st[4], bt, nh, sq)))
    return cudaErrorInvalidValue;
  if ((parts & kDq) && (!op16<R, D>(&qm.q, q, st[0], bt, nh, sq) ||
                        !op16<S, D>(&qm.k, k, st[1], bt, nh, sk) ||
                        !op16<S, D>(&qm.v, v, st[2], bt, nh, sk) ||
                        !op16<R, D>(&qm.g, g, st[4], bt, nh, sq)))
    return cudaErrorInvalidValue;
  return launch_kernels<T, D>(kv, qm, out, g, st[3], st[4], p, parts,
                              stream);
}

// The wgmma routes: Params and dispatch on head dim for element type T.
template <typename T>
cudaError_t run_16_d(const void* q, const void* k, const void* v,
                     const void* out, const void* g, const void* lse,
                     void* rows, void* counters, void* dq, void* dk,
                     void* dv, int batch, int nh, int sq, int sk, int d,
                     const Strides* st, int causal, float scale, int parts,
                     cudaStream_t s) {
  const Params<T> p{static_cast<const float*>(lse), static_cast<float*>(rows),
                    static_cast<T*>(dq), static_cast<T*>(dk),
                    static_cast<T*>(dv), batch, nh, sq, sk, causal,
                    batch * nh, static_cast<int*>(counters), scale,
                    1.f / sk, st[5], st[6], st[7]};
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(out),
          *tg = static_cast<const T*>(g);
  if (d == 32) return run_16<T, 32>(tq, tk, tv, to, tg, st, p, parts, s);
  if (d == 64) return run_16<T, 64>(tq, tk, tv, to, tg, st, p, parts, s);
  if (d == 128) return run_16<T, 128>(tq, tk, tv, to, tg, st, p, parts, s);
  return cudaErrorInvalidValue;
}

// The pieces of the fp32 backward's scratch: q, k, v, g as rows, then
// q^T, g^T, k^T, each hi and lo (the hi half of an input TMA reads in
// place stays unwritten)
struct ScratchF32 {
  float *qn, *kn, *vn, *gn, *qt, *gt, *kt;
  ScratchF32(float* base, int nbh, int sq, int sk, int d) {
    qn = base;
    kn = qn + nat_floats(nbh, sq, d);
    vn = kn + nat_floats(nbh, sk, d);
    gn = vn + nat_floats(nbh, sk, d);
    qt = gn + nat_floats(nbh, sq, d);
    gt = qt + tr_floats(nbh, sq, d);
    kt = gt + tr_floats(nbh, sq, d);
  }
  static long long floats(int nbh, int sq, int sk, int d) {
    return 2 * nat_floats(nbh, sq, d) + 2 * nat_floats(nbh, sk, d) +
           2 * tr_floats(nbh, sq, d) + tr_floats(nbh, sk, d);
  }
};

// fp32: split_kernel writes the hi and lo copies into `scratch`, and the
// sweep kernels read those and the inputs TMA reads in place
template <int D>
cudaError_t run_f32(const float* q, const float* k, const float* v,
                    const float* out, const float* g, const Strides* st,
                    const Params<float>& p, float* scratch, int parts,
                    cudaStream_t stream) {
  constexpr int R = 64 * CfgKV<float, D>::C, BQ = CfgKV<float, D>::S;
  constexpr int DV = CfgKV<float, D>::DV;
  constexpr int RQ = 64 * CfgQ<float, D>::C, BK = CfgQ<float, D>::S;
  const ScratchF32 sc(scratch, p.nbh, p.sq, p.sk, D);
  if (parts & kSplit) {
    SplitArgs a{};
    a.nbh = p.nbh;
    a.nh = p.nh;
    a.op[0] = SplitOp{q, sc.qn, sc.qt, st[0], p.sq, !in_place(q, st[0])};
    a.op[1] = SplitOp{k, sc.kn, sc.kt, st[1], p.sk, !in_place(k, st[1])};
    a.op[2] = SplitOp{v, sc.vn, nullptr, st[2], p.sk, !in_place(v, st[2])};
    a.op[3] = SplitOp{g, sc.gn, sc.gt, st[4], p.sq, !in_place(g, st[4])};
    cudaError_t err = launch_split<D>(a, 4, p.sq > p.sk ? p.sq : p.sk,
                                      stream);
    if (err != cudaSuccess) return err;
  }
  Maps kv{}, qm{};
  const int bt = p.batch, nh = p.nh, sq = p.sq, sk = p.sk;
  if ((parts & kDkDv) &&
      (!row_op<D, BQ>(&kv.q, q, st[0], sc.qn, bt, nh, sq) ||
       !row_op<D, R>(&kv.k, k, st[1], sc.kn, bt, nh, sk) ||
       !row_op<D, R>(&kv.v, v, st[2], sc.vn, bt, nh, sk) ||
       !row_op<D, BQ>(&kv.g, g, st[4], sc.gn, bt, nh, sq) ||
       !tr_op<D, BQ, DV>(&kv.t0, sc.qt, bt, nh, sq) ||
       !tr_op<D, BQ, DV>(&kv.t1, sc.gt, bt, nh, sq)))
    return cudaErrorInvalidValue;
  if ((parts & kDq) && (!row_op<D, RQ>(&qm.q, q, st[0], sc.qn, bt, nh, sq) ||
                        !row_op<D, BK>(&qm.k, k, st[1], sc.kn, bt, nh, sk) ||
                        !row_op<D, BK>(&qm.v, v, st[2], sc.vn, bt, nh, sk) ||
                        !row_op<D, RQ>(&qm.g, g, st[4], sc.gn, bt, nh, sq) ||
                        !tr_op<D, BK>(&qm.t0, sc.kt, bt, nh, sk)))
    return cudaErrorInvalidValue;
  return launch_kernels<float, D>(kv, qm, out, g, st[3], st[4], p, parts,
                                  stream);
}

template <typename T, int D>
void info(int kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (kernel == 0)
    err = cudaFuncGetAttributes(&a, flash_bwd_delta_kernel<T, D>);
  else if (kernel == 1)
    err = cudaFuncGetAttributes(&a, flash_bwd_dkdv_kernel<T, D>);
  else
    err = cudaFuncGetAttributes(&a, flash_bwd_dq_kernel<T, D>);
  if (err != cudaSuccess) return;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = kernel == 0 ? 0 : kernel == 1 ? smem_kv<T, D>() : smem_q<T, D>();
  out[3] = kernel == 0   ? kDeltaThreads
           : kernel == 1 ? 128 * (CfgKV<T, D>::C + 1)
                         : 128 * (CfgQ<T, D>::C + 1);
}

}  // namespace

// Floats of the fp32 backward's scratch (ScratchF32's pieces).
extern "C" long long flash_bwd_scratch_floats(int batch, int nh, int sq,
                                              int sk, int d) {
  return ScratchF32::floats(batch * nh, sq, sk, d);
}

// C entry for ctypes. `dtype` 0 fp32 (the tf32x3 route; `scratch` holds
// flash_bwd_scratch_floats floats), 1 bf16 or 2 fp16 (the wgmma routes;
// scratch unused). q, g, out, dq (b, sq, h, d), k, v, dk, dv (b, sk, h,
// d), with a contiguous head dim; bf16 and fp16 ones with 16-byte
// aligned bases and element strides that are multiples of 8, fp32 ones
// with any. lse
// (b, h, lse_rows(sq)) fp32 contiguous as the forward writes it; `rows`
// (b, h, 2, lse_rows(sq)) fp32 scratch, which the delta kernel fills
// (delta, and lse log2 e) for the other two to read; `counters` two int32
// of scratch (zeroed here, then the work queues). `parts` selects the
// kernels (1 delta, 2 dk/dv, 4 dq, 8 the fp32 split; 7 for the whole
// bf16 or fp16 backward, 15 for fp32). Launches on `stream` without
// synchronising; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or layout the kernels do not take).
extern "C" int flash_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, const void* lse, void* rows, void* counters, void* dq,
    void* dk, void* dv, void* scratch, int batch, int nh, int sq, int sk,
    int d, int dtype, const long long* strides, int causal, float scale,
    int parts, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  // strides: (b, s, h) for q, k, v, out, g, dq, dk, dv in that order
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2) {
    err = (dtype == 1 ? run_16_d<bf16> : run_16_d<f16>)(
        q, k, v, out, g, lse, rows, counters, dq, dk, dv, batch, nh, sq, sk,
        d, st, causal, scale, parts, s);
  } else if (dtype == 0) {
    const Params<float> p{static_cast<const float*>(lse),
                          static_cast<float*>(rows), static_cast<float*>(dq),
                          static_cast<float*>(dk), static_cast<float*>(dv),
                          batch, nh, sq, sk, causal, batch * nh,
                          static_cast<int*>(counters), scale, 1.f / sk,
                          st[5], st[6], st[7]};
    const float *fq = static_cast<const float*>(q),
                *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v),
                *fo = static_cast<const float*>(out),
                *fg = static_cast<const float*>(g);
    float* sc = static_cast<float*>(scratch);
    if (d == 32)
      err = run_f32<32>(fq, fk, fv, fo, fg, st, p, sc, parts, s);
    if (d == 64)
      err = run_f32<64>(fq, fk, fv, fo, fg, st, p, sc, parts, s);
    if (d == 128)
      err = run_f32<128>(fq, fk, fv, fo, fg, st, p, sc, parts, s);
  }
  return static_cast<int>(err);
}

// {registers, local (spill) bytes, dynamic shared bytes, threads} of
// kernel 0 (delta), 1 (dk/dv) or 2 (dq) for `dtype` (0 fp32, 1 bf16, 2
// fp16) and head dim d.
extern "C" void flash_bwd_info(int dtype, int d, int kernel, int* out) {
  if (dtype == 1 && d == 32) info<bf16, 32>(kernel, out);
  if (dtype == 1 && d == 64) info<bf16, 64>(kernel, out);
  if (dtype == 1 && d == 128) info<bf16, 128>(kernel, out);
  if (dtype == 2 && d == 32) info<f16, 32>(kernel, out);
  if (dtype == 2 && d == 64) info<f16, 64>(kernel, out);
  if (dtype == 2 && d == 128) info<f16, 128>(kernel, out);
  if (dtype == 0 && d == 32) info<float, 32>(kernel, out);
  if (dtype == 0 && d == 64) info<float, 64>(kernel, out);
  if (dtype == 0 && d == 128) info<float, 128>(kernel, out);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
