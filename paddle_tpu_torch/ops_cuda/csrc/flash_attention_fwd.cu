// Flash-attention forward for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the TPU kernel `_fwd_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_forward_flat`. Same function: for every
// (batch, head) and query row, an online softmax over the keys with
// bf16 q.k and p.v products accumulated in fp32, scores scaled in fp32,
// the bottom-right-aligned causal rule q + (sk - sq) >= j with -1e30
// for masked scores, p cast to bf16 before p.v, and an `l == 0` guard.
// It writes out (b, sq, h, d) in bf16 and the fp32 natural-log
// logsumexp m + log(l) as the (b, h, sq) rows of a (b, h, lse_rows(sq))
// buffer, which the backward (K3) reads.
//
// Bound on an H100 SXM at the training shape (b 18, h 12, s 1024,
// d 64, causal): 2 products of 2 s^2 d flops per head, halved by the
// causal mask, 29 GFLOP over 989 TFLOP/s = 0.029 ms; q, k, v read once
// and out and lse written once, 114 MB over 3.35 TB/s = 0.034 ms. The
// bound is the bytes, by a little; at d = 64 the exponentials cost the
// special-function units as much time as the two products cost the
// tensor cores (64 x 128 exp2 per 64 x 128 x 64 x 2 products), so the
// two have to overlap.
//
// What the design does about it:
// - The grid is persistent: one CTA per SM walks the work items (a query
//   tile of 128 rows of one (batch, head)), the tiles that see the most
//   keys first. A CTA is two consumer warpgroups of 64 rows each and a
//   producer warp (one warpgroup; `setmaxnreg` moves its registers to
//   the consumers). The producer loads an item's Q tile by TMA into one
//   of two slots, so the next item's Q lands while this one runs, and
//   streams K and V tiles into a ring of kStages buffers with full/empty
//   mbarriers; no consumer thread spends instructions on addresses.
// - Every product is a wgmma: S = Q K^T shared x shared (m64 nBK k16),
//   O += P V register x shared with V through an MN-major descriptor.
//   P goes from the S accumulator into bf16 A fragments without
//   touching shared memory. S of tile j + 1 is issued ahead of P V of
//   tile j, and the softmax of tile j + 1 runs while P V is in flight.
// - The softmax runs in the exp2 domain: p = exp2(s * scale log2 e - m)
//   with the scale folded into one FFMA; the logsumexp is converted back
//   to the natural log once per row.
// - Under the causal rule each warpgroup visits only the key tiles its
//   last row can see and masks only the tiles that cross the diagonal or
//   the ragged end. TMA's zero fill covers the ragged ends of q, k, v.
// - Causal sq > sk leaves the first sq - sk rows with no visible key.
//   The reference gives them a uniform softmax over all sk keys (the
//   mean of v). A warpgroup holding such a row visits every key tile,
//   scores the row 0 on each key (-inf past sk) and writes lse -1e30.
// - q, k, v are read through (batch, seq, head) byte strides in the
//   tensor maps, so the fused qkv projection (b, s, 3, h, d) is attended
//   in place.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64 * kConsumers;  // query rows per CTA
constexpr int kStages = 3;

template <int D>
struct Tiles {
  static constexpr int kBlockK = D <= 64 ? 128 : 64;  // keys per tile
};

template <int D>
struct Smem {
  static constexpr int BK = Tiles<D>::kBlockK;
  bf16 q[2][kBlockQ * D];  // this work item's Q tile and the next one's
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  Ring<kStages> ring;
  Ring<2> q_ring;
  int item[2];  // the work item in each Q slot (-1: done)
};

struct Params {
  bf16* out;
  float* lse;
  int nh, sq, sk, causal;
  int items;     // query tiles x batch x heads
  int* counter;  // the next work item, zeroed before the launch
  float scale;
  Strides os;
};

// Work item i: a query tile of head bh in `schedule`'s order; rank 0 is
// the last tile, which sees the most keys under the causal rule.
struct Item {
  int b, h, bh, q0, nkt;
  __device__ Item(const Params& p, int i, int bk) {
    const int ntq = (p.sq + kBlockQ - 1) / kBlockQ;
    int rank;
    schedule(i, p.items / ntq, ntq, bh, rank);
    b = bh / p.nh;
    h = bh % p.nh;
    q0 = (ntq - 1 - rank) * kBlockQ;
    nkt = live_tiles(p, q0, min(q0 + kBlockQ, p.sq) - 1, bk);
  }
  // key tiles of `bk` keys that rows [first_row, last_row] see. A row
  // with no visible key (first_row + sk - sq < 0, causal sq > sk) takes
  // the mean of every key's v, so a block holding one visits every tile.
  static __device__ int live_tiles(const Params& p, int first_row,
                                   int last_row, int bk) {
    const int all = (p.sk + bk - 1) / bk;
    const int off = p.sk - p.sq;
    if (!p.causal || first_row + off < 0) return all;
    return min(all, (last_row + off) / bk + 1);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const Params p) {
  constexpr int BK = Tiles<D>::kBlockK;
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = smem_layout<Smem<D>>(smem_raw);
  const int off = p.sk - p.sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm.ring.init();
    sm.q_ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * kConsumers) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i = take_item(p.counter, p.items, sm.item, sm.q_ring, j);
      if (i < 0) break;
      const Item w(p, i, BK);
      uint64_t* qbar = &sm.q_ring.full[j & 1];
      mbar_expect_tx(qbar, tile_bytes<kBlockQ, D>());
      tma_tile<kBlockQ, D>(sm.q[j & 1], &mq, qbar, w.h, w.q0, w.b);
      for (int kt = 0; kt < w.nkt; ++kt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar, 2 * tile_bytes<BK, D>());
        tma_tile<BK, D>(sm.k[s], &mk, bar, w.h, kt * BK, w.b);
        tma_tile<BK, D>(sm.v[s], &mv, bar, w.h, kt * BK, w.b);
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
    const int i = wait_item(sm.item, sm.q_ring, j);
    if (i < 0) break;
    const Item w(p, i, BK);
    const int qw = w.q0 + 64 * wg;
    const int nkt_w =
        qw < p.sq ? Item::live_tiles(p, qw, min(qw + 64, p.sq) - 1, BK) : 0;
    const int row_a = qw + 16 * w4 + g;  // this thread's rows: +0 and +8
    const bf16* sq_tile = sm.q[j & 1];

    float o[D / 2];
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) o[i2] = 0.f;
    float m_r[2] = {kNegInf * sl2, kNegInf * sl2};  // max of s * sl2
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums

    // scores of key tile kt -> p in place (exp2 domain); the factor that
    // rescales the rows' earlier sums goes to `alpha`. Only a tile that
    // crosses the diagonal or the ragged end takes the masked variant.
    auto softmax = [&](float* sc, int kt, float* alpha) {
      const int k0 = kt * BK;
      // mask: 0 none, 1 the causal rule and the ragged end, 2 that and
      // rows with no visible key (only a warpgroup that holds one)
      auto body = [&](auto mask) {
        constexpr int kMask = decltype(mask)::value;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int r = (x >> 1) & 1;
          if constexpr (kMask > 0) {
            const int col = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
            const int row = row_a + 8 * r;
            const bool keep = (col < p.sk) &
                              (!p.causal | causal_keep(row, col, off));
            sc[x] = keep ? sc[x] : kNegInf;
            if constexpr (kMask == 2) {
              // an empty row scores 0 on every key and -inf past sk: p =
              // 1 on each of the sk keys (its -1e30 scores are all equal)
              if (row + off < 0) sc[x] = col < p.sk ? 0.f : neg_inf();
            }
          }
          mx[r] = fmaxf(mx[r], sc[x]);  // the raw scores: the scale is > 0
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r] * sl2);
          alpha[r] = ex2(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int r = (x >> 1) & 1;
          sc[x] = ex2(fmaf(sc[x], sl2, -m_r[r]));
          l_r[r] += sc[x];
        }
      };
      if (p.causal && qw + off < 0)
        body(std::integral_constant<int, 2>{});
      else if (k0 + BK > p.sk || (p.causal && k0 + BK - 1 > qw + off))
        body(std::integral_constant<int, 1>{});
      else
        body(std::integral_constant<int, 0>{});
    };

    if (nkt_w > 0) {
      // S of tile kt + 1 runs on the tensor cores while P V of tile kt is
      // issued behind it, and the softmax of kt + 1 runs beside P V
      float sc[BK / 2], alpha[2];
      uint32_t pa[BK / 16][4];
      sm.ring.wait_full(it0);
      wgmma_fence();
      gemm_ss<BK, D / 16, kBlockQ, BK>(sc, sq_tile, 64 * wg,
                                       sm.k[it0 % kStages]);
      wgmma_commit();
      wgmma_wait();
      fence_regs<BK / 2>(sc);
      softmax(sc, 0, alpha);
      to_a_frags<BK>(pa, sc);
      for (int kt = 1; kt < nkt_w; ++kt) {
        const int it = it0 + kt;
        sm.ring.wait_full(it);
        wgmma_fence();
        gemm_ss<BK, D / 16, kBlockQ, BK>(sc, sq_tile, 64 * wg,
                                         sm.k[it % kStages]);
        wgmma_commit();
        gemm_rs<D, BK / 16, BK>(o, pa, sm.v[(it - 1) % kStages]);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<BK / 2>(sc);
        softmax(sc, kt, alpha);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        fence_regs<BK / 16>(pa);
        sm.ring.release(it - 1, lane);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
        to_a_frags<BK>(pa, sc);
      }
      wgmma_fence();
      gemm_rs<D, BK / 16, BK>(o, pa, sm.v[(it0 + nkt_w - 1) % kStages]);
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(o);
      fence_regs<BK / 16>(pa);
      sm.ring.release(it0 + nkt_w - 1, lane);
    }
    sm.q_ring.release(j, lane);  // every product on this Q has completed
    // tiles only the other warpgroup's rows see
    for (int kt = nkt_w; kt < w.nkt; ++kt) {
      sm.ring.wait_full(it0 + kt);
      sm.ring.release(it0 + kt, lane);
    }
    it0 += w.nkt;

    // normalise, write out and the natural-log logsumexp
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = l == 0.f ? 1.f : l;
      inv[r] = 1.f / l_safe;
      const int row = row_a + 8 * r;  // < lse_rows(sq): 0 past sq
      // an empty row's lse is -1e30 + log sk = -1e30 in fp32, as the
      // plain version gives it; the backward treats the row explicitly
      const float lse = p.causal && row + off < 0
                            ? kNegInf
                            : (m_r[r] + log2f(l_safe)) * kLn2;
      if (t == 0)
        p.lse[(long long)w.bh * lse_rows(p.sq) + row] =
            row < p.sq ? lse : 0.f;
    }
    bf16* ob = p.out + w.b * p.os.b + w.h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= p.sq) continue;
      bf16* orow = ob + row * p.os.s + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16(
            o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // + alignment slack
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, void* counter, int batch, int nh, int sq,
                   int sk, Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int BK = Tiles<D>::kBlockK;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, batch, sq, nh, D, qs, kBlockQ) ||
      !make_map(&mk, k, batch, sk, nh, D, ks, BK) ||
      !make_map(&mv, v, batch, sk, nh, D, vs, BK))
    return cudaErrorInvalidValue;
  const int items = (sq + kBlockQ - 1) / kBlockQ * batch * nh;
  const Params p{static_cast<bf16*>(out), static_cast<float*>(lse), nh, sq,
                 sk, causal, items, static_cast<int*>(counter), scale, os};
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int grid = items < sm_count() ? items : sm_count();
  flash_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(mq, mk, mv,
                                                                   p);
  return cudaGetLastError();
}

template <int D>
void info(int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, flash_fwd_kernel<D>) != cudaSuccess) return;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = smem_bytes<D>();
  out[3] = kThreads;
}

}  // namespace

// C entry for ctypes. `counter`: one int32 of device scratch (zeroed here,
// then the work queue). q (b, sq, h, d), k and v (b, sk, h, d), out
// (b, sq, h, d), all bf16 with a contiguous head dim, 16-byte aligned
// bases and the given element strides (multiples of 8); lse
// (b, h, lse_rows(sq)) fp32 contiguous, written 0 past sq. Launches on
// `stream` without synchronising; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or layout the kernel does not
// take).
extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* counter, int batch, int nh, int sq, int sk, int d, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, float scale, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(q, k, v, out, lse, counter, batch, nh, sq, sk, qs, ks,
                     vs, os, causal, scale, s);
  else if (d == 128)
    err = launch<128>(q, k, v, out, lse, counter, batch, nh, sq, sk, qs, ks,
                      vs, os, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// {registers, local (spill) bytes, dynamic shared bytes, threads} of the
// kernel for head dim d.
extern "C" void flash_fwd_info(int d, int* out) {
  if (d == 64) info<64>(out);
  if (d == 128) info<128>(out);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
