// Flash-attention forward for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the TPU kernel `_fwd_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_forward_flat`. Same function: for every
// (batch, head) and query row, an online softmax over the keys with
// q.k and p.v products accumulated in fp32, scores scaled in fp32, the
// bottom-right-aligned causal rule q + (sk - sq) >= j with -1e30 for
// masked scores, p cast to v's dtype before p.v, and an `l == 0` guard.
// It writes out (b, sq, h, d) in the input dtype and the fp32
// natural-log logsumexp m + log(l) as the (b, h, sq) rows of a
// (b, h, lse_rows(sq)) buffer, which the backward (K3) reads.
//
// Two routes, fixed by dtype, one kernel body:
// - bf16 at head dim 32, 64 or 128 (`wgmma`): bf16 products.
// - fp32 at head dim 32, 64 or 128 (`tf32x3`): every product is three
//   TF32 products (flash_attention_common.cuh), after `split_kernel` has
//   written the lo parts of q and k as rows (and their hi parts where TMA
//   cannot read q or k in place) and both parts of v transposed (TF32
//   wgmma reads B K-major only, and P V's B is V^T).
//
// Bound on an H100 SXM at the training shape (b 18, h 12, s 1024,
// d 64, causal): 2 products of 2 s^2 d flops per head, halved by the
// causal mask, 29 GFLOP. bf16: over 989 TFLOP/s 0.029 ms; q, k, v read
// once and out and lse written once, 114 MB over 3.35 TB/s = 0.034 ms:
// the bytes, by a little; at d = 64 the exponentials cost the
// special-function units as much time as the two products cost the
// tensor cores, so the two have to overlap. fp32: 3 x 29 GFLOP over the
// 495 TFLOP/s of TF32 = 0.176 ms; 227 MB of fp32 bytes = 0.068 ms: the
// operations.
//
// What the design does about it:
// - The grid is persistent: one CTA per SM walks the work items (a query
//   tile of 64 C rows of one (batch, head)), the tiles that see the most
//   keys first. A CTA is C consumer warpgroups of 64 rows each (2; 1 for
//   fp32 at d 128, whose hi and lo tiles fill shared memory four times
//   as fast as bf16's) and a producer warp (one warpgroup; `setmaxnreg`
//   moves its registers to the consumers). The producer loads an item's
//   Q tile by TMA into one of kSlots slots, so the next item's Q lands
//   while this one runs, and streams K and V tiles into a ring of
//   kStages buffers with full/empty mbarriers; no consumer thread spends
//   instructions on addresses.
// - Every product is a wgmma: S = Q K^T shared x shared (m64 nBK),
//   O += P V register x shared with V through an MN-major descriptor
//   (bf16) or V^T through a K-major one (fp32). P goes from the S
//   accumulator into A fragments without touching shared memory. S of
//   tile j + 1 is issued ahead of P V of tile j, and the softmax of tile
//   j + 1 runs while P V is in flight.
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
//   in place (fp32 q and k as their hi parts); fp32 ones with strides TMA
//   does not take go through split_kernel's plain loads, so any strides
//   with a contiguous head dim go.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Per (type, head dim): consumer warpgroups, keys per tile, ring stages,
// Q slots and tile parts (hi and lo for fp32). Shared memory: bf16
// d 128 2 x 32 + 3 x 32 KB; fp32 d 32 2 x 32 + 3 x 32, d 64 64 +
// 2 x 64, d 128 (one consumer warpgroup) 64 + 2 x 64 KB.
template <typename T, int D>
struct Cfg;
template <int D>
struct Cfg<bf16, D> {
  static constexpr int C = 2, BK = D <= 64 ? 128 : 64, kStages = 3,
                       kSlots = 2, kParts = 1;
};
template <int D>
struct Cfg<float, D> {
  static constexpr int C = D <= 64 ? 2 : 1, BK = D <= 64 ? 64 : 32,
                       kStages = D == 32 ? 3 : 2, kSlots = D == 32 ? 2 : 1,
                       kParts = 2;
};

template <typename T, int D>
struct Smem {
  using F = Cfg<T, D>;
  static constexpr int BQ = 64 * F::C;  // query rows per work item
  T q[F::kSlots][F::kParts * BQ * D];  // this item's Q tile and the next
  T k[F::kStages][F::kParts * F::BK * D];
  T v[F::kStages][F::kParts * F::BK * D];  // bf16 V; fp32 V^T (D x BK)
  Ring<F::kStages, F::C> ring;
  Ring<F::kSlots, F::C> q_ring;
  int item[F::kSlots];  // the work item in each Q slot (-1: done)
};

// The tensor maps: q and k as rows, v as rows (bf16) or transposed
// (fp32)
struct Maps {
  Op q, k, v;
};

template <typename T>
struct Params {
  T* out;
  float* lse;
  int batch, nh, sq, sk, causal;
  int items;     // query tiles x batch x heads
  int* counter;  // the next work item, zeroed before the launch
  float scale;
  Strides os;
};

// Work item i: a query tile of BQ rows of head bh in `schedule`'s order;
// rank 0 is the last tile, which sees the most keys under the causal
// rule.
struct Item {
  int b, h, bh, q0, nkt;
  template <typename P>
  __device__ Item(const P& p, int i, int bq, int bk) {
    const int ntq = (p.sq + bq - 1) / bq;
    int rank;
    schedule(i, p.items / ntq, ntq, bh, rank);
    b = bh / p.nh;
    h = bh % p.nh;
    q0 = (ntq - 1 - rank) * bq;
    nkt = live_tiles(p, q0, min(q0 + bq, p.sq) - 1, bk);
  }
  // key tiles of `bk` keys that rows [first_row, last_row] see. A row
  // with no visible key (first_row + sk - sq < 0, causal sq > sk) takes
  // the mean of every key's v, so a block holding one visits every tile.
  template <typename P>
  static __device__ int live_tiles(const P& p, int first_row, int last_row,
                                   int bk) {
    const int all = (p.sk + bk - 1) / bk;
    const int off = p.sk - p.sq;
    if (!p.causal || first_row + off < 0) return all;
    return min(all, (last_row + off) / bk + 1);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_fwd_kernel(const __grid_constant__ Maps m, const Params<T> p) {
  using F = Cfg<T, D>;
  constexpr int C = F::C, BK = F::BK, BQ = 64 * C, P = F::kParts;
  constexpr int kStages = F::kStages, kSlots = F::kSlots;
  constexpr bool kF32 = is_f32<T>();
  static_assert(kStages >= 2, "a tile is released after the next lands");
  using LQ = Tile<T, BQ, D>;
  using LK = Tile<T, BK, D>;
  using LV = std::conditional_t<kF32, Tile<T, D, BK>, Tile<T, BK, D>>;
  extern __shared__ unsigned char smem_raw[];
  Smem<T, D>& sm = smem_layout<Smem<T, D>>(smem_raw);
  const int off = p.sk - p.sq;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm.ring.init();
    sm.q_ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == C) {
    // ---- producer: one thread runs ahead over this CTA's work items ----
    producer_regs();
    if (threadIdx.x != 128 * C) return;
    int it = 0;  // ring tile counter
    for (int j = 0;; ++j) {  // work items of this CTA
      const int i = take_item(p.counter, p.items, sm.item, sm.q_ring, j);
      if (i < 0) break;
      const Item w(p, i, BQ, BK);
      uint64_t* qbar = &sm.q_ring.full[j % kSlots];
      mbar_expect_tx(qbar, P * LQ::kBytes);
      tma_op<T, BQ, D>(sm.q[j % kSlots], m.q, qbar, 0, w.h, w.q0, w.b);
      for (int kt = 0; kt < w.nkt; ++kt, ++it) {
        sm.ring.wait_empty(it);
        const int s = it % kStages;
        uint64_t* bar = &sm.ring.full[s];
        mbar_expect_tx(bar, P * (LK::kBytes + LV::kBytes));
        tma_op<T, BK, D>(sm.k[s], m.k, bar, 0, w.h, kt * BK, w.b);
        if constexpr (kF32)
          tma_op<T, D, BK>(sm.v[s], m.v, bar, kt * BK, w.h, 0, w.b);
        else
          tma_op<T, BK, D>(sm.v[s], m.v, bar, 0, w.h, kt * BK, w.b);
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
    const Item w(p, i, BQ, BK);
    const int qw = w.q0 + 64 * wg;
    const int nkt_w =
        qw < p.sq ? Item::live_tiles(p, qw, min(qw + 64, p.sq) - 1, BK) : 0;
    const int row_a = qw + 16 * w4 + g;  // this thread's rows: +0 and +8
    const T* sq_tile = sm.q[j % kSlots];

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
      Frags<T, BK> pa;
      sm.ring.wait_full(it0);
      wgmma_fence();
      gemm_ss<T, BK, D, BQ>(sc, sq_tile, 64 * wg, sm.k[it0 % kStages]);
      wgmma_commit();
      wgmma_wait();
      fence_regs<BK / 2>(sc);
      softmax(sc, 0, alpha);
      to_a_frags(pa, sc);
      for (int kt = 1; kt < nkt_w; ++kt) {
        const int it = it0 + kt;
        sm.ring.wait_full(it);
        wgmma_fence();
        gemm_ss<T, BK, D, BQ>(sc, sq_tile, 64 * wg, sm.k[it % kStages]);
        wgmma_commit();
        gemm_rs<T, D, BK>(o, pa, sm.v[(it - 1) % kStages]);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<BK / 2>(sc);
        softmax(sc, kt, alpha);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        fence_frags(pa);
        sm.ring.release(it - 1, lane);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
        to_a_frags(pa, sc);
      }
      wgmma_fence();
      gemm_rs<T, D, BK>(o, pa, sm.v[(it0 + nkt_w - 1) % kStages]);
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(o);
      fence_frags(pa);
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
    T* ob = p.out + w.b * p.os.b + w.h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= p.sq) continue;
      T* orow = ob + row * p.os.s + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2(orow + 8 * c, o[4 * c + 2 * r] * inv[r],
               o[4 * c + 2 * r + 1] * inv[r]);
    }
  }
}

template <typename T, int D>
constexpr int smem_bytes() {
  return sizeof(Smem<T, D>) + 1024;  // + alignment slack
}

// parts of a launch: the fp32 split (hi and lo copies) and the kernel
enum : int { kSplit = 1, kMain = 2 };

template <typename T, int D>
cudaError_t launch_main(const Maps& m, Params<T> p, cudaStream_t stream) {
  using F = Cfg<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<T, D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  p.items = (p.sq + 64 * F::C - 1) / (64 * F::C) * p.batch * p.nh;
  cudaError_t err = cudaMemsetAsync(p.counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int grid = p.items < sm_count() ? p.items : sm_count();
  flash_fwd_kernel<T, D>
      <<<grid, 128 * (F::C + 1), smem_bytes<T, D>(), stream>>>(m, p);
  return cudaGetLastError();
}

// bf16: tensor maps straight over q, k, v (st: q, k, v, out)
template <int D>
cudaError_t run_bf16(const bf16* q, const bf16* k, const bf16* v,
                     const Strides* st, const Params<bf16>& p,
                     cudaStream_t stream) {
  using F = Cfg<bf16, D>;
  Maps m{};
  if (!bf16_op<64 * F::C, D>(&m.q, q, st[0], p.batch, p.nh, p.sq) ||
      !bf16_op<F::BK, D>(&m.k, k, st[1], p.batch, p.nh, p.sk) ||
      !bf16_op<F::BK, D>(&m.v, v, st[2], p.batch, p.nh, p.sk))
    return cudaErrorInvalidValue;
  return launch_main<bf16, D>(m, p, stream);
}

// fp32: split_kernel writes q and k as rows (lo; hi too where TMA cannot
// read q or k in place) and v transposed, hi and lo, into `scratch`
// (flash_fwd_scratch_floats), and the kernel reads those and q and k
template <int D>
cudaError_t run_f32(const float* q, const float* k, const float* v,
                    float* scratch, const Strides* st,
                    const Params<float>& p, int parts, cudaStream_t stream) {
  using F = Cfg<float, D>;
  const int nbh = p.batch * p.nh;
  float* qn = scratch;
  float* kn = qn + nat_floats(nbh, p.sq, D);
  float* vt = kn + nat_floats(nbh, p.sk, D);
  if (parts & kSplit) {
    SplitArgs a{};
    a.nbh = nbh;
    a.nh = p.nh;
    a.op[0] = SplitOp{q, qn, nullptr, st[0], p.sq, !in_place(q, st[0])};
    a.op[1] = SplitOp{k, kn, nullptr, st[1], p.sk, !in_place(k, st[1])};
    a.op[2] = SplitOp{v, nullptr, vt, st[2], p.sk, false};
    cudaError_t err = launch_split<D>(a, 3, p.sq > p.sk ? p.sq : p.sk,
                                      stream);
    if (err != cudaSuccess) return err;
  }
  if (!(parts & kMain)) return cudaSuccess;
  Maps m{};
  if (!row_op<D, 64 * F::C>(&m.q, q, st[0], qn, p.batch, p.nh, p.sq) ||
      !row_op<D, F::BK>(&m.k, k, st[1], kn, p.batch, p.nh, p.sk) ||
      !tr_op<D, F::BK>(&m.v, vt, p.batch, p.nh, p.sk))
    return cudaErrorInvalidValue;
  return launch_main<float, D>(m, p, stream);
}

template <typename T, int D>
void info(int* out) {
  using F = Cfg<T, D>;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, flash_fwd_kernel<T, D>) != cudaSuccess)
    return;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = smem_bytes<T, D>();
  out[3] = 128 * (F::C + 1);
}

}  // namespace

// Floats of the fp32 forward's scratch: q and k as rows and v
// transposed, each hi and lo (split_kernel's layouts; the hi half of an
// operand TMA reads in place stays unwritten).
extern "C" long long flash_fwd_scratch_floats(int batch, int nh, int sq,
                                              int sk, int d) {
  const int nbh = batch * nh;
  return nat_floats(nbh, sq, d) + nat_floats(nbh, sk, d) +
         tr_floats(nbh, sk, d);
}

// C entry for ctypes. `dtype` 0 fp32 (the tf32x3 route; `scratch` holds
// flash_fwd_scratch_floats floats) or 1 bf16 (the wgmma route; scratch
// unused). `counter`: one int32 of device scratch (zeroed here, then the
// work queue). q (b, sq, h, d), k and v (b, sk, h, d), out (b, sq, h, d),
// with a contiguous head dim and the element strides (b, s, h of q, k,
// v, out); bf16 ones with 16-byte aligned bases and strides that are
// multiples of 8, fp32 ones with any. lse (b, h, lse_rows(sq)) fp32
// contiguous, written 0 past sq. `parts` (fp32): 1 the split, 2 the
// kernel, 3 both. Launches on `stream` without synchronising; returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// shape or layout the kernels do not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, void* counter,
                                void* scratch, int batch, int nh, int sq,
                                int sk, int d, int dtype,
                                const long long* strides, int causal,
                                float scale, int parts, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 ||
      !indices_fit(batch, nh, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    const Params<bf16> p{static_cast<bf16*>(out), static_cast<float*>(lse),
                         batch, nh, sq, sk, causal, 0,
                         static_cast<int*>(counter), scale, st[3]};
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    if (d == 32) err = run_bf16<32>(bq, bk, bv, st, p, s);
    if (d == 64) err = run_bf16<64>(bq, bk, bv, st, p, s);
    if (d == 128) err = run_bf16<128>(bq, bk, bv, st, p, s);
  } else if (dtype == 0) {
    const Params<float> p{static_cast<float*>(out), static_cast<float*>(lse),
                          batch, nh, sq, sk, causal, 0,
                          static_cast<int*>(counter), scale, st[3]};
    const float *fq = static_cast<const float*>(q),
                *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* sc = static_cast<float*>(scratch);
    if (d == 32) err = run_f32<32>(fq, fk, fv, sc, st, p, parts, s);
    if (d == 64) err = run_f32<64>(fq, fk, fv, sc, st, p, parts, s);
    if (d == 128) err = run_f32<128>(fq, fk, fv, sc, st, p, parts, s);
  }
  return static_cast<int>(err);
}

// {registers, local (spill) bytes, dynamic shared bytes, threads} of the
// kernel for `dtype` (0 fp32, 1 bf16) and head dim d.
extern "C" void flash_fwd_info(int dtype, int d, int* out) {
  if (dtype == 1 && d == 32) info<bf16, 32>(out);
  if (dtype == 1 && d == 64) info<bf16, 64>(out);
  if (dtype == 1 && d == 128) info<bf16, 128>(out);
  if (dtype == 0 && d == 32) info<float, 32>(out);
  if (dtype == 0 && d == 64) info<float, 64>(out);
  if (dtype == 0 && d == 128) info<float, 128>(out);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
