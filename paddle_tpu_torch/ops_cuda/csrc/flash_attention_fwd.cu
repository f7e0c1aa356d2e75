// Flash-attention forward for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the TPU kernel `_fwd_kernel` in
// paddle_tpu/ops_pallas/flash_attention.py, launched there through
// pl.pallas_call by `_flash_forward_flat`. Same function: for every
// (batch, head) and query row, an online softmax over the keys with
// bf16 q.k and p.v products accumulated in fp32, scores scaled in fp32,
// the bottom-right-aligned causal rule q + (sk - sq) >= j with -1e30
// for masked scores, p cast to bf16 before p.v, and an `l == 0` guard.
// It writes out (b, sq, h, d) in bf16 and the fp32 logsumexp m + log(l)
// as (b, h, sq), which the backward (K3) reads.
//
// Bound on an H100 SXM at the training shape (b 18, h 12, s 1024,
// d 64, causal): 2 products of 2 s^2 d flops per head, halved by the
// causal mask, 29 GFLOP over 989 TFLOP/s = 0.029 ms; q, k, v read once
// and out written once, 113 MB over 3.35 TB/s = 0.034 ms. The bound is
// the bytes, by a little; a tile-based kernel rereads K and V once per
// query tile (from L2), so in practice the tensor cores and the exp
// units set the pace.
//
// What the design does about it:
// - One CTA of four warps per (query tile of 64 rows, batch * head);
//   each warp owns 16 query rows for the whole key sweep, so the online
//   softmax state (m, l and the 16 x d accumulator) stays in registers
//   and no warp waits on another.
// - Products run on the tensor cores (mma.sync m16n8k16, bf16 -> fp32).
//   Q is loaded once into registers as A fragments; K and V tiles of 64
//   rows are double-buffered in shared memory with 16-byte cp.async, so
//   the copy of tile j + 1 overlaps the products of tile j. P never
//   leaves registers: the score accumulators are repacked as the A
//   fragments of the p.v product.
// - Under the causal rule a CTA visits only the key tiles its last row
//   can see (the TPU kernel's `num_live`), and masks only the tiles that
//   cross the diagonal or the ragged end of the keys; query tiles are
//   issued longest first so the short ones fill the tail of the grid.
// - It reads q, k, v through (batch, seq, head) strides, so the fused
//   qkv projection (b, s, 3, h, d) is attended in place: the TPU path's
//   (b, s, h, d) -> (b*h, s, d) flatten copies (forced there by Mosaic's
//   (8, 128) block tiling) do not exist here.
// No TMA, no wgmma and no warp specialisation yet.
#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;  // 4 warps x 16 rows
constexpr int kBlockK = 64;

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int nh, int sq, int sk,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBlockQ x LD
  bf16* sK = sQ + kBlockQ * LD;                  // 2 stages x kBlockK x LD
  bf16* sV = sK + 2 * kBlockK * LD;              // 2 stages x kBlockK x LD

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int q0 = qt * kBlockQ;
  const int off = sk - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  int nkt = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_q = min(q0 + kBlockQ, sq) - 1 + off;
    nkt = min(nkt, last_q / kBlockK + 1);
  }

  load_tile<kBlockQ, D>(sQ, qb, qs.s, q0, sq);
  load_tile<kBlockK, D>(sK, kb, ks.s, 0, sk);
  load_tile<kBlockK, D>(sV, vb, vs.s, 0, sk);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum
  const int row_a = q0 + warp * 16 + g;

  for (int kt = 0; kt < nkt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nkt) {
      load_tile<kBlockK, D>(sK + (stage ^ 1) * kBlockK * LD, kb, ks.s,
                            (kt + 1) * kBlockK, sk);
      load_tile<kBlockK, D>(sV + (stage ^ 1) * kBlockK * LD, vb, vs.s,
                            (kt + 1) * kBlockK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);
    }
    const bf16* sKs = sK + stage * kBlockK * LD;
    const bf16* sVs = sV + stage * kBlockK * LD;

    // s = q k^T over this key tile
    float s[kBlockK / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kBlockK / 16; ++n2) {
        uint32_t bfr[4];
        load_b_rows(bfr, sKs, LD, n2 * 16, kk * 16, lane);
        mma16816(s[2 * n2], qf[kk], bfr[0], bfr[1]);
        mma16816(s[2 * n2 + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale in fp32, mask, online softmax
    const int k0 = kt * kBlockK;
    const bool need_mask =
        k0 + kBlockK > sk || (causal && k0 + kBlockK - 1 > q0 + off);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if (need_mask) {
          const int row = row_a + (i >> 1) * 8;
          const int col = k0 + n * 8 + 2 * t + (i & 1);
          if (col >= sk || (causal && !causal_keep(row, col, off)))
            x = kNegInf;
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - m_r[i >> 1]);
        s[n][i] = p;
        l_r[i >> 1] += p;
      }
    }

    // o += bf16(p) v
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t bfr[4];
        load_b_cols(bfr, sVs, LD, kk * 16, d2 * 16, lane);
        mma16816(o[2 * d2], a, bfr[0], bfr[1]);
        mma16816(o[2 * d2 + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

  // normalise, write out and the logsumexp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    const int row = row_a + r * 8;
    if (row < sq) {
      bf16* orow = out + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if (t == 0) lse[(long long)bh * sq + row] = m_r[r] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int nh, int sq, int sk, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr int smem = (kBlockQ + 4 * kBlockK) * LD * sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * nh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), nh, sq, sk, qs, ks, vs, os, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. q (b, sq, h, d), k and v (b, sk, h, d), out
// (b, sq, h, d), all bf16 with a contiguous head dim and the given
// element strides; lse (b, h, sq) fp32 contiguous. Launches on `stream`
// without synchronising; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int nh, int sq, int sk, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, float scale, void* stream) {
  if (batch < 1 || nh < 1 || sq < 1 || sk < 1 || batch * nh > 65535 ||
      (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(q, k, v, out, lse, batch, nh, sq, sk, qs, ks, vs, os,
                     causal, scale, s);
  else if (d == 128)
    err = launch<128>(q, k, v, out, lse, batch, nh, sq, sk, qs, ks, vs, os,
                      causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
