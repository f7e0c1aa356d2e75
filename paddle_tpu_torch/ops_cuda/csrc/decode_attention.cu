// Ragged split-K flash-decode for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel `_decode_kernel` (body `_decode_inner`) in
// paddle_tpu/ops_pallas/decode_attention.py, launched there through
// pl.pallas_call by `_ragged_decode_call`. Same function: grid row b
// holds one query q[b] (nh heads of hd) and attends rows [0, len_b) of
// cache row slot_map[b] of kc/vc (S, T, nh, hd); the T rows are cut
// into num_splits splits of split_blocks chunks of block_k rows. Per
// (b, split) it emits the UNNORMALISED fp32 accumulator (B, ns, nh, hd),
// the fp32 running max m and sum-exp l (B, ns, 1, nh), and the visited
// chunk count clip(ceil((len - split_start) / block_k), 0, split_blocks)
// as int32 (B, ns). fp32 math throughout; a split with no live row gives
// m = -1e30, l = 0, acc = 0. The wrapper merges the splits.
//
// Bound on an H100 SXM: the bytes that must move, sum_b 2 * len_b * nh *
// hd * itemsize (K and V of the live rows, read once; q and the outputs
// are < 1% of that at serving shapes), over 3.35 TB/s. The arithmetic is
// 4 fp32 operations per cached element, so the kernel is bandwidth-bound
// by two orders of magnitude.
//
// What the design does about that bound:
// - It reads only live rows. A CTA loops over the rows of its split
//   below len_b and never touches a dead row (the TPU kernel copies the
//   whole last chunk and masks it; here the row mask costs nothing).
// - It fills the card. The TPU program runs one (lane, split) over all
//   heads; at GPT-small decode (B = 8, nh = 12, T = 1024, 2 splits) that
//   would be 16 CTAs on 132 SMs. Here the grid is (split, head, lane),
//   192 CTAs at that shape, and each CTA reads its own len_b and
//   slot_map[b] instead of a scalar prefetch.
// - Loads are 16 bytes a thread and coalesced: a group of G threads
//   covers one cache row (bf16 hd = 64: 128 B = 8 threads x 16 B), the
//   128 threads of a CTA cover 128 / G rows at once, and each thread
//   starts the K and V loads of kUnroll rows before it uses any of them,
//   so several loads are in flight per thread instead of a copy/compute
//   double buffer.
// - The online softmax (m, l, acc) lives in registers, one state per
//   row group; the groups merge once through shared memory at the end.
// No TMA and no wgmma: q_len = 1 gives one dot product per row and head,
// which tensor cores would not speed up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;

// 16 bytes of T widened to fp32 (both conversions are exact).
template <typename T>
struct Widen;

template <>
struct Widen<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void apply(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void apply(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 value is the high half of its fp32; the element at the
      // lower address sits in the low half of the little-endian word
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc,
                     const int* __restrict__ lengths,
                     const int* __restrict__ slot_map,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int* __restrict__ visits,
                     int t_rows, int nh, int block_k, int split_blocks,
                     float scale) {
  constexpr int kVec = Widen<T>::kElems;            // elements per 16 B
  constexpr int kVecsPerRow = HD / kVec;
  constexpr int kGroup = kVecsPerRow < 32 ? kVecsPerRow : 32;
  constexpr int kVecsPerThread = kVecsPerRow / kGroup;
  constexpr int kElemsPerThread = kVecsPerThread * kVec;
  constexpr int kRowsPerPass = kThreads / kGroup;
  static_assert(HD % kVec == 0 && kVecsPerRow % kGroup == 0, "row split");
  static_assert((kGroup & (kGroup - 1)) == 0, "group is a power of two");

  const int split = blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int num_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int grp = tid / kGroup;   // which row of a pass
  const int sub = tid % kGroup;   // which 16-byte slices of that row

  // rows past T never exist: clamping len to T changes neither the
  // attended rows nor the visit count (T is a multiple of the split)
  const int len = min(lengths[b], t_rows);
  const long long slot = slot_map[b];
  const int split_start = split * split_blocks * block_k;
  int nblk = (len - split_start + block_k - 1) / block_k;  // trunc, lax.div
  nblk = max(0, min(nblk, split_blocks));
  if (head == 0 && tid == 0) visits[b * num_splits + split] = nblk;
  const int row_end = min(len, split_start + nblk * block_k);

  float qf[kElemsPerThread];
  const T* qrow = q + ((size_t)b * nh + head) * HD;
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j)
    Widen<T>::apply(
        __ldg(reinterpret_cast<const uint4*>(qrow + (sub + j * kGroup) * kVec)),
        qf + j * kVec);

  float m = kNegInf;
  float l = 0.f;
  float acc[kElemsPerThread];
#pragma unroll
  for (int e = 0; e < kElemsPerThread; ++e) acc[e] = 0.f;

  const size_t row_stride = (size_t)nh * HD;
  const size_t lane_ofs = ((size_t)slot * t_rows * nh + head) * HD;
  const T* kbase = kc + lane_ofs;
  const T* vbase = vc + lane_ofs;

  // the trip count is uniform over the CTA (the warp shuffles below need
  // every lane); each group masks its own rows
  for (int base = split_start; base < row_end;
       base += kRowsPerPass * kUnroll) {
    uint4 kr[kUnroll][kVecsPerThread];
    uint4 vr[kUnroll][kVecsPerThread];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = base + u * kRowsPerPass + grp;
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j) {
        if (row < row_end) {
          const size_t ofs = row * row_stride + (sub + j * kGroup) * kVec;
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(kbase + ofs));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vbase + ofs));
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = base + u * kRowsPerPass + grp;
      float kf[kElemsPerThread];
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j)
        Widen<T>::apply(kr[u][j], kf + j * kVec);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e) s = fmaf(qf[e], kf[e], s);
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off, kGroup);
      if (row < row_end) {
        s *= scale;
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float pe = expf(s - m_new);
        l = l * alpha + pe;
        float vf[kElemsPerThread];
#pragma unroll
        for (int j = 0; j < kVecsPerThread; ++j)
          Widen<T>::apply(vr[u][j], vf + j * kVec);
#pragma unroll
        for (int e = 0; e < kElemsPerThread; ++e)
          acc[e] = fmaf(pe, vf[e], acc[e] * alpha);
        m = m_new;
      }
    }
  }

  // merge the row groups' online-softmax states
  __shared__ float sm_m[kRowsPerPass];
  __shared__ float sm_l[kRowsPerPass];
  __shared__ float sm_acc[kRowsPerPass][HD];
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      sm_acc[grp][(sub + j * kGroup) * kVec + e] = acc[j * kVec + e];
  __syncthreads();

  float m_all = kNegInf;
  for (int g = 0; g < kRowsPerPass; ++g) m_all = fmaxf(m_all, sm_m[g]);
  const size_t out_row = ((size_t)b * num_splits + split) * nh + head;
  for (int d = tid; d < HD; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < kRowsPerPass; ++g)
      a = fmaf(expf(sm_m[g] - m_all), sm_acc[g][d], a);
    acc_out[out_row * HD + d] = a;
  }
  if (tid == 0) {
    float lt = 0.f;
    for (int g = 0; g < kRowsPerPass; ++g)
      lt = fmaf(expf(sm_m[g] - m_all), sm_l[g], lt);
    m_out[out_row] = m_all;
    l_out[out_row] = lt;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, const void* slot_map, void* acc,
                   void* m, void* l, void* visits, dim3 grid, int t_rows,
                   int nh, int block_k, int split_blocks, float scale,
                   cudaStream_t stream) {
  ragged_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lengths),
      static_cast<const int*>(slot_map), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<int*>(visits), t_rows, nh, block_k, split_blocks, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc,
                      const void* lengths, const void* slot_map, void* acc,
                      void* m, void* l, void* visits, dim3 grid, int t_rows,
                      int nh, int block_k, int split_blocks, float scale,
                      cudaStream_t stream) {
#define PTT_HD_CASE(HD)                                                      \
  case HD:                                                                   \
    return launch<T, HD>(q, kc, vc, lengths, slot_map, acc, m, l, visits,    \
                         grid, t_rows, nh, block_k, split_blocks, scale,     \
                         stream);
  switch (hd) {
    PTT_HD_CASE(16)
    PTT_HD_CASE(32)
    PTT_HD_CASE(64)
    PTT_HD_CASE(128)
    PTT_HD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PTT_HD_CASE
}

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` without synchronising; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ragged_decode_launch(const void* q, const void* kc,
                                    const void* vc, const void* lengths,
                                    const void* slot_map, void* acc, void* m,
                                    void* l, void* visits, int batch,
                                    int slots, int t_rows, int nh, int hd,
                                    int dtype, int block_k, int num_splits,
                                    float scale, void* stream) {
  if (batch < 1 || slots < 1 || t_rows < 1 || nh < 1 || block_k < 1 ||
      num_splits < 1 || t_rows % (block_k * num_splits) != 0 ||
      batch > 65535 || nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_blocks = t_rows / (block_k * num_splits);
  const dim3 grid(num_splits, nh, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, kc, vc, lengths, slot_map, acc, m, l,
                           visits, grid, t_rows, nh, block_k, split_blocks,
                           scale, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, kc, vc, lengths, slot_map, acc, m,
                                   l, visits, grid, t_rows, nh, block_k,
                                   split_blocks, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
