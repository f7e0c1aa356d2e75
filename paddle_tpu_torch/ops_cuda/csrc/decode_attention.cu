// Ragged split-K flash-decode for Hopper (sm_90a): kernels K1, K4, K5
// and K6 of the port, one body with two seams.
//
// Replaces the TPU kernels of paddle_tpu/ops_pallas/decode_attention.py,
// which share the body `_decode_inner` and differ in the same two seams:
//   K1 `_decode_kernel`              slotted addressing, fp32/bf16 rows
//   K4 `_paged_decode_kernel`        paged addressing,   fp32/bf16 rows
//   K5 `_decode_kernel_quant`        slotted addressing, int8 rows + scales
//   K6 `_paged_decode_kernel_quant`  paged addressing,   int8 rows + scales
// (launched there through pl.pallas_call by `_ragged_decode_call` and
// `_paged_ragged_call`).
//
// Function: grid row b holds one query q[b] (nh heads of hd) and attends
// sequence rows [0, len_b); the output is the normalised attention in
// q's dtype (B, nh, hd). fp32 math throughout. The reference cuts the T =
// t_rows rows into num_splits splits of block_k-row chunks, emits per
// split an unnormalised partial and merges them outside (`_merge_splits`);
// here the merge happens inside the launch. With `visits` the kernel
// also writes the reference's visited chunk counts for its (block_k,
// num_splits), clip(ceil((len - split_start) / block_k), 0,
// split_blocks) as int32 (B, num_splits).
//
// Addressing seam (the JAX `dma_src`), a template parameter:
// - slotted: sequence row r of grid row b is row r of cache row
//   slot_map[b] of kc/vc (S, T, nh, hd);
// - paged: it is row r % page of page tables[b, r / page] of the pools
//   kp/vp (num_pages, page, nh, hd). Rows are addressed one by one, so a
//   chunk never needs to sit in one page; the wrapper still requires
//   block_k | page, as the reference does.
// Storage seam: fp32/bf16 rows widen exactly to fp32. int8 rows carry 16
// codes per 16-byte load, and each (row, head) has its own f32 scale in
// a (..., nh) array laid out like the rows' leading axes; a code widens
// as float(code) * scale, in fp32, before any softmax math (the TPU
// kernel's widen point). Nothing is rounded to bf16 there.
//
// Bound on an H100 SXM: the bytes that must move, sum_b 2 * len_b * nh *
// (hd * itemsize [+ 4 for an int8 row's scale]) (K and V of the live
// rows, read once; q, the output and the page tables are < 1% of that
// at serving shapes), over 3.35 TB/s. The arithmetic is 4 fp32
// operations per (row, head, d) of K and V (6 with the two dequantising
// multiplies), so the kernel is bandwidth-bound by two orders of
// magnitude; at serving sizes (a few MB) its time is latency: the number
// of dependent load rounds of the longest (lane, head).
//
// What the design does about it:
// - It reads only live rows. A CTA loops over the rows of its range
//   below len_b and never touches a dead row (the TPU kernel copies the
//   whole last chunk and masks it; here the row mask costs nothing), so
//   a NaN in a dead row or on the paged layout's trash page cannot reach
//   the output.
// - It cuts each (lane, head) into C = min(8, max(1, T / 128)) CTAs of a
//   fixed range of ceil(T / C) rows (`cluster_size` in the wrapper), a
//   function of T alone: not of the lengths, which live on the device,
//   nor of the addressing or of block_k. So a paged and a slotted launch
//   over the same rows, a speculative virtual lane and the plain step,
//   and a lane served alone or in a batch give the same bits. At
//   GPT-small decode (B = 8, nh = 12, T = 1024) the grid is (8, 12, 8) =
//   768 CTAs and no CTA walks more than 128 rows (a grid of the
//   reference's 2 splits has 192 CTAs, and the longest lane's two walk
//   up to 512 rows each while the short lanes' CTAs sit idle). A CTA
//   whose range starts at or past len_b holds the empty state (m =
//   -1e30, l = 0, acc = 0).
// - The C CTAs of one (lane, head) form a thread-block cluster, and the
//   merge runs inside it: each CTA folds its rows into (m, l, acc) in its
//   own shared memory; after a cluster barrier rank 0 reads its peers'
//   states through distributed shared memory, merges them in rank order
//   (deterministic), normalises and writes the output in q's dtype. A
//   second cluster barrier keeps every peer's shared memory alive until
//   rank 0 has read it. One launch and one output allocation per call:
//   no partials in device memory and no PyTorch kernels for the merge.
// - Loads are 16 bytes a thread and coalesced: a group of G threads
//   covers one cache row (bf16 hd = 64: 128 B = 8 threads x 16 B; int8
//   hd = 64: 64 B = 4 threads), the 128 threads of a CTA cover 128 / G
//   rows at once, and each thread starts the K and V loads (and scales)
//   of kUnroll rows before it uses any of them, so several loads are in
//   flight per thread instead of a copy/compute double buffer.
//   A TMA ring of (rows, 1 head, hd) boxes on mbarriers was tried in
//   their place and measured 7-12% slower at GPT-small's decode shapes
//   (PERF.md: each CTA walks at most 128 rows, two load rounds).
// - The online softmax (m, l, acc) lives in registers, one state per
//   row group; the groups merge through shared memory into the CTA's.
// No wgmma: q_len = 1 gives one dot product per row and head, which
// tensor cores would not speed up.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;  // the portable thread-block cluster size

// 16 bytes of T widened to fp32 (exact for every T).
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

template <>
struct Widen<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static void apply(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // the lowest address in the low byte
        out[4 * i + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// TQ: the query's and the output's type (fp32 or bf16). TKV: the cache's
// storage (TQ itself, or int8 codes with f32 scales). kPaged: the
// addressing seam. Grid (C, nh, B) in clusters of (C, 1, 1).
template <typename TQ, typename TKV, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
              const TKV* __restrict__ vc, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths,
              const int* __restrict__ index,  // slot_map (B,) or tables (B, P)
              TQ* __restrict__ out, int* __restrict__ visits, int t_rows,
              int nh, int range_rows, int block_k,
              int split_blocks, int num_splits, int page_size, int max_pages,
              float scale) {
  namespace cg = cooperative_groups;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kVec = Widen<TKV>::kElems;          // elements per 16 B
  constexpr int kVecsPerRow = HD / kVec;
  constexpr int kGroup = kVecsPerRow < 32 ? kVecsPerRow : 32;
  constexpr int kVecsPerThread = kVecsPerRow / kGroup;
  constexpr int kElemsPerThread = kVecsPerThread * kVec;
  constexpr int kRowsPerPass = kThreads / kGroup;
  static_assert(HD % kVec == 0 && kVecsPerRow % kGroup == 0, "row split");
  static_assert((kGroup & (kGroup - 1)) == 0, "group is a power of two");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;   // == the rank in the cluster (C, 1, 1)
  const int nranks = gridDim.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int grp = tid / kGroup;   // which row of a pass
  const int sub = tid % kGroup;   // which 16-byte slices of that row

  // rows past T never exist: clamping len to T changes neither the
  // attended rows nor the visit count (T is a multiple of the split)
  const int len = min(lengths[b], t_rows);
  // the lane's stripe (slotted), read beside its length: both gate the
  // first row loads, so neither waits on the other
  const size_t lane_row0 = kPaged ? 0 : (size_t)index[b] * t_rows;
  // this CTA's fixed range of rows, cut to the live ones
  const int row_start = rank * range_rows;
  const int row_end = min(len, row_start + range_rows);

  // the addressing seam: sequence row r -> row of the slab or pool,
  // counted from `kbase` (slotted: the lane's stripe, paged: the pool)
  const int* table = index + (size_t)b * max_pages;
  const size_t row_stride = (size_t)nh * HD;
  const TKV* kbase = kc + (lane_row0 * nh + head) * HD;
  const TKV* vbase = vc + (lane_row0 * nh + head) * HD;
  const float* ksbase = kQuant ? k_scale + lane_row0 * nh + head : nullptr;
  const float* vsbase = kQuant ? v_scale + lane_row0 * nh + head : nullptr;
  auto seq_row = [&](int r) -> size_t {
    if constexpr (kPaged)
      return (size_t)__ldg(table + r / page_size) * page_size +
             r % page_size;
    else
      return r;
  };

  float qf[kElemsPerThread];
  const TQ* qrow = q + ((size_t)b * nh + head) * HD;
  if constexpr (std::is_same<TQ, TKV>::value) {
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
      Widen<TKV>::apply(__ldg(reinterpret_cast<const uint4*>(
                            qrow + (sub + j * kGroup) * kVec)),
                        qf + j * kVec);
  } else {
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        qf[j * kVec + e] = to_float(qrow[(sub + j * kGroup) * kVec + e]);
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kElemsPerThread];
#pragma unroll
  for (int e = 0; e < kElemsPerThread; ++e) acc[e] = 0.f;

  // fold one row into the group's online softmax; `live` is uniform over
  // the group (the shuffle needs all of it), and a dead row's values,
  // whatever they are, never enter the state
  auto fold = [&](const uint4* kr, const uint4* vr, float ks, float vs,
                  bool live) {
    float kf[kElemsPerThread];
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
      Widen<TKV>::apply(kr[j], kf + j * kVec);
    if constexpr (kQuant) {
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e) kf[e] *= ks;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kElemsPerThread; ++e) s = fmaf(qf[e], kf[e], s);
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off, kGroup);
    if (live) {
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float pe = expf(s - m_new);
      l = l * alpha + pe;
      float vf[kElemsPerThread];
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j)
        Widen<TKV>::apply(vr[j], vf + j * kVec);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < kElemsPerThread; ++e) vf[e] *= vs;
      }
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e)
        acc[e] = fmaf(pe, vf[e], acc[e] * alpha);
      m = m_new;
    }
  };

  // the trip count is uniform over the CTA (the warp shuffles need
  // every lane); each group masks its own rows
  for (int base = row_start; base < row_end;
       base += kRowsPerPass * kUnroll) {
    uint4 kr[kUnroll][kVecsPerThread];
    uint4 vr[kUnroll][kVecsPerThread];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = base + u * kRowsPerPass + grp;
      // the row offset is formed inside the guard, as K1 always did: a
      // select hoisted above it cost K1 6% alone (measured on the card)
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j) {
        if (row < row_end) {
          const size_t ofs =
              seq_row(row) * row_stride + (sub + j * kGroup) * kVec;
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(kbase + ofs));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vbase + ofs));
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if constexpr (kQuant) {
        ks[u] = row < row_end ? __ldg(ksbase + seq_row(row) * nh) : 0.f;
        vs[u] = row < row_end ? __ldg(vsbase + seq_row(row) * nh) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = base + u * kRowsPerPass + grp;
      fold(kr[u], vr[u], kQuant ? ks[u] : 0.f, kQuant ? vs[u] : 0.f,
           row < row_end);
    }
  }

  // merge the row groups' online-softmax states into the CTA's
  __shared__ float sm_m[kRowsPerPass];
  __shared__ float sm_l[kRowsPerPass];
  __shared__ float sm_acc[kRowsPerPass][HD];
  __shared__ float cta_m, cta_l;  // the CTA's state, read by rank 0
  __shared__ float cta_acc[HD];
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
  for (int d = tid; d < HD; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < kRowsPerPass; ++g)
      a = fmaf(expf(sm_m[g] - m_all), sm_acc[g][d], a);
    cta_acc[d] = a;
  }
  if (tid == 0) {
    float lt = 0.f;
    for (int g = 0; g < kRowsPerPass; ++g)
      lt = fmaf(expf(sm_m[g] - m_all), sm_l[g], lt);
    cta_m = m_all;
    cta_l = lt;
  }

  // the cluster's merge: rank 0 reads every rank's state through
  // distributed shared memory, in rank order, and writes the output
  cluster.sync();
  if (rank == 0) {
    float w[kMaxCluster], lr[kMaxCluster];  // each rank's weight and sum
    float m_star = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      w[r] = r < nranks ? *cluster.map_shared_rank(&cta_m, r) : kNegInf;
      lr[r] = r < nranks ? *cluster.map_shared_rank(&cta_l, r) : 0.f;
      m_star = fmaxf(m_star, w[r]);
    }
    float l_tot = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      w[r] = expf(w[r] - m_star);
      l_tot = r < nranks ? fmaf(w[r], lr[r], l_tot) : l_tot;
    }
    l_tot = fmaxf(l_tot, 1e-30f);
    TQ* orow = out + ((size_t)b * nh + head) * HD;
    for (int d = tid; d < HD; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < nranks) a = fmaf(w[r], cluster.map_shared_rank(cta_acc, r)[d],
                                 a);
      store(orow + d, a / l_tot);
    }
    // the reference's visited chunk counts for its (block_k, num_splits)
    if (visits != nullptr && head == 0 && tid < num_splits) {
      const int split_start = tid * split_blocks * block_k;
      const int nblk = (len - split_start + block_k - 1) / block_k;
      visits[b * num_splits + tid] = max(0, min(nblk, split_blocks));
    }
  }
  cluster.sync();  // peers' shared memory stays alive until rank 0 read it
}

struct Args {
  const void *q, *kc, *vc, *k_scale, *v_scale, *lengths, *index;
  void *out, *visits;
  int t_rows, nh, range_rows, block_k, split_blocks, num_splits, page_size,
      max_pages;
  float scale;
};

template <typename TQ, typename TKV, int HD, bool kPaged>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // one cluster per (head, lane)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, decode_kernel<TQ, TKV, HD, kPaged>,
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc),
      static_cast<const TKV*>(a.vc), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.index),
      static_cast<TQ*>(a.out), static_cast<int*>(a.visits), a.t_rows, a.nh,
      a.range_rows, a.block_k, a.split_blocks, a.num_splits, a.page_size,
      a.max_pages, a.scale);
}

template <typename TQ, typename TKV, bool kPaged>
cudaError_t launch_hd(int hd, const Args& a, dim3 grid, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16, kPaged>(a, grid, s);
    case 32: return launch<TQ, TKV, 32, kPaged>(a, grid, s);
    case 64: return launch<TQ, TKV, 64, kPaged>(a, grid, s);
    case 128: return launch<TQ, TKV, 128, kPaged>(a, grid, s);
    case 256: return launch<TQ, TKV, 256, kPaged>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPaged>
cudaError_t launch_types(int q_dtype, int kv_dtype, int hd, const Args& a,
                         dim3 grid, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_hd<float, float, kPaged>(hd, a, grid, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_hd<bf16, bf16, kPaged>(hd, a, grid, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch_hd<float, int8_t, kPaged>(hd, a, grid, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_hd<bf16, int8_t, kPaged>(hd, a, grid, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry for ctypes. Types: 0 = float32, 1 = bfloat16, 2 = int8 (the
// cache only; then k_scale/v_scale are its f32 scales). page_size = 0
// selects the slotted layout (index = slot_map (B,), kc/vc (S, t_rows,
// nh, hd)); page_size > 0 the paged one (index = tables (B, max_pages),
// kc/vc (num_pages, page_size, nh, hd), t_rows = max_pages * page_size).
// `out` (B, nh, hd) in q's type; `visits` (B, num_splits) int32 or null.
// `cluster` = C in 1..8, the CTAs per (lane, head). Launches on `stream`
// without synchronising; returns the launch's error (cudaErrorInvalidValue
// for a shape or type the kernel does not take).
extern "C" int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* k_scale,
    const void* v_scale, const void* lengths, const void* index, void* out,
    void* visits, int batch, int t_rows, int nh, int hd, int q_dtype,
    int kv_dtype, int block_k, int num_splits, int page_size, int max_pages,
    int cluster, float scale, void* stream) {
  const bool paged = page_size > 0;
  if (batch < 1 || t_rows < 1 || nh < 1 || block_k < 1 || num_splits < 1 ||
      t_rows % (block_k * num_splits) != 0 || batch > 65535 || nh > 65535 ||
      cluster < 1 || cluster > kMaxCluster ||
      (kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr) ||
      (paged && (page_size % block_k != 0 || max_pages < 1 ||
                 t_rows != max_pages * page_size)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kc, vc, k_scale, v_scale, lengths, index, out, visits,
               t_rows, nh, (t_rows + cluster - 1) / cluster, block_k,
               t_rows / (block_k * num_splits), num_splits, page_size,
               paged ? max_pages : 0, scale};
  const dim3 grid(cluster, nh, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      paged ? launch_types<true>(q_dtype, kv_dtype, hd, a, grid, s)
            : launch_types<false>(q_dtype, kv_dtype, hd, a, grid, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
