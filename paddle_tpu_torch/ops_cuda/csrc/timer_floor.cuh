// Yardsticks for the timer that phase 8 of chip_smoke.py reads K7 with;
// built into K7's library and never on a serving or training path.
//
// - `timer_empty_launch`: an empty kernel. Its median under the timer is
//   the timer's own floor: what a kernel that does nothing reads in the
//   same window (launch, event and cache-flush effects). With `cluster`
//   > 1 its `grid` CTAs form thread-block clusters of that size and meet
//   once at a cluster barrier: the floor of a split-k launch.
// - `timer_stream_read_launch`: a read-only stream over `bytes` bytes
//   (a multiple of 16) with 16-byte coalesced loads over a grid-stride
//   loop, four loads in flight per thread. Each thread folds its words
//   into one by XOR and stores it only if it equals a sentinel, so the
//   compiler keeps every load and the kernel writes nothing. At a K7
//   shape's weight bytes it is what a perfect GEMV could read under
//   the same timer.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace timer_floor {

__global__ void empty_kernel(int cluster) {
  if (cluster > 1) cooperative_groups::this_cluster().sync();
}

__global__ void __launch_bounds__(256)
stream_read_kernel(const uint4* __restrict__ p, long long n16,
                   unsigned* __restrict__ sink) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned acc = 0;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  for (; i + 3 * stride < n16; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(p + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; i < n16; i += stride) {
    const uint4 v = __ldg(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) *sink = acc;
}

}  // namespace timer_floor

extern "C" {

// `grid` CTAs of 32 threads in clusters of `cluster` (grid % cluster == 0)
int timer_empty_launch(int grid, int cluster, void* stream) {
  if (grid < 1 || cluster < 1 || cluster > 8 || grid % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(32, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, timer_floor::empty_kernel, cluster));
}

// p: `bytes` bytes on the device, 16-byte aligned, bytes % 16 == 0;
// sink: one unsigned on the device; `grid` CTAs of 256 threads.
int timer_stream_read_launch(const void* p, long long bytes, void* sink,
                             int grid, void* stream) {
  if (bytes < 16 || bytes % 16 || grid < 1 ||
      reinterpret_cast<uintptr_t>(p) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  timer_floor::stream_read_kernel<<<grid, 256, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), bytes / 16, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
