// Host input-pipeline hot paths (reference analogs: the C++ DataLoader
// core `paddle/fluid/operators/reader/buffered_reader.cc` and the data
// feed `paddle/fluid/framework/data_feed.cc` — batch assembly and
// uint8→float preprocessing ran native there, not in Python).
//
// Role: the Python-side cost that remains around the device step is
// HOST batch assembly: gathering N sample buffers into one contiguous
// batch (memcpy-bound), an embarrassingly parallel memory op —
// std::thread over slabs, no Python object traffic inside the loop.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (driven by
// native/__init__.py, cached in _build/; a failed build raises).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void run_parallel(int64_t n_items, int n_threads,
                  void (*fn)(int64_t, int64_t, void*), void* ctx) {
  if (n_threads <= 1 || n_items <= 1) {
    fn(0, n_items, ctx);
    return;
  }
  if (n_threads > n_items) n_threads = static_cast<int>(n_items);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n_items + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_items ? lo + chunk : n_items;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi, ctx);
  }
  for (auto& th : threads) th.join();
}

struct CollateCtx {
  const void* const* srcs;
  int64_t bytes_each;
  char* dst;
};

void collate_range(int64_t lo, int64_t hi, void* p) {
  auto* c = static_cast<CollateCtx*>(p);
  for (int64_t i = lo; i < hi; ++i) {
    std::memcpy(c->dst + i * c->bytes_each, c->srcs[i], c->bytes_each);
  }
}

}  // namespace

extern "C" {

// Copy n equal-sized sample buffers into contiguous dst.
void ptpu_collate(const void* const* srcs, int64_t n, int64_t bytes_each,
                  void* dst, int n_threads) {
  CollateCtx ctx{srcs, bytes_each, static_cast<char*>(dst)};
  run_parallel(n, n_threads, collate_range, &ctx);
}

}  // extern "C"
