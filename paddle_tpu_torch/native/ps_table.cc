// Host-RAM sparse parameter table: the parameter-server analog of the
// PyTorch port (`paddle_tpu_torch/ps`), a copy of the JAX package's
// `native/ps_table.cc` (the port builds nothing of the JAX package).
//
// Reference: the-one-PS (`paddle/fluid/distributed/ps/` —
// brpc_ps_server.h / brpc_ps_client.h, table/memory_sparse_table.cc):
// CTR-scale embedding tables live in server RAM, workers pull rows by
// id, push gradients, and the server applies a sparse optimizer.
//
// A sharded open-addressing store with lazy, deterministically-seeded
// row init, SGD/AdaGrad apply, and binary snapshots. Duplicate ids in
// one push accumulate exactly (shard-serial apply), matching the
// reference's MergeAdd semantics. The fleet KV tier stores its byte
// blobs in the same rows (`SparseTable.put_bytes`).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread, at first use, into
// paddle_tpu_torch/_build/ (`paddle_tpu_torch/native/__init__.py`); a
// pure-numpy fallback in python mirrors the semantics bit-for-bit minus
// threading.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: deterministic per-(table_seed, id, column) init stream
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

inline float uniform01(uint64_t bits) {
  return static_cast<float>(bits >> 11) * (1.0f / 9007199254740992.0f);
}

struct Shard {
  std::unordered_map<int64_t, size_t> index;  // id -> row offset
  std::vector<float> rows;  // row = dim weights + dim accumulators
  std::mutex mu;
};

struct Table {
  int64_t dim;
  float init_std;
  uint64_t seed;
  int n_shards;
  std::vector<Shard> shards;
};

inline int shard_of(const Table* t, int64_t id) {
  return static_cast<int>(splitmix64(static_cast<uint64_t>(id)) %
                          static_cast<uint64_t>(t->n_shards));
}

// find-or-create WITHOUT init (restore overwrites the row anyway)
float* row_of_uninit(Table* t, Shard& s, int64_t id, bool* created) {
  auto it = s.index.find(id);
  if (it != s.index.end()) {
    *created = false;
    return s.rows.data() + it->second;
  }
  size_t off = s.rows.size();
  s.rows.resize(off + 2 * t->dim, 0.0f);
  s.index.emplace(id, off);
  *created = true;
  return s.rows.data() + off;
}

// find-or-create; returns pointer to the row (weights first, then accum)
float* row_of(Table* t, Shard& s, int64_t id) {
  bool created;
  float* w = row_of_uninit(t, s, id, &created);
  if (!created) return w;
  // Box-Muller over splitmix64 streams: same id ⇒ same init, any order
  uint64_t base = splitmix64(t->seed ^ static_cast<uint64_t>(id));
  for (int64_t j = 0; j < t->dim; j += 2) {
    uint64_t a = splitmix64(base + static_cast<uint64_t>(2 * j));
    uint64_t b = splitmix64(base + static_cast<uint64_t>(2 * j + 1));
    float u1 = uniform01(a), u2 = uniform01(b);
    if (u1 < 1e-12f) u1 = 1e-12f;
    float r = std::sqrt(-2.0f * std::log(u1)) * t->init_std;
    w[j] = r * std::cos(6.28318530718f * u2);
    if (j + 1 < t->dim) w[j + 1] = r * std::sin(6.28318530718f * u2);
  }
  return w;
}

// Bucket positions by owning shard in ONE hash pass, then run shards in
// parallel (each worker touches only its buckets — no locking races with
// other workers; the shard mutex still guards against concurrent callers).
static std::vector<std::vector<int64_t>> bucket_ids(const Table* t,
                                                    const int64_t* ids,
                                                    int64_t n) {
  std::vector<std::vector<int64_t>> buckets(t->n_shards);
  for (auto& b : buckets) b.reserve(n / t->n_shards + 1);
  for (int64_t i = 0; i < n; ++i) buckets[shard_of(t, ids[i])].push_back(i);
  return buckets;
}

template <typename Fn>
static void run_sharded(Table* t, const int64_t* ids, int64_t n,
                        int n_threads, Fn per_position) {
  auto buckets = bucket_ids(t, ids, n);
  int workers = t->n_shards;
  if (n_threads > 0 && n_threads < workers) workers = n_threads;
  auto work = [&](int w, int stride) {
    for (int sh = w; sh < t->n_shards; sh += stride) {
      Shard& s = t->shards[sh];
      std::lock_guard<std::mutex> g(s.mu);
      for (int64_t i : buckets[sh]) per_position(s, i);
    }
  };
  if (workers <= 1 || n < 256) {
    work(0, 1);
    return;
  }
  std::vector<std::thread> th;
  th.reserve(workers);
  for (int w = 0; w < workers; ++w) th.emplace_back(work, w, workers);
  for (auto& x : th) x.join();
}


}  // namespace

extern "C" {

void* ptpu_ps_create(int64_t dim, float init_std, uint64_t seed,
                     int n_shards) {
  auto* t = new Table();
  t->dim = dim;
  t->init_std = init_std;
  t->seed = seed;
  t->n_shards = n_shards < 1 ? 1 : n_shards;
  t->shards = std::vector<Shard>(t->n_shards);
  return t;
}

void ptpu_ps_free(void* h) { delete static_cast<Table*>(h); }

int64_t ptpu_ps_size(void* h) {
  auto* t = static_cast<Table*>(h);
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    n += static_cast<int64_t>(s.index.size());
  }
  return n;
}

// out: (n, dim) float32.
void ptpu_ps_pull(void* h, const int64_t* ids, int64_t n, float* out,
                  int n_threads) {
  auto* t = static_cast<Table*>(h);
  run_sharded(t, ids, n, n_threads, [&](Shard& s, int64_t i) {
    const float* w_row = row_of(t, s, ids[i]);
    std::memcpy(out + i * t->dim, w_row, sizeof(float) * t->dim);
  });
}

// grads: (n, dim). mode 0 = SGD, 1 = AdaGrad (accumulator in the row's
// second half). Duplicate ids apply sequentially within their shard —
// exact accumulation, like k separate pushes.
void ptpu_ps_push(void* h, const int64_t* ids, int64_t n,
                  const float* grads, float lr, int mode, float epsilon,
                  int n_threads) {
  auto* t = static_cast<Table*>(h);
  run_sharded(t, ids, n, n_threads, [&](Shard& s, int64_t i) {
    float* w_row = row_of(t, s, ids[i]);
    float* acc = w_row + t->dim;
    const float* gr = grads + i * t->dim;
    if (mode == 1) {
      for (int64_t j = 0; j < t->dim; ++j) {
        acc[j] += gr[j] * gr[j];
        w_row[j] -= lr * gr[j] / (std::sqrt(acc[j]) + epsilon);
      }
    } else {
      for (int64_t j = 0; j < t->dim; ++j) w_row[j] -= lr * gr[j];
    }
  });
}

// Snapshot: [int64 n] then n × (int64 id, dim weights, dim accums).
// Caller provides a buffer sized ptpu_ps_snapshot_bytes(); the fill is
// CAPACITY-BOUNDED and returns the bytes actually written — rows created
// concurrently between sizing and filling are skipped, never overflowed
// (the header count is the number of records actually serialized).
int64_t ptpu_ps_snapshot_bytes(void* h) {
  auto* t = static_cast<Table*>(h);
  int64_t n = ptpu_ps_size(h);
  return static_cast<int64_t>(sizeof(int64_t)) +
         n * static_cast<int64_t>(sizeof(int64_t) +
                                  sizeof(float) * 2 * t->dim);
}

int64_t ptpu_ps_snapshot(void* h, char* buf, int64_t buf_len) {
  auto* t = static_cast<Table*>(h);
  const int64_t rec = static_cast<int64_t>(sizeof(int64_t) +
                                           sizeof(float) * 2 * t->dim);
  int64_t written = 0;
  char* p = buf + sizeof(int64_t);
  int64_t cap = (buf_len - static_cast<int64_t>(sizeof(int64_t))) / rec;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.index) {
      if (written >= cap) break;
      std::memcpy(p, &kv.first, sizeof(int64_t));
      p += sizeof(int64_t);
      std::memcpy(p, s.rows.data() + kv.second,
                  sizeof(float) * 2 * t->dim);
      p += sizeof(float) * 2 * t->dim;
      ++written;
    }
  }
  std::memcpy(buf, &written, sizeof(int64_t));
  return static_cast<int64_t>(sizeof(int64_t)) + written * rec;
}

// Serialize the rows for `ids` in snapshot record format ([id, w, acc]
// per row, count header). Missing ids get their deterministic init
// first (same as a pull would). Caller sizes out as
// 8 + n * (8 + 8*dim) bytes. Returns bytes written.
int64_t ptpu_ps_export_rows(void* h, const int64_t* ids, int64_t n,
                            char* out) {
  auto* t = static_cast<Table*>(h);
  char* p = out + sizeof(int64_t);
  std::memcpy(out, &n, sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = t->shards[shard_of(t, ids[i])];
    std::lock_guard<std::mutex> g(s.mu);
    const float* row = row_of(t, s, ids[i]);
    std::memcpy(p, &ids[i], sizeof(int64_t));
    p += sizeof(int64_t);
    std::memcpy(p, row, sizeof(float) * 2 * t->dim);
    p += sizeof(float) * 2 * t->dim;
  }
  return static_cast<int64_t>(p - out);
}

// Remove rows. Touched shards compact their row storage in ONE pass
// (bulk eviction of k rows is O(shard) total, not O(k * shard)), so a
// long-lived table with spill/eviction churn never fragments.
void ptpu_ps_erase(void* h, const int64_t* ids, int64_t n) {
  auto* t = static_cast<Table*>(h);
  const size_t rec = 2 * static_cast<size_t>(t->dim);
  auto buckets = bucket_ids(t, ids, n);
  for (int si = 0; si < t->n_shards; ++si) {
    if (buckets[si].empty()) continue;
    Shard& s = t->shards[si];
    std::lock_guard<std::mutex> g(s.mu);
    bool any = false;
    for (int64_t pos : buckets[si]) {
      any |= s.index.erase(ids[pos]) > 0;
    }
    if (!any) continue;
    std::vector<float> packed;
    packed.reserve(s.index.size() * rec);
    for (auto& kv : s.index) {
      size_t dst = packed.size();
      packed.resize(dst + rec);
      std::memcpy(packed.data() + dst, s.rows.data() + kv.second,
                  sizeof(float) * rec);
      kv.second = dst;
    }
    s.rows.swap(packed);
  }
}

void ptpu_ps_clear(void* h) {
  auto* t = static_cast<Table*>(h);
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    s.index.clear();
    s.rows.clear();
  }
}

// buf_len must cover the n records the header declares (the Python side
// validates before calling — a truncated file never reads out of bounds).
void ptpu_ps_restore(void* h, const char* buf) {
  auto* t = static_cast<Table*>(h);
  int64_t n;
  std::memcpy(&n, buf, sizeof(int64_t));
  const char* p = buf + sizeof(int64_t);
  for (int64_t i = 0; i < n; ++i) {
    int64_t id;
    std::memcpy(&id, p, sizeof(int64_t));
    p += sizeof(int64_t);
    Shard& s = t->shards[shard_of(t, id)];
    std::lock_guard<std::mutex> g(s.mu);
    bool created;
    float* w_row = row_of_uninit(t, s, id, &created);
    std::memcpy(w_row, p, sizeof(float) * 2 * t->dim);
    p += sizeof(float) * 2 * t->dim;
  }
}

}  // extern "C"
