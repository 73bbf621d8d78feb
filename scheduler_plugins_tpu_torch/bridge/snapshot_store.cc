// Native cluster-state store: the bridge tier of the framework (the
// PyTorch port's copy of the JAX package's bridge/snapshot_store.cc).
//
// The reference's cross-process feed is client-go informers hydrating Go
// object caches; here it is an event stream ("pod added/bound/deleted",
// "node upserted") applied to a compact columnar store that exports the
// scheduler's dense snapshot columns without Python object traversal.
// Host C++, built with g++ into a shared library and consumed through
// ctypes (scheduler_plugins_tpu_torch/bridge/__init__.py).
//
// Layout contract (must match api.resources.CANONICAL):
//   slot 0 = cpu (millicores), slot 1 = memory (bytes),
//   slot 2 = ephemeral-storage, slot 3 = pods (count; requested tracks the
//   number of bound pods, pod demand is 1).
// Non-zero scoring defaults mirror the upstream NonZeroRequested accounting:
// 100 millicores / 200 MiB when a pod requests nothing.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kCpu = 0;
constexpr int kMemory = 1;
constexpr int kPods = 3;
constexpr int64_t kDefaultMilliCpu = 100;
constexpr int64_t kDefaultMemory = 200LL * 1024 * 1024;

struct Pod {
  std::vector<int64_t> req;
  std::vector<int64_t> limits;  // clamped to >= req on ingest
  int64_t priority = 0;
  int64_t creation_ms = 0;
  int64_t node = -1;  // bound node id, -1 pending
  bool terminating = false;
};

struct Store {
  int R;
  // node id -> dense row index; rows are append-only per id
  std::unordered_map<int64_t, int32_t> node_pos;
  std::vector<int64_t> node_ids;
  std::vector<int64_t> alloc;       // (N * R)
  std::vector<int64_t> capacity;    // (N * R)
  std::vector<int64_t> requested;   // (N * R)
  std::vector<int64_t> nonzero;     // (N * R)
  std::vector<int64_t> limits;      // (N * R)
  std::vector<int32_t> pod_count;   // (N)
  std::vector<int32_t> terminating; // (N)
  std::unordered_map<int64_t, Pod> pods;
  // Streaming-delta export (the O(changed) bridge seam): rows whose
  // columns changed since the last drain, first-touch ordered. A drain
  // exports ONLY these rows and bumps `generation`, so a downstream
  // mirror (serve engine, remote shard) ingests O(changed) per cycle
  // instead of the O(cluster) full export. A fresh store marks every
  // row dirty as it hydrates — a new consumer's first drain is a full
  // resync by construction.
  std::vector<int32_t> dirty_rows;  // first-touch order, unique
  std::vector<uint8_t> dirty_flag;  // (N)
  int64_t generation = 0;

  explicit Store(int r) : R(r) {}

  void MarkDirty(int32_t row) {
    if (row >= static_cast<int32_t>(dirty_flag.size()))
      dirty_flag.resize(row + 1, 0);
    if (!dirty_flag[row]) {
      dirty_flag[row] = 1;
      dirty_rows.push_back(row);
    }
  }

  int32_t NodeRow(int64_t id) {
    auto it = node_pos.find(id);
    if (it != node_pos.end()) return it->second;
    int32_t row = static_cast<int32_t>(node_ids.size());
    node_pos.emplace(id, row);
    node_ids.push_back(id);
    alloc.resize(alloc.size() + R, 0);
    capacity.resize(capacity.size() + R, 0);
    requested.resize(requested.size() + R, 0);
    nonzero.resize(nonzero.size() + R, 0);
    limits.resize(limits.size() + R, 0);
    pod_count.push_back(0);
    terminating.push_back(0);
    MarkDirty(row);
    return row;
  }

  void NonZero(const int64_t* req, int64_t* out) const {
    std::memcpy(out, req, sizeof(int64_t) * R);
    if (out[kCpu] == 0) out[kCpu] = kDefaultMilliCpu;
    if (out[kMemory] == 0) out[kMemory] = kDefaultMemory;
  }

  void Apply(int32_t row, const Pod& pod, int sign) {
    MarkDirty(row);
    int64_t* rq = requested.data() + static_cast<size_t>(row) * R;
    int64_t* nz = nonzero.data() + static_cast<size_t>(row) * R;
    int64_t* lm = limits.data() + static_cast<size_t>(row) * R;
    std::vector<int64_t> nonzero_req(R);
    NonZero(pod.req.data(), nonzero_req.data());
    for (int r = 0; r < R; ++r) {
      rq[r] += sign * pod.req[r];
      nz[r] += sign * nonzero_req[r];
      lm[r] += sign * pod.limits[r];
    }
    pod_count[row] += sign;
    rq[kPods] = pod_count[row];
    nz[kPods] = pod_count[row];
    if (pod.terminating) terminating[row] += sign;
  }
};

}  // namespace

extern "C" {

void* store_new(int r) { return new Store(r); }

void store_free(void* handle) { delete static_cast<Store*>(handle); }

void store_upsert_node(void* handle, int64_t id, const int64_t* alloc,
                       const int64_t* capacity) {
  Store* s = static_cast<Store*>(handle);
  int32_t row = s->NodeRow(id);
  s->MarkDirty(row);
  std::memcpy(s->alloc.data() + static_cast<size_t>(row) * s->R, alloc,
              sizeof(int64_t) * s->R);
  std::memcpy(s->capacity.data() + static_cast<size_t>(row) * s->R, capacity,
              sizeof(int64_t) * s->R);
}

// flags bit 0: terminating
void store_upsert_pod(void* handle, int64_t id, const int64_t* req,
                      const int64_t* lim, int64_t priority,
                      int64_t creation_ms, int64_t node_id, int64_t flags) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->pods.find(id);
  if (it != s->pods.end()) {
    // remove the previous incarnation's contribution first
    if (it->second.node >= 0) {
      auto row = s->node_pos.find(it->second.node);
      if (row != s->node_pos.end()) s->Apply(row->second, it->second, -1);
    }
    s->pods.erase(it);
  }
  Pod pod;
  pod.req.assign(req, req + s->R);
  pod.limits.resize(s->R);
  for (int r = 0; r < s->R; ++r)
    pod.limits[r] = lim[r] > req[r] ? lim[r] : req[r];
  pod.priority = priority;
  pod.creation_ms = creation_ms;
  pod.node = node_id;
  pod.terminating = (flags & 1) != 0;
  if (node_id >= 0) {
    int32_t row = s->NodeRow(node_id);
    s->Apply(row, pod, +1);
  }
  s->pods.emplace(id, std::move(pod));
}

void store_bind(void* handle, int64_t pod_id, int64_t node_id) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->pods.find(pod_id);
  if (it == s->pods.end() || it->second.node >= 0) return;
  it->second.node = node_id;
  s->Apply(s->NodeRow(node_id), it->second, +1);
}

void store_delete_pod(void* handle, int64_t pod_id) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->pods.find(pod_id);
  if (it == s->pods.end()) return;
  if (it->second.node >= 0) {
    auto row = s->node_pos.find(it->second.node);
    if (row != s->node_pos.end()) s->Apply(row->second, it->second, -1);
  }
  s->pods.erase(it);
}

// Batched ingestion — the wire-protocol shape: one call applies a whole
// event batch (K nodes or K pods) without per-event FFI crossings.
void store_upsert_nodes_batch(void* handle, int64_t k, const int64_t* ids,
                              const int64_t* alloc, const int64_t* capacity) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < k; ++i) {
    int32_t row = s->NodeRow(ids[i]);
    s->MarkDirty(row);
    std::memcpy(s->alloc.data() + static_cast<size_t>(row) * s->R,
                alloc + i * s->R, sizeof(int64_t) * s->R);
    std::memcpy(s->capacity.data() + static_cast<size_t>(row) * s->R,
                capacity + i * s->R, sizeof(int64_t) * s->R);
  }
}

void store_upsert_pods_batch(void* handle, int64_t k, const int64_t* ids,
                             const int64_t* req, const int64_t* lim,
                             const int64_t* priority,
                             const int64_t* creation_ms,
                             const int64_t* node_ids, const int64_t* flags) {
  for (int64_t i = 0; i < k; ++i) {
    store_upsert_pod(handle, ids[i], req + i * static_cast<Store*>(handle)->R,
                     lim + i * static_cast<Store*>(handle)->R, priority[i],
                     creation_ms[i], node_ids[i], flags[i]);
  }
}

int64_t store_num_nodes(void* handle) {
  return static_cast<int64_t>(static_cast<Store*>(handle)->node_ids.size());
}

int64_t store_num_pending(void* handle) {
  Store* s = static_cast<Store*>(handle);
  int64_t n = 0;
  for (const auto& [id, pod] : s->pods)
    if (pod.node < 0 && !pod.terminating) ++n;
  return n;
}

// Fills caller-allocated buffers sized (num_nodes x R) / (num_nodes).
void store_export_nodes(void* handle, int64_t* ids, int64_t* alloc,
                        int64_t* capacity, int64_t* requested,
                        int64_t* nonzero, int64_t* limits, int32_t* pod_count,
                        int32_t* terminating) {
  Store* s = static_cast<Store*>(handle);
  size_t n = s->node_ids.size();
  std::memcpy(ids, s->node_ids.data(), sizeof(int64_t) * n);
  std::memcpy(alloc, s->alloc.data(), sizeof(int64_t) * n * s->R);
  std::memcpy(capacity, s->capacity.data(), sizeof(int64_t) * n * s->R);
  std::memcpy(requested, s->requested.data(), sizeof(int64_t) * n * s->R);
  std::memcpy(nonzero, s->nonzero.data(), sizeof(int64_t) * n * s->R);
  std::memcpy(limits, s->limits.data(), sizeof(int64_t) * n * s->R);
  std::memcpy(pod_count, s->pod_count.data(), sizeof(int32_t) * n);
  std::memcpy(terminating, s->terminating.data(), sizeof(int32_t) * n);
}

// -- streaming-delta export (O(changed) bridge seam) ------------------------

int64_t store_dirty_count(void* handle) {
  return static_cast<int64_t>(static_cast<Store*>(handle)->dirty_rows.size());
}

int64_t store_generation(void* handle) {
  return static_cast<Store*>(handle)->generation;
}

// Fills caller-allocated buffers sized (store_dirty_count() x R) /
// (store_dirty_count()) with ONLY the rows touched since the last drain
// (first-touch order), then clears the dirty set and bumps the
// generation. Returns the number of rows written. Single-consumer
// semantics: a drain consumes the delta window.
int64_t store_export_dirty(void* handle, int64_t* ids, int64_t* alloc,
                           int64_t* capacity, int64_t* requested,
                           int64_t* nonzero, int64_t* limits,
                           int32_t* pod_count, int32_t* terminating) {
  Store* s = static_cast<Store*>(handle);
  const size_t R = s->R;
  for (size_t i = 0; i < s->dirty_rows.size(); ++i) {
    const int32_t row = s->dirty_rows[i];
    ids[i] = s->node_ids[row];
    std::memcpy(alloc + i * R, s->alloc.data() + static_cast<size_t>(row) * R,
                sizeof(int64_t) * R);
    std::memcpy(capacity + i * R,
                s->capacity.data() + static_cast<size_t>(row) * R,
                sizeof(int64_t) * R);
    std::memcpy(requested + i * R,
                s->requested.data() + static_cast<size_t>(row) * R,
                sizeof(int64_t) * R);
    std::memcpy(nonzero + i * R,
                s->nonzero.data() + static_cast<size_t>(row) * R,
                sizeof(int64_t) * R);
    std::memcpy(limits + i * R,
                s->limits.data() + static_cast<size_t>(row) * R,
                sizeof(int64_t) * R);
    pod_count[i] = s->pod_count[row];
    terminating[i] = s->terminating[row];
    s->dirty_flag[row] = 0;
  }
  const int64_t n = static_cast<int64_t>(s->dirty_rows.size());
  s->dirty_rows.clear();
  ++s->generation;
  return n;
}

// Fills caller-allocated buffers sized (num_pending x R) / (num_pending),
// ordered by (creation_ms, id) — the default queue order.
void store_export_pending(void* handle, int64_t* ids, int64_t* req,
                          int64_t* limits, int64_t* priority,
                          int64_t* creation_ms) {
  Store* s = static_cast<Store*>(handle);
  std::vector<std::pair<int64_t, int64_t>> order;  // (creation, id)
  for (const auto& [id, pod] : s->pods)
    if (pod.node < 0 && !pod.terminating) order.emplace_back(pod.creation_ms, id);
  std::sort(order.begin(), order.end());
  for (size_t i = 0; i < order.size(); ++i) {
    const Pod& pod = s->pods.at(order[i].second);
    ids[i] = order[i].second;
    std::memcpy(req + i * s->R, pod.req.data(), sizeof(int64_t) * s->R);
    std::memcpy(limits + i * s->R, pod.limits.data(), sizeof(int64_t) * s->R);
    priority[i] = pod.priority;
    creation_ms[i] = pod.creation_ms;
  }
}

}  // extern "C"
