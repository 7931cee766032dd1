// hnsw_builder.cpp — from-scratch HNSW graph builder + CPU search oracle.
//
// Host-side native component of valkey_search_tpu. Provides the same
// *capabilities* as the reference's modified hnswlib
// (third_party/hnswlib/hnswalg.h: addPoint :1260, searchKnn :1611,
// markDelete :1156, resizeIndex :757) but is an independent implementation
// of the Malkov & Yashunin HNSW algorithm designed to feed an accelerator:
//   - node-indexed flat arrays (level-0 links as one [cap, 2M] int32 block)
//     exportable straight into device buffers for batched beam search,
//   - capacity growth by block without relocation of per-node link vectors
//     (same motivation as the reference's ChunkedArray, hnswlib.h:259-302),
//   - deterministic level RNG seeded per index.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libhnsw.so hnsw_builder.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <utility>
#include <vector>

namespace {

using std::int32_t;
using std::size_t;
using std::uint64_t;

// ---------------------------------------------------------------------------
// distance kernels. NOTE: a naive `acc += t*t` loop does NOT vectorize
// under strict FP (the compiler may not reassociate the float reduction),
// leaving a ~4-cycle loop-carried dependency per element — it measured 5x
// slower than the explicit-SIMD form below at d=128. GCC vector extensions
// give wide lanes with programmer-specified association (reference analog:
// simsimd's hand-vectorized kernels, vectorize with the same trick).
// ---------------------------------------------------------------------------

typedef float vf8 __attribute__((vector_size(32), aligned(4)));

static inline float vf8_hsum(vf8 v) {
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += v[i];
  return s;
}

static inline float l2_sq(const float* a, const float* b, int d) {
  vf8 acc0 = {0}, acc1 = {0};
  int i = 0;
  for (; i + 16 <= d; i += 16) {
    vf8 x0, y0, x1, y1;
    std::memcpy(&x0, a + i, 32);
    std::memcpy(&y0, b + i, 32);
    std::memcpy(&x1, a + i + 8, 32);
    std::memcpy(&y1, b + i + 8, 32);
    const vf8 t0 = x0 - y0, t1 = x1 - y1;
    acc0 += t0 * t0;
    acc1 += t1 * t1;
  }
  float acc = vf8_hsum(acc0 + acc1);
  for (; i < d; ++i) {
    const float t = a[i] - b[i];
    acc += t * t;
  }
  return acc;
}

static inline float ip_dist(const float* a, const float* b, int d) {
  vf8 acc0 = {0}, acc1 = {0};
  int i = 0;
  for (; i + 16 <= d; i += 16) {
    vf8 x0, y0, x1, y1;
    std::memcpy(&x0, a + i, 32);
    std::memcpy(&y0, b + i, 32);
    std::memcpy(&x1, a + i + 8, 32);
    std::memcpy(&y1, b + i + 8, 32);
    acc0 += x0 * y0;
    acc1 += x1 * y1;
  }
  float acc = vf8_hsum(acc0 + acc1);
  for (; i < d; ++i) acc += a[i] * b[i];
  return 1.f - acc;
}

struct PairLess {  // min-heap on dist via greater<>
  bool operator()(const std::pair<float, int32_t>& a,
                  const std::pair<float, int32_t>& b) const {
    return a.first > b.first;
  }
};
struct PairGreater {  // max-heap on dist
  bool operator()(const std::pair<float, int32_t>& a,
                  const std::pair<float, int32_t>& b) const {
    return a.first < b.first;
  }
};

using MinHeap =
    std::priority_queue<std::pair<float, int32_t>,
                        std::vector<std::pair<float, int32_t>>, PairLess>;
using MaxHeap =
    std::priority_queue<std::pair<float, int32_t>,
                        std::vector<std::pair<float, int32_t>>, PairGreater>;

// Reusable visited set with epoch stamps: search_layer used to allocate
// (and zero) a cap-sized byte array per call — at 100k+ nodes that memset
// dominates insert cost. One buffer per thread, O(1) reset per search
// (hnswlib's VisitedListPool plays the same role, visited_list_pool.h).
struct VisitedBuf {
  std::vector<uint32_t> stamp;
  uint32_t epoch = 0;
  void begin(size_t cap) {
    if (stamp.size() < cap) stamp.resize(cap, 0);
    if (++epoch == 0) {
      std::fill(stamp.begin(), stamp.end(), 0u);
      epoch = 1;
    }
  }
  bool test_set(int32_t i) {
    if (stamp[i] == epoch) return true;
    stamp[i] = epoch;
    return false;
  }
};

// ---------------------------------------------------------------------------
// index
// ---------------------------------------------------------------------------

struct HnswIndex {
  int dim = 0;
  int metric = 0;  // 0 = l2 (squared), 1 = ip (1 - dot; cosine after normalize)
  int M = 16;
  // stack-buffer size for traversal scratch: covers M0 = 2*M up to M=512
  // (every sane config). FT.CREATE accepts M up to search.max-vector-m
  // (reference kMaxM), so larger M spills to per-call heap scratch
  // instead of silently truncating links.
  static constexpr int kMaxDegree = 1024;
  int M0 = 32;  // level-0 max degree = 2*M (hnswlib maxM0_)
  int ef_construction = 200;
  size_t cap = 0;
  int32_t count = 0;
  int32_t entry = -1;
  int max_level = -1;
  // instrumentation (hnswalg.h metric_hops / metric_distance_computations);
  // relaxed atomics: concurrent inserts batch their adds per walk
  std::atomic<uint64_t> hops{0};
  std::atomic<uint64_t> dist_comps{0};

  std::vector<float> vectors;       // [cap * dim]
  std::vector<int32_t> links0;      // [cap * M0], -1 padded
  std::vector<int32_t> nlinks0;     // [cap]
  std::vector<int32_t> levels;      // [cap]
  std::vector<uint8_t> deleted;     // [cap]
  // upper-level links, per node: flat [levels[n] * M], -1 padded
  std::vector<std::vector<int32_t>> upper;

  std::mt19937_64 rng;
  double mult = 0.0;  // 1/ln(M) — hnswlib mult_

  // incremental-publish support: nodes whose level-0 row changed since
  // the last export (the device mirror scatter-updates just these rows;
  // upper structures are tiny and re-export whole when touched)
  std::vector<int32_t> dirty_list;
  std::vector<uint8_t> dirty_flag;
  std::atomic<bool> upper_dirty{false};

  // -- concurrency (multi-threaded batch insert, reference hnswlib
  //    per-label link locks hnswalg.h:1260-1270) ---------------------------
  static constexpr int kStripes = 2048;
  std::unique_ptr<std::mutex[]> stripes =
      std::make_unique<std::mutex[]>(kStripes);
  std::mutex& stripe(int32_t n) { return stripes[n & (kStripes - 1)]; }
  std::mutex entry_mu;   // entry/max_level updates
  std::mutex dirty_mu;   // dirty_list appends (uncontended single-thread)
  VisitedBuf vb_main;    // visited buffer for single-threaded callers

  void mark_dirty(int32_t n) {
    std::lock_guard<std::mutex> g(dirty_mu);
    if ((size_t)n < dirty_flag.size() && !dirty_flag[n]) {
      dirty_flag[n] = 1;
      dirty_list.push_back(n);
    }
  }

  // copy a node's adjacency row into buf; under the stripe lock when
  // `locked` (concurrent build mutates rows in place)
  // buf_cap: caller's buffer capacity in elements — degree can reach
  // M0 = 2*M; traversal callers size their scratch to max(M0, kMaxDegree).
  int copy_links(int32_t n, int level, int32_t* buf, bool locked,
                 int buf_cap = kMaxDegree) {
    if (locked) {
      std::lock_guard<std::mutex> g(stripe(n));
      const int deg = std::min(degree(n, level), buf_cap);
      std::memcpy(buf, links_at(n, level), sizeof(int32_t) * deg);
      return deg;
    }
    const int deg = std::min(degree(n, level), buf_cap);
    std::memcpy(buf, links_at(n, level), sizeof(int32_t) * deg);
    return deg;
  }

  const float* vec(int32_t n) const { return vectors.data() + (size_t)n * dim; }

  float dist(const float* a, const float* b) const {
    return metric == 0 ? l2_sq(a, b, dim) : ip_dist(a, b, dim);
  }

  void ensure_cap(size_t need, size_t block) {
    if (need <= cap) return;
    size_t new_cap = ((need + block - 1) / block) * block;
    vectors.resize(new_cap * dim, 0.f);
    links0.resize(new_cap * M0, -1);
    nlinks0.resize(new_cap, 0);
    levels.resize(new_cap, 0);
    deleted.resize(new_cap, 0);
    upper.resize(new_cap);
    dirty_flag.resize(new_cap, 0);
    cap = new_cap;
  }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = -std::log(std::max(u(rng), 1e-300)) * mult;
    return (int)r;
  }

  int32_t* links_at(int32_t n, int level) {
    if (level == 0) return links0.data() + (size_t)n * M0;
    return upper[n].data() + (size_t)(level - 1) * M;
  }
  const int32_t* links_at(int32_t n, int level) const {
    if (level == 0) return links0.data() + (size_t)n * M0;
    return upper[n].data() + (size_t)(level - 1) * M;
  }
  int degree_cap(int level) const { return level == 0 ? M0 : M; }

  int degree(int32_t n, int level) const {
    if (level == 0) return nlinks0[n];
    const int32_t* l = links_at(n, level);
    int c = 0;
    while (c < M && l[c] >= 0) ++c;
    return c;
  }

  void set_links(int32_t n, int level, const std::vector<int32_t>& ids) {
    int32_t* l = links_at(n, level);
    const int capd = degree_cap(level);
    int c = (int)std::min<size_t>(ids.size(), capd);
    for (int i = 0; i < c; ++i) l[i] = ids[i];
    for (int i = c; i < capd; ++i) l[i] = -1;
    if (level == 0) {
      nlinks0[n] = c;
      mark_dirty(n);
    } else {
      upper_dirty = true;
    }
  }

  // Greedy descent at one level: move to the best-improving neighbor until
  // local minimum (reference hnswalg.h searchKnn upper-layer loop).
  int32_t greedy_descend(const float* q, int32_t start, int level,
                         float* out_d, bool locked = false) {
    int32_t cur = start;
    float cur_d = dist(q, vec(cur));
    uint64_t dc = 1, hp = 0;
    int32_t sbuf[kMaxDegree];
    std::vector<int32_t> hbuf;  // spill for M0 > kMaxDegree configs
    const int bufcap = std::max(M0, (int)kMaxDegree);
    int32_t* lbuf = sbuf;
    if (M0 > kMaxDegree) { hbuf.resize(bufcap); lbuf = hbuf.data(); }
    bool changed = true;
    while (changed) {
      changed = false;
      const int deg = copy_links(cur, level, lbuf, locked, bufcap);
      for (int i = 0; i < deg; ++i) __builtin_prefetch(vec(lbuf[i]));
      for (int i = 0; i < deg; ++i) {
        const int32_t nb = lbuf[i];
        const float d = dist(q, vec(nb));
        ++dc;
        if (d < cur_d) {
          cur_d = d;
          cur = nb;
          changed = true;
        }
      }
      ++hp;
    }
    dist_comps.fetch_add(dc, std::memory_order_relaxed);
    hops.fetch_add(hp, std::memory_order_relaxed);
    *out_d = cur_d;
    return cur;
  }

  // ef-bounded best-first search at one level (reference searchBaseLayer /
  // searchBaseLayerST). Returns a max-heap of up to ef (dist, node).
  // skip_deleted: exclude tombstoned nodes from results (still traversed).
  MaxHeap search_layer(const float* q, int32_t entry_node, int level, int ef,
                       bool skip_deleted, VisitedBuf* vbp = nullptr,
                       bool locked = false) {
    MaxHeap top;       // results, bounded ef
    MinHeap cands;     // expansion frontier
    VisitedBuf& vb = vbp ? *vbp : vb_main;
    vb.begin(cap);
    uint64_t dc = 0, hp = 0;
    int32_t sbuf[kMaxDegree];
    std::vector<int32_t> hbuf;  // spill for M0 > kMaxDegree configs
    const int bufcap = std::max(M0, (int)kMaxDegree);
    int32_t* lbuf = sbuf;
    if (M0 > kMaxDegree) { hbuf.resize(bufcap); lbuf = hbuf.data(); }

    const float d0 = dist(q, vec(entry_node));
    ++dc;
    vb.test_set(entry_node);
    float lower_bound;
    if (!skip_deleted || !deleted[entry_node]) {
      top.emplace(d0, entry_node);
      lower_bound = d0;
    } else {
      lower_bound = std::numeric_limits<float>::max();
    }
    cands.emplace(d0, entry_node);

    while (!cands.empty()) {
      auto [cd, cn] = cands.top();
      if (cd > lower_bound && top.size() >= (size_t)ef) break;
      cands.pop();
      ++hp;
      const int deg = copy_links(cn, level, lbuf, locked, bufcap);
      for (int i = 0; i < deg; ++i)  // hide DRAM latency on the random
        __builtin_prefetch(vec(lbuf[i]));  // vector reads (hnswlib does
      for (int i = 0; i < deg; ++i) {      // the same with _mm_prefetch)
        const int32_t nb = lbuf[i];
        if (nb < 0 || vb.test_set(nb)) continue;
        const float d = dist(q, vec(nb));
        ++dc;
        if (top.size() < (size_t)ef || d < lower_bound) {
          cands.emplace(d, nb);
          if (!skip_deleted || !deleted[nb]) {
            top.emplace(d, nb);
            if (top.size() > (size_t)ef) top.pop();
            if (!top.empty()) lower_bound = top.top().first;
          }
        }
      }
    }
    dist_comps.fetch_add(dc, std::memory_order_relaxed);
    hops.fetch_add(hp, std::memory_order_relaxed);
    return top;
  }

  // Neighbor selection heuristic (reference hnswalg.h
  // getNeighborsByHeuristic2): scan candidates closest-first; keep one iff it
  // is closer to q than to every already-kept neighbor.
  void select_neighbors(std::vector<std::pair<float, int32_t>>& cands, int m,
                        std::vector<int32_t>* out) {
    std::sort(cands.begin(), cands.end());
    out->clear();
    for (const auto& [dq, n] : cands) {
      if ((int)out->size() >= m) break;
      bool keep = true;
      for (int32_t sel : *out) {
        const float dns = dist(vec(n), vec(sel));
        dist_comps.fetch_add(1, std::memory_order_relaxed);
        if (dns < dq) {
          keep = false;
          break;
        }
      }
      if (keep) out->push_back(n);
    }
  }

  void connect(int32_t node, int level, const std::vector<int32_t>& nbrs,
               bool locked = false) {
    if (locked) {
      std::lock_guard<std::mutex> g(stripe(node));
      set_links(node, level, nbrs);
    } else {
      set_links(node, level, nbrs);
    }
    const int capd = degree_cap(level);
    std::vector<std::pair<float, int32_t>> merged;
    std::vector<int32_t> pruned;
    for (int32_t nb : nbrs) {
      // per-neighbor critical section (one stripe at a time — no nested
      // locks, so no deadlock): append or overflow-re-select in place
      std::unique_lock<std::mutex> g;
      if (locked) g = std::unique_lock<std::mutex>(stripe(nb));
      int32_t* l = links_at(nb, level);
      int deg = degree(nb, level);
      if (deg < capd) {
        l[deg] = node;
        if (level == 0) {
          nlinks0[nb] = deg + 1;
          mark_dirty(nb);
        } else {
          upper_dirty = true;
        }
        continue;
      }
      // overflow: re-select nb's neighbor list including the new node
      merged.clear();
      const float dn = dist(vec(nb), vec(node));
      dist_comps.fetch_add(1, std::memory_order_relaxed);
      merged.emplace_back(dn, node);
      for (int i = 0; i < deg; ++i) {
        merged.emplace_back(dist(vec(nb), vec(l[i])), l[i]);
        dist_comps.fetch_add(1, std::memory_order_relaxed);
      }
      select_neighbors(merged, capd, &pruned);
      set_links(nb, level, pruned);
    }
  }

  // Device-seeded insert: the caller supplies the level-0 candidate pool
  // (exact top-k of v against every node id < this one, computed by the
  // device's fused scan) so the expensive ef_construction beam at level 0 —
  // ~90% of hnswlib addPoint's distance computations (hnswalg.h:1260) —
  // is skipped. Exact candidates are a strict quality upgrade over the
  // approximate beam pool; upper levels (6% of nodes at M=16) still use
  // the classic descent+beam since their graphs are tiny.
  int32_t add_seeded(const float* v, const int32_t* seeds, int k_seeds) {
    ensure_cap((size_t)count + 1, 10240);
    const int32_t node = count++;
    std::memcpy(vectors.data() + (size_t)node * dim, v,
                sizeof(float) * dim);
    const int level = random_level();
    levels[node] = level;
    mark_dirty(node);
    if (level > 0) {
      upper[node].assign((size_t)level * M, -1);
      upper_dirty = true;
    }

    if (entry < 0) {
      entry = node;
      max_level = level;
      upper_dirty = true;
      return node;
    }

    // upper levels: classic greedy descent + beam (rare nodes only)
    int32_t cur = entry;
    if (level < max_level) {
      float cd;
      for (int lc = max_level; lc > level; --lc)
        cur = greedy_descend(v, cur, lc, &cd);
    }
    for (int lc = std::min(level, max_level); lc >= 1; --lc) {
      MaxHeap top = search_layer(v, cur, lc, ef_construction,
                                 /*skip_deleted=*/false);
      std::vector<std::pair<float, int32_t>> cands;
      while (!top.empty()) {
        cands.push_back(top.top());
        top.pop();
      }
      std::vector<int32_t> sel;
      select_neighbors(cands, M, &sel);
      connect(node, lc, sel);
      if (!sel.empty()) cur = sel[0];
    }

    // level 0 from the seed pool
    std::vector<std::pair<float, int32_t>> cands;
    cands.reserve(k_seeds);
    for (int i = 0; i < k_seeds; ++i) {
      const int32_t s = seeds[i];
      if (s < 0 || s >= node) continue;  // invalid / not yet inserted / self
      cands.emplace_back(dist(v, vec(s)), s);
      dist_comps.fetch_add(1, std::memory_order_relaxed);
    }
    if (cands.empty()) {
      // degenerate (first nodes of an empty index): classic beam
      MaxHeap top = search_layer(v, cur, 0, ef_construction,
                                 /*skip_deleted=*/false);
      while (!top.empty()) {
        cands.push_back(top.top());
        top.pop();
      }
    } else {
      std::sort(cands.begin(), cands.end());
    }
    std::vector<int32_t> sel;
    select_neighbors(cands, M, &sel);
    connect(node, 0, sel);

    if (level > max_level) {
      max_level = level;
      entry = node;
      upper_dirty = true;
    }
    return node;
  }

  int32_t add(const float* v) {
    ensure_cap((size_t)count + 1, 10240);
    const int32_t node = count++;
    std::memcpy(vectors.data() + (size_t)node * dim, v,
                sizeof(float) * dim);
    const int level = random_level();
    levels[node] = level;
    mark_dirty(node);
    if (level > 0) {
      upper[node].assign((size_t)level * M, -1);
      upper_dirty = true;
    }

    if (entry < 0) {
      entry = node;
      max_level = level;
      upper_dirty = true;
      return node;
    }

    int32_t cur = entry;
    if (level < max_level) {
      float cd;
      for (int lc = max_level; lc > level; --lc)
        cur = greedy_descend(v, cur, lc, &cd);
    }
    for (int lc = std::min(level, max_level); lc >= 0; --lc) {
      MaxHeap top = search_layer(v, cur, lc, ef_construction,
                                 /*skip_deleted=*/false);
      std::vector<std::pair<float, int32_t>> cands;
      while (!top.empty()) {
        cands.push_back(top.top());
        top.pop();
      }
      std::vector<int32_t> sel;
      select_neighbors(cands, M, &sel);
      connect(node, lc, sel);
      if (!sel.empty()) cur = sel[0];
    }
    if (level > max_level) {
      max_level = level;
      entry = node;
    }
    return node;
  }

  // One preassigned node's insertion under the concurrent-build protocol:
  // adjacency reads/writes go through the stripe locks, entry/max_level
  // through entry_mu (reference: thread-safe addPoint with per-label
  // locks + global lock, hnswalg.h:1260-1270).
  void insert_prepared(int32_t node, VisitedBuf* vb) {
    const float* v = vec(node);
    const int level = levels[node];
    int32_t cur;
    int start_level;
    {
      std::lock_guard<std::mutex> g(entry_mu);
      cur = entry;
      start_level = max_level;
    }
    if (cur < 0 || cur == node) return;  // seeded first node

    if (level < start_level) {
      float cd;
      for (int lc = start_level; lc > level; --lc)
        cur = greedy_descend(v, cur, lc, &cd, /*locked=*/true);
    }
    for (int lc = std::min(level, start_level); lc >= 0; --lc) {
      MaxHeap top = search_layer(v, cur, lc, ef_construction,
                                 /*skip_deleted=*/false, vb,
                                 /*locked=*/true);
      std::vector<std::pair<float, int32_t>> cands;
      while (!top.empty()) {
        cands.push_back(top.top());
        top.pop();
      }
      std::vector<int32_t> sel;
      select_neighbors(cands, M, &sel);
      connect(node, lc, sel, /*locked=*/true);
      if (!sel.empty()) cur = sel[0];
    }
    {
      std::lock_guard<std::mutex> g(entry_mu);
      if (level > max_level) {
        max_level = level;
        entry = node;
        upper_dirty = true;
      }
    }
  }

  // Parallel batch insert: slots, vectors, and levels are assigned
  // up-front under a single thread (capacity grows once — no relocation
  // races), then n_threads workers drain the batch concurrently.
  void add_batch_mt(const float* vecs, int32_t n, int n_threads,
                    int32_t* out_nodes) {
    ensure_cap((size_t)count + (size_t)n, 10240);
    const int32_t start = count;
    for (int32_t i = 0; i < n; ++i) {
      const int32_t node = start + i;
      std::memcpy(vectors.data() + (size_t)node * dim, vecs + (size_t)i * dim,
                  sizeof(float) * dim);
      const int level = random_level();
      levels[node] = level;
      if (level > 0) upper[node].assign((size_t)level * M, -1);
      mark_dirty(node);
      if (out_nodes) out_nodes[i] = node;
    }
    count += n;
    int32_t first = 0;
    if (entry < 0) {  // seed the graph with the batch's first node
      entry = start;
      max_level = levels[start];
      upper_dirty = true;
      first = 1;
    }
    if (n - first <= 0) return;
    n_threads = std::max(1, n_threads);
    std::atomic<int32_t> next{first};
    auto worker = [&]() {
      VisitedBuf vb;
      for (;;) {
        const int32_t i = next.fetch_add(1);
        if (i >= n) break;
        insert_prepared(start + i, &vb);
      }
    };
    if (n_threads == 1) {
      worker();
    } else {
      std::vector<std::thread> ts;
      ts.reserve(n_threads);
      for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
      for (auto& t : ts) t.join();
    }
  }

  // Bulk construction from a device-built pruned KNN graph (vectorized
  // M2 path, SURVEY.md §7): the device computes every node's exact top-k
  // neighbors and runs the select heuristic across all nodes in
  // parallel; the host only (a) installs the forward lists, (b) adds
  // reverse edges with overflow re-selection (hnswalg.h
  // mutuallyConnectNewElement semantics), and (c) builds the tiny upper
  // hierarchy (P(level>=1) = 1/M of nodes) with the classic beams.
  // Requires an empty index. Returns 0 on success.
  int bulk_build(const float* vecs, int32_t n, const int32_t* in_levels,
                 const int32_t* fwd_links, int m_links) {
    if (count != 0 || n <= 0) return -1;
    ensure_cap((size_t)n, 10240);
    std::memcpy(vectors.data(), vecs, sizeof(float) * (size_t)n * dim);
    count = n;
    for (int32_t v = 0; v < n; ++v) {
      const int lvl = in_levels[v];
      levels[v] = lvl;
      if (lvl > 0) upper[v].assign((size_t)lvl * M, -1);
    }

    // (a) forward level-0 lists (already heuristic-pruned on device)
    std::vector<int32_t> fl;
    for (int32_t v = 0; v < n; ++v) {
      fl.clear();
      const int32_t* row = fwd_links + (size_t)v * m_links;
      for (int i = 0; i < m_links; ++i)
        if (row[i] >= 0 && row[i] != v && row[i] < n) fl.push_back(row[i]);
      set_links(v, 0, fl);
    }

    // (b) reverse edges: u→v implies v→u unless v is full, in which case
    // v's list is re-selected with u as a candidate
    std::vector<std::pair<float, int32_t>> merged;
    std::vector<int32_t> pruned;
    for (int32_t u = 0; u < n; ++u) {
      const int32_t* lu = links_at(u, 0);
      const int du = nlinks0[u];
      for (int i = 0; i < du; ++i) {
        const int32_t v = lu[i];
        int32_t* lv = links_at(v, 0);
        const int dv = nlinks0[v];
        bool present = false;
        for (int j = 0; j < dv; ++j)
          if (lv[j] == u) { present = true; break; }
        if (present) continue;
        if (dv < M0) {
          lv[dv] = u;
          nlinks0[v] = dv + 1;
          continue;
        }
        merged.clear();
        merged.emplace_back(dist(vec(v), vec(u)), u);
        dist_comps.fetch_add(1, std::memory_order_relaxed);
        for (int j = 0; j < dv; ++j) {
          merged.emplace_back(dist(vec(v), vec(lv[j])), lv[j]);
          dist_comps.fetch_add(1, std::memory_order_relaxed);
        }
        select_neighbors(merged, M0, &pruned);
        set_links(v, 0, pruned);
      }
    }

    // (c) upper hierarchy over the ~n/M nodes with level >= 1
    int32_t up_entry = -1;
    int up_max = -1;
    for (int32_t v = 0; v < n; ++v) {
      const int lvl = levels[v];
      if (lvl <= 0) continue;
      if (up_entry < 0) {
        up_entry = v;
        up_max = lvl;
        continue;
      }
      int32_t cur = up_entry;
      float cd;
      if (lvl < up_max)
        for (int lc = up_max; lc > lvl; --lc)
          cur = greedy_descend(vec(v), cur, lc, &cd);
      for (int lc = std::min(lvl, up_max); lc >= 1; --lc) {
        MaxHeap top = search_layer(vec(v), cur, lc, ef_construction,
                                   /*skip_deleted=*/false);
        std::vector<std::pair<float, int32_t>> cands;
        while (!top.empty()) {
          cands.push_back(top.top());
          top.pop();
        }
        std::vector<int32_t> sel;
        select_neighbors(cands, M, &sel);
        connect(v, lc, sel);
        if (!sel.empty()) cur = sel[0];
      }
      if (lvl > up_max) {
        up_max = lvl;
        up_entry = v;
      }
    }
    entry = up_entry >= 0 ? up_entry : 0;
    max_level = up_max >= 0 ? up_max : 0;
    return 0;
  }

  int search(const float* q, int k, int ef, int32_t* out_ids,
             float* out_dists) {
    if (entry < 0) return 0;
    int32_t cur = entry;
    float cd;
    for (int lc = max_level; lc > 0; --lc)
      cur = greedy_descend(q, cur, lc, &cd);
    MaxHeap top = search_layer(q, cur, 0, std::max(ef, k),
                               /*skip_deleted=*/true);
    while (top.size() > (size_t)k) top.pop();
    const int n = (int)top.size();
    for (int i = n - 1; i >= 0; --i) {
      out_dists[i] = top.top().first;
      out_ids[i] = top.top().second;
      top.pop();
    }
    return n;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* hnsw_create(int dim, int metric, int M, int ef_construction,
                  uint64_t seed) {
  auto* h = new HnswIndex();
  h->dim = dim;
  h->metric = metric;
  h->M = M;
  h->M0 = 2 * M;
  h->ef_construction = ef_construction;
  h->mult = 1.0 / std::log((double)M);
  h->rng.seed(seed);
  return h;
}

void hnsw_free(void* p) { delete (HnswIndex*)p; }

int32_t hnsw_add(void* p, const float* vec) {
  return ((HnswIndex*)p)->add(vec);
}

void hnsw_add_batch_mt(void* p, const float* vecs, int32_t n, int n_threads,
                       int32_t* out_nodes) {
  ((HnswIndex*)p)->add_batch_mt(vecs, n, n_threads, out_nodes);
}

void hnsw_add_batch(void* p, const float* vecs, int32_t n, int32_t* out_nodes) {
  auto* h = (HnswIndex*)p;
  for (int32_t i = 0; i < n; ++i)
    out_nodes[i] = h->add(vecs + (size_t)i * h->dim);
}

// seeds: [n, k_seeds] node ids (device-computed exact top-k of each new
// point against all node ids below it; -1 padded). See add_seeded.
void hnsw_add_batch_seeded(void* p, const float* vecs, int32_t n,
                           const int32_t* seeds, int32_t k_seeds,
                           int32_t* out_nodes) {
  auto* h = (HnswIndex*)p;
  for (int32_t i = 0; i < n; ++i)
    out_nodes[i] = h->add_seeded(vecs + (size_t)i * h->dim,
                                 seeds + (size_t)i * k_seeds, k_seeds);
}

int hnsw_bulk_build(void* p, const float* vecs, int32_t n,
                    const int32_t* levels, const int32_t* fwd_links,
                    int32_t m_links) {
  return ((HnswIndex*)p)->bulk_build(vecs, n, levels, fwd_links, m_links);
}

// Label the level-0 connected components (undirected view of links0).
// Returns the component count; out_comp[i] = component id of node i.
// Bulk-built KNN graphs can fragment into per-cluster islands (no
// incremental long-range edges); the Python side bridges components
// with device scans until one remains.
int32_t hnsw_components(void* p, int32_t* out_comp) {
  auto* h = (HnswIndex*)p;
  const int32_t n = h->count;
  std::vector<int32_t> parent(n);
  for (int32_t i = 0; i < n; ++i) parent[i] = i;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int32_t u = 0; u < n; ++u) {
    const int32_t* l = h->links_at(u, 0);
    const int du = h->nlinks0[u];
    for (int i = 0; i < du; ++i) {
      int32_t ru = find(u), rv = find(l[i]);
      if (ru != rv) parent[ru] = rv;
    }
  }
  std::vector<int32_t> remap(n, -1);
  int32_t nc = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = find(i);
    if (remap[r] < 0) remap[r] = nc++;
    out_comp[i] = remap[r];
  }
  return nc;
}

// Force a mutual level-0 edge (connectivity bridge): append if there is
// room, otherwise replace the last (farthest, lists are kept
// closest-first) link. Never subject to heuristic pruning — bridges
// exist precisely because the heuristic would prune them.
void hnsw_add_bridge(void* p, int32_t u, int32_t v) {
  auto* h = (HnswIndex*)p;
  if (u < 0 || v < 0 || u >= h->count || v >= h->count || u == v) return;
  for (int pass = 0; pass < 2; ++pass) {
    const int32_t a = pass ? v : u;
    const int32_t b = pass ? u : v;
    int32_t* l = h->links_at(a, 0);
    const int deg = h->nlinks0[a];
    bool present = false;
    for (int i = 0; i < deg; ++i)
      if (l[i] == b) { present = true; break; }
    if (present) continue;
    if (deg < h->M0) {
      l[deg] = b;
      h->nlinks0[a] = deg + 1;
    } else {
      l[h->M0 - 1] = b;
    }
    h->mark_dirty(a);
  }
}

void hnsw_mark_deleted(void* p, int32_t node, int flag) {
  auto* h = (HnswIndex*)p;
  if (node >= 0 && node < h->count) {
    h->deleted[node] = (uint8_t)(flag != 0);
    h->mark_dirty(node);
  }
}

int32_t hnsw_dirty_count(void* p) {
  return (int32_t)((HnswIndex*)p)->dirty_list.size();
}

int hnsw_upper_dirty(void* p) {
  return ((HnswIndex*)p)->upper_dirty ? 1 : 0;
}

// Export the changed level-0 rows (ids + links + deleted flag) and clear
// the dirty set. out_links is [dirty_count, M0]; returns count written.
int32_t hnsw_export_dirty(void* p, int32_t* out_nodes, int32_t* out_links,
                          uint8_t* out_deleted) {
  auto* h = (HnswIndex*)p;
  const int32_t n = (int32_t)h->dirty_list.size();
  for (int32_t i = 0; i < n; ++i) {
    const int32_t nd = h->dirty_list[i];
    out_nodes[i] = nd;
    std::memcpy(out_links + (size_t)i * h->M0,
                h->links0.data() + (size_t)nd * h->M0,
                sizeof(int32_t) * h->M0);
    out_deleted[i] = h->deleted[nd];
    h->dirty_flag[nd] = 0;
  }
  h->dirty_list.clear();
  h->upper_dirty = false;
  return n;
}

void hnsw_clear_dirty(void* p) {
  auto* h = (HnswIndex*)p;
  for (int32_t nd : h->dirty_list) h->dirty_flag[nd] = 0;
  h->dirty_list.clear();
  h->upper_dirty = false;
}

int hnsw_search(void* p, const float* q, int k, int ef, int32_t* out_ids,
                float* out_dists) {
  return ((HnswIndex*)p)->search(q, k, ef, out_ids, out_dists);
}

int32_t hnsw_count(void* p) { return ((HnswIndex*)p)->count; }

// Resident bytes of the builder's graph state (vectors + links + aux) for
// the engine's memory accounting (reference counts every module byte via
// malloc interposition, vmsdk memory_allocation_overrides.h).
int64_t hnsw_bytes(void* p) {
  auto* ix = (HnswIndex*)p;
  int64_t b = 0;
  b += (int64_t)ix->vectors.capacity() * sizeof(float);
  b += (int64_t)ix->links0.capacity() * sizeof(int32_t);
  b += (int64_t)ix->nlinks0.capacity() * sizeof(int32_t);
  b += (int64_t)ix->levels.capacity() * sizeof(int32_t);
  b += (int64_t)ix->deleted.capacity();
  b += (int64_t)ix->dirty_flag.capacity();
  b += (int64_t)ix->dirty_list.capacity() * sizeof(int32_t);
  for (const auto& u : ix->upper)
    b += (int64_t)u.capacity() * sizeof(int32_t) + (u.empty() ? 0 : 24);
  return b;
}
int32_t hnsw_entry(void* p) { return ((HnswIndex*)p)->entry; }
int hnsw_max_level(void* p) { return ((HnswIndex*)p)->max_level; }
uint64_t hnsw_dist_comps(void* p) { return ((HnswIndex*)p)->dist_comps; }
uint64_t hnsw_hops(void* p) { return ((HnswIndex*)p)->hops; }

// Graph export for device upload: level-0 links [count, 2M] (-1 padded),
// per-node levels [count], deleted flags [count].
void hnsw_export_links0(void* p, int32_t* out) {
  auto* h = (HnswIndex*)p;
  std::memcpy(out, h->links0.data(),
              sizeof(int32_t) * (size_t)h->count * h->M0);
}
void hnsw_export_levels(void* p, int32_t* out) {
  auto* h = (HnswIndex*)p;
  std::memcpy(out, h->levels.data(), sizeof(int32_t) * h->count);
}
void hnsw_export_deleted(void* p, uint8_t* out) {
  auto* h = (HnswIndex*)p;
  std::memcpy(out, h->deleted.data(), sizeof(uint8_t) * h->count);
}
// Upper-level links for level l (1-based): caller provides
// out_links [n_at_level, M]; out_nodes receives the node ids. Returns count.
int32_t hnsw_export_upper(void* p, int level, int32_t* out_nodes,
                          int32_t* out_links) {
  auto* h = (HnswIndex*)p;
  int32_t c = 0;
  for (int32_t n = 0; n < h->count; ++n) {
    if (h->levels[n] >= level) {
      out_nodes[c] = n;
      std::memcpy(out_links + (size_t)c * h->M, h->links_at(n, level),
                  sizeof(int32_t) * h->M);
      ++c;
    }
  }
  return c;
}
int32_t hnsw_count_at_level(void* p, int level) {
  auto* h = (HnswIndex*)p;
  int32_t c = 0;
  for (int32_t n = 0; n < h->count; ++n)
    if (h->levels[n] >= level) ++c;
  return c;
}

// Checkpoint import: rebuild builder state from exported arrays (the
// equivalent of the reference's hnswlib LoadIndex, hnswalg.h:885, including
// basic structural validation — loadCheck :104).
// Returns 0 on success, negative error code on validation failure.
int hnsw_import(void* p, int32_t count, const float* vectors,
                const int32_t* links0, const int32_t* levels,
                const uint8_t* deleted, const int32_t* upper_flat,
                const int64_t* upper_offsets, int32_t entry, int max_level) {
  auto* h = (HnswIndex*)p;
  if (count < 0) return -1;
  if (count > 0 && (entry < 0 || entry >= count)) return -2;
  h->ensure_cap((size_t)count, 10240);
  h->count = count;
  h->entry = entry;
  h->max_level = max_level;
  std::memcpy(h->vectors.data(), vectors, sizeof(float) * (size_t)count * h->dim);
  std::memcpy(h->links0.data(), links0,
              sizeof(int32_t) * (size_t)count * h->M0);
  std::memcpy(h->levels.data(), levels, sizeof(int32_t) * count);
  std::memcpy(h->deleted.data(), deleted, sizeof(uint8_t) * count);
  for (int32_t n = 0; n < count; ++n) {
    int c = 0;
    const int32_t* l = h->links0.data() + (size_t)n * h->M0;
    while (c < h->M0 && l[c] >= 0) {
      if (l[c] >= count) return -3;  // dangling link → corrupt
      ++c;
    }
    h->nlinks0[n] = c;
    const int lev = h->levels[n];
    if (lev > 0) {
      const int64_t off = upper_offsets[n];
      h->upper[n].assign(upper_flat + off, upper_flat + off + (size_t)lev * h->M);
      for (int32_t u : h->upper[n])
        if (u >= count) return -3;
    } else {
      h->upper[n].clear();
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CPU brute-force exact k-NN (the reference's BruteforceSearch equivalent,
// third_party/hnswlib/bruteforce.h) — used as the single-host CPU baseline
// in bench.py and for small-set rescoring.
// ---------------------------------------------------------------------------

void bf_topk(const float* corpus, int32_t n, int dim, const float* q, int k,
             int metric, int32_t* out_ids, float* out_dists) {
  MaxHeap heap;
  for (int32_t i = 0; i < n; ++i) {
    const float* v = corpus + (size_t)i * dim;
    const float d = metric == 0 ? l2_sq(q, v, dim) : ip_dist(q, v, dim);
    if ((int)heap.size() < k) {
      heap.emplace(d, i);
    } else if (d < heap.top().first) {
      heap.pop();
      heap.emplace(d, i);
    }
  }
  const int m = (int)heap.size();
  for (int i = m - 1; i >= 0; --i) {
    out_dists[i] = heap.top().first;
    out_ids[i] = heap.top().second;
    heap.pop();
  }
  for (int i = m; i < k; ++i) {
    out_ids[i] = -1;
    out_dists[i] = std::numeric_limits<float>::infinity();
  }
}

}  // extern "C"
