// Native HNSW core: multithreaded graph builder + C ABI.
//
// This is the framework's native runtime tier — the capability analog of the
// reference's Rust core (hnsw.rs) and its C FFI surface (libext.rs), re-designed
// around the same dense flat-array layout the TPU path uses, so graphs built here
// are handed to JAX zero-copy via the export_* functions.
//
// Semantics reproduced from the reference (behavior, not code):
//   * level sampling law  (src/hnsw.rs:317-386)  — floor(-ln(U)/ln(M)), seeded
//   * search_layer        (src/hnsw.rs:922-1064) — ef-capped best-first with visited set
//   * insert              (src/hnsw.rs:1066-1215)— ef=1 upper descent with projection
//                          links, per-layer construction with select_neighbours
//   * select_neighbours   (src/hnsw.rs:1299-1421)— diversity prune + keep_pruned refill
//   * reverse update      (src/hnsw.rs:1241-1289)— backlinks at l_n = new point level,
//                          dedup, sort, shrink to 2M/M
//   * search_filter       (src/hnsw.rs:1487-1599)— one-scan greedy descent + layer-0 beam
//   * parallel insert     (src/hnsw.rs:1224-1238)— thread pool over inserts with
//                          per-point locks (same benign-race contract)
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread -o libhnsw_core.so hnsw_core.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <random>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::size_t;

// ------------------------------------------------------------------ logging ---------
// Native-tier verbosity — the analog of the reference's init_rust_log / env_logger
// surface (src/libext.rs:1237-1240). 0 = silent, 1 = info, 2 = debug. Initialized
// from the C ABI (hnsw_init_log) or the HNSW_NATIVE_LOG env var on first use.

static std::atomic<int> g_log_level{-1};

static int log_level() {
  int v = g_log_level.load();
  if (v < 0) {
    const char* e = std::getenv("HNSW_NATIVE_LOG");
    v = 0;
    if (e) {
      std::string s(e);
      if (s == "info" || s == "1") v = 1;
      else if (s == "debug" || s == "trace" || s == "2") v = 2;
    }
    g_log_level.store(v);
  }
  return v;
}

#define NLOG(lvl, ...)                                      \
  do {                                                      \
    if (log_level() >= (lvl)) {                             \
      std::fprintf(stderr, "[hnsw_core] " __VA_ARGS__);     \
      std::fputc('\n', stderr);                             \
    }                                                       \
  } while (0)

// ----------------------------------------------------------------- distances --------

enum class Dist : int32_t {
  L1 = 0, L2 = 1, Cosine = 2, Dot = 3, Hamming = 4, Jaccard = 5,
  Hellinger = 6, Jeffreys = 7, JensenShannon = 8, Levenshtein = 9, Ptr = 100,
};

template <typename T>
using DistFnT = float (*)(const T*, const T*, uint64_t);
using DistFn = DistFnT<float>;

template <typename T>
static float d_l1(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) s += std::fabs(float(a[i]) - float(b[i]));
  return s;
}
template <typename T>
static float d_l2(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) { float d = float(a[i]) - float(b[i]); s += d * d; }
  return std::sqrt(s);
}
template <typename T>
static float d_dot(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) s += float(a[i]) * float(b[i]);
  return 1.0f - s;
}
template <typename T>
static float d_cos(const T* a, const T* b, uint64_t n) {
  float s = 0, na = 0, nb = 0;
  for (uint64_t i = 0; i < n; ++i) {
    float x = float(a[i]), y = float(b[i]);
    s += x * y; na += x * x; nb += y * y;
  }
  float d = std::sqrt(na) * std::sqrt(nb);
  return d > 0 ? 1.0f - s / std::max(d, 1e-10f) : 1.0f;
}
template <typename T>
static float d_ham(const T* a, const T* b, uint64_t n) {
  uint64_t c = 0;
  for (uint64_t i = 0; i < n; ++i) c += (a[i] != b[i]);
  return float(c) / float(n);
}
template <typename T>
static float d_jac(const T* a, const T* b, uint64_t n) {
  float mn = 0, mx = 0;
  for (uint64_t i = 0; i < n; ++i) {
    float x = float(a[i]), y = float(b[i]);
    mn += std::min(x, y); mx += std::max(x, y);
  }
  return mx > 0 ? 1.0f - mn / std::max(mx, 1e-10f) : 0.0f;
}
template <typename T>
static float d_hel(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) {
    float d = std::sqrt(std::max(float(a[i]), 0.0f)) - std::sqrt(std::max(float(b[i]), 0.0f));
    s += d * d;
  }
  return std::sqrt(std::max(0.5f * s, 0.0f));
}
template <typename T>
static float d_jef(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) {
    float x = std::max(float(a[i]), 1e-10f), y = std::max(float(b[i]), 1e-10f);
    s += (x - y) * (std::log(x) - std::log(y));
  }
  return s;
}
template <typename T>
static float d_js(const T* a, const T* b, uint64_t n) {
  float s = 0;
  for (uint64_t i = 0; i < n; ++i) {
    float x = float(a[i]), y = float(b[i]);
    float m = 0.5f * (x + y);
    if (x > 0) s += x * (std::log(std::max(x, 1e-10f)) - std::log(std::max(m, 1e-10f)));
    if (y > 0) s += y * (std::log(std::max(y, 1e-10f)) - std::log(std::max(m, 1e-10f)));
  }
  return std::sqrt(std::max(0.5f * s, 0.0f));
}
// Levenshtein on integer code points (reference uses u16 words,
// tests/filtertest.rs:59-65); trailing zeros are treated as padding.
template <typename T>
static float d_lev(const T* a, const T* b, uint64_t n) {
  uint64_t la = n, lb = n;
  while (la > 0 && a[la - 1] == T(0)) --la;
  while (lb > 0 && b[lb - 1] == T(0)) --lb;
  if (la == 0) return float(lb);
  if (lb == 0) return float(la);
  std::vector<uint32_t> prev(lb + 1), cur(lb + 1);
  for (uint64_t j = 0; j <= lb; ++j) prev[j] = uint32_t(j);
  for (uint64_t i = 1; i <= la; ++i) {
    cur[0] = uint32_t(i);
    for (uint64_t j = 1; j <= lb; ++j) {
      uint32_t sub = prev[j - 1] + (a[i - 1] != b[j - 1]);
      cur[j] = std::min({sub, prev[j] + 1, cur[j - 1] + 1});
    }
    std::swap(prev, cur);
  }
  return float(prev[lb]);
}

template <typename T>
static DistFnT<T> dist_table(Dist d) {
  switch (d) {
    case Dist::L1: return d_l1<T>;
    case Dist::L2: return d_l2<T>;
    case Dist::Cosine: return d_cos<T>;
    case Dist::Dot: return d_dot<T>;
    case Dist::Hamming: return d_ham<T>;
    case Dist::Jaccard: return d_jac<T>;
    case Dist::Hellinger: return d_hel<T>;
    case Dist::Jeffreys: return d_jef<T>;
    case Dist::JensenShannon: return d_js<T>;
    case Dist::Levenshtein: return d_lev<T>;
    default: return d_l2<T>;
  }
}

// -------------------------------------------------------------------- index ---------

struct Link { float dist; int32_t id; };
static bool link_lt(const Link& a, const Link& b) { return a.dist < b.dist; }

// Stamped visited set: O(1) insert/query with no hashing or per-search allocation
// (epoch bump invalidates the whole table). One per thread.
struct Visited {
  std::vector<uint32_t> stamp;
  uint32_t epoch = 0;
  void begin(size_t need) {
    if (stamp.size() < need) stamp.resize(need, 0);
    if (++epoch == 0) { std::fill(stamp.begin(), stamp.end(), 0); epoch = 1; }
  }
  bool insert(int32_t i) {
    if (stamp[i] == epoch) return false;
    stamp[i] = epoch;
    return true;
  }
};
static thread_local Visited tl_visited;
static thread_local Visited tl_visited2;

struct Point {
  std::vector<std::vector<Link>> nbrs;  // one list per layer 0..max_layer-1
  mutable std::mutex lock;
};

template <typename T>
struct Index {
  // config
  uint64_t M, efc, max_layer;
  Dist dist_kind;
  DistFnT<T> dist;
  uint64_t dim = 0;
  bool extend_candidates = false, keep_pruned = false;
  // storage
  std::vector<T> data;           // [n, dim]
  std::vector<int64_t> origin;   // external ids
  std::vector<int32_t> level;
  std::vector<int32_t> rank;
  std::deque<Point> points;      // deque: rows never relocate (they hold mutexes)
  std::vector<int64_t> layer_counts;  // points with level == l
  std::atomic<int64_t> entry{-1};
  std::atomic<int64_t> n{0};
  size_t capacity;
  // level sampling (deterministic, seed 397 like the reference's LayerGenerator)
  std::mt19937_64 rng{397};
  double scale;
  std::mutex alloc_lock;
  mutable std::shared_mutex entry_lock;

  Index(uint64_t M_, uint64_t efc_, uint64_t cap, uint64_t max_layer_, Dist dk)
      : M(M_), efc(efc_), max_layer(std::min<uint64_t>(max_layer_, 16)),
        dist_kind(dk), dist(dist_table<T>(dk)), capacity(std::max<uint64_t>(cap, 16)) {
    scale = 1.0 / std::log(double(std::max<uint64_t>(M, 2)));
    points.resize(capacity);
    layer_counts.assign(max_layer, 0);
  }

  const T* vec(int64_t i) const { return data.data() + uint64_t(i) * dim; }
  uint64_t width(uint64_t l) const { return l == 0 ? 2 * M : M; }

  int sample_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double x = u(rng);
    auto lv = uint64_t(std::floor(-std::log(std::max(x, 1e-300)) * scale));
    if (lv >= max_layer) lv = std::uniform_int_distribution<uint64_t>(0, max_layer - 1)(rng);
    return int(lv);
  }

  void grow(size_t need) {
    if (need <= capacity) return;
    // deque::resize leaves existing elements in place (rows hold mutexes). Growth
    // only happens under alloc_lock; like the reference, concurrent search during a
    // growing insert is the caller's responsibility (searching-mode flag contract,
    // reference src/hnsw.rs:759-760).
    size_t nc = capacity;
    while (nc < need) nc *= 2;
    points.resize(nc);
    capacity = nc;
  }

  int64_t allocate(const T* v, uint64_t d_, int64_t oid, int forced_level) {
    std::lock_guard<std::mutex> g(alloc_lock);
    if (dim == 0) dim = d_;
    int64_t i = n.load();
    grow(size_t(i) + 1);
    // Indexed writes into pre-sized storage: parallel_insert resizes these vectors
    // to their FINAL size up front (under this same lock), so during the threaded
    // phase no vector reallocates or mutates its size while other threads read
    // elements through vec()/level[] — size-member races were latent UB on real
    // multi-core hardware even when reserve() prevented reallocation.
    size_t need = size_t(i) + 1;
    if (data.size() < need * dim) data.resize(need * dim);
    if (origin.size() < need) {
      origin.resize(need);
      level.resize(need);
      rank.resize(need);
    }
    std::memcpy(data.data() + size_t(i) * dim, v, dim * sizeof(T));
    int lv = forced_level >= 0 ? forced_level : sample_level();
    origin[i] = oid;
    level[i] = lv;
    rank[i] = int32_t(layer_counts[lv]);
    layer_counts[lv] += 1;
    points[i].nbrs.resize(max_layer);
    n.store(i + 1);
    return i;
  }

  // ---------------------------------------------------------------- search_layer ----
  // ef-capped best-first search in one layer; mirrors reference src/hnsw.rs:922-1064.
  void search_layer(const T* q, int64_t ep, uint64_t ef, uint64_t layer,
                    std::vector<Link>& out) const {
    out.clear();
    if (layer >= max_layer || layer_counts[layer] == 0 || ep < 0) return;
    float d0 = dist(q, vec(ep), dim);
    Visited& visited = tl_visited;
    visited.begin(capacity);
    visited.insert(int32_t(ep));
    // candidates: min-heap by dist; results: max-heap by dist capped at ef
    using QC = std::priority_queue<Link, std::vector<Link>,
                                   bool (*)(const Link&, const Link&)>;
    auto gt = +[](const Link& a, const Link& b) { return a.dist > b.dist; };
    auto lt = +[](const Link& a, const Link& b) { return a.dist < b.dist; };
    QC cand(gt);
    QC res(lt);
    cand.push({d0, int32_t(ep)});
    res.push({d0, int32_t(ep)});
    std::vector<int32_t> fresh;
    while (!cand.empty()) {
      Link c = cand.top();
      cand.pop();
      if (c.dist > res.top().dist) break;
      fresh.clear();
      {
        std::lock_guard<std::mutex> g(points[c.id].lock);
        const auto& row = points[c.id].nbrs[layer];
        for (const auto& e : row)
          if (visited.insert(e.id)) fresh.push_back(e.id);
      }
      for (int32_t e : fresh) {
        float de = dist(q, vec(e), dim);
        if (de < res.top().dist || res.size() < ef) {
          cand.push({de, e});
          res.push({de, e});
          if (res.size() > ef) res.pop();
        }
      }
    }
    out.reserve(res.size());
    while (!res.empty()) { out.push_back(res.top()); res.pop(); }
    std::sort(out.begin(), out.end(), link_lt);
  }

  // ------------------------------------------------------------ select_neighbours ---
  void select_neighbours(const T* q, std::vector<Link>& cand, uint64_t nb_asked,
                         bool extend, uint64_t layer, std::vector<Link>& kept) const {
    kept.clear();
    std::sort(cand.begin(), cand.end(), link_lt);
    if (cand.size() <= nb_asked && !extend) { kept = cand; return; }
    if (cand.size() <= nb_asked && extend) {
      std::unordered_set<int32_t> seen;
      for (auto& c : cand) seen.insert(c.id);
      std::vector<int32_t> extra;
      for (auto& c : cand) {
        std::lock_guard<std::mutex> g(points[c.id].lock);
        for (auto& e : points[c.id].nbrs[layer])
          if (seen.insert(e.id).second) extra.push_back(e.id);
      }
      for (int32_t e : extra) cand.push_back({dist(q, vec(e), dim), e});
      std::sort(cand.begin(), cand.end(), link_lt);
    }
    std::vector<Link> discarded;
    for (const auto& e : cand) {
      if (kept.size() >= nb_asked) break;
      bool ok = true;
      for (const auto& d : kept)
        if (dist(vec(e.id), vec(d.id), dim) <= e.dist) { ok = false; break; }
      if (ok) kept.push_back(e);
      else if (keep_pruned) discarded.push_back(e);
    }
    if (keep_pruned && kept.size() < nb_asked) {
      std::sort(discarded.begin(), discarded.end(), link_lt);
      for (const auto& d : discarded) {
        if (kept.size() >= nb_asked) break;
        kept.push_back(d);
      }
    }
  }

  // ------------------------------------------------------------------- insert -------
  void insert(const T* v, uint64_t d_, int64_t oid, int forced_level = -1) {
    int64_t idx = allocate(v, d_, oid, forced_level);
    int lv = level[idx];
    int64_t ep;
    {
      std::shared_lock<std::shared_mutex> g(entry_lock);
      ep = entry.load();
    }
    if (ep < 0) {
      std::unique_lock<std::shared_mutex> g(entry_lock);
      if (entry.load() < 0) { entry.store(idx); return; }
      ep = entry.load();
    }
    const T* q = vec(idx);
    int max_obs = level[ep];
    float d_entry = dist(q, vec(ep), dim);
    std::vector<Link> res, cand, kept;
    // upper-layer ef=1 descent with projection links (src/hnsw.rs:1114-1155)
    for (int l = max_obs; l > lv; --l) {
      search_layer(q, ep, 1, uint64_t(l), res);
      if (!res.empty()) {
        Link best = res.front();
        {
          std::lock_guard<std::mutex> g(points[idx].lock);
          if (points[idx].nbrs[l].size() < M) points[idx].nbrs[l].push_back(best);
        }
        if (best.dist < d_entry) { ep = best.id; d_entry = best.dist; }
      }
    }
    // construction loop (src/hnsw.rs:1156-1205)
    for (int l = lv; l >= 0; --l) {
      search_layer(q, ep, efc, uint64_t(l), res);
      if (res.empty()) continue;
      cand = res;
      uint64_t nb_conn = (l == 0) ? 2 * M : M;
      bool ext = (l == 0) && extend_candidates;
      select_neighbours(q, cand, nb_conn, ext, uint64_t(l), kept);
      std::sort(kept.begin(), kept.end(), link_lt);
      {
        std::lock_guard<std::mutex> g(points[idx].lock);
        points[idx].nbrs[l] = kept;
      }
      if (!kept.empty()) ep = kept.front().id;
    }
    // reverse update at l_n = new point's level (src/hnsw.rs:1241-1289)
    uint64_t l_n = uint64_t(lv);
    uint64_t thr = width(l_n);
    for (int l = lv; l >= 0; --l) {
      std::vector<Link> row;
      {
        std::lock_guard<std::mutex> g(points[idx].lock);
        row = points[idx].nbrs[l];
      }
      for (const auto& qlnk : row) {
        if (qlnk.id == idx) continue;
        std::lock_guard<std::mutex> g(points[qlnk.id].lock);
        auto& tgt = points[qlnk.id].nbrs[l_n];
        bool already = false;
        for (const auto& o : tgt)
          if (o.id == int32_t(idx)) { already = true; break; }
        if (already) continue;
        tgt.push_back({qlnk.dist, int32_t(idx)});
        std::sort(tgt.begin(), tgt.end(), link_lt);
        if (tgt.size() > thr) tgt.pop_back();
      }
    }
    // entry promotion (src/hnsw.rs:534-557)
    {
      std::unique_lock<std::shared_mutex> g(entry_lock);
      int64_t e = entry.load();
      if (e < 0 || lv > level[e]) entry.store(idx);
    }
  }

  void parallel_insert(const T* vs, uint64_t count, uint64_t d_,
                       const int64_t* oids, int n_threads) {
    if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
    NLOG(1, "parallel_insert: %llu points, dim %llu, %d threads",
         (unsigned long long)count, (unsigned long long)d_, n_threads);
    // pre-sample levels under one lock so the stream stays deterministic in order
    std::vector<int> lvls(count);
    {
      std::lock_guard<std::mutex> g(alloc_lock);
      for (uint64_t i = 0; i < count; ++i) lvls[i] = sample_level();
      // pre-SIZE (not reserve) every growable array to its final extent so the
      // threaded phase performs only element writes — allocate() then never
      // resizes, eliminating both reallocation and size-member data races
      size_t total = size_t(n.load()) + count;
      grow(total);
      if (dim == 0) dim = d_;
      data.resize(total * dim);
      origin.resize(total);
      level.resize(total);
      rank.resize(total);
    }
    std::atomic<uint64_t> next{0};
    auto worker = [&]() {
      for (;;) {
        uint64_t i = next.fetch_add(1);
        if (i >= count) break;
        insert(vs + i * d_, d_, oids[i], lvls[i]);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }

  // ------------------------------------------------------------------- search -------
  // production path: one-scan greedy descent + layer search (src/hnsw.rs:1487-1599)
  uint64_t search(const T* q, uint64_t knbn, uint64_t ef_arg,
                  int (*filter)(int64_t), std::vector<Link>& out) const {
    out.clear();
    int64_t ep = entry.load();
    if (ep < 0) return 0;
    if (data.size() < uint64_t(n.load()) * dim) return 0;  // graph-only (NoData) load
    float d_ep = dist(q, vec(ep), dim);
    int64_t pivot = ep;
    for (int layer = level[ep]; layer >= 1; --layer) {
      std::vector<Link> row;
      {
        std::lock_guard<std::mutex> g(points[pivot].lock);
        row = points[pivot].nbrs[layer];
      }
      int64_t best = -1;
      for (const auto& nl : row) {
        float dd = dist(q, vec(nl.id), dim);
        if (dd < d_ep) { d_ep = dd; best = nl.id; }
      }
      if (best >= 0) pivot = best;
    }
    uint64_t ef = std::max(ef_arg, knbn);
    uint64_t l0 = 0;
    while (l0 < max_layer && layer_counts[l0] == 0) ++l0;
    std::vector<Link> res;
    search_layer_filtered(q, pivot, ef, l0, filter, res);
    uint64_t last = std::min<uint64_t>({knbn, ef, res.size()});
    for (uint64_t i = 0; i < last; ++i) {
      if (!filter || filter(origin[res[i].id])) out.push_back(res[i]);
    }
    return out.size();
  }

  // search_layer with in-search filtering (reference filter semantics,
  // src/hnsw.rs:992-1050): no early return with a filter; results admit only
  // filter-passing points; traversal uses all points.
  void search_layer_filtered(const T* q, int64_t ep, uint64_t ef, uint64_t layer,
                             int (*filter)(int64_t), std::vector<Link>& out) const {
    if (!filter) { search_layer(q, ep, ef, layer, out); return; }
    out.clear();
    if (layer >= max_layer || layer_counts[layer] == 0 || ep < 0) return;
    float d0 = dist(q, vec(ep), dim);
    Visited& visited = tl_visited2;
    visited.begin(capacity);
    visited.insert(int32_t(ep));
    auto gt = +[](const Link& a, const Link& b) { return a.dist > b.dist; };
    auto lt = +[](const Link& a, const Link& b) { return a.dist < b.dist; };
    std::priority_queue<Link, std::vector<Link>, bool (*)(const Link&, const Link&)>
        cand(gt), trav(lt), res(lt);
    cand.push({d0, int32_t(ep)});
    trav.push({d0, int32_t(ep)});
    if (filter(origin[ep])) res.push({d0, int32_t(ep)});
    std::vector<int32_t> fresh;
    while (!cand.empty()) {
      Link c = cand.top();
      cand.pop();
      if (!trav.empty() && c.dist > trav.top().dist && trav.size() >= ef) continue;
      fresh.clear();
      {
        std::lock_guard<std::mutex> g(points[c.id].lock);
        for (const auto& e : points[c.id].nbrs[layer])
          if (visited.insert(e.id)) fresh.push_back(e.id);
      }
      for (int32_t e : fresh) {
        float de = dist(q, vec(e), dim);
        if (trav.size() < ef || de < trav.top().dist) {
          cand.push({de, e});
          trav.push({de, e});
          if (trav.size() > ef) trav.pop();
          if (filter(origin[e])) {
            res.push({de, e});
            if (res.size() > ef) res.pop();
          }
        }
      }
    }
    out.reserve(res.size());
    while (!res.empty()) { out.push_back(res.top()); res.pop(); }
    std::sort(out.begin(), out.end(), link_lt);
  }

  void parallel_search(const T* qs, uint64_t nq, uint64_t knbn, uint64_t ef,
                       int n_threads, int64_t* out_ids, float* out_d) const {
    if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
    std::atomic<uint64_t> next{0};
    auto worker = [&]() {
      std::vector<Link> res;
      for (;;) {
        uint64_t i = next.fetch_add(1);
        if (i >= nq) break;
        search(qs + i * dim, knbn, ef, nullptr, res);
        for (uint64_t j = 0; j < knbn; ++j) {
          if (j < res.size()) {
            out_ids[i * knbn + j] = origin[res[j].id];
            out_d[i * knbn + j] = res[j].dist;
          } else {
            out_ids[i * knbn + j] = -1;
            out_d[i * knbn + j] = INFINITY;
          }
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
};

// ------------------------------------------------------------- persistence ----------
// Byte-compatible with the reference dump format v4 (two files,
// <basename>.hnsw.graph + <basename>.hnsw.data; layout documented in
// hnsw_tpu/io/hnswio.py and SURVEY.md §2.5). Little-endian, usize = u64.

constexpr uint32_t MAGICPOINT = 0x000a678f;
constexpr uint32_t MAGICDESCR_2 = 0x002a677f;
constexpr uint32_t MAGICDESCR_3 = 0x002a6771;
constexpr uint32_t MAGICDESCR_4 = 0x002a6779;
constexpr uint32_t MAGICLAYER = 0x000a676f;
constexpr uint32_t MAGICDATAP = 0xa67f0000;

template <typename V>
static void wr(std::FILE* f, V v) { std::fwrite(&v, sizeof(V), 1, f); }
template <typename V>
static bool rd(std::FILE* f, V* v) { return std::fread(v, sizeof(V), 1, f) == 1; }

static const char* rust_dist_name(Dist d) {
  switch (d) {
    case Dist::L1: return "anndists::dist::distances::DistL1";
    case Dist::L2: return "anndists::dist::distances::DistL2";
    case Dist::Cosine: return "anndists::dist::distances::DistCosine";
    case Dist::Dot: return "anndists::dist::distances::DistDot";
    case Dist::Hamming: return "anndists::dist::distances::DistHamming";
    case Dist::Jaccard: return "anndists::dist::distances::DistJaccard";
    case Dist::Hellinger: return "anndists::dist::distances::DistHellinger";
    case Dist::Jeffreys: return "anndists::dist::distances::DistJeffreys";
    case Dist::JensenShannon: return "anndists::dist::distances::DistJensenShannon";
    case Dist::Levenshtein: return "anndists::dist::distances::DistLevenshtein";
    default: return "anndists::dist::distances::DistPtr";
  }
}

template <typename T> static const char* rust_type_name();
template <> const char* rust_type_name<float>() { return "f32"; }
template <> const char* rust_type_name<double>() { return "f64"; }
template <> const char* rust_type_name<int32_t>() { return "i32"; }
template <> const char* rust_type_name<uint32_t>() { return "u32"; }
template <> const char* rust_type_name<uint16_t>() { return "u16"; }
template <> const char* rust_type_name<uint8_t>() { return "u8"; }

template <typename T>
static int dump_index(Index<T>& ix, const char* dir, const char* basename) {
  std::string g = std::string(dir) + "/" + basename + ".hnsw.graph";
  std::string dp = std::string(dir) + "/" + basename + ".hnsw.data";
  std::FILE* fg = std::fopen(g.c_str(), "wb");
  std::FILE* fd = std::fopen(dp.c_str(), "wb");
  if (!fg || !fd) { if (fg) std::fclose(fg); if (fd) std::fclose(fd); return -1; }
  int64_t n = ix.n.load();
  if (n == 0 || ix.entry.load() < 0) { std::fclose(fg); std::fclose(fd); return -2; }
  // header stores M as u8; reject instead of truncating (reference hnsw.rs:823 casts)
  if (ix.M > 255) { std::fclose(fg); std::fclose(fd); return -3; }
  // description header
  wr<uint32_t>(fg, MAGICDESCR_4);
  wr<uint8_t>(fg, 1);  // Full
  wr<uint8_t>(fg, uint8_t(ix.M));
  wr<double>(fg, ix.scale);
  wr<uint8_t>(fg, 16);
  wr<uint64_t>(fg, ix.efc);
  wr<uint64_t>(fg, uint64_t(n));
  wr<uint64_t>(fg, ix.dim);
  std::string dn = rust_dist_name(ix.dist_kind);
  wr<uint64_t>(fg, dn.size());
  std::fwrite(dn.data(), 1, dn.size(), fg);
  std::string tn = rust_type_name<T>();
  wr<uint64_t>(fg, tn.size());
  std::fwrite(tn.data(), 1, tn.size(), fg);
  // data header
  wr<uint32_t>(fd, MAGICDATAP);
  wr<uint64_t>(fd, ix.dim);
  // iteration order: layer 0 upward, rank order (reference PointIndexation::dump)
  std::vector<std::vector<int64_t>> by_layer(16);
  for (int64_t i = 0; i < n; ++i) by_layer[ix.level[i]].push_back(i);
  for (auto& v : by_layer)
    std::sort(v.begin(), v.end(), [&](int64_t a, int64_t b) {
      return ix.rank[a] < ix.rank[b];
    });
  wr<uint8_t>(fg, 16);  // nb_layer again (PointIndexation::dump)
  for (int l = 0; l < 16; ++l) {
    wr<uint32_t>(fg, MAGICLAYER);
    wr<uint64_t>(fg, by_layer[l].size());
    for (int64_t i : by_layer[l]) {
      wr<uint32_t>(fg, MAGICPOINT);
      wr<uint64_t>(fg, uint64_t(ix.origin[i]));
      wr<uint8_t>(fg, uint8_t(ix.level[i]));
      wr<int32_t>(fg, ix.rank[i]);
      for (uint64_t ll = 0; ll < 16; ++ll) {
        if (ll >= ix.max_layer) { wr<uint64_t>(fg, 0); continue; }
        const auto& row = ix.points[i].nbrs[ll];
        wr<uint64_t>(fg, row.size());
        for (const auto& e : row) {
          wr<uint64_t>(fg, uint64_t(ix.origin[e.id]));
          wr<uint8_t>(fg, uint8_t(ix.level[e.id]));
          wr<int32_t>(fg, ix.rank[e.id]);
          wr<float>(fg, e.dist);
        }
      }
      wr<uint32_t>(fd, MAGICDATAP);
      wr<uint64_t>(fd, uint64_t(ix.origin[i]));
      wr<uint64_t>(fd, ix.dim * sizeof(T));
      std::fwrite(ix.vec(i), sizeof(T), ix.dim, fd);
    }
  }
  int64_t ep = ix.entry.load();
  wr<uint64_t>(fg, uint64_t(ix.origin[ep]));
  wr<uint8_t>(fg, uint8_t(ix.level[ep]));
  wr<int32_t>(fg, ix.rank[ep]);
  std::fclose(fg);
  std::fclose(fd);
  NLOG(1, "dumped %lld points to %s/%s.hnsw.{graph,data}", (long long)n, dir,
       basename);
  return 0;
}

// Parsed dump header (v3/v4) — the C-side analog of the Python tier's
// read_description (io/hnswio.py) and the reference's Description
// (src/hnswio.rs:846-930).
struct DumpHeader {
  int32_t version = 0;
  uint8_t mode = 0;
  uint8_t m = 0;
  double scale = 0.0;
  uint8_t nb_layer = 0;
  uint64_t ef = 0, nb_point = 0, dim = 0;
  std::string distname, t_name;
};

static bool parse_header(std::FILE* fg, DumpHeader& h) {
  uint32_t magic;
  uint64_t len;
  if (!rd(fg, &magic)) return false;
  if (magic == MAGICDESCR_4) h.version = 4;
  else if (magic == MAGICDESCR_3) h.version = 3;
  else if (magic == MAGICDESCR_2) h.version = 2;
  else return false;
  if (!rd(fg, &h.mode) || !rd(fg, &h.m)) return false;
  if (h.version == 4) {
    if (!rd(fg, &h.scale)) return false;
  } else {
    h.scale = 1.0 / std::log(std::max<double>(h.m, 2.0));
  }
  if (!(rd(fg, &h.nb_layer) && rd(fg, &h.ef) && rd(fg, &h.nb_point) &&
        rd(fg, &h.dim) && rd(fg, &len) && len <= 256)) return false;
  h.distname.resize(len);
  if (std::fread(h.distname.data(), 1, len, fg) != len) return false;
  if (!rd(fg, &len) || len > 256) return false;
  h.t_name.resize(len);
  return std::fread(h.t_name.data(), 1, len, fg) == len;
}

// fd == nullptr => graph-only (NoData) load: topology + metadata, no vectors
// (analog of the reference's NoData reload, libext.rs:446-451). v2 dumps carry
// bincode-serialized data records (u64 element count + raw LE elements).
// mode == 0 (Light dump): point and neighbor records carry NO (layer, rank)
// PointId — the point's pid is implied by its (layer, rank-in-file) position and
// neighbors resolve by external id (reference readers branch on dumpmode,
// src/hnswio.rs:1074-1090).
template <typename T>
static Index<T>* load_index(std::FILE* fg, std::FILE* fd, uint8_t max_nb_conn,
                            double scale, uint64_t ef, uint64_t nb_point,
                            uint64_t dim, Dist dk, int version = 4,
                            uint8_t mode = 1) {
  const bool full = mode == 1;
  auto* ix = new Index<T>(max_nb_conn, ef, nb_point, 16, dk);
  ix->scale = scale;
  ix->dim = dim;
  if (fd) ix->data.resize(nb_point * dim);
  ix->origin.resize(nb_point);
  ix->level.resize(nb_point);
  ix->rank.resize(nb_point);
  struct NRef { uint64_t d_id; uint8_t lv; int32_t rk; float dist; };
  std::vector<std::vector<std::vector<NRef>>> raw(nb_point);
  std::vector<std::vector<int64_t>> pid2idx(16);
  std::unordered_map<int64_t, int64_t> oid2idx;  // Light: resolve by external id
  if (!full) oid2idx.reserve(nb_point * 2);
  uint8_t nb_layer;
  if (!rd(fg, &nb_layer)) { delete ix; return nullptr; }
  // data header
  if (fd) {
    uint32_t dmagic; uint64_t ddim;
    if (!rd(fd, &dmagic) || dmagic != MAGICDATAP || !rd(fd, &ddim) || ddim != dim) {
      delete ix; return nullptr;
    }
  }
  int64_t idx = 0;
  for (int l = 0; l < nb_layer; ++l) {
    uint32_t lm; uint64_t cnt;
    if (!rd(fg, &lm) || lm != MAGICLAYER || !rd(fg, &cnt)) { delete ix; return nullptr; }
    pid2idx[l].resize(cnt);
    ix->layer_counts[l] = int64_t(cnt);
    for (uint64_t r = 0; r < cnt; ++r) {
      uint32_t pm; uint64_t oid;
      uint8_t lv = uint8_t(l); int32_t rk = int32_t(r);
      if (!rd(fg, &pm) || pm != MAGICPOINT || !rd(fg, &oid)) { delete ix; return nullptr; }
      if (full) {
        if (!rd(fg, &lv) || !rd(fg, &rk) || lv != l || uint64_t(rk) != r) {
          delete ix; return nullptr;
        }
      }
      ix->origin[idx] = int64_t(oid);
      ix->level[idx] = lv;
      ix->rank[idx] = rk;
      pid2idx[l][r] = idx;
      if (!full) oid2idx.emplace(int64_t(oid), idx);
      ix->points[idx].nbrs.resize(ix->max_layer);
      raw[idx].resize(16);
      for (int ll = 0; ll < 16; ++ll) {
        uint64_t nbg;
        if (!rd(fg, &nbg)) { delete ix; return nullptr; }
        raw[idx][ll].resize(nbg);
        for (uint64_t j = 0; j < nbg; ++j) {
          NRef& nr = raw[idx][ll][j];
          if (full) {
            if (!(rd(fg, &nr.d_id) && rd(fg, &nr.lv) && rd(fg, &nr.rk) &&
                  rd(fg, &nr.dist))) { delete ix; return nullptr; }
          } else {
            if (!(rd(fg, &nr.d_id) && rd(fg, &nr.dist))) { delete ix; return nullptr; }
          }
        }
      }
      if (fd) {
        uint32_t dm; uint64_t doid, blen;
        uint64_t want = dim * sizeof(T) + (version == 2 ? 8 : 0);
        if (!rd(fd, &dm) || dm != MAGICDATAP || !rd(fd, &doid) || !rd(fd, &blen) ||
            blen != want) { delete ix; return nullptr; }
        if (version == 2) {  // skip the bincode Vec<T> element-count prefix
          uint64_t cnt;
          if (!rd(fd, &cnt) || cnt != dim) { delete ix; return nullptr; }
        }
        if (std::fread(ix->data.data() + uint64_t(idx) * dim, sizeof(T), dim, fd)
            != dim) { delete ix; return nullptr; }
      }
      ++idx;
    }
  }
  ix->n.store(idx);
  // pass 2: resolve pids (Full) or external ids (Light) -> internal index,
  // sort rows by distance
  for (int64_t i = 0; i < idx; ++i) {
    for (uint64_t ll = 0; ll < ix->max_layer; ++ll) {
      auto& out = ix->points[i].nbrs[ll];
      for (const auto& nr : raw[i][ll]) {
        if (full) {
          if (nr.lv < 16 && uint64_t(nr.rk) < pid2idx[nr.lv].size())
            out.push_back({nr.dist, int32_t(pid2idx[nr.lv][nr.rk])});
        } else {
          auto it = oid2idx.find(int64_t(nr.d_id));
          if (it != oid2idx.end())
            out.push_back({nr.dist, int32_t(it->second)});
        }
      }
      std::sort(out.begin(), out.end(), link_lt);
    }
  }
  uint64_t ep_oid;
  if (!rd(fg, &ep_oid)) return ix;
  if (full) {
    uint8_t ep_lv; int32_t ep_rk;
    if (rd(fg, &ep_lv) && rd(fg, &ep_rk) && ep_lv < 16 &&
        uint64_t(ep_rk) < pid2idx[ep_lv].size())
      ix->entry.store(pid2idx[ep_lv][ep_rk]);
  } else {
    auto it = oid2idx.find(int64_t(ep_oid));
    if (it != oid2idx.end()) ix->entry.store(it->second);
  }
  return ix;
}

static Dist dist_from_name(const char* name) {
  std::string s(name);
  // dump headers carry the full Rust path ("anndists::dist::distances::DistL2");
  // ctor calls pass short names ("L2"). Strip both forms.
  auto pos = s.rfind("::");
  if (pos != std::string::npos) s = s.substr(pos + 2);
  if (s.rfind("Dist", 0) == 0) s = s.substr(4);
  if (s == "L1") return Dist::L1;
  if (s == "L2") return Dist::L2;
  if (s == "Cosine") return Dist::Cosine;
  if (s == "Dot") return Dist::Dot;
  if (s == "Hamming") return Dist::Hamming;
  if (s == "Jaccard") return Dist::Jaccard;
  if (s == "Hellinger") return Dist::Hellinger;
  if (s == "Jeffreys") return Dist::Jeffreys;
  if (s == "JensenShannon") return Dist::JensenShannon;
  if (s == "Levenshtein") return Dist::Levenshtein;
  return Dist::L2;
}

// Tagged handle: the ABI is typed per element type like the reference's
// per-(type x distance) FFI surface (libext.rs init_hnsw_{f32,i32,u32,u16,u8}).
enum class TCode : int32_t { F32 = 0, F64 = 1, I32 = 2, U32 = 3, U16 = 4, U8 = 5 };

struct Handle {
  TCode t;
  void* ix;
};

template <typename F>
static auto dispatch(Handle* h, F&& f) {
  switch (h->t) {
    case TCode::F32: return f(static_cast<Index<float>*>(h->ix));
    case TCode::F64: return f(static_cast<Index<double>*>(h->ix));
    case TCode::I32: return f(static_cast<Index<int32_t>*>(h->ix));
    case TCode::U32: return f(static_cast<Index<uint32_t>*>(h->ix));
    case TCode::U16: return f(static_cast<Index<uint16_t>*>(h->ix));
    default: return f(static_cast<Index<uint8_t>*>(h->ix));
  }
}

template <typename T>
static Handle* make_handle(TCode t, uint64_t m, uint64_t efc, uint64_t cap,
                           uint64_t ml, const char* dist) {
  if (m == 0 || m > 256) return nullptr;
  return new Handle{t, new Index<T>(m, efc, cap, ml ? ml : 16, dist_from_name(dist))};
}

// Flat-array import: build a native index directly from the dense table layout
// the Python/TPU tier uses (the inverse of the export_* surface). Rows are taken
// in stored order — callers keep them distance-sorted — so a subsequent
// hnsw_file_dump is byte-identical to the Python writer's output for the same
// graph. This is what makes reference-format persistence O(buffered-pass) at
// flagship scale (VERDICT r2 next #3): Python hands the arrays over zero-copy
// and the C++ writer streams the bytes.
template <typename T>
static Handle* import_index(TCode tc, uint64_t m, uint64_t efc, uint64_t ml,
                            const char* dist, double scale, uint64_t n,
                            uint64_t dim, const T* data, const int64_t* origin,
                            const int32_t* level, const int32_t* rank,
                            int64_t entry, int32_t nb_layers,
                            const int64_t* widths, const int32_t* const* lids,
                            const float* const* ldists, int extendc, int keepp) {
  if (m == 0 || m > 256 || n == 0) return nullptr;
  auto* ix = new Index<T>(m, efc, n, ml ? ml : 16, dist_from_name(dist));
  ix->scale = scale;
  ix->dim = dim;
  if (data) {
    ix->data.resize(size_t(n) * dim);
    std::memcpy(ix->data.data(), data, size_t(n) * dim * sizeof(T));
  }
  ix->origin.assign(origin, origin + n);
  ix->level.assign(level, level + n);
  ix->rank.assign(rank, rank + n);
  for (uint64_t i = 0; i < n; ++i) {
    ix->points[i].nbrs.resize(ix->max_layer);
    if (level[i] >= 0 && uint64_t(level[i]) < ix->max_layer)
      ix->layer_counts[level[i]] += 1;
  }
  for (int32_t l = 0; l < nb_layers && uint64_t(l) < ix->max_layer; ++l) {
    const int64_t w = widths[l];
    const int32_t* ids_l = lids[l];
    const float* dd_l = ldists[l];
    if (!ids_l || w <= 0) continue;
    for (uint64_t i = 0; i < n; ++i) {
      auto& row = ix->points[i].nbrs[l];
      const int32_t* r = ids_l + i * uint64_t(w);
      const float* d = dd_l + i * uint64_t(w);
      for (int64_t j = 0; j < w && r[j] >= 0; ++j) row.push_back({d[j], r[j]});
    }
  }
  ix->n.store(int64_t(n));
  ix->entry.store(entry);
  ix->extend_candidates = extendc != 0;
  ix->keep_pruned = keepp != 0;
  NLOG(2, "imported %llu points (dim %llu) from flat arrays",
       (unsigned long long)n, (unsigned long long)dim);
  return new Handle{tc, ix};
}

}  // namespace

// ------------------------------------------------------------------- C ABI ----------
// Typed surface mirroring the reference's libext.rs shape, plus flat-array exports
// for zero-copy handoff to the TPU path. Unsuffixed names are the f32 instance.

extern "C" {

#define HNSW_TYPED_ABI(SUF, CT, TC)                                                    \
  void* hnsw_init_##SUF(uint64_t m, uint64_t efc, uint64_t cap, uint64_t ml,           \
                        const char* dist) {                                            \
    return make_handle<CT>(TC, m, efc, cap, ml, dist);                                 \
  }                                                                                    \
  void hnsw_insert_##SUF(void* h, const CT* v, uint64_t dim, int64_t id) {             \
    static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix)->insert(v, dim, id);          \
  }                                                                                    \
  void hnsw_parallel_insert_##SUF(void* h, const CT* vs, uint64_t n, uint64_t dim,     \
                                  const int64_t* ids, int nt) {                        \
    static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix)                               \
        ->parallel_insert(vs, n, dim, ids, nt);                                        \
  }                                                                                    \
  uint64_t hnsw_search_##SUF(void* h, const CT* q, uint64_t knbn, uint64_t ef,         \
                             int64_t* oi, float* od) {                                 \
    auto* ix = static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix);                   \
    std::vector<Link> res;                                                             \
    ix->search(q, knbn, ef, nullptr, res);                                             \
    for (size_t i = 0; i < res.size(); ++i) {                                          \
      oi[i] = ix->origin[res[i].id];                                                   \
      od[i] = res[i].dist;                                                             \
    }                                                                                  \
    return res.size();                                                                 \
  }                                                                                    \
  uint64_t hnsw_search_filter_##SUF(void* h, const CT* q, uint64_t knbn, uint64_t ef,  \
                                    int (*filter)(int64_t), int64_t* oi, float* od) {  \
    auto* ix = static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix);                   \
    std::vector<Link> res;                                                             \
    ix->search(q, knbn, ef, filter, res);                                              \
    for (size_t i = 0; i < res.size(); ++i) {                                          \
      oi[i] = ix->origin[res[i].id];                                                   \
      od[i] = res[i].dist;                                                             \
    }                                                                                  \
    return res.size();                                                                 \
  }                                                                                    \
  void hnsw_parallel_search_##SUF(void* h, const CT* qs, uint64_t nq, uint64_t knbn,   \
                                  uint64_t ef, int nt, int64_t* oi, float* od) {       \
    static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix)                               \
        ->parallel_search(qs, nq, knbn, ef, nt, oi, od);                               \
  }                                                                                    \
  void hnsw_export_data_##SUF(void* h, CT* out) {                                      \
    auto* ix = static_cast<Index<CT>*>(static_cast<Handle*>(h)->ix);                   \
    size_t want = size_t(ix->n.load()) * ix->dim;                                      \
    if (ix->data.size() >= want) /* graph-only loads have no data */                   \
      std::memcpy(out, ix->data.data(), want * sizeof(CT));                            \
  }

HNSW_TYPED_ABI(f32, float, TCode::F32)
HNSW_TYPED_ABI(f64, double, TCode::F64)
HNSW_TYPED_ABI(i32, int32_t, TCode::I32)
HNSW_TYPED_ABI(u32, uint32_t, TCode::U32)
HNSW_TYPED_ABI(u16, uint16_t, TCode::U16)
HNSW_TYPED_ABI(u8, uint8_t, TCode::U8)
#undef HNSW_TYPED_ABI

#define HNSW_IMPORT_ABI(SUF, CT, TC)                                                   \
  void* hnsw_import_##SUF(uint64_t m, uint64_t efc, uint64_t ml, const char* dist,     \
                          double scale, uint64_t n, uint64_t dim, const CT* data,      \
                          const int64_t* origin, const int32_t* level,                 \
                          const int32_t* rank, int64_t entry, int32_t nb_layers,       \
                          const int64_t* widths, const int32_t* const* lids,           \
                          const float* const* ldists, int extendc, int keepp) {        \
    return import_index<CT>(TC, m, efc, ml, dist, scale, n, dim, data, origin,         \
                            level, rank, entry, nb_layers, widths, lids, ldists,       \
                            extendc, keepp);                                           \
  }

HNSW_IMPORT_ABI(f32, float, TCode::F32)
HNSW_IMPORT_ABI(f64, double, TCode::F64)
HNSW_IMPORT_ABI(i32, int32_t, TCode::I32)
HNSW_IMPORT_ABI(u32, uint32_t, TCode::U32)
HNSW_IMPORT_ABI(u16, uint16_t, TCode::U16)
HNSW_IMPORT_ABI(u8, uint8_t, TCode::U8)
#undef HNSW_IMPORT_ABI

// ----- legacy unsuffixed names = f32 (keeps the original header contract) -----

void* hnsw_init(uint64_t m, uint64_t efc, uint64_t cap, uint64_t ml,
                const char* dist) {
  return hnsw_init_f32(m, efc, cap, ml, dist);
}

void* hnsw_init_ptrdist(uint64_t m, uint64_t efc, uint64_t cap, uint64_t ml,
                        DistFn fn) {
  auto* h = static_cast<Handle*>(hnsw_init_f32(m, efc, cap, ml, "L2"));
  if (h) {
    auto* ix = static_cast<Index<float>*>(h->ix);
    ix->dist_kind = Dist::Ptr;
    ix->dist = fn;
  }
  return h;
}

void hnsw_insert(void* h, const float* v, uint64_t dim, int64_t id) {
  hnsw_insert_f32(h, v, dim, id);
}
void hnsw_parallel_insert(void* h, const float* vs, uint64_t n, uint64_t dim,
                          const int64_t* ids, int nt) {
  hnsw_parallel_insert_f32(h, vs, n, dim, ids, nt);
}
uint64_t hnsw_search(void* h, const float* q, uint64_t knbn, uint64_t ef,
                     int64_t* oi, float* od) {
  return hnsw_search_f32(h, q, knbn, ef, oi, od);
}
uint64_t hnsw_search_filter(void* h, const float* q, uint64_t knbn, uint64_t ef,
                            int (*filter)(int64_t), int64_t* oi, float* od) {
  return hnsw_search_filter_f32(h, q, knbn, ef, filter, oi, od);
}
void hnsw_parallel_search(void* h, const float* qs, uint64_t nq, uint64_t knbn,
                          uint64_t ef, int nt, int64_t* oi, float* od) {
  hnsw_parallel_search_f32(h, qs, nq, knbn, ef, nt, oi, od);
}
void hnsw_export_data(void* h, float* out) { hnsw_export_data_f32(h, out); }

// ----- type-agnostic operations (dispatch on the handle tag) -----

void hnsw_drop(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  if (!h) return;
  dispatch(h, [](auto* ix) { delete ix; });
  delete h;
}

void hnsw_set_extend_candidates(void* hv, int flag) {
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) { ix->extend_candidates = flag != 0; });
}
void hnsw_set_keeping_pruned(void* hv, int flag) {
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) { ix->keep_pruned = flag != 0; });
}
void hnsw_modify_level_scale(void* hv, double factor) {
  factor = std::min(1.0, std::max(0.2, factor));
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    ix->scale = factor / std::log(double(std::max<uint64_t>(ix->M, 2)));
  });
}

uint64_t hnsw_nb_points(void* hv) {
  return dispatch(static_cast<Handle*>(hv),
                  [](auto* ix) { return uint64_t(ix->n.load()); });
}
uint64_t hnsw_dim(void* hv) {
  return dispatch(static_cast<Handle*>(hv), [](auto* ix) { return uint64_t(ix->dim); });
}
int64_t hnsw_entry_point(void* hv) {
  return dispatch(static_cast<Handle*>(hv), [](auto* ix) { return ix->entry.load(); });
}
int32_t hnsw_max_level_used(void* hv) {
  return dispatch(static_cast<Handle*>(hv), [](auto* ix) {
    int64_t e = ix->entry.load();
    return e >= 0 ? ix->level[e] : 0;
  });
}
int64_t hnsw_layer_count(void* hv, int32_t l) {
  return dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    return (l >= 0 && uint64_t(l) < ix->max_layer) ? ix->layer_counts[l] : int64_t(0);
  });
}
double hnsw_level_scale(void* hv) {
  return dispatch(static_cast<Handle*>(hv), [](auto* ix) { return ix->scale; });
}

void hnsw_export_meta(void* hv, int64_t* origin, int32_t* level, int32_t* rank) {
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    int64_t cnt = ix->n.load();
    std::memcpy(origin, ix->origin.data(), size_t(cnt) * sizeof(int64_t));
    std::memcpy(level, ix->level.data(), size_t(cnt) * sizeof(int32_t));
    std::memcpy(rank, ix->rank.data(), size_t(cnt) * sizeof(int32_t));
  });
}

int32_t hnsw_file_dump(void* hv, const char* dir, const char* basename) {
  return dispatch(static_cast<Handle*>(hv),
                  [&](auto* ix) { return int32_t(dump_index(*ix, dir, basename)); });
}

// Reload a Full or Light v2/v3/v4 dump; returns a tagged handle of the dumped
// element type, or NULL on any validation failure (analog of libext.rs
// generate_loadhnsw!). with_data = 0 skips the data file entirely (NoData reload).
// A DistPtr dump REQUIRES ptr_fn (reference load_hnsw_with_dist,
// src/hnswio.rs:531-613): loading one without a distance function is a hard NULL,
// never a silent remap to L2.
static void* load_dump(const char* dir, const char* basename, int with_data,
                       DistFn ptr_fn = nullptr) {
  std::string g = std::string(dir) + "/" + basename + ".hnsw.graph";
  std::string dp = std::string(dir) + "/" + basename + ".hnsw.data";
  std::FILE* fg = std::fopen(g.c_str(), "rb");
  if (!fg) return nullptr;
  std::FILE* fd = nullptr;
  if (with_data) {
    fd = std::fopen(dp.c_str(), "rb");
    if (!fd) { std::fclose(fg); return nullptr; }
  }
  Handle* out = nullptr;
  DumpHeader h;
  if (parse_header(fg, h) && (h.mode == 1 || h.mode == 0)) {
    Dist dk = dist_from_name(h.distname.c_str());
    bool is_ptr = h.distname.find("DistPtr") != std::string::npos;
    const std::string& tn = h.t_name;
    if (is_ptr && (!ptr_fn || tn != "f32")) {
      NLOG(1, "load %s/%s: DistPtr dump needs hnsw_load_ptrdist with an f32 "
              "distance fn", dir, basename);
    } else if (tn == "f32") {
      auto* ix = load_index<float>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode);
      if (ix && is_ptr) { ix->dist_kind = Dist::Ptr; ix->dist = ptr_fn; }
      out = new Handle{TCode::F32, ix};
    }
    else if (tn == "f64")
      out = new Handle{TCode::F64, load_index<double>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode)};
    else if (tn == "i32")
      out = new Handle{TCode::I32, load_index<int32_t>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode)};
    else if (tn == "u32")
      out = new Handle{TCode::U32, load_index<uint32_t>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode)};
    else if (tn == "u16")
      out = new Handle{TCode::U16, load_index<uint16_t>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode)};
    else if (tn == "u8")
      out = new Handle{TCode::U8, load_index<uint8_t>(fg, fd, h.m, h.scale, h.ef, h.nb_point, h.dim, dk, h.version, h.mode)};
  }
  std::fclose(fg);
  if (fd) std::fclose(fd);
  if (out && !out->ix) { delete out; out = nullptr; }
  NLOG(2, "load %s/%s -> %s", dir, basename, out ? "ok" : "FAILED");
  return out;
}

void* hnsw_load(const char* dir, const char* basename) {
  return load_dump(dir, basename, 1);
}

void* hnsw_load_graph_only(const char* dir, const char* basename) {
  return load_dump(dir, basename, 0);
}

// Custom-distance reload (reference load_hnsw_with_dist, src/hnswio.rs:531-613 +
// FFI ptr-dist ctors, src/libext.rs:643-655): reload a DistPtr dump with the
// caller's distance function. f32 only, like the init ctor.
void* hnsw_load_ptrdist(const char* dir, const char* basename, DistFn fn) {
  if (!fn) return nullptr;
  return load_dump(dir, basename, 1, fn);
}

// Analog of the reference's init_rust_log (src/libext.rs:1237-1240): set the
// native tier's verbosity from an embedding. 0 = silent, 1 = info, 2 = debug.
void hnsw_init_log(int32_t level) {
  g_log_level.store(level < 0 ? 0 : level);
  NLOG(2, "native logging initialized at level %d", level);
}

// must stay layout-identical to hnsw_description in hnsw_tpu.h
typedef struct {
  int32_t format_version;
  int32_t dumpmode;
  int32_t max_nb_connection;
  int32_t nb_layer;
  double level_scale;
  uint64_t ef_construction;
  uint64_t nb_point;
  uint64_t dimension;
  char distname[64];
  char t_name[16];
} hnsw_description;

int32_t hnsw_load_description(const char* dir, const char* basename,
                              hnsw_description* out) {
  std::string g = std::string(dir) + "/" + basename + ".hnsw.graph";
  std::FILE* fg = std::fopen(g.c_str(), "rb");
  if (!fg) return -1;
  DumpHeader h;
  bool ok = parse_header(fg, h);
  std::fclose(fg);
  if (!ok || !out) return -2;
  out->format_version = h.version;
  out->dumpmode = h.mode;
  out->max_nb_connection = h.m;
  out->nb_layer = h.nb_layer;
  out->level_scale = h.scale;
  out->ef_construction = h.ef;
  out->nb_point = h.nb_point;
  out->dimension = h.dim;
  std::snprintf(out->distname, sizeof(out->distname), "%s", h.distname.c_str());
  std::snprintf(out->t_name, sizeof(out->t_name), "%s", h.t_name.c_str());
  return 0;
}

int32_t hnsw_element_type(void* hv) {
  return int32_t(static_cast<Handle*>(hv)->t);
}

// Widest row actually present in layer l — can exceed width(l) when the index
// was imported from a navigability-repaired graph (reserve columns; see
// Hnsw.ensure_navigable). to_hnsw sizes its export buffers with this so the
// repair links survive a native round trip.
int64_t hnsw_layer_max_row(void* hv, int32_t l) {
  int64_t w = 0;
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    int64_t cnt = ix->n.load();
    for (int64_t i = 0; i < cnt; ++i)
      w = std::max<int64_t>(w, int64_t(ix->points[i].nbrs[l].size()));
  });
  return w;
}

// Stride-explicit export (w >= hnsw_layer_max_row): rows shorter than w are
// -1/inf padded; rows longer than w are truncated (callers pass a large-enough
// w via hnsw_layer_max_row).
void hnsw_export_layer_w(void* hv, int32_t l, int64_t wq, int32_t* ids,
                         float* dists) {
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    int64_t cnt = ix->n.load();
    uint64_t w = uint64_t(wq);
    for (int64_t i = 0; i < cnt; ++i) {
      const auto& row = ix->points[i].nbrs[l];
      uint64_t m = std::min<uint64_t>(row.size(), w);
      for (uint64_t j = 0; j < m; ++j) {
        ids[uint64_t(i) * w + j] = row[j].id;
        dists[uint64_t(i) * w + j] = row[j].dist;
      }
      for (uint64_t j = m; j < w; ++j) {
        ids[uint64_t(i) * w + j] = -1;
        dists[uint64_t(i) * w + j] = INFINITY;
      }
    }
  });
}

void hnsw_export_layer(void* hv, int32_t l, int32_t* ids, float* dists) {
  dispatch(static_cast<Handle*>(hv), [&](auto* ix) {
    int64_t cnt = ix->n.load();
    uint64_t w = ix->width(uint64_t(l));
    for (int64_t i = 0; i < cnt; ++i) {
      const auto& row = ix->points[i].nbrs[l];
      uint64_t m = std::min<uint64_t>(row.size(), w);
      for (uint64_t j = 0; j < m; ++j) {
        ids[uint64_t(i) * w + j] = row[j].id;
        dists[uint64_t(i) * w + j] = row[j].dist;
      }
      for (uint64_t j = m; j < w; ++j) {
        ids[uint64_t(i) * w + j] = -1;
        dists[uint64_t(i) * w + j] = INFINITY;
      }
    }
  });
}

}  // extern "C"
