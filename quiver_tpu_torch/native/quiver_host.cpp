// quiver_tpu_torch native host runtime: the host-side routines beside the
// CUDA kernels (the port's copy of quiver_tpu/native/quiver_host.cpp; the
// two are kept apart so that neither package opens the other's files).
//
// - csr_from_coo: a linear-time parallel COO -> CSR build (counting sort,
//   stable, so its arrays equal a numpy stable argsort's for any thread
//   count);
// - gather_rows_bytes: a parallel host row gather (zero rows for ids
//   below 0 or at the row count and above);
// - sample_neighbors_cpu: a reservoir sampler with the padded (S, k) / -1
//   contract, its generator keyed per row on (seed, row);
// - reindex_cpu: the order-preserving hash reindex (seeds first).
//
// A plain C ABI for ctypes. Built at first use by
// quiver_tpu_torch/native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC quiver_host.cpp -o libquiver_host_<digest>.so
// (no -march=native: a library built on one CPU may be loaded on another).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Counting sort by row, deterministic and stable in both paths: CSR slots
// within a row always follow COO order, so native and numpy-argsort builds
// produce byte-identical indices/eid, and every process that builds the
// same graph (each worker of a run, a rebuild after a streaming commit)
// gets the same arrays.
//
// Parallel scheme, O(E + T*N) total work: atomic relaxed histogram for
// indptr (order-independent), then a chunked stable scatter — edges are
// split into T contiguous chunks, each thread histograms its own chunk
// per row, a cross-chunk exclusive scan per row turns the histograms into
// deterministic per-(chunk,row) cursors, and each thread scatters only its
// own chunk. Stability holds because chunk order equals COO order. The
// T*N*4B cursor matrix is capped at ~1GB by shrinking T (T=1 degenerates
// to the serial single-pass scatter, still O(E)).
template <typename RowT, typename ColT>
void csr_from_coo_impl(const RowT* rows, const ColT* cols, int64_t n_edges,
                       int64_t n_nodes, int64_t* indptr, int32_t* indices,
                       int64_t* eid) {
  auto serial = [&]() {
    std::vector<int64_t> counts(n_nodes, 0);
    for (int64_t e = 0; e < n_edges; ++e) counts[rows[e]]++;
    indptr[0] = 0;
    for (int64_t i = 0; i < n_nodes; ++i) indptr[i + 1] = indptr[i] + counts[i];
    std::vector<int64_t> cursor(indptr, indptr + n_nodes);
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t slot = cursor[rows[e]]++;
      indices[slot] = (int32_t)cols[e];
      if (eid) eid[slot] = e;
    }
  };
  // uint32 chunk cursors assume per-row degrees < 2^32
  if (max_threads() <= 1 || n_edges >= (int64_t)UINT32_MAX) {
    serial();
    return;
  }
  std::vector<std::atomic<int64_t>> counts(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i)
    counts[i].store(0, std::memory_order_relaxed);
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < n_edges; ++e)
    counts[rows[e]].fetch_add(1, std::memory_order_relaxed);
  indptr[0] = 0;
  for (int64_t i = 0; i < n_nodes; ++i)
    indptr[i + 1] = indptr[i] + counts[i].load(std::memory_order_relaxed);

  // cap the T*N cursor matrix at ~1GB
  int T = max_threads();
  int64_t t_cap = ((int64_t)1 << 30) / (4 * std::max(n_nodes, (int64_t)1));
  if (t_cap < T) T = (int)std::max(t_cap, (int64_t)1);
  if (T <= 1) {
    std::vector<int64_t> cursor(indptr, indptr + n_nodes);
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t slot = cursor[rows[e]]++;
      indices[slot] = (int32_t)cols[e];
      if (eid) eid[slot] = e;
    }
    return;
  }

  // chunk boundaries over the edge list
  std::vector<int64_t> chunk(T + 1);
  for (int t = 0; t <= T; ++t) chunk[t] = n_edges * t / T;

  // per-(chunk,row) histogram; c[t*n_nodes + r]
  std::vector<uint32_t> c((size_t)T * n_nodes, 0);
#pragma omp parallel for schedule(static) num_threads(T)
  for (int t = 0; t < T; ++t) {
    uint32_t* ct = c.data() + (size_t)t * n_nodes;
    for (int64_t e = chunk[t]; e < chunk[t + 1]; ++e) ct[rows[e]]++;
  }
  // exclusive scan across chunks, per row
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_nodes; ++r) {
    uint32_t running = 0;
    for (int t = 0; t < T; ++t) {
      uint32_t tmp = c[(size_t)t * n_nodes + r];
      c[(size_t)t * n_nodes + r] = running;
      running += tmp;
    }
  }
  // stable scatter: thread t owns chunk t and its cursor row
#pragma omp parallel for schedule(static) num_threads(T)
  for (int t = 0; t < T; ++t) {
    uint32_t* ct = c.data() + (size_t)t * n_nodes;
    for (int64_t e = chunk[t]; e < chunk[t + 1]; ++e) {
      int64_t r = (int64_t)rows[e];
      int64_t slot = indptr[r] + (int64_t)(ct[r]++);
      indices[slot] = (int32_t)cols[e];
      if (eid) eid[slot] = e;
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// CSR construction: counting sort by row, O(E) and parallel (vs the numpy
// argsort path's O(E log E) single thread). eid keeps the CSR-slot -> COO
// position mapping.
// ---------------------------------------------------------------------------
void csr_from_coo_i64(const int64_t* rows, const int64_t* cols, int64_t n_edges,
                      int64_t n_nodes, int64_t* indptr /* n_nodes+1 */,
                      int32_t* indices, int64_t* eid) {
  csr_from_coo_impl(rows, cols, n_edges, n_nodes, indptr, indices, eid);
}

void csr_from_coo_i32(const int32_t* rows, const int32_t* cols, int64_t n_edges,
                      int64_t n_nodes, int64_t* indptr, int32_t* indices,
                      int64_t* eid) {
  csr_from_coo_impl(rows, cols, n_edges, n_nodes, indptr, indices, eid);
}

// ---------------------------------------------------------------------------
// Host feature gather: parallel row memcpy out of the (pinned) host table —
// the cold-tier service loop. row_bytes lets one entry point cover any dtype.
// Negative ids produce zero rows (the -1 sentinel contract).
// ---------------------------------------------------------------------------
void gather_rows_bytes(const uint8_t* table, int64_t n_rows, int64_t row_bytes,
                       const int64_t* ids, int64_t n_ids, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_ids; ++i) {
    int64_t id = ids[i];
    uint8_t* dst = out + i * row_bytes;
    if (id < 0 || id >= n_rows)
      std::memset(dst, 0, row_bytes);
    else
      std::memcpy(dst, table + id * row_bytes, row_bytes);
  }
}

// ---------------------------------------------------------------------------
// CPU reservoir sampler: per-seed uniform without-replacement neighbor
// sampling with the padded (n_seeds, k) / -1 contract. Parity with the
// reference CPU tier (quiver.cpp:20-37, std::sample over quiver.cpu.hpp).
// ---------------------------------------------------------------------------
void sample_neighbors_cpu(const int64_t* indptr, const int32_t* indices,
                          const int32_t* seeds, int64_t n_seeds, int32_t k,
                          uint64_t seed, int32_t* out /* n_seeds*k */,
                          int32_t* counts /* n_seeds */) {
#pragma omp parallel
  {
    // per-thread reservoir buffer, reused across rows (no per-row malloc)
    std::vector<int64_t> res(k);
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n_seeds; ++i) {
      int32_t* row_out = out + i * k;
      std::fill(row_out, row_out + k, -1);
      int32_t s = seeds[i];
      if (s < 0) {
        counts[i] = 0;
        continue;
      }
      int64_t lo = indptr[s], hi = indptr[s + 1];
      int64_t deg = hi - lo;
      if (deg <= k) {
        for (int64_t j = 0; j < deg; ++j) row_out[j] = indices[lo + j];
        counts[i] = (int32_t)deg;
      } else {
        // per-row RNG keyed on (seed, row index) so results are
        // reproducible regardless of thread count or schedule
        std::mt19937_64 rng((seed + 1) * 0x9E3779B97F4A7C15ULL ^
                            (uint64_t)i * 0xBF58476D1CE4E5B9ULL);
        for (int32_t j = 0; j < k; ++j) res[j] = j;
        for (int64_t j = k; j < deg; ++j) {
          std::uniform_int_distribution<int64_t> d(0, j);
          int64_t p = d(rng);
          if (p < k) res[p] = j;
        }
        for (int32_t j = 0; j < k; ++j) row_out[j] = indices[lo + res[j]];
        counts[i] = k;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Hash-based order-preserving reindex: frontier = unique(seeds ∪ neighbors)
// with seeds forced first (duplicates kept as distinct slots), neighbor lanes
// rewritten to frontier-local ids. Native parity with the reference's
// CPUQuiver::reindex_group (quiver.cpp:39-84) under this framework's padded
// (-1 sentinel) contract. Serial hash pass (like the reference's); the
// OpenMP pass only rewrites lanes.
// Returns the frontier length. frontier must have room for
// n_seeds + n_seeds*k entries (worst case).
// ---------------------------------------------------------------------------
int64_t reindex_cpu(const int32_t* seeds, int64_t n_seeds,
                    const int32_t* neighbors /* n_seeds*k */, int32_t k,
                    int32_t* frontier /* cap >= n_seeds*(k+1) */,
                    int32_t* col /* n_seeds*k */) {
  std::unordered_map<int32_t, int32_t> first;
  first.reserve((size_t)(n_seeds * (k + 1)));
  int64_t m = 0;
  // forced seed lanes: every valid seed occupies its own slot; the map keeps
  // the FIRST occurrence so later duplicates resolve to it. Intentional
  // divergence from the reference's CPUQuiver::reindex_group (quiver.cpp:56),
  // which overwrites so duplicate seeds map to the LAST slot — this repo's
  // first-occurrence rule matches ops/reindex.py's reindex_layer
  // (masked_unique), which is what this path is tested against.
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t s = seeds[i];
    if (s < 0) continue;
    frontier[m] = s;
    first.emplace(s, (int32_t)m);
    ++m;
  }
  for (int64_t i = 0; i < n_seeds * k; ++i) {
    int32_t v = neighbors[i];
    if (v < 0) continue;
    auto it = first.emplace(v, (int32_t)m);
    if (it.second) frontier[m++] = v;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_seeds * k; ++i) {
    int32_t v = neighbors[i];
    col[i] = v < 0 ? -1 : first.find(v)->second;
  }
  return m;
}

// ---------------------------------------------------------------------------
// Degree computation (indptr diff) — trivial but keeps preprocessing native.
// ---------------------------------------------------------------------------
void degrees_i64(const int64_t* indptr, int64_t n_nodes, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_nodes; ++i) out[i] = indptr[i + 1] - indptr[i];
}

int quiver_host_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
