// K2: row gather over a hot and a cold tier, in one launch:
//   t      = order ? order[ids[j]] : ids[j]           (the degree reorder)
//   out[j] = t < hot_rows ? hot[t] : cold[t - hot_rows]
// for rows of any width and element size (f32, bf16, int8 codes). A negative
// id gives a zero row, or leaves out[j] as it was when `keep_missing` is set.
// The single-table gather (`gather_rows`) is the same kernel with no cold
// tier and no order; the tiered feature lookup (`tiered_gather`) translates
// the id, picks the tier, reads the row once and writes the shared output
// once, with no second launch and no intermediate id tensor.
//
// Replaces the TPU kernel `_gather_kernel` (quiver_tpu/ops/pallas/gather.py:28),
// which issues one DMA per row with 16 rows in flight, and the XLA ops that
// translated ids and merged the tiers around it. Here a warp copies R rows:
// lanes 0..R-1 resolve one row's source each (one coalesced id load, the
// order lookup, the tier pick), the warp shares the sources by shuffle, and
// its lanes then move consecutive words of the R rows laid end to end, in
// chunks of 32 * V words with every load of a chunk issued before its
// stores, so every load and store is coalesced and up to V words per lane
// are in flight. R is chosen by row width: as many rows as fill one chunk,
// at most 4 (at 400 B rows, four rows per warp measured faster than one,
// PERF.md); rows wider than a chunk take one warp each, in several chunks.
//
// Bound: bytes (one read and one write of every gathered row). The word is
// the widest of 16, 8, 4, 2 or 1 bytes that divides the row width and the
// alignment of every base pointer, so a 400 B f32 row moves as 16 B vectors,
// a 200 B bf16 row as 8 B words and a 100 B int8 row as 4 B words, with no
// misaligned access and no tail. The hot tier lives in device memory; the
// cold tier in pinned host memory (a UVA device pointer, read over PCIe, the
// reference's zero-copy design), where the link's rate bounds its rows.
#include "common.cuh"

constexpr int V = 4;             // words in flight per lane: a chunk is 32 * V
constexpr int MAX_ROWS = 4;      // rows per warp at most

template <typename W>
__global__ void gather_kernel(const W* __restrict__ hot,
                              const W* __restrict__ cold,
                              const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ order,
                              long long hot_rows, W* __restrict__ out,
                              long long n_ids, long long row_words,
                              int rows_per_warp, int keep_missing) {
    long long row0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * rows_per_warp;
    int lane = threadIdx.x & 31;
    if (row0 >= n_ids) return;  // uniform across the warp
    int nrows = n_ids - row0 < rows_per_warp ? (int)(n_ids - row0) : rows_per_warp;
    // lane l < nrows resolves row row0 + l: its source, or null for a
    // negative id; `keep` marks a negative id whose out row stays
    const W* src = nullptr;
    int keep = 0;
    if (lane < nrows) {
        int id = ids[row0 + lane];
        if (id < 0) {
            keep = keep_missing;
        } else {
            long long t = order != nullptr ? (long long)order[id] : (long long)id;
            src = t < hot_rows ? hot + t * row_words : cold + (t - hot_rows) * row_words;
        }
    }
    long long total = nrows * row_words;
    W* dst = out + row0 * row_words;
    for (long long c0 = 0; c0 < total; c0 += 32 * V) {
        W v[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
            long long j = c0 + lane + 32 * u;
            int row = (int)(j / row_words);
            row = row < nrows ? row : nrows - 1;
            const W* s = (const W*)__shfl_sync(0xffffffffu, (long long)src, row);
            v[u] = (j < total && s != nullptr) ? s[j - row * row_words] : W{};
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
            long long j = c0 + lane + 32 * u;
            int row = (int)(j / row_words);
            row = row < nrows ? row : nrows - 1;
            int k = __shfl_sync(0xffffffffu, keep, row);
            if (j < total && !k) dst[j] = v[u];
        }
    }
}

struct GatherArgs {
    const void* hot;          // rows [0, hot_rows); null when cold holds all
    const void* cold;         // rows [hot_rows, N); null when hot holds all
    const int32_t* ids;
    const int32_t* order;     // null: t = id
    long long hot_rows;
    void* out;
    long long n_ids;
    long long row_bytes;
    long long keep_missing;
    void* stream;
};
static_assert(sizeof(GatherArgs) == 10 * 8, "GatherArgs is 10 packed fields");

template <typename W>
static void launch(const GatherArgs* a) {
    const int threads = 256;  // 8 warps
    long long words = a->row_bytes / (long long)sizeof(W);
    long long fit = 32 * V / words;
    int rows = fit < 1 ? 1 : (fit > MAX_ROWS ? MAX_ROWS : (int)fit);
    long long warps = (a->n_ids + rows - 1) / rows;
    unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
    gather_kernel<W><<<blocks, threads, 0, (cudaStream_t)a->stream>>>(
        (const W*)a->hot, (const W*)a->cold, a->ids, a->order, a->hot_rows,
        (W*)a->out, a->n_ids, words, rows, (int)a->keep_missing);
}

// Takes its arguments as one struct of 8-byte fields (ctypes passes it as
// one pointer); returns the launch's CUDA error code (0 on success).
extern "C" int quiver_gather(const GatherArgs* a) {
    if (a->n_ids == 0 || a->row_bytes == 0) return 0;
    uintptr_t w = (uintptr_t)a->hot | (uintptr_t)a->cold | (uintptr_t)a->out |
                  (uintptr_t)a->row_bytes;
    if (w % 16 == 0) {
        launch<uint4>(a);
    } else if (w % 8 == 0) {
        launch<uint2>(a);
    } else if (w % 4 == 0) {
        launch<uint32_t>(a);
    } else if (w % 2 == 0) {
        launch<uint16_t>(a);
    } else {
        launch<uint8_t>(a);
    }
    return (int)cudaGetLastError();
}
