// K2: row gather over a hot and a cold tier, in one launch:
//   t      = order ? order[min(ids[j], n_rows - 1)] : min(ids[j], n_rows - 1)
//   out[j] = t < hot_rows ? hot[t] : cold[t - hot_rows]
// for rows of any width and element size (f32, bf16, int8 codes). A negative
// id gives a zero row, or leaves out[j] as it was when `keep_missing` is set.
// An id of n_rows or more reads row n_rows - 1, as the XLA gathers of the
// JAX package clamp, so no id can read past a table. The single-table gather
// (`gather_rows`) is the same kernel with no cold tier and no order; the
// tiered feature lookup (`tiered_gather`) translates the id, picks the tier,
// reads the row once and writes the shared output once, with no second
// launch and no intermediate id tensor. Its int8 sibling
// (`tiered_gather_dequant`) reads int8 codes and writes float32 rows,
//   out[j][f] = __fmul_rn((float)q[t][f], scale[t]),
// the JAX package's one multiply per element, in the same launch.
//
// Replaces the TPU kernel `_gather_kernel` (quiver_tpu/ops/pallas/gather.py:28),
// which issues one DMA per row with 16 rows in flight, and the XLA ops that
// translated ids, dequantised int8 rows and merged the tiers around it. Here
// a warp copies R rows: lanes 0..R-1 resolve one row's source each (one
// coalesced id load, the clamp, the order lookup, the tier pick, and for
// int8 rows the row's scale), the warp shares them by shuffle, and its lanes
// then move consecutive words of the R rows laid end to end, in chunks of
// 32 * V words with every load of a chunk issued before its stores, so every
// load and store is coalesced and up to V words per lane are in flight. R is
// chosen by row width: as many rows as fill one chunk, at most 4 (at 400 B
// rows, four rows per warp measured faster than one, PERF.md); rows wider
// than a chunk take one warp each, in several chunks.
//
// Bound: bytes (one read and one write of every gathered row; for int8 rows
// also one 4 B scale read per row, and 4 B written per 1 B code read). The
// word is the widest of 16, 8, 4, 2 or 1 bytes that divides the row width
// and the alignment of every base pointer, so a 400 B f32 row moves as 16 B
// vectors, a 200 B bf16 row as 8 B words and a 100 B int8 row as 4 B words,
// with no misaligned access and no tail; the dequantising kernel reads code
// words of 4, 2 or 1 bytes (4 codes at F=100, 2 at F=602) and stores their
// floats as one 16, 8 or 4 B vector. The hot tier lives in device memory;
// the cold tier in pinned host memory (a UVA device pointer, read over PCIe,
// the reference's zero-copy design), where the link's rate bounds its rows.
#include "common.cuh"

constexpr int V = 4;             // words in flight per lane: a chunk is 32 * V
constexpr int MAX_ROWS = 4;      // rows per warp at most
constexpr int THREADS = 256;     // 8 warps, every launch of this file

// The source row of id `id` (null for a negative id or an empty table) and
// its translated row `t`, clamped to the table.
template <typename W>
__device__ __forceinline__ const W* row_source(int id, const int32_t* order,
                                               const W* hot, const W* cold,
                                               long long hot_rows, long long n_rows,
                                               long long row_words, long long* t_out) {
    if (id < 0 || n_rows == 0) return nullptr;
    long long c = (long long)id < n_rows ? (long long)id : n_rows - 1;
    long long t = order != nullptr ? (long long)order[c] : c;
    *t_out = t;
    return t < hot_rows ? hot + t * row_words : cold + (t - hot_rows) * row_words;
}

template <typename W>
__global__ void gather_kernel(const W* __restrict__ hot,
                              const W* __restrict__ cold,
                              const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ order,
                              long long hot_rows, long long n_rows,
                              W* __restrict__ out,
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
        long long t;
        src = row_source(id, order, hot, cold, hot_rows, n_rows, row_words, &t);
        keep = id < 0 ? keep_missing : 0;
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

// C floats, stored as one vector: the dequantised codes of one code word
template <int C> struct Floats;
template <> struct Floats<4> { using T = float4; };
template <> struct Floats<2> { using T = float2; };
template <> struct Floats<1> { using T = float; };

// The C codes of word w, each times s (one f32 multiply, as the JAX package's
// `codes.astype(f32) * scale`).
__device__ __forceinline__ float4 dequant(uint32_t w, float s) {
    return make_float4(__fmul_rn((float)(int8_t)(w & 0xff), s),
                       __fmul_rn((float)(int8_t)((w >> 8) & 0xff), s),
                       __fmul_rn((float)(int8_t)((w >> 16) & 0xff), s),
                       __fmul_rn((float)(int8_t)(w >> 24), s));
}
__device__ __forceinline__ float2 dequant(uint16_t w, float s) {
    return make_float2(__fmul_rn((float)(int8_t)(w & 0xff), s),
                       __fmul_rn((float)(int8_t)(w >> 8), s));
}
__device__ __forceinline__ float dequant(uint8_t w, float s) {
    return __fmul_rn((float)(int8_t)w, s);
}

// gather_kernel's warp layout over int8 codes in words of W, writing float32
// rows: a word of C codes becomes one store of C floats. A negative id gives
// a zero row.
template <typename W>
__global__ void gather_dequant_kernel(const W* __restrict__ hot,
                                      const W* __restrict__ cold,
                                      const float* __restrict__ scale,
                                      const int32_t* __restrict__ ids,
                                      const int32_t* __restrict__ order,
                                      long long hot_rows, long long n_rows,
                                      float* __restrict__ out,
                                      long long n_ids, long long row_words,
                                      int rows_per_warp) {
    constexpr int C = sizeof(W);
    using F = typename Floats<C>::T;
    long long row0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * rows_per_warp;
    int lane = threadIdx.x & 31;
    if (row0 >= n_ids) return;  // uniform across the warp
    int nrows = n_ids - row0 < rows_per_warp ? (int)(n_ids - row0) : rows_per_warp;
    const W* src = nullptr;
    float sc = 0.0f;
    if (lane < nrows) {
        long long t;
        src = row_source(ids[row0 + lane], order, hot, cold, hot_rows, n_rows,
                         row_words, &t);
        if (src != nullptr) sc = scale[t];
    }
    long long total = nrows * row_words;
    F* dst = (F*)(out + row0 * row_words * C);
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
            float s = __shfl_sync(0xffffffffu, sc, row);
            // a zero row for a negative id: zero codes times scale 0
            if (j < total) dst[j] = dequant(v[u], s);
        }
    }
}

struct GatherArgs {
    const void* hot;          // rows [0, hot_rows); null when cold holds all
    const void* cold;         // rows [hot_rows, n_rows); null when hot holds all
    const int32_t* ids;
    const int32_t* order;     // null: t = id
    const float* scale;       // (n_rows,) per-row scales of int8 codes; dequant only
    long long hot_rows;
    long long n_rows;         // ids >= n_rows read row n_rows - 1
    void* out;
    long long n_ids;
    long long row_bytes;      // bytes of a stored row (the codes, for int8)
    long long keep_missing;   // gather only
    void* stream;
};
static_assert(sizeof(GatherArgs) == 12 * 8, "GatherArgs is 12 packed fields");

// rows per warp: as many rows of `words` words as fill one chunk, 1 to MAX_ROWS
static int rows_per_warp(long long words) {
    long long fit = 32 * V / words;
    return fit < 1 ? 1 : (fit > MAX_ROWS ? MAX_ROWS : (int)fit);
}

static unsigned blocks_for(long long n_ids, int rows, int threads) {
    long long warps = (n_ids + rows - 1) / rows;
    return (unsigned)((warps * 32 + threads - 1) / threads);
}

template <typename W>
static void launch(const GatherArgs* a) {
    const int threads = THREADS;
    long long words = a->row_bytes / (long long)sizeof(W);
    int rows = rows_per_warp(words);
    gather_kernel<W><<<blocks_for(a->n_ids, rows, threads), threads, 0,
                       (cudaStream_t)a->stream>>>(
        (const W*)a->hot, (const W*)a->cold, a->ids, a->order, a->hot_rows,
        a->n_rows, (W*)a->out, a->n_ids, words, rows, (int)a->keep_missing);
}

template <typename W>
static void launch_dequant(const GatherArgs* a) {
    const int threads = THREADS;
    long long words = a->row_bytes / (long long)sizeof(W);
    int rows = rows_per_warp(words);
    gather_dequant_kernel<W><<<blocks_for(a->n_ids, rows, threads), threads, 0,
                               (cudaStream_t)a->stream>>>(
        (const W*)a->hot, (const W*)a->cold, a->scale, a->ids, a->order,
        a->hot_rows, a->n_rows, (float*)a->out, a->n_ids, words, rows);
}

// Each entry takes its arguments as one struct of 8-byte fields (ctypes
// passes it as one pointer); returns the launch's CUDA error code (0 on
// success).
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

// int8 codes in, float32 rows out: the code word (4, 2 or 1 codes) is the
// widest that divides the code row's width and the alignment of both code
// tables; the output (4 B per code, from torch.empty) is then aligned for
// its vector of floats.
extern "C" int quiver_gather_dequant(const GatherArgs* a) {
    if (a->n_ids == 0 || a->row_bytes == 0) return 0;
    uintptr_t w = (uintptr_t)a->hot | (uintptr_t)a->cold | (uintptr_t)a->row_bytes;
    if (w % 4 == 0) {
        launch_dequant<uint32_t>(a);
    } else if (w % 2 == 0) {
        launch_dequant<uint16_t>(a);
    } else {
        launch_dequant<uint8_t>(a);
    }
    return (int)cudaGetLastError();
}

// The audit's kernel check (common.cuh): every instantiation of this file.
extern "C" int quiver_kernel_attrs(KernelAttrs* out, int cap) {
    static const KernelRow rows[] = {
        {(const void*)gather_kernel<uint4>, "gather_kernel<uint4>", "gather", THREADS},
        {(const void*)gather_kernel<uint2>, "gather_kernel<uint2>", "gather", THREADS},
        {(const void*)gather_kernel<uint32_t>, "gather_kernel<uint32_t>", "gather", THREADS},
        {(const void*)gather_kernel<uint16_t>, "gather_kernel<uint16_t>", "gather", THREADS},
        {(const void*)gather_kernel<uint8_t>, "gather_kernel<uint8_t>", "gather", THREADS},
        {(const void*)gather_dequant_kernel<uint32_t>, "gather_dequant_kernel<uint32_t>",
         "gather_dequant", THREADS},
        {(const void*)gather_dequant_kernel<uint16_t>, "gather_dequant_kernel<uint16_t>",
         "gather_dequant", THREADS},
        {(const void*)gather_dequant_kernel<uint8_t>, "gather_dequant_kernel<uint8_t>",
         "gather_dequant", THREADS},
    };
    return fill_kernel_attrs(out, cap, rows, (int)(sizeof(rows) / sizeof(rows[0])));
}
