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
// (`tiered_gather_dequant`, gather_dequant_kernel below, with its own note)
// reads int8 codes and writes float32 rows,
//   out[j][f] = __fmul_rn((float)q[t][f], scale[t]),
// the JAX package's one multiply per element, in the same launch.
//
// Replaces the TPU kernel `_gather_kernel` (quiver_tpu/ops/pallas/gather.py:28),
// which issues one DMA per row with 16 rows in flight, and the XLA ops that
// translated ids and merged the tiers around it. Here a warp copies R rows:
// lanes 0..R-1 resolve one row's source each (one coalesced id load, the
// clamp, the order lookup, the tier pick), the warp shares them by shuffle,
// and its lanes then move consecutive words of the R rows laid end to end,
// in chunks of 32 * V words with every load of a chunk issued before its
// stores, so every load and store is coalesced and up to V words per lane
// are in flight. R is chosen by row width: as many rows as fill one chunk,
// at most 4 (at 400 B rows, four rows per warp measured faster than one,
// PERF.md); rows wider than a chunk take one warp each, in several chunks.
//
// Bound: bytes (one read and one write of every gathered row). The word is
// the widest of 16, 8, 4, 2 or 1 bytes that divides the row width and the
// alignment of every base pointer, so a 400 B f32 row moves as 16 B vectors
// and a 200 B bf16 row as 8 B words, with no misaligned access and no tail.
// The hot tier lives in device memory; the cold tier in pinned host memory
// (a UVA device pointer, read over PCIe, the reference's zero-copy design),
// where the link's rate bounds its rows.
#include "common.cuh"

#include <atomic>

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

// ---- K2's int8 entry (tiered_gather_dequant) ----------------------------
//
// Replaces the TPU kernel `_gather_kernel` (quiver_tpu/ops/pallas/gather.py:28)
// where it reads int8 codes, and the XLA ops around it in
// quiver_tpu/feature/feature.py (`_dequant_fn` / `wrap_dequant_gathers`, the
// `codes.astype(f32) * scale[t]` after `tiered_lookup`'s id translation,
// clamp and tier merge): one launch computes
//   t      = order ? order[min(id, n_rows - 1)] : min(id, n_rows - 1)
//   out[j] = __fmul_rn((float)q[t][f], scale[t]),   a zero row for id < 0.
//
// Bound: bytes. On the card, the ids, order and scale reads, the hot code
// rows and the float32 output (4 B written per 1 B code read) at 3.35 TB/s;
// the cold code rows cross PCIe from pinned host memory (UVA), bounded by
// the pinned copy rate (50-55 GB/s on the H100's hosts). The measured cold
// rates fit reads from SMs being served a 128 B line at a time at a rate
// set by the host (rows of 128 B on line boundaries read at 26-30 GB/s on
// one host; every rate about twice that on another; PERF.md), so a cold
// row costs the lines it touches, and the design keeps many lines in
// flight, each read in as few requests as the row allows. What each part
// of it does about the limits of the warp-per-rows layout it replaces:
//
// - Wide reads whatever the row's alignment. A code row of F bytes at any
//   byte address is read as the 16 B-aligned granules from floor16(src) to
//   ceil16(src + F), 16 B a lane, consecutive lanes on consecutive granules,
//   so every request is a whole 16 B word of a contiguous run (a 64 B or
//   128 B load instruction before, at F = 602 or 100). The bytes of the row
//   are then cut out of shared memory. Reading the whole granule cannot
//   fault: allocations are mapped in whole pages (device memory, and pinned
//   host memory read through cudaHostGetDevicePointer, at page granularity),
//   a page is a multiple of 16 B, so a 16 B-aligned granule that holds any
//   byte of a table (or of a view into one) lies inside a page the table's
//   allocation maps. Over PCIe the over-read costs nothing: a row already
//   spans whole 32 B sectors.
// - Many rows in flight. Each warp owns a ring of DQ_DEPTH stage slots in
//   shared memory. A stage is up to DQ_ITEMS items (a row, or a DQ_SEG-code
//   segment of a wider row) whose granules fit one DQ_GRANULES slot; its
//   copies are issued as cp.async.ca 16 B into the slot, one commit group
//   per stage, DQ_DEPTH - 1 stages ahead of the one being converted. So a
//   warp keeps up to DQ_DEPTH KB of codes in flight instead of one chunk,
//   and pays one round trip per DQ_DEPTH stages instead of per chunk.
//   `.ca` (through L1) is the route: `.cg` read cold rows at 0.33-0.47 of
//   its rate, and one cp.async.bulk per row envelope on an mbarrier at
//   0.35-0.56 of it (PERF.md), so neither is kept.
// - Little integer work per byte. Each lane's (item, granule) pairs of a
//   stage and its (item, vector) walk are fixed per launch: computed once,
//   then advanced by adds. A stage's items are resolved by one lane each
//   (id, clamp, order, tier, scale) into shared memory, not shuffled per
//   word; no 64-bit division runs per word.
// - Wide stores. Each lane turns S consecutive codes (S = 4, 2 or 1: the
//   widest that divides F) into one float4, float2 or float store, each
//   code times the row's scale with __fmul_rn (the JAX package's one
//   multiply per element; bitwise tiered_gather_plain). The codes are read
//   from shared memory as two aligned words and a funnel shift.
// - A persistent grid. The launch fills the SMs at the occupancy the
//   ring's shared memory allows (never more blocks than there are stages),
//   and each warp walks a strided list of stages, so the ring's depth, not
//   the grid, sets the bytes in flight. Hot and cold rows share the
//   pipeline; a launch of a few rows is one small grid.
constexpr int DQ_GRANULES = 64;                  // 16 B granules in a stage slot (1 KB)
constexpr int DQ_SEG = (DQ_GRANULES - 1) * 16;   // codes of an item at most (1008)
constexpr int DQ_ITEMS = 32;                     // items in a stage at most: one lane each
constexpr int DQ_DEPTH = 4;                      // stages in flight per warp
constexpr int DQ_WARPS = THREADS / 32;

// One item of a stage, written by its resolving lane: where its floats go
// (-1: past the last id), its row's scale, and `meta` = the row's offset in
// its first granule (bits 0-3) | its code count (bits 4-14) | 1 << 15 when
// it reads a row (clear for a negative id: a zero row).
struct __align__(16) DqItem {
    long long out;
    float scale;
    int meta;
};
constexpr int DQ_CODES = DQ_GRANULES * 16 + 16;  // the slot's codes and 16 B of pad
constexpr int DQ_SLOT = DQ_CODES + DQ_ITEMS * (int)sizeof(DqItem);
constexpr int DQ_SMEM = DQ_WARPS * DQ_DEPTH * DQ_SLOT;  // dynamic shared bytes a block
static_assert(DQ_SMEM <= 232448, "a block's ring must fit an SM's 232,448 B");

struct DqParams {
    const char* hot;
    const char* cold;
    const float* scale;
    const int32_t* ids;
    const int32_t* order;
    float* out;
    long long hot_rows, n_rows, F;
    long long n_items;   // n_ids * segs
    long long n_stages;  // ceil(n_items / items)
    int segs;            // items per row: ceil(F / DQ_SEG)
    int seg_codes;       // codes of a full item: min(F, DQ_SEG)
    int env;             // granules a slot reserves per item: ceil((seg_codes + 15) / 16)
    int items;           // items per stage: min(DQ_ITEMS, DQ_GRANULES / env)
};

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

// S codes starting at byte `b` of a slot, as the low bytes of a word: two
// aligned 4 B reads and a funnel shift (the slot's pad keeps the second
// read inside the ring).
template <int S>
__device__ __forceinline__ uint32_t slot_codes(const unsigned char* b) {
    if constexpr (S == 1) {
        return *b;
    } else {
        uintptr_t a = (uintptr_t)b;
        const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
        return __funnelshift_r(w[0], w[1], (unsigned)(a & 3) * 8);
    }
}

// One 16 B granule of a code table (device memory, or pinned host memory
// over UVA) into shared memory, asynchronously, through L1 (`.ca`).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src)
                 : "memory");
}

// Copy slot position `pos` (item `ik`, granule `ig` of it) if that item's
// envelope holds it; the item's first granule `g0` and granule count `ng`
// sit in lane `ik` (every lane calls this: it shuffles).
__device__ __forceinline__ void dq_copy(unsigned char* codes, int pos, int ik, int ig,
                                        int items, const char* g0, int ng) {
    int k = ik < 32 ? ik : 31;
    const char* gb = (const char*)__shfl_sync(0xffffffffu, (long long)g0, k);
    int n = __shfl_sync(0xffffffffu, ng, k);
    if (ik < items && ig < n) cp_async16(codes + pos * 16, gb + ig * 16);
}

// Resolve stage `st`'s items (lane k: item k) into the slot `codes` and
// issue the copies of their granules as one commit group (an empty group
// past the last stage). Lane `lane` copies slot positions lane (item ik0,
// granule ig0) and lane + 32 (ik1, ig1).
__device__ __forceinline__ void dq_issue(const DqParams& p, long long st, int lane,
                                         unsigned char* codes, int ik0, int ig0,
                                         int ik1, int ig1) {
    const char* g0 = nullptr;
    int ng = 0;
    if (st < p.n_stages && lane < p.items) {
        long long item = st * p.items + lane;
        DqItem it{-1, 0.0f, 0};
        if (item < p.n_items) {
            long long row = p.segs == 1 ? item : item / p.segs;
            int seg = (int)(item - row * p.segs);
            long long rest = p.F - (long long)seg * DQ_SEG;
            int c = rest < p.seg_codes ? (int)rest : p.seg_codes;
            it.out = row * p.F + (long long)seg * DQ_SEG;
            it.meta = c << 4;
            int id = p.ids[row];
            if (id >= 0 && p.n_rows > 0) {
                long long cl = (long long)id < p.n_rows ? (long long)id : p.n_rows - 1;
                long long t = p.order != nullptr ? (long long)p.order[cl] : cl;
                const char* src = (t < p.hot_rows ? p.hot + t * p.F
                                                  : p.cold + (t - p.hot_rows) * p.F)
                                  + (long long)seg * DQ_SEG;
                int off = (int)((uintptr_t)src & 15);
                g0 = src - off;
                ng = (off + c + 15) >> 4;
                it.scale = p.scale[t];
                it.meta |= off | (1 << 15);
            }
        }
        ((DqItem*)(codes + DQ_CODES))[lane] = it;
    }
    dq_copy(codes, lane, ik0, ig0, p.items, g0, ng);
    dq_copy(codes, lane + 32, ik1, ig1, p.items, g0, ng);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Dequantise the slot `codes`' items into their output rows: this lane's
// vectors v = lane + 32 i, i < nv, as (item k, vector w), from (k0, w0) in
// steps of (dk, dw).
template <int S>
__device__ __forceinline__ void dq_convert(const DqParams& p, const unsigned char* codes,
                                           int k0, int w0, int dk, int dw, int vpi, int nv) {
    using F4 = typename Floats<S>::T;
    const DqItem* items = (const DqItem*)(codes + DQ_CODES);
    int k = k0, w = w0;
    for (int i = 0; i < nv; ++i) {
        if (k < p.items) {
            DqItem it = items[k];
            int c = (it.meta >> 4) & 0x7ff;
            if (it.out >= 0 && w * S < c) {
                uint32_t word = slot_codes<S>(codes + k * p.env * 16 + (it.meta & 15) + w * S);
                if (!(it.meta >> 15)) word = 0;  // a zero row: zero codes times 0
                F4 v;
                if constexpr (S == 4) v = dequant(word, it.scale);
                else if constexpr (S == 2) v = dequant((uint16_t)word, it.scale);
                else v = dequant((uint8_t)word, it.scale);
                *(F4*)(p.out + it.out + w * S) = v;
            }
        }
        w += dw;
        k += dk;
        if (w >= vpi) {
            w -= vpi;
            ++k;
        }
    }
}

// S codes a vector: every launch with F % S == 0 (S = 4, 2, 1 floats a store).
template <int S>
__global__ void __launch_bounds__(THREADS)
gather_dequant_kernel(const DqParams p) {
    extern __shared__ __align__(16) unsigned char dq_smem[];
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    if (warp >= p.n_stages) return;  // uniform across the warp
    unsigned char* ring = dq_smem + (threadIdx.x >> 5) * (DQ_DEPTH * DQ_SLOT);
    // this lane's slot positions lane and lane + 32 as (item, granule), and
    // its vectors of a stage: fixed for the launch
    const int ik0 = lane / p.env, ig0 = lane - ik0 * p.env;
    const int ik1 = (lane + 32) / p.env, ig1 = lane + 32 - ik1 * p.env;
    const int vpi = p.seg_codes / S;
    const int nv = (p.items * vpi + 31) / 32;
    const int k0 = lane / vpi, w0 = lane - k0 * vpi;
    const int dk = 32 / vpi, dw = 32 - dk * vpi;

    // stage i of this warp is stage warp + i * warps, in slot i % DQ_DEPTH
    const long long mine = (p.n_stages - warp + warps - 1) / warps;
#pragma unroll
    for (int d = 0; d < DQ_DEPTH; ++d)
        dq_issue(p, warp + d * warps, lane, ring + d * DQ_SLOT, ik0, ig0, ik1, ig1);
    for (long long i = 0; i < mine; ++i) {
        unsigned char* codes = ring + (int)(i % DQ_DEPTH) * DQ_SLOT;
        asm volatile("cp.async.wait_group %0;\n" :: "n"(DQ_DEPTH - 1) : "memory");
        __syncwarp();
        dq_convert<S>(p, codes, k0, w0, dk, dw, vpi, nv);
        __syncwarp();
        dq_issue(p, warp + (i + DQ_DEPTH) * warps, lane, codes, ik0, ig0, ik1, ig1);
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

// Blocks of gather_dequant_kernel<S> an SM holds at DQ_SMEM bytes a block
// on the current device (its shared memory limit raised first when DQ_SMEM
// is over the default 48 KB), and the device's SM count; 0 on an error.
constexpr int MAX_DEVICES = 64;

template <int S>
static cudaError_t dequant_grid(int* sms, int* per_sm) {
    static std::atomic<int> cached_sms[MAX_DEVICES], cached_per_sm[MAX_DEVICES];
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && cached_per_sm[dev].load(std::memory_order_relaxed) > 0) {
        *sms = cached_sms[dev].load(std::memory_order_relaxed);
        *per_sm = cached_per_sm[dev].load(std::memory_order_relaxed);
        return cudaSuccess;
    }
    if (DQ_SMEM > 48 * 1024) {
        err = cudaFuncSetAttribute(gather_dequant_kernel<S>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
        if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gather_dequant_kernel<S>,
                                                        THREADS, DQ_SMEM);
    if (err != cudaSuccess) return err;
    if (*per_sm < 1) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) {
        cached_sms[dev].store(*sms, std::memory_order_relaxed);
        cached_per_sm[dev].store(*per_sm, std::memory_order_relaxed);
    }
    return cudaSuccess;
}

template <int S>
static int launch_dequant(const GatherArgs* a) {
    DqParams p;
    p.hot = (const char*)a->hot;
    p.cold = (const char*)a->cold;
    p.scale = a->scale;
    p.ids = a->ids;
    p.order = a->order;
    p.out = (float*)a->out;
    p.hot_rows = a->hot_rows;
    p.n_rows = a->n_rows;
    p.F = a->row_bytes;
    p.segs = (int)((p.F + DQ_SEG - 1) / DQ_SEG);
    p.seg_codes = p.F < DQ_SEG ? (int)p.F : DQ_SEG;
    p.env = (p.seg_codes + 30) / 16;
    p.items = DQ_GRANULES / p.env < DQ_ITEMS ? DQ_GRANULES / p.env : DQ_ITEMS;
    p.n_items = a->n_ids * p.segs;
    p.n_stages = (p.n_items + p.items - 1) / p.items;
    int sms, per_sm;
    cudaError_t err = dequant_grid<S>(&sms, &per_sm);
    if (err != cudaSuccess) return (int)err;
    long long want = (p.n_stages + DQ_WARPS - 1) / DQ_WARPS;
    long long full = (long long)sms * per_sm;
    unsigned blocks = (unsigned)(want < full ? want : full);
    gather_dequant_kernel<S><<<blocks, THREADS, DQ_SMEM, (cudaStream_t)a->stream>>>(p);
    return (int)cudaGetLastError();
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

// int8 codes in, float32 rows out: S, the floats a lane stores at once, is
// the widest of 4, 2 or 1 that divides F and the output's alignment (the
// code tables may sit at any byte address: they are read in granules).
extern "C" int quiver_gather_dequant(const GatherArgs* a) {
    if (a->n_ids == 0 || a->row_bytes == 0) return 0;
    uintptr_t w = (uintptr_t)a->out | (uintptr_t)(a->row_bytes * 4);
    if (w % 16 == 0) return launch_dequant<4>(a);
    if (w % 8 == 0) return launch_dequant<2>(a);
    return launch_dequant<1>(a);
}

// The audit's kernel check (common.cuh): every instantiation of this file.
extern "C" int quiver_kernel_attrs(KernelAttrs* out, int cap) {
    static const KernelRow rows[] = {
        {(const void*)gather_kernel<uint4>, "gather_kernel<uint4>", "gather", THREADS},
        {(const void*)gather_kernel<uint2>, "gather_kernel<uint2>", "gather", THREADS},
        {(const void*)gather_kernel<uint32_t>, "gather_kernel<uint32_t>", "gather", THREADS},
        {(const void*)gather_kernel<uint16_t>, "gather_kernel<uint16_t>", "gather", THREADS},
        {(const void*)gather_kernel<uint8_t>, "gather_kernel<uint8_t>", "gather", THREADS},
        {(const void*)gather_dequant_kernel<4>, "gather_dequant_kernel<4>",
         "gather_dequant", THREADS, DQ_SMEM},
        {(const void*)gather_dequant_kernel<2>, "gather_dequant_kernel<2>",
         "gather_dequant", THREADS, DQ_SMEM},
        {(const void*)gather_dequant_kernel<1>, "gather_dequant_kernel<1>",
         "gather_dequant", THREADS, DQ_SMEM},
    };
    return fill_kernel_attrs(out, cap, rows, (int)(sizeof(rows) / sizeof(rows[0])));
}
