// Segment mean over CSR rows, the layer-wise inference's neighbour mean:
//   out[r] = (sum over e in [indptr[r], indptr[r + 1]) of table[indices[e]])
//            / max(indptr[r + 1] - indptr[r], 1)
// for every row r, in one launch, over a float32, bfloat16 or float16 table
// of any width. Each element sums its row's edges in CSR order from 0.0f
// with plain IEEE float adds (no reassociation, no fast math), then divides
// by the degree with an IEEE division, so a float32 row is bitwise the
// sequential sum the card's sorted accumulate (`index_put_(accumulate=True)`
// then `acc / deg`) gives. A 16-bit table is summed in float32 in registers
// and rounded once, when the row is stored. A zero-degree row is zeros.
//
// Replaces no Pallas kernel: the JAX package leaves this sum to an XLA
// scatter or a cumsum-difference scan (quiver_tpu/models/inference.py). Its
// port walked the edge array in chunks, wrote each chunk's messages
// `table[indices[e]]` to device memory (up to 2 GB a chunk), searched the
// chunk's destinations in indptr, and read the messages back through a
// sorted accumulate that reloads and stores the output row once per edge.
//
// Bound: bytes. Each edge's source row is read once (E * F * 4 B for
// float32), the ids once (4 B an edge) and each output row written once; at
// ogbn-products' shapes that is about 310 GB a three-layer pass, 93 ms at
// 3.35 TB/s. Rows drawn again (high-degree sources) may come from L2, and
// there the kernel ran past the bound (1.11 of it at F = 100, 1.33 at
// F = 256). What the design does about the bound:
//
// - No intermediate. A warp owns an item, a slice of one output row's
//   columns: it reads the row's ids, 32 at a time, coalesced (the next 32
//   already in flight), broadcasts them by shuffle, reads the slice of each
//   source row into registers and adds it. Nothing but the ids, the source
//   rows and the output row touches memory.
// - Wide, coalesced words. Consecutive lanes read consecutive words of a
//   source row, each the widest of 16, 8, 4 or 2 bytes that divides the row
//   and the table's and the output's alignment (F = 100 float32: 25 lanes of
//   float4; F = 256: two items of 32 float4 lanes).
// - Enough in flight. A lane keeps RING 4-byte registers of loads
//   outstanding, all issued before the first of them is added (4 edges of
//   16 B words), at 64 registers a thread so that 32 warps fit an SM. On
//   the H100 occupancy paid more than depth: 16 registers at 4 blocks an SM
//   ran F = 100 in 13.7 ms and F = 256 in 29.0 ms at ogbn-products' shapes,
//   12 at 4 blocks 14.8 / 30.3, 16 at 3 blocks 17.5 / 32.7, 64 at 1 block
//   92.5 / 106.1, and deeper rings at 4 blocks spilled and lost (PERF.md).
//   A 16-bit table's sums take twice the registers of its words, so its
//   kernels keep RING_16BIT, the most that spills nothing at 64.
// - Few registers live. The block's rows' bounds and first items sit in
//   shared memory, and a row's edges are counted in 32 bits from its own
//   first id, so nothing but the ring, the sums and the ids stays live.
// - Long rows split by columns, never by edges. A row of degree HEAVY_DEG or
//   more (Pareto rows reach 17,481) takes items of 128 B (32 lanes of 4 B
//   words) with RING edges in flight a lane: its work spreads over four
//   times the warps, each with four times the edges in flight, so its time
//   shrinks about fourfold while every element keeps its order of adds. The
//   choice is made per row from its degree and the row's width; without it
//   the same shapes ran 2-3% slower, and splitting from degree 256, 1,024
//   or 16,384 up gained less than from 4,096.
// - Balanced blocks. A block of WARPS warps owns WARPS consecutive rows; its
//   warps deal out the rows' items in turn (item i to warp i % WARPS).
// - 64-bit offsets. Edge offsets come from the int64 indptr and row offsets
//   are computed in 64 bits, so N x F past 2^31 is fine (a row's own degree
//   and width stay below 2^31 and 2^30 bytes).
// - Ids where they lie. `indices` is device memory, or pinned host memory
//   read over UVA (the HOST placement): the same kernel reads both.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

constexpr int THREADS = 256;           // 8 warps, every launch of this file
constexpr int WARPS = THREADS / 32;    // rows a block owns
constexpr int MIN_BLOCKS = 4;          // blocks an SM holds: 64 registers a thread
constexpr int RING = 16;               // 4-byte registers of loads in flight a lane
constexpr int RING_16BIT = 12;         // the same for 16-bit tables (twice the floats of sums)
constexpr long long HEAVY_DEG = 4096;  // rows of this degree or more take 128 B items
constexpr int HEAVY_BYTES = 128;       // bytes of a long row's item: 32 lanes of 4 B
constexpr unsigned FULL = 0xffffffffu;

// A word of B bytes as its 32-bit parts (a 2-byte word in the low half of one)
template <int B>
struct Word {
    static constexpr int P = B >= 4 ? B / 4 : 1;
    uint32_t x[P];
};

template <int B>
__device__ __forceinline__ Word<B> load_word(const char* p) {
    Word<B> w;
    if constexpr (B == 16) {
        uint4 v = __ldg((const uint4*)p);
        w.x[0] = v.x; w.x[1] = v.y; w.x[2] = v.z; w.x[3] = v.w;
    } else if constexpr (B == 8) {
        uint2 v = __ldg((const uint2*)p);
        w.x[0] = v.x; w.x[1] = v.y;
    } else if constexpr (B == 4) {
        w.x[0] = __ldg((const unsigned int*)p);
    } else {
        w.x[0] = __ldg((const unsigned short*)p);
    }
    return w;
}

template <int B>
__device__ __forceinline__ void store_word(char* p, const Word<B>& w) {
    if constexpr (B == 16) {
        *(uint4*)p = make_uint4(w.x[0], w.x[1], w.x[2], w.x[3]);
    } else if constexpr (B == 8) {
        *(uint2*)p = make_uint2(w.x[0], w.x[1]);
    } else if constexpr (B == 4) {
        *(uint32_t*)p = w.x[0];
    } else {
        *(uint16_t*)p = (uint16_t)w.x[0];
    }
}

// The element types: `get` reads element j of a 32-bit part as a float,
// `put` packs n floats (1 or 2) into one part, rounding to nearest even.
struct F32 {
    static constexpr int SIZE = 4;
    __device__ static float get(uint32_t x, int) { return __uint_as_float(x); }
    __device__ static uint32_t put(const float* v, int) { return __float_as_uint(v[0]); }
};
struct BF16 {
    static constexpr int SIZE = 2;
    __device__ static float get(uint32_t x, int j) {
        return __uint_as_float(j == 0 ? x << 16 : x & 0xffff0000u);
    }
    __device__ static uint32_t put(const float* v, int n) {
        uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
        return n == 1 ? lo : lo | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
    }
};
struct F16 {
    static constexpr int SIZE = 2;
    __device__ static float get(uint32_t x, int j) {
        return __half2float(__ushort_as_half((unsigned short)(j == 0 ? x & 0xffffu : x >> 16)));
    }
    __device__ static uint32_t put(const float* v, int n) {
        uint32_t lo = __half_as_ushort(__float2half_rn(v[0]));
        return n == 1 ? lo : lo | ((uint32_t)__half_as_ushort(__float2half_rn(v[1])) << 16);
    }
};

struct SegParams {
    const long long* indptr;
    const int32_t* indices;
    const char* table;
    char* out;
    long long n_rows;
    long long row_bytes;
    int items;        // items of a row: ceil(row_bytes / (32 * B))
    int heavy_items;  // items of a long row: ceil(row_bytes / HEAVY_BYTES); 0: no such path
};

// One item: a slice of one output row's columns, the mean over the row's
// `deg` edges (ids `ids`) of that slice of each source row; B-byte words a
// lane, U edges of loads in flight. `col` is this lane's word of the slice
// in table row 0, `dst` its word of the output row, `on` whether the lane
// has one. Every lane of the warp calls it (it shuffles).
template <class E, int B, int U>
__device__ __forceinline__ void item_mean(const int32_t* ids, int deg, const char* col,
                                          long long row_bytes, char* dst, bool on,
                                          int lane) {
    constexpr int EPP = (B >= 4 ? 4 : B) / E::SIZE;  // elements of a 32-bit part
    constexpr int EPW = Word<B>::P * EPP;            // elements of a word
    constexpr int IDS = (U + 31) / 32;               // id registers a lane
    constexpr int CH = 32 * IDS;                     // edges whose ids a lane holds
    float acc[EPW];
#pragma unroll
    for (int i = 0; i < EPW; ++i) acc[i] = 0.0f;
    int id[IDS];
#pragma unroll
    for (int i = 0; i < IDS; ++i) id[i] = 32 * i + lane < deg ? ids[32 * i + lane] : 0;
    for (int c0 = 0; c0 < deg; c0 += CH) {
        const int n = deg - c0 < CH ? deg - c0 : CH;
        int next[IDS];  // the next ids, in flight while this chunk's rows load
#pragma unroll
        for (int i = 0; i < IDS; ++i) {
            const int e = c0 + CH + 32 * i + lane;
            next[i] = e < deg ? ids[e] : 0;
        }
#pragma unroll
        for (int j = 0; j < CH; j += U) {
            if (j < n) {
                Word<B> v[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int src = __shfl_sync(FULL, id[(j + u) / 32], (j + u) % 32);
                    if (on && j + u < n) v[u] = load_word<B>(col + (long long)src * row_bytes);
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (on && j + u < n) {
#pragma unroll
                        for (int i = 0; i < Word<B>::P; ++i)
#pragma unroll
                            for (int k = 0; k < EPP; ++k)
                                acc[i * EPP + k] += E::get(v[u].x[i], k);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < IDS; ++i) id[i] = next[i];
    }
    if (on) {
        const float d = (float)(deg > 0 ? deg : 1);
        Word<B> w;
#pragma unroll
        for (int i = 0; i < Word<B>::P; ++i) {
            float q[EPP];
#pragma unroll
            for (int k = 0; k < EPP; ++k) q[k] = __fdiv_rn(acc[i * EPP + k], d);
            w.x[i] = E::put(q, EPP);
        }
        store_word<B>(dst, w);
    }
}

// B-byte words for the rows of ordinary degree; 4-byte words for long rows
// when B is wider (heavy_items > 0). The block's rows are read once into
// shared memory, so no row's bounds stay in registers across the items.
template <class E, int B>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) segment_mean_kernel(const SegParams p) {
    __shared__ long long row_beg[WARPS];  // the block's rows' first edges
    __shared__ int row_deg[WARPS];        // their degrees
    __shared__ int row_first[WARPS + 1];  // their first items; last, the block's items
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long row0 = (long long)blockIdx.x * WARPS;
    if (warp == 0) {
        long long beg = 0;
        int deg = 0, items = 0;
        if (lane < WARPS && row0 + lane < p.n_rows) {
            beg = p.indptr[row0 + lane];
            deg = (int)(p.indptr[row0 + lane + 1] - beg);
            items = p.heavy_items > 0 && deg >= HEAVY_DEG ? p.heavy_items : p.items;
        }
        int first = items;  // inclusive prefix of the items over the lanes
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            int v = __shfl_up_sync(FULL, first, d);
            if (lane >= d) first += v;
        }
        if (lane < WARPS) {
            row_beg[lane] = beg;
            row_deg[lane] = deg;
            row_first[lane] = first - items;
        }
        if (lane == WARPS - 1) row_first[WARPS] = first;
    }
    __syncthreads();
    constexpr int ring = E::SIZE == 4 ? RING : RING_16BIT;
    const int total = row_first[WARPS];
    for (int item = warp; item < total; item += WARPS) {
        // the row holding `item`: the last whose items start at or before it
        // (a row past the last has no items and starts at `total`)
        const int r = 31 - __clz(__ballot_sync(FULL, lane < WARPS && row_first[lane] <= item));
        const int s = item - row_first[r], deg = row_deg[r];
        const int32_t* ids = p.indices + row_beg[r];
        char* out_row = p.out + (row0 + r) * p.row_bytes;
        if constexpr (B > 4) {
            if (p.heavy_items > 0 && deg >= HEAVY_DEG) {
                const int at = s * HEAVY_BYTES + lane * 4;
                item_mean<E, 4, ring>(ids, deg, p.table + at, p.row_bytes, out_row + at,
                                      at < p.row_bytes, lane);
                continue;
            }
        }
        const int at = s * 32 * B + lane * B;
        item_mean<E, B, ring / Word<B>::P>(ids, deg, p.table + at, p.row_bytes, out_row + at,
                                           at < p.row_bytes, lane);
    }
}

struct SegmentArgs {
    const long long* indptr;  // (n_rows + 1,) int64 edge offsets, on the device
    const int32_t* indices;   // (E,) int32 source rows: device, or pinned host (UVA)
    const void* table;        // (n_src, F) source rows
    void* out;                // (n_rows, F), the table's element type
    long long n_rows;
    long long row_bytes;      // F times the element size
    long long dtype;          // 0 float32, 1 bfloat16, 2 float16
    void* stream;
};
static_assert(sizeof(SegmentArgs) == 8 * 8, "SegmentArgs is 8 packed fields");

template <class E, int B>
static void launch(const SegmentArgs* a) {
    SegParams p;
    p.indptr = a->indptr;
    p.indices = a->indices;
    p.table = (const char*)a->table;
    p.out = (char*)a->out;
    p.n_rows = a->n_rows;
    p.row_bytes = a->row_bytes;
    p.items = (int)((a->row_bytes + 32 * B - 1) / (32 * B));
    p.heavy_items = B > 4 ? (int)((a->row_bytes + HEAVY_BYTES - 1) / HEAVY_BYTES) : 0;
    unsigned blocks = (unsigned)((a->n_rows + WARPS - 1) / WARPS);
    segment_mean_kernel<E, B><<<blocks, THREADS, 0, (cudaStream_t)a->stream>>>(p);
}

template <class E>
static void launch_words(const SegmentArgs* a) {
    uintptr_t w = (uintptr_t)a->table | (uintptr_t)a->out | (uintptr_t)a->row_bytes;
    if (w % 16 == 0) {
        launch<E, 16>(a);
    } else if (w % 8 == 0) {
        launch<E, 8>(a);
    } else if constexpr (E::SIZE == 4) {
        launch<E, 4>(a);  // a float32 table and row are 4 B-aligned
    } else if (w % 4 == 0) {
        launch<E, 4>(a);
    } else {
        launch<E, 2>(a);
    }
}

// The entry takes its arguments as one struct of 8-byte fields (ctypes
// passes it as one pointer); returns the launch's CUDA error code (0 on
// success).
extern "C" int quiver_segment_mean(const SegmentArgs* a) {
    if (a->n_rows == 0 || a->row_bytes == 0) return 0;
    if (a->row_bytes >= (1LL << 30)) return (int)cudaErrorInvalidValue;  // int column offsets
    if (a->dtype == 0) {
        launch_words<F32>(a);
    } else if (a->dtype == 1) {
        launch_words<BF16>(a);
    } else if (a->dtype == 2) {
        launch_words<F16>(a);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The audit's kernel check (common.cuh): every instantiation of this file.
extern "C" int quiver_kernel_attrs(KernelAttrs* out, int cap) {
    static const KernelRow rows[] = {
        {(const void*)segment_mean_kernel<F32, 16>, "segment_mean_kernel<f32, 16>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F32, 8>, "segment_mean_kernel<f32, 8>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F32, 4>, "segment_mean_kernel<f32, 4>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<BF16, 16>, "segment_mean_kernel<bf16, 16>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<BF16, 8>, "segment_mean_kernel<bf16, 8>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<BF16, 4>, "segment_mean_kernel<bf16, 4>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<BF16, 2>, "segment_mean_kernel<bf16, 2>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F16, 16>, "segment_mean_kernel<f16, 16>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F16, 8>, "segment_mean_kernel<f16, 8>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F16, 4>, "segment_mean_kernel<f16, 4>", "segment_mean", THREADS},
        {(const void*)segment_mean_kernel<F16, 2>, "segment_mean_kernel<f16, 2>", "segment_mean", THREADS},
    };
    return fill_kernel_attrs(out, cap, rows, (int)(sizeof(rows) / sizeof(rows[0])));
}
