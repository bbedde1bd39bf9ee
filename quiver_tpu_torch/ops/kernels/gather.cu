// K2: row gather, out[j, :] = table[ids[j], :] for rows of any width and
// element size (f32, bf16, int8 codes). A negative id gives a zero row, or
// leaves out[j, :] as it was when `keep_missing` is set, which is how a
// second tier's gather fills only its own lanes of a shared output.
//
// Replaces the TPU kernel `_gather_kernel` (quiver_tpu/ops/pallas/gather.py:28),
// which issues one DMA per row with 16 rows in flight. Here one warp copies
// one row, in the manner of the reference's warp-per-row
// `quiver_tensor_gather`: the lanes of the warp move consecutive words of
// the row, so every load and store is coalesced.
//
// Bound: bytes (one read and one write of every gathered row). The word is
// the widest of 16, 8, 4, 2 or 1 bytes that divides the row width and the
// alignment of both base pointers, so a 400 B f32 row moves as 16 B vectors,
// a 200 B bf16 row as 8 B words and a 100 B int8 row as 4 B words, with no
// misaligned access and no tail. The table may live in device memory or in
// pinned host memory (a UVA device pointer, the cold tier).
#include "common.cuh"

template <typename W>
__global__ void gather_kernel(const W* __restrict__ table,
                              const int32_t* __restrict__ ids,
                              W* __restrict__ out, long long n_ids,
                              long long row_words, int keep_missing) {
    long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (row >= n_ids) return;
    int id = ids[row];
    W* dst = out + row * row_words;
    if (id < 0) {
        if (!keep_missing) {
            for (long long j = lane; j < row_words; j += 32) dst[j] = W{};
        }
        return;
    }
    const W* src = table + (long long)id * row_words;
    for (long long j = lane; j < row_words; j += 32) dst[j] = src[j];
}

template <typename W>
static void launch(const void* table, const int32_t* ids, void* out,
                   long long n_ids, long long row_bytes, int keep_missing,
                   cudaStream_t s) {
    const int threads = 256;  // 8 warps, one row each
    long long blocks = (n_ids * 32 + threads - 1) / threads;
    gather_kernel<W><<<(unsigned)blocks, threads, 0, s>>>(
        (const W*)table, ids, (W*)out, n_ids,
        row_bytes / (long long)sizeof(W), keep_missing);
}

// Launches on `stream`; returns the launch's CUDA error code (0 on success).
extern "C" int quiver_gather_rows(const void* table, const int32_t* ids,
                                  void* out, long long n_ids,
                                  long long row_bytes, int keep_missing,
                                  void* stream) {
    if (n_ids == 0 || row_bytes == 0) return 0;
    uintptr_t a = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
    cudaStream_t s = (cudaStream_t)stream;
    if (a % 16 == 0) {
        launch<uint4>(table, ids, out, n_ids, row_bytes, keep_missing, s);
    } else if (a % 8 == 0) {
        launch<uint2>(table, ids, out, n_ids, row_bytes, keep_missing, s);
    } else if (a % 4 == 0) {
        launch<uint32_t>(table, ids, out, n_ids, row_bytes, keep_missing, s);
    } else if (a % 2 == 0) {
        launch<uint16_t>(table, ids, out, n_ids, row_bytes, keep_missing, s);
    } else {
        launch<uint8_t>(table, ids, out, n_ids, row_bytes, keep_missing, s);
    }
    return (int)cudaGetLastError();
}
