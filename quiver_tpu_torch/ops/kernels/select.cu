// K1: per-row neighbour select,
//   out[t][r, c] = c < count[r] ? tables[t][start[r] + offs[r, c]] : -1
// over one or two aligned int32 tables (the CSR `indices`, plus an optional
// `eid` lane riding the same offsets).
//
// Replaces the TPU kernel `_select_kernel` (quiver_tpu/ops/pallas/fused.py:75),
// which DMAs a 2048-slot window of each row into VMEM and picks the drawn
// slots with a one-hot masked sum. An H100 serves random 32-byte sector
// loads well, so here every output lane is one thread that loads its slot
// directly: no window, so rows of any degree are sampled exactly (no hub-row
// attenuation) and `start` is int64 (indptr may exceed 2^31).
//
// Bound: bytes. Each lane moves 4 B of offsets, one 4 B table load (a
// separate 32 B sector in practice, since slots are random) and one 4 B
// store per table; there is no arithmetic to speak of. Consecutive threads
// write consecutive outputs, so stores coalesce. Tables may live in device
// memory or in pinned host memory (a UVA device pointer).
#include "common.cuh"

template <bool TWO>
__global__ void select_kernel(const int32_t* __restrict__ tab0,
                              const int32_t* __restrict__ tab1,
                              const int64_t* __restrict__ start,
                              const int32_t* __restrict__ offs,
                              const int32_t* __restrict__ count,
                              int32_t* __restrict__ out0,
                              int32_t* __restrict__ out1,
                              long long n, int k) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long r = i / k;
    int c = (int)(i - r * k);
    if (count != nullptr && c >= count[r]) {
        out0[i] = -1;
        if (TWO) out1[i] = -1;
        return;
    }
    long long p = start[r] + (long long)offs[i];
    out0[i] = tab0[p];
    if (TWO) out1[i] = tab1[p];
}

// rows * k output lanes; `tab1`/`out1` null for the one-table form, `count`
// null to take every lane. Launches on `stream`; returns the launch's CUDA
// error code (0 on success).
extern "C" int quiver_select(const int32_t* tab0, const int32_t* tab1,
                             const int64_t* start, const int32_t* offs,
                             const int32_t* count, int32_t* out0,
                             int32_t* out1, long long rows, int k,
                             void* stream) {
    long long n = rows * (long long)k;
    if (n == 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (tab1 != nullptr) {
        select_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            tab0, tab1, start, offs, count, out0, out1, n, k);
    } else {
        select_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            tab0, nullptr, start, offs, count, out0, nullptr, n, k);
    }
    return (int)cudaGetLastError();
}
