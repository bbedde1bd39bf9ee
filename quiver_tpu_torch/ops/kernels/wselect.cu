// K3: weighted per-row neighbour select (inverse-CDF search fused with the
// select). For output lane (r, c), with d = deg[r] and s = start[r]:
//   c >= min(d, k): every output is -1 and nothing is read;
//   d <= k:         row_off = c (take every neighbour, CSR order);
//   otherwise:      uu = scale_u ? u[r, c] * cum_weights[s + d - 1] : u[r, c]
//                   row_off = smallest m in [0, d) with cum_weights[s + m] >= uu
//                   (an `iters`-round bisection over the row);
//   nbr = indices[s + row_off], and eid[s + row_off] on the optional eid lane.
//
// Replaces the TPU kernel `_wselect_kernel` (quiver_tpu/ops/pallas/fused.py:113),
// which DMAs a 2048-slot window of each row's `indices`/`cum_weights` into
// VMEM and walks the prefix segment there with one-hot masked sums, and so
// refuses rows longer than the window. Its docstring shows the windowed walk
// is an affine shift of the global search of quiver_tpu/ops/sample.py
// `_cdf_search`; here every lane runs that global search directly against
// device memory (or pinned host memory over UVA): no window, any degree.
//
// Bit parity with the XLA oracle: `u * tot` is one round-to-nearest f32
// multiply (__fmul_rn: never contracted into an FMA), the compare is a plain
// f32 `<`, and `mid` is the int64 floor of (lo + hi) / 2 of non-negative
// values. Rows whose total weight is <= 0 already carry the uniform prefix
// 1..deg (CSRTopo._row_prefix_weights), so they need no case here.
//
// Bound: bytes, and latency. Each searching lane makes `iters` dependent
// loads (one 32 B sector each, at random rows) before its select load; the
// lanes of a row probe the same first slots, so those hit L1/L2. One thread
// per lane keeps enough independent chains in flight to cover the latency.
// A later design can give a row to a warp and stage its prefix segment in
// shared memory.
#include "common.cuh"

template <bool EID>
__global__ void wselect_kernel(const int32_t* __restrict__ indices,
                               const float* __restrict__ cum_weights,
                               const int32_t* __restrict__ eid,
                               const int64_t* __restrict__ start,
                               const int32_t* __restrict__ deg,
                               const float* __restrict__ u,
                               int32_t* __restrict__ out_nbr,
                               int32_t* __restrict__ out_off,
                               int32_t* __restrict__ out_eid,
                               long long n, int k, int iters, int scale_u) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long r = i / k;
    int c = (int)(i - r * k);
    int d = deg[r];
    if (c >= d || c >= k) {
        out_nbr[i] = -1;
        out_off[i] = -1;
        if (EID) out_eid[i] = -1;
        return;
    }
    long long s = start[r];
    long long off = c;
    if (d > k) {
        long long lo = s, hi = s + d - 1;
        float uu = u[i];
        if (scale_u) uu = __fmul_rn(uu, cum_weights[hi]);
        for (int t = 0; t < iters; ++t) {
            long long mid = (lo + hi) >> 1;  // floor: lo + hi >= 0
            if (cum_weights[mid] < uu) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        off = lo - s;
    }
    long long p = s + off;
    out_nbr[i] = indices[p];
    out_off[i] = (int32_t)off;
    if (EID) out_eid[i] = eid[p];
}

// rows * k output lanes; `eid`/`out_eid` null for the form without the eid
// lane. Launches on `stream`; returns the launch's CUDA error code (0 on
// success).
extern "C" int quiver_wselect(const int32_t* indices, const float* cum_weights,
                              const int32_t* eid, const int64_t* start,
                              const int32_t* deg, const float* u,
                              int32_t* out_nbr, int32_t* out_off,
                              int32_t* out_eid, long long rows, int k,
                              int iters, int scale_u, void* stream) {
    long long n = rows * (long long)k;
    if (n == 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (eid != nullptr) {
        wselect_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            indices, cum_weights, eid, start, deg, u, out_nbr, out_off,
            out_eid, n, k, iters, scale_u);
    } else {
        wselect_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            indices, cum_weights, nullptr, start, deg, u, out_nbr, out_off,
            nullptr, n, k, iters, scale_u);
    }
    return (int)cudaGetLastError();
}
