// K1: neighbour select, two entries.
//
// `quiver_select`, the select of the Pallas contract:
//   out[t][r, c] = c < count[r] ? tables[t][start[r] + offs[r, c]] : -1
// over one or two aligned int32 tables (the CSR `indices`, plus an optional
// `eid` lane riding the same offsets). The draw seams (offsets computed
// elsewhere, e.g. JAX's) and the temporal hop, whose row start and degree
// come from the window search, run on it.
//
// `quiver_uniform_hop`, the whole uniform hop of ops/sample.py in one
// launch: for output lane (r, c) of row r = (lead b, seed lane s), from the
// raw 62-bit draws `jitter[r, c]` and `rot[r]`,
//   valid = s < num[b] && seeds[r] >= 0;  base = indptr[seed];
//   deg   = valid ? indptr[seed + 1] - base : 0;  count = min(deg, k);
//   off   = deg <= k ? c
//         : rotate(lo_c + jitter % span_c, rot % deg) over k integer strata;
//   nbr   = c < count ? indices[base + off] : -1,
// plus the count per row and, on request, the eid lane (the `eid` table's
// value, or the CSR slot base + off in indptr's width). It is bitwise the
// composition seed_degrees -> stratified_offsets -> rotate_offsets ->
// select of ops/sample.py: the same integer arithmetic (% taking the
// divisor's sign, as torch's does), with the stratum bounds in 32 bits,
// where every one of their values fits (k <= 46340).
//
// Both replace the TPU kernel `_select_kernel` (quiver_tpu/ops/pallas/fused.py:75),
// which DMAs a 2048-slot window of each row into VMEM and picks the drawn
// slots with a one-hot masked sum; XLA computed the degrees and offsets
// around it. An H100 serves random 32-byte sector loads well, so here every
// output lane is one thread that loads its slot directly: no window, so rows
// of any degree are sampled exactly (no hub-row attenuation) and `start` is
// int64 (indptr may exceed 2^31).
//
// Bound: bytes. Each lane moves its draw (4 B offset, or 8 B jitter), one
// table load (a separate 32 B sector in practice, since slots are random)
// and one 4 B store per output; the hop adds two indptr loads per row (one
// sector, shared by the row's k lanes through L1). Consecutive threads write
// consecutive outputs, so stores coalesce. At the serving shapes the card's
// work is nanoseconds and the host's launch path is the cost: the hop's one
// launch replaces the ~45 small torch launches of the composed path, and the
// wrappers launch through build.py's lean path. Tables may live in device
// memory or in pinned host memory (a UVA device pointer).
#include "common.cuh"

constexpr int THREADS = 256;  // every launch of this file

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

// The entries take their arguments as one struct of 8-byte fields (ctypes
// passes it as one pointer), the stream last; each returns the launch's CUDA
// error code (0 on success).
struct SelectArgs {
    const int32_t* tab0;
    const int32_t* tab1;    // read when out1 is set
    const int64_t* start;
    const int32_t* offs;
    const int32_t* count;   // null: take every lane
    int32_t* out0;
    int32_t* out1;          // null: the one-table form
    long long rows;         // rows * k output lanes
    long long k;
    void* stream;
};
static_assert(sizeof(SelectArgs) == 10 * 8, "SelectArgs is 10 packed fields");

extern "C" int quiver_select(const SelectArgs* a) {
    long long n = a->rows * a->k;
    if (n == 0) return 0;
    const int threads = THREADS;
    long long blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)a->stream;
    if (a->out1 != nullptr) {
        select_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            a->tab0, a->tab1, a->start, a->offs, a->count, a->out0, a->out1, n,
            (int)a->k);
    } else {
        select_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            a->tab0, nullptr, a->start, a->offs, a->count, a->out0, nullptr, n,
            (int)a->k);
    }
    return (int)cudaGetLastError();
}

// a % b with the sign of b (b > 0), as torch's integer `%`
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
    long long m = a % b;
    return m < 0 ? m + b : m;
}

// EIDS: 0 no eid lane, 1 the eid table's value, 2 the CSR slot (indptr's width)
template <typename IP, int EIDS>
__global__ void uniform_hop_kernel(const IP* __restrict__ indptr,
                                   const int32_t* __restrict__ seeds,
                                   const int32_t* __restrict__ num,
                                   long long num_scalar, int num_stride,
                                   const int64_t* __restrict__ jitter,
                                   const int64_t* __restrict__ rot,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ eid,
                                   int32_t* __restrict__ nbr,
                                   int32_t* __restrict__ counts,
                                   void* __restrict__ eids,
                                   long long n, int S, int k) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long r = i / k;
    int c = (int)(i - r * k);
    long long b = r / S;
    int s = (int)(r - b * S);
    int seed = seeds[r];
    long long nv = num != nullptr ? (long long)num[b * num_stride] : num_scalar;
    bool valid = s < nv && seed >= 0;
    long long base = (long long)indptr[valid ? seed : 0];
    int deg = valid ? (int)(indptr[seed + 1] - (IP)base) : 0;
    int cnt = deg < k ? deg : k;
    if (c == 0) counts[r] = cnt;
    if (c >= cnt) {
        nbr[i] = -1;
        if (EIDS == 1) ((int32_t*)eids)[i] = -1;
        if (EIDS == 2) ((IP*)eids)[i] = (IP)-1;
        return;
    }
    long long off = c;  // take-all rows (deg <= k) keep CSR order
    if (deg > k) {
        // the stratum bounds fit 32 bits (every term <= deg, and c * rem <
        // k^2 < 2^31 for k <= 46340); the 62-bit draws reduce in 64
        int q = deg / k, rem = deg % k;
        int lo = c * q + (c * rem) / k;
        int hi = (c + 1) * q + ((c + 1) * rem) / k;
        long long span = hi - lo > 1 ? hi - lo : 1;
        off = (int32_t)(lo + floor_mod(jitter[i], span));
        long long shifted = off + floor_mod(rot[r], deg);
        off = (int32_t)(shifted >= deg ? shifted - deg : shifted);
    }
    long long p = base + off;
    nbr[i] = indices[p];
    if (EIDS == 1) ((int32_t*)eids)[i] = eid[p];
    if (EIDS == 2) ((IP*)eids)[i] = (IP)p;
}

struct UniformHopArgs {
    const void* indptr;
    long long indptr64;       // indptr is int64, else int32
    const int32_t* seeds;
    const int32_t* num;       // one int32 count per lead index (num_stride
    long long num_scalar;     // 1) or one for all (0); null: num_scalar
    long long num_stride;
    const int64_t* jitter;
    const int64_t* rot;
    const int32_t* indices;
    const int32_t* eid;
    int32_t* nbr;
    int32_t* counts;
    void* eids;
    long long eid_lane;       // 0: none; 1: eid's values into int32 `eids`;
                              // 2: the CSR slots, in indptr's width
    long long rows;           // lead * S seed rows of k lanes each
    long long S;
    long long k;
    void* stream;
};
static_assert(sizeof(UniformHopArgs) == 18 * 8, "UniformHopArgs is 18 packed fields");

template <typename IP>
static void launch_hop(const UniformHopArgs* a, long long n) {
    const int threads = THREADS;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)a->stream;
    const IP* ip = (const IP*)a->indptr;
    int S = (int)a->S, k = (int)a->k, stride = (int)a->num_stride;
    if (a->eid_lane == 0) {
        uniform_hop_kernel<IP, 0><<<blocks, threads, 0, s>>>(
            ip, a->seeds, a->num, a->num_scalar, stride, a->jitter, a->rot,
            a->indices, nullptr, a->nbr, a->counts, nullptr, n, S, k);
    } else if (a->eid_lane == 1) {
        uniform_hop_kernel<IP, 1><<<blocks, threads, 0, s>>>(
            ip, a->seeds, a->num, a->num_scalar, stride, a->jitter, a->rot,
            a->indices, a->eid, a->nbr, a->counts, a->eids, n, S, k);
    } else {
        uniform_hop_kernel<IP, 2><<<blocks, threads, 0, s>>>(
            ip, a->seeds, a->num, a->num_scalar, stride, a->jitter, a->rot,
            a->indices, nullptr, a->nbr, a->counts, a->eids, n, S, k);
    }
}

extern "C" int quiver_uniform_hop(const UniformHopArgs* a) {
    long long n = a->rows * a->k;
    if (n == 0) return 0;
    if (a->indptr64) {
        launch_hop<int64_t>(a, n);
    } else {
        launch_hop<int32_t>(a, n);
    }
    return (int)cudaGetLastError();
}

// The audit's kernel check (common.cuh): every instantiation of this file.
extern "C" int quiver_kernel_attrs(KernelAttrs* out, int cap) {
    static const KernelRow rows[] = {
        {(const void*)select_kernel<true>, "select_kernel<true>", "select", THREADS},
        {(const void*)select_kernel<false>, "select_kernel<false>", "select", THREADS},
        {(const void*)uniform_hop_kernel<int32_t, 0>, "uniform_hop_kernel<int32_t, 0>",
         "uniform_hop", THREADS},
        {(const void*)uniform_hop_kernel<int32_t, 1>, "uniform_hop_kernel<int32_t, 1>",
         "uniform_hop", THREADS},
        {(const void*)uniform_hop_kernel<int32_t, 2>, "uniform_hop_kernel<int32_t, 2>",
         "uniform_hop", THREADS},
        {(const void*)uniform_hop_kernel<int64_t, 0>, "uniform_hop_kernel<int64_t, 0>",
         "uniform_hop", THREADS},
        {(const void*)uniform_hop_kernel<int64_t, 1>, "uniform_hop_kernel<int64_t, 1>",
         "uniform_hop", THREADS},
        {(const void*)uniform_hop_kernel<int64_t, 2>, "uniform_hop_kernel<int64_t, 2>",
         "uniform_hop", THREADS},
    };
    return fill_kernel_attrs(out, cap, rows, (int)(sizeof(rows) / sizeof(rows[0])));
}
