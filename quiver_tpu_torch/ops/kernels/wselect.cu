// K3: weighted neighbour select, two entries over one device routine.
//
// `quiver_wselect`, the select of the Pallas contract. For output lane
// (r, c), with d = deg[r] and s = start[r]:
//   c >= min(d, k): every output is -1 and nothing is read;
//   d <= k:         row_off = c (take every neighbour, CSR order);
//   otherwise:      uu = scale_u ? u[r, c] * cum_weights[s + d - 1] : u[r, c]
//                   row_off = smallest m in [0, d) with cum_weights[s + m] >= uu
//                   (an `iters`-round bisection over the row);
//   nbr = indices[s + row_off], and eid[s + row_off] on the optional eid lane.
// The draw seams that hand in a callable of the degrees (JAX's draws) and
// the owner-side draw of a sharded sampler (`scale_u` off) run on it.
//
// `quiver_weighted_hop`, the whole weighted hop of ops/sample.py in one
// launch: for row r = (lead b, seed lane s),
//   valid = s < num[b] && seeds[r] >= 0;  base = indptr[valid ? seed : 0];
//   deg   = valid ? indptr[seed + 1] - base : 0;  count = min(deg, k);
// then the select above with start = base and u scaled by the row total,
// the count per row and, on request, the eid lane (the `eid` table's value,
// or the CSR slot base + row_off in indptr's width). It is bitwise the
// composition seed_degrees -> weighted_offsets -> select of ops/sample.py.
//
// Both replace the TPU kernel `_wselect_kernel` (quiver_tpu/ops/pallas/fused.py:113),
// which DMAs a 2048-slot window of each row's `indices`/`cum_weights` into
// VMEM and walks the prefix segment there with one-hot masked sums, and so
// refuses rows longer than the window. Here every output lane is one thread
// that bisects its row directly in device memory (or pinned host memory over
// UVA): no window, any degree. The bisection runs on row-local offsets,
// whose floor-mid is the global search's mid less the row start, with the
// plain version's f32 compares and all `iters` rounds. `u * tot` is one
// round-to-nearest f32 multiply (__fmul_rn: never contracted into an FMA).
// Rows whose total weight is <= 0 already carry the uniform prefix 1..deg
// (CSRTopo._row_prefix_weights), so they need no case here.
//
// Bound: bytes. A searching lane makes `iters` + 2 dependent loads (14 on
// the products graph), but after the first probes of a row its k lanes hit
// the same sectors in L1, and one thread per output lane keeps enough
// chains in flight to cover their latency. Staging a row's prefix segment
// in shared memory (a group of lanes per row, one coalesced read, the
// bisection there) was measured on an H100 and lost at every group size
// and cap: it reads the whole segment where the search touches a few
// sectors, and leaves lanes idle (PERF.md). The selects and the eid lane
// are one load per lane; consecutive threads write consecutive outputs.
#include "common.cuh"

constexpr int THREADS = 256;

// Loads of tables the kernels only read, through the read-only data path.
__device__ __forceinline__ int32_t ldro(const int32_t* p) { return __ldg(p); }
__device__ __forceinline__ float ldro(const float* p) { return __ldg(p); }
__device__ __forceinline__ int64_t ldro(const int64_t* p) {
    return (int64_t)__ldg((const long long*)p);
}

// Output lane c of a row of d slots whose prefix weights start at w, with
// its draw at u: the lane's row-local offset, or -1 for c >= min(d, k).
// The bisection gives the smallest m with w[m] >= uu once the rounds
// suffice; lo + hi < 2^32.
__device__ __forceinline__ int lane_offset(const float* w, const float* u, int d, int k,
                                           int c, int iters, bool scale_u) {
    if (c >= d || c >= k) return -1;
    if (d <= k) return c;
    float uu = ldro(u);
    if (scale_u) uu = __fmul_rn(uu, ldro(w + d - 1));
    int lo = 0, hi = d - 1;
    for (int t = 0; t < iters; ++t) {
        int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
        if (ldro(w + mid) < uu) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// The entries take their arguments as one struct of 8-byte fields (ctypes
// passes it as one pointer), the stream last; each returns the launch's CUDA
// error code (0 on success).
struct WselectArgs {
    const int32_t* indices;
    const float* cum_weights;
    const int32_t* eid;     // read when out_eid is set
    const int64_t* start;
    const int32_t* deg;
    const float* u;
    int32_t* out_nbr;
    int32_t* out_off;
    int32_t* out_eid;       // null: no eid lane
    long long rows;         // rows * k output lanes
    long long k;
    long long iters;
    long long scale_u;
    void* stream;
};
static_assert(sizeof(WselectArgs) == 14 * 8, "WselectArgs is 14 packed fields");

template <bool EID>
__global__ void __launch_bounds__(THREADS) wselect_kernel(const WselectArgs a) {
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.rows * a.k) return;
    int k = (int)a.k;
    long long r = i / k;
    int c = (int)(i - r * k);
    long long s = ldro(a.start + r);
    int off = lane_offset(a.cum_weights + s, a.u + i, ldro(a.deg + r), k, c,
                          (int)a.iters, a.scale_u != 0);
    if (off < 0) {
        a.out_nbr[i] = -1;
        a.out_off[i] = -1;
        if (EID) a.out_eid[i] = -1;
        return;
    }
    long long p = s + off;
    a.out_nbr[i] = ldro(a.indices + p);
    a.out_off[i] = off;
    if (EID) a.out_eid[i] = ldro(a.eid + p);
}

struct WeightedHopArgs {
    const void* indptr;
    long long indptr64;       // indptr is int64, else int32
    const int32_t* seeds;
    const int32_t* num;       // one int32 count per lead index (num_stride
    long long num_scalar;     // 1) or one for all (0); null: num_scalar
    long long num_stride;
    const float* u;           // uniforms in [0, 1), scaled by the row total
    const float* cum_weights;
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
    long long iters;
    void* stream;
};
static_assert(sizeof(WeightedHopArgs) == 19 * 8, "WeightedHopArgs is 19 packed fields");

// EIDS: 0 no eid lane, 1 the eid table's value, 2 the CSR slot (indptr's width)
template <typename IP, int EIDS>
__global__ void __launch_bounds__(THREADS) weighted_hop_kernel(const WeightedHopArgs a) {
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.rows * a.k) return;
    int k = (int)a.k;
    long long r = i / k;
    int c = (int)(i - r * k);
    const IP* indptr = (const IP*)a.indptr;
    long long b = r / a.S;
    int seed = ldro(a.seeds + r);
    long long nv = a.num != nullptr ? (long long)ldro(a.num + b * a.num_stride)
                                    : a.num_scalar;
    bool valid = r - b * a.S < nv && seed >= 0;
    long long base = (long long)ldro(indptr + (valid ? seed : 0));
    int d = valid ? (int)(ldro(indptr + seed + 1) - (IP)base) : 0;
    if (c == 0) a.counts[r] = d < k ? d : k;
    int off = lane_offset(a.cum_weights + base, a.u + i, d, k, c, (int)a.iters, true);
    if (off < 0) {
        a.nbr[i] = -1;
        if (EIDS == 1) ((int32_t*)a.eids)[i] = -1;
        if (EIDS == 2) ((IP*)a.eids)[i] = (IP)-1;
        return;
    }
    long long p = base + off;
    a.nbr[i] = ldro(a.indices + p);
    if (EIDS == 1) ((int32_t*)a.eids)[i] = ldro(a.eid + p);
    if (EIDS == 2) ((IP*)a.eids)[i] = (IP)p;
}

// One thread per output lane.
template <typename Kernel, typename Args>
static int launch_lanes(Kernel kernel, const Args* a) {
    long long n = a->rows * a->k;
    if (n == 0) return 0;
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    kernel<<<blocks, THREADS, 0, (cudaStream_t)a->stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int quiver_wselect(const WselectArgs* a) {
    if (a->out_eid != nullptr) return launch_lanes(wselect_kernel<true>, a);
    return launch_lanes(wselect_kernel<false>, a);
}

template <typename IP>
static int launch_hop(const WeightedHopArgs* a) {
    if (a->eid_lane == 1) return launch_lanes(weighted_hop_kernel<IP, 1>, a);
    if (a->eid_lane == 2) return launch_lanes(weighted_hop_kernel<IP, 2>, a);
    return launch_lanes(weighted_hop_kernel<IP, 0>, a);
}

extern "C" int quiver_weighted_hop(const WeightedHopArgs* a) {
    return a->indptr64 ? launch_hop<int64_t>(a) : launch_hop<int32_t>(a);
}
