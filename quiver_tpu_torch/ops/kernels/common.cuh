// Shared host-side helpers for the hand-written Hopper kernels of
// quiver_tpu_torch. Each kernel source is built into its own shared
// library with a plain C interface (loaded through ctypes), so every
// library carries its own copy of these helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

// Device-side address of a pinned host buffer, so that a kernel can read it
// over PCIe without a staging copy (zero-copy UVA, the reference's design
// for the cold feature tier and the UVA topology). Returns the CUDA error
// code; 0 on success.
extern "C" int quiver_device_pointer(void* host, void** dev) {
    return (int)cudaHostGetDevicePointer(dev, host, 0);
}

// One __global__ instantiation's resources as cudaFuncGetAttributes reports
// them, and the block size the host code launches it with: what the program
// audit checks against an SM's limits (tools/audit/mem.py vmem_usages), the
// counterpart of the JAX package's VMEM accounting. The names, then 8-byte
// fields, as ops/kernels/build.py reads them.
struct KernelAttrs {
    char kernel[64];           // the instantiation, e.g. "gather_kernel<uint4>"
    char entry[32];            // the C entry that launches it (build.py _ENTRIES)
    long long block;           // threads per block of its launches
    long long regs;            // registers per thread
    long long shared_static;   // static shared memory per block
    long long shared_dynamic;  // dynamic shared memory its launches ask for
    long long local;           // local (spill) memory per thread
    long long max_threads;     // the most threads per block it can launch with
};

// One row of a file's kernel table: the kernel, its name, its entry, its
// block, and the dynamic shared bytes the largest of its launches asks for
// (0, left out, for a kernel that uses none).
struct KernelRow {
    const void* fn;
    const char* kernel;
    const char* entry;
    int block;
    int shared_dynamic;
};

// Fill out[0..n) from the file's kernel table `rows`; returns n, or minus the
// first CUDA error, or -1 when `cap` rows do not hold them.
static int fill_kernel_attrs(KernelAttrs* out, int cap, const KernelRow* rows, int n) {
    if (cap < n) return -1;
    for (int i = 0; i < n; ++i) {
        cudaFuncAttributes a;
        cudaError_t err = cudaFuncGetAttributes(&a, rows[i].fn);
        if (err != cudaSuccess) return -(int)err;
        snprintf(out[i].kernel, sizeof(out[i].kernel), "%s", rows[i].kernel);
        snprintf(out[i].entry, sizeof(out[i].entry), "%s", rows[i].entry);
        out[i].block = rows[i].block;
        out[i].regs = a.numRegs;
        out[i].shared_static = (long long)a.sharedSizeBytes;
        out[i].shared_dynamic = rows[i].shared_dynamic;
        out[i].local = (long long)a.localSizeBytes;
        out[i].max_threads = a.maxThreadsPerBlock;
    }
    return n;
}
