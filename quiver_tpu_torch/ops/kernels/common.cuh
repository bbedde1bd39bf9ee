// Shared host-side helpers for the hand-written Hopper kernels of
// quiver_tpu_torch. Each kernel source is built into its own shared
// library with a plain C interface (loaded through ctypes), so every
// library carries its own copy of these helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Device-side address of a pinned host buffer, so that a kernel can read it
// over PCIe without a staging copy (zero-copy UVA, the reference's design
// for the cold feature tier and the UVA topology). Returns the CUDA error
// code; 0 on success.
extern "C" int quiver_device_pointer(void* host, void** dev) {
    return (int)cudaHostGetDevicePointer(dev, host, 0);
}
