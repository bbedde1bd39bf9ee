"""Build, load and launch the hand-written CUDA kernels.

Each ``<name>.cu`` beside this file is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded through ``ctypes``. The
build runs at first use, never at import, from the sources in the package
only, into ``.cuda_build/`` beside them; the first use builds every library
at once, one ``nvcc`` per source in parallel. The library's file name
carries a digest of its sources and flags, so an edited source rebuilds
and a stale library is never loaded. Compilation goes to a temporary file
that is then renamed into place, so a concurrent loader never opens a torn
library. Building and the first load hold one process-wide lock, so two
threads (a ``Prefetcher``'s worker and the main thread) never run
``nvcc`` twice into the same temporary file.

Every wrapper launches through the same lean host path: :func:`address`
gives a table's address (a pinned host table's UVA address is looked up
once per table and kept on the tensor), and :func:`launch` calls the
entry (looked up once) with the current raw stream, enters no device
context when the launch device is already current, and raises on a launch
error. Every entry takes its arguments as one packed struct of 8-byte
fields, the stream last, which ctypes passes as one pointer (every ctypes
argument costs host time to convert). A build or launch failure raises:
there is no fallback to the plain PyTorch version on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading

import torch

__all__ = ["KERNELS", "address", "build_all", "launch"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, ".cuda_build")
KERNELS = ("select", "gather", "wselect")
_HEADERS = ("common.cuh",)
_LOCK = threading.RLock()  # builds and the first load of the libraries
_LIBS: dict[str, ctypes.CDLL] | None = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and $PATH); the CUDA kernels cannot be built"
        )
    return found


def _arch() -> str:
    """The gencode target of device 0: ``sm_90a`` on Hopper."""
    major, minor = torch.cuda.get_device_capability(0)
    suffix = "a" if major == 9 else ""
    return f"{major}{minor}{suffix}"


def _flags(arch: str) -> list[str]:
    return [
        f"-gencode=arch=compute_{arch},code=sm_{arch}", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC",
    ]


def _target(name: str, arch: str) -> tuple[str, list[str]]:
    src = os.path.join(_DIR, f"{name}.cu")
    h = hashlib.sha256()
    for path in (src,) + tuple(os.path.join(_DIR, x) for x in _HEADERS):
        with open(path, "rb") as fh:
            h.update(fh.read())
    flags = _flags(arch)
    h.update(" ".join(flags).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    return lib, [_nvcc(), *flags, "-o", "{out}", src]


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together, under the build lock. Returns ``{name: library
    path}``; raises with the compiler's output if any build fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict[str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    arch = _arch()
    libs, procs = {}, []
    for name in names:
        lib, cmd = _target(name, arch)
        libs[name] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [tmp if c == "{out}" else c for c in cmd]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            if os.path.exists(tmp):
                os.unlink(tmp)
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return libs


_P, _I = ctypes.c_void_p, ctypes.c_int
# entry -> (library, C function, the number of 8-byte fields of its packed
# argument struct, the stream last among them). Every C function returns
# the launch's CUDA error code.
_ENTRIES = {
    "select": ("select", "quiver_select", 10),
    "uniform_hop": ("select", "quiver_uniform_hop", 18),
    "gather": ("gather", "quiver_gather", 12),
    "gather_dequant": ("gather", "quiver_gather_dequant", 12),
    "wselect": ("wselect", "quiver_wselect", 14),
    "weighted_hop": ("wselect", "quiver_weighted_hop", 19),
}


def _libraries() -> dict[str, ctypes.CDLL]:
    """Every kernel library, built and loaded once per process; the first
    call holds the build lock, so concurrent first uses load once."""
    global _LIBS
    if _LIBS is None:
        with _LOCK:
            if _LIBS is None:
                libs = {name: ctypes.CDLL(path) for name, path in build_all().items()}
                for lib in libs.values():
                    lib.quiver_device_pointer.argtypes = [_P, ctypes.POINTER(_P)]
                    lib.quiver_device_pointer.restype = _I
                _LIBS = libs
    return _LIBS


@functools.cache
def _kernel(entry: str):
    """``(ctypes function, struct packer)`` of kernel entry ``entry``;
    every library is built on first use."""
    lib, fn_name, fields = _ENTRIES[entry]
    fn = getattr(_libraries()[lib], fn_name)
    fn.restype = _I
    fn.argtypes = [ctypes.c_char_p]
    return fn, struct.Struct(f"<{fields}q").pack


def address(t, index: int) -> int:
    """Address a kernel on CUDA device ``index`` reads ``t`` at: its own
    for a tensor on that device, the UVA device address for a pinned host
    tensor (looked up once per tensor and storage). Raises for another
    device and for pageable host memory, which a kernel cannot read."""
    where = t.get_device()
    if where == index:
        return t.data_ptr()
    if where >= 0:
        raise ValueError(f"tensor on cuda:{where}, kernel on cuda:{index}")
    ptr = t.data_ptr()
    known = t.__dict__.get("_uva_address")
    if known is not None and known[0] == ptr:
        return known[1]
    if not t.is_pinned():
        raise ValueError(
            "a CUDA kernel can read a host tensor only from pinned memory "
            "(see core.memory.to_pinned_host)"
        )
    dev = _P()
    err = _libraries()[KERNELS[0]].quiver_device_pointer(ptr, ctypes.byref(dev))
    if err:
        raise RuntimeError(f"cudaHostGetDevicePointer failed with CUDA error {err}")
    t._uva_address = (ptr, dev.value)
    return dev.value


def launch(entry: str, index: int, *args) -> None:
    """Launch kernel entry ``entry`` on CUDA device ``index`` with
    ``args`` (ints; 0 for an absent pointer) and the device's current raw
    stream, entering that device's context only when it is not already
    current; raises if the launch fails."""
    fn, pack = _kernel(entry)
    packed = pack(*args, torch._C._cuda_getCurrentRawStream(index))
    if torch._C._cuda_getDevice() == index:
        err = fn(packed)
    else:
        with torch.cuda.device(index):
            err = fn(packed)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {err}")
