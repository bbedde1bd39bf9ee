"""Build and load the hand-written CUDA kernels.

Each ``<name>.cu`` beside this file is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded through ``ctypes``. The
build runs at first use, never at import, from the sources in the package
only, into ``.cuda_build/`` beside them. The library's file name carries a
digest of its sources and flags, so an edited source rebuilds and a stale
library is never loaded. Compilation goes to a temporary file that is then
renamed into place, so a concurrent loader never opens a torn library.

A build or load failure raises: there is no fallback to the plain PyTorch
version on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["KERNELS", "build_all", "check", "device_pointer", "load", "stream_ptr"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, ".cuda_build")
KERNELS = ("select", "gather", "wselect")
_HEADERS = ("common.cuh",)


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
    import torch

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
    started together. Returns ``{name: library path}``; raises with the
    compiler's output if any build fails."""
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


_P = ctypes.c_void_p
_SIGNATURES = {
    "select": ("quiver_select", [_P, _P, _P, _P, _P, _P, _P,
                                 ctypes.c_longlong, ctypes.c_int, _P]),
    "gather": ("quiver_gather_rows", [_P, _P, _P, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int, _P]),
    "wselect": ("quiver_wselect", [_P] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, _P]),
}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = ctypes.CDLL(build_all((name,))[name])
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.quiver_device_pointer.argtypes = [_P, ctypes.POINTER(_P)]
    lib.quiver_device_pointer.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def device_pointer(lib, t) -> int:
    """Address a kernel reads ``t`` at: its own for a CUDA tensor, the UVA
    device address for a pinned host tensor. Raises for pageable host
    memory, which a kernel cannot read."""
    if t.is_cuda:
        return t.data_ptr()
    if not t.is_pinned():
        raise ValueError(
            "a CUDA kernel can read a host tensor only from pinned memory "
            "(see core.memory.to_pinned_host)"
        )
    dev = _P()
    check(lib.quiver_device_pointer(t.data_ptr(), ctypes.byref(dev)),
          "cudaHostGetDevicePointer")
    return dev.value


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
