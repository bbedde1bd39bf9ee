"""The native host runtime: a ctypes loader for ``quiver_host.cpp``.

The port of ``quiver_tpu/native/``, with the same functions, signatures
and dtypes: :func:`csr_from_coo` (a linear-time parallel COO -> CSR
build, stable for any OpenMP thread count), :func:`gather_rows`,
:func:`sample_neighbors`, :func:`reindex` and :func:`num_threads`.

The library is built at first use, never at import: ``g++ -O3 -fopenmp
-shared -fPIC`` compiles the source beside this file into ``.host_build/``
(git-ignored), under a file name that carries a digest of the source and
the flags, so an edited source builds again and a stale library is never
loaded. The compiler writes a temporary file that is renamed into place,
and concurrent first uses (test workers, threads) take a file lock, so
none loads a torn library and one process compiles. ``-march=native`` is
left out: a library built on one CPU may be loaded on another.

``available`` is read lazily (its first read builds and loads). With no
toolchain, or when the build or load fails, it is False, the failure is
logged once with the compiler's output, and ``CSRTopo`` and ``RelCSR``
build their CSR with numpy, which gives the same arrays bitwise.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..utils.trace import get_logger

__all__ = ["available", "build", "csr_from_coo", "gather_rows", "num_threads",
           "reindex", "sample_neighbors"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "quiver_host.cpp")
BUILD_DIR = os.path.join(_DIR, ".host_build")
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
_LOCK = threading.Lock()
_lib = None
_tried = False


def _target() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libquiver_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library into ``BUILD_DIR`` unless it is there already;
    returns its path. Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = _target()
    if os.path.exists(lib):
        return lib
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler per directory
        if os.path.exists(lib):
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, _SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
        # durable before it is published: a torn library under its final
        # (digest) name would be loaded, and fail, on every later start
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, lib)
    return lib


def _bind(path: str):
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.csr_from_coo_i64.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                     i64p, i32p, i64p]
    lib.csr_from_coo_i32.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                     i64p, i32p, i64p]
    lib.gather_rows_bytes.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i64p,
                                      ctypes.c_int64, u8p]
    lib.sample_neighbors_cpu.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_uint64, i32p, i32p]
    lib.reindex_cpu.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int32, i32p, i32p]
    lib.reindex_cpu.restype = ctypes.c_int64
    lib.quiver_host_num_threads.restype = ctypes.c_int
    return lib


def _library():
    """The loaded library, built and loaded on the first call; None when
    that failed (logged once)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _LOCK:
        if not _tried:
            try:
                _lib = _bind(build())
            except (OSError, RuntimeError, AttributeError) as e:
                get_logger("native").warning(
                    "native host library unavailable (CSR builds use numpy): %s", e)
            _tried = True
    return _lib


def __getattr__(name):
    if name == "available":
        return _library() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _loaded():
    lib = _library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, n_nodes: int, with_eid: bool = True):
    """Linear-time parallel COO -> CSR: ``(indptr int64, indices int32,
    eid int64 or None)``, slots within a row in COO order."""
    lib = _loaded()
    if n_nodes > np.iinfo(np.int32).max:
        # indices are stored as int32; past that the numpy build is the tool
        raise ValueError(f"native CSR builder supports < 2^31 nodes, got {n_nodes}")
    e = rows.shape[0]
    if cols.shape != (e,):
        raise ValueError(f"rows {rows.shape} and cols {cols.shape} differ")
    # the build writes slots by row id: every id must be in range
    if e and (int(rows.min()) < 0 or int(rows.max()) >= n_nodes):
        raise ValueError(f"rows must lie in [0, {n_nodes})")
    if e and (int(cols.min()) < 0 or int(cols.max()) > np.iinfo(np.int32).max):
        raise ValueError("cols must lie in [0, 2^31)")
    indptr = np.empty(n_nodes + 1, np.int64)
    indices = np.empty(e, np.int32)
    eid = np.empty(e, np.int64) if with_eid else None
    eid_p = _ptr(eid, ctypes.c_int64) if with_eid else None
    if rows.dtype == np.int32 and cols.dtype == np.int32:
        rows = np.ascontiguousarray(rows, np.int32)
        cols = np.ascontiguousarray(cols, np.int32)
        lib.csr_from_coo_i32(
            _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32), e, n_nodes,
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32), eid_p,
        )
    else:
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        lib.csr_from_coo_i64(
            _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64), e, n_nodes,
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32), eid_p,
        )
    return indptr, indices, eid


def gather_rows(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Parallel host row gather; ids below 0 or at the row count and above
    give zero rows."""
    lib = _loaded()
    table = np.ascontiguousarray(table)
    ids = np.ascontiguousarray(ids, np.int64)
    out = np.empty((ids.shape[0],) + table.shape[1:], table.dtype)
    lib.gather_rows_bytes(
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        table.shape[0], table.strides[0],
        _ptr(ids, ctypes.c_int64), ids.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def sample_neighbors(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray,
                     k: int, seed: int = 0):
    """Host reservoir sampler with the padded ``(S, k)`` / -1 contract:
    ``(neighbours int32, counts int32)``; row ``i``'s generator is keyed on
    ``(seed, i)``, so the draws do not depend on the thread count."""
    lib = _loaded()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    if indices.shape[0] < int(indptr[-1]):
        raise ValueError(f"indices hold {indices.shape[0]} slots, indptr names {int(indptr[-1])}")
    if seeds.size and int(seeds.max()) >= indptr.shape[0] - 1:
        raise ValueError(f"seeds must lie below {indptr.shape[0] - 1} (-1 pads)")
    s = seeds.shape[0]
    out = np.empty((s, k), np.int32)
    counts = np.empty(s, np.int32)
    lib.sample_neighbors_cpu(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(seeds, ctypes.c_int32), s, k, seed,
        _ptr(out, ctypes.c_int32), _ptr(counts, ctypes.c_int32),
    )
    return out, counts


def reindex(seeds: np.ndarray, neighbors: np.ndarray):
    """Order-preserving hash reindex.

    Args:
      seeds: ``(S,)`` int32 node ids, -1 for padding; every valid seed
        keeps its own frontier slot (duplicates included).
      neighbors: ``(S, k)`` int32 sampled ids, -1 invalid.

    Returns:
      ``(frontier (M,) int32`` seeds first, then first occurrences;
      ``col (S, k) int32`` frontier-local ids, -1 where invalid).
    """
    lib = _loaded()
    seeds = np.ascontiguousarray(seeds, np.int32)
    neighbors = np.ascontiguousarray(neighbors, np.int32)
    s, k = neighbors.shape
    if seeds.shape[0] != s:
        raise ValueError(f"seeds {seeds.shape} vs neighbors {neighbors.shape}")
    frontier = np.empty(s * (k + 1), np.int32)
    col = np.empty((s, k), np.int32)
    m = lib.reindex_cpu(
        _ptr(seeds, ctypes.c_int32), s,
        _ptr(neighbors, ctypes.c_int32), k,
        _ptr(frontier, ctypes.c_int32), _ptr(col, ctypes.c_int32),
    )
    return frontier[:m].copy(), col


def num_threads() -> int:
    """OpenMP threads the library runs with (0 when unavailable)."""
    lib = _library()
    return lib.quiver_host_num_threads() if lib is not None else 0
