"""Raw on-disk format: one ``.npy`` file per array and a CRC32 manifest.

The port of ``quiver_tpu/ooc/format.py`` (numpy and the standard library
only), with the same file names, manifest keys and checksums, so a
directory that either package writes loads in the other, bitwise.

``CSRTopo.save`` writes one ``.npz`` by default, a zip that numpy reads
only by decompressing whole members into memory, which an out-of-core
load must not do. This format is a DIRECTORY of uncompressed ``.npy``
files (each ``np.memmap``-able in place) described by ``manifest.json``
(per array: shape, dtype, byte span, CRC32), with a checkpoint's
durability discipline (``resilience/integrity.py``):

* every file lands in a temporary directory on the same file system
  first, fsynced;
* the ``COMMIT`` marker is written last inside it;
* one ``os.replace`` renames the directory into place, so a reader that
  sees the final name sees a complete artifact, and a crash at any
  earlier point leaves only a temporary directory, never a torn one.

Verification has two speeds. :func:`load_raw_dir` always checks the
structure (COMMIT marker, manifest format, every file present at its
manifested byte size), O(1) per array. The full CRC32 sweep
(:func:`verify_raw_dir`) reads every byte, which defeats the
O(touched pages) residency an mmap load exists for, so mmap loads skip it
by default and eager loads run it; ``verify=`` overrides either way. A
directory that fails verification is renamed aside by
:func:`quarantine_raw_dir` (the checkpoint quarantine naming), so no later
load trusts it.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from ..resilience.integrity import (
    COMMIT_NAME,
    MANIFEST_NAME,
    array_checksum,
    quarantine_name,
)

__all__ = [
    "RAW_FORMAT",
    "CorruptRawDir",
    "load_raw_dir",
    "npy_data_offset",
    "quarantine_raw_dir",
    "save_raw_dir",
    "verify_raw_dir",
]

RAW_FORMAT = "quiver-ooc-raw-v1"


class CorruptRawDir(ValueError):
    """A raw-format directory failed verification (missing COMMIT,
    unreadable manifest, file-size mismatch, or a CRC32 mismatch).
    Loaders treat this as "this artifact does not exist": quarantine the
    directory and fall back (e.g. to a legacy ``.npz``)."""


def npy_data_offset(path: str) -> tuple[tuple, np.dtype, int]:
    """Parse an ``.npy`` header: (shape, dtype, data byte offset).

    The offset is what windowed ``os.pread`` access needs to address row
    ranges without mapping the file; C order is required (every writer
    here emits C-contiguous arrays).
    """
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(fh)
        if fortran:
            raise CorruptRawDir(
                f"{path}: Fortran-order .npy unsupported in the raw format"
            )
        return shape, dtype, fh.tell()


def _fsync_write_npy(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as fh:
        np.lib.format.write_array(
            fh, np.ascontiguousarray(arr), allow_pickle=False
        )
        fh.flush()
        os.fsync(fh.fileno())


def _fsync_write_text(path: str, text: str) -> None:
    with open(path, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_raw_dir(path: str, arrays: dict, meta: dict | None = None) -> dict:
    """Atomically publish ``arrays`` as a raw-format directory at ``path``.

    Each array lands as ``<name>.npy`` (uncompressed, C order, fsynced)
    with a manifest record ``{file, shape, dtype, nbytes, data_offset,
    crc32}``; ``meta`` rides the manifest uninterpreted. An existing
    directory at ``path`` is replaced atomically (rotated aside, the new
    directory renamed in, the old one removed). Returns the manifest.
    """
    path = os.path.normpath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        records = {}
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            fname = f"{name}.npy"
            fpath = os.path.join(tmp, fname)
            _fsync_write_npy(fpath, arr)
            _, _, offset = npy_data_offset(fpath)
            records[name] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "nbytes": int(arr.nbytes),
                "data_offset": int(offset),
                "crc32": array_checksum(arr),
            }
        manifest = {
            "format": RAW_FORMAT,
            "arrays": records,
            "meta": dict(meta or {}),
        }
        _fsync_write_text(
            os.path.join(tmp, MANIFEST_NAME),
            json.dumps(manifest, indent=1, sort_keys=True),
        )
        _fsync_write_text(os.path.join(tmp, COMMIT_NAME), RAW_FORMAT + "\n")
        _fsync_dir(tmp)
        old = None
        if os.path.exists(path):
            old = f"{path}.old-{os.getpid()}"
            os.replace(path, old)
        os.replace(tmp, path)
        parent = os.path.dirname(path) or "."
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        return manifest
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_manifest(path: str) -> dict:
    """Structural read of a raw dir's manifest: COMMIT marker present,
    manifest parses, format recognized. Raises :class:`CorruptRawDir`."""
    if not os.path.isdir(path):
        raise CorruptRawDir(f"{path}: not a raw-format directory")
    if not os.path.exists(os.path.join(path, COMMIT_NAME)):
        raise CorruptRawDir(
            f"{path}: no COMMIT marker (uncommitted/partial save)"
        )
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise CorruptRawDir(
            f"{path}: unreadable manifest ({type(e).__name__}: {e})"
        ) from None
    if manifest.get("format") != RAW_FORMAT:
        raise CorruptRawDir(
            f"{path}: unknown raw format {manifest.get('format')!r} "
            f"(expected {RAW_FORMAT!r})"
        )
    return manifest


def load_raw_dir(path: str, mmap: bool = True,
                 verify: bool | None = None) -> tuple[dict, dict]:
    """Load a raw-format directory; returns ``(arrays, meta)``.

    ``mmap=True`` backs every array onto a read-only ``np.memmap`` —
    resident bytes stay O(touched pages). Structure is ALWAYS checked
    (COMMIT, manifest, per-file byte size); the full CRC32 sweep runs
    when ``verify`` is True, or by default on eager (``mmap=False``)
    loads — an mmap load skips it because checksumming pages the whole
    file in, which is the cost this format exists to avoid. Any failure
    raises :class:`CorruptRawDir`.
    """
    manifest = load_manifest(path)
    if verify is None:
        verify = not mmap
    arrays = {}
    for name, rec in manifest["arrays"].items():
        fpath = os.path.join(path, rec["file"])
        try:
            size = os.path.getsize(fpath)
        except OSError:
            raise CorruptRawDir(
                f"{path}: missing array file {rec['file']!r}"
            ) from None
        expected = int(rec["data_offset"]) + int(rec["nbytes"])
        if size != expected:
            raise CorruptRawDir(
                f"{path}: {rec['file']} is {size} B, manifest covers "
                f"{expected} B (truncated or torn write)"
            )
        try:
            arr = np.load(fpath, mmap_mode="r" if mmap else None,
                          allow_pickle=False)
        except (OSError, ValueError) as e:
            raise CorruptRawDir(
                f"{path}: unreadable array {rec['file']!r} "
                f"({type(e).__name__}: {e})"
            ) from None
        if (list(arr.shape) != list(rec["shape"])
                or str(arr.dtype) != rec["dtype"]):
            raise CorruptRawDir(
                f"{path}: {rec['file']} header {arr.shape}/{arr.dtype} "
                f"disagrees with manifest {rec['shape']}/{rec['dtype']}"
            )
        if verify:
            crc = array_checksum(arr)
            if crc != int(rec["crc32"]):
                raise CorruptRawDir(
                    f"{path}: checksum mismatch on {rec['file']!r} "
                    f"(stored {rec['crc32']}, computed {crc})"
                )
        arrays[name] = arr
    return arrays, dict(manifest.get("meta", {}))


def verify_raw_dir(path: str) -> dict:
    """Full integrity sweep (structure + every CRC32); pages every byte
    in — the pre-trust check for chaos recovery and tests, not the hot
    load path. Returns the manifest; raises :class:`CorruptRawDir`."""
    load_raw_dir(path, mmap=False, verify=True)
    return load_manifest(path)


def quarantine_raw_dir(path: str) -> str:
    """Rename a corrupt raw dir aside (checkpoint quarantine naming) so
    no later load trusts it; returns the new path."""
    path = os.path.normpath(path)
    parent, name = os.path.split(path)
    dest = os.path.join(
        parent, quarantine_name(name, time.time_ns() // 1000)
    )
    os.replace(path, dest)
    return dest
