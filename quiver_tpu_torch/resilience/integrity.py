"""Checkpoint integrity: manifest schema, content checksums, verification.

The port's copy of ``quiver_tpu/resilience/integrity.py`` (numpy and the
standard library only). It keeps the same CRC32 (``zlib``), the same file
names and the same manifest layout, so each package verifies the other's
files. The flight recorder (``obs/recorder.py``) uses ``COMMIT_NAME`` and
:func:`quarantine_name`; the checkpoint store (ROADMAP A.7) will use the
rest.

A checkpoint directory is self-describing and tamper-evident:

* ``manifest.json`` — one record per saved leaf (stable key path, global
  shape, dtype, byte offset into the payload, CRC32 content checksum),
  the checksum of the pickled tree structure, and free-form writer
  metadata (``meta``).
* ``arrays.bin`` — every leaf's C-contiguous bytes, concatenated at the
  manifest's offsets.
* ``treedef.pkl`` — a pickled skeleton of the saved structure.
* ``COMMIT`` — the atomic durability marker. It is written LAST inside
  the temp directory, and the temp directory is then renamed into place
  in one ``os.replace``: a reader that sees the final name sees a
  complete checkpoint, and a crash at ANY earlier point leaves only a
  skipped temp directory — never a half-readable checkpoint.

:func:`verify_checkpoint_dir` re-derives every checksum and raises
:class:`CorruptCheckpoint` (with the first failing check named) on any
mismatch.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

__all__ = [
    "ARRAYS_NAME",
    "COMMIT_NAME",
    "CorruptCheckpoint",
    "FORMAT",
    "MANIFEST_NAME",
    "TREEDEF_NAME",
    "array_checksum",
    "build_manifest",
    "load_manifest",
    "quarantine_name",
    "verify_checkpoint_dir",
]

FORMAT = "quiver-ckpt-v1"
MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.bin"
TREEDEF_NAME = "treedef.pkl"
COMMIT_NAME = "COMMIT"


class CorruptCheckpoint(RuntimeError):
    """A checkpoint directory failed integrity verification (missing
    COMMIT marker, unreadable manifest, payload size mismatch, or a
    content-checksum mismatch). The restore path treats this as "this
    checkpoint does not exist": quarantine and fall back."""


def array_checksum(arr: np.ndarray) -> int:
    """CRC32 of the array's C-order bytes (the manifest's per-leaf
    content checksum — cheap enough to verify on every restore)."""
    return zlib.crc32(np.asarray(arr).tobytes()) & 0xFFFFFFFF


def build_manifest(step: int, leaves: list[dict], treedef_crc: int,
                   meta: dict | None = None) -> dict:
    """Assemble the manifest dict for one checkpoint.

    ``leaves`` are per-leaf records ``{path, shape, dtype, offset, nbytes,
    crc32}`` in payload order; ``treedef_crc`` covers the pickled skeleton
    bytes; ``meta`` is the writer's free-form metadata (never interpreted
    here; the trainer that resumes from it owns its semantics).
    """
    return {
        "format": FORMAT,
        "step": int(step),
        "leaves": list(leaves),
        "treedef_crc32": int(treedef_crc),
        "meta": dict(meta or {}),
    }


def load_manifest(path: str) -> dict:
    """Parse ``manifest.json`` under ``path``; raise
    :class:`CorruptCheckpoint` when missing, unparseable, or of an
    unknown format."""
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise CorruptCheckpoint(
            f"{path}: unreadable manifest ({type(e).__name__}: {e})"
        ) from None
    if manifest.get("format") != FORMAT:
        raise CorruptCheckpoint(
            f"{path}: unknown checkpoint format "
            f"{manifest.get('format')!r} (expected {FORMAT!r})"
        )
    return manifest


def verify_checkpoint_dir(path: str) -> dict:
    """Full integrity check of one checkpoint directory.

    Verifies, in order: the COMMIT marker exists, the manifest parses,
    the payload file has exactly the manifest's byte span, every leaf's
    CRC32 matches, and the pickled treedef's CRC32 matches. Returns the
    manifest on success; raises :class:`CorruptCheckpoint` naming the
    first failing check otherwise.
    """
    if not os.path.isdir(path):
        raise CorruptCheckpoint(f"{path}: not a checkpoint directory")
    if not os.path.exists(os.path.join(path, COMMIT_NAME)):
        raise CorruptCheckpoint(
            f"{path}: no COMMIT marker (uncommitted/partial save)"
        )
    manifest = load_manifest(path)
    apath = os.path.join(path, ARRAYS_NAME)
    try:
        with open(apath, "rb") as fh:
            payload = fh.read()
    except OSError as e:
        raise CorruptCheckpoint(f"{path}: unreadable payload ({e})") from None
    expected = sum(int(rec["nbytes"]) for rec in manifest["leaves"])
    if len(payload) != expected:
        raise CorruptCheckpoint(
            f"{path}: payload is {len(payload)} B, manifest covers "
            f"{expected} B"
        )
    for rec in manifest["leaves"]:
        off, n = int(rec["offset"]), int(rec["nbytes"])
        crc = zlib.crc32(payload[off:off + n]) & 0xFFFFFFFF
        if crc != int(rec["crc32"]):
            raise CorruptCheckpoint(
                f"{path}: checksum mismatch on leaf {rec['path']!r} "
                f"(stored {rec['crc32']}, computed {crc})"
            )
    tpath = os.path.join(path, TREEDEF_NAME)
    try:
        with open(tpath, "rb") as fh:
            tbytes = fh.read()
    except OSError as e:
        raise CorruptCheckpoint(f"{path}: unreadable treedef ({e})") from None
    tcrc = zlib.crc32(tbytes) & 0xFFFFFFFF
    if tcrc != int(manifest["treedef_crc32"]):
        raise CorruptCheckpoint(
            f"{path}: treedef checksum mismatch "
            f"(stored {manifest['treedef_crc32']}, computed {tcrc})"
        )
    return manifest


def quarantine_name(dirname: str, stamp: int) -> str:
    """Name a corrupt checkpoint directory is renamed to — prefixed so no
    step scan ever matches it again, stamped so repeated quarantines of
    same-named directories cannot collide."""
    return f"quarantine-{dirname}-{int(stamp)}"
