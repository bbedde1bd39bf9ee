"""The serving programs' cache: fingerprints, manifests, and the process's
captured programs.

The port of ``quiver_tpu/serving/aot.py``. The JAX package persists each
ladder program's backend-compiled executable, so a replica in a fresh
process deserialises instead of compiling. The port's programs are CUDA
graphs (``serving/ladder.py``), and a CUDA graph cannot be serialised: it
holds the addresses of the tensors it read at capture. So a captured
program lives in a process-wide registry, keyed by its
:func:`program_fingerprint` and the addresses it baked, and what goes to
disk is what can be persisted: one manifest per fingerprint (``format``,
``fingerprint``, ``components``), published atomically.

A program is served from the cache when its manifest on disk is sound and
the registry holds a program for the same fingerprint and addresses: a
second replica in the same process joins with no capture. A fresh process
finds the manifests but no programs, so it captures again and republishes;
this is the one place where the port differs from the JAX package.

Cache discipline, as in the JAX package (shared with the kernel-election
cache, ``ops/election.py``):

* **Keying**: the fingerprint covers everything the program closed over
  (target, bucket, fanouts, lane caps, kernel, dedup, weighted, the CSR's
  committed ``version`` and the placed topology's shapes and dtypes, for
  the forward the model and its parameters' shapes, the feature width and
  row dtype, and the toolchain: torch, CUDA, the card). Any mismatch is a
  miss: build and publish, never a wrong program.
* **Tolerant load**: a corrupt, truncated or skewed manifest is a miss
  with ONE warning per process; the build that follows republishes over
  it.
* **Atomic publish**: temp file, fsync, ``os.replace``.

``QUIVER_AOT_CACHE`` overrides the default directory (beside
``QUIVER_ELECTION_CACHE``), resolved once per process.
"""

from __future__ import annotations

import hashlib
import json
import os
import weakref

from ..ops.election import (
    _election_cache_path,
    atomic_publish_bytes,
    tolerant_cache_read,
)
from ..utils.trace import get_logger, warn_once

__all__ = ["AOTExecutableCache", "program_fingerprint"]

_BLOB_FORMAT = 1

_AOT_CACHE_DIR: str | None = None

# the process's captured programs: (fingerprint, baked addresses) ->
# program, filled by AOTExecutableCache.store and read by its load. Weak:
# a program lives while a ladder serves from it, so the programs of a
# superseded placement go with the last ladder that held them.
_PROGRAMS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _aot_cache_dir() -> str:
    """Default cache directory (``QUIVER_AOT_CACHE``), resolved ONCE per
    process, beside the kernel-election cache. Tests reset
    ``_AOT_CACHE_DIR`` to resolve it again."""
    global _AOT_CACHE_DIR
    if _AOT_CACHE_DIR is None:
        _AOT_CACHE_DIR = os.environ.get(
            "QUIVER_AOT_CACHE",
            os.path.join(
                os.path.dirname(_election_cache_path()), "aot_executables"
            ),
        )
    return _AOT_CACHE_DIR


def as_cache(aot_cache) -> "AOTExecutableCache | None":
    """An ``aot_cache=`` argument as a cache: an
    :class:`AOTExecutableCache` itself, a directory path, ``True`` for the
    default directory, or None."""
    if aot_cache is None or isinstance(aot_cache, AOTExecutableCache):
        return aot_cache
    if aot_cache is True or isinstance(aot_cache, (str, os.PathLike)):
        return AOTExecutableCache(
            None if aot_cache is True else os.fspath(aot_cache))
    raise TypeError(f"aot_cache must be an AOTExecutableCache, a path or "
                    f"True, got {type(aot_cache).__name__}")


def program_fingerprint(components: dict) -> str:
    """Content hash of a program's identity: the SHA-256 of the canonical
    (sorted-key, no-whitespace) JSON encoding of ``components``, first 32
    hex digits; the JAX package's hash of the same dict."""
    canon = json.dumps(components, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:32]


class AOTExecutableCache:
    """Manifests of the serving programs on disk, over the process's
    registry of captured programs.

    ``load`` never raises: an absent, corrupt or skewed manifest, or a
    program this process has not captured, is a miss. ``store`` registers
    the program and publishes its manifest; a failed publish only costs
    the next replica a capture.

    ``hits``/``misses``/``stores``/``rejects`` are this cache object's
    counters (``rejects`` counts manifests that were present but
    unreadable or mismatched).
    """

    def __init__(self, path: str | None = None):
        self.path = str(path) if path is not None else _aot_cache_dir()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.rejects = 0

    def entry_path(self, fingerprint: str) -> str:
        return os.path.join(self.path, f"{fingerprint}.aotx")

    # -- load ---------------------------------------------------------------

    def load(self, fingerprint: str, addresses: tuple = ()):
        """The captured program for ``fingerprint`` over ``addresses`` (the
        tensors it reads), or ``None``. A hit needs a sound manifest on
        disk and the program in this process's registry."""
        path = self.entry_path(fingerprint)
        blob = tolerant_cache_read(
            path, lambda f: json.loads(f.read().decode("utf-8")),
            what="AOT-program", child="serving.aot",
        )
        if blob is None:
            self.misses += 1
            if os.path.exists(path):
                self.rejects += 1
            return None
        if (not isinstance(blob, dict)
                or blob.get("format") != _BLOB_FORMAT
                or blob.get("fingerprint") != fingerprint):
            # format or fingerprint skew: treated exactly as corruption,
            # the build that follows republishes over it
            warn_once(
                f"cache-unreadable:{path}:skew",
                "AOT-program cache entry %s does not match its "
                "fingerprint/format; capturing and republishing",
                path, child="serving.aot",
            )
            self.misses += 1
            self.rejects += 1
            return None
        program = _PROGRAMS.get((fingerprint, tuple(addresses)))
        if program is None:
            self.misses += 1
            return None
        self.hits += 1
        return program

    # -- store --------------------------------------------------------------

    def store(self, fingerprint: str, program, components: dict | None = None,
              addresses: tuple = ()) -> bool:
        """Register ``program`` under ``(fingerprint, addresses)`` and
        atomically publish its manifest; True on publish. An unwritable
        directory logs once and returns False (the program is registered
        either way)."""
        _PROGRAMS[(fingerprint, tuple(addresses))] = program
        blob = json.dumps({
            "format": _BLOB_FORMAT,
            "fingerprint": fingerprint,
            "components": components,
        }, sort_keys=True).encode("utf-8")
        try:
            atomic_publish_bytes(self.entry_path(fingerprint), blob)
        except OSError as e:
            warn_once(
                f"aot-store:{self.path}:write",
                "AOT cache %s unwritable (%s: %s); replicas will capture "
                "instead of warming from it", self.path,
                type(e).__name__, str(e)[:200], child="serving.aot",
            )
            return False
        self.stores += 1
        get_logger("serving.aot").info(
            "published AOT program %s (%d bytes)", fingerprint, len(blob)
        )
        return True

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.path)
                       if n.endswith(".aotx"))
        except OSError:
            return 0

    def stats(self) -> dict:
        return {"path": self.path, "entries": len(self), "hits": self.hits,
                "misses": self.misses, "stores": self.stores,
                "rejects": self.rejects}
