"""Kernel elections (pallas vs xla) with one shared disk cache.

The port of ``quiver_tpu/ops/election.py``. The gather election
(``feature/feature.py``) and the sample election
(``sampling/sampler.py``) follow one contract:

1. an explicit ``kernel="pallas"|"xla"`` bypasses everything. "pallas"
   names the hand-written CUDA kernel, "xla" the stock-op path;
2. ``kernel="auto"`` off the card resolves to xla: on the CPU both names
   run plain PyTorch, as the JAX package's ``auto`` off the TPU is xla;
3. on a CUDA device, auto runs a one-time correctness smoke of the
   hand-written kernel. An election with a ``measure`` then ELECTS BY
   MEASURED THROUGHPUT between the two paths; one without a ``measure``
   resolves to the hand-written kernel, because its xla path is not a
   candidate for auto on the card (the gather's: its stock lookup runs
   no port kernel). Unlike the JAX package, a failed smoke or a failed
   measurement RAISES: the port swaps in no other path quietly;
4. a measured election is memoised per process and persisted in ONE disk
   cache file shared by every election (``QUIVER_ELECTION_CACHE``,
   default ``~/.cache/quiver_tpu/kernel_elections.json``), keyed by (rev,
   torch version, CUDA version, device name and compute capability), so a
   kernel or toolchain change forces re-election. The JAX package reads
   the same variable, so the port's entries take names of their own
   (prefixed ``torch.``), and each package keeps the other's entries when
   it rewrites the file. A corrupt or truncated cache degrades to
   re-election with ONE warning (:func:`tolerant_cache_read`) and every
   rewrite is an atomic publish (:func:`atomic_publish_bytes`);
5. ``env_var=pallas|xla`` (``QUIVER_GATHER_KERNEL``,
   ``QUIVER_SAMPLE_KERNEL``) overrides the smoke and the measurement.

Env-before-first-use: the force knob and ``QUIVER_ELECTION_CACHE`` are
read ONCE per process, at the first auto resolution; flipping them
afterwards is inert. Tests call ``reset()`` (and reset
``_ELECTION_CACHE_PATH``) to simulate a fresh process.
"""

from __future__ import annotations

import json
import os
from collections.abc import Callable

import torch

from ..utils.trace import get_logger, warn_once

__all__ = [
    "KernelElection",
    "atomic_publish_bytes",
    "tolerant_cache_read",
    "validate_kernel_arg",
]

_KERNELS = ("auto", "pallas", "xla")


def validate_kernel_arg(kernel: str) -> str:
    """Argument check only; touches no device."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be auto|pallas|xla, got {kernel!r}")
    return kernel


_ELECTION_CACHE_PATH: str | None = None


def _election_cache_path() -> str:
    """Disk-cache path shared by ALL elections (``QUIVER_ELECTION_CACHE``),
    resolved ONCE per process. Tests reset ``_ELECTION_CACHE_PATH``."""
    global _ELECTION_CACHE_PATH
    if _ELECTION_CACHE_PATH is None:
        _ELECTION_CACHE_PATH = os.environ.get(
            "QUIVER_ELECTION_CACHE",
            os.path.expanduser("~/.cache/quiver_tpu/kernel_elections.json"),
        )
    return _ELECTION_CACHE_PATH


def device_kind(device) -> str:
    """The card's name and compute capability, e.g.
    ``NVIDIA H100 80GB HBM3 sm90`` (part of the cache key)."""
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)} sm{major}{minor}"


def tolerant_cache_read(path: str, reader, *, what: str,
                        child: str | None = None):
    """Fail-safe shared-cache read: ``reader(binary_file)`` or ``None``.

    A missing file is a silent miss; anything else (truncation, garbage
    bytes, a permission error, a reader that chokes) is a miss plus ONE
    warning per (process, path); the caller recomputes and republishes
    over the bad file.
    """
    try:
        with open(path, "rb") as f:
            return reader(f)
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 — any corruption degrades to a
        # recompute; a cache must never be what takes a lookup down
        warn_once(
            f"cache-unreadable:{path}",
            "%s cache %s unreadable (%s: %s); ignoring it — recomputing "
            "and republishing over it", what, path, type(e).__name__,
            str(e)[:200], child=child,
        )
        return None


def atomic_publish_bytes(path: str, data: bytes) -> None:
    """Atomically publish ``data`` at ``path`` (write temp + fsync +
    ``os.replace``): concurrent readers see the old blob or the new one,
    never a torn write. Raises ``OSError`` on failure."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp_path = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp_path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, path)
    except OSError:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise


class KernelElection:
    """One named pallas-vs-xla election (see the module docstring).

    ``smoke(device)`` is the hand-written kernel's correctness gate (False
    or a raise makes auto raise on the card); ``measure(kernel, device)``
    maps ``"pallas"|"xla"`` to a higher-is-better score in ``unit``, and
    ``measure=None`` makes the smoke-checked kernel auto's only choice on
    the card (nothing measured or cached). Both run lazily at the first
    auto resolution on a CUDA device, never at construction. ``result`` holds the decided election
    (``{"kernel", "how", ...}``); ``reset()`` is the test seam simulating a
    fresh process (forgets the memo and the pinned env force).
    """

    CACHE_PREFIX = "torch."  # the port's entries in the shared file

    def __init__(self, name: str, env_var: str, rev: int,
                 smoke: Callable[[object], bool],
                 measure: Callable[[str, object], float] | None,
                 unit: str = "GB/s", log_child: str | None = None):
        self.name = name
        self.env_var = env_var
        self.rev = int(rev)
        self._smoke = smoke
        self._measure = measure
        self.unit = unit
        self._log_child = log_child or name
        self.result: dict | None = None
        self._forced: str | None = None

    @property
    def cache_entry(self) -> str:
        """This election's entry in the shared cache file."""
        return self.CACHE_PREFIX + self.name

    def forced(self) -> str:
        """The env force ("" = none), read ONCE per process."""
        if self._forced is None:
            self._forced = os.environ.get(self.env_var, "").strip().lower()
        return self._forced

    # -- disk cache (one file, nested by entry name) ------------------------

    def cache_key(self, device) -> str:
        return (f"rev{self.rev}-torch{torch.__version__}-"
                f"cuda{torch.version.cuda}-{device_kind(device)}")

    def _load_blob(self) -> dict:
        """The whole shared cache file as a dict: ``{}`` on a miss, and
        ``{}`` with ONE warning on a corrupt file or a non-object one."""
        path = _election_cache_path()
        blob = tolerant_cache_read(path, json.load, what="kernel-election",
                                   child=self._log_child)
        if blob is not None and not isinstance(blob, dict):
            warn_once(
                f"cache-unreadable:{path}:shape",
                "kernel-election cache %s holds a %s, not an object; "
                "ignoring it — re-electing and republishing over it",
                path, type(blob).__name__, child=self._log_child,
            )
            return {}
        return blob or {}

    def _load_cached(self, cache_key: str) -> dict | None:
        entry = self._load_blob().get(self.cache_entry)
        if (isinstance(entry, dict) and entry.get("key") == cache_key
                and entry.get("kernel") in ("pallas", "xla")):
            return entry
        return None

    def _store(self, entry: dict) -> None:
        # keep every election entry of either package (a value holding
        # "kernel"), drop anything else
        blob = {k: v for k, v in self._load_blob().items()
                if isinstance(v, dict) and "kernel" in v}
        blob[self.cache_entry] = entry
        try:
            atomic_publish_bytes(_election_cache_path(),
                                 json.dumps(blob).encode("utf-8"))
        except OSError:
            pass

    # -- resolution ----------------------------------------------------------

    def elect(self, device) -> str:
        """The election on CUDA ``device``: env force, else the smoke (a
        failure raises), else the hand-written kernel when there is no
        ``measure``, else the disk cache, else a measurement of both paths
        (a failure raises). Memoised per process."""
        if self.result is not None:
            return self.result["kernel"]
        log = get_logger(self._log_child)
        forced = self.forced()
        if forced in ("pallas", "xla"):
            self.result = {"kernel": forced, "how": "env override"}
            return forced
        if not self._smoke(device):
            raise RuntimeError(
                f"{self.name} kernel smoke returned wrong results on "
                f"{device}; kernel='auto' does not fall back (request "
                f"kernel='xla' for the stock-op path)")
        if self._measure is None:
            self.result = {"kernel": "pallas", "how": "smoke"}
            log.info("%s kernel=auto -> pallas (smoke passed; the only "
                     "candidate on the card)", self.name)
            return "pallas"
        cache_key = self.cache_key(device)
        cached = self._load_cached(cache_key)
        if cached is not None:
            self.result = {**cached, "how": "disk cache"}
            log.info("%s kernel=auto -> %s (cached election: %s)",
                     self.name, cached["kernel"], cached.get("score"))
            return cached["kernel"]
        score = {k: round(float(self._measure(k, device)), 2)
                 for k in ("xla", "pallas")}
        kernel = max(score, key=score.get)
        self.result = {"kernel": kernel, "score": score, "key": cache_key,
                       "how": "measured"}
        log.info("%s kernel=auto -> %s (measured %s: %s)",
                 self.name, kernel, self.unit, score)
        self._store({"kernel": kernel, "score": score, "key": cache_key})
        return kernel

    def resolve_request(self, kernel: str, device) -> str:
        """Resolve a kernel request for ``device``: explicit requests pass
        through; auto is xla off the card and the election on it."""
        validate_kernel_arg(kernel)
        if kernel != "auto":
            return kernel
        if torch.device(device).type != "cuda":
            return "xla"
        return self.elect(device)

    def reset(self) -> None:
        """Test seam: forget the in-process decision and the pinned env
        force, as a fresh process would."""
        self.result = None
        self._forced = None
