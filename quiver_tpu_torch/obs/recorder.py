"""Black-box flight recorder: a bounded telemetry ring and atomic
postmortem bundles.

The port of ``quiver_tpu/obs/recorder.py``. When a circuit breaker opens
or a serving queue sheds a burst, the telemetry that explains the failure
is what the live process is about to overwrite. :class:`FlightRecorder`
keeps a bounded ring of recent decision/audit events, and on a trigger
dumps a self-describing POSTMORTEM BUNDLE: the tracer's recent spans
(Chrome trace-event JSON, for Perfetto), every attached registry's metric
snapshots, the event ring, and a manifest naming the trigger reason and
the faulting stage.

A bundle is published atomically, in the JAX package's layout: every file
is written into a temp directory and fsynced, a per-file CRC32 manifest
is written next, the ``COMMIT`` marker
(``resilience/integrity.COMMIT_NAME``) is the LAST write, and one
``os.replace`` publishes the directory. A crash mid-dump leaves only an
invisible temp dir, never a half-readable bundle. :func:`verify_bundle`
re-derives every checksum, and each package's ``verify_bundle`` accepts
the other's bundles; :func:`list_bundles` quarantine-renames any torn
directory it finds.

``trigger(..., inject_failure=)`` is the chaos seam: ``"crash"`` dies
before the COMMIT marker (leaving the invisible temp), ``"torn"``
publishes a bundle with a corrupted payload and no marker, so the
quarantine path can be drilled.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib

import numpy as np

from ..resilience.integrity import COMMIT_NAME, quarantine_name
from .export import snapshot_to_dict
from .registry import RECORDER_BUNDLES, RECORDER_EVENTS, MetricsRegistry
from .tracing import to_chrome_trace

__all__ = [
    "BUNDLE_FORMAT",
    "BUNDLE_MANIFEST",
    "FlightRecorder",
    "TornBundle",
    "list_bundles",
    "verify_bundle",
]

BUNDLE_FORMAT = "quiver-postmortem-v1"
BUNDLE_MANIFEST = "manifest.json"
_BUNDLE_PREFIX = "postmortem-"
_INJECT_MODES = ("crash", "torn")


class TornBundle(RuntimeError):
    """A postmortem bundle failed integrity verification (missing COMMIT
    marker, unreadable/foreign manifest, or a payload checksum mismatch).
    Treated like :class:`~..resilience.integrity.CorruptCheckpoint`:
    quarantine and ignore."""


class FlightRecorder:
    """Bounded black-box ring + triggered atomic postmortem dumps.

    Args:
      directory: bundle root (created if missing).
      capacity: event-ring bound (oldest :meth:`note` records evicted).
      keep: committed-bundle retention window (oldest pruned after a
        successful dump; the newest ``keep`` survive).
      tracer: optional :class:`~.tracing.Tracer` whose
        retained spans are dumped into every bundle (``spans.json``,
        Chrome trace-event format).
      metrics: optional :class:`MetricsRegistry` to land the recorder's
        own counters on (``recorder.bundles`` / ``recorder.events``);
        it is also snapshotted into bundles like any attached registry.

    Wire one recorder through a stack (server + breaker) and every fault
    class dumps into one directory with the shared tracer/metric context
    attached.
    """

    def __init__(self, directory, capacity: int = 512, keep: int = 4,
                 tracer=None, metrics: MetricsRegistry | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.capacity = int(capacity)
        self.keep = int(keep)
        self.tracer = tracer
        self.metrics = metrics
        self._registries: list[MetricsRegistry] = []
        if metrics is not None:
            metrics.counter(
                RECORDER_BUNDLES, unit="bundles",
                doc="postmortem bundles published by the flight recorder "
                    "(trigger events + explicit dumps)",
            )
            metrics.counter(
                RECORDER_EVENTS, unit="events",
                doc="decision/audit events noted into the flight "
                    "recorder's bounded ring (lifetime total)",
            )
            self._registries.append(metrics)
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.events_total = 0
        self.bundles_total = 0
        self._seq = self._next_seq()

    def _next_seq(self) -> int:
        seq = 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 1
        for name in names:
            if not name.startswith(_BUNDLE_PREFIX):
                continue
            parts = name[len(_BUNDLE_PREFIX):].split("-", 1)
            try:
                seq = max(seq, int(parts[0]))
            except ValueError:
                continue
        return seq + 1

    # -- ring ----------------------------------------------------------------

    def attach_registry(self, registry: MetricsRegistry) -> "FlightRecorder":
        """Snapshot this registry into every future bundle (idempotent)."""
        if registry is not None and all(r is not registry
                                        for r in self._registries):
            self._registries.append(registry)
        return self

    def note(self, kind: str, **attrs) -> None:
        """Append one decision/audit record to the bounded ring — cheap
        host bookkeeping; only a trigger persists anything."""
        with self._lock:
            self.events_total += 1
            self._events.append({
                "seq": self.events_total,
                "kind": str(kind),
                "t": time.time(),
                **{k: _jsonable(v) for k, v in attrs.items()},
            })
            total = self.events_total
        if self.metrics is not None:
            self.metrics.set(RECORDER_EVENTS, np.int32(total))

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # -- dumping -------------------------------------------------------------

    def trigger(self, reason: str, stage: str | None = None,
                inject_failure: str | None = None, **attrs) -> str:
        """Dump one postmortem bundle for ``reason`` (the fault class)
        with ``stage`` naming the faulting stage; returns the committed
        bundle path. ``inject_failure`` is the chaos seam — ``"crash"``
        raises before the COMMIT marker (invisible temp left behind),
        ``"torn"`` publishes a corrupt, marker-less bundle."""
        if inject_failure is not None and inject_failure not in _INJECT_MODES:
            raise ValueError(
                f"inject_failure must be one of {_INJECT_MODES}, "
                f"got {inject_failure!r}"
            )
        with self._lock:
            seq = self._seq
            self._seq += 1
        name = f"{_BUNDLE_PREFIX}{seq:06d}-{_slug(reason)}"
        final = os.path.join(self.directory, name)
        tmp_dir = os.path.join(self.directory, f".tmp-{name}")
        os.makedirs(tmp_dir)
        spans = self.tracer.spans() if self.tracer is not None else []
        snaps = []
        for reg in self._registries:
            snaps.extend(snapshot_to_dict(s) for s in reg.snapshots())
        payload = {
            "spans.json": _encode(to_chrome_trace(spans)),
            "metrics.json": _encode(snaps),
            "events.json": _encode(self.events()),
        }
        files = {}
        for fname, data in payload.items():
            _write_file(os.path.join(tmp_dir, fname), data)
            files[fname] = {
                "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                "nbytes": len(data),
            }
        manifest = {
            "format": BUNDLE_FORMAT,
            "seq": seq,
            "reason": str(reason),
            "stage": stage,
            "attrs": {k: _jsonable(v) for k, v in attrs.items()},
            "written_at": time.time(),
            "spans": len(spans),
            "events": len(self._events),
            "files": files,
        }
        _write_file(os.path.join(tmp_dir, BUNDLE_MANIFEST),
                    _encode(manifest))
        if inject_failure == "crash":
            # the kill-mid-dump drill: die with the temp dir on disk —
            # no COMMIT, no publish; list_bundles never sees it
            raise RuntimeError(
                f"injected recorder crash before COMMIT (temp left at "
                f"{tmp_dir})"
            )
        if inject_failure == "torn":
            # simulate lost unflushed pages surfacing at the final name:
            # truncate a payload and publish WITHOUT the marker
            with open(os.path.join(tmp_dir, "spans.json"), "w") as fh:
                fh.write('{"traceEvents": [tor')
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp_dir, final)
            return final
        _write_file(os.path.join(tmp_dir, COMMIT_NAME), b"COMMIT\n")
        os.replace(tmp_dir, final)
        with self._lock:
            self.bundles_total += 1
            total = self.bundles_total
        if self.metrics is not None:
            self.metrics.set(RECORDER_BUNDLES, np.int32(total))
        self._prune()
        return final

    def dump(self, stage: str | None = None,
             inject_failure: str | None = None, **attrs) -> str:
        """Explicit (non-fault) postmortem dump."""
        return self.trigger("manual", stage=stage,
                            inject_failure=inject_failure, **attrs)

    def _prune(self) -> None:
        bundles = list_bundles(self.directory, quarantine=False)
        for path, _manifest in bundles[: max(len(bundles) - self.keep, 0)]:
            for fname in os.listdir(path):
                try:
                    os.unlink(os.path.join(path, fname))
                except OSError:
                    pass
            try:
                os.rmdir(path)
            except OSError:
                pass

    def bundles(self) -> list[tuple[str, dict]]:
        """Committed, integrity-verified bundles (oldest first); torn
        directories are quarantined as a side effect."""
        return list_bundles(self.directory, quarantine=True)


# -- verification -------------------------------------------------------------

def verify_bundle(path: str) -> dict:
    """Full integrity check of one bundle directory: COMMIT marker,
    manifest parse + format, every payload file's size and CRC32.
    Returns the manifest; raises :class:`TornBundle` naming the first
    failing check."""
    if not os.path.isdir(path):
        raise TornBundle(f"{path}: not a bundle directory")
    if not os.path.exists(os.path.join(path, COMMIT_NAME)):
        raise TornBundle(f"{path}: no COMMIT marker (torn/partial dump)")
    mpath = os.path.join(path, BUNDLE_MANIFEST)
    try:
        with open(mpath, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise TornBundle(
            f"{path}: unreadable manifest ({type(e).__name__}: {e})"
        ) from None
    if manifest.get("format") != BUNDLE_FORMAT:
        raise TornBundle(
            f"{path}: unknown bundle format {manifest.get('format')!r} "
            f"(expected {BUNDLE_FORMAT!r})"
        )
    for fname, rec in manifest.get("files", {}).items():
        fpath = os.path.join(path, fname)
        try:
            with open(fpath, "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise TornBundle(f"{path}: unreadable {fname} ({e})") from None
        if len(data) != int(rec["nbytes"]):
            raise TornBundle(
                f"{path}: {fname} is {len(data)} B, manifest covers "
                f"{rec['nbytes']} B"
            )
        crc = zlib.crc32(data) & 0xFFFFFFFF
        if crc != int(rec["crc32"]):
            raise TornBundle(
                f"{path}: checksum mismatch on {fname} "
                f"(stored {rec['crc32']}, computed {crc})"
            )
    return manifest


def list_bundles(directory, quarantine: bool = True) -> list[tuple[str, dict]]:
    """(path, manifest) for every valid bundle under ``directory``,
    oldest (lowest seq) first. A final-named directory that fails
    verification is quarantine-renamed (``quarantine=True``) so no later
    scan trusts it — temp dirs are invisible by construction."""
    out = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not name.startswith(_BUNDLE_PREFIX):
            continue
        path = os.path.join(directory, name)
        try:
            manifest = verify_bundle(path)
        except TornBundle:
            if quarantine:
                qpath = os.path.join(
                    directory,
                    quarantine_name(name, int(time.time() * 1e6)),
                )
                try:
                    os.replace(path, qpath)
                except OSError:
                    pass
            continue
        out.append((path, manifest))
    out.sort(key=lambda pm: int(pm[1].get("seq", 0)))
    return out


# -- helpers ------------------------------------------------------------------

def _slug(reason: str) -> str:
    keep = [c if c.isalnum() else "_" for c in str(reason).lower()]
    return "".join(keep)[:40] or "trigger"


def _encode(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _write_file(path: str, data: bytes) -> None:
    """Write + fsync one bundle member (always under the temp dir —
    the atomic-publish discipline's write helper)."""
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
