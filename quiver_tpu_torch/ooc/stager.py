"""AsyncStager: bounded background window reads for the disk tier.

The port of ``quiver_tpu/ooc/stager.py``, with the JAX package's read
order, LRU, counters and seeded retry sequence (so its backoff delays are
the same). The worker threads only read bytes on the host; they make no
CUDA call, so a store's K2 launch and its staging copies stay on the
caller's thread and stream.

The ``Prefetcher`` hides batch t+1's host-side sample and gather under
batch t's device step; this class rides the same pattern one level down:
the disk reads a cold-row gather needs go to a single background thread
as WINDOW reads (``window_rows`` consecutive rows per read; staged layouts
keep reads contiguous), and the gather blocks only on the windows it
needs. The blocked share is measured:

* ``ooc.stage_wait`` (StepTimeline stage and registry gauge, seconds):
  time :meth:`fetch` spent blocked on window futures, the EXPOSED disk
  cost; reads that completed under compute cost nothing here (their full
  durations land on the ``ooc.read`` timeline stage);
* ``ooc.page_reads``: window reads issued to disk;
* ``ooc.readahead_hits``: requested rows served without a new read: the
  row's window was already cached or in flight, or rode in on a window
  this same fetch dispatched for a neighbouring row (every row beyond a
  dispatched window's first is a readahead hit).

A raising read is retried with bounded exponential backoff and seeded
jitter (``retries``/``backoff``/``backoff_cap``/``jitter``/``retry_seed``,
the Prefetcher's contract); exhausted retries surface at the fetch that
needed the window. The worker is a single thread, so the read order, and
with it the page cache's eviction order, is deterministic.

The stager owns its executor: call :meth:`close` (or use it as a context
manager) when done.
"""

from __future__ import annotations

import collections
import concurrent.futures
import random
import threading
import time

import numpy as np
import torch

from ..obs.registry import (
    OOC_PAGE_READS,
    OOC_READAHEAD_HITS,
    OOC_STAGE_WAIT,
)

__all__ = ["AsyncStager"]


class AsyncStager:
    """Stage disk-tier row windows through a bounded background reader.

    Args:
      read_window: callable ``(window_index) -> np.ndarray`` returning
        the window's rows — the only thing that touches the disk. Runs
        on the worker thread; may raise (retried per the policy below).
      num_windows: total window count (bounds prefetch requests).
      window_rows: rows per window (the readahead granularity).
      cache_windows: LRU capacity in windows; also the in-flight bound —
        the stager never holds more than ``cache_windows`` windows
        staged + pending, so resident staging bytes are
        ``cache_windows * window_bytes`` regardless of graph size.
      retries / backoff / backoff_cap / jitter / retry_seed: the
        Prefetcher's bounded-retry contract for a raising read.
      metrics: optional ``MetricsRegistry``: lands
        ``ooc.page_reads`` / ``ooc.readahead_hits`` counters and the
        cumulative ``ooc.stage_wait`` gauge.
      timeline: optional StepTimeline — per-event ``ooc.stage_wait``
        (exposed wait per fetch), ``ooc.read`` (each background read's
        duration), ``ooc.retry_wait`` (each backoff sleep).
      tracer: optional :class:`~..obs.tracing.Tracer`: the same per-event
        stages land as spans (subsystem ``stager``) tagged with the causing
        ``trace`` id.
      trace: trace id the stager's spans attach to.
    """

    def __init__(self, read_window, num_windows: int, window_rows: int,
                 cache_windows: int = 32, retries: int = 0,
                 backoff: float = 0.05, backoff_cap: float = 2.0,
                 jitter: float = 0.5, retry_seed: int = 0,
                 metrics=None, timeline=None, tracer=None,
                 trace: str | None = None):
        if num_windows < 1:
            raise ValueError(f"num_windows must be >= 1, got {num_windows}")
        if window_rows < 1:
            raise ValueError(f"window_rows must be >= 1, got {window_rows}")
        if cache_windows < 1:
            raise ValueError(
                f"cache_windows must be >= 1, got {cache_windows}"
            )
        if retries < 0 or backoff < 0 or backoff_cap < 0 or jitter < 0:
            raise ValueError(
                "retries/backoff/backoff_cap/jitter must be >= 0"
            )
        self._read_window = read_window
        self.num_windows = int(num_windows)
        self.window_rows = int(window_rows)
        self.cache_windows = int(cache_windows)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self.metrics = metrics
        self.timeline = timeline
        if metrics is not None:
            metrics.counter(
                OOC_PAGE_READS, unit="windows",
                doc="disk window reads issued by the out-of-core stager "
                    "(lifetime total)",
            )
            metrics.counter(
                OOC_READAHEAD_HITS, unit="rows",
                doc="requested disk rows served from an already-staged "
                    "window — cached, in flight, or amortized onto a "
                    "neighboring row's windowed read (lifetime total)",
            )
            metrics.gauge(
                OOC_STAGE_WAIT, dtype=torch.float32, unit="s",
                doc="cumulative seconds gathers spent BLOCKED on disk "
                    "window reads (the exposed share of disk cost)",
            )
        # jitter PRNG lives on the single worker thread (like the
        # Prefetcher's: deterministic backoff stream per retry_seed)
        self._jitter_rng = random.Random(retry_seed)
        self._lock = threading.Lock()
        # window index -> rows (completed) / Future (in flight); the
        # worker function NEVER takes the lock — fetch() publishes
        # completed windows into the cache after waiting
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._pending: dict = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="quiver-ooc-stage"
        )
        self.tracer = tracer
        self.trace = trace
        self.page_reads_total = 0
        self.readahead_hits_total = 0
        self.read_retries_total = 0
        self.stage_wait_total = 0.0

    # -- telemetry -----------------------------------------------------------

    def _observe(self, stage: str, seconds: float) -> None:
        if self.timeline is not None:
            self.timeline.observe(stage, seconds)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.observe(
                stage, seconds, trace=self.trace, subsystem="stager",
            )

    def _publish_counters(self) -> None:
        if self.metrics is not None:
            self.metrics.set(OOC_PAGE_READS, np.int32(self.page_reads_total))
            self.metrics.set(
                OOC_READAHEAD_HITS, np.int32(self.readahead_hits_total)
            )
            self.metrics.set(
                OOC_STAGE_WAIT, np.float32(self.stage_wait_total)
            )

    # -- worker side (no lock: reads bytes, returns them) --------------------

    def _read_resilient(self, window: int) -> np.ndarray:
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                rows = self._read_window(window)
            except Exception:  # noqa: BLE001 — bounded retry, then surface
                if attempt >= self.retries:
                    raise
                attempt += 1
                self.read_retries_total += 1
                delay = min(
                    self.backoff * 2.0 ** (attempt - 1), self.backoff_cap
                ) * (1.0 + self.jitter * self._jitter_rng.random())
                self._observe("ooc.retry_wait", delay)
                if delay > 0:
                    time.sleep(delay)
            else:
                self._observe("ooc.read", time.perf_counter() - t0)
                return np.asarray(rows)

    # -- staging -------------------------------------------------------------

    def _windows_of(self, rows: np.ndarray) -> np.ndarray:
        return np.unique(rows // self.window_rows)

    def _dispatch_locked(self, window: int) -> None:
        """Issue one window read (caller holds the lock; submit() only
        enqueues — the worker function takes no locks, so there is no
        re-acquisition across this call)."""
        self._pending[window] = self._pool.submit(
            self._read_resilient, int(window)
        )
        self.page_reads_total += 1

    def prefetch(self, rows) -> int:
        """Dispatch background reads for the windows covering ``rows``
        without waiting. Bounded: stops once staged + in-flight windows
        reach ``cache_windows``. Returns the number of reads issued."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            return 0
        issued = 0
        with self._lock:
            for w in self._windows_of(rows).tolist():
                if w in self._cache or w in self._pending:
                    continue
                if len(self._cache) + len(self._pending) >= self.cache_windows:
                    break
                self._dispatch_locked(w)
                issued += 1
        if issued:
            self._publish_counters()
        return issued

    def fetch(self, rows) -> np.ndarray:
        """Gather disk rows ``rows`` (1-D, window-relative row ids),
        blocking only on the windows not already staged. Returns the
        (len(rows), ...) row block in request order."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            raise ValueError("fetch of an empty row set")
        windows = rows // self.window_rows
        uniq, counts = np.unique(windows, return_counts=True)
        need: dict[int, object] = {}
        with self._lock:
            for w, c in zip(uniq.tolist(), counts.tolist()):
                if w in self._cache:
                    self._cache.move_to_end(w)
                    need[w] = self._cache[w]
                    self.readahead_hits_total += c
                elif w in self._pending:
                    # in flight from an earlier prefetch/fetch: its rows
                    # were hidden up to now — hits, even if we block on
                    # the tail of the read below
                    need[w] = self._pending[w]
                    self.readahead_hits_total += c
                else:
                    self._dispatch_locked(w)
                    need[w] = self._pending[w]
                    # the windowed read amortizes: every requested row
                    # beyond the window's first rode along for free
                    self.readahead_hits_total += c - 1
        t0 = time.perf_counter()
        blocks = {}
        waited = False
        for w, src in need.items():
            if isinstance(src, np.ndarray):
                blocks[w] = src
            else:
                waited = True
                blocks[w] = src.result()  # raises if retries exhausted
        wait = time.perf_counter() - t0 if waited else 0.0
        self.stage_wait_total += wait
        self._observe("ooc.stage_wait", wait)
        with self._lock:
            for w in need:
                self._pending.pop(w, None)
                self._cache[w] = blocks[w]
                self._cache.move_to_end(w)
            while len(self._cache) > self.cache_windows:
                self._cache.popitem(last=False)
        self._publish_counters()
        out = None
        for w in blocks:
            sel = windows == w
            local = rows[sel] - w * self.window_rows
            part = blocks[w][local]
            if out is None:
                out = np.empty((rows.size,) + part.shape[1:], part.dtype)
            out[sel] = part
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Shut the worker down without joining an in-flight read (it
        finishes in the background and is dropped)."""
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "AsyncStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
