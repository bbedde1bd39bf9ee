"""Background embedding-refresh lane for the serving path.

The port of ``quiver_tpu/serving/refresh.py``. Point queries answered by
the sampled k-hop forward read the live topology and store, so they are
fresh by construction. Another class of serving reads wants precomputed
embeddings: the full-graph layer-wise tables of ``models/inference.py``
(each layer computed once over all nodes, far cheaper per node than the
sampled forward at high query rates).

A precomputed table captures the host CSR at one committed version, and a
mutation invalidates it. :class:`EmbeddingRefresher` holds the table to
that: lookups raise :class:`~..core.topology.VersionMismatchError` once
the committed version drifts from the table's, :meth:`refresh` recomputes
(layer-wise, whole graph) and publishes table and version together, and
:meth:`start` runs that loop on a background thread, so the serving
thread never blocks on a rebuild. On a CUDA device every recompute runs on
the refresher's own stream and is published, under the lock, only after
that stream has synchronised.
"""

from __future__ import annotations

import threading

import torch

from ..core.memory import resolve_device
from ..core.topology import VersionMismatchError
from ..models.inference import sage_layerwise_inference

__all__ = ["EmbeddingRefresher"]


class EmbeddingRefresher:
    """Versioned full-graph embedding table with a background refresh loop.

    Args:
      model: the trained module (``infer_fn`` consumes it; the port's
        module holds its weights, so there is no ``params``).
      csr_topo: the HOST CSR a mutation changes; its committed
        ``version`` decides staleness.
      features: ``(N, F)`` input features, or a zero-argument callable
        returning them (bind it to the live store, so a mutation's row
        updates reach the next refresh).
      infer_fn: layer-wise inference entry point, called as
        ``infer_fn(model, csr_topo, x, chunk=, mode=, device=)`` (default
        :func:`~..models.inference.sage_layerwise_inference`).
      chunk / mode: forwarded to ``infer_fn``.
      tracer: optional :class:`~..obs.tracing.Tracer`; each recompute
        lands a ``serve.refresh`` span tagged with the version it
        published.
      device: where the table is computed and kept; CUDA unless the
        caller passes another.
    """

    def __init__(self, model, csr_topo, features, *, infer_fn=None,
                 chunk: int = 1 << 21, mode: str = "HBM", tracer=None,
                 device=None):
        self.model = model
        self.csr_topo = csr_topo
        self._features = features
        self.tracer = tracer
        self.infer_fn = infer_fn if infer_fn is not None else (
            sage_layerwise_inference
        )
        self.chunk = int(chunk)
        self.mode = mode
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.refreshes = 0
        self._table: torch.Tensor | None = None
        self._table_version: int | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _features_now(self):
        f = self._features
        return f() if callable(f) else f

    def _compute(self):
        return self.infer_fn(self.model, self.csr_topo, self._features_now(),
                             chunk=self.chunk, mode=self.mode,
                             device=self.device)

    # -- refresh -------------------------------------------------------------

    def refresh(self) -> int:
        """Recompute the whole-graph table from the committed state now
        and publish table and version together; returns the version
        published. Safe from the background thread while lookups read the
        old table."""
        version = int(self.csr_topo.version)
        t0 = (self.tracer.now()
              if self.tracer is not None and self.tracer.enabled else None)
        if self._stream is None:
            table = self._compute()
        else:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                table = self._compute()
            self._stream.synchronize()
        with self._lock:
            self._table = table
            self._table_version = version
            self.refreshes += 1
        if t0 is not None:
            self.tracer.record(
                "serve.refresh", t0, self.tracer.now() - t0,
                subsystem="serve", version=version,
            )
        return version

    # -- versioned reads -----------------------------------------------------

    def check_version(self) -> None:
        """Raise :class:`VersionMismatchError` when no table is published
        or it was built from a superseded commit: a stale embedding row is
        a wrong answer, not a cheap one."""
        with self._lock:
            ver = self._table_version
        current = int(self.csr_topo.version)
        if ver is None:
            raise VersionMismatchError(
                "no embedding table published yet; call refresh() (or "
                "start() the background lane) before lookup()"
            )
        if current != ver:
            raise VersionMismatchError(
                f"embedding table built from topology version {ver} but "
                f"the host CSR has committed version {current}; call "
                f"refresh() to recompute"
            )

    @property
    def version(self) -> int | None:
        """The committed version the published table reflects."""
        with self._lock:
            return self._table_version

    @property
    def table(self) -> torch.Tensor | None:
        """The published ``(N, num_classes)`` table (None before the first
        refresh), unchecked against the committed version."""
        with self._lock:
            # graftlint: disable=stale-version-read -- the documented unchecked accessor; lookup() is the checked read
            return self._table

    def lookup(self, ids) -> torch.Tensor:
        """Rows of the published table for ``ids``; raises
        :class:`VersionMismatchError` instead of serving stale rows."""
        self.check_version()
        with self._lock:
            table = self._table
        if table.is_cuda:
            # a later refresh frees this table only after the reading
            # stream's work is done
            table.record_stream(torch.cuda.current_stream(table.device))
        return table[torch.as_tensor(ids, device=table.device).to(torch.int64)]

    # -- background lane -----------------------------------------------------

    def start(self, interval_s: float = 1.0) -> threading.Thread:
        """Run the refresh loop on a daemon thread: poll the committed
        version every ``interval_s`` and recompute when it drifts (the
        first round publishes the initial table)."""
        if self._thread is not None:
            raise RuntimeError("refresh lane already running; stop() first")
        self._stop.clear()
        t = threading.Thread(
            target=self._loop, args=(float(interval_s),),
            name="embedding-refresh", daemon=True,
        )
        self._thread = t
        t.start()
        return t

    def _loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            try:
                self.check_version()
            except VersionMismatchError:
                self.refresh()
            self._stop.wait(interval_s)

    def stop(self) -> None:
        """Stop and join the background lane (idempotent)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def __enter__(self) -> "EmbeddingRefresher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
