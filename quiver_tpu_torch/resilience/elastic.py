"""Elastic resume's reduction, and degraded-mode feature serving.

The port of ``quiver_tpu/resilience/elastic.py``.

:func:`worker_ordered_mean` is the step reduction of an elastic trainer
(``DistributedTrainer(logical_workers=)``): the per-block values in
logical-worker order, summed by an explicit left fold and only then
divided by the worker count, so the result does not depend on how the
logical workers map onto mesh slots. That is what lets ``resume(mesh=)``
continue a run on another mesh shape bitwise.

:class:`CircuitBreaker` and :class:`DegradedFeature` keep serving when a
store is down, with the JAX
package's state machine, thresholds, counter and recorder trigger. While
the breaker is closed, lookups pass through and failures propagate; after
``failures`` consecutive failures (an OUTAGE of the cold tier, not a
blip) it opens and lookups serve fallback rows (zeros, or each id's last
good rows) instead of raising, counted on the registry
(``resilience.degraded_lookups``); half-open probes re-test the real
store and close the breaker when the outage ends.

The last-good rows stay on the lookup's device, in a slot table; a dense
id -> slot map of the store's row count stays on the host (the JAX
package keeps a dict of per-row numpy arrays, filled row by row). A good
lookup costs one copy of its ids to the host (which waits for the ids, as
the serving stage does anyway), a few numpy ops, and one indexed copy of
its rows into the table. The rows served are the JAX package's: ids enter
in lane order until ``cache_rows`` distinct ids are held, a held id's row
is overwritten by each good lookup, and ids never seen get zero rows. An
id past the table is held under the last id, the row the store's lookup
reads for it.

:func:`validate_resume_meta` checks a checkpoint's manifest against the
trainer that restores it, with the JAX package's errors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.registry import DEGRADED_LOOKUPS, MetricsRegistry
from ..utils.trace import get_logger

__all__ = ["CircuitBreaker", "DegradedFeature", "validate_resume_meta",
           "worker_ordered_mean"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def worker_ordered_mean(tree, axes, workers: int):
    """Mean over the logical-worker axis in a fixed order, bitwise
    independent of how the workers map onto mesh slots.

    Each leaf is the ``(workers, ...)`` stack of the per-block values in
    logical-worker order (slot-major, block-minor: ``worker = slot *
    blocks_per_device + block``): on the port's one-process mesh this
    stack is the JAX package's ``all_gather``. The reduction is the
    explicit left fold ``g[0] + g[1] + ... + g[W-1]``, then the division by
    ``workers``; ``torch.mean`` and ``torch.sum`` reduce in another order.
    ``axes`` is accepted for the JAX package's signature and is inert.
    Leaves may sit in dicts, lists and tuples."""
    del axes  # the stack is already in logical-worker order

    def one(g):
        if g.shape[0] != workers:
            raise ValueError(
                f"a leaf of shape {tuple(g.shape)} does not stack {workers} workers"
            )
        total = g[0]
        for i in range(1, workers):
            total = total + g[i]
        return total / workers

    return _tree_map(one, tree)


def validate_resume_meta(meta: dict, *, mesh_shape: dict, workers: int,
                         local_batch: int) -> None:
    """Validate a checkpoint manifest's ``meta`` against the trainer that
    wants to restore it.

    Raises ``ValueError`` naming the first mismatch: the logical worker
    count and per-block batch size decide the seed packing and the
    per-block seeds, so a mismatch would not crash; it would silently
    train a DIFFERENT run. A mesh-shape change also needs the writer to
    have been elastic (``logical_workers=``): a trajectory reduced over
    one mesh is not reproducible on another shape.
    """
    saved_workers = meta.get("workers")
    if saved_workers is not None and int(saved_workers) != int(workers):
        raise ValueError(
            f"checkpoint was written with {saved_workers} logical workers, "
            f"this trainer runs {workers}; construct the trainer with "
            f"logical_workers={saved_workers} (seed packing and per-block "
            f"PRNG fold-in follow the logical worker count)"
        )
    saved_lb = meta.get("local_batch")
    if saved_lb is not None and int(saved_lb) != int(local_batch):
        raise ValueError(
            f"checkpoint was written with local_batch={saved_lb}, this "
            f"trainer uses {local_batch}; the per-block seed width must "
            f"match for the packed seed matrix to replay"
        )
    saved_mesh = meta.get("mesh")
    if saved_mesh is not None and dict(saved_mesh) != dict(mesh_shape):
        if not meta.get("elastic"):
            raise ValueError(
                f"checkpoint was written on mesh {dict(saved_mesh)} by a "
                f"NON-elastic trainer and cannot restore onto "
                f"{dict(mesh_shape)}: only the logical_workers= step "
                f"reduction is bit-reproducible across mesh shapes"
            )


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    Deterministic: the state advances only on :meth:`record_success` /
    :meth:`record_failure`, and the open -> half-open transition is
    COUNT-based (every ``probe_every``-th short-circuited call lets one
    probe through), so drills replay exactly; no clock is read.

    States:
      * ``closed``: every call attempts the real operation; failures count
        consecutively and propagate to the caller.
      * ``open``: entered after ``failures`` consecutive failures (or a
        failed probe): calls are short-circuited to the fallback.
      * ``half-open``: after ``probe_every`` short-circuited calls, one
        probe attempts the real operation: success closes the breaker,
        failure re-opens it.

    ``on_open`` (settable after construction) is called at every
    closed/half-open -> open transition (the flight-recorder trigger);
    exceptions it raises are swallowed.
    """

    def __init__(self, failures: int = 3, probe_every: int = 8,
                 on_open=None):
        if failures < 1 or probe_every < 1:
            raise ValueError(
                f"failures/probe_every must be >= 1, got "
                f"{failures}/{probe_every}"
            )
        self.failures = int(failures)
        self.probe_every = int(probe_every)
        self.on_open = on_open
        self.state = "closed"
        self._consecutive = 0
        self._since_probe = 0

    def allow(self) -> bool:
        """Should the caller attempt the real operation? Advances the
        open-state probe countdown (to ``half-open`` when a probe is due)."""
        if self.state == "closed" or self.state == "half-open":
            return True
        self._since_probe += 1
        if self._since_probe >= self.probe_every:
            self._since_probe = 0
            self.state = "half-open"
            return True
        return False

    def record_success(self) -> None:
        self._consecutive = 0
        if self.state != "closed":
            get_logger("resilience").info(
                "circuit breaker CLOSED (probe succeeded; outage over)"
            )
            self.state = "closed"

    def record_failure(self) -> None:
        self._consecutive += 1
        if self.state == "half-open" or (
            self.state == "closed" and self._consecutive >= self.failures
        ):
            get_logger("resilience").warning(
                "circuit breaker OPEN (%s) — serving fallback rows until "
                "a probe succeeds",
                "probe failed" if self.state == "half-open"
                else f"{self._consecutive} consecutive failures",
            )
            self.state = "open"
            self._since_probe = 0
            if self.on_open is not None:
                try:
                    self.on_open()
                except Exception:  # noqa: BLE001 — forensics must never
                    pass           # make the outage worse


class DegradedFeature:
    """Degraded-mode wrapper around a feature store's lookup.

    Wraps anything ids -> rows indexable that exposes ``shape`` ``(n,
    dim)`` and ``device`` (a :class:`~..feature.feature.Feature`, or a
    wrapper of one). Closed, lookups pass through and failures propagate;
    once ``failures`` consecutive lookups fail, the breaker opens and
    lookups serve ``fallback`` rows on the store's device instead of
    raising, each counted on the registry; half-open probes close the
    breaker when the store recovers.

    Args:
      feature: the wrapped store.
      failures: consecutive-failure threshold that opens the breaker.
      probe_every: short-circuited calls between half-open probes.
      fallback: ``"zeros"`` (constant rows) or ``"last-good"`` (each id's
        most recently fetched row from a bounded cache, zeros for ids never
        seen).
      cache_rows: row budget of the last-good cache (insertion stops at
        the budget; ``"zeros"`` keeps no cache).
      metrics: optional external :class:`MetricsRegistry` for the
        degraded counter (e.g. a server's); a private one otherwise.
      recorder: optional :class:`~..obs.recorder.FlightRecorder`: a
        breaker-open transition dumps a postmortem bundle naming the
        gather stage.
    """

    _FALLBACKS = ("zeros", "last-good")

    def __init__(self, feature, failures: int = 3, probe_every: int = 8,
                 fallback: str = "zeros", cache_rows: int = 65536,
                 metrics: MetricsRegistry | None = None, recorder=None):
        if fallback not in self._FALLBACKS:
            raise ValueError(
                f"fallback must be one of {self._FALLBACKS}, "
                f"got {fallback!r}"
            )
        self.feature = feature
        self.breaker = CircuitBreaker(failures, probe_every)
        if recorder is not None:
            self.breaker.on_open = lambda: recorder.trigger(
                "breaker_open", stage="gather", fallback=fallback,
            )
        self.fallback = fallback
        self.cache_rows = int(cache_rows)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.counter(
            DEGRADED_LOOKUPS, unit="lookups",
            doc="feature lookups served by the circuit breaker's fallback "
                "(zeros/last-good) instead of the real store",
        )
        self.degraded_total = 0
        self._row_dtype = None
        # the last-good cache: each id's slot on the host (-1: not held),
        # and on the lookup's device the slot table, whose row C takes the
        # writes of lanes that hold no slot and row C + 1 stays zero
        self._slot_of = self._table = None
        self._held = 0

    def _row_spec(self):
        """(dim, dtype) of a fallback row: from the last good rows when
        seen, else the store's (int8 storage dequantises to float32)."""
        dim = int(self.feature.shape[1])
        if self._row_dtype is not None:
            return dim, self._row_dtype
        if getattr(self.feature, "scale", None) is not None:
            return dim, torch.float32
        dtype = getattr(self.feature, "dtype", None)
        return dim, dtype if isinstance(dtype, torch.dtype) else torch.float32

    def _host_ids(self, ids) -> np.ndarray:
        """The lanes' ids on the host, int64: ``-1`` lanes stay ``-1`` and
        ids past the table read the last id."""
        ids = torch.as_tensor(ids).reshape(-1).cpu().numpy().astype(np.int64)
        return np.where(ids >= 0, np.minimum(ids, self._slot_of.shape[0] - 1), -1)

    def _slots(self, ids: np.ndarray) -> np.ndarray:
        """Each lane's slot, ``-1`` where its id is not held."""
        return np.where(ids >= 0, self._slot_of[ids], -1).astype(np.int64)

    def _remember(self, ids, rows) -> None:
        """Fold one good lookup into the last-good cache: held ids take
        their new rows; new ids take the next slots in the order of their
        first lanes until ``cache_rows`` are held."""
        if self.fallback != "last-good" or self.cache_rows < 1:
            return
        C = self.cache_rows
        if self._table is None:
            self._slot_of = np.full(int(self.feature.shape[0]), -1, np.int32)
            self._table = torch.zeros((C + 2, rows.shape[1]), dtype=rows.dtype,
                                      device=rows.device)
        ids = self._host_ids(ids)
        new = ids[(ids >= 0) & (self._slot_of[ids] < 0)]
        if new.size and self._held < C:
            uniq, first = np.unique(new, return_index=True)
            admit = uniq[np.argsort(first)][:C - self._held]
            self._slot_of[admit] = np.arange(self._held, self._held + admit.size)
            self._held += admit.size
        slots = self._slots(ids)
        dst = torch.from_numpy(np.where(slots >= 0, slots, C))
        self._table.index_copy_(0, dst.to(rows.device), rows)

    def _serve_fallback(self, ids):
        dim, dtype = self._row_spec()
        dev = self.feature.device
        if self.fallback == "last-good" and self._table is not None:
            slots = self._slots(self._host_ids(ids))
            at = torch.from_numpy(np.where(slots >= 0, slots, self.cache_rows + 1))
            out = self._table[at.to(dev)]
        else:
            n = torch.as_tensor(ids).reshape(-1).shape[0]
            out = torch.zeros((n, dim), dtype=dtype, device=dev)
        self.degraded_total += 1
        self.metrics.set(DEGRADED_LOOKUPS, np.int32(self.degraded_total))
        return out

    def __getitem__(self, ids):
        if self.breaker.allow():
            try:
                rows = self.feature[ids]
            except Exception:  # noqa: BLE001 — the breaker decides whether
                self.breaker.record_failure()  # this failure surfaces
                if self.breaker.state == "open":
                    return self._serve_fallback(ids)
                raise
            self.breaker.record_success()
            self._row_dtype = rows.dtype
            self._remember(ids, rows)
            return rows
        return self._serve_fallback(ids)

    def __getattr__(self, name):
        return getattr(self.feature, name)
