"""Deadline-aware request coalescing for the online serving path.

A copy of ``quiver_tpu/serving/coalesce.py`` (host-only Python).

Single-node point queries arrive one at a time; the micro-batch step
(``serving/ladder.py``) wants power-of-two batches. The
:class:`DeadlineBatcher` bridges the two: it admits requests into a
bounded FIFO and releases them as a batch when either (a) enough requests
are pending to fill the largest ladder bucket, or (b) the *oldest*
pending request has spent its configured fraction of its deadline budget
waiting — the classic latency/throughput coalescing knob, here fully
deterministic under an injectable clock so the packing decision sequence
is a pure function of the arrival sequence (tests replay it bitwise).

Backpressure is a bounded queue: ``submit`` raises
:class:`ServeQueueFull` instead of growing without limit — an overloaded
server sheds load at admission, where the caller can still retry or
route elsewhere, not at completion where the work is already sunk.

Admission control is SLO-class aware (:data:`PRIORITIES`): every request
carries a priority class (``gold`` ahead of ``bronze``), each class can
have its own default deadline, and the shed policy under a full queue
drops bronze before gold — a gold arrival at the bound evicts the
newest pending bronze request (marked ``shed``, least sunk queue-wait)
instead of being rejected; only when no lower class is pending does
admission raise. Released batches pack gold first, so under mixed load
the scarce bucket lanes go to the tight-deadline class.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = ["DeadlineBatcher", "PRIORITIES", "ServeQueueFull", "ServeRequest"]

#: SLO priority classes, best first — index order is the order of the
#: per-class counters in ``InferenceServer.stats()``.
PRIORITIES = ("gold", "bronze")
_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class ServeQueueFull(RuntimeError):
    """Admission rejected: the serving queue is at its bound. The caller
    owns the retry/shed decision — an unbounded queue would convert
    overload into unbounded latency for every later request instead."""


@dataclasses.dataclass
class ServeRequest:
    """One admitted point query and (after completion) its outcome.

    ``seq`` is the admission sequence number — the request's draws come
    from generators seeded by ``(server seed, seq, layer)``, so a request's
    sampled neighborhood is a function of (node, seq) alone, independent
    of which bucket it lands in and of its co-batched neighbors. That
    independence is what makes ladder-served responses bitwise equal to
    the direct single-query oracle.
    """

    node: int
    seq: int
    t_admit: float
    deadline_s: float
    priority: str = "gold"
    result: np.ndarray | None = None
    overflow: int = 0
    t_done: float | None = None
    missed: bool | None = None
    shed: bool = False
    trace_id: str = ""

    @property
    def deadline_at(self) -> float:
        return self.t_admit + self.deadline_s

    @property
    def done(self) -> bool:
        """Completed OR shed — either way the caller stops waiting (a
        shed request has ``shed=True`` and ``result is None``)."""
        return self.t_done is not None

    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_admit


def ladder_buckets(max_batch: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder up to ``max_batch``: (1, 2, 4, ...).

    ``max_batch`` must itself be a power of two — a non-power-of-two top
    bucket would make the padded tail of full batches permanent.
    """
    m = int(max_batch)
    if m < 1 or (m & (m - 1)) != 0:
        raise ValueError(f"max_batch must be a power of two >= 1, got {max_batch}")
    out, b = [], 1
    while b <= m:
        out.append(b)
        b *= 2
    return tuple(out)


class DeadlineBatcher:
    """Bounded FIFO that packs point queries into ladder buckets.

    Args:
      buckets: ascending batch-size ladder (see :func:`ladder_buckets`);
        the last entry is the largest batch a flush releases.
      default_deadline_s: per-request deadline when ``submit`` gives none.
      budget_fraction: fraction of a request's deadline it may spend
        *queued* before its presence forces a flush (the rest of the
        budget is reserved for sample/gather/forward/readback).
      max_queue: admission bound; ``submit`` past it sheds (bronze
        before gold) or raises :class:`ServeQueueFull`.
      clock: injectable monotonic clock — tests drive a fake clock and
        the flush sequence becomes deterministic in the arrival sequence.
      class_deadlines: optional per-priority-class default deadlines,
        e.g. ``{"gold": 0.02, "bronze": 0.1}`` — consulted when
        ``submit`` gives no explicit deadline, before the global
        ``default_deadline_s``.
    """

    def __init__(self, buckets=(1, 2, 4, 8), default_deadline_s: float = 0.05,
                 budget_fraction: float = 0.5, max_queue: int = 256,
                 clock=time.monotonic, class_deadlines: dict | None = None):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending and unique, got {buckets}")
        if any(b < 1 or (b & (b - 1)) != 0 for b in buckets):
            raise ValueError(f"buckets must be powers of two, got {buckets}")
        if not 0.0 < budget_fraction <= 1.0:
            raise ValueError(
                f"budget_fraction must be in (0, 1], got {budget_fraction}"
            )
        if max_queue < buckets[-1]:
            raise ValueError(
                f"max_queue ({max_queue}) must hold at least one full "
                f"top bucket ({buckets[-1]})"
            )
        class_deadlines = dict(class_deadlines or {})
        for p, d in class_deadlines.items():
            if p not in PRIORITIES:
                raise ValueError(
                    f"class_deadlines keys must be in {PRIORITIES}, got {p!r}"
                )
            if float(d) <= 0:
                raise ValueError(
                    f"class_deadlines[{p!r}] must be > 0, got {d}"
                )
        self.buckets = buckets
        self.default_deadline_s = float(default_deadline_s)
        self.budget_fraction = float(budget_fraction)
        self.max_queue = int(max_queue)
        self.clock = clock
        self.class_deadlines = {p: float(d) for p, d in class_deadlines.items()}
        self.shed_by_class = dict.fromkeys(PRIORITIES, 0)
        self._pending: list[ServeRequest] = []
        self._seq = 0
        self._lock = threading.Lock()

    # -- admission -----------------------------------------------------------

    def submit(self, node: int, deadline_s: float | None = None,
               priority: str = "gold") -> ServeRequest:
        """Admit one point query; returns the request handle the caller
        polls for results. At the bound the shed policy runs: a request
        evicts the NEWEST pending request of a strictly lower priority
        class (bronze drops before any gold — the victim is marked
        ``shed`` with no result, and chosen newest-first so the least
        sunk queue-wait is discarded); with nothing lower-class pending,
        admission raises :class:`ServeQueueFull`."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be in {PRIORITIES}, got {priority!r}"
            )
        if deadline_s is not None:
            deadline = float(deadline_s)
        else:
            deadline = self.class_deadlines.get(
                priority, self.default_deadline_s
            )
        if deadline <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline}")
        now = self.clock()
        with self._lock:
            if len(self._pending) >= self.max_queue:
                victim = self._shed_victim_locked(_RANK[priority])
                if victim is None:
                    self.shed_by_class[priority] += 1
                    raise ServeQueueFull(
                        f"serving queue at bound ({self.max_queue}) with "
                        f"nothing below class {priority!r} to shed; retry "
                        f"after a drain or route elsewhere"
                    )
                victim.shed = True
                victim.t_done = now
                self.shed_by_class[victim.priority] += 1
                self._pending.remove(victim)
            req = ServeRequest(int(node), self._seq, now, deadline,
                               priority=priority)
            self._seq += 1
            self._pending.append(req)
        return req

    def _shed_victim_locked(self, rank: int) -> ServeRequest | None:
        """The newest pending request of a class strictly below ``rank``
        (None when every pending request is at or above it)."""
        for r in reversed(self._pending):
            if _RANK[r.priority] > rank:
                return r
        return None

    # -- flush decision ------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def ready(self) -> bool:
        """True when a flush is due: the top bucket would be full, or
        some pending request has burned its queue-wait fraction of its
        deadline (with per-class deadlines a later-admitted gold request
        can come due before the oldest bronze — the check is a min over
        pending, which reduces to the oldest when deadlines are
        uniform)."""
        now = self.clock()
        with self._lock:
            return self._ready_locked(now)

    def _ready_locked(self, now: float) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.buckets[-1]:
            return True
        due = min(r.t_admit + self.budget_fraction * r.deadline_s
                  for r in self._pending)
        return now >= due

    def bucket_for(self, count: int) -> int:
        """Smallest ladder bucket holding ``count`` requests."""
        for b in self.buckets:
            if count <= b:
                return b
        return self.buckets[-1]

    def pop(self, force: bool = False) -> tuple[list[ServeRequest], int] | None:
        """Release the next batch: up to one top bucket of requests plus
        the smallest bucket that holds them, packed gold-first then by
        admission order (pure FIFO when a single class is in play).
        ``None`` when nothing is due (``force`` flushes whatever is
        pending — the closed-loop drain path). Deterministic: the
        decision uses only the injectable clock and the admission
        order."""
        now = self.clock()
        with self._lock:
            if not self._pending:
                return None
            if not force and not self._ready_locked(now):
                return None
            take = min(len(self._pending), self.buckets[-1])
            batch = sorted(
                self._pending, key=lambda r: (_RANK[r.priority], r.seq)
            )[:take]
            chosen = {id(r) for r in batch}
            self._pending = [r for r in self._pending if id(r) not in chosen]
        return batch, self.bucket_for(take)
