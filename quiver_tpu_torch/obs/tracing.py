"""Causal span tracing across serving (and, later, training).

The port of ``quiver_tpu/obs/tracing.py``. Counters and P² stage
quantiles say how slow a stage is on average; :class:`Tracer` says what
happened to ONE request and why it was slow. It is pure host-side
bookkeeping: the server opens one trace per admitted request and records
its six batch stages (``queue_wait``, ``pad``, ``sample``, ``gather``,
``forward``, ``readback``) as child spans of that trace.

Spans are wall-clock observations taken around the work, never inside
it: a disabled tracer does no work beyond one attribute check and returns
a shared no-op span, and enabling it changes no input of any kernel or
model call, so responses are bitwise identical either way.

A live span (inside its ``with`` block) is its thread's current span.
Functions that hold no tracer open theirs with :func:`span`: a child of
the thread's current span, in that span's tracer, or else a root in the
process-wide :func:`default_tracer`. With no span live, :func:`span`
records only while the trace switch is on (``QUIVER_ENABLE_TRACE`` /
``enable_trace``) or a ``torch.profiler`` records in the process.

While a profiler records, every live span is also a range of its name on
the profiler's host timeline, so it lines up with the card's work there.
The range is recorded as an operator and not as a user annotation: the
profiler mirrors only the innermost user annotation on the device's
streams, so a span of the program's there would take the mirror from an
enclosing ``record_function`` of the caller's (a benchmark's span around
the call) and leave its device work charged to nothing. A span given a
CUDA ``device`` records a timing event pair on that device's current
stream at entry and exit; its ``device_ms`` is read from them lazily,
once the end event has completed, and no span ever synchronises.

Export is Chrome trace-event JSON (:func:`to_chrome_trace`), loadable in
Perfetto / ``chrome://tracing``: every span becomes a complete
``"ph": "X"`` event carrying its trace/span/parent ids in ``args``.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..utils.trace import trace_enabled
from .registry import TRACE_SPANS, MetricsRegistry

__all__ = ["Span", "Tracer", "default_tracer", "span",
           "to_chrome_trace", "write_chrome_trace"]


class Span:
    """One finished unit of attributed work.

    Fields: ``name`` (dotted stage name), ``trace_id`` (the causal chain
    this span belongs to), ``span_id`` / ``parent_id`` (tracer-unique;
    parent ``""`` = a root span), ``t0`` / ``dur`` (seconds on the
    tracer's monotonic clock; ``t0`` is relative to the tracer's epoch so
    exports start near zero), ``tid`` (small stable per-thread id), and
    free-form ``attrs`` (``subsystem`` is the conventional grouping key:
    serve / fleet / trainer / prefetch / stager / resilience / control).
    :attr:`device_ms` is the span's time on its card's stream, when it
    was opened with a CUDA ``device``.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "dur",
                 "tid", "attrs", "_events", "_device_ms")

    def __init__(self, name, trace_id, span_id, parent_id, t0, dur, tid,
                 attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.attrs = attrs
        self._events = None
        self._device_ms = None

    @property
    def device_ms(self) -> float | None:
        """Milliseconds on the span's stream from its first enqueued work
        to its last (the timing events recorded at entry and exit). None
        for a span with no CUDA device, and while the end event is still
        pending: reading it never waits for the card."""
        events = self._events
        if events is not None and events[1].query():
            self._device_ms = events[0].elapsed_time(events[1])
            self._events = None
        return self._device_ms

    def set(self, key: str, value) -> None:
        """Attach/overwrite one attribute (live spans: inside the
        ``with tracer.span(...)`` block; the no-op span accepts and
        drops it)."""
        self.attrs[key] = value

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t0_s": self.t0,
            "dur_s": self.dur,
            "tid": self.tid,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id!r}, "
                f"dur={self.dur * 1e3:.3f}ms)")


class _NullSpan:
    """The shared no-op span a disabled tracer hands out: accepts the
    full :class:`Span` surface, allocates nothing, records nothing."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = ""
    t0 = 0.0
    dur = 0.0
    tid = 0
    attrs: dict = {}
    device_ms = None

    def set(self, key, value) -> None:
        pass

    def as_dict(self) -> dict:
        return {}


_NULL_SPAN = _NullSpan()


class _NullScope:
    """Reusable disabled-path context manager — ``tracer.span(...)`` with
    ``enabled=False`` returns this singleton: zero allocation, zero
    clock reads."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


_LIVE = threading.local()  # .stack: the thread's live (tracer, span) pairs


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process: the autograd
    profiler's process-wide flag (a profile of every thread sets only
    this one), or this thread's profiler state."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


def _live_stack() -> list:
    stack = getattr(_LIVE, "stack", None)
    if stack is None:
        stack = _LIVE.stack = []
    return stack


class _SpanScope:
    """Live-path context manager: clocks the block and records one span
    on exit (even when the block raises — a failing stage still lands on
    the timeline, tagged by the caller if it wants to). While the block
    runs the span is its thread's current span; under a recording
    profiler it is also an operator range of its name on the host's
    timeline, and with a CUDA ``device`` it records a timing event at
    entry and at exit."""

    __slots__ = ("_tracer", "_span", "_t0", "_device", "_range", "_start")

    def __init__(self, tracer: "Tracer", span: Span, device=None):
        self._tracer = tracer
        self._span = span
        self._device = device

    def __enter__(self) -> Span:
        s = self._span
        self._range = self._start = None
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(s.name)
            self._range.__enter__()
        if self._device is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        _live_stack().append((self._tracer, s))
        self._t0 = time.perf_counter()
        return s

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        s = self._span
        _live_stack().pop()
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            s._events = (self._start, end)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        s.t0 = self._t0 - self._tracer._epoch
        s.dur = t1 - self._t0
        if exc_type is not None:
            s.attrs["error"] = exc_type.__name__
        self._tracer._record(s)
        return False


class Tracer:
    """Issues :class:`Span` s and keeps the last ``max_spans`` of them.

    Args:
      enabled: the zero-overhead switch — ``False`` makes every call a
        cheap no-op returning shared null objects (bitwise-identical
        results are structural, not best-effort).
      max_spans: bounded ring of finished spans (oldest evicted).
      metrics: optional :class:`MetricsRegistry` to land the lifetime
        ``trace.spans`` counter on.

    Ids are deterministic per tracer: trace ids count up (``t1``,
    ``t2``, ...) unless the caller supplies an explicit one
    (:meth:`trace` with a name, e.g. ``train.epoch.<n>``, so a resumed
    run stitches); span ids count up (``s1``, ``s2``, ...). All methods
    are thread-safe.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 4096,
                 metrics: MetricsRegistry | None = None):
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.metrics = metrics
        if metrics is not None:
            metrics.counter(
                TRACE_SPANS, unit="spans",
                doc="finished trace spans recorded by the grafttrace "
                    "tracer (lifetime total; bounded ring keeps the "
                    "last max_spans of them)",
            )
        self._epoch = time.perf_counter()
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._next_trace = 0
        self._next_span = 0
        self._tids: dict[int, int] = {}
        self.spans_total = 0

    # -- ids -----------------------------------------------------------------

    def trace(self, name: str | None = None) -> str:
        """A trace id: the explicit ``name`` when given (deterministic
        stitching — e.g. ``train.epoch.3`` survives a restart), else the
        next counter id. ``""`` when disabled."""
        if not self.enabled:
            return ""
        if name is not None:
            return str(name)
        with self._lock:
            self._next_trace += 1
            return f"t{self._next_trace}"

    def _span_id(self) -> str:
        self._next_span += 1
        return f"s{self._next_span}"

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids) + 1
        return tid

    # -- recording -----------------------------------------------------------

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.max_spans:
                del self._spans[: len(self._spans) - self.max_spans]
            self.spans_total += 1
            total = self.spans_total
        if self.metrics is not None:
            self.metrics.set(TRACE_SPANS, np.int32(total))

    def _make(self, name, trace, parent, subsystem, attrs) -> Span:
        a = dict(attrs) if attrs else {}
        if subsystem is not None:
            a["subsystem"] = subsystem
        parent_id = parent.span_id if isinstance(parent, Span) else (
            parent or ""
        )
        with self._lock:
            sid = self._span_id()
            tid = self._tid()
        return Span(str(name), trace or "", sid, parent_id, 0.0, 0.0,
                    tid, a)

    def span(self, name: str, trace: str | None = None, parent=None,
             subsystem: str | None = None, device=None, **attrs):
        """Context manager timing one unit of work; yields the live
        :class:`Span` (callers may ``.set()`` attrs inside the block).
        ``parent`` is a parent :class:`Span` or span-id string; ids are
        what the caller gives, whatever span is live (:func:`span` takes
        them from the thread). With a CUDA ``device`` the span also times
        its stream (:attr:`Span.device_ms`)."""
        if not self.enabled:
            return _NULL_SCOPE
        if device is not None and torch.device(device).type != "cuda":
            device = None
        return _SpanScope(self, self._make(name, trace, parent,
                                           subsystem, attrs), device)

    def record(self, name: str, t0: float, dur: float,
               trace: str | None = None, parent=None,
               subsystem: str | None = None, **attrs) -> Span | None:
        """Record an already-measured span: ``t0`` on the tracer's
        relative clock (see :meth:`now`), ``dur`` in seconds. Returns the
        span (None when disabled) so callers can parent children on it."""
        if not self.enabled:
            return None
        s = self._make(name, trace, parent, subsystem, attrs)
        s.t0 = float(t0)
        s.dur = float(dur)
        self._record(s)
        return s

    def observe(self, name: str, seconds: float, trace: str | None = None,
                parent=None, subsystem: str | None = None,
                **attrs) -> Span | None:
        """Record a span of duration ``seconds`` ending NOW — for work
        whose start the caller measured on another clock (queue waits,
        externally-timed stages)."""
        if not self.enabled:
            return None
        dur = max(float(seconds), 0.0)
        return self.record(name, self.now() - dur, dur, trace=trace,
                           parent=parent, subsystem=subsystem, **attrs)

    def event(self, name: str, trace: str | None = None, parent=None,
              subsystem: str | None = None, **attrs) -> Span | None:
        """A zero-duration marker span (enqueue, failover, decision)."""
        if not self.enabled:
            return None
        return self.record(name, self.now(), 0.0, trace=trace,
                           parent=parent, subsystem=subsystem, **attrs)

    def now(self) -> float:
        """Seconds on the tracer's relative monotonic clock (0 at
        construction) — the ``t0`` base for :meth:`record`."""
        return time.perf_counter() - self._epoch

    # -- inspection / export -------------------------------------------------

    def spans(self) -> list[Span]:
        """Snapshot of the retained spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def traces(self, name: str) -> list[list[Span]]:
        """The retained spans of each trace holding a span ``name``,
        oldest first per trace, traces in the order their ``name`` spans
        finished."""
        spans = self.spans()
        by_trace: dict[str, list[Span]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        return [by_trace[s.trace_id] for s in spans if s.name == name]

    def subsystems(self) -> set[str]:
        """Distinct ``subsystem`` attrs across retained spans."""
        return {s.attrs["subsystem"] for s in self.spans()
                if "subsystem" in s.attrs}

    def to_chrome(self) -> dict:
        return to_chrome_trace(self.spans())

    def write_chrome(self, path) -> int:
        return write_chrome_trace(self.spans(), path)


# -- the program's own spans -------------------------------------------------

_DEFAULT: list = []
_DEFAULT_LOCK = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer that :func:`span` records into when no live
    span encloses it (made on first use)."""
    if not _DEFAULT:
        with _DEFAULT_LOCK:
            if not _DEFAULT:
                _DEFAULT.append(Tracer())
    return _DEFAULT[0]


def span(name: str, new_trace: bool = False, device=None, **attrs):
    """A span for a function that holds no tracer: a child of this
    thread's current span, in that span's tracer (and, unless
    ``new_trace``, in its trace); else a root of a new trace in
    :func:`default_tracer`, recorded only while the trace switch is on or
    a ``torch.profiler`` records, and otherwise the shared no-op scope.
    ``device`` and ``attrs`` as :meth:`Tracer.span`."""
    stack = _live_stack()
    if stack:
        tracer, parent = stack[-1]
        trace = tracer.trace() if new_trace else parent.trace_id
        return tracer.span(name, trace, parent, device=device, **attrs)
    if not (trace_enabled() or _profiling()):
        return _NULL_SCOPE
    tracer = default_tracer()
    return tracer.span(name, tracer.trace(), device=device, **attrs)


# -- Chrome trace-event / Perfetto export -------------------------------------

def to_chrome_trace(spans) -> dict:
    """Chrome trace-event JSON for ``spans`` — one complete (``"X"``)
    event per span, timestamps/durations in microseconds, trace/span/
    parent ids and attrs in ``args``. Loads directly in Perfetto and
    ``chrome://tracing``."""
    events = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": s.attrs.get("subsystem", "quiver"),
            "ph": "X",
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(s.dur * 1e6, 3),
            "pid": 1,
            "tid": s.tid,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                **{k: _jsonable(v) for k, v in s.attrs.items()},
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def write_chrome_trace(spans, path) -> int:
    """Write the Chrome trace-event JSON for ``spans`` to ``path``;
    returns the event count."""
    doc = to_chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])
