"""The traced window: ``torch.profiler`` over every thread, reduced to what
the per-layer readers need.

A loop marks its own spans with ``record_function``: ``bench.window``
(``TracedWindow``) around the whole window on the main thread, and one
span per call into a layer, named ``bench.<layer>`` or, where a reader
pairs a call with what the loop kept of it, ``bench.<layer>#<call>``
(the ``infer`` loop marks each pass ``bench.pass#<n>``). The trace mirrors
each span on every stream that ran work it launched; a device operation
(kernel, copy, set) is charged to the mirrored span that holds its start
on its stream. A stream runs its work in order, so work that a library
launches from a thread of its own still falls in the span on that span's
stream.

Busy time is the union of the device intervals over every stream, so
operations that overlap on two streams count once (``device_union_ms``
and ``profiled_idle`` of ``chip_smoke.py``, whose rule this copies).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import NamedTuple

import torch

__all__ = ["SPAN_PREFIX", "Trace", "TracedWindow", "reduce_events"]

SPAN_PREFIX = "bench."
WINDOW = "bench.window"


class Trace(NamedTuple):
    window_s: float  # the traced window, by its span on the host
    busy_s: float  # union of device intervals inside it
    calls: dict  # span name -> {call tag (the "#n", else one per mirror): device seconds}
    device_ops: list  # [[name, seconds]] the ten that took most time
    idle_gaps: list  # [[span the main thread was in, seconds]] the ten longest
    device_events: int
    attributed_s: float  # device seconds charged to a span, of summed_s
    summed_s: float

    def idle_share(self) -> float | None:
        """Percent of the window in which no operation ran on the card, on
        any stream; None when nothing ran."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> Trace | None:
    """Reduce the profiler's raw events (``kineto_results.events()``) of
    one traced window. None when the window's span is missing."""
    cpu = torch.autograd.DeviceType.CPU
    host_spans = collections.defaultdict(list)  # thread -> [(start, end, name)]
    dev_spans = collections.defaultdict(list)  # stream -> [(start, end, name)]
    device = []
    window = None
    for e in events:
        name = e.name()
        bench = name.startswith(SPAN_PREFIX)
        if e.device_type() == cpu:
            if bench:
                item = (e.start_ns(), e.end_ns(), name)
                if name == WINDOW:
                    window = (item[0], item[1], e.start_thread_id())
                else:
                    host_spans[e.start_thread_id()].append(item)
        elif bench:
            if name != WINDOW:
                dev_spans[e.device_resource_id()].append((e.start_ns(), e.end_ns(), name))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name, e.device_resource_id()))
    if window is None:
        return None
    w0, w1, main = window

    def finder(lists):
        for lst in lists.values():
            lst.sort()
        starts = {k: [a for a, _, _ in lst] for k, lst in lists.items()}

        def at(key, t):
            lst = lists.get(key)
            if not lst:
                return None
            i = bisect.bisect_right(starts[key], t) - 1
            return i if i >= 0 and lst[i][0] <= t <= lst[i][1] else None
        return at

    host_at, dev_at = finder(host_spans), finder(dev_spans)
    charged = collections.defaultdict(float)  # (stream, index) -> seconds
    by_op = collections.Counter()
    inside = []
    attributed = 0.0
    for a, b, name, stream in device:
        if b < w0 or a > w1:
            continue
        inside.append((max(a, w0), min(b, w1)))
        secs = (b - a) / 1e9
        by_op[name[:120]] += secs
        i = dev_at(stream, a)
        if i is not None:
            charged[(stream, i)] += secs
            attributed += secs
    # a host span may run on several streams: its calls sum over them
    calls = collections.defaultdict(lambda: collections.defaultdict(float))
    for stream, lst in dev_spans.items():
        for i, (a, b, name) in enumerate(lst):
            if a >= w0 and b <= w1:
                base, _, tag = name.partition("#")
                calls[base][int(tag) if tag else (stream, a)] += charged.get((stream, i), 0.0)
    calls = {k: {t: v for t, v in d.items()} for k, d in calls.items()}
    busy = _union(inside)
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            i = host_at(main, (a + edge) / 2)
            label = host_spans[main][i][2].partition("#")[0] if i is not None else "host"
            gaps.append((label, (a - edge) / 1e9))
        edge = max(edge, b)
    gaps.sort(key=lambda g: -g[1])
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        calls=calls,
        device_ops=[[k, v] for k, v in by_op.most_common(10)],
        idle_gaps=[[k, v] for k, v in gaps[:10]],
        device_events=len(inside),
        attributed_s=attributed,
        summed_s=sum(by_op.values()),
    )


class TracedWindow:
    """``with TracedWindow(on) as tw:`` profiles the window when ``on``
    (every thread, the host and the card) and marks it with the window's
    span; ``tw.trace`` is the reduction afterwards (None when off or when
    the profiler saw no window). ``tw.reduce_s`` is the host time the
    reduction took."""

    def __init__(self, on: bool, cuda: bool):
        self.on = on
        self.cuda = cuda
        self.trace = None
        self.reduce_s = 0.0
        self._prof = self._span = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
            self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self._prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            if exc[0] is None:
                t0 = time.perf_counter()
                self.trace = reduce_events(self._prof.profiler.kineto_results.events())
                self.reduce_s = time.perf_counter() - t0
            self._prof = None
        return False
