"""Metrics registry: named counters and gauges with one audited path.

The port of ``quiver_tpu/obs/registry.py``. Code that produces a metric
*registers* a named counter or gauge once (host side, before the work
runs) and *feeds* it through a :class:`MetricsTape` while the work runs;
``tape.finalize()`` returns one ``{name: value}`` dict, which the caller
hands to :meth:`MetricsRegistry.record`. Every producer and consumer
spells a metric through the module constants below, so none drifts.

A tape keeps what it is fed as tensors on their device and adds them
there, so :meth:`MetricsTape.add` never waits for the device;
:meth:`MetricsTape.finalize` reads every value back in one copy per dtype.
``psum=`` names the axes a metric would be summed over across cards; it is
validated as in the JAX package, and on a world of one card the sum is the
identity (the multi-card layer, ROADMAP A.11, gives it
``torch.distributed``).

A disabled registry is a no-op: its tapes feed nothing and finalize to
``{}``, and ``record`` drops everything.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "MetricSpec",
    "MetricSnapshot",
    "MetricsRegistry",
    "MetricsTape",
    "ROUTED_OVERFLOW",
    "TIER_HITS",
    "SAMPLE_OVERFLOW",
    "HETERO_SAMPLE_OVERFLOW",
    "GUARD_SKIPPED",
    "GUARD_NONFINITE",
    "PREFETCH_RETRIES",
    "PREFETCH_SKIPS",
    "PREFETCH_QUEUE_DEPTH",
    "DEGRADED_LOOKUPS",
    "DELTAS_QUARANTINED",
    "DELTAS_COMMITTED",
    "STREAMING_COMMITS",
    "SERVE_REQUESTS",
    "SERVE_DEADLINE_MISSES",
    "SERVE_DEGRADED_LOOKUPS",
    "SERVE_RECOMPILES",
    "SERVE_AOT_LOADS",
    "SERVE_SHED",
    "SERVE_CLASS_MISSES",
    "TRAIN_OVERLAP_EFFICIENCY",
    "PIPELINE_REISSUES",
    "FEATURE_ROW_HEAT",
    "CTRL_DECISIONS",
    "CTRL_REPINS",
    "CTRL_SPLIT_MOVES",
    "CTRL_ALPHA_CHANGES",
    "CTRL_OOC_PROMOTIONS",
    "OOC_STAGE_WAIT",
    "OOC_PAGE_READS",
    "OOC_READAHEAD_HITS",
    "TRACE_SPANS",
    "RECORDER_BUNDLES",
    "RECORDER_EVENTS",
]

# well-known metric names, the JAX package's spellings (producers and
# consumers import these, so none drifts)
ROUTED_OVERFLOW = "feature.routed_overflow"
TIER_HITS = "feature.tier_hits"
SAMPLE_OVERFLOW = "sample.hop_overflow"
# per-(hop, edge-type) routed-overflow lanes of the distributed hetero
# sampler
HETERO_SAMPLE_OVERFLOW = "sample.hetero_hop_overflow"
# steps skipped by the non-finite guard, and the count of non-finite
# loss/grad values it detected
GUARD_SKIPPED = "resilience.skipped_steps"
GUARD_NONFINITE = "resilience.nonfinite_grads"
# prefetcher batch re-dispatches and dropped batches, and feature lookups
# served degraded by the circuit breaker's fallback
PREFETCH_RETRIES = "prefetch.retries"
PREFETCH_SKIPS = "prefetch.skipped_batches"
# in-flight prefetch dispatches at the most recent queue transition
PREFETCH_QUEUE_DEPTH = "prefetch.queue_depth"
DEGRADED_LOOKUPS = "resilience.degraded_lookups"
# out-of-core disk tier: seconds a gather waited on window reads, window
# reads issued, and requested rows served from an already-staged window
OOC_STAGE_WAIT = "ooc.stage_wait"
OOC_PAGE_READS = "ooc.page_reads"
OOC_READAHEAD_HITS = "ooc.readahead_hits"
# streaming mutation: delta batches rejected, merged, and published commits
DELTAS_QUARANTINED = "streaming.deltas_quarantined"
DELTAS_COMMITTED = "streaming.deltas_committed"
STREAMING_COMMITS = "streaming.commits"
# online serving: completed point queries, requests finished after their
# deadline, serve-batch lookups satisfied through the breaker's fallback,
# and ladder-program compilations
SERVE_REQUESTS = "serve.requests"
SERVE_DEADLINE_MISSES = "serve.deadline_misses"
SERVE_DEGRADED_LOOKUPS = "serve.degraded_lookups"
SERVE_RECOMPILES = "serve.recompiles"
# ladder programs loaded from a persisted cache instead of compiled, and
# the per-SLO-class admission outcomes (serving.coalesce.PRIORITIES order)
SERVE_AOT_LOADS = "serve.aot_loads"
SERVE_SHED = "serve.shed_requests"
SERVE_CLASS_MISSES = "serve.class_deadline_misses"
# pipelined training: overlap efficiency and re-issued prologue batches
TRAIN_OVERLAP_EFFICIENCY = "train.overlap_efficiency"
PIPELINE_REISSUES = "train.pipeline_reissues"
# control plane: per-row access heat and the decision counters
FEATURE_ROW_HEAT = "feature.row_heat"
CTRL_DECISIONS = "ctrl.decisions"
CTRL_REPINS = "ctrl.repins"
CTRL_SPLIT_MOVES = "ctrl.split_moves"
CTRL_ALPHA_CHANGES = "ctrl.alpha_changes"
CTRL_OOC_PROMOTIONS = "ctrl.ooc_promotions"
# tracing and the flight recorder: finished spans, published postmortem
# bundles, and events noted into the recorder's ring
TRACE_SPANS = "trace.spans"
RECORDER_BUNDLES = "recorder.bundles"
RECORDER_EVENTS = "recorder.events"

_KINDS = ("counter", "gauge")


def to_numpy(value) -> np.ndarray:
    """A host numpy array of a metric value (a tensor on any device, a
    numpy array or a Python number)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Declaration of one named metric.

    ``shape`` is the per-step shape (``()`` for scalars); a value stacked
    over steps lands as ``(steps,) + shape``. ``counter`` values accumulate
    within a step (tape ``add``); ``gauge`` values overwrite (tape ``set``).
    """

    name: str
    kind: str
    shape: tuple[int, ...] = ()
    dtype: Any = torch.int32
    doc: str = ""
    unit: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")


@dataclasses.dataclass
class MetricSnapshot:
    """One recorded metric value (a step's, or a stack of steps).

    ``value`` may be a device tensor; :attr:`numpy` reads it back on
    access, so recording never waits for the device. ``steps`` is None for
    a single step and the stack's length otherwise.
    """

    name: str
    kind: str
    value: Any
    steps: int | None = None
    unit: str = ""
    doc: str = ""

    @property
    def numpy(self) -> np.ndarray:
        return to_numpy(self.value)

    @property
    def shape(self) -> tuple[int, ...]:
        """Full stored shape (includes the steps axis when present)."""
        return tuple(np.shape(self.numpy))

    def total(self):
        """Sum over every axis — the natural counter reduction."""
        return self.numpy.sum()

    def last(self) -> np.ndarray:
        """The most recent per-step value (the value itself when single)."""
        arr = self.numpy
        return arr[-1] if self.steps is not None else arr


def _psum_axes(psum) -> tuple:
    if isinstance(psum, str):
        return (psum,)
    axes = tuple(psum)
    if not axes or not all(isinstance(a, str) for a in axes):
        raise ValueError(f"psum must name one axis or a tuple of axes, got {psum!r}")
    return axes


class MetricsTape:
    """Collects one step's metrics dict.

    Create one per step via :meth:`MetricsRegistry.tape`; feed values with
    :meth:`add` (counters accumulate) / :meth:`set` (gauges overwrite).
    Tensors stay on their device and accumulate there; :meth:`finalize`
    reads everything back at once. On a disabled registry every method is
    a no-op and ``finalize`` returns ``{}``.
    """

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self._values: dict[str, Any] = {}
        self._psum: dict[str, tuple] = {}

    def _note_psum(self, name: str, psum) -> None:
        if psum is None:
            return
        axes = _psum_axes(psum)
        prev = self._psum.get(name)
        if prev is not None and prev != axes:
            raise ValueError(
                f"metric {name!r} fed with conflicting psum axes "
                f"{prev} vs {axes}"
            )
        self._psum[name] = axes

    def add(self, name: str, value, psum=None) -> None:
        """Accumulate ``value`` into counter ``name`` (on its device; no
        host sync)."""
        if not self._registry.enabled:
            return
        spec = self._registry.spec(name)
        if spec.kind != "counter":
            raise ValueError(f"metric {name!r} is a {spec.kind}; use set()")
        self._note_psum(name, psum)
        cur = self._values.get(name)
        self._values[name] = value if cur is None else cur + value

    def set(self, name: str, value, psum=None) -> None:
        """Overwrite gauge ``name`` with ``value``."""
        if not self._registry.enabled:
            return
        spec = self._registry.spec(name)
        if spec.kind != "gauge":
            raise ValueError(f"metric {name!r} is a {spec.kind}; use add()")
        self._note_psum(name, psum)
        self._values[name] = value

    def finalize(self, names=None) -> dict[str, np.ndarray]:
        """The step's metrics: every registered metric present (zero-filled
        from its spec when unfed), as host numpy arrays of the spec's
        dtype, read back in one copy per dtype. ``psum`` is the identity on
        one card.

        ``names`` restricts the dict to that subset of registered metrics
        (still zero-filled when unfed); feeding a metric and then
        finalizing without it raises instead of dropping the value."""
        if not self._registry.enabled:
            return {}
        if names is None:
            specs = self._registry.specs()
        else:
            specs = {name: self._registry.spec(name) for name in names}
            dropped = [n for n in self._values if n not in specs]
            if dropped:
                raise ValueError(
                    f"finalize(names=...) would drop fed metrics "
                    f"{sorted(dropped)}; include them in names or don't "
                    f"feed them on this tape"
                )
        # one device -> host copy per dtype: flatten and concatenate
        groups: dict[torch.dtype, list[tuple[str, torch.Tensor]]] = {}
        for name, spec in specs.items():
            v = self._values.get(name)
            if v is None:
                v = torch.zeros(spec.shape, dtype=spec.dtype)
            v = torch.as_tensor(v).to(spec.dtype)
            groups.setdefault(spec.dtype, []).append((name, v))
        out = {}
        for dtype, items in groups.items():
            dev = next((v.device for _n, v in items if v.device.type != "cpu"),
                       torch.device("cpu"))
            flat = torch.cat([v.to(dev).reshape(-1) for _n, v in items]).cpu().numpy()
            at = 0
            for name, v in items:
                n = v.numel()
                out[name] = flat[at:at + n].reshape(tuple(v.shape))
                at += n
        return {name: out[name] for name in specs}


class MetricsRegistry:
    """Named counters/gauges with per-step tapes and recorded snapshots.

    :meth:`counter`/:meth:`gauge` declare metrics (idempotent: re-declaring
    an identical spec is a no-op, a conflicting one raises); :meth:`record`
    lands a tape's dict as :class:`MetricSnapshot` objects; :meth:`value` /
    :meth:`snapshot` read them back. ``enabled=False`` makes the whole
    registry a no-op.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._specs: dict[str, MetricSpec] = {}
        self._snaps: dict[str, MetricSnapshot] = {}

    # -- declaration --------------------------------------------------------

    def _register(self, spec: MetricSpec) -> str:
        prev = self._specs.get(spec.name)
        if prev is not None:
            if prev != spec:
                raise ValueError(
                    f"metric {spec.name!r} already registered with a "
                    f"different spec ({prev} vs {spec})"
                )
            return spec.name
        self._specs[spec.name] = spec
        return spec.name

    def counter(self, name: str, shape=(), dtype=torch.int32, doc: str = "",
                unit: str = "") -> str:
        """Register (or re-assert) a counter; returns ``name``."""
        return self._register(
            MetricSpec(name, "counter", tuple(shape), dtype, doc, unit)
        )

    def gauge(self, name: str, shape=(), dtype=torch.int32, doc: str = "",
              unit: str = "") -> str:
        """Register (or re-assert) a gauge; returns ``name``."""
        return self._register(
            MetricSpec(name, "gauge", tuple(shape), dtype, doc, unit)
        )

    def spec(self, name: str) -> MetricSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"metric {name!r} is not registered (known: "
                f"{sorted(self._specs)})"
            ) from None

    def specs(self) -> dict[str, MetricSpec]:
        """Registered specs, insertion-ordered (read-only copy)."""
        return dict(self._specs)

    def names(self) -> list[str]:
        return list(self._specs)

    def tape(self) -> MetricsTape:
        return MetricsTape(self)

    # -- recorded values ----------------------------------------------------

    def _steps_of(self, spec: MetricSpec, value) -> int | None:
        shape = tuple(value.shape) if hasattr(value, "shape") else np.shape(value)
        if len(shape) == len(spec.shape):
            return None
        if len(shape) == len(spec.shape) + 1:
            return int(shape[0])  # a stack of steps
        raise ValueError(
            f"metric {spec.name!r}: value ndim {len(shape)} matches neither "
            f"the spec shape {spec.shape} nor a (steps,)-stack of it"
        )

    def record(self, values: dict[str, Any]) -> None:
        """Land a tape's metrics dict as snapshots."""
        if not self.enabled or not values:
            return
        for name, v in values.items():
            self.set(name, v)

    def set(self, name: str, value) -> None:
        """Host-side write of one metric (``None`` clears it)."""
        if value is None:
            self._snaps.pop(name, None)
            return
        spec = self.spec(name)
        self._snaps[name] = MetricSnapshot(
            name, spec.kind, value, self._steps_of(spec, value),
            spec.unit, spec.doc,
        )

    def value(self, name: str):
        """The raw recorded value (tensor or host array), or None."""
        snap = self._snaps.get(name)
        return None if snap is None else snap.value

    def snapshot(self, name: str) -> MetricSnapshot | None:
        return self._snaps.get(name)

    def snapshots(self) -> list[MetricSnapshot]:
        """Every recorded snapshot, registration-ordered."""
        return [self._snaps[n] for n in self._specs if n in self._snaps]

    def clear(self, name: str | None = None) -> None:
        if name is None:
            self._snaps.clear()
        else:
            self._snaps.pop(name, None)
