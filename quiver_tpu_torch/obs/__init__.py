"""Observability: metrics, step timeline, export, tracing, forensics.

The port of ``quiver_tpu/obs/``:

* :class:`MetricsRegistry` / :class:`MetricsTape`: named counters and
  gauges fed through a per-step tape and landed as typed
  :class:`MetricSnapshot` objects (``registry.py``);
* :class:`StepTimeline`: host-side per-stage wall clock with streaming
  p50/p95/p99 (``timeline.py``);
* JSONL and Prometheus-style exporters, both round-trippable and
  byte-equal to the JAX package's (``export.py``);
* :func:`profile_epoch`: ``torch.profiler`` bracketing with the same
  stage names on the card's timeline (``profile.py``);
* :class:`Tracer` / :class:`Span`: per-request causal spans, exported as
  Chrome trace-event JSON (``tracing.py``);
* :class:`FlightRecorder`: a bounded black-box ring dumping atomic,
  checksummed postmortem bundles on fault triggers (``recorder.py``);
* :class:`TelemetryEndpoint`: an opt-in stdlib HTTP thread serving
  ``/metrics``, ``/traces``, ``/healthz`` (``endpoint.py``).
"""

from .endpoint import TelemetryEndpoint
from .export import (
    from_prometheus,
    prometheus_name,
    read_jsonl,
    snapshot_from_dict,
    snapshot_to_dict,
    to_prometheus,
    write_jsonl,
)
from .profile import profile_epoch
from .recorder import (
    FlightRecorder,
    TornBundle,
    list_bundles,
    verify_bundle,
)
from .registry import (
    GUARD_NONFINITE,
    GUARD_SKIPPED,
    RECORDER_BUNDLES,
    RECORDER_EVENTS,
    ROUTED_OVERFLOW,
    SAMPLE_OVERFLOW,
    TIER_HITS,
    TRACE_SPANS,
    MetricSnapshot,
    MetricSpec,
    MetricsRegistry,
    MetricsTape,
)
from .timeline import P2Quantile, StageStats, StepTimeline
from .tracing import Span, Tracer, to_chrome_trace, write_chrome_trace

__all__ = [
    "MetricSpec",
    "MetricSnapshot",
    "MetricsRegistry",
    "MetricsTape",
    "ROUTED_OVERFLOW",
    "TIER_HITS",
    "SAMPLE_OVERFLOW",
    "GUARD_SKIPPED",
    "GUARD_NONFINITE",
    "P2Quantile",
    "StageStats",
    "StepTimeline",
    "snapshot_to_dict",
    "snapshot_from_dict",
    "write_jsonl",
    "read_jsonl",
    "to_prometheus",
    "from_prometheus",
    "prometheus_name",
    "profile_epoch",
    "Span",
    "Tracer",
    "TRACE_SPANS",
    "RECORDER_BUNDLES",
    "RECORDER_EVENTS",
    "to_chrome_trace",
    "write_chrome_trace",
    "FlightRecorder",
    "TornBundle",
    "verify_bundle",
    "list_bundles",
    "TelemetryEndpoint",
]
