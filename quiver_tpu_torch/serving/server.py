"""The online inference server over resident graph state.

The port of ``quiver_tpu/serving/server.py``. It composes the
:class:`~.coalesce.DeadlineBatcher` (admission, deadline-aware coalescing,
bounded-queue backpressure), the :class:`~.ladder.ServeLadder` (per-bucket
sample and forward programs, CUDA graphs on the card, replayed in steady
state) and the feature store's gather between them: a
:class:`~..feature.feature.Feature`, or the circuit-breaker-wrapped
:class:`~..resilience.elastic.DegradedFeature`, so a cold-tier outage
degrades responses instead of failing them.

Every batch walks the JAX server's six stages, ``queue_wait``, ``pad``,
``sample``, ``gather``, ``forward`` and ``readback``, on an
:class:`~..obs.timeline.StepTimeline` (P² p50/p95/p99 per stage); each
stage ends in a device synchronise, so its host-clock time covers its
device work. The serve counters land on a
:class:`~..obs.registry.MetricsRegistry` under the ``serve.*`` names, a
:class:`~..obs.tracing.Tracer` records one trace per request with the six
stages as child spans, and a :class:`~..obs.recorder.FlightRecorder`
dumps a postmortem bundle on a shed burst or a breaker opening.

Staleness: the server records the host CSR's committed ``version`` when it
builds its ladder, and every serve path raises
:class:`~..core.topology.VersionMismatchError` once the version moves,
until :meth:`InferenceServer.refresh` re-places the topology and rebuilds
the programs (through the program cache, when one is attached).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.memory import resolve_device
from ..core.topology import VersionMismatchError
from ..obs.registry import (
    SERVE_AOT_LOADS,
    SERVE_CLASS_MISSES,
    SERVE_DEADLINE_MISSES,
    SERVE_DEGRADED_LOOKUPS,
    SERVE_RECOMPILES,
    SERVE_REQUESTS,
    SERVE_SHED,
    MetricsRegistry,
)
from ..obs.timeline import StepTimeline
from ..obs.tracing import Tracer
from ..resilience.elastic import DegradedFeature
from .aot import as_cache
from .coalesce import PRIORITIES, DeadlineBatcher, ServeRequest, ladder_buckets
from .ladder import ServeLadder

__all__ = ["InferenceServer"]


class _MarkedStage:
    """Context manager pairing one :class:`StepTimeline` stage with a
    ``(name, t0, dur)`` mark on the server's tracer clock."""

    __slots__ = ("_server", "_name", "_marks", "_inner", "_t0")

    def __init__(self, server, name, marks):
        self._server = server
        self._name = name
        self._marks = marks
        self._inner = server.timeline.stage(name, sync=server.device)

    def __enter__(self):
        self._t0 = self._server.tracer.now()
        return self._inner.__enter__()

    def __exit__(self, exc_type, exc, tb):
        # the inner stage synchronises, so its exit ends the mark
        out = self._inner.__exit__(exc_type, exc, tb)
        self._marks.append(
            (self._name, self._t0, self._server.tracer.now() - self._t0)
        )
        return out


class InferenceServer:
    """Deadline-aware micro-batch serving over a resident sampler and store.

    Args:
      sampler: the :class:`~..sampling.sampler.GraphSageSampler` holding
        the placed topology to serve from.
      model: the module, ``model(x, adjs)`` -> log-probs; it is put in
        eval mode.
      feature: ids -> rows store (:class:`~..feature.feature.Feature`, or
        a wrapper of one exposing ``shape`` and ``device``).
      device: the serving device; CUDA unless the caller passes another.
        The sampler and the store must live on it.
      max_batch: top of the power-of-two bucket ladder.
      buckets: explicit ladder override (ascending powers of two).
      default_deadline_s / budget_fraction / max_queue / clock /
        class_deadlines: the :class:`DeadlineBatcher` knobs (the clock is
        injectable; tests drive a fake one).
      lane_caps: per-layer single-seed frontier caps (default: the
        sampler's worst-case single-seed plan).
      seed: base seed; a request's draws come from generators seeded by
        ``(seed, seq, layer)``, so responses are functions of (node, seq).
      degraded: None (store failures propagate), or ``"zeros"`` /
        ``"last-good"``: wrap the store in a circuit-breaker
        :class:`DegradedFeature`, so an outage serves degraded rows
        instead of failing requests.
      breaker_failures / probe_every: breaker thresholds when wrapping.
      metrics / timeline: external sinks (private by default).
      controller: optional :class:`~..control.CacheController` fed every
        served batch's sampled node ids (``observe_serve``, after the
        sample stage, from the sample program's output), so the store can
        re-tier under serving traffic; attached to the underlying store
        when it has a controller slot. It must have ``observe_serve``.
      aot_cache: optional program cache: an
        :class:`~.aot.AOTExecutableCache`, a directory path, or ``True``
        for the default location. Ladder builds consult it before
        capturing and publish after; :meth:`warm_from_cache` is the
        replica join that captures nothing the process already holds.
      tracer: optional :class:`Tracer`: every admitted request opens one
        trace, and the six batch stages land as child spans of it.
        Default: a disabled tracer (no work, bitwise-identical responses).
      recorder: optional :class:`~..obs.recorder.FlightRecorder`: dumps a
        postmortem bundle on a shed burst (``shed_burst`` sheds since the
        last dump) and, when this server wraps its store in a
        ``DegradedFeature``, on breaker open.
      shed_burst: shed-count threshold for the recorder trigger.
      draw_fn: optional ``draw_fn(seq, layer, deg)`` replacing the
        generator draws (the parity tests feed it JAX's): it returns a
        lane's int32 offsets, or its float32 ``u01`` block when the
        sampler is weighted.
    """

    STAGES = ("queue_wait", "pad", "sample", "gather", "forward", "readback")

    def __init__(self, sampler, model, feature, *, device=None,
                 max_batch: int = 8, buckets=None,
                 default_deadline_s: float = 0.05,
                 budget_fraction: float = 0.5, max_queue: int = 256,
                 clock=time.monotonic, lane_caps=None, seed: int = 0,
                 degraded: str | None = None, breaker_failures: int = 3,
                 probe_every: int = 8,
                 metrics: MetricsRegistry | None = None,
                 timeline: StepTimeline | None = None,
                 controller=None, class_deadlines: dict | None = None,
                 aot_cache=None, tracer: Tracer | None = None,
                 recorder=None, shed_burst: int = 8, draw_fn=None):
        if controller is not None and not hasattr(controller, "observe_serve"):
            raise TypeError(
                f"controller must have observe_serve (a CacheController), "
                f"got {type(controller).__name__}")
        self.aot_cache = as_cache(aot_cache)
        self.device = resolve_device(device)
        for name, dev in (("sampler", sampler.device),
                          ("feature", feature.device)):
            if torch.device(dev) != self.device:
                raise ValueError(
                    f"{name} lives on {dev}, the server on {self.device}")
        self.sampler = sampler
        self.model = model.to(self.device).eval()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.timeline = timeline if timeline is not None else StepTimeline()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.recorder = recorder
        self.replica_index = 0
        self.shed_burst = int(shed_burst)
        self._shed_dumped = 0
        self.clock = clock
        self.seed = int(seed)
        self.draw_fn = draw_fn
        if degraded is not None and not isinstance(feature, DegradedFeature):
            feature = DegradedFeature(
                feature, failures=breaker_failures, probe_every=probe_every,
                fallback=degraded, metrics=self.metrics, recorder=recorder,
            )
        self.feature = feature
        self.controller = controller
        if controller is not None:
            # repin decisions land on the underlying store (the breaker
            # unwrapped); a plain Feature has no tiers to move
            store = feature.feature if isinstance(feature, DegradedFeature) \
                else feature
            if hasattr(store, "_controller"):
                controller.attach(store)
        self.batcher = DeadlineBatcher(
            buckets=tuple(buckets) if buckets else ladder_buckets(max_batch),
            default_deadline_s=default_deadline_s,
            budget_fraction=budget_fraction,
            max_queue=max_queue, clock=clock,
            class_deadlines=class_deadlines,
        )
        self._lane_caps = lane_caps
        self.metrics.counter(
            SERVE_REQUESTS, unit="requests",
            doc="point queries completed by the serving path",
        )
        self.metrics.counter(
            SERVE_DEADLINE_MISSES, unit="requests",
            doc="requests completed after their admission deadline",
        )
        self.metrics.counter(
            SERVE_DEGRADED_LOOKUPS, unit="lookups",
            doc="serve-batch feature gathers satisfied by the circuit "
                "breaker's degraded fallback instead of the real store",
        )
        self.metrics.counter(
            SERVE_RECOMPILES, unit="programs",
            doc="ladder program compilations (0 after warmup = the "
                "steady-state never-recompile contract)",
        )
        self.metrics.counter(
            SERVE_AOT_LOADS, unit="programs",
            doc="ladder programs warmed by deserializing a persisted AOT "
                "executable instead of compiling (a cache-warm replica "
                "reports recompiles == 0)",
        )
        self.metrics.counter(
            SERVE_SHED, shape=(len(PRIORITIES),), unit="requests",
            doc="requests shed at admission under a full queue, by SLO "
                "class (coalesce.PRIORITIES order: gold, bronze)",
        )
        self.metrics.counter(
            SERVE_CLASS_MISSES, shape=(len(PRIORITIES),), unit="requests",
            doc="deadline misses attributed by SLO class "
                "(coalesce.PRIORITIES order: gold, bronze)",
        )
        self._requests_total = 0
        self._misses_total = 0
        self._recompiles_total = 0
        self._aot_loads_total = 0
        self._class_misses = [0] * len(PRIORITIES)
        self._serve_degraded_total = 0
        self._degraded_seen = (
            feature.degraded_total if isinstance(feature, DegradedFeature)
            else 0
        )
        # row dtype/width probe: one -1 (padding) id returns one zero row of
        # exactly the dtype and width the store serves
        probe = self.feature[torch.full((1,), -1, dtype=torch.int32)]
        self._row_dtype = probe.dtype
        self._feature_dim = int(probe.shape[1])
        self._ladder = self._make_ladder()
        self._topo_version = int(sampler.csr_topo.version)

    def _make_ladder(self) -> ServeLadder:
        return ServeLadder(
            self.sampler, self.model, self._feature_dim,
            row_dtype=self._row_dtype, lane_caps=self._lane_caps,
            seed=self.seed, draw_fn=self.draw_fn,
            on_compile=self._on_ladder_compile, aot_cache=self.aot_cache,
            on_cache_load=self._on_ladder_cache_load,
        )

    def _on_ladder_compile(self) -> None:
        self._recompiles_total += 1
        self.metrics.set(SERVE_RECOMPILES, np.int32(self._recompiles_total))

    def _on_ladder_cache_load(self) -> None:
        self._aot_loads_total += 1
        self.metrics.set(SERVE_AOT_LOADS, np.int32(self._aot_loads_total))

    def _sync_shed(self) -> None:
        shed = [self.batcher.shed_by_class[p] for p in PRIORITIES]
        self.metrics.set(SERVE_SHED, np.asarray(shed, np.int32))
        total = int(sum(shed))
        if self.recorder is not None:
            if total > self._shed_dumped:
                self.recorder.note(
                    "serve.shed", replica=self.replica_index,
                    shed_total=total,
                )
            if total - self._shed_dumped >= self.shed_burst:
                self._shed_dumped = total
                self.recorder.trigger(
                    "shed_burst", stage="queue",
                    replica=self.replica_index, shed_total=total,
                    queue_depth=self.batcher.depth,
                )

    @property
    def ladder(self) -> ServeLadder:
        # graftlint: disable=stale-version-read -- the ladder object itself, for inspection; every serving path checks the version first
        return self._ladder

    # -- streaming-mutation versioning --------------------------------------

    def check_version(self) -> None:
        """Raise :class:`VersionMismatchError` when the host CSR has
        committed a version the ladder was not built from."""
        current = int(self.sampler.csr_topo.version)
        if current != self._topo_version:
            raise VersionMismatchError(
                f"serving ladder built against topology version "
                f"{self._topo_version} but the host CSR has committed "
                f"version {current}; call refresh() before serving"
            )

    def refresh(self, warmup: bool = True) -> "InferenceServer":
        """Re-place the topology and rebuild the ladder after a commit.
        ``warmup`` rebuilds the buckets that were live before; with a
        program cache attached each rebuild checks the cache first (the
        committed version is in the fingerprint), so a replica whose
        sampler another replica already refreshed takes that replica's
        programs and captures nothing."""
        live = sorted(set(self._ladder._sample_exec)
                      | set(self._ladder._forward_exec))
        self.sampler.refresh_topology()
        self._ladder = self._make_ladder()
        self._topo_version = int(self.sampler.csr_topo.version)
        if warmup and live:
            self._ladder.warmup(live)
        return self

    # -- serving -------------------------------------------------------------

    def submit(self, node: int, deadline_s: float | None = None,
               priority: str = "gold",
               trace_id: str | None = None) -> ServeRequest:
        """Admit one point query (see :meth:`DeadlineBatcher.submit`); the
        shed policy under a full queue drops bronze before gold, and shed
        counts land per class on ``serve.shed_requests``. ``trace_id``
        joins the request to an existing trace; absent, a fresh trace
        opens per request when tracing is on."""
        try:
            req = self.batcher.submit(node, deadline_s, priority)
        finally:
            self._sync_shed()
        if self.tracer.enabled:
            req.trace_id = (trace_id if trace_id is not None
                            else self.tracer.trace())
            self.tracer.event(
                "serve.enqueue", trace=req.trace_id, subsystem="serve",
                node=int(node), seq=req.seq, priority=priority,
                replica=self.replica_index,
            )
        return req

    def warmup(self, buckets=None) -> int:
        """Build every bucket's programs before traffic (all batcher
        buckets by default); returns the number of captures. Steady-state
        serving after warmup replays programs only."""
        self.check_version()
        return self._ladder.warmup(
            tuple(buckets) if buckets else self.batcher.buckets
        )

    def warm_from_cache(self, buckets=None) -> dict:
        """Warm the ladder (all batcher buckets by default) from the
        program cache wherever it holds the program, capturing and
        publishing only the rest; returns ``{"loaded": n, "compiled":
        m}``. A replica joining a process whose first replica captured
        reports ``compiled == 0`` and answers bitwise as that replica. A
        fresh process captures again (CUDA graphs are process-local)."""
        self.check_version()
        return self._ladder.warm_from_cache(
            tuple(buckets) if buckets else self.batcher.buckets
        )

    def pump(self, force: bool = False) -> list[ServeRequest]:
        """Serve at most one due batch; returns the completed requests
        (empty when nothing is due). ``force`` flushes a partial bucket."""
        self.check_version()
        popped = self.batcher.pop(force=force)
        if popped is None:
            return []
        reqs, bucket = popped
        now = self.clock()
        for r in reqs:
            self.timeline.observe("queue_wait", now - r.t_admit)
        return self._run_batch(reqs, bucket)

    def serve(self, nodes, deadline_s: float | None = None,
              priority: str = "gold") -> list[ServeRequest]:
        """Closed-loop convenience: admit ``nodes`` and drain the queue;
        returns their completed requests in admission order."""
        reqs = [self.submit(int(n), deadline_s, priority)
                for n in np.asarray(nodes)]
        while any(not r.done for r in reqs):
            self.pump(force=True)
        return reqs

    def _stage(self, name: str, marks):
        """One timed batch stage, ending in a device synchronise: always
        on the P² timeline; when tracing, also a ``(name, t0, dur)`` mark
        (tracer clock) for every request of the batch."""
        if marks is None:
            return self.timeline.stage(name, sync=self.device)
        return _MarkedStage(self, name, marks)

    def _emit_batch_spans(self, reqs, bucket, marks, t_batch0, t_pop):
        """Per-request traces: one ``serve.request`` root from admission to
        completion, a ``serve.queue_wait`` child from the batcher clock,
        and the five measured batch stages as children (shared by the
        co-batched requests)."""
        t_end = self.tracer.now()
        for r in reqs:
            qwait = max(t_pop - r.t_admit, 0.0)
            root = self.tracer.record(
                "serve.request", t_batch0 - qwait,
                (t_end - t_batch0) + qwait, trace=r.trace_id,
                subsystem="serve", node=int(r.node), seq=r.seq,
                priority=r.priority, bucket=bucket,
                replica=self.replica_index, missed=bool(r.missed),
            )
            self.tracer.record(
                "serve.queue_wait", t_batch0 - qwait, qwait,
                trace=r.trace_id, parent=root, subsystem="serve",
            )
            for name, t0, dur in marks:
                self.tracer.record(
                    f"serve.{name}", t0, dur, trace=r.trace_id,
                    parent=root, subsystem="serve", bucket=bucket,
                )

    def _run_batch(self, reqs, bucket: int) -> list[ServeRequest]:
        marks = [] if self.tracer.enabled else None
        t_batch0 = self.tracer.now() if marks is not None else 0.0
        t_pop = self.clock()
        capL = self._ladder.lane_caps[-1]
        with self._stage("pad", marks):
            seeds = np.full(bucket, -1, np.int32)
            seqs = [None] * bucket
            for i, r in enumerate(reqs):
                seeds[i] = r.node
                seqs[i] = r.seq
        sample_ex = self._ladder.sample_exec(bucket)
        with self._stage("sample", marks):
            # the seeds are copied into the program's own buffer, outside
            # the captured graph
            n_ids, eis, overflow = sample_ex(torch.from_numpy(seeds), seqs)
        if self.controller is not None:
            # serve-path gather frequencies feed the same sketch a training
            # loop does (padding -1 lanes are filtered there)
            self.controller.observe_serve(n_ids.reshape(-1))
        with self._stage("gather", marks):
            x = self.feature[n_ids.reshape(-1)].reshape(
                bucket, capL, self._feature_dim)
        forward_ex = self._ladder.forward_exec(bucket)
        with self._stage("forward", marks):
            out = forward_ex(x, eis)
        with self._stage("readback", marks):
            # copies: the outputs are the programs' own tensors, which the
            # next batch overwrites
            out_np = out.to("cpu", copy=True).numpy()
            ovf_np = overflow.to("cpu", copy=True).numpy()
        t_done = self.clock()
        misses = 0
        for i, r in enumerate(reqs):
            r.result = out_np[i]
            r.overflow = int(ovf_np[i])
            r.t_done = t_done
            r.missed = t_done > r.deadline_at
            misses += int(r.missed)
            if r.missed:
                self._class_misses[PRIORITIES.index(r.priority)] += 1
        self._requests_total += len(reqs)
        self._misses_total += misses
        self.metrics.set(SERVE_REQUESTS, np.int32(self._requests_total))
        self.metrics.set(SERVE_DEADLINE_MISSES, np.int32(self._misses_total))
        self.metrics.set(
            SERVE_CLASS_MISSES, np.asarray(self._class_misses, np.int32)
        )
        if isinstance(self.feature, DegradedFeature):
            delta = self.feature.degraded_total - self._degraded_seen
            if delta:
                self._degraded_seen = self.feature.degraded_total
                self._serve_degraded_total += delta
                self.metrics.set(
                    SERVE_DEGRADED_LOOKUPS,
                    np.int32(self._serve_degraded_total),
                )
        if marks is not None:
            self._emit_batch_spans(reqs, bucket, marks, t_batch0, t_pop)
        return reqs

    # -- parity oracle -------------------------------------------------------

    def oracle(self, node: int, seq: int) -> np.ndarray:
        """The direct (ladder-free) answer for ``(node, seq)``: a single-seed
        sample with the same draws, the same store gather, and the model on
        one lane at the oracle's shapes."""
        self.check_version()
        n_id, eis, _overflow = self._ladder.oracle_sample(node, seq)
        x = self.feature[n_id].reshape(self._ladder.lane_caps[-1],
                                       self._feature_dim)
        return self._ladder.oracle_forward(x, eis).cpu().numpy()

    # -- introspection -------------------------------------------------------

    @property
    def recompiles(self) -> int:
        """Ladder program builds, each a capture on the card
        (``serve.recompiles``; flat after :meth:`warmup`)."""
        return self._recompiles_total

    @property
    def aot_loads(self) -> int:
        """Ladder programs taken from the program cache
        (``serve.aot_loads``)."""
        return self._aot_loads_total

    def stats(self) -> dict:
        """Host-side serve counters and per-stage latency quantiles: the
        JAX server's layout, ``stages`` as ``StageStats.as_dict()`` (P²
        estimates, milliseconds)."""
        stages = {
            name: st.as_dict()
            for name, st in self.timeline.summary().items()
        }
        return {
            "requests": self._requests_total,
            "deadline_misses": self._misses_total,
            "class_deadline_misses": dict(
                zip(PRIORITIES, self._class_misses)
            ),
            "shed": dict(self.batcher.shed_by_class),
            "degraded_lookups": self._serve_degraded_total,
            "recompiles": self._recompiles_total,
            "aot_loads": self._aot_loads_total,
            "queue_depth": self.batcher.depth,
            "stages": stages,
        }
