"""Serving fleet: N replicas over one resident state, joining without
captures.

The port of ``quiver_tpu/serving/fleet.py``. The reference scales serving
by sharing one resident ``Feature`` behind many frontends; the fleet
shares along both axes that matter:

* **data**: every :class:`~.server.InferenceServer` replica serves the
  same sampler topology, feature store (plain or breaker-wrapped) and
  :class:`~..control.CacheController` sketch, so the fleet's serve
  traffic feeds one re-tiering decision stream;
* **programs**: every replica warms from the same
  :class:`~.aot.AOTExecutableCache`: the first replica captures each
  ladder program once and registers it, and each later replica in the
  process takes it, joining with zero captures and answering every
  ``(node, seq)`` bitwise as the first (all replicas share the base
  seed). A fresh process captures again: CUDA graphs are process-local.

Routing is least-queue-depth with full-queue failover, and admission is
SLO-class aware per replica (``serving/coalesce.py``).
"""

from __future__ import annotations

import time

import numpy as np

from ..obs.endpoint import TelemetryEndpoint
from ..obs.tracing import Tracer
from .aot import as_cache
from .coalesce import PRIORITIES, ServeQueueFull, ServeRequest
from .server import InferenceServer

__all__ = ["ServingFleet"]


class ServingFleet:
    """N :class:`InferenceServer` replicas over one shared resident state.

    Args:
      sampler / model / feature: the shared serving state (see
        :class:`InferenceServer`; the port's model holds its weights, so
        there is no ``params``).
      replicas: initial fleet size (:meth:`add_replica` grows it later).
      aot_cache: the shared program cache every replica warms from and
        publishes to: an :class:`AOTExecutableCache`, a directory path, or
        ``True`` (default) for the default location; ``None`` gives every
        replica its own captures.
      controller: optional shared :class:`~..control.CacheController`; all
        replicas feed one sketch.
      seed: base seed shared by ALL replicas, so a response is a function
        of ``(node, seq)`` alone and any replica answers any request
        identically.
      warm: warm each constructed replica at once (join records land in
        :attr:`cold_starts`).
      clock: injectable clock handed to every replica's batcher.
      tracer: optional shared :class:`Tracer`: the fleet opens ONE trace
        per submitted request before routing, so a failed-over request's
        spans on every replica it touched share one trace id. Default: a
        disabled tracer.
      recorder: optional shared :class:`~..obs.recorder.FlightRecorder`
        handed to every replica.
      device: the serving device (CUDA unless the caller passes another).
      **server_kwargs: forwarded to every :class:`InferenceServer`
        (``max_batch``, ``buckets``, ``class_deadlines``, ``max_queue``,
        ``degraded``, ``draw_fn``, ...).
    """

    def __init__(self, sampler, model, feature, *, replicas: int = 1,
                 aot_cache=True, controller=None, seed: int = 0,
                 warm: bool = True, clock=time.monotonic,
                 tracer: Tracer | None = None, recorder=None, device=None,
                 **server_kwargs):
        self.sampler = sampler
        self.model = model
        self.feature = feature
        self.aot_cache = as_cache(aot_cache)
        self.controller = controller
        self.seed = int(seed)
        self.clock = clock
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.recorder = recorder
        self.device = device
        self._server_kwargs = dict(server_kwargs)
        self.servers: list[InferenceServer] = []
        #: per-replica join records ``{"seconds", "loaded", "compiled"}``:
        #: a join from a cache that holds the programs shows
        #: ``compiled == 0``
        self.cold_starts: list[dict] = []
        for _ in range(int(replicas)):
            self.add_replica(warm=warm)

    # -- membership ----------------------------------------------------------

    def add_replica(self, warm: bool = True) -> InferenceServer:
        """Construct one replica over the shared state and (by default)
        warm it from the shared program cache; a join whose programs the
        process already holds captures nothing."""
        t0 = time.perf_counter()
        srv = InferenceServer(
            self.sampler, self.model, self.feature, device=self.device,
            aot_cache=self.aot_cache, controller=self.controller,
            seed=self.seed, clock=self.clock, tracer=self.tracer,
            recorder=self.recorder, **self._server_kwargs,
        )
        srv.replica_index = len(self.servers)
        ws = {"loaded": 0, "compiled": 0}
        if warm:
            ws = srv.warm_from_cache() if self.aot_cache is not None \
                else {"loaded": 0, "compiled": srv.warmup()}
        self.cold_starts.append(
            {"seconds": time.perf_counter() - t0, **ws}
        )
        self.servers.append(srv)
        return srv

    # -- routing and serving -------------------------------------------------

    def submit(self, node: int, deadline_s: float | None = None,
               priority: str = "gold") -> ServeRequest:
        """Admit one point query on the least-loaded replica; a replica at
        its bound runs its own shed policy (bronze before gold), and a
        hard rejection fails over to the next replica before
        :class:`ServeQueueFull` propagates."""
        if not self.servers:
            raise RuntimeError("fleet has no replicas; call add_replica()")
        # one trace per request, opened BEFORE routing: every replica a
        # failover touches records its spans under this id
        tid = self.tracer.trace() if self.tracer.enabled else None
        last_err = None
        first = True
        for srv in sorted(self.servers, key=lambda s: s.batcher.depth):
            if tid is not None:
                self.tracer.event(
                    "fleet.route" if first else "fleet.failover",
                    trace=tid, subsystem="fleet",
                    replica=srv.replica_index, node=int(node),
                    depth=srv.batcher.depth,
                )
            first = False
            try:
                return srv.submit(node, deadline_s, priority, trace_id=tid)
            except ServeQueueFull as e:
                last_err = e
        if tid is not None:
            self.tracer.event(
                "fleet.rejected", trace=tid, subsystem="fleet",
                node=int(node),
            )
        raise last_err

    def pump(self, force: bool = False) -> list[ServeRequest]:
        """Serve at most one due batch per replica; returns the completed
        requests across the fleet."""
        done: list[ServeRequest] = []
        for srv in self.servers:
            done.extend(srv.pump(force=force))
        return done

    def serve(self, nodes, deadline_s: float | None = None,
              priority: str = "gold") -> list[ServeRequest]:
        """Closed-loop convenience: admit ``nodes`` across the fleet and
        drain every queue; returns the requests in admission order."""
        reqs = [self.submit(int(n), deadline_s, priority)
                for n in np.asarray(nodes)]
        while any(not r.done for r in reqs):
            self.pump(force=True)
        return reqs

    # -- mutation versioning -------------------------------------------------

    def check_version(self) -> None:
        for srv in self.servers:
            srv.check_version()

    def refresh(self, warmup: bool = True) -> "ServingFleet":
        """Re-place and rebuild every replica after a topology mutation.
        The first replica re-places the shared sampler, captures the new
        version's programs and publishes them; every later replica finds
        the sampler placed and takes those programs from the cache: a
        fleet pays each capture once, not once per replica."""
        for srv in self.servers:
            srv.refresh(warmup=warmup)
        return self

    # -- introspection -------------------------------------------------------

    @property
    def recompiles(self) -> int:
        """Fleet-total ladder program builds (captures on the card)."""
        return sum(s.recompiles for s in self.servers)

    @property
    def aot_loads(self) -> int:
        """Fleet-total programs taken from the program cache."""
        return sum(s.aot_loads for s in self.servers)

    def health(self) -> dict:
        """The ``/healthz`` summary: per-replica queue depth, topology
        version, breaker state (when the store is breaker-wrapped)."""
        reps = []
        for srv in self.servers:
            breaker = getattr(srv.feature, "breaker", None)
            reps.append({
                "replica": srv.replica_index,
                "queue_depth": srv.batcher.depth,
                "topology_version": srv._topo_version,
                "breaker": breaker.state if breaker is not None else None,
            })
        return {
            "replicas": len(reps),
            "queue_depth": sum(r["queue_depth"] for r in reps),
            "per_replica": reps,
        }

    def serve_telemetry(self, host: str = "127.0.0.1",
                        port: int = 0) -> TelemetryEndpoint:
        """Start (and return) a live telemetry endpoint over the fleet:
        ``/metrics`` from replica 0's registry, ``/traces`` from the shared
        tracer, ``/healthz`` from :meth:`health`. The caller stops it."""
        metrics = self.servers[0].metrics if self.servers else None
        return TelemetryEndpoint(
            metrics=metrics, tracer=self.tracer, health=self.health,
            host=host, port=port,
        ).start()

    def oracle(self, node: int, seq: int) -> np.ndarray:
        """The fleet-wide parity reference: replicas share the base seed,
        so replica 0's direct (ladder-free) answer is the answer every
        replica must give bitwise for ``(node, seq)``."""
        return self.servers[0].oracle(node, seq)

    def stats(self) -> dict:
        """Fleet-aggregated serve counters (per-class shed and misses
        summed across replicas) plus the per-replica breakdown."""
        per = [s.stats() for s in self.servers]
        return {
            "replicas": len(per),
            "requests": sum(p["requests"] for p in per),
            "deadline_misses": sum(p["deadline_misses"] for p in per),
            "class_deadline_misses": {
                c: sum(p["class_deadline_misses"][c] for p in per)
                for c in PRIORITIES
            },
            "shed": {
                c: sum(p["shed"][c] for p in per) for c in PRIORITIES
            },
            "recompiles": sum(p["recompiles"] for p in per),
            "aot_loads": sum(p["aot_loads"] for p in per),
            "queue_depth": sum(p["queue_depth"] for p in per),
            "cold_starts": list(self.cold_starts),
            "aot_cache": (self.aot_cache.stats()
                          if self.aot_cache is not None else None),
            "per_replica": per,
        }
