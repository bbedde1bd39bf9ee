"""The online inference server over resident graph state.

The port of ``quiver_tpu/serving/server.py``. It composes the
:class:`~.coalesce.DeadlineBatcher` (admission, deadline-aware coalescing,
bounded-queue backpressure), the :class:`~.ladder.ServeLadder` (per-bucket
sample and forward steps) and the feature store's gather between them.

Every batch walks the same six stages as the JAX server: ``queue_wait``,
``pad``, ``sample``, ``gather``, ``forward`` and ``readback``. Each stage
ends in a device synchronise, so its host-clock time is the time of its
device work; the times are kept per stage and summarised by
:meth:`InferenceServer.stats`.

Staleness: the server records the host CSR's committed ``version`` when it
builds its ladder, and every serve path raises
:class:`~..core.topology.VersionMismatchError` once the version moves,
until :meth:`InferenceServer.refresh` re-places the topology.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core.memory import resolve_device
from ..core.topology import VersionMismatchError
from .coalesce import PRIORITIES, DeadlineBatcher, ServeRequest, ladder_buckets
from .ladder import ServeLadder

__all__ = ["InferenceServer", "StageTimes"]


class StageTimes:
    """Per-stage latency samples (seconds), summarised on demand."""

    def __init__(self, stages):
        self.samples = {name: [] for name in stages}

    def observe(self, name: str, seconds: float) -> None:
        self.samples[name].append(float(seconds))

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            if xs:
                a = np.asarray(xs)
                out[name] = {"count": len(xs), "mean": float(a.mean()),
                             "p50": float(np.percentile(a, 50)),
                             "p99": float(np.percentile(a, 99))}
        return out


class InferenceServer:
    """Deadline-aware micro-batch serving over a resident sampler and store.

    Args:
      sampler: the :class:`~..sampling.sampler.GraphSageSampler` holding
        the placed topology to serve from.
      model: the module, ``model(x, adjs)`` -> log-probs; it is put in
        eval mode.
      feature: ids -> rows store (:class:`~..feature.feature.Feature`).
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
                 class_deadlines: dict | None = None, draw_fn=None):
        self.device = resolve_device(device)
        for name, dev in (("sampler", sampler.device),
                          ("feature", feature.device)):
            if torch.device(dev) != self.device:
                raise ValueError(
                    f"{name} lives on {dev}, the server on {self.device}")
        self.sampler = sampler
        self.model = model.to(self.device).eval()
        self.feature = feature
        self.clock = clock
        self.seed = int(seed)
        self.draw_fn = draw_fn
        self.batcher = DeadlineBatcher(
            buckets=tuple(buckets) if buckets else ladder_buckets(max_batch),
            default_deadline_s=default_deadline_s,
            budget_fraction=budget_fraction,
            max_queue=max_queue, clock=clock,
            class_deadlines=class_deadlines,
        )
        self.timeline = StageTimes(self.STAGES)
        self._lane_caps = lane_caps
        self._requests_total = 0
        self._misses_total = 0
        self._class_misses = [0] * len(PRIORITIES)
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
        )

    @property
    def ladder(self) -> ServeLadder:
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
        """Re-place the topology and rebuild the ladder after a commit;
        ``warmup`` re-warms the buckets that were warm before."""
        live = sorted(self._ladder._warm)
        self.sampler.refresh_topology()
        self._ladder = self._make_ladder()
        self._topo_version = int(self.sampler.csr_topo.version)
        if warmup and live:
            self._ladder.warmup(live)
        return self

    # -- serving -------------------------------------------------------------

    def submit(self, node: int, deadline_s: float | None = None,
               priority: str = "gold") -> ServeRequest:
        """Admit one point query (see :meth:`DeadlineBatcher.submit`)."""
        return self.batcher.submit(node, deadline_s, priority)

    def warmup(self, buckets=None) -> int:
        """Run every bucket once before traffic (all batcher buckets by
        default); returns the number of buckets warmed."""
        self.check_version()
        return self._ladder.warmup(
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

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timeline.observe(name, time.perf_counter() - t0)

    def _run_batch(self, reqs, bucket: int) -> list[ServeRequest]:
        capL = self._ladder.lane_caps[-1]
        with self._stage("pad"):
            seeds = np.full(bucket, -1, np.int32)
            seqs = [None] * bucket
            for i, r in enumerate(reqs):
                seeds[i] = r.node
                seqs[i] = r.seq
            seeds_d = torch.from_numpy(seeds).to(self.device)
        with self._stage("sample"):
            n_ids, eis, overflow = self._ladder.sample_exec(bucket)(seeds_d, seqs)
        with self._stage("gather"):
            x = self.feature[n_ids.reshape(-1)].reshape(
                bucket, capL, self._feature_dim)
        with self._stage("forward"):
            out = self._ladder.forward_exec(bucket)(x, eis)
        with self._stage("readback"):
            out_np = out.cpu().numpy()
            ovf_np = overflow.cpu().numpy()
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

    def stats(self) -> dict:
        """Serve counters and per-stage latency quantiles (seconds)."""
        return {
            "requests": self._requests_total,
            "deadline_misses": self._misses_total,
            "class_deadline_misses": dict(zip(PRIORITIES, self._class_misses)),
            "shed": dict(self.batcher.shed_by_class),
            "queue_depth": self.batcher.depth,
            "stages": self.timeline.summary(),
        }
