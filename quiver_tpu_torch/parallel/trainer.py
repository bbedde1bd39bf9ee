"""Training over a device mesh: the fused trainer and the data-parallel one.

The port of ``quiver_tpu/parallel/trainer.py``: :class:`DistributedTrainer`
and :class:`DataParallelTrainer`, with their telemetry summary.

:class:`DistributedTrainer` owns the whole step, as the JAX package's one
compiled program does: each data worker samples its padded seed block on
the device (``GraphSageSampler.sample_padded``, one kernel K1 launch per
hop), the rows are gathered (one kernel K2 launch per worker from a
replicated ``Feature``; from a ``ShardedFeature``, one three-tier lookup
per feature group), then the forward, the backward, the optional
non-finite guard and one optimizer step. Here the step runs eagerly, one
launch after another on the current stream, with no host read but the
guard's verdict; ``epoch_scan`` is a loop of such steps with JAX's
contract (checkpoint chunks, the one-step skew of ``pipeline_depth=1``,
preemption and resume).

:class:`DataParallelTrainer` is the reference's papers100M loop
(benchmarks/ogbn-papers100M/dist_sampling_ogb_paper100M_quiver.py:120-165):
each data-parallel worker samples its own seed block and gathers its own
features, host-driven under the :class:`~.pipeline.Prefetcher`, and one
model step averages the workers' gradients (the reference's DDP
allreduce, JAX's ``pmean``). It takes any sampler and store configuration:
``mode="HOST"`` topologies (kernel K1 reading ``indices`` over UVA), cold
feature tiers (K2 reading pinned rows), weighted hops, auto caps.

In both, every data worker runs in this process on the mesh's one device,
in worker order, and the gradient is the workers' mean. A mesh whose
workers map to more than one distinct device raises (meshes of distinct
cards are ROADMAP A.11e). :class:`DistributedTrainer`'s elastic mode
(``logical_workers=``) fixes the worker count apart from the mesh and
reduces in logical-worker order, so ``resume(mesh=)`` continues a run on
another mesh shape bitwise.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..control.freq import heat_num_bins, row_heat_histogram
from ..core.config import CachePolicy, parse_size_bytes
from ..feature.shard import ShardedFeature
from ..obs.registry import (
    FEATURE_ROW_HEAT,
    GUARD_NONFINITE,
    GUARD_SKIPPED,
    PIPELINE_REISSUES,
    ROUTED_OVERFLOW,
    SAMPLE_OVERFLOW,
    TIER_HITS,
    TRAIN_OVERLAP_EFFICIENCY,
    MetricsRegistry,
)
from ..obs.timeline import StepTimeline
from ..obs.tracing import Tracer
from ..ops.sample import fold_key, seeded_generator
from ..resilience.elastic import validate_resume_meta, worker_ordered_mean
from ..resilience.faults import Preemption
from ..resilience.guard import guard_verdict, guarded_update
from ..sampling.sampler import Adj
from ..utils.trace import get_logger, info_once
from .mesh import DATA_AXIS, FEATURE_AXIS, Mesh, shard_seed_blocks
from .pipeline import Batch, Prefetcher
from .train import cross_entropy_on_seeds, init_model

__all__ = ["DistributedTrainer", "DataParallelTrainer", "fold_key"]


def _metrics_report(metrics: MetricsRegistry, timeline: StepTimeline,
                    empty_note: str = "") -> str:
    """One-call telemetry summary: every recorded registry metric (totals
    and the most recent per-step value) and the host StepTimeline's
    streaming percentiles."""
    lines = []
    snaps = metrics.snapshots()
    if snaps:
        lines.append("metrics:")
        for s in snaps:
            arr = s.numpy
            head = f"  {s.name} ({s.kind}"
            if s.steps is not None:
                head += f", {s.steps} steps"
            head += ")"
            if s.kind == "counter":
                head += f": total={int(arr.sum())}"
                if s.steps is not None:
                    head += f" last={np.asarray(s.last()).tolist()}"
            else:
                head += f": last={np.asarray(s.last()).tolist()}"
                if s.steps is not None:
                    head += f" total={arr.sum(axis=0).tolist()}"
            lines.append(head)
    else:
        lines.append(f"metrics: (none recorded{empty_note})")
    lines.append("timeline:")
    lines.extend("  " + ln for ln in timeline.report().splitlines())
    return "\n".join(lines)


def _one_device(mesh: Mesh) -> torch.device:
    """The one device every slot of ``mesh`` sits on; raises for more."""
    devices = set(mesh.devices.ravel().tolist())
    if len(devices) > 1:
        raise NotImplementedError(
            f"the mesh's workers sit on {len(devices)} devices; training "
            "across distinct devices is not ported yet (ROADMAP A.11e)"
        )
    return devices.pop()


class IssuedBlock(NamedTuple):
    """One worker's issued block: what the step's train half consumes."""

    n_id: torch.Tensor  # (frontier_cap,) node ids, seeds first, -1 padded
    x: torch.Tensor  # (frontier_cap, F) gathered rows
    adjs: list  # deepest layer first
    num_seeds: torch.Tensor  # valid seeds of the block (device scalar)
    tier_hits: torch.Tensor  # int32 (3,) [replicated, hot, cold] hits
    heat: torch.Tensor | None = None  # int32 row-heat histogram (heat feed on)


class IssuedStep(NamedTuple):
    """A step's issued half: every worker's block, in worker order, the
    routed lookups' fallback-served lanes (int32 device scalar) and the
    routed hops' per hop (int32 ``(L,)``, a topology-sharded sampler's;
    None: zeros)."""

    blocks: list
    routed_overflow: torch.Tensor
    sample_overflow: torch.Tensor | None = None


class DistributedTrainer:
    """Owns the fused train step for a (sampler, feature, model) triple.

    Args (JAX's, in JAX's order, with a torch optimizer in ``tx``'s place):
      mesh: a :class:`~.mesh.Mesh` whose workers all sit on one device.
      sampler: a ``GraphSageSampler`` (its topology on the mesh's device),
        or a ``topo_sharding="mesh"`` one (``DistGraphSageSampler``) over
        this mesh's ``feature`` axis, which needs ``seed_sharding="all"``:
        each feature group's workers then sample together, one routed hop
        at a time (``sample_group``). Its caps planned for ``local_batch``
        are the step's: an auto sampler is planned before the trainer is
        built (one ``sample`` call) and is neither planned nor regrown by
        the step.
      feature: a ``Feature`` (``device_replicate``: hot rows on the device,
        cold rows pinned on the host), or a
        :class:`~..feature.shard.ShardedFeature` over a mesh of the same
        shape (L0 rows on the device, L1 rows sharded over the feature
        axis, cold rows pinned).
      model: the torch model, its parameters on the mesh's device.
      optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters;
        the step updates them in place.
      local_batch: seeds per worker block (padded with -1).
      seed_sharding: ``"data"`` (one worker per data row of the mesh) or
        ``"all"`` (every mesh slot a worker); equal on a ``feature=1``
        mesh. Over a sharded store, ``"data"`` runs the psum flavour (the
        feature group shares one sample, every shard serves its lanes) and
        ``"all"`` the routed one (each member's lanes routed to their
        owning shards, :class:`~.routing.BucketRoute`).
      routed_alpha: the routed lookup's bucket capacity, ``ceil(alpha * L
        / F)`` lanes for ``L`` ids per member (``None``: uncapped; the
        overflow is served exactly and counted in ``last_routed_overflow``).
      replicate_budget: on a sharded store, the L0 tier's bytes per device:
        ``feature.resplit_budget`` before the first step; inert on a
        replicated store (logged once).
      collect_metrics: record the step's telemetry in ``metrics``.
      nonfinite_guard: skip the optimizer update of a step whose loss or
        gradients hold a NaN or Inf (:mod:`..resilience.guard`); the
        parameters and the optimizer state pass through bit-unchanged.
        The verdict is read on the host: one synchronisation per step,
        only while the guard is on.
      fault_plan: a :class:`~..resilience.FaultPlan`: NaN rows written
        into a copy of the gathered block on its planned steps, and a
        simulated :class:`~..resilience.Preemption`.
      checkpoint_dir / checkpoint_every / checkpoint_keep: ``epoch_scan``
        runs in chunks of ``checkpoint_every`` steps and saves (model,
        optimizer, step, epoch, key) after each through a
        :class:`~..utils.checkpoint.Checkpointer`; see :meth:`resume`.
      pipeline_depth: 0, the serial epoch; 1, the one-step skew: issue
        step t+1's sample and gather, then train step t (a prologue issues
        the first batch of each chunk, so a chunk after the first issues
        its first batch again, counted in ``train.pipeline_reissues``).
        The same ops on the same inputs as depth 0, in another order.
      auto_alpha: tune ``routed_alpha`` between steps: one budget for the
        routed lookup and a topology-sharded sampler's hops, read from both
        overflow counts of the previous step (an
        :class:`~..control.AlphaTuner`: double on overflow, up to F; halve
        after a run of clean steps, not below a value that overflowed).
        With no ``controller`` a default one with no heat feed is made; it
        is not attached to the store.
      controller: a :class:`~..control.CacheController` that owns the
        store's placement and routing decisions: attached to a
        ``ShardedFeature`` (its split tuner moves the L0/L1 boundary, its
        ``end_epoch`` may ``repin``), fed each step's seeds and, when it
        asks for heat and metrics are on, each step's row-heat histogram
        (``feature.row_heat``, computed on the device in the step), and
        driving the ``routed_alpha`` tuner. A frozen controller observes
        and decides nothing: the losses stay those of ``controller=None``.
      logical_workers: elastic mode: the logical seed-block worker count,
        fixed apart from the mesh (``seed_sharding="all"``, a multiple of
        the mesh's slots). Slot ``s`` runs ``blocks_per_device`` blocks in
        turn; block ``b`` is logical worker ``w = s * blocks_per_device +
        b``, keyed ``fold_key(k, 1, w)``; a feature group's routed sample
        and lookup pair its members' block ``b``; the loss and the
        gradients are :func:`~..resilience.worker_ordered_mean` of the
        blocks' unscaled values. The trajectory is then bitwise
        independent of the mesh shape, so :meth:`resume` with ``mesh=``
        continues a run on another shape. None: one block per slot and
        the plain mean (each worker's gradient of ``loss / workers``,
        summed in worker order).
      donate_epoch_state: accepted; the JAX package's opt-in to reuse the
        epoch's parameter buffers already holds here, since the step
        updates the caller's parameters in place.
      tracer, recorder: the ``train.step``/``train.chunk`` spans and the
        flight recorder that dumps a bundle when the guard skips a step.

    Not ported yet (raises ``NotImplementedError`` naming its ROADMAP
    item): a mesh whose workers sit on more than one distinct device
    (A.11e).

    Keys: a JAX key is played by an int seed, read and never advanced.
    Step ``t`` of an epoch draws from ``fold_key(key0, 0, t)``; worker
    ``w`` of a step keyed ``k`` from ``fold_key(k, 1, w)``; its sample
    stream is ``(worker key, 0)`` and its dropout stream ``(worker key,
    1)``. So a re-issued, skewed or resumed step draws exactly what the
    serial step drew. ``draw_fn`` (None, or ``draw_fn(key, worker, layer,
    deg)``) replaces the sample draws of the step keyed ``key``, as
    ``GraphSageSampler.sample``'s ``draw_fn`` does (the tests replay the
    JAX package's draws through it).
    """

    def __init__(
        self,
        mesh: Mesh,
        sampler,
        feature,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        local_batch: int = 128,
        seed_sharding: str = "data",
        routed_alpha: float | None = 2.0,
        replicate_budget: int | str | None = None,
        auto_alpha: bool = False,
        collect_metrics: bool = True,
        nonfinite_guard: bool = False,
        fault_plan=None,
        checkpoint_dir=None,
        checkpoint_every: int = 0,
        checkpoint_keep: int = 3,
        logical_workers: int | None = None,
        pipeline_depth: int = 0,
        controller=None,
        donate_epoch_state: bool = False,
        tracer: Tracer | None = None,
        recorder=None,
    ):
        self.seed_sharding = str(seed_sharding)
        if self.seed_sharding not in ("data", "all"):
            raise ValueError(
                f"seed_sharding must be 'data' or 'all', got {seed_sharding!r}"
            )
        if routed_alpha is not None and routed_alpha <= 0:
            raise ValueError(
                f"routed_alpha must be > 0 or None, got {routed_alpha}"
            )
        self.routed_alpha = None if routed_alpha is None else float(routed_alpha)
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 (serial) or 1 (one-step skew), "
                f"got {pipeline_depth}"
            )
        self.checkpoint_every = int(checkpoint_every)
        if checkpoint_dir is not None and self.checkpoint_every < 1:
            raise ValueError(
                "checkpoint_dir= requires checkpoint_every >= 1 "
                f"(got {checkpoint_every})"
            )
        if checkpoint_dir is None and self.checkpoint_every:
            raise ValueError(
                "checkpoint_every= without checkpoint_dir= has "
                "nothing to write to"
            )
        self.auto_alpha = bool(auto_alpha)
        device = _one_device(mesh)
        # a topo_sharding="mesh" sampler routes each hop over the feature
        # axis, so every mesh slot must be a worker over its own block
        # ("data" would route a feature group's one frontier F times)
        self.topo_sharded = getattr(sampler, "topo_sharding", "replicated") == "mesh"
        if self.topo_sharded:
            if self.seed_sharding != "all":
                raise ValueError(
                    "a topo_sharding='mesh' sampler requires "
                    "seed_sharding='all' (every device a full sampling "
                    "worker over its own seed block)"
                )
            if sampler.mesh is not mesh:
                raise ValueError(
                    "the sampler's mesh must be the trainer's mesh "
                    "(the topology partition and the step program must "
                    "agree on the feature axis)"
                )
            if sampler.axis != FEATURE_AXIS:
                raise ValueError(
                    f"topo_sharding='mesh' sampler must shard over the "
                    f"'{FEATURE_AXIS}' axis, got {sampler.axis!r}"
                )
        self._sharded = isinstance(feature, ShardedFeature)
        if self._sharded and feature.mesh.shape != mesh.shape:
            raise ValueError(
                f"the ShardedFeature's mesh {feature.mesh.shape} is not the "
                f"trainer's {mesh.shape}"
            )
        if replicate_budget is not None:
            if self._sharded:
                feature.resplit_budget(replicate_budget)
            elif parse_size_bytes(replicate_budget):
                info_once(
                    "trainer-replicate-budget-inert",
                    "DistributedTrainer(replicate_budget=%r) on a "
                    "device_replicate Feature is INERT: its hot tier is "
                    "already replicated per device (zero-comm); size it "
                    "with device_cache_size",
                    replicate_budget,
                )
        self.donate_epoch_state = bool(donate_epoch_state)
        self.collect_metrics = bool(collect_metrics)
        self.metrics = MetricsRegistry(enabled=self.collect_metrics)
        self.metrics.counter(
            ROUTED_OVERFLOW, unit="lanes",
            doc="capped-bucket fallback-served lanes of the step's sharded "
                "feature gather",
        )
        self.metrics.gauge(
            TIER_HITS, shape=(3,), unit="hits",
            doc="mesh-total per-tier feature hits [replicated, sharded, cold]",
        )
        self.metrics.counter(
            SAMPLE_OVERFLOW, shape=(len(tuple(sampler.sizes)),), unit="lanes",
            doc="per-hop fallback-served lanes of the topo-sharded sampler "
                "(seeds-outward)",
        )
        self.nonfinite_guard = bool(nonfinite_guard)
        if self.nonfinite_guard:
            self.metrics.counter(
                GUARD_SKIPPED, unit="steps",
                doc="optimizer updates skipped by the non-finite step guard",
            )
            self.metrics.counter(
                GUARD_NONFINITE, unit="values",
                doc="non-finite loss/grad values detected before the "
                    "gradient mean",
            )
        self._pipeline_reissues = 0
        if self.pipeline_depth:
            self.metrics.counter(
                PIPELINE_REISSUES, unit="batches",
                doc="prologue batches re-issued from the seed matrix at "
                    "checkpoint-chunk/resume boundaries (the carried "
                    "batch is replayed, not serialized)",
            )
            self.metrics.gauge(
                TRAIN_OVERLAP_EFFICIENCY, dtype=torch.float32, unit="x",
                doc="serial stage-sum over measured pipelined step time "
                    "(> 1.0 = sample/gather latency hidden under compute)",
            )
        self.fault_plan = fault_plan
        self._fault_step = 0  # eager step() call counter the plan indexes
        self._preempt_fired = False
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.recorder = recorder
        self._guard_trips_seen = 0
        if checkpoint_dir is not None:
            from ..utils.checkpoint import Checkpointer

            self.checkpointer = Checkpointer(
                checkpoint_dir, max_to_keep=checkpoint_keep, tracer=self.tracer,
            )
            latest = self.checkpointer.latest_step()
            # a pre-existing run directory: keep the save ids monotonic
            self._ckpt_seq = 0 if latest is None else latest + 1
        else:
            self.checkpointer = None
            self._ckpt_seq = 0
        self.timeline = StepTimeline()
        self.mesh = mesh
        self.device = device
        self.sampler = sampler
        self.feature = feature
        self.model = model
        self.optimizer = optimizer
        self.local_batch = int(local_batch)
        self.data_size = mesh.shape[DATA_AXIS]
        self.feature_size = mesh.shape[FEATURE_AXIS]
        # seed-block workers: every slot under "all", one per data group
        # under "data"; elastic mode fixes the LOGICAL count apart from the
        # mesh, and each slot runs blocks_per_device of them in turn
        self._device_workers = self.data_size * (
            self.feature_size if self.seed_sharding == "all" else 1
        )
        self.elastic = logical_workers is not None
        if self.elastic:
            lw = int(logical_workers)
            if self.seed_sharding != "all":
                raise ValueError(
                    "logical_workers= (elastic mode) requires "
                    "seed_sharding='all': every device must be a full "
                    "seed-block worker for blocks to re-map across mesh "
                    "shapes"
                )
            if lw < self._device_workers or lw % self._device_workers:
                raise ValueError(
                    f"logical_workers={lw} must be a multiple of the "
                    f"device worker count {self._device_workers} (each "
                    f"device runs logical_workers/devices seed blocks)"
                )
            self.workers = lw
        else:
            self.workers = self._device_workers
        self.blocks_per_device = self.workers // self._device_workers
        # a sharded store under "all": each feature group's lookup routes
        self._routed = self._sharded and self.seed_sharding == "all"
        self.global_batch = self.local_batch * self.workers
        # the cache controller: auto_alpha with none builds an alpha-only
        # one (no heat feed, not attached: it must not move a split the
        # caller never asked for); a given one is attached to a sharded
        # store, and its heat feed is registered before the first step
        if controller is None and self.auto_alpha:
            from ..control import CacheController

            controller = CacheController(heat_bins=0)
        elif controller is not None and self._sharded:
            controller.attach(feature)
        self.controller = controller
        self._heat_bins = 0
        if (controller is not None and controller.wants_heat and self.collect_metrics
                and self._sharded and feature.shape):
            self._heat_bins = heat_num_bins(feature.shape[0], controller.heat_bins)
            self.metrics.gauge(
                FEATURE_ROW_HEAT, shape=(self._heat_bins,), unit="hits",
                doc="in-program per-row access-heat histogram (positional "
                    "bins over the store's translated row order, "
                    "mesh-total; feeds the controller's FreqSketch)",
            )
        self.caps = tuple(sampler._caps_for(self.local_batch))
        self.draw_fn = None
        self._bound_versions = self._current_versions()

    # -- telemetry views (over the metrics registry) ---------------------------

    @property
    def last_routed_overflow(self):
        """Registry metric ``feature.routed_overflow``: the step's
        fallback-served lanes of the routed lookups (``(steps,)`` after
        ``epoch_scan``; 0 when nothing routes)."""
        return self.metrics.value(ROUTED_OVERFLOW)

    @last_routed_overflow.setter
    def last_routed_overflow(self, value):
        self.metrics.set(ROUTED_OVERFLOW, value)

    @property
    def last_tier_hits(self):
        """Registry metric ``feature.tier_hits``: int32 (3,) per step
        ((steps, 3) after ``epoch_scan``), ``[replicated, hot, cold]``."""
        return self.metrics.value(TIER_HITS)

    @last_tier_hits.setter
    def last_tier_hits(self, value):
        self.metrics.set(TIER_HITS, value)

    @property
    def last_sample_overflow(self):
        """Registry metric ``sample.hop_overflow``: a topology-sharded
        sampler's per-hop fallback-served lanes, summed over the feature
        groups (``(steps, L)`` after ``epoch_scan``; zeros when the
        topology is replicated)."""
        return self.metrics.value(SAMPLE_OVERFLOW)

    @last_sample_overflow.setter
    def last_sample_overflow(self, value):
        self.metrics.set(SAMPLE_OVERFLOW, value)

    def metrics_report(self) -> str:
        """One-call text summary of the trainer's telemetry: every recorded
        registry metric (totals and the most recent per-step value) and
        the host StepTimeline's streaming percentiles."""
        return _metrics_report(
            self.metrics, self.timeline,
            "" if self.collect_metrics else "; collect_metrics=False",
        )

    def health(self) -> dict:
        """The ``/healthz`` summary: worker geometry, bound streaming
        versions, checkpoint progress, guard-trip count."""
        topo_v, feat_v = self._current_versions()
        return {
            "workers": int(self.workers),
            "global_batch": int(self.global_batch),
            "topology_version": topo_v,
            "feature_version": feat_v,
            "checkpoint_seq": int(self._ckpt_seq),
            "guard_trips": int(self._guard_trips_seen),
        }

    def serve_telemetry(self, host: str = "127.0.0.1", port: int = 0):
        """Start (and return) a live telemetry endpoint over this trainer:
        ``/metrics`` from its registry, ``/traces`` from its tracer,
        ``/healthz`` from :meth:`health`. It reads host-side snapshots
        only."""
        from ..obs.endpoint import TelemetryEndpoint

        return TelemetryEndpoint(
            metrics=self.metrics, tracer=self.tracer, health=self.health,
            host=host, port=port,
        ).start()

    # -- streaming-mutation versioning -------------------------------------------

    def _current_versions(self) -> tuple[int, int]:
        """(topology version, feature version) of the host state now."""
        return (
            int(getattr(self.sampler.csr_topo, "version", 0)),
            int(getattr(self.feature, "version", 0)),
        )

    def _check_versions(self) -> None:
        """Raise instead of training on a placement older than a committed
        mutation of the graph or the rows."""
        current = self._current_versions()
        if current != self._bound_versions:
            from ..core.topology import VersionMismatchError

            raise VersionMismatchError(
                f"trainer program is bound to (topology, feature) "
                f"versions {self._bound_versions} but the host state has "
                f"committed {current}; call trainer.refresh() to "
                f"re-capture the mutated state before training"
            )

    def refresh(self) -> "DistributedTrainer":
        """Re-place the sampler's topology from the mutated host CSR (its
        ``refresh_topology`` seam, when stale) and bind the trainer to the
        current versions. The mesh, the model, the optimizer state, the
        seed packing and the keys are untouched."""
        if int(getattr(self.sampler.csr_topo, "version", 0)) != \
                self.sampler._topo_version:
            self.sampler.refresh_topology()
        self._bound_versions = self._current_versions()
        return self

    # -- the step's halves --------------------------------------------------------

    def _params(self) -> list:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _tier_hits(self, n_id) -> torch.Tensor:
        """int32 (3,) valid lanes per tier ``[replicated, hot, cold]`` of
        a replicated store (its hot tier is JAX's second), on the device."""
        valid = n_id >= 0
        ids = n_id.clamp(min=0).to(torch.int64)
        order = getattr(self.feature, "feature_order", None)
        if order is not None:
            ids = order[ids]
        hot = ids < int(getattr(self.feature, "hot_rows", 0))
        return torch.stack([
            torch.zeros((), dtype=torch.int32, device=n_id.device),
            (valid & hot).sum(dtype=torch.int32),
            (valid & ~hot).sum(dtype=torch.int32),
        ])

    def _heat(self, n_id):
        """The row-heat histogram of one worker's frontier ids (int32
        ``(bins,)`` on the device, no host read), or None with the heat
        feed off."""
        if not self._heat_bins:
            return None
        return row_heat_histogram(n_id, self.feature.feature_order,
                                  self.sampler.csr_topo.node_count, self._heat_bins)

    def sample_block(self, seeds, num_seeds, key: int, draw_fn=None):
        """One worker's sample: the sampler's ``sample_padded`` on the
        padded device ``seeds`` (one K1 launch per hop, drawing from the
        worker key's sample stream, or from ``draw_fn(layer, deg)``).
        Returns ``(n_id, adjs)``."""
        gen = None if draw_fn is not None else seeded_generator(self.device, key, 0)
        n_id, _, adjs, _, _, _ = self.sampler.sample_padded(
            seeds, num_seeds, generator=gen, draw_fn=draw_fn)
        return n_id, adjs

    def _lookup(self, n_id):
        """``(rows, tier hits, routed overflow)`` of one lookup, on the
        device: a worker's ``(L,)`` frontier (a replicated store: one K2
        ``tiered_gather``, or ``tiered_gather_dequant`` for int8; a sharded
        store: the psum flavour), or a routed feature group's ``(F, L)``
        frontiers (hits per member)."""
        if not self._sharded:
            return (self.feature[n_id], self._tier_hits(n_id),
                    torch.zeros((), dtype=torch.int32, device=n_id.device))
        routed = n_id.dim() == 2
        hot = self.feature.hot
        cap = (None if not routed or hot is None or self.routed_alpha is None
               else hot.routed_cap(int(n_id.shape[1]), self.routed_alpha))
        return self.feature.lookup(n_id, routed=routed, cap=cap)

    def issue_block(self, seeds, num_seeds, key: int, draw_fn=None) -> IssuedBlock:
        """The schedule-movable half of one worker's block, when its lookup
        needs no other worker's ids (a replicated store, or a sharded
        store's psum flavour): :meth:`sample_block`, then the lookup of
        the frontier and its tier hits, all on the device."""
        n_id, adjs = self.sample_block(seeds, num_seeds, key, draw_fn)
        x, hits, _ = self._lookup(n_id)
        return IssuedBlock(n_id, x, adjs, num_seeds, hits, self._heat(n_id))

    def train_block(self, n_id, x, adjs, num_seeds, labels, key: int,
                    inject: bool = False):
        """The compute half of one worker's block: the planned NaN rows
        (written into a copy of ``x`` when ``inject``), the labels and the
        seed mask, the forward in training mode (dropout from the worker
        key's dropout stream) and the backward. Returns ``(loss, grads)``:
        the block's loss and the gradients of ``loss / workers`` (the
        worker's share of the step's mean; of the unscaled ``loss`` in
        elastic mode, which divides after its fixed-order sum), neither
        read back."""
        S = self.local_batch
        plan = self.fault_plan
        if inject and plan is not None and plan.injects_nan():
            if not x.is_floating_point():
                raise ValueError(
                    f"FaultPlan NaN injection needs float features, got {x.dtype}"
                )
            x = x.clone()
            x[:min(int(plan.nan_rows), int(x.shape[0]))] = float("nan")
        lab = labels[n_id[:S].clamp(min=0)]
        mask = torch.arange(S, device=n_id.device) < num_seeds
        self.model.train()
        logits = self.model(x, adjs, seeded_generator(self.device, key, 1))
        loss = cross_entropy_on_seeds(logits[:S], lab, mask)
        params = self._params()
        grads = torch.autograd.grad(loss if self.elastic else loss / self.workers,
                                    params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads

    def _worker_draw(self, key: int, w: int):
        return None if self.draw_fn is None else functools.partial(
            self.draw_fn, key, w)

    def _blocks(self, packed):
        """The step's per-worker ``(seeds, num_seeds)`` from its packed
        ``(workers * local_batch,)`` device row."""
        rows = packed.reshape(self.workers, self.local_batch)
        return [(r, (r >= 0).sum(dtype=torch.int32)) for r in rows]

    def _group_members(self) -> list:
        """Each feature group's members as logical workers, group by group
        and block by block: group ``g``'s block ``b`` pairs the slots ``g *
        F + i`` at their block ``b``, logical workers ``(g * F + i) *
        blocks_per_device + b``."""
        F, bpd = self.feature_size, self.blocks_per_device
        return [[(g * F + i) * bpd + b for i in range(F)]
                for g in range(self.data_size) for b in range(bpd)]

    def sample_group(self, blocks, members, key: int):
        """A feature group's sample over a topology-sharded sampler: its
        members' blocks together, one routed hop at a time
        (``sample_group``, no host read), worker ``w`` drawing from its
        worker key's sample stream (or ``draw_fn``). Returns ``(n_id (F,
        L), adjs with (F, 2, E) edge lists, per-hop overflow (L,))``."""
        seeds = torch.stack([blocks[w][0] for w in members])
        num = torch.stack([blocks[w][1] for w in members])
        # the step's one routing budget: the trainer's alpha caps the hops
        # as it caps the routed lookup
        if self.draw_fn is None:
            gens = [seeded_generator(self.device, fold_key(key, 1, w), 0) for w in members]
            out = self.sampler.sample_group(seeds, num, generators=gens,
                                            routed_alpha=self.routed_alpha)
        else:
            out = self.sampler.sample_group(seeds, num, draw_fn=lambda i, l, deg: (
                self.draw_fn(key, members[i], l, deg)), routed_alpha=self.routed_alpha)
        return out[0], out[2], out[6]

    def _issue(self, packed, key: int) -> IssuedStep:
        """The issue half of the step keyed ``key``: every worker's block,
        in worker order. With a routed lookup or a topology-sharded
        sampler each feature group samples its members' blocks first, then
        looks their frontiers up (at once when routed)."""
        blocks = self._blocks(packed)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.topo_sharded:
            return self._issue_groups(blocks, key)
        if not self._routed:
            return IssuedStep([self.issue_block(seeds, num, fold_key(key, 1, w),
                                                self._worker_draw(key, w))
                               for w, (seeds, num) in enumerate(blocks)], zero)
        issued, overflow = [None] * self.workers, zero
        for members in self._group_members():
            samples = [self.sample_block(*blocks[w], fold_key(key, 1, w),
                                         self._worker_draw(key, w)) for w in members]
            xs, hits, ov = self._lookup(torch.stack([n_id for n_id, _ in samples]))
            for i, (w, (n_id, adjs)) in enumerate(zip(members, samples)):
                issued[w] = IssuedBlock(n_id, xs[i], adjs, blocks[w][1], hits[i],
                                        self._heat(n_id))
            overflow = overflow + ov
        return IssuedStep(issued, overflow)

    def _issue_groups(self, blocks, key: int) -> IssuedStep:
        """:meth:`_issue` over a topology-sharded sampler: per feature
        group, :meth:`sample_group`, then the lookup of the members'
        frontiers (one routed lookup, or one per worker)."""
        issued = [None] * self.workers
        routed_ov = torch.zeros((), dtype=torch.int32, device=self.device)
        sample_ov = 0
        for members in self._group_members():
            n_id, adjs, hop_ov = self.sample_group(blocks, members, key)
            sample_ov = sample_ov + hop_ov
            if self._routed:
                xs, hits, ov = self._lookup(n_id)
                routed_ov = routed_ov + ov
            else:
                xs, hits, _ = zip(*(self._lookup(n_id[i]) for i in range(len(members))))
            for i, w in enumerate(members):
                issued[w] = IssuedBlock(
                    n_id[i], xs[i], [Adj(a.edge_index[i], None, a.size, a.fanout)
                                     for a in adjs], blocks[w][1], hits[i],
                    self._heat(n_id[i]))
        return IssuedStep(issued, routed_ov, sample_ov)

    def _train(self, issued: IssuedStep, labels, key: int, inject: bool):
        """The train half of a step over its issued blocks."""
        outs = [self.train_block(b.n_id, b.x, b.adjs, b.num_seeds, labels,
                                 fold_key(key, 1, w), inject)
                for w, b in enumerate(issued.blocks)]
        return self._update(outs, [b.tier_hits for b in issued.blocks],
                            issued.routed_overflow, issued.sample_overflow,
                            [b.heat for b in issued.blocks])

    def _run_step(self, packed, labels, key: int, inject: bool):
        """The serial step: the issue half, then the train half and the
        update, in worker order."""
        return self._train(self._issue(packed, key), labels, key, inject)

    def _update(self, outs, hits, routed_overflow, sample_overflow=None, heat=None):
        """Sum the workers' gradient shares into ``.grad`` in worker order
        (elastic mode: :func:`~..resilience.worker_ordered_mean` of the
        blocks' gradients and losses), take the guard's verdict before they
        mix (every worker's count), and step the optimizer. Returns ``(mean
        loss, the step's metrics dict)``, on the device: the tier hits (and
        the row heat, with the heat feed on) summed over the workers (a
        feature group's members share one lookup under the psum flavour,
        counted once), the routed overflow and the hops' overflow."""
        params = self._params()
        self.optimizer.zero_grad(set_to_none=True)
        bad = ([guard_verdict(loss, grads)[1] for loss, grads in outs]
               if self.nonfinite_guard else [])
        if self.elastic:
            stacked = [torch.stack(g) for g in zip(*(grads for _, grads in outs))]
            for p, g in zip(params, worker_ordered_mean(stacked, None, self.workers)):
                p.grad = g
            loss = worker_ordered_mean(torch.stack([o[0] for o in outs]), None,
                                       self.workers)
        else:
            for _, grads in outs:
                for p, g in zip(params, grads):
                    if p.grad is None:
                        p.grad = g
                    else:
                        p.grad.add_(g)
            loss = torch.stack([o[0] for o in outs]).mean()
        mtree = {}
        if self.collect_metrics:
            dev = loss.device
            mtree = {
                ROUTED_OVERFLOW: routed_overflow,
                TIER_HITS: torch.stack(hits).sum(0, dtype=torch.int32),
                SAMPLE_OVERFLOW: (torch.zeros((len(self.sampler.sizes),),
                                              dtype=torch.int32, device=dev)
                                  if sample_overflow is None else sample_overflow),
            }
            if self._heat_bins:
                mtree[FEATURE_ROW_HEAT] = torch.stack(heat).sum(0, dtype=torch.int32)
        if self.nonfinite_guard:
            total_bad = torch.stack(bad).sum(dtype=torch.int32)
            ok = total_bad == 0
            if self.collect_metrics:
                mtree[GUARD_NONFINITE] = total_bad
                mtree[GUARD_SKIPPED] = (~ok).to(torch.int32)
            guarded_update(self.optimizer, params, ok)
        else:
            self.optimizer.step()
        return loss, mtree

    # -- API -------------------------------------------------------------------

    def init(self, key):
        """Sample one block (the JAX package's ``init`` does, so the
        sampler's calls match its; over a topology-sharded sampler none,
        as there JAX's builds empty blocks), initialise the model's parameters from
        ``key`` (an int seeding a host generator, or a generator; flax's
        initialisers, :func:`~.train.init_model`, drawn on its device) and
        reset the optimizer's state. Returns ``(model, optimizer)``, in the
        place of JAX's ``(params, opt_state)``."""
        if not self.topo_sharded:
            n = self.sampler.csr_topo.node_count
            m = min(self.local_batch, n)
            padded = np.full(self.local_batch, -1, np.int32)
            padded[:m] = np.arange(m)
            self.sampler.sample_padded(torch.from_numpy(padded).to(self.device), m,
                                       generator=seeded_generator(self.device, 0))
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator().manual_seed(int(key))
        # Module.to moves each parameter's data in place: the optimizer
        # keeps its references
        init_model(self.model.to(gen.device), gen)
        self.model.to(self.device)
        self.optimizer.state = collections.defaultdict(dict)
        return self.model, self.optimizer

    def shard_seeds(self, seeds: np.ndarray):
        """Pack a global seed array into per-worker valid-prefix blocks,
        padded to ``(workers * local_batch,)`` with -1."""
        return shard_seed_blocks(seeds, self.workers, self.local_batch,
                                 "local_batch").reshape(-1)

    def _check_guard_trip(self) -> None:
        """Flight-recorder trigger: a guard trip (the guard skipped >= 1
        step since last checked) dumps a postmortem bundle naming the
        train stage. Reads the skip counter on the host."""
        if self.recorder is None or not self.nonfinite_guard:
            return
        snap = self.metrics.snapshot(GUARD_SKIPPED)
        total = int(snap.total()) if snap is not None else 0
        if total > self._guard_trips_seen:
            self._guard_trips_seen = total
            self.recorder.trigger(
                "nonfinite_guard", stage="train", skipped_total=total,
            )

    def step(self, seeds, labels, key: int):
        """One fused step. ``seeds``: the global seed array (host);
        ``labels``: the full ``(N,)`` label tensor; ``key``: the step's int
        seed. Returns the mean loss, on the device.

        After the call ``last_tier_hits`` holds the step's per-tier hits
        (int32 (3,)), and with the guard on the skip and non-finite
        counters hold its verdict. A planned preemption raises
        :class:`~..resilience.Preemption` after the step ran.

        Before the step, between batches: a sharded store with
        ``auto_split=True`` or a controller moves its L0/L1 boundary from
        the previous step's hits, the ``routed_alpha`` tuner reads the
        previous step's overflow, and the controller observes the seeds.
        After it, the controller folds in the step's row heat."""
        self._check_versions()
        feature = self.feature
        plan = self.fault_plan
        step_idx = self._fault_step
        self._fault_step += 1
        with self.tracer.span("train.step", trace=f"train.step.{step_idx}",
                              subsystem="trainer", step=step_idx), \
                self.timeline.stage("step"):
            if self._sharded and (feature.auto_split or feature._controller is not None):
                feature._maybe_auto_split()
            self._maybe_grow_routed_alpha()
            packed = self.shard_seeds(seeds)
            if self.controller is not None:
                # the host-visible ids of the step: they name repin rows
                self.controller.observe_ids(packed)
            packed = torch.from_numpy(packed).to(self.device)
            labels = torch.as_tensor(labels, device=self.device)
            inject = plan is not None and plan.nan_at(step_idx)
            loss, mtree = self._run_step(packed, labels, int(key), inject)
        self.metrics.record(mtree)
        self._check_guard_trip()
        if mtree and self._sharded:
            # the store's own view of the step's traffic, as after its lookups
            self.feature.last_tier_hits = mtree[TIER_HITS]
        if mtree and self.controller is not None:
            self.controller.observe_histogram(mtree.get(FEATURE_ROW_HEAT))
        if (plan is not None and not self._preempt_fired
                and plan.preempts_in(step_idx, step_idx + 1)):
            # the step ran but its results are lost with the raise: the
            # caller resumes from the last checkpoint, like a real kill
            self._preempt_fired = True
            raise Preemption(f"simulated preemption at step {step_idx}")
        return loss

    def pack_epoch(self, train_idx: np.ndarray, seed=None, key=None):
        """Shuffle ``train_idx`` and pack it into a ``(steps,
        workers * local_batch)`` seed matrix of per-worker valid-prefix
        blocks (-1 padded): the rows of :meth:`epoch_scan`. ``seed`` (or
        the legacy ``key``): an int, or an integer array whose last word
        is used, as the JAX package reads a raw key."""
        if seed is None:
            seed = key  # legacy name
        idx = np.asarray(train_idx)
        if seed is not None:
            if getattr(seed, "shape", ()) != ():
                seed = int(np.asarray(seed).ravel()[-1])
            idx = np.random.default_rng(int(seed)).permutation(idx)
        steps = -(-len(idx) // self.global_batch)
        return np.stack([
            self.shard_seeds(idx[s * self.global_batch: (s + 1) * self.global_batch])
            for s in range(steps)
        ])

    @staticmethod
    def step_key(key0: int, t: int) -> int:
        """The int seed of step ``t`` of the epoch keyed ``key0``: a
        function of the two alone, so a chunk or a resumed epoch draws the
        keys the whole epoch would."""
        return fold_key(key0, 0, t)

    def _run_chunk(self, packed, labels, key0: int, inject, lo: int, hi: int):
        """Steps ``[lo, hi)`` of the epoch; ``(losses, metrics dicts)``."""
        losses, mtrees = [], []
        keys = [self.step_key(key0, t) for t in range(lo, hi)]
        if not self.pipeline_depth:
            for t, k in zip(range(lo, hi), keys):
                loss, m = self._run_step(packed[t], labels, k, bool(inject[t]))
                losses.append(loss)
                mtrees.append(m)
            return losses, mtrees
        # the one-step skew: issue step t + 1, then train step t (the
        # prologue issues step lo; the last step issues nothing)
        batch = self._issue(packed[lo], keys[0])
        for i, t in enumerate(range(lo, hi)):
            nxt = self._issue(packed[t + 1], keys[i + 1]) if t + 1 < hi else None
            loss, m = self._train(batch, labels, keys[i], bool(inject[t]))
            losses.append(loss)
            mtrees.append(m)
            batch = nxt
        return losses, mtrees

    def _record_steps(self, mtrees) -> dict:
        """Land per-step metrics dicts as ``(steps, ...)`` stacks; returns
        the stacks."""
        if not (mtrees and mtrees[0]):
            return {}
        stacked = {name: torch.stack([m[name] for m in mtrees]) for name in mtrees[0]}
        self.metrics.record(stacked)
        return stacked

    def epoch_scan(self, seed_mat, labels, key: int, epoch: int = 0,
                   start_step: int = 0):
        """A whole epoch over the packed seed matrix, step after step with
        no host read (but the guard's verdict, when on).

        Returns the ``(steps - start_step,)`` float32 losses, on the
        device: the caller reads them once. ``last_tier_hits`` holds the
        per-step hits (int32 ``(steps, 3)``).

        With ``checkpoint_dir=``/``checkpoint_every=`` the epoch runs in
        chunks of ``checkpoint_every`` steps, with an asynchronous save
        after each (the state is copied to the host at the save, so the
        next step cannot race it). ``start_step``/``epoch`` replay a
        resumed epoch: pass the same seed matrix (``pack_epoch`` with the
        same seed) and the key :meth:`resume` returned, and the remaining
        steps draw what the uninterrupted run drew. A ``fault_plan`` with
        ``preempt_at_step`` raises :class:`~..resilience.Preemption` once
        that step's chunk has run but before its checkpoint lands.
        ``pipeline_depth=1`` runs the one-step skew with the same chunking
        and resume semantics; each chunk after the first issues its first
        batch again (``train.pipeline_reissues``).

        The split is frozen for the epoch: before it, a sharded store with
        a controller moves its boundary, the ``routed_alpha`` tuner reads
        the last overflow and the controller observes the seed matrix;
        after it, the controller folds in the epoch's heat, the store gets
        the epoch's summed tier hits, and ``controller.end_epoch`` may
        ``repin`` the store (and ``refresh()`` this trainer).
        """
        self._check_versions()
        steps = int(np.shape(seed_mat)[0])
        start = int(start_step)
        key = int(key)
        if not 0 <= start <= steps:
            raise ValueError(
                f"start_step {start} outside [0, {steps}] for a "
                f"{steps}-step epoch"
            )
        plan = self.fault_plan
        losses, mtrees = [], []
        # the epoch trace id is deterministic: a preempted run's resume
        # records its chunks under the same id
        etrace = self.tracer.trace(f"train.epoch.{int(epoch)}")
        with self.timeline.stage("epoch_scan"):
            if self._sharded and self.feature._controller is not None:
                self.feature._maybe_auto_split()
            self._maybe_grow_routed_alpha()
            if self.controller is not None:
                self.controller.observe_ids(np.asarray(seed_mat))
            packed = torch.from_numpy(np.asarray(seed_mat, np.int32)).to(self.device)
            labels = torch.as_tensor(labels, device=self.device)
            if plan is not None and plan.injects_nan():
                inject = plan.nan_mask(steps)
            else:
                inject = np.zeros(steps, dtype=bool)
            chunk = (self.checkpoint_every if self.checkpointer is not None
                     else max(steps - start, 1))
            lo = start
            while lo < steps:
                hi = min(lo + chunk, steps)
                t0 = self.tracer.now() if self.tracer.enabled else 0.0
                chunk_losses, chunk_m = self._run_chunk(packed, labels, key,
                                                        inject, lo, hi)
                # dispatch-timed: the device may still be running
                self.tracer.record(
                    "train.chunk", t0, self.tracer.now() - t0,
                    trace=etrace, subsystem="trainer", epoch=int(epoch),
                    start_step=lo, steps=hi - lo,
                    pipeline_depth=self.pipeline_depth,
                )
                if self.pipeline_depth and lo > start:
                    # this chunk issued its first batch again (the previous
                    # chunk's last step had not issued it)
                    self._pipeline_reissues += 1
                    self.metrics.set(PIPELINE_REISSUES,
                                     np.int32(self._pipeline_reissues))
                    self.tracer.event("train.reissue", trace=etrace,
                                      subsystem="trainer", step=lo)
                losses.extend(chunk_losses)
                mtrees.extend(chunk_m)
                if (plan is not None and not self._preempt_fired
                        and plan.preempts_in(lo, hi)):
                    # the chunk ran but dies un-checkpointed; its telemetry
                    # lands first, so the guard trips that explain the
                    # preempted run reach the registry and the recorder
                    self._preempt_fired = True
                    self._record_steps(mtrees)
                    self._check_guard_trip()
                    self.tracer.event("train.preempt", trace=etrace,
                                      subsystem="trainer",
                                      step=plan.preempt_at_step)
                    if self.recorder is not None:
                        self.recorder.note("preemption", epoch=int(epoch),
                                           step=int(plan.preempt_at_step))
                    raise Preemption(
                        f"simulated preemption at step "
                        f"{plan.preempt_at_step}: chunk [{lo}, {hi}) lost "
                        f"(last checkpoint at step {lo})"
                    )
                if self.checkpointer is not None:
                    self._save_checkpoint(key, epoch, hi, steps_per_epoch=steps,
                                          trace=etrace)
                lo = hi
        stacked = self._record_steps(mtrees)
        self._check_guard_trip()
        if self.controller is not None:
            # the epoch's boundary: its heat into the sketch, its summed
            # tier hits to the store's split tuner, then a possible repin
            if stacked:
                self.controller.observe_histogram(stacked.get(FEATURE_ROW_HEAT))
                if self._sharded and TIER_HITS in stacked:
                    self.feature.last_tier_hits = stacked[TIER_HITS].sum(0).cpu().numpy()
            if self._sharded:
                self.controller.end_epoch(self.feature, self)
        if not losses:  # start == steps: a resumed, already-finished epoch
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.stack(losses)

    # -- checkpoint / resume ------------------------------------------------------

    def _save_checkpoint(self, key: int, epoch: int, step: int,
                         steps_per_epoch: int | None = None,
                         trace: str | None = None) -> None:
        """Asynchronous atomic save between chunks: the model's and the
        optimizer's state dicts, ``step`` (completed rows of the current
        epoch's seed matrix), ``epoch`` and the epoch's int ``key``, with
        the JAX package's manifest metadata (what :meth:`resume`
        validates)."""
        state = {
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            # Python ints: 0-d int64 leaves, restored as the same ints
            "step": int(step),
            "epoch": int(epoch),
            "key": int(key),
        }
        meta = {
            "mesh": {DATA_AXIS: int(self.data_size),
                     FEATURE_AXIS: int(self.feature_size)},
            "workers": int(self.workers),
            "local_batch": int(self.local_batch),
            "seed_sharding": self.seed_sharding,
            "elastic": bool(self.elastic),
            "epoch": int(epoch),
            "step": int(step),
        }
        if steps_per_epoch is not None:
            meta["steps_per_epoch"] = int(steps_per_epoch)
        self.checkpointer.save(self._ckpt_seq, state, metadata=meta, trace=trace)
        self._ckpt_seq += 1

    def resume(self, checkpoint_step: int | None = None, mesh: Mesh | None = None):
        """Restore the newest VALID checkpoint, if any, into the model and
        the optimizer.

        Waits for in-flight saves first. ``checkpoint_step`` pins one
        checkpoint (the checkpointer's sequence id) instead; a pinned one
        that fails verification raises ``CorruptCheckpoint``. A corrupt
        or half-written newest checkpoint is quarantined and the newest
        valid one restores instead. The manifest metadata is checked
        against this trainer (:func:`~..resilience.validate_resume_meta`);
        a checkpoint of another mesh shape needs ``mesh=``.

        Elastic resume (``mesh=``): restore onto another mesh shape. The
        writing trainer must have been elastic (``logical_workers=``) and
        so must this one; it re-plans in place (:meth:`_replan`): the
        topology-sharded sampler and the sharded store re-partition onto
        the new mesh, and each slot runs ``logical_workers / slots``
        blocks. A trainer built afresh on the new mesh (the process-death
        flow) passes its own mesh, ``resume(mesh=trainer.mesh)``. Regenerate
        the same seed matrix (``pack_epoch`` with the same seed) and call
        ``epoch_scan(..., key, epoch=epoch, start_step=step)``: the
        remaining steps are the uninterrupted run's, bitwise.

        Returns ``(model, optimizer, key, step, epoch)``: the JAX tuple
        with the restored model and optimizer in place of ``(params,
        opt_state)`` and the saved epoch's int key; feed ``key``, ``epoch``
        and ``start_step=step`` back to :meth:`epoch_scan`. With no
        checkpoint on disk: ``(model, optimizer, None, 0, 0)``, untouched.
        """
        if self.checkpointer is None:
            raise ValueError(
                "resume() needs checkpointing enabled "
                "(checkpoint_dir=/checkpoint_every= at construction)"
            )
        self.checkpointer.wait_until_finished()
        if checkpoint_step is None:
            latest = self.checkpointer.latest_valid_step()
            if latest is None:
                return self.model, self.optimizer, None, 0, 0
        else:
            latest = int(checkpoint_step)
        meta = self.checkpointer.metadata(latest)
        target = self.mesh if mesh is None else mesh
        target_shape = {DATA_AXIS: int(target.shape[DATA_AXIS]),
                        FEATURE_AXIS: int(target.shape[FEATURE_AXIS])}
        saved_mesh = meta.get("mesh")
        if (saved_mesh is not None and mesh is None
                and dict(saved_mesh) != target_shape):
            raise ValueError(
                f"checkpoint was written on mesh {dict(saved_mesh)} but "
                f"this trainer's mesh is {target_shape}; pass "
                f"resume(mesh=) to opt into the elastic restore (requires "
                f"logical_workers= on the writing trainer)"
            )
        validate_resume_meta(
            meta, mesh_shape=target_shape, workers=self.workers,
            local_batch=self.local_batch,
        )
        if mesh is not None and mesh is not self.mesh:
            self._replan(mesh)
        state = self.checkpointer.restore(latest)
        step = int(state["step"])
        spe = meta.get("steps_per_epoch")
        if spe is not None and not 0 <= step <= int(spe):
            raise ValueError(
                f"restored step {step} is outside [0, {int(spe)}] for the "
                f"saved epoch — the checkpoint directory does not belong "
                f"to this run's seed packing"
            )
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        return (self.model, self.optimizer, int(state["key"]), step,
                int(state["epoch"]))

    def _replan(self, mesh: Mesh) -> None:
        """Re-plan the trainer onto another mesh shape (an elastic resume).

        The logical worker count stays (seed packing, block keys and the
        fixed-order reduction follow it); what changes is how many blocks
        each slot runs. A topology-sharded sampler and a sharded store
        re-partition through their ``replan`` (same bytes, new owners), an
        attached controller is attached to the re-placed store again, and
        the trainer binds to the current versions."""
        if not self.elastic:
            raise ValueError(
                "resume(mesh=) needs an elastic trainer: construct with "
                "logical_workers=<the writing run's worker count> so the "
                "step reduction is mesh-shape independent"
            )
        dev_workers = int(mesh.shape[DATA_AXIS]) * int(mesh.shape[FEATURE_AXIS])
        if dev_workers < 1 or self.workers % dev_workers:
            raise ValueError(
                f"cannot re-plan {self.workers} logical workers onto "
                f"{dev_workers} devices (must divide evenly)"
            )
        device = _one_device(mesh)
        old = (int(self.data_size), int(self.feature_size))
        self.mesh = mesh
        self.device = device
        self.data_size = mesh.shape[DATA_AXIS]
        self.feature_size = mesh.shape[FEATURE_AXIS]
        self._device_workers = dev_workers
        self.blocks_per_device = self.workers // dev_workers
        if self.topo_sharded:
            self.sampler.replan(mesh)
        if self._sharded:
            self.feature.replan(mesh)
            if self.controller is not None and self.feature._controller is self.controller:
                self.controller.attach(self.feature)
        info_once(
            "trainer-elastic-replan",
            "elastic replan: mesh (data=%d, feature=%d) -> (data=%d, "
            "feature=%d); %d logical workers now run %d block(s)/device "
            "(trajectory stays bit-identical — fixed-order reduction)",
            old[0], old[1], int(self.data_size), int(self.feature_size),
            self.workers, self.blocks_per_device,
        )
        self._bound_versions = self._current_versions()


    def _maybe_grow_routed_alpha(self) -> None:
        """The shared routing tuner, between batches: the routed lookup and
        a topology-sharded sampler's hops draw on one ``routed_alpha``, so
        the controller's :class:`~..control.AlphaTuner` reads both overflow
        counts of the previous step (host reads). Overflow doubles alpha
        (up to F, the uncapped buckets); a run of clean steps halves it.
        Overflowed lanes were served exactly either way."""
        if self.controller is None or self.routed_alpha is None:
            return
        total = 0
        for v in (self.last_routed_overflow, self.last_sample_overflow):
            if v is not None:
                total += int(v.sum())
        new = self.controller.decide_alpha(total, self.routed_alpha, float(self.feature_size))
        if new is None:
            return
        old = self.routed_alpha
        self.routed_alpha = float(new)
        get_logger().info(
            "shared routing budget: %d lanes fallback-served last batch "
            "(feature gather + sampler hops); alpha %.2f -> %.2f",
            total, old, self.routed_alpha,
        )
        self.last_routed_overflow = None
        self.last_sample_overflow = None


class DataParallelTrainer:
    """Unfused data-parallel training: host-driven sample and gather with
    prefetch overlap, one model step per group of D worker blocks.

    Args:
      mesh: a :class:`~.mesh.Mesh` with ``feature == 1``; its ``data``
        axis gives D workers, all on one device.
      sampler: any sampler (``GraphSageSampler`` or a wrapper of one).
      feature: a replicated feature store (``Feature`` or a wrapper).
      model: the torch model (its parameters on the mesh's device).
      optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters,
        in the place of JAX's optax transformation.
      local_batch: seeds per worker block.
      prefetch_retries, prefetch_backoff, prefetch_skip_policy: the epoch
        loop's :class:`~.pipeline.Prefetcher` knobs (bounded retry of
        transient sample or gather faults, then raise or skip).

    ``metrics`` and ``timeline`` receive the Prefetcher's counters and
    stages; :meth:`metrics_report` prints them.
    """

    def __init__(
        self,
        mesh: Mesh,
        sampler,
        feature,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        local_batch: int = 128,
        prefetch_retries: int = 0,
        prefetch_backoff: float = 0.05,
        prefetch_skip_policy: str = "raise",
    ):
        policy = getattr(feature, "cache_policy", CachePolicy.DEVICE_REPLICATE)
        if policy is not CachePolicy.DEVICE_REPLICATE:
            raise ValueError(
                "DataParallelTrainer replicates the feature store; use the "
                "fused DistributedTrainer for mesh-sharded hot tiers"
            )
        if mesh.shape.get(FEATURE_AXIS, 1) != 1:
            raise ValueError(
                "DataParallelTrainer is pure data parallelism; build the "
                "mesh with feature=1"
            )
        workers = list(mesh.devices[:, 0])
        if len(set(workers)) > 1:
            raise NotImplementedError(
                f"the mesh's data workers sit on {len(set(workers))} devices; "
                "training across distinct devices is not ported yet "
                "(ROADMAP A.11e)"
            )
        self.mesh = mesh
        self.device = workers[0]
        self.sampler = sampler
        self.feature = feature
        self.model = model
        self.optimizer = optimizer
        self.local_batch = int(local_batch)
        self.data_size = mesh.shape[DATA_AXIS]
        self.global_batch = self.local_batch * self.data_size
        # the epoch loop's Prefetcher lands its retry and skip counters
        # here, readable beside the stage timeline (metrics_report)
        self.metrics = MetricsRegistry()
        self.timeline = StepTimeline()
        self.prefetch_retries = int(prefetch_retries)
        self.prefetch_backoff = float(prefetch_backoff)
        self.prefetch_skip_policy = str(prefetch_skip_policy)
        self._pin_auto_caps()

    def _pin_auto_caps(self):
        """Plan auto frontier caps once, from a probe batch, and freeze
        them: later skewed batches are clipped and their overflow reported
        (the fixed-caps behaviour) instead of regrowing the caps mid-epoch,
        which would make the workers' blocks disagree on shapes. The probe
        advances the sampler's call counter by one."""
        if not getattr(self.sampler, "_auto_caps", False):
            return
        n = self.sampler.csr_topo.node_count
        self.sampler.sample(np.arange(min(self.local_batch, n)))
        self.sampler._auto_caps = False
        get_logger().info(
            "auto frontier caps planned from a probe batch and PINNED at "
            "%s for the epoch loop (mid-epoch replanning would make "
            "stacked blocks disagree; overflowing batches are clipped and "
            "reported instead)",
            self.sampler._frontier_caps,
        )

    def _adj_sizes(self, caps) -> list[tuple[int, int]]:
        """Static Adj sizes, deepest layer first (the sampler's order)."""
        sizes = []
        prev = self.local_batch
        for cap in caps:
            sizes.append((cap, prev))
            prev = cap
        return sizes[::-1]

    # -- API ----------------------------------------------------------------

    def metrics_report(self) -> str:
        """One-call telemetry summary (the epoch loop's prefetch retry and
        skip counters and the host stage timeline)."""
        return _metrics_report(self.metrics, self.timeline)

    def init(self, generator: torch.Generator) -> torch.nn.Module:
        """Sample and gather one block (as the JAX package's ``init``
        does, so the sampler's and the store's call counts match its),
        initialise the model's parameters from ``generator`` (flax's
        initialisers, :func:`~.train.init_model`, drawn on the generator's
        device, so a host generator gives every device the same
        parameters) and reset the optimizer's state. Returns the model."""
        n = self.sampler.csr_topo.node_count
        out = self.sampler.sample(np.arange(min(self.local_batch, n)))
        self.feature[out.n_id]
        # Module.to moves each parameter's data in place: the optimizer
        # keeps its references
        init_model(self.model.to(generator.device), generator)
        self.model.to(self.device)
        self.optimizer.state = collections.defaultdict(dict)
        return self.model

    def seed_blocks(self, seeds: np.ndarray):
        """Split a global seed array into per-worker blocks
        (``train_idx.split(world_size)[rank]``)."""
        blocks = np.array_split(np.asarray(seeds), self.data_size)
        for b in blocks:
            if len(b) > self.local_batch:
                raise ValueError(
                    f"block {len(b)} exceeds local_batch {self.local_batch}"
                )
        return blocks

    def _stack(self, batches):
        """The blocks' per-layer metadata, read off their own Adjs: caps in
        sizes order (seeds outward, what :meth:`_adj_sizes` takes) and
        fanouts deepest-first. Every block must agree (one process runs
        the blocks in turn and stacks nothing)."""
        caps = fanouts = None
        for b in batches:
            c = tuple(a.size[0] for a in b.out.adjs[::-1])
            f = tuple(a.fanout for a in b.out.adjs)
            if caps is None:
                caps, fanouts = c, f
            elif c != caps or f != fanouts:
                # unreachable for trainer-owned samplers (_pin_auto_caps
                # froze the plan); guards externally mutated samplers
                raise ValueError(
                    "sampled blocks disagree on frontier caps/fanouts "
                    f"({caps}/{fanouts} vs {c}/{f}); pin frontier_caps on "
                    "the sampler (auto caps may replan between blocks)"
                )
        return caps, fanouts

    def step(self, batches, labels, generator: torch.Generator | None = None):
        """One data-parallel step from D batches (``Batch`` or anything
        with ``.out`` and ``.x``), worker ``w``'s first. ``labels`` is the
        full ``(N,)`` label tensor on the mesh's device.

        Worker ``w``'s loss is the masked NLL of its block's first
        ``local_batch`` rows: lanes past the block's true ``batch_size``
        hold frontier nodes of a short block and are masked out, as are
        ``-1`` seeds. Dropout draws from a generator derived from
        ``generator``'s seed and ``w`` (JAX's ``fold_in(key, w)``; like a
        key, ``generator`` is read, not advanced). The gradient is the
        mean of the workers' (JAX's ``pmean``), then one optimizer step.
        Returns the mean of the workers' losses, on the device (no host
        sync)."""
        if len(batches) != self.data_size:
            raise ValueError(
                f"need {self.data_size} batches (one per data shard), "
                f"got {len(batches)}"
            )
        caps, fanouts = self._stack(batches)
        adj_sizes = self._adj_sizes(caps)
        S, dev = self.local_batch, self.device
        labels = torch.as_tensor(labels, device=dev)
        lanes = torch.arange(S, device=dev)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        losses = []
        for w, b in enumerate(batches):
            adjs = [Adj(a.edge_index, None, sz, fanout=f)
                    for a, sz, f in zip(b.out.adjs, adj_sizes, fanouts)]
            seed_ids = b.out.n_id[:S]
            lab = labels[seed_ids.clamp(min=0)]
            mask = (lanes < b.out.batch_size) & (seed_ids >= 0)
            g = (None if generator is None
                 else seeded_generator(dev, generator.initial_seed(), w))
            loss = cross_entropy_on_seeds(self.model(b.x, adjs, g)[:S], lab, mask)
            (loss / self.data_size).backward()
            losses.append(loss.detach())
        self.optimizer.step()
        return torch.stack(losses).mean()

    def _epoch_blocks(self, train_idx: np.ndarray, rng) -> list:
        """The epoch's worker blocks: ``steps`` global batches of a
        permutation of ``train_idx`` (at least one, short if it must), each
        split into D blocks."""
        perm = rng.permutation(len(train_idx))
        steps = max(len(train_idx) // self.global_batch, 1)
        blocks = []
        for s in range(steps):
            chunk = train_idx[perm[s * self.global_batch:(s + 1) * self.global_batch]]
            blocks.extend(self.seed_blocks(chunk))
        return blocks

    def _serial(self, blocks):
        """The blocks' batches on the caller's thread, one after another
        (``depth=0``: no Prefetcher, so no retries)."""
        for seeds in blocks:
            out = self.sampler.sample(seeds)
            yield Batch(seeds, out, self.feature[out.n_id])

    def train_epoch(self, train_idx, labels, generator: torch.Generator,
                    rng=None, depth: int = 2):
        """One epoch: the JAX package's permutation (``rng``, default
        ``np.random.default_rng(0)``) and blocking, so the blocks are
        bitwise its blocks for the same ``rng``; sample and gather for the
        next steps run on the Prefetcher's worker (``depth`` batches ahead,
        with the trainer's retry knobs, ``timeline`` and ``metrics``)
        while the current step computes; ``depth=0`` runs them serially.
        Step ``i``'s dropout generator is derived from ``generator``'s seed
        and ``i`` (pass a fresh generator per epoch, as JAX passes a fresh
        key). The host reads the losses once, at the end.

        Returns ``(mean_loss, num_steps)``.
        """
        rng = rng or np.random.default_rng(0)
        train_idx = np.asarray(train_idx)
        if train_idx.size == 0:
            # a silent NaN mean loss poisons every downstream consumer
            # (schedulers, early stopping, logs): fail loudly
            raise ValueError(
                "train_epoch got an empty seed set (train_idx) — nothing "
                "to train on; check the split/filter that produced it"
            )
        blocks = self._epoch_blocks(train_idx, rng)
        labels = torch.as_tensor(labels, device=self.device)
        if depth > 0:
            batches = Prefetcher(
                self.sampler, self.feature, depth=depth,
                retries=self.prefetch_retries, backoff=self.prefetch_backoff,
                skip_policy=self.prefetch_skip_policy,
                timeline=self.timeline, metrics=self.metrics,
            ).run(blocks)
        else:
            batches = self._serial(blocks)
        seed = generator.initial_seed()
        losses, group = [], []
        for batch in batches:
            group.append(batch)
            if len(group) == self.data_size:
                sub = seeded_generator("cpu", seed, len(losses))
                losses.append(self.step(group, labels, sub))
                group = []
        if not losses:
            return float("nan"), 0
        return float(torch.stack(losses).mean()), len(losses)
