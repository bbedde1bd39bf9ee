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

On a logical mesh every data worker runs in this process, in worker
order, each on its slot's device, and the gradient is the workers' mean.
Its slots may repeat one device or sit on distinct devices (cards, or a
card and the host): a worker's sample, lookup, forward and backward run on
its slot's device, over the sampler's and the store's parts or copies
there and one replica of the model per distinct device; its loss, its
gradients and its counters move to the lead device (``devices.flat[0]``),
where they are reduced in the same worker order as on one device, the
optimizer steps and the tuners decide; the replicas take the lead's
parameters before every step. On a mesh of one repeated device nothing
moves and the step is what it was. On a world mesh
(``parallel/mesh.py`` ``WorldMesh``: one process per slot over
``torch.distributed``) each rank runs its own worker (its own blocks, in
elastic mode), and the sums that the logical mesh's loop makes
(gradients, loss, metrics, the guard's count) run over the rank's process
groups (``parallel/world.py``), so every rank's step is bitwise the
logical mesh's. :class:`DistributedTrainer`'s elastic mode
(``logical_workers=``) fixes the worker count apart from the mesh and
reduces in logical-worker order, so ``resume(mesh=)`` continues a run on
another mesh shape bitwise, and a fresh world of another size continues a
checkpoint of the old one; on a world rank 0 alone writes the
checkpoints and chooses the step that every rank restores.
"""

from __future__ import annotations

import collections
import copy
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..control.freq import heat_num_bins, row_heat_histogram
from ..core.config import CachePolicy, parse_size_bytes
from ..feature.shard import ShardedFeature
from ..obs.marks import collective
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
from . import world
from .mesh import (DATA_AXIS, FEATURE_AXIS, Mesh, is_world, lead_device, mesh_devices,
                   shard_seed_blocks)
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


def _check_placeable(mesh: Mesh, sampler, feature, replanning: bool = False) -> bool:
    """Whether ``mesh`` is one device (repeated); over distinct devices,
    check that the sampler and the store can run on each (a replicated
    sampler's ``placed_on``, a replicated store's ``replica``, a sharded
    store over the same devices, unless it is being re-planned onto
    ``mesh``) and raise ``ValueError`` if not."""
    if len(mesh_devices(mesh)) == 1:
        return True
    if (getattr(sampler, "topo_sharding", "replicated") != "mesh"
            and not hasattr(sampler, "placed_on")):
        raise ValueError(
            f"a mesh of distinct devices ({mesh_devices(mesh)}) needs a sampler that "
            f"places its topology per device (GraphSageSampler); got {type(sampler).__name__}")
    if isinstance(feature, ShardedFeature):
        if (not replanning
                and feature.mesh.devices.ravel().tolist() != mesh.devices.ravel().tolist()):
            raise ValueError(
                f"the ShardedFeature's devices {feature.mesh.devices.tolist()} are not "
                f"the trainer mesh's {mesh.devices.tolist()}")
    elif not hasattr(feature, "replica"):
        raise ValueError(
            f"a mesh of distinct devices ({mesh_devices(mesh)}) needs a store that "
            f"places itself per device (Feature, ShardedFeature); got "
            f"{type(feature).__name__}")
    return False


class _Replicas:
    """One replica of a model per distinct device of a mesh besides the
    lead's, which holds the model itself: each made at its device's first
    use, and each given the lead's parameters and buffers by
    :meth:`refresh`."""

    def __init__(self, model: torch.nn.Module, lead: torch.device):
        self.model, self.lead, self.copies = model, lead, {}

    def on(self, device) -> torch.nn.Module:
        if device == self.lead:
            return self.model
        rep = self.copies.get(device)
        if rep is None:
            rep = self.copies[device] = copy.deepcopy(self.model).to(device)
        return rep

    def refresh(self) -> None:
        if not self.copies:
            return
        src = list(self.model.state_dict().values())
        with torch.no_grad():
            for rep in self.copies.values():
                for dst, t in zip(rep.state_dict().values(), src):
                    dst.copy_(t)


def _flat_by_dtype(tensors) -> tuple[list, list]:
    """``(index lists, one flat buffer per dtype)`` of ``tensors``: the
    collectives of a gradient move one buffer per dtype."""
    by_dtype: dict = {}
    for i, g in enumerate(tensors):
        by_dtype.setdefault(g.dtype, []).append(i)
    idxs = list(by_dtype.values())
    return idxs, [torch.cat([tensors[i].reshape(-1) for i in idx]) for idx in idxs]


def _unflatten(flats, idxs, like) -> list:
    """The tensors of :func:`_flat_by_dtype`'s buffers, shaped as ``like``."""
    out = [None] * len(like)
    for idx, flat in zip(idxs, flats):
        for i, part in zip(idx, flat.split([like[i].numel() for i in idx])):
            out[i] = part.view_as(like[i])
    return out


def _ordered_grads(grads, group, axes) -> list:
    """Each gradient summed over the world ``group`` in member order:
    one flat buffer, so one collective, per dtype; bitwise the logical
    mesh's accumulation of the workers' gradients. The fold holds the
    group's W flat buffers at once."""
    idxs, flats = _flat_by_dtype(grads)
    return _unflatten([world.ordered_sum(f, group, axes, mark=False) for f in flats],
                      idxs, grads)


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
      mesh: a :class:`~.mesh.Mesh`: its slots on one device (repeated) or
        on distinct devices (see below), or a world mesh.
      sampler: a ``GraphSageSampler`` (placed on each device a worker
        samples on, :meth:`~..sampling.sampler.GraphSageSampler.placed_on`),
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
      model: the torch model, its parameters on the mesh's lead device
        (``devices.flat[0]``).
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

    On a world mesh (``WorldMesh``, one process per slot) the rank runs
    one worker, ``w = rank`` under ``"all"`` and its data row under
    ``"data"`` (in elastic mode its blocks, logical workers ``rank *
    blocks_per_device + b``): its blocks of the same seed packing, its
    keys, its sample (over its own replicated topology, or its own shard
    of a topology-sharded sampler's, routed over its feature group) and
    its lookup (the psum or the routed flavour over its feature group);
    the gradients (one flat buffer per dtype), the loss, the metrics and
    the guard's count are summed over its process groups
    (``parallel/world.py``; elastic mode gathers the blocks' values over
    the world, :func:`~..resilience.worker_ordered_mean`), so the step is
    bitwise the logical mesh's of the same shape. With ``checkpoint_dir=``
    rank 0 alone writes; every rank reads the same directory (see
    :meth:`resume`). The controller and ``auto_alpha`` run on every rank
    and decide from world-identical inputs: the global seeds (every rank
    packs the whole array), the row heat, the tier hits and the overflow
    counts, each summed over the world before a rank reads it. So every
    rank moves the same boundary, picks the same alpha and repins the same
    rows, and the shapes of the next collectives agree.

    On a logical mesh of distinct devices (``make_mesh(devices=["cuda:0",
    "cuda:1"])``, or a card and the host) worker ``w`` runs on its slot's
    device (under ``"all"`` slot ``w // blocks_per_device``, under
    ``"data"`` the first slot of its data row): its seeds, its sample (over
    the sampler's placement there, drawing from that device's generators),
    its lookup (a replicated store's :meth:`~..feature.feature.Feature.replica`
    there; a sharded store's psum flavour served by each shard on its own
    member's device and summed on the worker's), its forward and backward
    (on that device's replica of the model). A feature group's joint work
    (a routed lookup, a topology-sharded sample) runs on the device of its
    first member, each owner serving on its own; its rows and frontiers
    then move to each member's device. Losses, gradients, tier hits,
    overflows, row heat and the guard's counts move to the lead device and
    are reduced there in worker order, so on a mesh of one repeated device
    the step is bitwise what it was; the replicas take the lead's
    parameters before each step (after every optimizer step, and after a
    caller loads a state into the model).

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
        device = lead_device(mesh)
        self._single = _check_placeable(mesh, sampler, feature)
        self.world = is_world(mesh)
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
        if self._sharded and (feature.mesh.shape != mesh.shape
                              or is_world(feature.mesh) != self.world):
            raise ValueError(
                f"the ShardedFeature's mesh {feature.mesh!r} is not the "
                f"trainer's {mesh!r} (shape and form must agree)"
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
        self.checkpointer = None
        self._ckpt_seq = 0
        if checkpoint_dir is not None:
            self._open_checkpoints(mesh, checkpoint_dir, checkpoint_keep)
        self.timeline = StepTimeline()
        self.mesh = mesh
        self.device = device
        self.sampler = sampler
        self.feature = feature
        self.model = model
        self._replicas = _Replicas(model, device)
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
        self._held = self._held_workers()
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

    def _worker_device(self, w: int) -> torch.device:
        """The device worker ``w`` runs on, as the mesh lists it: its
        slot's (``"all"``: slot ``w // blocks_per_device``; ``"data"``: the
        first slot of data row ``w``); on a world mesh, the rank's."""
        if self.seed_sharding == "all":
            return self.mesh.devices.flat[w // self.blocks_per_device]
        return self.mesh.devices[w, 0]

    def _held_workers(self) -> list:
        """The workers this process runs, in turn: every one on a logical
        mesh; on a world mesh the rank's own (its data row under
        ``"data"``; its ``blocks_per_device`` logical workers under
        ``"all"``)."""
        if not self.world:
            return list(range(self.workers))
        d, f = self.mesh.slot
        if self.seed_sharding != "all":
            return [d]
        slot = d * self.feature_size + f
        return [slot * self.blocks_per_device + b for b in range(self.blocks_per_device)]

    def _open_checkpoints(self, mesh, directory, keep: int) -> None:
        """The checkpointer and the next save id (monotonic over a
        pre-existing run directory). On a world mesh rank 0 opens the
        directory (creating it) and alone writes; after a barrier every
        other rank opens it read-only, and every rank raises when any
        cannot see it (a rank never starts afresh alone); rank 0's next
        save id is shared."""
        from ..utils.checkpoint import Checkpointer

        if not is_world(mesh):
            self.checkpointer = Checkpointer(directory, max_to_keep=keep, tracer=self.tracer)
            latest = self.checkpointer.latest_step()
            self._ckpt_seq = 0 if latest is None else latest + 1
            return
        writer = mesh.rank == 0
        if writer:
            self.checkpointer = Checkpointer(directory, max_to_keep=keep, tracer=self.tracer)
        world.barrier(mesh)
        seen = torch.tensor([int(os.path.isdir(directory))], device=mesh.device)
        axes = mesh.axis_names
        blind = [r for r, v in enumerate(
            world.all_gather(seen, mesh.group(axes), axes, mark=False).reshape(-1).tolist())
            if not v]
        if blind:
            raise FileNotFoundError(
                f"checkpoint_dir {os.path.abspath(directory)!r} is not visible to rank(s) "
                f"{blind}: every rank reads rank 0's checkpoints, so the directory must "
                "be on a file system they share (the node's own disk on one machine)")
        if not writer:
            self.checkpointer = Checkpointer(directory, max_to_keep=keep, read_only=True)
        latest = self.checkpointer.latest_step() if writer else None
        self._ckpt_seq = world.root_int(-1 if latest is None else latest, mesh) + 1

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

    def _store_on(self, device):
        """The replicated store a worker on ``device`` reads: the store
        itself on a mesh of one device, else its replica there."""
        return self.feature if self._single else self.feature.replica(device)

    def _tier_hits(self, n_id, store=None) -> torch.Tensor:
        """int32 (3,) valid lanes per tier ``[replicated, hot, cold]`` of
        a replicated store (its hot tier is JAX's second; ``store``, the
        copy the lookup read, default the trainer's), on the ids' device."""
        store = self.feature if store is None else store
        valid = n_id >= 0
        ids = n_id.clamp(min=0).to(torch.int64)
        order = getattr(store, "feature_order", None)
        if order is not None:
            ids = order[ids]
        hot = ids < int(getattr(store, "hot_rows", 0))
        return torch.stack([
            torch.zeros((), dtype=torch.int32, device=n_id.device),
            (valid & hot).sum(dtype=torch.int32),
            (valid & ~hot).sum(dtype=torch.int32),
        ])

    def _heat(self, n_id, device=None):
        """The row-heat histogram of one worker's frontier ids (int32
        ``(bins,)`` on the ids' device, ``device`` in the mesh's name,
        no host read), or None with the heat feed off."""
        if not self._heat_bins:
            return None
        order = self.feature._on("feature_order", self.device if device is None else device)
        return row_heat_histogram(n_id, order, self.sampler.csr_topo.node_count,
                                  self._heat_bins)

    def sample_block(self, seeds, num_seeds, key: int, draw_fn=None, device=None):
        """One worker's sample: the sampler's ``sample_padded`` on the
        padded ``seeds`` on ``device`` (the worker's; default the lead's;
        one K1 launch per hop on a card, drawing from the worker key's
        sample stream on that device, or from ``draw_fn(layer, deg)``).
        Returns ``(n_id, adjs)``."""
        dev = self.device if device is None else device
        gen = None if draw_fn is not None else seeded_generator(dev, key, 0)
        where = {} if self._single else {"device": dev}
        n_id, _, adjs, _, _, _ = self.sampler.sample_padded(
            seeds, num_seeds, generator=gen, draw_fn=draw_fn, **where)
        return n_id, adjs

    def _lookup(self, n_id, device=None):
        """``(rows, tier hits, routed overflow)`` of one lookup on
        ``device`` (where ``n_id`` lies, in the mesh's name; default the
        lead's): a worker's ``(L,)`` frontier (a replicated store: one K2
        ``tiered_gather``, or ``tiered_gather_dequant`` for int8; a sharded
        store: the psum flavour), or a routed feature group's ``(F, L)``
        frontiers (hits per member)."""
        dev = self.device if device is None else device
        if not self._sharded:
            store = self._store_on(dev)
            return (store[n_id], self._tier_hits(n_id, store),
                    torch.zeros((), dtype=torch.int32, device=n_id.device))
        # a world rank's routed frontier is its own (L,) vector
        routed = self._routed if self.world else n_id.dim() == 2
        hot = self.feature.hot
        cap = (None if not routed or hot is None or self.routed_alpha is None
               else hot.routed_cap(int(n_id.shape[-1]), self.routed_alpha))
        return self.feature.lookup(n_id, routed=routed, cap=cap, device=dev)

    def issue_block(self, seeds, num_seeds, key: int, draw_fn=None,
                    device=None) -> IssuedBlock:
        """The schedule-movable half of one worker's block, when its lookup
        needs no other worker's ids (a replicated store, or a sharded
        store's psum flavour): :meth:`sample_block`, then the lookup of
        the frontier and its tier hits, all on ``device`` (the worker's;
        default the lead's)."""
        n_id, adjs = self.sample_block(seeds, num_seeds, key, draw_fn, device)
        x, hits, _ = self._lookup(n_id, device)
        return IssuedBlock(n_id, x, adjs, num_seeds, hits, self._heat(n_id, device))

    def train_block(self, n_id, x, adjs, num_seeds, labels, key: int,
                    inject: bool = False, device=None):
        """The compute half of one worker's block, on ``device`` (the
        worker's, where its block and ``labels`` lie; default the lead's),
        over that device's replica of the model: the planned NaN rows
        (written into a copy of ``x`` when ``inject``), the labels and the
        seed mask, the forward in training mode (dropout from the worker
        key's dropout stream) and the backward. Returns ``(loss, grads)``:
        the block's loss and the gradients of ``loss / workers`` (the
        worker's share of the step's mean; of the unscaled ``loss`` in
        elastic mode, which divides after its fixed-order sum), neither
        read back, on ``device``."""
        S = self.local_batch
        plan = self.fault_plan
        if inject and plan is not None and plan.injects_nan():
            if not x.is_floating_point():
                raise ValueError(
                    f"FaultPlan NaN injection needs float features, got {x.dtype}"
                )
            x = x.clone()
            x[:min(int(plan.nan_rows), int(x.shape[0]))] = float("nan")
        dev = self.device if device is None else device
        model = self._replicas.on(dev)
        lab = labels[n_id[:S].clamp(min=0)]
        mask = torch.arange(S, device=n_id.device) < num_seeds
        model.train()
        logits = model(x, adjs, seeded_generator(dev, key, 1))
        loss = cross_entropy_on_seeds(logits[:S], lab, mask)
        params = [p for p in model.parameters() if p.requires_grad]
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
        ``(workers * local_batch,)`` row on the lead, each on its worker's
        device."""
        rows = packed.reshape(self.workers, self.local_batch)
        rows = [r.to(self._worker_device(w)) for w, r in enumerate(rows)]
        return [(r, (r >= 0).sum(dtype=torch.int32)) for r in rows]

    def _group_members(self) -> list:
        """Each feature group's members as logical workers, group by group
        and block by block: group ``g``'s block ``b`` pairs the slots ``g *
        F + i`` at their block ``b``, logical workers ``(g * F + i) *
        blocks_per_device + b``."""
        F, bpd = self.feature_size, self.blocks_per_device
        return [[(g * F + i) * bpd + b for i in range(F)]
                for g in range(self.data_size) for b in range(bpd)]

    def sample_group(self, blocks, members, key: int, device=None):
        """A feature group's sample over a topology-sharded sampler: its
        members' blocks together, one routed hop at a time
        (``sample_group``, no host read), on ``device`` (the group's first
        member's; default the lead's), worker ``w`` drawing from its worker
        key's sample stream there (or ``draw_fn``). Returns ``(n_id (F, L),
        adjs with (F, 2, E) edge lists, per-hop overflow (L,))``."""
        dev = self.device if device is None else device
        seeds = torch.stack([blocks[w][0].to(dev) for w in members])
        num = torch.stack([blocks[w][1].to(dev) for w in members])
        # the step's one routing budget: the trainer's alpha caps the hops
        # as it caps the routed lookup
        if self.draw_fn is None:
            gens = [seeded_generator(dev, fold_key(key, 1, w), 0) for w in members]
            out = self.sampler.sample_group(seeds, num, generators=gens,
                                            routed_alpha=self.routed_alpha, device=dev)
        else:
            out = self.sampler.sample_group(seeds, num, draw_fn=lambda i, l, deg: (
                self.draw_fn(key, members[i], l, deg)), routed_alpha=self.routed_alpha,
                device=dev)
        return out[0], out[2], out[6]

    def _issue(self, packed, key: int) -> IssuedStep:
        """The issue half of the step keyed ``key``: every worker's block,
        in worker order. With a routed lookup or a topology-sharded
        sampler each feature group samples its members' blocks first, then
        looks their frontiers up (at once when routed)."""
        blocks = self._blocks(packed)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.world:
            return self._issue_world(blocks, key)
        if self.topo_sharded:
            return self._issue_groups(blocks, key)
        if not self._routed:
            return IssuedStep([self.issue_block(seeds, num, fold_key(key, 1, w),
                                                self._worker_draw(key, w),
                                                self._worker_device(w))
                               for w, (seeds, num) in enumerate(blocks)], zero)
        issued, overflow = [None] * self.workers, zero
        for members in self._group_members():
            # the group's routed lookup runs on its first member's device
            gdev = self._worker_device(members[0])
            samples = [self.sample_block(*blocks[w], fold_key(key, 1, w),
                                         self._worker_draw(key, w), self._worker_device(w))
                       for w in members]
            xs, hits, ov = self._lookup(torch.stack([n_id.to(gdev) for n_id, _ in samples]),
                                        gdev)
            for i, (w, (n_id, adjs)) in enumerate(zip(members, samples)):
                wdev = self._worker_device(w)
                issued[w] = IssuedBlock(n_id, xs[i].to(wdev), adjs, blocks[w][1], hits[i],
                                        self._heat(n_id, wdev))
            overflow = overflow + ov.to(self.device)
        return IssuedStep(issued, overflow)

    def _issue_groups(self, blocks, key: int) -> IssuedStep:
        """:meth:`_issue` over a topology-sharded sampler: per feature
        group, :meth:`sample_group`, then the lookup of the members'
        frontiers (one routed lookup, or one per worker)."""
        issued = [None] * self.workers
        routed_ov = torch.zeros((), dtype=torch.int32, device=self.device)
        sample_ov = 0
        for members in self._group_members():
            # the group samples (and looks up, when routed) on its first
            # member's device; each member's block then moves to its own
            gdev = self._worker_device(members[0])
            devs = [self._worker_device(w) for w in members]
            n_id, adjs, hop_ov = self.sample_group(blocks, members, key, gdev)
            sample_ov = sample_ov + hop_ov.to(self.device)
            if self._routed:
                xs, hits, ov = self._lookup(n_id, gdev)
                routed_ov = routed_ov + ov.to(self.device)
            else:
                xs, hits, _ = zip(*(self._lookup(n_id[i].to(d), d)
                                    for i, d in enumerate(devs)))
            for i, (w, d) in enumerate(zip(members, devs)):
                issued[w] = IssuedBlock(
                    n_id[i].to(d), xs[i].to(d),
                    [Adj(a.edge_index[i].to(d), None, a.size, a.fanout) for a in adjs],
                    blocks[w][1], hits[i], self._heat(n_id[i], gdev))
        return IssuedStep(issued, routed_ov, sample_ov)

    def _issue_world(self, blocks, key: int) -> IssuedStep:
        """:meth:`_issue` on a world mesh: the rank's workers in turn (one,
        or its blocks in elastic mode, every rank of a feature group at the
        same block), each sampled (over a topology-sharded sampler: routed
        over the rank's feature group) and looked up (routed over the
        group, or the psum flavour); the overflows are the rank's groups'
        totals, summed over its blocks."""
        issued = []
        routed_ov = torch.zeros((), dtype=torch.int32, device=self.device)
        sample_ov = None
        for w in self._held:
            seeds, num = blocks[w]
            if self.topo_sharded:
                n_id, adjs, hop_ov = self.sample_group(blocks, [w], key)
                n_id = n_id[0]
                adjs = [Adj(a.edge_index[0], None, a.size, a.fanout) for a in adjs]
                sample_ov = hop_ov if sample_ov is None else sample_ov + hop_ov
            else:
                n_id, adjs = self.sample_block(seeds, num, fold_key(key, 1, w),
                                               self._worker_draw(key, w))
            x, hits, ov = self._lookup(n_id)
            if self._routed:
                routed_ov = routed_ov + ov
            issued.append(IssuedBlock(n_id, x, adjs, num, hits, self._heat(n_id)))
        return IssuedStep(issued, routed_ov, sample_ov)

    def _train(self, issued: IssuedStep, labels, key: int, inject: bool):
        """The train half of a step over its issued blocks: each worker's
        block on its device, then its loss, gradients and counters on the
        lead for the update."""
        self._replicas.refresh()
        lead, labs, outs = self.device, {}, []
        for w, b in zip(self._held, issued.blocks):
            dev = self._worker_device(w)
            if dev not in labs:
                labs[dev] = labels.to(dev)
            loss, grads = self.train_block(b.n_id, b.x, b.adjs, b.num_seeds, labs[dev],
                                           fold_key(key, 1, w), inject, dev)
            outs.append((loss.to(lead), [g.to(lead) for g in grads]))
        hits = [b.tier_hits.to(lead) for b in issued.blocks]
        heat = [None if b.heat is None else b.heat.to(lead) for b in issued.blocks]
        routed_ov = issued.routed_overflow.to(lead)
        sample_ov = (None if issued.sample_overflow is None
                     else issued.sample_overflow.to(lead))
        if self.world:
            return self._world_update(outs, hits, routed_ov, sample_ov, heat)
        return self._update(outs, hits, routed_ov, sample_ov, heat)

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
        # the JAX package's tape psums: each metric's sum over the workers is
        # marked as its mesh reduction (the counts are per mesh slot under
        # "all", shared by a feature group under "data")
        axes = (DATA_AXIS, FEATURE_AXIS) if self.seed_sharding == "all" else (DATA_AXIS,)
        if self.collect_metrics:
            dev = loss.device
            mtree = {
                ROUTED_OVERFLOW: routed_overflow,
                TIER_HITS: torch.stack(hits).sum(0, dtype=torch.int32),
                SAMPLE_OVERFLOW: (torch.zeros((len(self.sampler.sizes),),
                                              dtype=torch.int32, device=dev)
                                  if sample_overflow is None else sample_overflow),
            }
            collective("psum", (DATA_AXIS,), routed_overflow)
            collective("psum", axes, mtree[TIER_HITS])
            if sample_overflow is not None:
                collective("psum", (DATA_AXIS,), sample_overflow)
            if self._heat_bins:
                mtree[FEATURE_ROW_HEAT] = torch.stack(heat).sum(0, dtype=torch.int32)
                collective("psum", axes, mtree[FEATURE_ROW_HEAT])
        if self.nonfinite_guard:
            # the verdict's sum runs on every guarded step, over the whole
            # mesh as the JAX package's guard_verdict psums; the metric is
            # a sum of its own, as the JAX package's tape adds it
            total_bad = torch.stack(bad).sum(dtype=torch.int32)
            collective("psum", (DATA_AXIS, FEATURE_AXIS), total_bad)
            ok = total_bad == 0
            if self.collect_metrics:
                mtree[GUARD_NONFINITE] = torch.stack(bad).sum(dtype=torch.int32)
                collective("psum", axes, mtree[GUARD_NONFINITE])
                mtree[GUARD_SKIPPED] = (~ok).to(torch.int32)
            guarded_update(self.optimizer, params, ok)
        else:
            self.optimizer.step()
        return loss, mtree

    def _world_update(self, outs, hits, routed_overflow, sample_overflow=None, heat=None):
        """:meth:`_update` on a world mesh, for the rank's workers: the
        same sums over the rank's process groups, in the same order and
        with the same marks. The gradients and the loss are summed over the
        workers' group (the world under ``"all"``, the data group under
        ``"data"``, whose feature members hold the same worker) in worker
        order; in elastic mode each rank's blocks are gathered over the
        world into the logical-worker stack of
        :func:`~..resilience.worker_ordered_mean`. The metrics are integer
        sums, each the world's total on every rank (the overflows' per
        group sums over the data group, the tier hits and the row heat over
        the workers' group), so the tuners that read them decide the same
        on every rank; the guard's count is summed over the whole world."""
        losses = [o[0] for o in outs]
        mesh = self.mesh
        axes = (DATA_AXIS, FEATURE_AXIS) if self.seed_sharding == "all" else (DATA_AXIS,)
        group = mesh.group(axes)
        params = self._params()
        self.optimizer.zero_grad(set_to_none=True)
        if self.elastic:
            # one (blocks, n) stack per dtype, gathered over the world in
            # rank order: the (workers, n) stack in logical-worker order
            idxs, _ = _flat_by_dtype(outs[0][1])
            stacks = [torch.stack(flats) for flats in zip(
                *(_flat_by_dtype(grads)[1] for _, grads in outs))]
            means = worker_ordered_mean(stacks, axes, self.workers, mesh=mesh)
            reduced = _unflatten(means, idxs, outs[0][1])
            mean = worker_ordered_mean(torch.stack(losses), axes, self.workers, mesh=mesh)
        else:
            (_, grads), = outs
            reduced = _ordered_grads(grads, group, axes)
            mean = world.all_gather(losses[0], group, axes, mark=False).mean()
        for p, g in zip(params, reduced):
            p.grad = g
        mtree = {}
        if self.collect_metrics:
            data = mesh.group(DATA_AXIS)
            mtree = {
                ROUTED_OVERFLOW: world.int_sum(routed_overflow, data, (DATA_AXIS,)),
                TIER_HITS: world.int_sum(torch.stack(hits).sum(0, dtype=torch.int32),
                                         group, axes),
                SAMPLE_OVERFLOW: (torch.zeros((len(self.sampler.sizes),), dtype=torch.int32,
                                              device=mean.device)
                                  if sample_overflow is None else
                                  world.int_sum(sample_overflow, data, (DATA_AXIS,))),
            }
            if self._heat_bins:
                mtree[FEATURE_ROW_HEAT] = world.int_sum(
                    torch.stack(heat).sum(0, dtype=torch.int32), group, axes)
        if self.nonfinite_guard:
            ok, bad = guard_verdict(losses, [g for _, g in outs], (DATA_AXIS, FEATURE_AXIS),
                                    mesh=mesh)
            if self.collect_metrics:
                mtree[GUARD_NONFINITE] = world.int_sum(bad, group, axes)
                mtree[GUARD_SKIPPED] = (~ok).to(torch.int32)
            guarded_update(self.optimizer, params, ok)
        else:
            self.optimizer.step()
        return mean, mtree

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
        validates). On a world mesh rank 0 alone writes (every rank holds
        the same state) and every rank advances the save id."""
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
        if not self.world or self.mesh.rank == 0:
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
        blocks. The new mesh may hold other devices (a mesh of one card onto
        one of a card and the host, or of two cards): the model moves to its
        lead device before the restore, and the replicas follow its devices.
        A trainer built afresh on the new mesh (the process-death
        flow) passes its own mesh, ``resume(mesh=trainer.mesh)``. Regenerate
        the same seed matrix (``pack_epoch`` with the same seed) and call
        ``epoch_scan(..., key, epoch=epoch, start_step=step)``: the
        remaining steps are the uninterrupted run's, bitwise.

        On a world mesh every rank calls :meth:`resume`: rank 0 waits for
        its saves, a barrier follows, then rank 0 chooses the step (the
        newest valid, quarantining a corrupt one) and shares it, and every
        rank restores that one from the shared directory (the state and
        its metadata are those of a logical checkpoint, so either form
        restores the other's). ``mesh=`` is another world mesh over the
        same processes (the replan of the sampler's shards and the store
        runs over the old groups), or the trainer's own (the process-death
        flow: a fresh world of another size, with the same
        ``logical_workers``, resumes with ``resume(mesh=trainer.mesh)``).

        Returns ``(model, optimizer, key, step, epoch)``: the JAX tuple
        with the restored model and optimizer in place of ``(params,
        opt_state)`` and the saved epoch's int key; feed ``key``, ``epoch``
        and ``start_step=step`` back to :meth:`epoch_scan`. With no
        checkpoint on disk: ``(model, optimizer, None, 0, 0)``, untouched.
        """
        if mesh is not None and mesh is not self.mesh:
            self._check_replan_form(mesh)
        if self.checkpointer is None:
            raise ValueError(
                "resume() needs checkpointing enabled "
                "(checkpoint_dir=/checkpoint_every= at construction)"
            )
        latest = self._restore_step(checkpoint_step)
        if latest is None:
            return self.model, self.optimizer, None, 0, 0
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

    def _restore_step(self, checkpoint_step):
        """The step every rank restores (None: no checkpoint). In-flight
        saves finish first; on a world mesh rank 0 alone waits for its
        saves and, after a barrier, chooses the step (the pinned one, or
        the newest valid, quarantining a corrupt newest one) and shares it
        as one integer."""
        ckpt = self.checkpointer
        if not self.world:
            ckpt.wait_until_finished()
            return ckpt.latest_valid_step() if checkpoint_step is None else int(checkpoint_step)
        rank0 = self.mesh.rank == 0
        if rank0:
            ckpt.wait_until_finished()
        world.barrier(self.mesh)
        step = -1
        if rank0:
            step = ckpt.latest_valid_step() if checkpoint_step is None else int(checkpoint_step)
            step = -1 if step is None else step
        step = world.root_int(step, self.mesh)
        return None if step < 0 else step

    def _check_replan_form(self, mesh) -> None:
        """``resume(mesh=)`` replans within one form: a world trainer onto a
        world mesh over the live process group (a group's size is fixed for
        its processes' lives), a logical one onto a logical mesh."""
        if not self.world and not is_world(mesh):
            return
        live = (torch.distributed.get_world_size()
                if torch.distributed.is_initialized() else None)
        if not (self.world and is_world(mesh) and mesh.world_size == live):
            raise ValueError(
                f"resume(mesh={mesh!r}) cannot move this trainer ({self.mesh!r}) onto "
                f"another form or a world of another size than the live process group "
                f"({live} ranks): a process group's size is fixed for its processes' "
                "lives. To continue on another number of processes, start a fresh world "
                "of that size, build the trainer there with the same logical_workers= "
                "and call resume(mesh=trainer.mesh)")

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
        device = lead_device(mesh)
        single = _check_placeable(mesh, self.sampler, self.feature, replanning=True)
        old = (int(self.data_size), int(self.feature_size))
        self.mesh = mesh
        if device != self.device:
            # Module.to moves the parameters in place: the optimizer keeps
            # its references, and the restore places its state beside them
            self.model.to(device)
        self.device = device
        self._single = single
        self._replicas = _Replicas(self.model, device)
        self.data_size = mesh.shape[DATA_AXIS]
        self.feature_size = mesh.shape[FEATURE_AXIS]
        self._device_workers = dev_workers
        self.blocks_per_device = self.workers // dev_workers
        self._held = self._held_workers()
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


class _RankCalls:
    """A sampler seen by one rank of a world of ``size`` data workers,
    whose epoch samples blocks ``rank, rank + size, ...`` of the logical
    loop's. The sampler's own stream keys each call by its call counter,
    so the counter starts ``rank`` calls on and steps past the other
    ranks' ``size - 1`` blocks after each call; :meth:`finish` leaves it
    where the logical loop's ends."""

    def __init__(self, sampler, rank: int, size: int):
        self.sampler, self.rank, self.size = sampler, rank, size
        self.device = getattr(sampler, "device", None)
        sampler._call += rank

    def sample(self, seeds):
        out = self.sampler.sample(seeds)
        self.sampler._call += self.size - 1
        return out

    def finish(self) -> None:
        self.sampler._call -= self.rank


class _SlotSampler:
    """The sampler of a :class:`DataParallelTrainer` as one data worker
    sees it: each call samples on the worker's slot ``device`` (None: the
    sampler's own), with the trainer's ``draw_fn`` keyed by the sampler's
    call number. Every slot shares the sampler, so its call counter, caps
    and draws run in the logical loop's order."""

    def __init__(self, trainer, device):
        self.trainer, self.device = trainer, device

    def sample(self, seeds):
        sampler, fn = self.trainer.sampler, self.trainer.draw_fn
        draw = None if fn is None else functools.partial(fn, sampler._call + 1)
        where = {} if self.device is None else {"device": self.device}
        return sampler.sample(seeds, draw_fn=draw, **where)


class DataParallelTrainer:
    """Unfused data-parallel training: host-driven sample and gather with
    prefetch overlap, one model step per group of D worker blocks.

    Args:
      mesh: a :class:`~.mesh.Mesh` with ``feature == 1``; its ``data``
        axis gives D workers: a logical mesh runs them in this process,
        worker ``w`` on slot ``w``'s device (one device repeated, or
        distinct devices: each worker samples and gathers on its own,
        over the sampler's placement and the store's replica there, and
        runs its forward and backward on that device's replica of the
        model; its gradients are added on the lead device in worker order,
        where the optimizer steps), or one per process (a world mesh: the
        rank is worker ``rank``, its ``step`` takes its own batch and its
        ``train_epoch`` samples its own blocks; the gradients and the loss
        are summed over the world in worker order, bitwise the logical
        mesh's step).
      sampler: any sampler (``GraphSageSampler`` or a wrapper of one; a
        ``GraphSageSampler`` over distinct devices).
      feature: a replicated feature store (``Feature`` or a wrapper; a
        ``Feature`` over distinct devices).
      model: the torch model (its parameters on the mesh's lead device,
        ``devices.flat[0]``).
      optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters,
        in the place of JAX's optax transformation.
      local_batch: seeds per worker block.
      prefetch_retries, prefetch_backoff, prefetch_skip_policy: the epoch
        loop's :class:`~.pipeline.Prefetcher` knobs (bounded retry of
        transient sample or gather faults, then raise or skip).

    ``metrics`` and ``timeline`` receive the Prefetcher's counters and
    stages; :meth:`metrics_report` prints them. ``draw_fn`` (None, or
    ``draw_fn(call, layer, deg)``) replaces the epoch's sample draws of the
    sampler's call number ``call``, as ``GraphSageSampler.sample``'s
    ``draw_fn`` does (a logical mesh).
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
        self.world = is_world(mesh)
        self.mesh = mesh
        self.device = lead_device(mesh)
        self._single = _check_placeable(mesh, sampler, feature)
        self.sampler = sampler
        self.feature = feature
        self.model = model
        self._replicas = _Replicas(model, self.device)
        self.optimizer = optimizer
        self.draw_fn = None
        self.local_batch = int(local_batch)
        self.data_size = mesh.shape[DATA_AXIS]
        self.global_batch = self.local_batch * self.data_size
        # the workers this process runs: all of them in turn, or the rank's
        self._held = [mesh.rank] if self.world else list(range(self.data_size))
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
        with ``.out`` and ``.x``), worker ``w``'s first; on a world mesh
        from one, this rank's. ``labels`` is the full ``(N,)`` label tensor
        on the mesh's device.

        Worker ``w``'s loss is the masked NLL of its block's first
        ``local_batch`` rows: lanes past the block's true ``batch_size``
        hold frontier nodes of a short block and are masked out, as are
        ``-1`` seeds. Dropout draws from a generator derived from
        ``generator``'s seed and ``w`` (JAX's ``fold_in(key, w)``; like a
        key, ``generator`` is read, not advanced). The gradient is the
        mean of the workers' (JAX's ``pmean``), then one optimizer step.
        Returns the mean of the workers' losses, on the device (no host
        sync).

        On a mesh of distinct devices worker ``w``'s batch lies on slot
        ``w``'s device; its forward and backward run there on that device's
        replica of the model (which takes the lead's parameters first), and
        its gradients are added to the lead's in worker order; the loss
        returned lies on the lead device."""
        if len(batches) != len(self._held):
            raise ValueError(
                f"need {len(self._held)} batches (one per data shard held "
                f"by this process), got {len(batches)}"
            )
        caps, fanouts = self._stack(batches)
        adj_sizes = self._adj_sizes(caps)
        S, dev = self.local_batch, self.device
        labels = torch.as_tensor(labels, device=dev)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        self._replicas.refresh()
        losses, on = [], {}
        for w, b in zip(self._held, batches):
            wdev = self.mesh.devices[w, 0]
            if wdev not in on:
                on[wdev] = (labels.to(wdev), torch.arange(S, device=wdev))
            lab_w, lanes = on[wdev]
            model = self._replicas.on(wdev)
            adjs = [Adj(a.edge_index, None, sz, fanout=f)
                    for a, sz, f in zip(b.out.adjs, adj_sizes, fanouts)]
            seed_ids = b.out.n_id[:S]
            lab = lab_w[seed_ids.clamp(min=0)]
            mask = (lanes < b.out.batch_size) & (seed_ids >= 0)
            g = (None if generator is None
                 else seeded_generator(wdev, generator.initial_seed(), w))
            model.train()
            loss = cross_entropy_on_seeds(model(b.x, adjs, g)[:S], lab, mask)
            if model is self.model:
                (loss / self.data_size).backward()
            else:
                self._add_grads(model, loss / self.data_size)
            losses.append(loss.detach().to(dev))
        if self.world:
            # the logical step accumulates every worker's backward in turn:
            # the ordered sum over the world in worker order
            group = self.mesh.group(DATA_AXIS)
            params = [p for p in self.model.parameters() if p.grad is not None]
            for p, g in zip(params, _ordered_grads([p.grad for p in params], group,
                                                   (DATA_AXIS,))):
                p.grad = g
            self.optimizer.step()
            return world.all_gather(losses[0], group, (DATA_AXIS,), mark=False).mean()
        self.optimizer.step()
        return torch.stack(losses).mean()

    def _add_grads(self, replica, scaled) -> None:
        """The backward of ``scaled`` on a replica, its gradients added to
        the lead model's ``.grad`` (set where None), as the lead's own
        backward accumulates them; a parameter the loss does not reach
        keeps its gradient."""
        pairs = [(p, r) for p, r in zip(self.model.parameters(), replica.parameters())
                 if r.requires_grad]
        grads = torch.autograd.grad(scaled, [r for _, r in pairs], allow_unused=True)
        for (p, _), g in zip(pairs, grads):
            if g is None:
                continue
            g = g.to(self.device)
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)

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

    def _serial(self, blocks, sampler, feature):
        """The blocks' batches on the caller's thread, one after another
        (``depth=0``: no Prefetcher, so no retries); block ``i`` from
        ``sampler[i % len]`` and ``feature[i % len]`` when they are lists
        (one per worker slot)."""
        samplers = sampler if isinstance(sampler, list) else [sampler]
        features = feature if isinstance(feature, list) else [feature]
        for i, seeds in enumerate(blocks):
            out = samplers[i % len(samplers)].sample(seeds)
            yield Batch(seeds, out, features[i % len(features)][out.n_id])

    def _slot_inputs(self):
        """The epoch's ``(sampler, feature)`` for the Prefetcher or the
        serial loop: the trainer's own on a mesh of one device with no
        ``draw_fn``, else one per data worker (each sampling on its slot's
        device with the trainer's ``draw_fn``, and the store's replica
        there)."""
        if self._single and self.draw_fn is None:
            return self.sampler, self.feature
        devs = [self.mesh.devices[w, 0] for w in range(self.data_size)]
        return ([_SlotSampler(self, None if self._single else d) for d in devs],
                [self.feature if self._single else self.feature.replica(d) for d in devs])

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
        sampler, feature = self.sampler, self.feature
        if not self.world:
            sampler, feature = self._slot_inputs()
        if self.world:
            # the rank's blocks, drawing what the logical loop's calls for
            # them draw: the call counter steps past the other ranks' blocks
            rank, D = self.mesh.rank, self.data_size
            blocks = blocks[rank::D]
            sampler = _RankCalls(self.sampler, rank, D)
        if depth > 0:
            batches = Prefetcher(
                sampler, feature, depth=depth,
                retries=self.prefetch_retries, backoff=self.prefetch_backoff,
                skip_policy=self.prefetch_skip_policy,
                timeline=self.timeline, metrics=self.metrics,
            ).run(blocks)
        else:
            batches = self._serial(blocks, sampler, feature)
        seed = generator.initial_seed()
        losses, group = [], []
        for batch in batches:
            group.append(batch)
            if len(group) == len(self._held):
                sub = seeded_generator("cpu", seed, len(losses))
                losses.append(self.step(group, labels, sub))
                group = []
        if self.world:
            sampler.finish()
        if not losses:
            return float("nan"), 0
        return float(torch.stack(losses).mean()), len(losses)
