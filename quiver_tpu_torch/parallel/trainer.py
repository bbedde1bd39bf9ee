"""Data-parallel training over a device mesh: the unfused trainer.

The port of ``quiver_tpu/parallel/trainer.py``'s :class:`DataParallelTrainer`
and its telemetry summary. It is the reference's papers100M loop
(benchmarks/ogbn-papers100M/dist_sampling_ogb_paper100M_quiver.py:120-165):
each data-parallel worker samples its own seed block and gathers its own
features, host-driven under the :class:`~.pipeline.Prefetcher`, and one
model step averages the workers' gradients (the reference's DDP
allreduce, JAX's ``pmean``). It takes any sampler and store configuration:
``mode="HOST"`` topologies (kernel K1 reading ``indices`` over UVA), cold
feature tiers (K2 reading pinned rows), weighted hops, auto caps.

Here every data worker runs in this process on the mesh's one device, in
worker order: the gradient is the sum of ``loss_w / D`` over the workers,
each worker's backward accumulating into ``.grad`` in turn. A mesh whose
workers map to more than one distinct device raises until the
``torch.distributed`` layer lands (ROADMAP A.11). The fused
``DistributedTrainer`` is ROADMAP A.10b.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..core.config import CachePolicy
from ..obs.registry import MetricsRegistry
from ..obs.timeline import StepTimeline
from ..ops.sample import seeded_generator
from ..sampling.sampler import Adj
from ..utils.trace import get_logger
from .mesh import DATA_AXIS, FEATURE_AXIS, Mesh
from .pipeline import Batch, Prefetcher
from .train import cross_entropy_on_seeds, init_model

__all__ = ["DataParallelTrainer"]


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
                "training across devices needs the torch.distributed layer "
                "(ROADMAP A.11)"
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
