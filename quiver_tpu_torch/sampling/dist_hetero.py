"""Distributed heterogeneous neighbour sampling over a mesh-sharded topology.

The port of ``quiver_tpu/sampling/dist_hetero.py``, the scale-out
counterpart of ``HeteroGraphSampler``: every relation's CSR lives as a
row-range partition (:class:`~..core.hetero_sharded.HeteroShardedTopology`)
and every mesh slot is a sampling worker over its own seed block. Each hop
runs the homogeneous owner-routed hop (``sampling.dist.dist_sample_layer``)
per relation, with one twist: the relations into one destination type
share its row ranges, so they share ONE ``BucketRoute`` plan per (hop,
destination type); its id lanes are routed once, and every relation's
degree, offset and neighbour exchanges ride the same buckets.

In group form, as in ``sampling/dist.py``: one process holds a feature
group's F members and each exchange serves every owner in turn (one K1
``select``, or K3 ``wselect`` on a weighted relation, per owner per
relation per hop). In world form (a ``WorldMesh``, one process per slot)
the rank is one member over its own shard of each relation: one route per
(hop, destination type) over its feature group, and one launch per
relation per exchange, for its own shard.

Parity: for the same seed block, draws, caps and dedup, every worker's
sample is bitwise the replicated ``HeteroGraphSampler``'s on that block;
the per-type dedup is the replicated loop's (``hetero_reindex_hop``). Worker
``w`` of a call keyed ``key`` draws hop ``h`` of relation ``r`` from
``seeded_generator(device, fold_key(key, w), h, r)``.

Bucket overflow is served exactly and counted per (hop, edge type) under
``HETERO_SAMPLE_OVERFLOW``; relations into one type share that hop's plan,
so they report its overflow equally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SampleMode
from ..core.hetero import HeteroCSRTopo
from ..core.hetero_sharded import HeteroShardedTopology
from ..obs.registry import HETERO_SAMPLE_OVERFLOW, MetricsRegistry
from ..ops.election import validate_kernel_arg
from ..ops.sample import fold_key
from ..parallel.mesh import (FEATURE_AXIS, axis_devices, axis_groups, is_world,
                             shard_seed_blocks)
from ..parallel.routing import BucketRoute
from ..utils.trace import trace_scope
from .dist import dist_sample_layer, group_total, merger, routed_sample_cap, stack_draws
from .hetero import (
    HeteroGraphSampler,
    HeteroLayer,
    HeteroSampleOutput,
    hetero_reindex_hop,
)
from .sampler import (Adj, _round_up, check_seed_range, read_counts,
                      resolve_sample_kernel, run_auto_caps)

__all__ = ["DistHeteroSampler", "dist_hetero_multilayer_sample"]


def dist_hetero_multilayer_sample(rels, seeds, num_seeds, input_type,
                                  layer_plans, draw, *, rows_per_shard: dict,
                                  routed_alpha: float | None = 2.0,
                                  weighted_rels=frozenset(), group=None,
                                  node_bounds=None):
    """The distributed hetero loop of a feature group (group form), or of
    one member's ``(1, S)`` row over its feature group ``group`` (world
    form, as ``dist_sample_layer``'s).

    Args:
      rels: ``{edge_type: ShardedRel}``, the partition of every relation.
      seeds: ``(F, S)`` int32 seed ids of ``input_type``, one row per
        member, -1 padded; ``num_seeds`` an int or ``(F,)``.
      layer_plans: the per-hop plans of ``HeteroGraphSampler._plan``
        (sharing the replicated planner is part of the parity contract).
      draw: ``draw(hop, edge_type, deg)`` gives a relation's draws over its
        ``(F, S)`` degrees (see ``dist_sample_layer``).
      rows_per_shard: ``{node_type: rows per shard}``.
      routed_alpha: the bucket budget, ``ceil(alpha * S_t / F)`` lanes per
        destination per (hop, type); None: uncapped.
      weighted_rels: the relations that draw by weight.
      node_bounds: ``{type: global node count}`` runs the per-type
        dedup by ``"map"``, as ``hetero_reindex_hop``'s; None, the sort.

    Returns ``(frontier {type: (F, cap)}, counts {type: (F,)}, layers
    deepest first, overflow (F,), per-hop unclipped uniques seeds outward,
    hop overflow)``; the last is int32 ``(slots,)``: per hop, the shared
    plan's fallback-served lanes of each active relation in sorted order.
    """
    F = seeds.shape[0] if group is None else len(group.ranks)
    dev = seeds.device
    frontier = {input_type: seeds}
    counts = {input_type: torch.as_tensor(num_seeds, device=dev)}
    layers, frontier_counts, hop_overflows = [], [], []
    overflow = torch.zeros(seeds.shape[0], dtype=torch.int32, device=dev)
    for hop, (rel_fanouts, caps_prev, caps_next) in enumerate(layer_plans):
        # every active relation through ONE shared plan per destination type
        routes, samples = {}, {}
        for et, k in rel_fanouts.items():
            d = et[2]
            cur = frontier[d]
            if d not in routes:
                S = cur.shape[-1]
                valid = ((torch.arange(S, device=dev) < counts[d][..., None])
                         & (cur >= 0))
                s = torch.where(valid, cur, 0)
                routes[d] = BucketRoute(
                    s, valid, torch.div(s, rows_per_shard[d], rounding_mode="floor"),
                    num_shards=F, cap=routed_sample_cap(S, F, routed_alpha), group=group)
            with trace_scope(f"dist_hetero_layer_{hop}"):
                samples[et], _, _ = dist_sample_layer(
                    rels[et], cur, counts[d], k,
                    lambda deg, et=et: draw(hop, et, deg),
                    weighted=et in weighted_rels, route=routes[d])
        hop_overflows.extend(routes[et[2]].overflow
                             for et in sorted(rel_fanouts, key=str))
        frontier, counts, adjs, uniques, ovf = hetero_reindex_hop(
            frontier, counts, samples, rel_fanouts, caps_next,
            node_bounds=node_bounds)
        overflow = overflow + ovf
        layers.append(HeteroLayer(adjs, dict(caps_next), dict(caps_prev)))
        frontier_counts.append(uniques)
    return (frontier, counts, layers[::-1], overflow, tuple(frontier_counts),
            torch.stack(hop_overflows))


class DistHeteroSampler(HeteroGraphSampler):
    """K-hop typed sampler over a mesh-sharded heterogeneous topology.

    The typed member of the distributed family (``DistGraphSageSampler``
    is the homogeneous one): per-relation partitions, owner-routed hops
    through one shared ``BucketRoute`` plan per (hop, destination type),
    and the ``seed_sharding="all"`` worker discipline (see the module
    docstring for the parity contract).

    Extra args over the replicated sampler: ``mesh`` (required),
    ``routed_alpha`` (``cap = ceil(alpha * S / F)`` lanes per destination
    per hop; None: uncapped), ``axis`` (the mesh axis of the partitions)
    and ``kernel`` (validated, and resolved lazily by :attr:`kernel` as the
    replicated sampler's; the owner side runs K1 ``select`` / K3
    ``wselect`` whatever it resolves to). HBM mode only, no ``with_eid``. ``device`` defaults
    to the mesh's first device.

    After :meth:`sample`, ``last_sample_overflow`` holds the
    fallback-served lanes per (hop, edge type), an int32 ``(num_slots,)``
    tensor in :attr:`overflow_slots` order (the ``HETERO_SAMPLE_OVERFLOW``
    registry metric).

    On a world mesh the rank samples its own worker over its own shards,
    and :meth:`sample` gathers the workers over the world (the logical
    form's merged output, the same on every rank);
    :meth:`sample_per_worker` gives the rank's own worker.
    """

    def __init__(self, topo: HeteroCSRTopo, sizes, input_type: str,
                 mode: str | SampleMode = SampleMode.HBM,
                 seed_capacity: int | None = None,
                 frontier_caps: str | None = None, seed: int = 0,
                 auto_margin: float = 1.25, weighted=False,
                 with_eid: bool = False, dedup: str = "auto", *,
                 mesh=None, routed_alpha: float | None = 2.0,
                 axis: str = FEATURE_AXIS, kernel: str = "auto", device=None):
        if mesh is None:
            raise ValueError("DistHeteroSampler requires mesh=")
        self._kernel = validate_kernel_arg(str(kernel))
        if with_eid:
            raise ValueError(
                "with_eid over a sharded topology is not supported; the "
                "sharded relation slices do not carry eid — use the "
                "replicated HeteroGraphSampler"
            )
        if SampleMode.parse(mode) is not SampleMode.HBM:
            raise ValueError(
                "DistHeteroSampler requires mode='HBM': each shard's "
                "relation slice is device-resident (that is the point — "
                "per-chip bytes shrink 1/F instead of staging through host)"
            )
        if routed_alpha is not None and routed_alpha <= 0:
            raise ValueError(
                f"routed_alpha must be > 0 or None, got {routed_alpha}"
            )
        self.mesh = mesh
        self.axis = axis
        self.routed_alpha = None if routed_alpha is None else float(routed_alpha)
        super().__init__(
            topo, sizes, input_type, mode=mode, seed_capacity=seed_capacity,
            frontier_caps=frontier_caps, seed=seed, auto_margin=auto_margin,
            weighted=weighted, with_eid=with_eid, dedup=dedup,
            device=axis_devices(mesh, axis)[0] if device is None else device,
        )
        # the (hop, edge type) slots: the active sets depend only on the
        # schema's reachability, so any seed capacity plans the same
        self._overflow_slots = tuple(
            (li, et)
            for li, (active, _, _) in enumerate(self._plan(128))
            for et in sorted(active, key=str)
        )
        self.metrics = MetricsRegistry()
        self.metrics.counter(
            HETERO_SAMPLE_OVERFLOW, shape=(len(self._overflow_slots),),
            unit="lanes",
            doc="fallback-served lanes per (hop, edge type) of the last "
                "distributed hetero sample (overflow_slots order)",
        )

    def _init_topo(self):
        return HeteroShardedTopology(
            self.mesh, self.topo, axis=self.axis,
            weighted_rels=self.weighted_rels,
        )

    @property
    def kernel(self) -> str:
        """The resolved hop path (``"pallas"`` or ``"xla"``), resolved at
        the first read and kept, as ``GraphSageSampler.kernel``;
        ``_kernel`` holds the constructor's request."""
        resolved = getattr(self, "_kernel_resolved", None)
        if resolved is None:
            resolved = resolve_sample_kernel(self._kernel, self.device)
            self._kernel_resolved = resolved
        return resolved

    @property
    def overflow_slots(self) -> tuple:
        """The ``(hop, edge_type)`` order of the overflow vector."""
        return self._overflow_slots

    @property
    def last_sample_overflow(self):
        """Fallback-served lanes of the last :meth:`sample`, int32
        ``(num_slots,)`` in :attr:`overflow_slots` order."""
        return self.metrics.value(HETERO_SAMPLE_OVERFLOW)

    @property
    def last_sample_overflow_by_rel(self) -> dict | None:
        """``{(hop, edge_type): lanes}`` of the last sample (host ints;
        None before any)."""
        v = self.metrics.value(HETERO_SAMPLE_OVERFLOW)
        if v is None:
            return None
        return dict(zip(self._overflow_slots, v.tolist()))

    @property
    def workers(self) -> int:
        """Seed-block workers: every slot of the mesh."""
        return self.mesh.devices.size

    def shard_seeds(self, seeds, local_cap: int) -> np.ndarray:
        """Split a global seed array into per-worker valid-prefix blocks,
        padded to ``(workers, local_cap)`` with -1."""
        return shard_seed_blocks(seeds, self.workers, local_cap)

    def _group_draw(self, cap: int, keys, draw_fn):
        """``draw(hop, edge_type, deg)`` of a group: each member's draws
        stacked, from ``draw_fn(member, hop, edge_type, deg)`` or the
        member key's bits (``_bits_seam``)."""
        if draw_fn is not None:
            def draw(hop, et, deg):
                return torch.stack([torch.as_tensor(draw_fn(i, hop, et, deg[i]),
                                                    device=self.device)
                                    for i in range(deg.shape[0])])

            return draw
        seams = [self._bits_seam(cap, (int(key),)) for key in keys]
        return lambda hop, et, deg: stack_draws(
            [bits(hop, et, (deg.shape[-1],)) for bits in seams], et in self.weighted_rels)

    def _run(self, seeds, num, keys, draw_fn, plans):
        """Every group's sample, worker-major (a leading ``(workers,)``
        dimension on every tensor but the mesh-total hop overflow); on a
        world mesh the rank's own worker, gathered over the world."""
        cap = int(seeds.shape[-1])
        groups = axis_groups(self.mesh, self.axis)
        world_group = self.mesh.group(self.axis) if is_world(self.mesh) else None
        outs = []
        for members in ([[self.mesh.rank]] if world_group is not None else groups):
            idx = torch.tensor(members, device=self.device)
            gdraw = None if draw_fn is None else (
                lambda i, h, et, deg, m=members: draw_fn(m[i], h, et, deg))
            outs.append(dist_hetero_multilayer_sample(
                self.dev_topos.rels, seeds[idx], num[idx], self.input_type, plans,
                self._group_draw(cap, [keys[w] for w in members], gdraw),
                rows_per_shard=self.dev_topos.rows_per_shard,
                routed_alpha=self.routed_alpha, weighted_rels=self.weighted_rels,
                group=world_group, **self._dedup_args()))
        merge = merger(self.mesh, outs, groups)

        frontier = {t: merge(lambda o, t=t: o[0][t]) for t in outs[0][0]}
        counts = {t: merge(lambda o, t=t: o[1][t]) for t in outs[0][1]}
        layers = []
        for l, layer in enumerate(outs[0][2]):
            # (workers, 2, E) -> (2, workers * E), worker-major
            adjs = {et: Adj(merge(lambda o, l=l, et=et: o[2][l].adjs[et].edge_index)
                            .transpose(0, 1).reshape(2, -1), None, a.size,
                            fanout=a.fanout)
                    for et, a in layer.adjs.items()}
            layers.append(HeteroLayer(adjs, dict(layer.src_caps), dict(layer.dst_caps)))
        fcounts = tuple({t: merge(lambda o, li=li, t=t: o[4][li][t]) for t in layer}
                        for li, layer in enumerate(outs[0][4]))
        return (frontier, counts, layers, merge(lambda o: o[3]), fcounts,
                group_total(self.mesh, outs, lambda o: o[5], groups))

    def sample(self, input_nodes, key: int | None = None,
               draw_fn=None) -> HeteroSampleOutput:
        """Sample typed k-hop neighbourhoods of a GLOBAL seed batch, split
        across every worker of the mesh.

        Returns one worker-major ``HeteroSampleOutput``: each ``n_id[t]``
        is ``(workers * cap_t,)``, each relation's ``edge_index`` ``(2,
        workers * S*k)`` with per-worker ``size``, ``batch_size`` the
        per-worker padded block, ``n_count`` and ``overflow`` mesh totals,
        ``frontier_counts`` per-layer, per-type worker maxima (host ints).
        ``key`` (an int) overrides the sampler's own stream (call ``c`` is
        keyed ``fold_key(seed, c)``); ``draw_fn(worker, hop, edge_type,
        deg)`` replaces the draws.
        """
        seeds = np.asarray(input_nodes)
        batch = int(seeds.shape[0])
        check_seed_range(seeds, self.topo.num_nodes[self.input_type])
        W = self.workers
        per_worker = -(-batch // W) if batch else 1
        cap = self._seed_capacity or max(_round_up(per_worker, 128), 128)
        packed = torch.from_numpy(self.shard_seeds(seeds, cap)).to(self.device)
        num = (packed >= 0).sum(1, dtype=torch.int32)
        if key is None:
            self._call += 1
            key = fold_key(self.seed, self._call)
        keys = [fold_key(int(key), w) for w in range(W)]

        def run():
            plans = self._plan(cap, self._cap_overrides if self._auto_caps else None)
            return self._run(packed, num, keys, draw_fn, plans)

        # the replicated sampler's regrowth, fed from the worker maxima
        out = run_auto_caps(
            self, run, lambda o: read_counts(
                o[3].sum(dtype=torch.int32),
                [{t: v.max() for t, v in layer.items()} for layer in o[4]]),
            self._plan_auto, lambda: self._cap_overrides, "dist hetero auto caps")
        self.metrics.set(HETERO_SAMPLE_OVERFLOW, out[5])
        frontier, counts, layers, overflow, fcounts, _ = out
        observed = tuple({t: int(v.max()) for t, v in layer.items()} for layer in fcounts)
        return HeteroSampleOutput(
            {t: v.reshape(-1) for t, v in frontier.items()},
            {t: v.sum(dtype=torch.int32) for t, v in counts.items()},
            cap, layers, overflow.sum(dtype=torch.int32), observed)

    def sample_per_worker(self, input_nodes, key: int | None = None, draw_fn=None):
        """:meth:`sample`, cut into per-worker ``HeteroSampleOutput``s, each
        comparable bitwise with the replicated sampler's on that worker's
        seed block and draws; on a world mesh, a list of one: the rank's
        own worker."""
        out = self.sample(np.asarray(input_nodes), key=key, draw_fn=draw_fn)
        W = self.workers
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        per = []
        for w in range(W):
            n_id = {t: v.reshape(W, -1)[w] for t, v in out.n_id.items()}
            layers = [HeteroLayer(
                {et: Adj(a.edge_index.reshape(2, W, -1)[:, w], None, a.size,
                         fanout=a.fanout) for et, a in layer.adjs.items()},
                dict(layer.src_caps), dict(layer.dst_caps)) for layer in out.adjs]
            per.append(HeteroSampleOutput(n_id, {}, out.batch_size, layers, zero, ()))
        return [per[self.mesh.rank]] if is_world(self.mesh) else per
