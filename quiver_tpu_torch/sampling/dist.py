"""Distributed neighbour sampling over a mesh-sharded topology.

The port of ``quiver_tpu/sampling/dist.py``, the scale-out counterpart of
``GraphSageSampler``: the graph lives as a
:class:`~..core.sharded_topology.ShardedTopology` (contiguous row ranges of
the CSR over the mesh's ``feature`` axis) and every mesh slot is a
sampling worker over its own seed block. Each hop:

1. routes every frontier vertex to the shard that owns its row, through a
   capped-bucket :class:`~..parallel.routing.BucketRoute` (the plan the
   routed feature lookup uses);
2. the owner answers the vertex's degree;
3. the requester draws the offsets with the replicated hop's scheme
   (``ops.sample.stratified_offsets`` and ``rotate_offsets`` on the same
   draws), which makes the two samplers agree bitwise;
4. the offsets ride the same buckets to the owner (the ids are not sent
   again), which selects the neighbour ids from its slice with kernel K1's
   ``select`` and routes the ``(cap, k)`` blocks back.

Weighted hops take three exchanges: degrees; the rows' total weights
(f32); then the requester's ``u01 * total`` out and the neighbours back,
the owner searching its prefix-weight slice with kernel K3's ``wselect``
(``scale_u=False``: ``u`` arrives scaled). Temporal hops get ``(first,
deg_t)``, the in-window slot range, as one int32 exchange with a trailing
dimension of 2, and rebase their offsets by ``first``.

Group form. The JAX package runs one hop per device inside ``shard_map``,
with ``all_to_all`` and ``psum`` between the devices. Here one process
holds a feature group's F members at once: every function below takes the
members' ``(F, S)`` frontiers, and an exchange is one
``BucketRoute.exchange`` over them, whose ``serve(member, ids[,
payload])`` runs the owner side of each member in turn. That is one K1
``select`` (or K3 ``wselect``) launch per owner per neighbour exchange,
the shape distinct cards would run. An owner masks every lane it does not
own (and every dead lane) to zero rows and reads nothing for it: the
bucket fallback's sum over the members is exact only then.

World form. On a world mesh (``parallel/mesh.py`` ``WorldMesh``, one
process per slot) a rank is one member: it holds its own ``(S,)``
frontier (a ``(1, S)`` row here) and its own shard of the topology, each
hop's ``BucketRoute`` carries the exchanges over its feature group's
``all_to_all_single`` (``group=``), and ``serve`` runs once, for the
rank's own shard: one K1 ``select`` (or K3 ``wselect``) launch per
neighbour exchange. The caps and bucket capacities come from the shapes
alone, or, for auto caps, from counts maxed over the world, so every
rank's ``all_to_all_single`` has the same splits; the answers are bitwise
the group form's.

Bucket overflow is served exactly by the route's fallback and counted:
the per-hop vector is ``last_sample_overflow``.

Parity: for the same seed block, draws, caps and dedup, each worker's
sample is bitwise the replicated ``GraphSageSampler``'s on that block.
Worker ``w`` of a call keyed ``key`` (an int, the role of a JAX key)
draws what the replicated sampler's ``sample_padded`` draws from a
generator seeded ``fold_key(key, w)``; ``w`` is the flat worker index over
the mesh's axes in axis-name order (JAX's ``_worker_index``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SampleMode
from ..core.sharded_topology import ShardedTopology, shard_position
from ..core.topology import CSRTopo
from ..obs.registry import SAMPLE_OVERFLOW, MetricsRegistry
from ..ops.kernels.fused import select, wselect
from ..ops.reindex import dedup_bound
from ..ops.sample import (
    fold_key,
    rotate_offsets,
    stratified_offsets,
    temporal_window_counts,
)
from ..parallel import world
from ..parallel.mesh import (FEATURE_AXIS, axis_devices, axis_groups, is_world,
                             shard_seed_blocks)
from ..parallel.routing import BucketRoute
from ..utils.trace import trace_scope
from .sampler import (
    Adj,
    GraphSageSampler,
    SampleOutput,
    _round_up,
    check_seed_range,
    read_counts,
    reindex_hop,
    run_auto_caps,
)

__all__ = [
    "DistGraphSageSampler",
    "dist_sample_layer",
    "dist_multilayer_sample",
    "routed_sample_cap",
]


_OWN = object()  # sample_group's default budget: the sampler's own routed_alpha

def routed_sample_cap(length: int, num_shards: int,
                      alpha: float | None) -> int | None:
    """Per-destination bucket capacity for a frontier of width ``length``:
    ``ceil(alpha * L / F)`` clamped to [1, L]; ``None`` (or a cap >= L)
    means the exact-safe full-length buckets."""
    if alpha is None:
        return None
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    cap = -(-int(alpha * length) // max(num_shards, 1))
    cap = max(1, min(cap, int(length)))
    return None if cap >= length else cap


def stack_draws(draws, weighted: bool):
    """The members' draws of one hop stacked along a leading member
    dimension: ``u01`` blocks when ``weighted``, else ``(jitter, rot)``
    pairs."""
    if weighted:
        return torch.stack(draws)
    return tuple(torch.stack(parts) for parts in zip(*draws))


def worker_major(parts, groups):
    """Per-group tensors (leading dimension: the group's members, in
    ``groups`` order) as one tensor whose leading dimension is the flat
    worker index."""
    out = torch.cat(parts)
    order = [w for members in groups for w in members]
    if order == sorted(order):
        return out
    inv = torch.empty(len(order), dtype=torch.int64)
    inv[torch.tensor(order)] = torch.arange(len(order))
    return out[inv.to(out.device)]


def merger(mesh, outs, groups):
    """``merge(get)``: the per-member tensors ``get(o)`` of the groups'
    outputs ``outs`` as one worker-major tensor. On a world mesh ``outs``
    holds the rank's own output alone, and the merge is an ``all_gather``
    over the world in rank (= worker) order, the same on every rank;
    unmarked, as the logical form's concatenation is no collective."""
    if not is_world(mesh):
        return lambda get: worker_major([get(o) for o in outs], groups)
    axes = mesh.axis_names
    group = mesh.group(axes)
    return lambda get: world.all_gather(get(outs[0]), group, axes,
                                        mark=False).flatten(0, 1)


def group_total(mesh, outs, get, groups):
    """The groups' totals ``get(o)`` (int32, each group's own) summed over
    the groups; on a world mesh gathered first, each group's total taken
    from its first member."""
    if not is_world(mesh):
        return sum(get(o) for o in outs)
    axes = mesh.axis_names
    every = world.all_gather(get(outs[0]), mesh.group(axes), axes, mark=False)
    return every[[members[0] for members in groups]].sum(0, dtype=torch.int32)


class _Owner:
    """The owner side of one shard of a partition (a ``ShardedTopology``
    or a ``ShardedRel``) for one routing plan: member ``d`` answering the
    ``ids`` the plan routes to it (``BucketRoute.requests()[d]``, the same
    tensor in every exchange), zero for the ids it does not own and for
    dead ids (below 0). The ownership test and the rows' starts and
    degrees are computed once, here, and serve every exchange of the
    plan."""

    def __init__(self, shards, d: int, ids):
        i = shard_position(shards, d)
        self.indices = shards.indices[i]
        self.cum_weights = None if shards.cum_weights is None else shards.cum_weights[i]
        self.edge_time = None if shards.edge_time is None else shards.edge_time[i]
        self.iters = shards.search_iters
        self.out_device = ids.device
        indptr, rps = shards.indptr[i], shards.rows_per_shard
        ids = ids.to(indptr.device)
        mine = (ids >= 0) & (torch.div(ids, rps, rounding_mode="floor") == d)
        r = torch.where(mine, ids - d * rps, 0).to(torch.int64)
        lo, hi = indptr[r], indptr[r + 1]
        # base: int64 local row starts; deg: int32, 0 off the shard
        self.mine, self.base = mine, lo.to(torch.int64)
        self.row_deg = torch.where(mine, hi - lo, 0).to(torch.int32)

    def deg(self):
        return self.row_deg.to(self.out_device)

    def nbr(self, offs):
        """K1 ``select`` at the routed offsets, which are -1 past each
        lane's valid prefix: the count of a lane the shard does not own is
        0, so it reads nothing."""
        offs = offs.to(self.base.device)
        count = torch.where(self.mine, (offs >= 0).sum(-1, dtype=torch.int32), 0)
        (out,) = select((self.indices,), self.base, offs.clamp(min=0).contiguous(), count)
        return torch.where(self.mine[:, None], out, 0).to(self.out_device)

    def total(self):
        """Each owned row's total weight (its last prefix entry)."""
        end = (self.base + self.row_deg - 1).clamp(0, self.cum_weights.shape[0] - 1)
        return torch.where(self.mine & (self.row_deg > 0), self.cum_weights[end],
                           0.0).to(self.out_device)

    def wnbr(self, u):
        """K3 ``wselect`` over the owned rows with ``u`` already scaled by
        the row totals (``scale_u=False``; its take-all override for
        ``deg <= k``); a row of degree 0 reads nothing."""
        out, _ = wselect(self.indices, self.cum_weights, self.base, self.row_deg,
                         u.to(self.base.device).contiguous(), self.iters, scale_u=False)
        return torch.where(self.mine[:, None], out, 0).to(self.out_device)

    def window(self, lo_t, hi_t):
        """``(first, deg_t)`` of each owned row's in-window slots."""
        first, deg_t = temporal_window_counts(self.edge_time, self.base, self.row_deg,
                                              lo_t, hi_t, self.iters)
        return torch.where(self.mine[:, None], torch.stack([first, deg_t], -1),
                           0).to(self.out_device)


def exchange(route, serve, payload=None):
    """``route.exchange`` over ``(rows, L, ...)`` tensors in either form:
    a world route takes and returns this member's one row."""
    if route.group is None:
        return route.exchange(serve, payload)
    return route.exchange(serve, None if payload is None else payload[0])[None]


def owners_of(shards, route) -> dict:
    """``{member: _Owner}`` for every member this process serves in
    ``route`` (all of them, or a world rank's own)."""
    held = range(route.num_shards) if route.group is None else [route.group.index]
    return {d: _Owner(shards, d, ids) for d, ids in zip(held, route.requests())}


def _offsets(draws, deg, k: int):
    """A uniform hop's ``(F, S, k)`` int32 offsets and selection mask from
    its draws: raw ``(jitter, rot)`` bits (the replicated hop's scheme),
    or the offsets themselves (a ``draw_fn``'s)."""
    if isinstance(draws, tuple):
        jitter, rot = draws
        off, sel = stratified_offsets(deg, k, jitter)
        return rotate_offsets(off, deg, k, rot), sel
    i = torch.arange(k, device=deg.device)
    return draws.to(torch.int32), i < deg.clamp(max=k)[..., None]


def dist_sample_layer(shards, seeds, num_seeds, k: int, draw, *,
                      cap: int | None = None, weighted: bool = False,
                      time_window=None, route=None, group=None):
    """One distributed hop of a feature group (group form), or of one
    member (world form, ``group=``).

    Args:
      shards: the partition, a ``ShardedTopology`` or a ``ShardedRel``
        (per-member ``indptr`` / ``indices`` / ``cum_weights`` /
        ``edge_time`` tensors, ``rows_per_shard``, ``search_iters``).
      seeds: ``(F, S)`` int32 node ids, one row per member, -1 padded
        (valid entries occupy a prefix).
      num_seeds: valid seeds, an int or an ``(F,)`` tensor.
      k: fanout.
      draw: ``draw(deg)`` gives the hop's draws from the ``(F, S)`` int32
        degrees (in-window on a temporal hop; 0 on dead lanes): raw
        ``(jitter (F, S, k), rot (F, S, 1))`` int64 bits or ``(F, S, k)``
        int32 offsets on a uniform or temporal hop, ``(F, S, k)`` f32
        ``u01`` on a weighted one.
      cap: per-destination bucket capacity (None = uncapped).
      weighted: inverse-CDF draws against the owners' prefix weights.
      time_window: ``(lo, hi)``: draw among each row's in-window edges.
      route: a ``BucketRoute`` already planned over ``seeds`` (the hetero
        sampler shares one per destination type); None plans one.
      group: the world form: this rank's feature group
        (``WorldMesh.group("feature")``); ``seeds`` is then this member's
        ``(1, S)`` row and ``shards`` its own shard.

    Returns ``(neighbours (F, S, k) int32 -1 masked, counts (F, S), the
    group's fallback-served lanes)``.
    """
    S = seeds.shape[1]
    F = seeds.shape[0] if group is None else len(group.ranks)
    dev = seeds.device
    num = torch.as_tensor(num_seeds, device=dev)
    valid = (torch.arange(S, device=dev) < num[..., None]) & (seeds >= 0)
    s = torch.where(valid, seeds, 0)
    if route is None:
        route = BucketRoute(s, valid, torch.div(s, shards.rows_per_shard,
                                                rounding_mode="floor"),
                            num_shards=F, cap=cap, group=group)
    # every exchange of the plan serves owner d the same ids: its rows are
    # looked up once
    owners = owners_of(shards, route)
    if weighted:
        deg = exchange(route, lambda d, _ids: owners[d].deg())
        tot = exchange(route, lambda d, _ids: owners[d].total())
        tot = torch.where(deg > 0, tot, 1.0)
        u = draw(deg).to(torch.float32) * tot[..., None]
        nbr = exchange(route, lambda d, _ids, u: owners[d].wnbr(u), payload=u)
        i = torch.arange(k, device=dev)
        mask = valid[..., None] & (i < deg.clamp(max=k)[..., None])
    else:
        if time_window is None:
            deg = exchange(route, lambda d, _ids: owners[d].deg())
            first = None
        else:
            lo_t, hi_t = time_window
            win = exchange(route, lambda d, _ids: owners[d].window(lo_t, hi_t))
            first, deg = win[..., 0], win[..., 1]
        off, sel = _offsets(draw(deg), deg, k)
        mask = valid[..., None] & sel
        if first is not None:
            off = first[..., None] + off
        # offsets out (the ids are not sent again), -1 past each lane's
        # valid prefix; neighbour blocks back
        nbr = exchange(route, lambda d, _ids, offs: owners[d].nbr(offs),
                       payload=torch.where(mask, off, -1))
    nbr = torch.where(mask, nbr, -1).to(torch.int32)
    counts = torch.where(valid, deg.clamp(max=k), 0)
    return nbr, counts, route.overflow


def dist_multilayer_sample(shards, seeds, num_seeds, sizes, caps, draw, *,
                           routed_alpha: float | None = 2.0,
                           weighted: bool = False, time_window=None, group=None,
                           dedup: str = "sort", node_count: int | None = None):
    """The multi-layer distributed sample and reindex of a feature group
    (of one member, its ``(1, S)`` row, on a world mesh: ``group=``, as in
    :func:`dist_sample_layer`).

    The sharded-topology twin of ``sampling.sampler.multilayer_sample``:
    ``seeds`` is ``(F, S)`` (one row per member), ``num_seeds`` an int or
    ``(F,)``, ``draw(layer, deg)`` gives a hop's draws over its ``(F,
    S_l)`` degrees (see :func:`dist_sample_layer`); the reindex and the
    ``Adj`` assembly are the replicated loop's (``reindex_hop``), one per
    member, by the resolved strategy ``dedup``; ``"map"`` needs
    ``node_count``, the GLOBAL node count (every rank holds it from the
    indptr geometry), which bounds every sampled id. Returns the
    replicated loop's tuple, each entry with a leading member dimension,
    and the ``(L,)`` int32 vector of per-hop fallback-served lanes (group
    totals, seeds outward).
    """
    node_bound = dedup_bound(dedup, node_count)
    F = seeds.shape[0] if group is None else len(group.ranks)
    adjs, edge_counts, frontier_counts, hop_overflows = [], [], [], []
    cur, cur_n = seeds, torch.as_tensor(num_seeds, device=seeds.device)
    total_overflow = torch.zeros(seeds.shape[0], dtype=torch.int32, device=seeds.device)
    for l, k in enumerate(sizes):
        cap = routed_sample_cap(cur.shape[-1], F, routed_alpha)
        with trace_scope(f"dist_sample_layer_{l}"):
            nbr, _, hop_ov = dist_sample_layer(
                shards, cur, cur_n, k, lambda deg, l=l: draw(l, deg), cap=cap,
                weighted=weighted, time_window=time_window, group=group)
        hop_overflows.append(hop_ov)
        with trace_scope(f"reindex_layer_{l}"):
            frontier, n_frontier, adj, edges, overflow = reindex_hop(
                cur, cur_n, nbr, caps[l], node_bound=node_bound)
        adjs.append(adj)
        edge_counts.append(edges)
        frontier_counts.append(n_frontier + overflow)
        cur, cur_n = frontier, n_frontier
        total_overflow = total_overflow + overflow
    return (cur, cur_n, adjs[::-1], total_overflow, tuple(edge_counts[::-1]),
            tuple(frontier_counts[::-1]), torch.stack(hop_overflows))


class DistGraphSageSampler(GraphSageSampler):
    """K-hop sampler over a mesh-sharded topology.

    Built directly or by ``GraphSageSampler(..., topo_sharding="mesh",
    mesh=mesh)``. Every mesh slot is a sampling worker over its own seed
    block (the ``seed_sharding="all"`` discipline); each hop routes the
    frontier to the shards that own its rows (see the module docstring).
    Uniform, ``weighted=True`` and ``time_window`` draws, each bitwise its
    replicated counterpart. ``kernel`` is validated and inert: the owner
    side always runs K1's ``select`` / K3's ``wselect`` (their plain
    versions on CPU tensors). HBM mode only, no ``with_eid``, no
    ``device_topo``. ``routed_alpha`` is the bucket budget, ``ceil(alpha
    * L / F)`` lanes per destination per hop (``None``: uncapped); the
    ``DistributedTrainer`` drives this sampler and a sharded feature store
    with one alpha. ``device`` defaults to the mesh's first device.

    After :meth:`sample`, ``last_sample_overflow`` holds the per-hop
    fallback-served lanes (int32 ``(num_layers,)``, seeds outward, mesh
    totals), a view of ``metrics``' ``SAMPLE_OVERFLOW``; never read back.

    On a world mesh (one process per slot) the rank is worker ``rank`` and
    holds its own shard of the topology (``ShardedTopology.member``):
    :meth:`sample_group`, :meth:`sample_padded` and
    :meth:`sample_per_worker` give the rank's own worker, and
    :meth:`sample` the logical form's merged output, gathered over the
    world in worker order (the same on every rank).
    """

    def __init__(
        self,
        csr_topo: CSRTopo,
        sizes,
        device=None,
        mode: str | SampleMode = SampleMode.HBM,
        seed_capacity: int | None = None,
        frontier_caps=None,
        seed: int = 0,
        weighted: bool = False,
        time_window=None,
        auto_margin: float = 1.25,
        kernel: str = "auto",
        with_eid: bool = False,
        dedup: str = "auto",
        device_topo=None,
        topo_sharding: str = "mesh",
        mesh=None,
        routed_alpha: float | None = 2.0,
        axis: str = FEATURE_AXIS,
    ):
        if topo_sharding != "mesh":
            raise ValueError(
                f"DistGraphSageSampler is the topo_sharding='mesh' sampler; "
                f"got topo_sharding={topo_sharding!r}"
            )
        if mesh is None:
            raise ValueError("topo_sharding='mesh' requires mesh=")
        if with_eid:
            raise ValueError(
                "with_eid over a sharded topology is not supported; the "
                "sharded CSR slices do not carry eid — use the replicated "
                "GraphSageSampler"
            )
        if SampleMode.parse(mode) is not SampleMode.HBM:
            raise ValueError(
                "topo_sharding='mesh' requires mode='HBM': each shard's CSR "
                "slice is device-resident (that is the point — per-chip "
                "bytes shrink 1/F instead of staging through host)"
            )
        if device_topo is not None:
            raise ValueError(
                "device_topo cannot be combined with topo_sharding='mesh'"
            )
        if routed_alpha is not None and routed_alpha <= 0:
            raise ValueError(
                f"routed_alpha must be > 0 or None, got {routed_alpha}"
            )
        self.mesh = mesh
        self.axis = axis
        self.routed_alpha = None if routed_alpha is None else float(routed_alpha)
        self.metrics = MetricsRegistry()
        self.metrics.counter(
            SAMPLE_OVERFLOW, shape=(len(tuple(sizes)),), unit="lanes",
            doc="per-hop fallback-served lanes of the last distributed "
                "sample (seeds-outward)",
        )
        super().__init__(
            csr_topo, sizes,
            device=axis_devices(mesh, axis)[0] if device is None else device,
            mode=mode, seed_capacity=seed_capacity, frontier_caps=frontier_caps,
            seed=seed, weighted=weighted, time_window=time_window,
            auto_margin=auto_margin, kernel=kernel, with_eid=with_eid,
            dedup=dedup, topo_sharding="mesh",
        )

    @property
    def last_sample_overflow(self):
        """Per-hop fallback-served lanes of the last :meth:`sample` (a view
        of the ``sample.hop_overflow`` registry metric)."""
        return self.metrics.value(SAMPLE_OVERFLOW)

    @last_sample_overflow.setter
    def last_sample_overflow(self, value):
        self.metrics.set(SAMPLE_OVERFLOW, value)

    def _init_topo(self, device_topo=None):
        return ShardedTopology(
            self.mesh, self.csr_topo, axis=self.axis,
            with_weights=self.weighted,
            with_times=self.time_window is not None,
        )

    def replan(self, mesh) -> "DistGraphSageSampler":
        """Re-partition the topology onto another mesh. Draws, caps and the
        parity contract are untouched: per seed block and key the
        re-planned sampler draws what the old one would."""
        self.mesh = mesh
        self.topo = self.topo.replan(mesh, axis=self.axis)
        return self

    @property
    def workers(self) -> int:
        """Seed-block workers: every slot of the mesh."""
        return self.mesh.devices.size

    def _world_group(self):
        """The rank's group along the partition's axis (None: logical)."""
        return self.mesh.group(self.axis) if is_world(self.mesh) else None

    def sample_padded(self, seeds, num_seeds, generator=None, draw_fn=None,
                      routed_alpha=_OWN):
        """On a world mesh, the rank's own worker: the replicated
        ``sample_padded``'s contract and tuple (``(cap,)`` device seeds;
        ``draw_fn(layer, deg)``, or layer ``l`` from ``(generator
        .initial_seed(), l)``, or, with neither, worker ``rank`` of a
        :meth:`sample` call on the sampler's own stream), with no host
        read. On a logical mesh a feature group samples at once: call
        :meth:`sample_group`."""
        if not is_world(self.mesh):
            raise TypeError(
                "a topology-sharded sampler samples a feature group at once: "
                "call sample_group")
        self.check_topo_version()
        seeds = torch.as_tensor(seeds, device=self.device).to(torch.int32).reshape(1, -1)
        keys = None
        if generator is not None:
            keys = [generator.initial_seed()]
        elif draw_fn is None:
            self._call += 1
            keys = [fold_key(fold_key(self.seed, self._call), self.mesh.rank)]
        num = torch.as_tensor(num_seeds, device=self.device).reshape(1)
        out = self._sample_group(
            seeds, num, keys,
            None if draw_fn is None else (lambda _i, l, deg: draw_fn(l, deg)), routed_alpha)
        self.last_sample_overflow = out[6]
        n_id, n_count, adjs, overflow, ecs, fcs, _ = out
        return (n_id[0], n_count[0], [Adj(a.edge_index[0], None, a.size, a.fanout)
                                       for a in adjs],
                overflow[0], tuple(c[0] for c in ecs), tuple(c[0] for c in fcs))

    # -- the group entry ------------------------------------------------------

    def _group_draw(self, cap: int, keys, draw_fn, device=None):
        """``draw(layer, deg)`` of a group: each member's draws stacked,
        from ``draw_fn(member, layer, deg)`` or, for the member keyed
        ``key``, the replicated ``sample_padded``'s draws from a generator
        seeded ``key`` (layer ``l`` from ``seeded_generator(device, key,
        l)`` over the worst-case rows), on ``device`` (default the
        sampler's)."""
        dev = self.device if device is None else device
        if draw_fn is not None:
            def draw(l, deg):
                return torch.stack([torch.as_tensor(draw_fn(i, l, deg[i]), device=dev)
                                    for i in range(deg.shape[0])])

            return draw
        seams = [self._draw_seam(cap, None, (int(key),), dev)["bits"] for key in keys]
        return lambda l, deg: stack_draws([bits(l, (deg.shape[-1],)) for bits in seams],
                                          self.weighted)

    def _sample_group(self, seeds, num_seeds, keys, draw_fn, routed_alpha=_OWN,
                      device=None):
        cap = int(seeds.shape[-1])
        return dist_multilayer_sample(
            self.topo, seeds, num_seeds, self.sizes, self._caps_for(cap),
            self._group_draw(cap, keys, draw_fn, device),
            routed_alpha=self.routed_alpha if routed_alpha is _OWN else routed_alpha,
            weighted=self.weighted, time_window=self.time_window,
            group=self._world_group(), dedup=self.dedup,
            node_count=self.topo.node_count)

    def sample_group(self, seeds, num_seeds, generators=None, draw_fn=None,
                     routed_alpha=_OWN, device=None):
        """Sample one feature group's padded device seed blocks with no host
        read: the sampler call of a fused train step.

        ``seeds`` is ``(F, cap)`` int32 on the sampler's device, one row per
        member along the sharded axis, -1 past its ``num_seeds`` (an int
        or an ``(F,)`` tensor). The caps are those planned for ``cap``.
        Draws: ``draw_fn(member, layer, deg)``, or member ``i`` draws what
        ``sample_padded(generator=generators[i])`` of a replicated sampler
        draws. On a world mesh ``seeds`` is the rank's own ``(1, cap)`` row
        (``member`` 0 of ``draw_fn`` is that row) and every tensor of the
        result has a leading dimension of 1. Returns ``dist_multilayer_sample``'s tuple: ``(n_id (F,
        frontier_cap), n_count (F,), adjs deepest first (edge_index (F, 2,
        E_l)), overflow (F,), edge_counts, frontier_counts, hop overflow
        (L,))``, all on the device. ``routed_alpha`` (a float, or None for
        uncapped buckets) replaces the sampler's own for this call: a fused
        trainer's step caps the hops with its own budget. ``device`` (default
        the sampler's) is where the group's plan, draws, reindex and
        results live, as the mesh names it: a trainer passes its group's
        first member's on a mesh of distinct devices; each owner answers on
        its shard's device either way.
        """
        self.check_topo_version()
        keys = None if generators is None else [g.initial_seed() for g in generators]
        if keys is None and draw_fn is None:
            raise ValueError("sample_group needs generators or draw_fn")
        dev = self.device if device is None else device
        seeds = torch.as_tensor(seeds, device=dev).to(torch.int32)
        return self._sample_group(seeds, num_seeds, keys, draw_fn, routed_alpha, dev)

    # -- the public API -------------------------------------------------------

    def shard_seeds(self, seeds, local_cap: int) -> np.ndarray:
        """Split a global seed array into per-worker valid-prefix blocks,
        padded to ``(workers, local_cap)`` with -1."""
        return shard_seed_blocks(seeds, self.workers, local_cap)

    def _run(self, seeds, num, keys, draw_fn):
        """Every group's sample, worker-major: ``(n_id, n_count, edge
        indices deepest first, overflow, edge_counts, frontier_counts)``,
        each with a leading ``(workers,)`` dimension (``edge_index`` ``(W,
        2, E_l)``), and the mesh-total per-hop overflow. On a world mesh
        the rank samples its own worker and the outputs are gathered over
        the world."""
        groups = axis_groups(self.mesh, self.axis)
        outs = []
        # a world rank samples its own worker's row, a logical mesh every group
        for members in ([[self.mesh.rank]] if is_world(self.mesh) else groups):
            idx = torch.tensor(members, device=self.device)
            gdraw = None if draw_fn is None else (
                lambda i, l, deg, m=members: draw_fn(m[i], l, deg))
            outs.append(self._sample_group(
                seeds[idx], num[idx], None if keys is None else [keys[w] for w in members],
                gdraw))
        merge = merger(self.mesh, outs, groups)
        L = len(self.sizes)
        return (merge(lambda o: o[0]), merge(lambda o: o[1]),
                [merge(lambda o, l=l: o[2][l].edge_index) for l in range(L)],
                merge(lambda o: o[3]),
                [merge(lambda o, l=l: o[4][l]) for l in range(L)],
                [merge(lambda o, l=l: o[5][l]) for l in range(L)],
                group_total(self.mesh, outs, lambda o: o[6], groups))

    def sample(self, input_nodes, key: int | None = None, draw_fn=None) -> SampleOutput:
        """Sample k-hop neighbourhoods of a GLOBAL seed batch, split across
        every worker of the mesh.

        Returns one worker-major ``SampleOutput``: ``n_id`` is ``(workers *
        frontier_cap,)`` (each worker's block bitwise the replicated
        sampler's on its seed block; :meth:`sample_per_worker`), each
        ``adjs[l].edge_index`` ``(2, workers * E_l)`` with per-worker
        ``size`` and ``fanout``, ``batch_size`` the per-worker padded
        block, ``n_count``, ``overflow`` and ``edge_counts`` mesh totals,
        ``frontier_counts`` per-layer worker maxima. ``key`` (an int)
        overrides the sampler's own stream (call ``c`` is keyed
        ``fold_key(seed, c)``); worker ``w`` draws from ``fold_key(key,
        w)``. ``draw_fn(worker, layer, deg)`` replaces the draws (the
        ``(S_l,)`` degrees of that worker's hop; offsets, or ``u01`` when
        weighted). An auto sampler plans and regrows its caps from the
        worker maxima, reading the counts on the host (on a world mesh,
        from the gathered output, so every rank plans the same caps).
        """
        self.check_topo_version()
        seeds = np.asarray(input_nodes)
        batch = int(seeds.shape[0])
        check_seed_range(seeds, self.csr_topo.node_count)
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
            return self._caps_for(cap), self._run(packed, num, keys, draw_fn)

        # the replicated sampler's regrowth, fed from the worker maxima
        used, out = run_auto_caps(
            self, run, lambda r: read_counts(r[1][3].sum(dtype=torch.int32),
                                             [c.max() for c in r[1][5]]),
            lambda counts: self._plan_auto(cap, counts[::-1]),
            lambda: self._frontier_caps, "dist auto caps")
        self.last_sample_overflow = out[6]
        return self._assemble(out, cap, used)

    def _assemble(self, out, seed_cap: int, caps) -> SampleOutput:
        """The worker-major ``SampleOutput`` of a run under ``caps``."""
        n_id, n_count, eis, overflow, ecs, fcs, _ = out
        L = len(self.sizes)
        widths = (seed_cap,) + tuple(caps[:-1])
        adjs = [Adj(torch.cat(list(ei), dim=-1), None, (caps[l], widths[l]),
                    fanout=self.sizes[l])
                for l, ei in zip(range(L - 1, -1, -1), eis)]
        host = torch.stack([c.sum() for c in ecs] + [c.max() for c in fcs]).tolist()
        return SampleOutput(n_id.reshape(-1), seed_cap, adjs,
                            n_count.sum(dtype=torch.int32), overflow.sum(dtype=torch.int32),
                            tuple(host[:L]), tuple(host[L:]))

    def sample_per_worker(self, input_nodes, key: int | None = None,
                          draw_fn=None) -> list[SampleOutput]:
        """:meth:`sample`, cut into per-worker ``SampleOutput``s, each
        comparable bitwise with the replicated sampler's on that worker's
        seed block and draws; on a world mesh, a list of one: the rank's
        own worker."""
        seeds = np.asarray(input_nodes)
        out = self.sample(seeds, key=key, draw_fn=draw_fn)
        W = self.workers
        n_id = out.n_id.reshape(W, -1)
        zero = torch.zeros((), dtype=torch.int32, device=n_id.device)
        per = []
        for w, blk in enumerate(np.array_split(seeds, W)):
            adjs = [Adj(a.edge_index.reshape(2, W, -1)[:, w], None, a.size,
                        fanout=a.fanout) for a in out.adjs]
            per.append(SampleOutput(n_id[w], len(blk), adjs, zero, zero, (), ()))
        return [per[self.mesh.rank]] if is_world(self.mesh) else per
