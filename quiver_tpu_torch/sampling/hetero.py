"""Multi-layer heterogeneous neighbour sampler.

The port of ``quiver_tpu/sampling/hetero.py``: the homogeneous padded
design (``sampling/sampler.py``) over typed graphs. Each hop samples every
active relation ``(src_t, rel, dst_t)`` whose destination type has a
frontier, then deduplicates per *node type* (previous frontier first, in
first-occurrence order: the same ``masked_unique`` the homogeneous reindex
runs). Every per-hop, per-type capacity is planned from the fanouts, as in
the JAX package.

Output contract (PyG's hetero NeighborSampler): ``adjs`` deepest layer
first, each a :class:`HeteroLayer` with one padded ``Adj`` per relation and
the per-type capacities a model slices with; ``n_id[input_type][:batch]
== seeds``.

On a CUDA device every relation's hop is one launch of kernel K1's fused
uniform hop (``uniform_hop``), or of K3's fused weighted hop
(``weighted_hop``) on a weighted relation. Draws: hop ``h`` of relation
``r`` (its index in ``topo.edge_types``) in call ``c`` draws from
``seeded_generator(device, seed, c, h, r)``, over the relation's
worst-case rows, and takes the prefix it needs, so an auto-caps rerun
repeats the draws; ``sample_padded(generator=g)`` draws from
``(g.initial_seed(), h, r)``. The ``draw_fn(hop, edge_type, deg)`` seam replaces
them (the tests feed it JAX's): it returns a uniform hop's int32 offsets
(K1's ``select`` then runs) or a weighted hop's float32 ``u01`` block
(K3's ``wselect``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.config import SampleMode
from ..core.hetero import HeteroCSRTopo
from ..core.memory import resolve_device
from ..ops.reindex import dedup_bound, masked_unique, resolve_dedup
from ..ops.sample import hop_draws, sample_layer, seeded_generator
from .sampler import Adj, _round_up, check_seed_range, read_counts, run_auto_caps

__all__ = ["HeteroGraphSampler", "HeteroLayer", "HeteroSampleOutput",
           "hetero_multilayer_sample", "hetero_reindex_hop"]


class HeteroLayer:
    """One hop's relation-wise adjacency: ``adjs`` maps each edge type to a
    padded :class:`Adj`; ``src_caps``/``dst_caps`` are the per-type
    frontier capacities on the source and target side (slice bounds and
    segment counts for the model)."""

    def __init__(self, adjs: dict, src_caps: dict, dst_caps: dict):
        self.adjs = adjs
        self.src_caps = src_caps
        self.dst_caps = dst_caps

    def __repr__(self):
        return (
            f"HeteroLayer(rels={[f'{s}-{r}->{d}' for s, r, d in self.adjs]}, "
            f"src_caps={self.src_caps}, dst_caps={self.dst_caps})"
        )

    def to(self, device) -> "HeteroLayer":
        return HeteroLayer({et: a.to(device) for et, a in self.adjs.items()},
                           dict(self.src_caps), dict(self.dst_caps))


class HeteroSampleOutput(NamedTuple):
    n_id: dict  # node_type -> (cap,) global ids, -1 padded
    n_count: dict  # node_type -> 0-d valid count
    batch_size: int
    adjs: list  # HeteroLayer records, deepest first
    overflow: torch.Tensor  # total uniques dropped by caps (0 = exact)
    # per-hop unclipped unique counts {type: 0-d}, seeds outward: what the
    # auto-caps planner reads
    frontier_counts: tuple = ()


def _normalize_sizes(sizes, topo: HeteroCSRTopo):
    """Per-layer fanout spec: an int (every relation) or ``{edge_type: k}``.

    -1 means the relation's full neighbourhood (its max in-degree); 0 (dict
    form) disables the relation for that hop; other non-positive fanouts
    raise.
    """
    edge_types = topo.edge_types

    def resolve(et, k):
        k = int(k)
        if k == -1:
            return max(topo.relations[et].max_degree, 1)
        if k < 1:
            raise ValueError(
                f"fanout for {et} must be >= 1, -1 (full), or 0 (disable, "
                f"dict form only); got {k}"
            )
        return k

    out = []
    for layer in sizes:
        if isinstance(layer, int):
            out.append({et: resolve(et, layer) for et in edge_types})
        else:
            unknown = set(layer) - set(edge_types)
            if unknown:
                raise ValueError(f"unknown edge types in sizes: {unknown}")
            out.append({
                et: resolve(et, k) for et, k in layer.items() if int(k) != 0
            })
    return out


def hetero_reindex_hop(frontier, counts, samples, rel_fanouts, caps_next,
                       eids=None, node_bounds=None):
    """One typed hop's per-type dedup and ``Adj`` records.

    ``frontier``/``counts`` map each node type to its ``(..., S_t)`` ids
    and valid counts before the hop; ``samples`` each active relation to
    its ``(..., S_dst, k)`` neighbours; ``caps_next`` each type to its
    capacity after the hop; ``eids`` (optional) each relation to its
    neighbours' edge ids. Every leading index is an independent sample
    (the distributed sampler's group members).

    Each type's new frontier is the previous one first (forced), then each
    relation's samples of that source type in ``sorted(str)`` order,
    deduplicated: by ``"map"`` with ``node_bounds`` (``{type: node
    count}``), else by ``"sort"``.
    Returns ``(new frontier, new counts, {edge_type: Adj}, unclipped
    uniques per type, overflow)``.
    """
    new_frontier, new_counts, locals_per_rel, layer_uniques = {}, {}, {}, {}
    overflow = 0
    for t, cap in caps_next.items():
        blocks, valids, spans = [], [], {}
        prev = frontier.get(t)
        n_prev = 0
        if prev is not None:
            n_prev = prev.shape[-1]
            blocks.append(prev)
            lane = torch.arange(n_prev, device=prev.device)
            num = torch.as_tensor(counts[t], device=prev.device)
            valids.append((lane < num[..., None]) & (prev >= 0))
        for et in sorted(samples, key=str):
            if et[0] != t:
                continue
            flat = samples[et].flatten(-2)
            spans[et] = (sum(b.shape[-1] for b in blocks), flat.shape[-1])
            blocks.append(flat)
            valids.append(flat >= 0)
        uniq, num_u, local = masked_unique(
            torch.cat(blocks, -1), torch.cat(valids, -1), cap, num_forced=n_prev,
            node_bound=None if node_bounds is None else node_bounds[t])
        new_frontier[t] = uniq
        new_counts[t] = num_u.clamp(max=cap)
        layer_uniques[t] = num_u
        overflow = overflow + (num_u - cap).clamp(min=0)
        for et, (off, ln) in spans.items():
            locals_per_rel[et] = local[..., off:off + ln]

    # one padded Adj per relation: src = local id in the new src-type
    # frontier, dst = row in the previous dst-type frontier (its local id
    # next hop, the previous nodes being forced first)
    adjs = {}
    for et, k in rel_fanouts.items():
        s_t, _, d_t = et
        S = frontier[d_t].shape[-1]
        col = locals_per_rel[et].unflatten(-1, (S, k))
        row = torch.arange(S, dtype=torch.int32, device=col.device)[:, None]
        row = torch.where(col >= 0, row, -1)
        edge_index = torch.stack([col.flatten(-2), row.flatten(-2)], dim=-2)
        e_id = None
        if eids is not None:
            # neighbours dropped by frontier-cap overflow must not leak
            # their edge ids
            e_id = torch.where(col >= 0, eids[et], -1).flatten(-2)
        adjs[et] = Adj(edge_index, e_id, (caps_next[s_t], S), fanout=k)
    return new_frontier, new_counts, adjs, layer_uniques, overflow


def hetero_multilayer_sample(dev_topos, seeds, num_seeds, input_type,
                             layer_plans, draw=None, bits=None,
                             weighted_rels=frozenset(), with_eid: bool = False,
                             node_bounds=None):
    """The hetero sampling loop.

    ``layer_plans`` is a tuple of per-hop plans ``(rel_fanouts, caps_prev,
    caps_next)``: active edge types -> fanouts, and node types ->
    capacities before and after the hop. Each relation's hop draws through
    one of two seams: ``draw(hop, edge_type, deg)`` gives its int32
    offsets (``float32`` ``u01`` on a relation of ``weighted_rels``) from
    its degrees; ``bits(hop, edge_type, shape)`` its raw draws over rows of
    ``shape``, which a fused entry consumes. ``with_eid`` threads each
    relation's COO edge positions into every ``Adj.e_id``. ``node_bounds``
    (``{type: node count}``) runs the per-type dedup by ``"map"``, else
    by ``"sort"``, as in :func:`hetero_reindex_hop`. ``num_seeds`` is an int or a device
    scalar; nothing on this path reads the device back, so it runs as one
    stream of launches.

    Returns ``(frontier {type: ids}, counts {type: 0-d}, layers deepest
    first, overflow, per-hop unclipped unique counts seeds outward)``.
    """
    if (draw is None) == (bits is None):
        raise ValueError("hetero_multilayer_sample takes one of draw and bits")
    dev = seeds.device
    if not torch.is_tensor(num_seeds):
        # a fill on the device, not a copy from the host: a copy from
        # pageable memory would synchronise with the card
        num_seeds = torch.full((), int(num_seeds), dtype=torch.int32, device=dev)
    frontier = {input_type: seeds}
    counts = {input_type: num_seeds}
    layers, frontier_counts = [], []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)

    for hop, (rel_fanouts, caps_prev, caps_next) in enumerate(layer_plans):
        # 1) sample every active relation, in rel_fanouts order
        samples, eids = {}, {}
        for et, k in rel_fanouts.items():
            weighted = et in weighted_rels
            if bits is not None:
                seam = {"bits": lambda shape, et=et: bits(hop, et, shape)}
            else:
                seam = {"u" if weighted else "offs":
                        lambda deg, et=et: draw(hop, et, deg)}
            res = sample_layer(dev_topos[et], frontier[et[2]], counts[et[2]], k,
                               weighted=weighted, with_eid=with_eid, **seam)
            samples[et] = res[0]
            if with_eid:
                eids[et] = res[2]

        new_frontier, new_counts, adjs, layer_uniques, ovf = hetero_reindex_hop(
            frontier, counts, samples, rel_fanouts, caps_next,
            eids if with_eid else None, node_bounds)
        overflow = overflow + ovf
        layers.append(HeteroLayer(adjs, dict(caps_next), dict(caps_prev)))
        frontier_counts.append(layer_uniques)
        frontier, counts = new_frontier, new_counts

    return frontier, counts, layers[::-1], overflow, tuple(frontier_counts)


class HeteroGraphSampler:
    """K-hop typed neighbour sampler over a :class:`HeteroCSRTopo`.

    Args:
      topo: HeteroCSRTopo (relations stored as incoming adjacency).
      sizes: per-layer fanouts, each an int (every relation) or a dict
        ``{edge_type: fanout}`` (omitted or 0 disables the relation that
        hop); -1 is a relation's full neighbourhood.
      input_type: node type of the seeds.
      mode: topology placement, ``"GPU"``/``"HBM"`` or ``"UVA"``/``"HOST"``
        (each relation's ``indices``, ``eid`` and ``cum_weights`` pinned
        on the host, read over UVA by the kernels).
      seed_capacity: padded seed batch; defaults to the batch rounded up
        to a multiple of 128.
      frontier_caps: ``"auto"`` sizes every per-hop, per-type capacity
        from the first call's unclipped unique counts times
        ``auto_margin`` and regrows them when a later call overflows,
        rerunning that call with the same draws; default: the worst case.
      seed: base seed of the draws (see the module docstring).
      auto_margin: headroom factor of ``"auto"`` caps (>= 1).
      weighted: ``True`` draws in proportion to the edge weights on every
        relation that has weights (at least one must), or an iterable of
        edge types names exactly those (each must have weights); the other
        relations sample uniformly.
      with_eid: populate every ``Adj.e_id`` with relation-local COO edge
        positions.
      dedup: the per-type reindex strategy, ``"sort"``, ``"map"`` (a
        dense ``(num_nodes[type],)`` position map per type, no sort),
        ``"scan"`` (JAX's scatter-free strategy; the port runs the sort)
        or ``"auto"``, resolved once here by
        :func:`~..ops.reindex.resolve_dedup` (``"map"`` off the card,
        ``"sort"`` on it). All give the same samples.
      device: sampling device; CUDA unless the caller names another.

    ``reruns`` counts the calls an auto sampler ran again under regrown
    caps.
    """

    def __init__(self, topo: HeteroCSRTopo, sizes: Sequence,
                 input_type: str, mode: str | SampleMode = SampleMode.HBM,
                 seed_capacity: int | None = None,
                 frontier_caps: str | None = None, seed: int = 0,
                 auto_margin: float = 1.25, weighted=False,
                 with_eid: bool = False, dedup: str = "auto", device=None):
        if input_type not in topo.num_nodes:
            raise ValueError(f"unknown input_type {input_type!r}")
        self.dedup = resolve_dedup(str(dedup))  # validates; "auto" -> platform
        self.device = resolve_device(device)
        self.topo = topo
        self.input_type = input_type
        self.sizes = _normalize_sizes(sizes, topo)
        self.mode = SampleMode.parse(mode)
        self.with_eid = bool(with_eid)
        if weighted is True:
            weighted_rels = topo.weighted_edge_types
            if not weighted_rels:
                raise ValueError(
                    "weighted=True requires at least one relation with edge "
                    "weights; call topo.set_edge_weight() first"
                )
        elif weighted:
            weighted_rels = [tuple(str(t) for t in et) for et in weighted]
            missing = [
                et for et in weighted_rels
                if et not in topo.relations
                or topo.relations[et].cum_weights is None
            ]
            if missing:
                raise ValueError(
                    f"weighted relations need edge weights attached: {missing}"
                )
        else:
            weighted_rels = []
        self.weighted_rels = frozenset(weighted_rels)
        self.dev_topos = self._init_topo()
        self._seed_capacity = seed_capacity
        if frontier_caps not in (None, "auto"):
            raise ValueError(
                f"frontier_caps must be None or 'auto', got {frontier_caps!r}"
            )
        self._auto_caps = frontier_caps == "auto"
        self._auto_margin = float(auto_margin)
        if self._auto_margin < 1.0:
            raise ValueError(f"auto_margin must be >= 1.0, got {auto_margin}")
        # per-layer {type: cap} overrides planned from observed counts
        self._cap_overrides: tuple | None = None
        self._rel_index = {et: i for i, et in enumerate(topo.edge_types)}
        self.seed = int(seed)
        self._call = 0
        self.reruns = 0

    def _init_topo(self):
        """Place every relation's CSR on the sampling device."""
        return self.topo.to_device(self.mode, with_eid=self.with_eid,
                                   weighted_rels=self.weighted_rels,
                                   device=self.device)

    # -- planning ------------------------------------------------------------

    def _plan(self, seed_cap: int, overrides: tuple | None = None):
        """Per-hop (active relations, caps before, caps after).

        ``overrides`` (auto mode): per-layer ``{type: planned cap}``; each
        is clamped into [previous hop's cap, worst case], so the
        seeds-first invariant holds whatever was observed.
        """
        caps = {self.input_type: seed_cap}
        plans = []
        for li, layer in enumerate(self.sizes):
            active = {
                et: k for et, k in layer.items()
                if caps.get(et[2], 0) > 0 and k > 0
            }
            caps_next = dict(caps)
            for et, k in active.items():
                s_t, _, d_t = et
                caps_next[s_t] = caps_next.get(s_t, 0) + caps[d_t] * k
            for t in caps_next:
                # clamp growth at the type's node count, never below the
                # previous hop's cap: forced (seeds-first) lanes keep
                # duplicates as distinct slots
                worst = _round_up(
                    max(min(caps_next[t], self.topo.num_nodes[t]),
                        caps.get(t, 0)),
                    8,
                )
                cap = worst
                if overrides is not None and t in overrides[li]:
                    cap = _round_up(int(overrides[li][t]), 128)
                    cap = max(cap, caps.get(t, 0), 128)
                    cap = min(cap, worst)
                caps_next[t] = cap
            plans.append((active, dict(caps), caps_next))
            caps = caps_next
        return tuple(plans)

    def _plan_auto(self, observed: Sequence[dict]) -> None:
        """Fold a run's per-layer unclipped unique counts into the cap
        overrides (margin headroom; never shrinking below a previous plan)."""
        old = self._cap_overrides or tuple({} for _ in observed)
        new = []
        for obs, prev in zip(observed, old):
            layer = dict(prev)
            for t, n in obs.items():
                want = int(self._auto_margin * int(n))
                layer[t] = max(want, prev.get(t, 0))
            new.append(layer)
        self._cap_overrides = tuple(new)

    def _bits_seam(self, cap: int, key: tuple):
        """``bits(hop, edge_type, shape)``: the raw draws of a relation's
        hop at seed capacity ``cap``, from a generator seeded by ``key +
        (hop, relation index)`` over the relation's worst-case rows, cut
        to the rows it needs (so an auto sampler's rerun repeats them)."""
        worst = self._plan(cap)

        def bits(hop, et, shape):
            k = worst[hop][0][et]
            weighted = et in self.weighted_rels
            rows = max(worst[hop][1][et[2]], shape[0])
            g = seeded_generator(self.device, *key, hop, self._rel_index[et])
            draws = hop_draws((rows,), k, g, weighted=weighted)
            if weighted:
                return draws[:shape[0]]
            return tuple(d[:shape[0]] for d in draws)

        return bits

    # -- public API ----------------------------------------------------------

    def sample(self, input_nodes, draw_fn=None) -> HeteroSampleOutput:
        """Sample typed k-hop neighbourhoods of ``input_nodes`` (ids of
        ``input_type``).

        ``draw_fn(hop, edge_type, deg)`` replaces the generator draws: it
        receives the relation's ``(S,)`` int32 degrees at that hop (0 on
        invalid rows) and returns ``(S, k)`` int32 row-local offsets, or on
        a weighted relation ``(S, k)`` float32 uniforms in ``[0, 1)``.
        """
        seeds = np.asarray(input_nodes)
        batch = int(seeds.shape[0])
        check_seed_range(seeds, self.topo.num_nodes[self.input_type])
        cap = self._seed_capacity or max(_round_up(batch, 128), 128)
        if batch > cap:
            raise ValueError(f"batch {batch} exceeds seed_capacity {cap}")
        padded = np.full(cap, -1, dtype=np.int32)
        padded[:batch] = seeds
        self._call += 1
        seam = self._draw_seam(cap, draw_fn, (self.seed, self._call))
        dev_seeds = torch.from_numpy(padded).to(self.device)

        def run():
            plans = self._plan(cap, self._cap_overrides if self._auto_caps
                               else None)
            return hetero_multilayer_sample(
                self.dev_topos, dev_seeds, batch, self.input_type, plans,
                weighted_rels=self.weighted_rels, with_eid=self.with_eid,
                **self._dedup_args(), **seam)

        frontier, counts, layers, overflow, fcounts = run_auto_caps(
            self, run, lambda o: read_counts(o[3], o[4]), self._plan_auto,
            lambda: self._cap_overrides, "hetero auto caps")
        return HeteroSampleOutput(frontier, counts, batch, layers, overflow,
                                  fcounts)

    def sample_padded(self, seeds, num_seeds, generator=None, draw_fn=None):
        """Sample already-padded device seeds with no host read: the
        sampler call of a streamed train step (the JAX package's compiled
        ``run`` of ``_compiled(seed_cap)``).

        ``seeds`` is a ``(cap,)`` int32 tensor on the sampler's device, -1
        past ``num_seeds`` (an int or a device scalar). The caps are the
        ones planned for ``cap``: an auto sampler is neither planned nor
        regrown here, and the overflow comes back as a device tensor. Each
        relation's hop is one launch of its fused kernel, as in
        :meth:`sample`.

        Draws: ``draw_fn(hop, edge_type, deg)`` as in :meth:`sample`; else
        the hop of relation ``r`` draws from a generator seeded by
        ``(generator.initial_seed(), hop, r)`` (``generator`` plays a JAX
        key: it is read, not advanced); with neither, from the sampler's
        own stream, as :meth:`sample` draws (the call counter advances).
        The outputs are bitwise :meth:`sample`'s for the same seeds, caps
        and draws.

        Returns ``(frontier {type: ids}, counts {type: 0-d}, layers deepest
        first, overflow, per-hop unclipped unique counts)``, all on the
        device.
        """
        seeds = torch.as_tensor(seeds, device=self.device).to(torch.int32)
        cap = int(seeds.shape[0])
        if generator is not None:
            key = (generator.initial_seed(),)
        else:
            self._call += 1
            key = (self.seed, self._call)
        plans = self._plan(cap, self._cap_overrides if self._auto_caps else None)
        return hetero_multilayer_sample(
            self.dev_topos, seeds, num_seeds, self.input_type, plans,
            weighted_rels=self.weighted_rels, with_eid=self.with_eid,
            **self._dedup_args(), **self._draw_seam(cap, draw_fn, key))

    def _dedup_args(self) -> dict:
        """The per-type dedup's arguments for :attr:`dedup`: the node
        counts bound the ``"map"`` strategy's position maps."""
        return {"node_bounds": dedup_bound(
            self.dedup, {t: int(n) for t, n in self.topo.num_nodes.items()})}

    def _draw_seam(self, cap: int, draw_fn, key: tuple) -> dict:
        """The relation hops' draws of one call at seed capacity ``cap``,
        as the ``hetero_multilayer_sample`` seam: ``draw_fn``'s, or the raw
        bits of :meth:`_bits_seam` under ``key``."""
        if draw_fn is None:
            return {"bits": self._bits_seam(cap, key)}

        def draw(hop, et, deg):
            return torch.as_tensor(draw_fn(hop, et, deg), device=self.device)

        return {"draw": draw}
