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
repeats the draws. The ``draw_fn(hop, edge_type, deg)`` seam replaces
them (the tests feed it JAX's): it returns a uniform hop's int32 offsets
(K1's ``select`` then runs) or a weighted hop's float32 ``u01`` block
(K3's ``wselect``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.config import SampleMode, validate_dedup
from ..core.hetero import HeteroCSRTopo
from ..core.memory import resolve_device
from ..ops.reindex import masked_unique
from ..ops.sample import hop_draws, sample_layer, seeded_generator
from ..utils.trace import get_logger
from .sampler import Adj, _round_up

__all__ = ["HeteroGraphSampler", "HeteroLayer", "HeteroSampleOutput",
           "hetero_multilayer_sample"]


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


def hetero_multilayer_sample(dev_topos, seeds, num_seeds, input_type,
                             layer_plans, draw=None, bits=None,
                             weighted_rels=frozenset(), with_eid: bool = False):
    """The hetero sampling loop.

    ``layer_plans`` is a tuple of per-hop plans ``(rel_fanouts, caps_prev,
    caps_next)``: active edge types -> fanouts, and node types ->
    capacities before and after the hop. Each relation's hop draws through
    one of two seams: ``draw(hop, edge_type, deg)`` gives its int32
    offsets (``float32`` ``u01`` on a relation of ``weighted_rels``) from
    its degrees; ``bits(hop, edge_type, shape)`` its raw draws over rows of
    ``shape``, which a fused entry consumes. ``with_eid`` threads each
    relation's COO edge positions into every ``Adj.e_id``.

    Returns ``(frontier {type: ids}, counts {type: 0-d}, layers deepest
    first, overflow, per-hop unclipped unique counts seeds outward)``.
    """
    if (draw is None) == (bits is None):
        raise ValueError("hetero_multilayer_sample takes one of draw and bits")
    dev = seeds.device
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

        # 2) per-type dedup: the previous frontier first (forced), then each
        #    relation's samples of this source type, in sorted(str) order
        new_frontier, new_counts, locals_per_rel, layer_uniques = {}, {}, {}, {}
        for t, cap in caps_next.items():
            blocks, valids, spans = [], [], {}
            prev = frontier.get(t)
            n_prev = 0
            if prev is not None:
                n_prev = prev.shape[0]
                blocks.append(prev)
                lane = torch.arange(n_prev, device=dev)
                valids.append((lane < torch.as_tensor(counts[t], device=dev))
                              & (prev >= 0))
            for et in sorted(samples, key=str):
                if et[0] != t:
                    continue
                flat = samples[et].reshape(-1)
                spans[et] = (sum(b.shape[0] for b in blocks), flat.shape[0])
                blocks.append(flat)
                valids.append(flat >= 0)
            uniq, num_u, local = masked_unique(torch.cat(blocks),
                                               torch.cat(valids), cap,
                                               num_forced=n_prev)
            new_frontier[t] = uniq
            new_counts[t] = num_u.clamp(max=cap)
            layer_uniques[t] = num_u
            overflow = overflow + (num_u - cap).clamp(min=0)
            for et, (off, ln) in spans.items():
                locals_per_rel[et] = local[off:off + ln]

        # 3) one padded Adj per relation: src = local id in the new
        #    src-type frontier, dst = row in the previous dst-type frontier
        #    (its local id next hop, the previous nodes being forced first)
        adjs = {}
        for et, k in rel_fanouts.items():
            s_t, _, d_t = et
            S = frontier[d_t].shape[0]
            col = locals_per_rel[et].reshape(S, k)
            row = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
            row = torch.where(col >= 0, row, -1)
            edge_index = torch.stack([col.reshape(-1), row.reshape(-1)])
            e_id = None
            if with_eid:
                # neighbours dropped by frontier-cap overflow must not leak
                # their edge ids
                e_id = torch.where(col >= 0, eids[et], -1).reshape(-1)
            adjs[et] = Adj(edge_index, e_id, (caps_next[s_t], S), fanout=k)
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
      dedup: ``"sort"``, ``"map"``, ``"scan"`` or ``"auto"``, validated:
        the JAX package's three strategies give identical results, and each
        runs the port's one reindex, which gives them too.
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
        self.dedup = validate_dedup(str(dedup))
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
        self.dev_topos = topo.to_device(self.mode, with_eid=self.with_eid,
                                        weighted_rels=self.weighted_rels,
                                        device=self.device)
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
        n = self.topo.num_nodes[self.input_type]
        if batch and (seeds.min() < 0 or seeds.max() >= n):
            raise ValueError(
                f"seed ids must be in [0, {n}); got "
                f"[{seeds.min()}, {seeds.max()}]"
            )
        cap = self._seed_capacity or max(_round_up(batch, 128), 128)
        if batch > cap:
            raise ValueError(f"batch {batch} exceeds seed_capacity {cap}")
        padded = np.full(cap, -1, dtype=np.int32)
        padded[:batch] = seeds
        self._call += 1
        call = self._call
        # each relation's hop draws over its worst-case rows and takes the
        # prefix it needs, so an auto sampler's rerun repeats the draws
        worst = self._plan(cap)

        def bits(hop, et, shape):
            k = worst[hop][0][et]
            weighted = et in self.weighted_rels
            rows = max(worst[hop][1][et[2]], shape[0])
            g = seeded_generator(self.device, self.seed, call, hop,
                                 self._rel_index[et])
            draws = hop_draws((rows,), k, g, weighted=weighted)
            if weighted:
                return draws[:shape[0]]
            return tuple(d[:shape[0]] for d in draws)

        def draw(hop, et, deg):
            return torch.as_tensor(draw_fn(hop, et, deg), device=self.device)

        seam = {"draw": draw} if draw_fn is not None else {"bits": bits}
        dev_seeds = torch.from_numpy(padded).to(self.device)

        def run():
            plans = self._plan(cap, self._cap_overrides if self._auto_caps
                               else None)
            return hetero_multilayer_sample(
                self.dev_topos, dev_seeds, batch, self.input_type, plans,
                weighted_rels=self.weighted_rels, with_eid=self.with_eid,
                **seam)

        frontier, counts, layers, overflow, fcounts = run()
        if self._auto_caps:
            # one host sync per call reads the overflow and the counts;
            # regrowth is bounded and saturates at the worst-case caps
            # (then the clipped result and its overflow stand)
            first_plan = self._cap_overrides is None
            for _ in range(len(self.sizes) + 2):
                keys = [(li, t) for li, layer in enumerate(fcounts) for t in layer]
                ovf, *vals = torch.stack(
                    [overflow] + [fcounts[li][t] for li, t in keys]).tolist()
                if not first_plan and ovf == 0:
                    break
                observed = [{} for _ in fcounts]
                for (li, t), v in zip(keys, vals):
                    observed[li][t] = v
                before = self._cap_overrides
                self._plan_auto(observed)
                if self._cap_overrides != before:
                    get_logger().info(
                        "hetero auto caps %s: %s -> %s",
                        "planned" if before is None else "regrown",
                        before, self._cap_overrides,
                    )
                if not first_plan and self._cap_overrides == before:
                    break  # saturated: rerunning the same plan can't help
                if first_plan and ovf == 0:
                    break  # the worst-case first run was exact; keep it
                frontier, counts, layers, overflow, fcounts = run()
                self.reruns += 1
                first_plan = False
        return HeteroSampleOutput(frontier, counts, batch, layers, overflow,
                                  fcounts)
