"""GraphSAINT subgraph sampling.

The port of ``quiver_tpu/sampling/saint.py``: node-induced subgraph
extraction with padded shapes, the three GraphSAINT samplers (node, edge,
random walk) and the loss-normalisation estimate (Zeng et al.,
"GraphSAINT: Graph Sampling Based Inductive Learning Method").

A node budget ``C`` (padded with -1) and a per-node degree cap ``D``: the
induced edge set is a ``(2, C*D)`` padded local edge list. Membership is a
stable sort plus a binary search over the node set.

On a CUDA device the ``(C, D)`` neighbour window is read by kernel K2's
single-table gather (``gather_rows``, through ``staged_gather``; over UVA
when the topology is pinned on the host), as is the edge sampler's
endpoint lookup, and each random-walk step is one launch of K1's fused
uniform hop (``uniform_hop``, through ``sample_layer`` with k = 1).

Draws: call ``c`` of a sampler draws from ``seeded_generator(device,
seed, c)``. ``sample(draws=)`` replaces them (the tests feed it JAX's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.memory import resolve_device
from ..core.topology import CSRTopo
from ..ops.reindex import masked_unique
from ..ops.sample import sample_layer, seeded_generator, staged_gather

__all__ = [
    "SAINTEdgeSampler",
    "SAINTNodeSampler",
    "SAINTRandomWalkSampler",
    "SaintSubgraph",
    "estimate_saint_norm",
    "random_walk",
    "saint_subgraph",
]


class SaintSubgraph(NamedTuple):
    """Induced subgraph in local ids, padded with -1.

    node_id: ``(C,)`` global node ids (local id i is ``node_id[i]``).
    edge_index: ``(2, C*D)`` [src, dst] local ids, -1 where invalid.
    num_nodes: 0-d valid node count.
    num_edges: 0-d valid edge count.
    """

    node_id: torch.Tensor
    edge_index: torch.Tensor
    num_nodes: torch.Tensor
    num_edges: torch.Tensor


def _membership(nodes, queries):
    """Local id of each query in ``nodes``, or -1.

    nodes: ``(C,)`` ids, -1 padded, may repeat (the first occurrence wins,
    which the stable sort gives). queries: any shape (-1 lanes give -1).
    """
    C = nodes.shape[0]
    sent = torch.iinfo(nodes.dtype).max
    keyed = torch.where(nodes >= 0, nodes, sent)
    order = torch.argsort(keyed, stable=True)
    sorted_nodes = keyed[order]
    q = queries.to(nodes.dtype)
    pos = torch.searchsorted(sorted_nodes, q).clamp(max=C - 1)
    hit = (sorted_nodes[pos] == q) & (q >= 0)
    return torch.where(hit, order[pos], -1).to(torch.int32)


def saint_subgraph(topo, nodes, num_nodes, deg_cap: int) -> SaintSubgraph:
    """Node-induced subgraph over a placed CSR topology.

    For every valid node u of ``nodes`` (``(C,)`` ids, -1 padded, valid
    entries a prefix of ``num_nodes``; a repeated id keeps its first
    occurrence as its local id), scans up to ``deg_cap`` of u's neighbours
    in CSR order (edges past the cap are dropped: ``deg_cap >=
    max_degree`` is exact) and keeps each edge whose endpoint is in
    ``nodes``. The window read is one K2 ``gather_rows`` launch on a card.
    """
    C = nodes.shape[0]
    dev = nodes.device
    valid = (torch.arange(C, device=dev) < torch.as_tensor(num_nodes, device=dev)) \
        & (nodes >= 0)
    s = torch.where(valid, nodes, 0).to(torch.int64)
    base = topo.indptr[s]
    deg = torch.where(valid, (topo.indptr[s + 1] - base).to(torch.int32), 0)

    j = torch.arange(deg_cap, dtype=torch.int32, device=dev)[None, :]
    in_window = j < deg.clamp(max=deg_cap)[:, None]
    epos = base[:, None] + torch.where(in_window, j, 0).to(base.dtype)
    nbr = torch.where(in_window, staged_gather(topo.indices, epos), -1)

    dst_local = _membership(nodes, nbr)  # (C, D)
    src_local = torch.arange(C, dtype=torch.int32, device=dev)[:, None].expand(
        C, deg_cap)
    keep = (dst_local >= 0) & in_window
    edge_index = torch.stack([torch.where(keep, src_local, -1).reshape(-1),
                              torch.where(keep, dst_local, -1).reshape(-1)])
    return SaintSubgraph(nodes, edge_index, valid.sum().to(torch.int32),
                         keep.sum().to(torch.int32))


def _uniform_positions(generator, n: int, count: int):
    """``(count,)`` int64 draws uniform over ``[0, n)``."""
    return torch.randint(0, max(n, 1), (count,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def _degree_proportional_nodes(topo, draws, budget: int):
    """Degree-proportional nodes and their first-occurrence dedup.

    P(node) proportional to its degree is a uniform edge position mapped
    to its row: ``indptr`` is the degree CDF, so one ``searchsorted``
    gives the row. ``draws`` are the ``(budget,)`` edge positions, or, on
    a graph with no edges (no degree law), node ids drawn uniformly.
    """
    if topo.indices.shape[0] == 0:
        src = draws.to(torch.int32)
    else:
        r = draws.to(topo.indptr.dtype)
        src = (torch.searchsorted(topo.indptr, r, right=True) - 1).to(torch.int32)
    nodes, num, _ = masked_unique(src, torch.ones_like(src, dtype=torch.bool),
                                  budget)
    return nodes, num.clamp(max=budget)


def _uniform_edge_endpoints(topo, draws, budget: int):
    """The endpoints of ``budget`` uniform edges (``draws``, edge
    positions), deduplicated, under a ``2 * budget`` cap; the destination
    lookup is one K2 ``gather_rows`` launch on a card."""
    dst = staged_gather(topo.indices, draws).to(torch.int32)
    r = draws.to(topo.indptr.dtype)
    src = (torch.searchsorted(topo.indptr, r, right=True) - 1).to(torch.int32)
    both = torch.cat([src, dst])
    nodes, num, _ = masked_unique(both, both >= 0, 2 * budget)
    return nodes, num.clamp(max=2 * budget)


def random_walk(topo, starts, walk_length: int, generator=None, draw_fn=None):
    """Uniform random walks: ``(R,)`` int32 starts -> ``(R, walk_length +
    1)`` visited ids. A dead end (degree 0) stays in place, so every lane
    stays valid.

    Each step is ``sample_layer`` with k = 1 (one K1 ``uniform_hop``
    launch on a card) drawing from ``generator``; ``draw_fn(step, deg)``
    replaces the draws with the step's ``(R, 1)`` int32 offsets (then K1's
    ``select`` runs).
    """
    R = starts.shape[0]
    cur = starts.to(torch.int32)
    out = [cur]
    for step in range(walk_length):
        if draw_fn is None:
            nbr, _ = sample_layer(topo, cur, R, 1, generator)
        else:
            nbr, _ = sample_layer(topo, cur, R, 1,
                                  offs=lambda deg, step=step: draw_fn(step, deg))
        nxt = nbr[:, 0]
        cur = torch.where(nxt >= 0, nxt, cur)
        out.append(cur)
    return torch.stack(out, dim=1)


class _SaintSamplerBase:
    """Node-budget padding and the per-call draws.

    ``deg_cap`` defaults to the 99th-percentile degree, not the maximum:
    the induction reads ``(budget, deg_cap)`` blocks, and a power-law hub
    would inflate them by orders of magnitude for edges that mostly fail
    the membership test. Pass ``deg_cap=csr_topo.max_degree`` for exact
    induced subgraphs. ``device`` is the sampling device (CUDA unless
    named).
    """

    def __init__(self, csr_topo: CSRTopo, budget: int, deg_cap: int | None = None,
                 seed: int = 0, device=None):
        self.csr_topo = csr_topo
        self.budget = int(budget)
        if deg_cap is None:
            deg = csr_topo.degree
            p99 = int(np.percentile(deg, 99)) if deg.size else 1
            deg_cap = min(max(p99, 1), max(csr_topo.max_degree, 1))
        self.deg_cap = int(deg_cap)
        self.device = resolve_device(device)
        self.topo = csr_topo.to_device(device=self.device)
        self.seed = int(seed)
        self._call = 0

    def _next_generator(self) -> torch.Generator:
        self._call += 1
        return seeded_generator(self.device, self.seed, self._call)

    def _positions(self, draws, n: int, count: int):
        """This call's ``(count,)`` uniform draws over ``[0, n)``: ``draws``
        when given, else from the call's generator."""
        if draws is None:
            return _uniform_positions(self._next_generator(), n, count)
        self._call += 1
        return torch.as_tensor(draws, device=self.device).to(torch.int64)

    def sample(self, draws=None) -> SaintSubgraph:
        raise NotImplementedError


class SAINTNodeSampler(_SaintSamplerBase):
    """GraphSAINT-Node: ``budget`` nodes drawn with probability
    proportional to degree (the paper's importance distribution), then
    the subgraph they induce. ``sample(draws)`` takes the ``(budget,)``
    edge positions (node ids on a graph without edges)."""

    def sample(self, draws=None) -> SaintSubgraph:
        E = self.csr_topo.edge_count
        n = E if E else self.csr_topo.node_count
        pos = self._positions(draws, n, self.budget)
        nodes, num = _degree_proportional_nodes(self.topo, pos, self.budget)
        return saint_subgraph(self.topo, nodes, num, self.deg_cap)


class SAINTEdgeSampler(_SaintSamplerBase):
    """GraphSAINT-Edge: ``budget`` edges drawn uniformly, both endpoints as
    the node set (node budget 2 x edges), then the subgraph they induce.
    ``sample(draws)`` takes the ``(budget,)`` edge positions."""

    def __init__(self, csr_topo, budget, deg_cap=None, seed=0, device=None):
        if csr_topo.edge_count == 0:
            raise ValueError("SAINTEdgeSampler needs a graph with edges")
        super().__init__(csr_topo, budget, deg_cap, seed, device)

    def sample(self, draws=None) -> SaintSubgraph:
        pos = self._positions(draws, self.csr_topo.edge_count, self.budget)
        nodes, num = _uniform_edge_endpoints(self.topo, pos, self.budget)
        return saint_subgraph(self.topo, nodes, num, self.deg_cap)


class SAINTRandomWalkSampler(_SaintSamplerBase):
    """GraphSAINT-RW: ``roots`` uniform roots, each walking
    ``walk_length`` uniform steps; the visited set induces the subgraph.
    ``sample(draws)`` takes ``(starts, draw_fn)``: the ``(roots,)`` root
    ids and :func:`random_walk`'s ``draw_fn``."""

    def __init__(self, csr_topo, roots: int, walk_length: int,
                 deg_cap=None, seed=0, device=None):
        budget = roots * (walk_length + 1)
        super().__init__(csr_topo, budget, deg_cap, seed, device)
        self.roots = int(roots)
        self.walk_length = int(walk_length)

    def sample(self, draws=None) -> SaintSubgraph:
        n = self.csr_topo.node_count
        if draws is None:
            g = self._next_generator()
            starts, draw_fn = _uniform_positions(g, n, self.roots), None
        else:
            self._call += 1
            g, (starts, draw_fn) = None, draws
            starts = torch.as_tensor(starts, device=self.device)
        visited = random_walk(self.topo, starts.to(torch.int32), self.walk_length,
                              g, draw_fn).reshape(-1)
        nodes, num, _ = masked_unique(visited, visited >= 0, self.budget)
        return saint_subgraph(self.topo, nodes, num.clamp(max=self.budget),
                              self.deg_cap)


def estimate_saint_norm(sampler, num_iters: int = 50):
    """GraphSAINT's loss normalisation, estimated by pre-sampling.

    Runs ``num_iters`` draws and counts each node's appearances; returns
    ``(node_norm (N,) float32, counts (N,) int64)`` with ``node_norm[v]``
    ~ 1 / P(v in a subgraph), scaled to mean 1 over the nodes that
    appeared (GraphSAINT eq. 2's lambda); nodes never drawn get 0.
    """
    N = sampler.csr_topo.node_count
    counts = np.zeros(N, dtype=np.int64)
    for _ in range(num_iters):
        ids = sampler.sample().node_id.cpu().numpy()
        counts[ids[ids >= 0]] += 1
    freq = counts / num_iters
    norm = np.zeros(N, dtype=np.float32)
    seen = freq > 0
    norm[seen] = 1.0 / freq[seen]
    if seen.any():
        norm /= norm[seen].mean()
    return norm, counts
