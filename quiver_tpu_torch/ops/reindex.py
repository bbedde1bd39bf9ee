"""Order-preserving deduplication with padded shapes.

The port of ``quiver_tpu/ops/reindex.py`` (``masked_unique``,
``reindex_layer`` and the reference's permutation helpers). Every id is
assigned the position of its first occurrence, so the unique list comes
out in first-occurrence order with the seeds first (PyG's
``n_id[:batch_size]`` contract). Two strategies find that position, with
the same outputs:

- ``"sort"``: a stable sort, a run-start scan, scatters back to the lanes
  and into the unique list;
- ``"map"`` (``node_bound=``): a scatter-min into a dense ``(node_bound,)``
  int32 position map per row, no sort (the reference's GPU hash table).

The JAX package's third strategy, ``"scan"`` (``scatter_free=True``),
avoids scatters, which are slow on a TPU; on the card it was slower than
the sort at every measured shape (``chip_smoke.py`` phase 9p), so the
name is accepted and runs the sort, with the same outputs.

Both functions take optional leading batch dimensions, one independent
dedup per leading index (the map is then ``(R, node_bound)``).
:func:`resolve_dedup` keeps the JAX package's contract for the strategy
names and ``QUIVER_DEDUP``; :func:`dedup_bound` turns a resolved name
into the functions' ``node_bound``.
"""

from __future__ import annotations

import os

import torch

from ..core.config import resolve_platform_strategy
from ..utils.trace import info_once

__all__ = ["complete_permutation", "dedup_bound", "inverse_permutation",
           "inverse_permutation_gather", "masked_unique", "reindex_layer",
           "resolve_dedup"]

DEDUP_STRATEGIES = ("sort", "map", "scan")

# QUIVER_DEDUP resolution caches, one environment read per process each
# (set QUIVER_DEDUP before the first sampler is built; tests reset these)
_forced_dedup: str | None = None
_auto_dedup: str | None = None


def _forced_dedup_env() -> str:
    """The ``QUIVER_DEDUP`` force, read once per process ("" = no force)."""
    global _forced_dedup
    if _forced_dedup is None:
        _forced_dedup = os.environ.get("QUIVER_DEDUP", "").strip()
    return _forced_dedup


def resolve_dedup(dedup: str) -> str:
    """Resolve a dedup strategy name, mapping ``"auto"`` to the default.

    The JAX package's contract: an explicit ``"sort"``, ``"map"`` or
    ``"scan"`` passes through, and a ``QUIVER_DEDUP`` force that differs
    from it is logged once (the force applies to ``"auto"`` only);
    ``"auto"`` takes a valid force, else the platform's default, both read
    once per process; an unknown name, or an unknown force, raises
    ``ValueError``.

    The default is ``"map"`` off the card, as the JAX package's CPU
    default, and ``"sort"`` when a CUDA device is present (the strategy
    the card's paths were built and timed with; ``chip_smoke.py`` phase
    9p times the map beside it there).
    """
    if dedup in DEDUP_STRATEGIES:
        forced = _forced_dedup_env()
        if forced and forced != dedup:
            info_once(
                f"dedup-env-ignored-{dedup}",
                "QUIVER_DEDUP=%s ignored for explicit dedup=%r (the env "
                "override applies only to dedup='auto')",
                forced, dedup,
            )
        return dedup
    if dedup != "auto":
        raise ValueError(
            f"dedup must be 'auto', 'sort', 'map', or 'scan', got {dedup!r}"
        )
    global _auto_dedup
    if _auto_dedup is None:
        _auto_dedup = resolve_platform_strategy(
            "QUIVER_DEDUP", DEDUP_STRATEGIES, tpu_default="sort",
            other_default="map",
        )
    return _auto_dedup


def dedup_bound(dedup: str, bound):
    """The ``node_bound`` that runs the resolved strategy ``dedup``:
    ``bound`` (an id bound, or the typed samplers' ``{type: bound}``)
    under ``"map"``, None under ``"sort"`` and ``"scan"``, which both run
    the sort. Raises ``ValueError`` on a name that is not a resolved
    strategy (``"auto"`` included), or on ``"map"`` with no bound."""
    if dedup not in DEDUP_STRATEGIES:
        raise ValueError(f"dedup must be one of {DEDUP_STRATEGIES} (resolved), "
                         f"got {dedup!r}")
    if dedup != "map":
        return None
    if bound is None:
        raise ValueError("dedup='map' needs a node bound")
    return bound


_SENTINEL = torch.iinfo(torch.int64).max


def _rep_by_map(ids2, valid2, node_bound: int):
    """``dedup="map"``: each lane's first-occurrence position from a dense
    ``(R, node_bound)`` int32 position map filled with ``T``: the valid
    lanes scatter-min their positions into it and every lane reads its
    id's slot back (the reference's hash table, whose atomicMin keeps the
    first occurrence). No sort. Ids index the map as JAX's do: a negative
    id counts from the end; a valid id outside the map is left out of the
    scatter, and its read clamps into the map (a wrong answer, as in the
    JAX package: ``node_bound`` must bound the ids)."""
    R, T = ids2.shape
    pos = torch.arange(T, dtype=torch.int32, device=ids2.device)
    slot = torch.where(valid2, ids2, 0).to(torch.int64)
    slot = torch.where(slot < 0, slot + node_bound, slot)
    inside = valid2 & (slot >= 0) & (slot < node_bound)
    # a lane left out writes the fill T into slot 0, which changes no slot
    first = torch.full((R, node_bound), T, dtype=torch.int32, device=ids2.device)
    first.scatter_reduce_(1, torch.where(inside, slot, 0),
                          torch.where(inside, pos, T), "amin")
    return torch.gather(first, 1, slot.clamp(0, node_bound - 1))


def masked_unique(ids, valid, size: int, num_forced: int = 0,
                  node_bound: int | None = None, scatter_free: bool = False):
    """First-occurrence-order unique of ``ids[valid]``, padded to ``size``.

    Args:
      ids: ``(..., T)`` integer ids.
      valid: ``(..., T)`` bool mask.
      size: output capacity of the unique list.
      num_forced: the first ``num_forced`` valid lanes are kept as distinct
        outputs even when their values repeat (seed lanes, duplicates
        included); later duplicates map to the first occurrence.
      node_bound: run ``dedup="map"``: a scatter-min into a dense
        ``(..., node_bound)`` int32 position map, no sort. Every valid id
        must lie in ``[0, node_bound)``: one past it gives a wrong answer
        and no error, as in the JAX package.
      scatter_free: JAX's ``dedup="scan"`` switch, accepted; the sort
        runs (the same outputs).

    Without ``node_bound``, ``dedup="sort"``: a stable sort and scatters.

    Returns:
      uniq: ``(..., size)`` unique ids in first-occurrence order, -1 padded.
      num_unique: ``(...)`` int32 total uniques found (may exceed ``size``).
      local: ``(..., T)`` int32 compact id of each element among the
        uniques, -1 for invalid or overflowed elements.
    """
    lead, T = ids.shape[:-1], ids.shape[-1]
    ids2 = ids.reshape(-1, T)
    valid2 = valid.reshape(-1, T)
    R = ids2.shape[0]
    dev = ids.device
    pos = torch.arange(T, device=dev, dtype=torch.int64)
    if node_bound is not None:
        rep_pos = _rep_by_map(ids2, valid2, int(node_bound)).to(torch.int64)
    else:
        vals = torch.where(valid2, ids2.to(torch.int64), _SENTINEL)
        # stable sort: within a run of equal values positions ascend, so a
        # run's first sorted element is the value's first occurrence
        sv, order = torch.sort(vals, dim=-1, stable=True)
        first = torch.ones_like(sv, dtype=torch.bool)
        first[:, 1:] = sv[:, 1:] != sv[:, :-1]
        first &= sv != _SENTINEL
        idx_first = torch.cummax(torch.where(first, pos, -1), dim=-1).values
        rep_sorted = torch.where(
            idx_first >= 0, torch.gather(order, 1, idx_first.clamp(min=0)), T)
        rep_pos = torch.empty_like(rep_sorted).scatter_(1, order, rep_sorted)

    forced = (pos < num_forced) & valid2
    is_rep = (valid2 & (rep_pos == pos)) | forced
    rank = torch.cumsum(is_rep.to(torch.int64), dim=-1) - 1
    num_unique = is_rep.sum(dim=-1).to(torch.int32)
    # representatives land at their rank; every other lane writes the
    # spare column `size`, which is cut off
    target = torch.where(is_rep & (rank < size), rank, size)
    uniq = torch.full((R, size + 1), -1, dtype=ids.dtype, device=dev)
    uniq.scatter_(1, target, ids2)
    local = torch.gather(rank, 1, rep_pos.clamp(max=max(T - 1, 0)))
    local = torch.where(valid2 & (local < size), local, -1).to(torch.int32)
    return (uniq[:, :size].reshape(*lead, size), num_unique.reshape(lead),
            local.reshape(*lead, T))


def reindex_layer(seeds, num_seeds, neighbors, frontier_cap: int,
                  node_bound: int | None = None, scatter_free: bool = False):
    """Per-layer reindex: frontier = unique(seeds ∪ neighbors), seeds first.

    Args:
      seeds: ``(..., S)`` seed ids, -1 padded; valid entries form a prefix.
      num_seeds: valid seed count, scalar or ``(...)``.
      neighbors: ``(..., S, K)`` sampled ids, -1 where invalid.
      frontier_cap: capacity of the output frontier.
      node_bound, scatter_free: the dedup strategy, as
        :func:`masked_unique` (``"map"`` with ``node_bound``, else
        ``"sort"``).

    Returns:
      frontier: ``(..., frontier_cap)`` unique ids, seeds first, -1 padded.
      num_frontier: ``(...)`` valid count, clipped to the capacity.
      col_local: ``(..., S, K)`` frontier-local id per neighbour, -1 where
        invalid (seed i's local id is i).
      overflow: ``(...)`` uniques dropped for exceeding ``frontier_cap``.
    """
    *lead, S, K = neighbors.shape
    flat = neighbors.reshape(*lead, S * K)
    ids = torch.cat([seeds, flat], dim=-1)
    num = torch.as_tensor(num_seeds, device=seeds.device)
    lane = torch.arange(S, device=seeds.device)
    seed_valid = (lane < num[..., None]) & (seeds >= 0)
    valid = torch.cat([seed_valid, flat >= 0], dim=-1)
    uniq, num_unique, local = masked_unique(ids, valid, frontier_cap,
                                            num_forced=S, node_bound=node_bound)
    col_local = local[..., S:].reshape(*lead, S, K)
    num_frontier = num_unique.clamp(max=frontier_cap)
    overflow = (num_unique - frontier_cap).clamp(min=0)
    return uniq, num_frontier, col_local, overflow


def inverse_permutation(p):
    """``q`` with ``q[p[i]] == i``, in ``p``'s dtype and on its device (the
    reference's ``inverse_permutation``), by one scatter."""
    n = p.shape[0]
    return torch.zeros_like(p).scatter_(
        0, p.to(torch.int64), torch.arange(n, dtype=p.dtype, device=p.device))


def inverse_permutation_gather(p):
    """:func:`inverse_permutation` without a scatter: the argsort of a
    permutation is its inverse. Returns int32."""
    return torch.argsort(p).to(torch.int32)


def complete_permutation(p, n: int):
    """Extend an injective partial map ``p`` (``m`` distinct values below
    ``n``) to a permutation of ``0..n-1``: ``p``'s entries first, in
    order, then the missing values ascending (the reference's
    ``complete_permutation``). Present values rank by their position in
    ``p``, absent ones at ``m + value``; the argsort of the ranks is the
    result, in ``p``'s dtype."""
    m = p.shape[0]
    if m > n:
        raise ValueError(f"partial permutation longer ({m}) than n ({n})")
    rank = torch.arange(n, dtype=p.dtype, device=p.device) + m
    rank.scatter_(0, p.to(torch.int64),
                  torch.arange(m, dtype=p.dtype, device=p.device))
    return torch.argsort(rank).to(p.dtype)
