"""Order-preserving deduplication with padded shapes.

The port of ``quiver_tpu/ops/reindex.py`` (``masked_unique``,
``reindex_layer`` and the reference's permutation helpers). Every id is
assigned the position of its first occurrence through a stable sort, so
the unique list comes out in first-occurrence order with the seeds first
(PyG's ``n_id[:batch_size]`` contract). The JAX package keeps three bit-identical strategies
(sort/map/scan); the port keeps the sort, which suits the small serving
frontiers and needs no ``(node_count,)`` scratch map per hop. Both
functions take optional leading batch dimensions, one independent dedup
per leading index.
"""

from __future__ import annotations

import torch

__all__ = ["complete_permutation", "inverse_permutation",
           "inverse_permutation_gather", "masked_unique", "reindex_layer"]

_SENTINEL = torch.iinfo(torch.int64).max


def masked_unique(ids, valid, size: int, num_forced: int = 0):
    """First-occurrence-order unique of ``ids[valid]``, padded to ``size``.

    Args:
      ids: ``(..., T)`` integer ids.
      valid: ``(..., T)`` bool mask.
      size: output capacity of the unique list.
      num_forced: the first ``num_forced`` valid lanes are kept as distinct
        outputs even when their values repeat (seed lanes, duplicates
        included); later duplicates map to the first occurrence.

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


def reindex_layer(seeds, num_seeds, neighbors, frontier_cap: int):
    """Per-layer reindex: frontier = unique(seeds ∪ neighbors), seeds first.

    Args:
      seeds: ``(..., S)`` seed ids, -1 padded; valid entries form a prefix.
      num_seeds: valid seed count, scalar or ``(...)``.
      neighbors: ``(..., S, K)`` sampled ids, -1 where invalid.
      frontier_cap: capacity of the output frontier.

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
                                            num_forced=S)
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
