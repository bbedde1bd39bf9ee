"""Access-frequency sketch of the cache controller: measured heat over the
row space.

The port of ``quiver_tpu/control/freq.py``. The reference plans its
hot/cold placement once from node degree; this module measures the running
workload's access distribution instead, in two structures:

* a **positional histogram** (:func:`row_heat_histogram`): every gathered
  id lands one count in a bounded ``(num_bins,)`` vector binned over the
  store's translated row order. The binning is monotone in the translated
  index (``bin = row // rows_per_bin``), so the mass below any candidate
  tier boundary reads straight off the histogram, which is the cost
  model's input (:func:`~.cost.predicted_hit_rates`);
* an **exact top-K heavy-hitter set** (host side, SpaceSaving): original
  node ids with estimated hit counts, fed from every host-visible id
  stream (serve batches, eager gathers, degree priors). It names the rows
  a repin pins.

Both decay with an EMA between epochs (:meth:`FreqSketch.decay`), so heat
tracks the current traffic mix rather than the run's whole history.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

__all__ = ["FreqSketch", "heat_num_bins", "row_heat_histogram"]


def heat_num_bins(num_rows: int, num_bins: int = 256) -> int:
    """The histogram width for a ``num_rows``-row store: ``num_bins``
    capped at the row count."""
    return max(1, min(int(num_bins), int(num_rows)))


def _host(x) -> np.ndarray:
    """``x`` as a numpy array (a torch tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def row_heat_histogram(n_id, feature_order, num_rows: int, num_bins: int):
    """Per-row access-heat histogram over the translated row space.

    ``n_id`` are the gather's original node ids (``-1`` marks an invalid
    lane and counts nothing); ``feature_order`` the store's node id ->
    translated row map (None is the identity). Bin ``b`` covers
    translated rows ``[b * rpb, (b + 1) * rpb)`` with ``rpb =
    ceil(num_rows / num_bins)``. Returns an int32 ``(num_bins,)`` tensor on
    ``n_id``'s device.
    """
    n_id = torch.as_tensor(n_id)
    valid = (n_id >= 0).reshape(-1)
    ids = torch.where(n_id >= 0, n_id, 0).to(torch.int64).reshape(-1)
    if feature_order is not None:
        order = torch.as_tensor(feature_order, device=ids.device)
        ids = order[ids].to(torch.int64)
    rpb = -(-num_rows // num_bins)  # ceil; bins stay < num_bins
    bins = torch.clamp(ids // rpb, 0, num_bins - 1)
    return torch.zeros(num_bins, dtype=torch.int32, device=ids.device).index_add_(
        0, bins, valid.to(torch.int32))


class FreqSketch:
    """Host-side access-heat state: EMA'd positional histogram + exact
    top-K heavy hitters.

    Args:
      num_rows: the store's row count (fixes the bin -> row mapping).
      num_bins: histogram width (capped at ``num_rows``).
      top_k: heavy-hitter capacity. SpaceSaving eviction: a new id
        replaces the current minimum and inherits its count (an estimate
        never below the true count), so the top of the set is exact once
        an id is genuinely frequent. The victim is the JAX sketch's, the
        first minimum in insertion order, found through a heap of
        ``(count, insertion number, id)`` entries instead of a scan of the
        whole set: a serve batch brings hundreds of new ids, and a scan
        per id cost about 13 ms a batch of 8 at ``top_k=1024``.
      decay: EMA factor applied by :meth:`decay` (``heat *= decay``).
    """

    def __init__(self, num_rows: int, num_bins: int = 256,
                 top_k: int = 1024, decay: float = 0.5):
        if num_rows < 1:
            raise ValueError(f"num_rows must be >= 1, got {num_rows}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.num_rows = int(num_rows)
        self.num_bins = heat_num_bins(num_rows, num_bins)
        self.rows_per_bin = -(-self.num_rows // self.num_bins)
        self.top_k = int(top_k)
        self.decay_factor = float(decay)
        # EMA'd translated-bin heat (float64: the EMA makes counts fractional)
        self.heat = np.zeros(self.num_bins, np.float64)
        # heavy hitters: original node id -> estimated hit count, in
        # insertion order; _seq numbers each id's insertion, and _heap holds
        # (count, seq, id) entries, stale ones skipped when they surface
        self._hitters: dict[int, float] = {}
        self._seq: dict[int, int] = {}
        self._heap: list[tuple[float, int, int]] = []
        self._next_seq = 0
        self.observed = 0  # raw hits ever folded in (before decay)

    # -- feeding -------------------------------------------------------------

    def observe_histogram(self, hist) -> None:
        """Fold one heat histogram in (``(num_bins,)``, or a stack
        ``(steps, num_bins)``, summed over steps)."""
        arr = _host(hist).astype(np.float64)
        if arr.ndim == 2:
            arr = arr.sum(axis=0)
        if arr.shape != (self.num_bins,):
            raise ValueError(
                f"histogram shape {arr.shape} != ({self.num_bins},)"
            )
        self.heat += arr
        self.observed += int(arr.sum())

    def observe_ids(self, ids, weight: float = 1.0) -> None:
        """Fold a host-visible original-node-id stream in (serve batches,
        eager gathers). Updates the heavy-hitter set only: the histogram is
        fed by the gather's own histogram, and ids at this boundary are
        not translated."""
        ids = _host(ids).reshape(-1)
        ids = ids[ids >= 0]
        if ids.size == 0:
            return
        uniq, counts = np.unique(ids, return_counts=True)
        self.observed += int(counts.sum())
        for i, c in zip(uniq.tolist(), counts.tolist()):
            self._bump(int(i), float(c) * weight)

    def observe_prior(self, weights) -> None:
        """Fold a per-node prior in (e.g. degrees after a mutation) at low
        weight: one synthetic hit scaled by the node's share of the
        largest, so it breaks ties before traffic is measured and measured
        heat soon dominates it."""
        w = _host(weights).astype(np.float64).reshape(-1)
        if w.size == 0 or w.sum() <= 0:
            return
        top = np.argsort(-w, kind="stable")[: self.top_k]
        scale = float(w[top].max())
        for i in top.tolist():
            if w[i] > 0:
                self._bump(int(i), float(w[i]) / scale)

    def _bump(self, node: int, weight: float) -> None:
        if node in self._hitters:
            self._hitters[node] += weight
            self._push(node)
        elif len(self._hitters) < self.top_k:
            self._insert(node, weight)
        else:
            # SpaceSaving: evict the minimum, inherit its count
            victim = self._min_hitter()
            floor = self._hitters.pop(victim)
            del self._seq[victim]
            self._insert(node, floor + weight)

    def _insert(self, node: int, count: float) -> None:
        self._hitters[node] = count
        self._seq[node] = self._next_seq
        self._next_seq += 1
        self._push(node)

    def _push(self, node: int) -> None:
        heapq.heappush(self._heap, (self._hitters[node], self._seq[node], node))
        if len(self._heap) > 4 * self.top_k + 64:  # drop the stale entries
            self._rebuild_heap()

    def _min_hitter(self) -> int:
        """The first id in insertion order among those of least count
        (``min`` over the dict, as the JAX sketch takes it)."""
        while True:
            count, seq, node = self._heap[0]
            if self._seq.get(node) == seq and self._hitters[node] == count:
                return node
            heapq.heappop(self._heap)

    def _rebuild_heap(self) -> None:
        self._heap = [(c, self._seq[n], n) for n, c in self._hitters.items()]
        heapq.heapify(self._heap)

    # -- reading -------------------------------------------------------------

    def top_rows(self, k: int) -> np.ndarray:
        """The ``k`` hottest original node ids, hottest first (fewer when
        fewer have been observed)."""
        items = sorted(
            self._hitters.items(), key=lambda kv: (-kv[1], kv[0])
        )
        return np.array([i for i, _ in items[:k]], np.int64)

    def bin_mass_below(self, row: int) -> float:
        """EMA'd hit mass at translated rows ``[0, row)``, fractional
        inside the boundary bin (uniform within a bin)."""
        row = max(0, min(int(row), self.num_rows))
        full, part = divmod(row, self.rows_per_bin)
        mass = float(self.heat[:full].sum())
        if part and full < self.num_bins:
            mass += float(self.heat[full]) * part / self.rows_per_bin
        return mass

    @property
    def total_mass(self) -> float:
        return float(self.heat.sum())

    def decay(self) -> None:
        """Between-epoch EMA decay of both structures."""
        self.heat *= self.decay_factor
        for node in self._hitters:
            self._hitters[node] *= self.decay_factor
        self._rebuild_heap()

    def state(self) -> dict:
        """Snapshot for audit records and tests (copies, not views)."""
        return {
            "num_bins": self.num_bins,
            "observed": self.observed,
            "total_mass": self.total_mass,
            "hitters": dict(self._hitters),
        }
