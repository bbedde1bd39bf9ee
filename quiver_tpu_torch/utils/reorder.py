"""Degree-based feature reordering (host-side numpy, runs once).

A copy of ``quiver_tpu.utils.reorder`` (``reorder_by_degree`` and the
reference-signature ``reindex_by_config``), bitwise equal:
sort nodes by descending degree so the hot tier of the feature cache holds
high-degree nodes, and shuffle the hot prefix.

Invariant: ``feature[ids] == new_feature[new_order[ids]]``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["reorder_by_degree", "reindex_by_config"]


def reorder_by_degree(
    feature: np.ndarray,
    degree: np.ndarray,
    hot_ratio: float,
    seed: int = 0,
    pin_top: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Reorder feature rows hot-first by degree.

    Args:
      feature: (N, F) node features.
      degree: (N,) node degrees (CSRTopo.degree).
      hot_ratio: fraction of rows in the hot tier; this prefix of the
        degree-sorted order is shuffled.
      seed: shuffle seed.
      pin_top: keep the top ``pin_top`` rows in strict descending-degree
        order (excluded from the shuffle).

    Returns:
      (new_feature, new_order) where new_order maps old node id -> new row,
      i.e. new_feature[new_order[i]] == feature[i].
    """
    n = feature.shape[0]
    if degree.shape != (n,):
        raise ValueError(f"degree shape {degree.shape} != ({n},)")
    hot_ratio = float(np.clip(hot_ratio, 0.0, 1.0))
    # stable argsort of -degree, so equal-degree nodes keep id order
    perm = np.argsort(-degree.astype(np.int64), kind="stable")
    hot = int(n * hot_ratio)
    pin = int(np.clip(pin_top, 0, hot))
    if hot - pin > 1:
        rng = np.random.default_rng(seed)
        rng.shuffle(perm[pin:hot])
    new_feature = feature[perm]
    new_order = np.empty(n, dtype=np.int64)
    new_order[perm] = np.arange(n, dtype=np.int64)
    if n <= np.iinfo(np.int32).max:
        new_order = new_order.astype(np.int32)
    return new_feature, new_order


def reindex_by_config(adj_csr, graph_feature, gpu_portion, seed: int = 0):
    """The reference's signature (``reindex_by_config(csr_topo, feature,
    gpu_portion)``) for :func:`reorder_by_degree`: returns
    ``(reordered_feature, new_order)``."""
    return reorder_by_degree(
        np.asarray(graph_feature), adj_csr.degree, gpu_portion, seed=seed
    )
