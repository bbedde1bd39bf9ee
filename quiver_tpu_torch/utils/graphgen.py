"""Synthetic power-law graphs for tests and dataset-free runs.

A copy of ``quiver_tpu.utils.graphgen``: the same numpy draws from the
same seed, so both packages build the same graph.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_pareto_graph", "generate_uniform_graph"]


def generate_pareto_graph(
    num_nodes: int,
    avg_degree: float,
    alpha: float = 2.0,
    seed: int = 0,
    max_degree: int | None = None,
) -> np.ndarray:
    """Power-law (Pareto) out-degree graph as a (2, E) COO edge_index.

    Degrees are drawn from a Pareto(alpha) scaled to the requested mean,
    endpoints uniformly at random.
    """
    rng = np.random.default_rng(seed)
    # Pareto with mean alpha*m/(alpha-1); scale m so the mean is avg_degree.
    m = avg_degree * (alpha - 1.0) / alpha
    deg = rng.pareto(alpha, num_nodes) * m + 1.0
    if max_degree is None:
        max_degree = max(int(avg_degree * 64), 64)
    deg = np.minimum(deg.astype(np.int64), max_degree)
    total = int(deg.sum())
    row = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    col = rng.integers(0, num_nodes, size=total, dtype=np.int64)
    dtype = np.int32 if num_nodes <= np.iinfo(np.int32).max else np.int64
    return np.stack([row.astype(dtype), col.astype(dtype)])


def generate_uniform_graph(num_nodes: int, avg_degree: int, seed: int = 0) -> np.ndarray:
    """Uniform random graph as a (2, E) COO edge_index: ``num_nodes *
    avg_degree`` edges, both endpoints uniform."""
    rng = np.random.default_rng(seed)
    total = num_nodes * avg_degree
    dtype = np.int32 if num_nodes <= np.iinfo(np.int32).max else np.int64
    row = rng.integers(0, num_nodes, size=total, dtype=dtype)
    col = rng.integers(0, num_nodes, size=total, dtype=dtype)
    return np.stack([row, col])
