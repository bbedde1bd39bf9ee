"""The benchmark's inputs, made from seeds on the device: a graph and its
features (from the configuration's data seed), and the model's first
weights (from the run's ``--seed``).

The graph is a symmetric power-law graph: every node draws a degree from a
Pareto law with the configuration's exponent, scaled so that the degrees
sum to the published count of directed edges and capped at the assumed
largest degree; the degree stubs are then paired at random (the
configuration model), and each pair is stored in both directions. So the
in-degree is skewed as in the published datasets, which is what a
degree-ordered feature cache relies on. Self-loops and repeated edges that
the pairing makes are kept; the program and the reference both take a
graph with them.

Everything is made with a ``torch.Generator`` on the run's device, in a
few large calls. The same seed on the same kind of device gives the same
arrays, so the reference can make them again after the window.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Dataset", "derive_seed", "make_dataset", "make_edges", "make_weights",
           "power_law_degrees"]


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed mixed from ``seed`` and ``salt`` (numpy's
    SeedSequence), so nearby seeds give unrelated streams. ``seed`` may be
    any whole number that fits 64 bits."""
    words = [int(w) & 0xFFFFFFFFFFFFFFFF for w in (seed, *salt)]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) & 0x7FFFFFFFFFFFFFFF


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def power_law_degrees(num_nodes: int, num_edges: int, exponent: float, cap: int,
                      g: torch.Generator) -> torch.Tensor:
    """``(num_nodes,)`` int64 degrees that sum to ``num_edges``: Pareto
    draws ``u^(-1/exponent)`` times the smallest scale whose floored and
    capped degrees (at least 1) reach ``num_edges``, then one taken off
    as many nodes of degree above 1, in a seeded order, as the sum runs
    over."""
    if num_edges < num_nodes or num_edges > num_nodes * cap:
        raise ValueError(f"{num_edges} edges cannot give {num_nodes} nodes a "
                         f"degree in [1, {cap}]")
    dev = g.device
    u = torch.rand(num_nodes, generator=g, device=dev, dtype=torch.float64)
    base = (1.0 - u).pow(-1.0 / exponent)

    def degrees(scale: float) -> torch.Tensor:
        return torch.floor(base * scale).clamp(1, cap).to(torch.int64)

    lo, hi = 0.0, 1.0
    while int(degrees(hi).sum()) < num_edges:
        lo, hi = hi, hi * 2.0
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if int(degrees(mid).sum()) < num_edges:
            lo = mid
        else:
            hi = mid
    deg = degrees(hi)
    excess = int(deg.sum()) - num_edges
    order = torch.randperm(num_nodes, generator=g, device=dev)
    take = order[deg[order] > 1][:excess]
    if take.numel() < excess:
        raise ValueError("the degree cap leaves too few nodes to trim")
    deg[take] -= 1
    return deg


def make_edges(deg: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """``(2, E)`` int32 COO edges of the configuration model over degrees
    ``deg`` (``E = deg.sum()``, even): the stubs shuffled and paired, each
    pair stored as two directed edges, first ``u -> v`` for every pair,
    then ``v -> u``."""
    n = deg.shape[0]
    stubs = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=deg.device), deg)
    if stubs.shape[0] % 2:
        raise ValueError("the degrees must sum to an even number")
    stubs = stubs[torch.randperm(stubs.shape[0], generator=g, device=deg.device)]
    a, b = stubs[0::2], stubs[1::2]
    return torch.stack([torch.cat([a, b]), torch.cat([b, a])])


class Dataset(NamedTuple):
    edges: torch.Tensor  # (2, E) int32: row (the node) and its neighbour
    features: torch.Tensor  # (N, F) float32


def make_dataset(cfg: dict, device) -> Dataset:
    """The configuration's graph and features from its ``data_seed``, on
    ``device``; each part draws from its own stream."""
    seed = int(cfg["data_seed"])
    n, e = int(cfg["num_nodes"]), int(cfg["num_edges"])
    g = _generator(device, derive_seed(seed, 1))
    deg = power_law_degrees(n, e, float(cfg["assumed"]["degree_exponent"]),
                            int(cfg["assumed"]["degree_cap"]), g)
    edges = make_edges(deg, g)
    g = _generator(device, derive_seed(seed, 2))
    features = torch.randn(n, int(cfg["num_features"]), generator=g, device=device,
                           dtype=torch.float32)
    return Dataset(edges, features)


def make_weights(shapes: list[tuple[str, tuple[int, ...]]], seed: int,
                 device) -> dict[str, torch.Tensor]:
    """First weights for parameters of ``shapes`` (name, shape) from
    ``seed``: every matrix from one normal draw, scaled by
    ``1/sqrt(fan_in)`` (LeCun's normal), every vector zero. Both the
    program and the reference are handed these."""
    g = _generator(device, derive_seed(seed, 4))
    mats = [(name, shape) for name, shape in shapes if len(shape) == 2]
    total = sum(s[0] * s[1] for _, s in mats)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) == 2:
            size = shape[0] * shape[1]
            out[name] = flat[at:at + size].reshape(shape) / float(np.sqrt(shape[1]))
            at += size
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
