"""quiver_tpu_torch's reindex in its default strategy (``"sort"``: no
``node_bound``, no ``scatter_free``) against all three quiver_tpu dedup
strategies (sort, map, scan). The port runs the map itself too (by JAX's
``node_bound``), and takes JAX's ``scatter_free`` for the scan, which runs
its sort; each is held against JAX's same strategy, and shown to run its
own work, in ``tests/test_torch_dedup.py``.

Tolerance: bitwise. Unique lists, counts, local ids and overflow are
integers; the port must equal each JAX strategy exactly, dtype included,
with duplicate seeds, padding, invalid neighbour lanes and frontier-cap
overflow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quiver_tpu.ops import reindex as rj  # noqa: E402

from quiver_tpu_torch.ops import reindex as rt  # noqa: E402

# (strategy name, JAX keyword arguments); "map" needs the id bound
STRATEGIES = [("sort", {}), ("map", {"node_bound": 50}), ("scan", {"scatter_free": True})]


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _case(seed, S=6, K=4, n=50):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, n, S).astype(np.int32)
    seeds[1] = seeds[0]  # duplicate seeds stay distinct forced slots
    seeds[-1] = -1
    nbr = rng.integers(0, n, (S, K)).astype(np.int32)
    nbr[rng.random((S, K)) < 0.25] = -1
    nbr[0, 0] = seeds[2]  # a neighbour equal to a seed maps to the seed
    return seeds, nbr


@pytest.mark.parametrize("name,kw", STRATEGIES)
@pytest.mark.parametrize("seed,cap,num", [(0, 40, 5), (1, 10, 5), (2, 7, 3), (3, 24, 0)])
def test_reindex_layer_bitwise(name, kw, seed, cap, num):
    seeds, nbr = _case(seed)
    want = rj.reindex_layer(jnp.asarray(seeds), jnp.int32(num), jnp.asarray(nbr),
                            cap, **kw)
    got = rt.reindex_layer(torch.from_numpy(seeds), num, torch.from_numpy(nbr), cap)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("name,kw", STRATEGIES)
@pytest.mark.parametrize("size,forced", [(30, 0), (30, 4), (5, 2), (64, 64)])
def test_masked_unique_bitwise(name, kw, size, forced):
    rng = np.random.default_rng(size + forced)
    ids = rng.integers(0, 50, 64).astype(np.int32)
    valid = rng.random(64) < 0.8
    want = rj.masked_unique(jnp.asarray(ids), jnp.asarray(valid), size,
                            num_forced=forced, **kw)
    got = rt.masked_unique(torch.from_numpy(ids), torch.from_numpy(valid), size,
                           num_forced=forced)
    for g, w in zip(got, want):
        _same(g, w)


def test_reindex_batched_equals_rows():
    """Leading batch dims dedup independently (the serving ladder's lanes)."""
    cases = [_case(s) for s in range(4)]
    seeds = torch.from_numpy(np.stack([c[0] for c in cases]))
    nbr = torch.from_numpy(np.stack([c[1] for c in cases]))
    num = torch.tensor([5, 3, 0, 5], dtype=torch.int32)
    batched = rt.reindex_layer(seeds, num, nbr, 12)
    for b in range(4):
        row = rt.reindex_layer(seeds[b], int(num[b]), nbr[b], 12)
        for x, y in zip(batched, row):
            np.testing.assert_array_equal(x[b].numpy(), y.numpy())


def test_seeds_first_and_overflow_reported():
    seeds = torch.tensor([7, 7, 3], dtype=torch.int32)
    nbr = torch.tensor([[1, 2], [7, -1], [4, 5]], dtype=torch.int32)
    frontier, n, col, ovf = rt.reindex_layer(seeds, 3, nbr, 5)
    assert frontier.tolist() == [7, 7, 3, 1, 2]
    assert int(n) == 5 and int(ovf) == 2
    assert col.tolist() == [[3, 4], [0, -1], [-1, -1]]
