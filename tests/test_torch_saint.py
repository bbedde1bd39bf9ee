"""GraphSAINT sampling of quiver_tpu_torch (``sampling/saint.py``) against
quiver_tpu's.

The same numpy-seeded power-law graphs (``generate_pareto_graph``, the
sizes of ``tests/test_saint.py``) go through both packages.

Tolerance: bitwise for every integer output: ``_membership``,
``saint_subgraph`` (HBM and HOST placement), and the three samplers and
``random_walk`` under JAX's replayed draws (``sample(draws=)``: the
``randint`` of ``fold_in(PRNGKey(seed), call)``, and each walk step's
offsets from the next ``split``). ``estimate_saint_norm`` over the same
draws: counts bitwise, norms within 1e-6 (float32 reductions). The port's
own draws are held to their laws: degree-proportional nodes (as
``tests/test_saint.py`` holds the JAX draw) and uniform walk steps.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402
from quiver_tpu.sampling import saint as saint_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.sampling import saint as saint_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


def _topos(n, deg, seed):
    ei = generate_pareto_graph(n, deg, seed=seed)
    return qj.CSRTopo(edge_index=ei), qt.CSRTopo(edge_index=ei)


def _same_subgraph(st, sj):
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_membership_matches_jax():
    rng = np.random.default_rng(0)
    for C in (1, 7, 64):
        nodes = rng.integers(0, 40, C).astype(np.int32)  # duplicates: first wins
        nodes[rng.random(C) < 0.2] = -1
        queries = rng.integers(-1, 45, (C, 9)).astype(np.int32)
        got = saint_t._membership(torch.from_numpy(nodes), torch.from_numpy(queries))
        want = saint_j._membership(jnp.asarray(nodes), jnp.asarray(queries))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


@pytest.mark.parametrize("deg_cap", ["max", 5])
def test_saint_subgraph_matches_jax_hbm_and_host(deg_cap):
    tj, tt = _topos(300, 6.0, 0)
    cap = tt.max_degree if deg_cap == "max" else deg_cap
    rng = np.random.default_rng(1)
    nodes = np.unique(rng.integers(0, 300, 80)).astype(np.int32)
    padded = np.full(96, -1, np.int32)
    padded[:len(nodes)] = nodes
    padded[len(nodes) - 3] = padded[2]  # a repeated id keeps its first slot
    want = saint_j.saint_subgraph(tj.to_device(), jnp.asarray(padded),
                                  jnp.int32(len(nodes)), deg_cap=cap)
    for mode in ("HBM", "HOST"):
        got = saint_t.saint_subgraph(tt.to_device(mode, "cpu"), torch.from_numpy(padded),
                                     len(nodes), cap)
        _same_subgraph(got, want)
    assert int(got.num_edges) > 0


def _jax_positions(seed, call, count, high):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), call)
    return torch.from_numpy(np.array(
        jax.random.randint(key, (count,), 0, high, dtype=jnp.int32)))


@functools.partial(jax.jit, static_argnums=2)
def _jax_offsets(key, deg, k):
    kj, kr = jax.random.split(key)
    off, _ = sample_j.stratified_offsets(kj, deg, k)
    return sample_j.rotate_offsets(kr, off, deg, k)


def _jax_walk_draws(key, walk_length):
    """``draw_fn(step, deg)`` replaying ``random_walk``'s key chain."""
    subs = []
    for _ in range(walk_length):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return lambda step, deg: torch.from_numpy(np.array(
        _jax_offsets(subs[step], jnp.asarray(deg.numpy()), 1)))


def _jax_rw_draws(seed, call, roots, n, walk_length):
    kr, kw = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), call))
    starts = np.array(jax.random.randint(kr, (roots,), 0, n, dtype=jnp.int32))
    return torch.from_numpy(starts), _jax_walk_draws(kw, walk_length)


def _replayed(kind, st, seed, call):
    """The draws JAX's sampler ``kind`` makes in call ``call``."""
    topo = st.csr_topo
    if kind == "rw":
        return _jax_rw_draws(seed, call, st.roots, topo.node_count, st.walk_length)
    high = topo.edge_count or topo.node_count
    return _jax_positions(seed, call, st.budget, high)


def _samplers(kind, tj, tt, seed):
    if kind == "node":
        return (qj.SAINTNodeSampler(tj, budget=64, seed=seed),
                qt.SAINTNodeSampler(tt, budget=64, seed=seed, device="cpu"))
    if kind == "edge":
        return (qj.SAINTEdgeSampler(tj, budget=32, seed=seed),
                qt.SAINTEdgeSampler(tt, budget=32, seed=seed, device="cpu"))
    return (qj.SAINTRandomWalkSampler(tj, roots=8, walk_length=3, seed=seed),
            qt.SAINTRandomWalkSampler(tt, roots=8, walk_length=3, seed=seed,
                                      device="cpu"))


@pytest.mark.parametrize("kind", ["node", "edge", "rw"])
def test_samplers_bitwise_under_jax_draws(kind):
    tj, tt = _topos(400, 6.0, 5)
    sj, st = _samplers(kind, tj, tt, seed=2)
    assert st.deg_cap == sj.deg_cap and st.budget == sj.budget
    for call in (1, 2):
        _same_subgraph(st.sample(draws=_replayed(kind, st, 2, call)), sj.sample())


def test_node_draw_without_edges_draws_nodes():
    """With no edges there is no degree law: the node draw takes uniform
    node ids, as JAX's does (the induction then has no window to read)."""
    indptr = np.zeros(11, np.int64)
    tj = qj.CSRTopo(indptr=indptr, indices=np.zeros(0, np.int64))
    tt = qt.CSRTopo(indptr=indptr, indices=np.zeros(0, np.int64))
    key = jax.random.PRNGKey(4)
    want = saint_j._degree_proportional_nodes(tj.to_device(), key, 8)
    draws = torch.from_numpy(np.array(jax.random.randint(key, (8,), 0, 10, jnp.int32)))
    got = saint_t._degree_proportional_nodes(tt.to_device(device="cpu"), draws, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st = qt.SAINTNodeSampler(tt, budget=8, seed=1, device="cpu")
    sub = st.sample()
    assert 0 < int(sub.num_nodes) <= 8 and int(sub.num_edges) == 0


def test_random_walk_matches_jax():
    tj, tt = _topos(300, 6.0, 4)
    starts = np.arange(16, dtype=np.int32)
    key = jax.random.PRNGKey(0)
    want = saint_j.random_walk(tj.to_device(), jnp.asarray(starts), 4, key)
    got = saint_t.random_walk(tt.to_device(device="cpu"), torch.from_numpy(starts), 4,
                              draw_fn=_jax_walk_draws(key, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_estimate_saint_norm_matches_jax():
    tj, tt = _topos(200, 6.0, 6)
    sj = qj.SAINTNodeSampler(tj, budget=50, seed=3)
    st = qt.SAINTNodeSampler(tt, budget=50, seed=3, device="cpu")

    class Replay:
        """The port's sampler fed JAX's draws, call by call."""
        csr_topo = tt

        def sample(self):
            return st.sample(draws=_replayed("node", st, 3, st._call + 1))

    norm_j, counts_j = saint_j.estimate_saint_norm(sj, num_iters=20)
    norm_t, counts_t = saint_t.estimate_saint_norm(Replay(), num_iters=20)
    np.testing.assert_array_equal(counts_t, counts_j)
    np.testing.assert_allclose(norm_t, norm_j, rtol=0, atol=1e-6)
    seen = counts_t > 0
    assert (norm_t[~seen] == 0).all()
    np.testing.assert_allclose(norm_t[seen].mean(), 1.0, rtol=1e-5)


def test_own_node_draws_are_degree_proportional():
    """``tests/test_saint.py``'s law for the JAX draw, on the port's own
    draws: zero-degree nodes never appear, and nodes above the median
    degree appear more often than those at or below it."""
    _, tt = _topos(60, 4.0, 8)
    s = qt.SAINTNodeSampler(tt, budget=64, seed=0, device="cpu")
    deg = tt.degree.astype(np.float64)
    counts = np.zeros(tt.node_count)
    for _ in range(200):
        pos = saint_t._uniform_positions(s._next_generator(), tt.edge_count, 64)
        nodes, num = saint_t._degree_proportional_nodes(s.topo, pos, 64)
        counts[nodes[:int(num)].numpy()] += 1
    assert counts[deg == 0].sum() == 0
    rate = counts / 200
    assert rate[deg > np.median(deg)].mean() > rate[(deg > 0) & (deg <= np.median(deg))].mean()
    # and the raw positions map to rows by the degree CDF
    pos = saint_t._uniform_positions(s._next_generator(), tt.edge_count, 20000)
    rows = np.searchsorted(tt.indptr, pos.numpy(), side="right") - 1
    freq = np.bincount(rows, minlength=tt.node_count) / 20000
    np.testing.assert_allclose(freq, deg / deg.sum(), atol=0.01)


def test_own_walk_steps_are_uniform():
    """4,000 walkers from one node: each CSR slot of its row is the first
    step with probability 1 / degree."""
    _, tt = _topos(300, 6.0, 4)
    node = int(np.argmax(tt.degree == 6))
    row = tt.indices[tt.indptr[node]:tt.indptr[node + 1]]
    g = torch.Generator().manual_seed(0)
    walks = saint_t.random_walk(tt.to_device(device="cpu"),
                                torch.full((4000,), node, dtype=torch.int32), 1, g)
    steps = walks[:, 1].numpy()
    assert np.isin(steps, row).all()
    for v in np.unique(row):
        np.testing.assert_allclose((steps == v).mean(), (row == v).mean(), atol=0.03)


def test_sampler_contracts():
    tj, tt = _topos(400, 6.0, 3)
    for s in (qt.SAINTNodeSampler(tt, 64, seed=0, device="cpu"),
              qt.SAINTEdgeSampler(tt, 32, seed=1, device="cpu"),
              qt.SAINTRandomWalkSampler(tt, 8, 3, seed=2, device="cpu")):
        a, b = s.sample(), s.sample()
        assert not torch.equal(a.node_id, b.node_id)  # new draws each call
        valid = a.node_id[a.node_id >= 0].numpy()
        assert 0 < int(a.num_nodes) == valid.shape[0] <= s.budget * (
            2 if isinstance(s, qt.SAINTEdgeSampler) else 1)
        assert np.unique(valid).shape == valid.shape
        src, dst = a.edge_index.numpy()
        nid = a.node_id.numpy()
        keep = src >= 0
        assert int(a.num_edges) == keep.sum()
        for u, v in zip(nid[src[keep]], nid[dst[keep]]):
            assert v in tt.indices[tt.indptr[u]:tt.indptr[u + 1]]
    with pytest.raises(ValueError, match="needs a graph with edges"):
        qt.SAINTEdgeSampler(qt.CSRTopo(indptr=np.zeros(3, np.int64),
                                       indices=np.zeros(0, np.int64)), 4, device="cpu")


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    _, tt = _topos(100, 4.0, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: qt.SAINTNodeSampler(tt, 8),
                 lambda: qt.SAINTEdgeSampler(tt, 8),
                 lambda: qt.SAINTRandomWalkSampler(tt, 4, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
