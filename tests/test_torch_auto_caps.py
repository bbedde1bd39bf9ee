"""Auto frontier caps (``GraphSageSampler(frontier_caps="auto")``) of
quiver_tpu_torch: the port's mirror of ``tests/test_auto_caps.py``, and
the port's planner and replan loop against quiver_tpu's.

Tolerance: bitwise throughout (caps, counts, node ids and edges are
integers). An auto sampler draws each hop over its worst-case rows, so its
samples equal a worst-case sampler's with the same seed whatever its plan;
under JAX's draws (``draw_fn``) it equals the JAX auto sampler, call by
call, regrowth included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402


@pytest.fixture(scope="module")
def topo():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, 5000, size=(2, 30000)).astype(np.int64)
    return qt.CSRTopo(edge_index=ei)


def _sampler(topo, sizes, **kw):
    return qt.GraphSageSampler(topo, sizes, device="cpu", **kw)


def _valid_edges(out):
    edges = set()
    for li, adj in enumerate(out.adjs):
        src, dst = adj.edge_index.numpy()
        for s, d in zip(src, dst):
            if s >= 0:
                edges.add((li, int(s), int(d)))
    return edges


def test_auto_tightens_after_first_call(topo):
    s = _sampler(topo, [5, 5], seed_capacity=64, frontier_caps="auto", seed=1)
    worst = s._worst_caps(64)
    assert s._frontier_caps is None
    out1 = s.sample(np.arange(64))
    assert s._frontier_caps is not None and s.reruns == 0
    assert all(c <= w for c, w in zip(s._frontier_caps, worst))
    assert s._frontier_caps[-1] < worst[-1]  # a tighter deep cap
    assert list(s._frontier_caps) == sorted(s._frontier_caps)
    out2 = s.sample(np.arange(64))
    assert out2.n_id.shape[0] == s._frontier_caps[-1] < out1.n_id.shape[0]
    assert int(out2.overflow) == 0


@pytest.mark.parametrize("sizes,cap", [([4, 3], 32), ([5, 5], 64)])
def test_auto_matches_worst_case_results(topo, sizes, cap):
    """Same seed, same calls: the same valid samples, whatever the caps
    (at [5, 5] x 64 the planned deep cap is tighter than the worst case)."""
    a = _sampler(topo, sizes, seed_capacity=cap, seed=9)
    b = _sampler(topo, sizes, seed_capacity=cap, frontier_caps="auto", seed=9)
    seeds = np.random.default_rng(5).integers(0, topo.node_count, cap)
    for _ in range(3):  # including calls after b's plan tightened
        oa, ob = a.sample(seeds), b.sample(seeds)
        na, nb = int(oa.n_count), int(ob.n_count)
        assert na == nb
        np.testing.assert_array_equal(oa.n_id[:na].numpy(), ob.n_id[:nb].numpy())
        assert _valid_edges(oa) == _valid_edges(ob)
    assert (b._frontier_caps[-1] < a._worst_caps(cap)[-1]) == (cap == 64)


def test_auto_regrows_on_overflow(topo):
    """Plan on all-duplicate seeds (a tiny frontier), then a diverse batch
    must overflow, regrow and rerun with the same draws."""
    s = _sampler(topo, [4, 3], seed_capacity=32, frontier_caps="auto", seed=2,
                 auto_margin=1.0)
    s.sample(np.full(32, 7))
    tiny = s._frontier_caps
    out = s.sample(np.random.default_rng(0).integers(0, topo.node_count, 32))
    assert s._frontier_caps != tiny and s.reruns >= 1
    assert int(out.overflow) == 0
    assert all(c >= t for c, t in zip(s._frontier_caps, tiny))  # never shrinks
    ref = _sampler(topo, [4, 3], seed_capacity=32, seed=2)
    ref.sample(np.full(32, 7))
    oref = ref.sample(np.random.default_rng(0).integers(0, topo.node_count, 32))
    n = int(oref.n_count)
    assert int(out.n_count) == n
    np.testing.assert_array_equal(out.n_id[:n].numpy(), oref.n_id[:n].numpy())
    assert _valid_edges(out) == _valid_edges(oref)


def test_auto_margin_and_caps_validation(topo):
    with pytest.raises(ValueError, match="auto_margin"):
        _sampler(topo, [3], frontier_caps="auto", auto_margin=0.5)
    with pytest.raises(ValueError, match="one entry per layer"):
        _sampler(topo, [3, 2], frontier_caps=[128])
    with pytest.raises(ValueError, match="positive"):
        _sampler(topo, [3], frontier_caps=[0])


def test_edge_and_frontier_counts_reported(topo):
    s = _sampler(topo, [4, 3], seed_capacity=32, seed=0)
    out = s.sample(np.arange(32))
    assert len(out.edge_counts) == 2 and len(out.frontier_counts) == 2
    for c, adj in zip(out.edge_counts, out.adjs):  # deepest first
        assert int(c) == int((adj.edge_index[0] >= 0).sum())
    assert int(out.overflow) == 0
    assert int(out.frontier_counts[0]) == int(out.n_count)


@pytest.mark.parametrize("margin", [1.0, 1.25, 2.0])
def test_plan_auto_matches_jax(margin):
    """The same observed counts, call after call, plan the same caps."""
    rng = np.random.default_rng(int(margin * 4))
    ei = rng.integers(0, 3000, size=(2, 20000)).astype(np.int64)
    sj = qj.GraphSageSampler(qj.CSRTopo(edge_index=ei), [6, 4, 3],
                             frontier_caps="auto", auto_margin=margin, kernel="xla")
    st = _sampler(qt.CSRTopo(edge_index=ei), [6, 4, 3], frontier_caps="auto",
                  auto_margin=margin)
    for seed_cap in (64, 256):
        assert st._worst_caps(seed_cap) == sj._worst_caps(seed_cap)
        sj._frontier_caps = st._frontier_caps = None
        for _ in range(4):
            observed = sorted(rng.integers(1, 3500, 3).tolist())
            sj._plan_auto(seed_cap, observed)
            st._plan_auto(seed_cap, observed)
            assert st._frontier_caps == sj._frontier_caps


def _jax_draws(seed, call, sizes):
    """``draw_fn(layer, deg)`` replaying the JAX sampler's draws of call
    ``call`` (``fold_in(PRNGKey(seed), call)``, split per layer)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), call)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draw(l, deg):
        kj, kr = jax.random.split(subs[l])
        d = jnp.asarray(deg.numpy())
        off, _ = sample_j.stratified_offsets(kj, d, sizes[l])
        return torch.from_numpy(np.array(sample_j.rotate_offsets(kr, off, d, sizes[l])))
    return draw


def test_auto_matches_jax_auto_sampler_under_jax_draws():
    """Call by call (planning, a regrow and its rerun): the port's auto
    sampler fed JAX's draws gives the JAX auto sampler's caps and output."""
    ei = np.random.default_rng(1).integers(0, 4000, size=(2, 24000)).astype(np.int64)
    sizes = [4, 3]
    sj = qj.GraphSageSampler(qj.CSRTopo(edge_index=ei), sizes, seed=6,
                             seed_capacity=32, frontier_caps="auto",
                             auto_margin=1.0, kernel="xla", dedup="sort")
    st = _sampler(qt.CSRTopo(edge_index=ei), sizes, seed=6, seed_capacity=32,
                  frontier_caps="auto", auto_margin=1.0)
    batches = [np.full(32, 11), np.random.default_rng(2).integers(0, 4000, 32),
               np.random.default_rng(3).integers(0, 4000, 32)]
    for call, seeds in enumerate(batches, start=1):
        oj = sj.sample(seeds)
        ot = st.sample(seeds, draw_fn=_jax_draws(6, call, sizes))
        assert st._frontier_caps == sj._frontier_caps
        np.testing.assert_array_equal(ot.n_id.numpy(), np.asarray(oj.n_id))
        assert int(ot.n_count) == int(oj.n_count)
        assert int(ot.overflow) == int(oj.overflow) == 0
        for at, aj in zip(ot.adjs, oj.adjs):
            assert at.size == aj.size
            np.testing.assert_array_equal(at.edge_index.numpy(), np.asarray(aj.edge_index))
        for a, b in zip(ot.edge_counts + ot.frontier_counts,
                        oj.edge_counts + oj.frontier_counts):
            assert int(a) == int(b)
    assert st.reruns >= 1  # the diverse batch regrew the duplicate batch's plan
