"""quiver_tpu_torch's temporal hop (``set_edge_time``,
``temporal_window_counts``, ``sample_layer(time_window=)`` and
``GraphSageSampler(time_window=)``) against quiver_tpu.

JAX's uniform draws are replayed through the ``offs`` seam over the
in-window degrees (``kj, kr = split(key)``), so both sides draw the same
slots; the fused comparison runs the Pallas ``fused_sample_layer`` in
interpret mode.

Tolerance: bitwise for every integer output and for ``edge_time`` and
``cum_weights``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402
from quiver_tpu.ops.pallas.fused import fused_sample_layer as fused_layer_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops import sample as sample_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tgraph():
    """Pareto graph with timestamps on a coarse grid around 0 (ties, and
    -0.0 beside 0.0, keep CSR order) and weights set before the re-sort;
    rows 10..19 emptied."""
    coo = generate_pareto_graph(1000, 8.0, seed=2)
    coo = coo[:, (coo[0] < 10) | (coo[0] > 19)]
    rng = np.random.default_rng(8)
    t = (rng.integers(-10, 50, coo.shape[1]) / 50.0).astype(np.float64)
    t[rng.random(coo.shape[1]) < 0.05] = -0.0
    w = rng.random(coo.shape[1]).astype(np.float32)
    tj = qj.CSRTopo(edge_index=coo, edge_weight=w, edge_time=t)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=w, edge_time=t)
    assert tj.edge_count >= 2048  # the Pallas window
    return coo, t, w, tj, tt


def test_set_edge_time_bitwise(tgraph):
    _coo, _t, _w, tj, tt = tgraph
    for name in ("indices", "eid", "edge_time", "edge_weight", "cum_weights", "indptr"):
        _same(getattr(tt, name), getattr(tj, name))
    for r in range(tt.node_count):  # every row time-sorted
        assert np.all(np.diff(tt.edge_time[tt.indptr[r]:tt.indptr[r + 1]]) >= 0)


def test_set_edge_time_csr_order_bitwise(tgraph):
    coo, t, _w, _tj, _tt = tgraph
    tj = qj.CSRTopo(edge_index=coo).set_edge_time(t, coo_order=False)
    tt = qt.CSRTopo(edge_index=coo).set_edge_time(t, coo_order=False)
    for name in ("indices", "eid", "edge_time"):
        _same(getattr(tt, name), getattr(tj, name))
    assert tt.cum_weights is None


@pytest.mark.parametrize("bad,match", [(np.array([0.0, np.inf, 1.0]), "finite"),
                                       (np.array([0.0, 1.0]), "entries")])
def test_bad_times_rejected(bad, match):
    ei = np.array([[0, 0, 1], [1, 2, 0]])
    for pkg in (qj, qt):
        with pytest.raises(ValueError, match=match):
            pkg.CSRTopo(edge_index=ei, edge_time=bad)


@pytest.mark.parametrize("window", [(0.2, 0.6), (0.5, 0.5), (0.9, 0.1), (-1.0, 2.0), (0.33, 0.34)])
def test_temporal_window_counts_bitwise(tgraph, window):
    _coo, _t, _w, tj, tt = tgraph
    dj = tj.to_device(with_times=True)
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, tj.node_count, 60)
    seeds[:3] = [12, 999, int(np.argmax(tj.degree))]
    base = tj.indptr[seeds]
    deg = (tj.indptr[seeds + 1] - base).astype(np.int32)
    fj, dj_t = sample_j.temporal_window_counts(dj.edge_time, jnp.asarray(base),
                                               jnp.asarray(deg), *window, dj.search_iters)
    ft, dt_t = sample_t.temporal_window_counts(torch.from_numpy(tt.edge_time),
                                               torch.from_numpy(base), torch.from_numpy(deg),
                                               *window, dj.search_iters)
    _same(ft.numpy(), fj)
    _same(dt_t.numpy(), dj_t)


def _jax_offsets(key, k):
    """The JAX uniform draw over the (in-window) degrees, as an offs seam."""
    kj, kr = jax.random.split(key)

    def draw(deg):
        d = jnp.asarray(deg.numpy())
        off, _ = sample_j.stratified_offsets(kj, d, k)
        return torch.from_numpy(np.array(sample_j.rotate_offsets(kr, off, d, k)))
    return draw


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("with_eid,topo_eid", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("window", [(0.2, 0.6), (0.0, 0.02)])
def test_temporal_sample_layer_bitwise(tgraph, k, with_eid, topo_eid, window):
    _coo, _t, _w, tj, tt = tgraph
    dj = tj.to_device(with_eid=topo_eid, with_times=True)
    dt = tt.to_device(device="cpu", with_eid=topo_eid, with_times=True)
    rng = np.random.default_rng(k)
    seeds = rng.integers(0, tj.node_count, 40).astype(np.int32)
    seeds[:2] = [15, int(np.argmax(tj.degree))]
    seeds[35:] = -1
    num = 33
    key = jax.random.PRNGKey(31 + k)
    args = (jnp.asarray(seeds), jnp.int32(num), k, key)
    want = sample_j.sample_layer(dj, *args, with_eid=with_eid, time_window=window)
    want_fused = fused_layer_j(dj, *args, time_window=window, with_eid=with_eid)
    got = sample_t.sample_layer(dt, torch.from_numpy(seeds), num, k, with_eid=with_eid,
                                time_window=window, offs=_jax_offsets(key, k))
    assert len(got) == len(want) == len(want_fused)
    for g, w, wf in zip(got, want, want_fused):
        _same(g.numpy(), w)
        _same(g.numpy(), wf)
    # every drawn edge lies in the window
    lo, hi = np.float32(window[0]), np.float32(window[1])
    if with_eid and not topo_eid:
        ts = tt.edge_time[got[2].numpy()[got[2].numpy() >= 0]]
        assert np.all((ts >= lo) & (ts <= hi))


def test_temporal_sampler_matches_jax_sampler_under_jax_draws(tgraph):
    _coo, _t, _w, tj, tt = tgraph
    sizes, window = [4, 3], (0.1, 0.7)
    sj = qj.GraphSageSampler(tj, sizes, seed=5, kernel="xla", dedup="sort",
                             with_eid=True, time_window=window)
    st = qt.GraphSageSampler(tt, sizes, device="cpu", seed=5, with_eid=True,
                             time_window=window)
    seeds = np.array([5, 7, 7, 300, 11, 15], np.int64)
    out_j = sj.sample(seeds)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)
    out_t = st.sample(seeds, draw_fn=lambda l, deg: _jax_offsets(subs[l], sizes[l])(deg))
    _same(out_t.n_id.numpy(), out_j.n_id)
    assert int(out_t.n_count) == int(out_j.n_count)
    for at, aj in zip(out_t.adjs, out_j.adjs):
        _same(at.edge_index.numpy(), aj.edge_index)
        _same(at.e_id.numpy(), aj.e_id)
        e = at.e_id.numpy()
        ts = _t[e[e >= 0]].astype(np.float32)  # e_id is a COO position
        assert np.all((ts >= np.float32(0.1)) & (ts <= np.float32(0.7)))
    for a, b in zip(out_t.edge_counts + out_t.frontier_counts,
                    out_j.edge_counts + out_j.frontier_counts):
        assert int(a) == int(b)


def test_temporal_guards(tgraph):
    coo, _t, _w, _tj, tt = tgraph
    bare = qt.CSRTopo(edge_index=coo)
    with pytest.raises(ValueError, match="edge timestamps"):
        qt.GraphSageSampler(bare, [2], device="cpu", time_window=(0, 1))
    with pytest.raises(ValueError, match="edge timestamps"):
        bare.to_device(device="cpu", with_times=True)
    with pytest.raises(ValueError, match="mode='GPU'"):
        tt.to_device("UVA", device="cpu", with_times=True)
    with pytest.raises(ValueError, match="time_window cannot be combined"):
        sample_t.sample_layer(tt.to_device(device="cpu", with_weights=True, with_times=True),
                              torch.zeros(2, dtype=torch.int32), 2, 2,
                              weighted=True, time_window=(0, 1), u=torch.rand(2, 2))
    with pytest.raises(ValueError, match="edge_time"):
        sample_t.sample_layer(bare.to_device(device="cpu"), torch.zeros(2, dtype=torch.int32),
                              2, 2, time_window=(0, 1), offs=torch.zeros(2, 2))
