"""quiver_tpu_torch's weighted hop (K3's plain version, the weighted
``sample_layer`` and ``GraphSageSampler(weighted=True)``) against quiver_tpu.

* ``set_edge_weight``/``cum_weights`` against the JAX ``CSRTopo``, in COO and
  CSR order, with zero-total rows, and the same rejections.
* ``wselect_plain``/``fused_weighted_hop`` against the Pallas
  ``fused_weighted_hop`` (interpret mode on the CPU), on shared ``u``: both
  ``scale_u`` forms, with and without the eid lane, padded rows, -1 seeds,
  ``deg == 0``, ``deg <= k`` and zero-total-weight rows. The Pallas call
  needs ``edge_count >= 2048`` and ``max_degree <= 2048``; the fixture
  checks both.
* ``sample_layer(weighted=True, u=...)`` fed JAX's ``u01`` block against
  JAX ``sample_layer(weighted=True)`` and ``fused_sample_layer``, on GPU-
  and UVA-mode (CPU-placed) topologies; the sampler under JAX's key chain.
* The port's own draws against ``w / sum(w)`` on a star graph.

Tolerance: bitwise for every integer output and for ``cum_weights``; the
frequency test allows 4 standard errors of a multinomial frequency.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402
from quiver_tpu.ops.pallas.fused import (  # noqa: E402
    fused_sample_layer as fused_layer_j,
    fused_weighted_hop as whop_j,
)

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops import sample as sample_t  # noqa: E402
from quiver_tpu_torch.ops.kernels import fused as fused_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

WINDOW = 2048  # the Pallas kernels' default row window


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def wgraph():
    """A pareto graph with rows 10..19 emptied and rows 20..29 carrying
    all-zero weights (the uniform-prefix rows), exp(N(0,1)) weights
    elsewhere, as the products benchmark draws them."""
    coo = generate_pareto_graph(1000, 8.0, seed=1)
    coo = coo[:, (coo[0] < 10) | (coo[0] > 19)]
    w = np.exp(np.random.default_rng(6).normal(size=coo.shape[1])).astype(np.float32)
    w[(coo[0] >= 20) & (coo[0] < 30)] = 0.0
    tj = qj.CSRTopo(edge_index=coo, edge_weight=w)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=w)
    assert tj.edge_count >= WINDOW and tj.max_degree <= WINDOW
    assert (tj.degree[10:20] == 0).all()
    return coo, w, tj, tt


@pytest.mark.parametrize("coo_order", [True, False])
def test_cum_weights_bitwise(wgraph, coo_order):
    coo, w, _tj, _tt = wgraph
    tj = qj.CSRTopo(edge_index=coo).set_edge_weight(w, coo_order=coo_order)
    tt = qt.CSRTopo(edge_index=coo).set_edge_weight(w, coo_order=coo_order)
    _same(tt.edge_weight, tj.edge_weight)
    _same(tt.cum_weights, tj.cum_weights)
    # zero-total rows carry the uniform prefix 1..deg
    lo, hi = tt.indptr[20], tt.indptr[21]
    if coo_order:
        np.testing.assert_array_equal(tt.cum_weights[lo:hi], np.arange(1, hi - lo + 1))


def test_cum_weights_from_indptr_bitwise(wgraph):
    _coo, w, tj, _tt = wgraph
    kw = dict(indptr=tj.indptr, indices=tj.indices, edge_weight=w)
    _same(qt.CSRTopo(**kw).cum_weights, qj.CSRTopo(**kw).cum_weights)


@pytest.mark.parametrize("bad,match", [(np.array([1.0, -1.0, 2.0]), "non-negative"),
                                       (np.array([1.0, np.nan, 2.0]), "finite"),
                                       (np.array([1.0, 2.0]), "entries")])
def test_bad_weights_rejected(bad, match):
    ei = np.array([[0, 0, 1], [1, 2, 0]])
    for pkg in (qj, qt):
        with pytest.raises(ValueError, match=match):
            pkg.CSRTopo(edge_index=ei, edge_weight=bad)


def test_placement_search_iters(wgraph):
    _coo, _w, tj, tt = wgraph
    dj = tj.to_device(with_weights=True)
    for mode in ("GPU", "UVA"):
        dt = tt.to_device(mode, device="cpu", with_weights=True, with_eid=True)
        assert dt.search_iters == dj.search_iters == int(np.ceil(np.log2(tt.max_degree + 1)))
        _same(dt.cum_weights.numpy(), tj.cum_weights)
    assert tt.to_device(device="cpu").search_iters == 0
    with pytest.raises(ValueError, match="edge weights"):
        qt.CSRTopo(edge_index=np.array([[0], [1]])).to_device(device="cpu", with_weights=True)


def _hop_inputs(tj, S, k, seed):
    """Row starts/degrees of S seeds (some -1, the empty and zero-weight
    rows included, the last lanes padding) and a shared u01 block."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, tj.node_count, S).astype(np.int64)
    seeds[:4] = [12, 21, 25, int(np.argmax(tj.degree))]
    seeds[rng.random(S) < 0.1] = -1
    valid = seeds >= 0
    s = np.where(valid, seeds, 0)
    start = tj.indptr[s].astype(np.int64)
    deg = np.where(valid, tj.indptr[s + 1] - tj.indptr[s], 0).astype(np.int32)
    u01 = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (S, k), jnp.float32))
    return start, deg, u01


def _pallas_hop(tj, start, deg, u, k, iters, eid, scale_u):
    E = tj.edge_count
    start_wide = np.clip(start, 0, E - WINDOW)
    off0 = (start - start_wide).astype(np.int32)
    return whop_j(jnp.asarray(tj.indices.astype(np.int32)), jnp.asarray(tj.cum_weights),
                  jnp.asarray(start_wide.astype(np.int32)), jnp.asarray(off0),
                  jnp.asarray(deg), jnp.asarray(u), iters,
                  eid=None if eid is None else jnp.asarray(eid),
                  scale_u=scale_u)


@pytest.mark.parametrize("S,k", [(13, 4), (16, 9)])
@pytest.mark.parametrize("with_eid", [False, True])
@pytest.mark.parametrize("scale_u", [True, False])
def test_wselect_plain_matches_pallas_hop(wgraph, S, k, with_eid, scale_u):
    _coo, _w, tj, _tt = wgraph
    iters = tj.to_device(with_weights=True).search_iters
    start, deg, u = _hop_inputs(tj, S, k, S * k)
    if not scale_u:  # the caller scales by the row totals itself
        end = np.maximum(start + deg - 1, 0)
        u = u * np.where(deg > 0, tj.cum_weights[end], np.float32(1.0))[:, None]
    eid = tj.eid.astype(np.int32) if with_eid else None
    want = _pallas_hop(tj, start, deg, u, k, iters, eid, scale_u)
    mask = np.arange(k)[None, :] < np.minimum(deg, k)[:, None]
    args = (torch.from_numpy(tj.indices), torch.from_numpy(tj.cum_weights),
            torch.from_numpy(start), torch.from_numpy(deg), torch.from_numpy(u), iters)
    kw = dict(eid=None if eid is None else torch.from_numpy(eid), scale_u=scale_u)
    got = fused_t.wselect_plain(*args, **kw)
    got_hop = fused_t.fused_weighted_hop(*args, **kw)
    assert len(got) == len(want) == len(got_hop) == (3 if with_eid else 2)
    for g, h, w in zip(got, got_hop, want):
        _same(g.numpy(), np.where(mask, np.asarray(w), -1))
        _same(h.numpy(), g.numpy())
    assert fused_t.wselect.launches == 0  # CPU tensors never launch K3


def test_wselect_plain_empty_edges():
    out = fused_t.wselect_plain(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0), torch.zeros(3, dtype=torch.int64),
        torch.zeros(3, dtype=torch.int32), torch.rand(3, 2), 1)
    for o in out:
        _same(o.numpy(), np.full((3, 2), -1, np.int32))


def test_weighted_offsets_and_cdf_search_bitwise(wgraph):
    _coo, _w, tj, _tt = wgraph
    dj = tj.to_device(with_weights=True)
    k, key = 6, jax.random.PRNGKey(4)
    start, deg, _ = _hop_inputs(tj, 40, k, 3)
    base = start.astype(np.int32)
    off_j, mask_j = sample_j.weighted_offsets(key, dj.cum_weights, jnp.asarray(base),
                                              jnp.asarray(deg), k, dj.search_iters)
    u01 = torch.from_numpy(np.array(jax.random.uniform(key, (40, k), jnp.float32)))
    cw = torch.from_numpy(tj.cum_weights)
    off_t, mask_t = sample_t.weighted_offsets(cw, torch.from_numpy(start),
                                              torch.from_numpy(deg), k, dj.search_iters, u01)
    _same(off_t.numpy(), off_j)
    _same(mask_t.numpy(), mask_j)
    u = jnp.asarray(u01.numpy()) * 3.0
    _same(sample_t.cdf_search(cw, torch.from_numpy(np.array(u)), torch.from_numpy(start),
                              torch.from_numpy(deg), dj.search_iters).numpy(),
          sample_j._cdf_search(dj.cum_weights, u, jnp.asarray(base), jnp.asarray(deg),
                               dj.search_iters))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("with_eid,topo_eid", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("mode", ["GPU", "UVA"])
def test_weighted_sample_layer_bitwise(wgraph, k, with_eid, topo_eid, mode):
    _coo, _w, tj, tt = wgraph
    dj = tj.to_device(with_eid=topo_eid, with_weights=True)
    dt = tt.to_device(mode, device="cpu", with_eid=topo_eid, with_weights=True)
    rng = np.random.default_rng(k)
    seeds = rng.integers(0, tj.node_count, 40).astype(np.int32)
    seeds[:3] = [15, 22, int(np.argmax(tj.degree))]  # empty, zero-weight, hub
    seeds[[5, 17]] = seeds[3]  # duplicates
    seeds[35:] = -1  # padding
    num = 33  # lanes 33.. are invalid although 33, 34 hold ids
    key = jax.random.PRNGKey(21 + k)
    args = (jnp.asarray(seeds), jnp.int32(num), k, key)
    want = sample_j.sample_layer(dj, *args, with_eid=with_eid, weighted=True)
    want_fused = fused_layer_j(dj, *args, weighted=True, with_eid=with_eid)
    u01 = np.array(jax.random.uniform(key, (40, k), jnp.float32))
    got = sample_t.sample_layer(dt, torch.from_numpy(seeds), num, k, with_eid=with_eid,
                                weighted=True, u=lambda deg: torch.from_numpy(u01))
    got_fused = fused_t.fused_sample_layer(dt, torch.from_numpy(seeds), num, k,
                                           weighted=True, with_eid=with_eid,
                                           u=torch.from_numpy(u01))
    assert len(got) == len(want) == len(want_fused) == len(got_fused)
    for g, gf, w, wf in zip(got, got_fused, want, want_fused):
        _same(g.numpy(), w)
        _same(g.numpy(), wf)
        _same(gf.numpy(), w)


def test_weighted_batched_equals_rows(wgraph):
    """Leading batch dims are independent rows (the serving ladder)."""
    _coo, _w, _tj, tt = wgraph
    dt = tt.to_device(device="cpu", with_weights=True)
    rng = np.random.default_rng(0)
    seeds = torch.from_numpy(rng.integers(0, tt.node_count, (3, 10)).astype(np.int32))
    num = torch.tensor([10, 4, 0], dtype=torch.int32)
    u = torch.from_numpy(rng.random((3, 10, 4), dtype=np.float32))
    nbr, cnt = sample_t.sample_layer(dt, seeds, num, 4, weighted=True, u=u)
    for b in range(3):
        nb, cb = sample_t.sample_layer(dt, seeds[b], int(num[b]), 4, weighted=True, u=u[b])
        _same(nbr[b].numpy(), nb.numpy())
        _same(cnt[b].numpy(), cb.numpy())


def _star(weights):
    deg = len(weights)
    ei = np.stack([np.zeros(deg, np.int64), np.arange(1, deg + 1)])
    return qt.CSRTopo(edge_index=ei, edge_weight=np.asarray(weights, np.float32))


def test_weighted_draw_frequencies_match_weights():
    """The port's own draws (torch.rand u01) pick neighbour j with
    probability w_j / sum(w)."""
    w = np.array([1.0, 1.0, 2.0, 4.0, 8.0, 0.0, 0.5])
    dt = _star(w).to_device(device="cpu", with_weights=True)
    trials, k = 4000, 3
    g = torch.Generator().manual_seed(0)
    nbr, cnt = sample_t.sample_layer(dt, torch.zeros(trials, dtype=torch.int32), trials, k,
                                     g, weighted=True)
    assert bool((cnt == k).all())
    total = trials * k
    freq = np.bincount(nbr.numpy().ravel(), minlength=len(w) + 1)[1:] / total
    p = w / w.sum()
    se = np.sqrt(p * (1 - p) / total)
    assert np.all(np.abs(freq - p) <= 4 * se + 1e-12), (freq, p)
    assert freq[5] == 0.0  # a zero-weight edge is never drawn


def test_weighted_zero_total_row_is_uniform():
    dt = _star([0.0] * 6).to_device(device="cpu", with_weights=True)
    g = torch.Generator().manual_seed(1)
    nbr, _ = sample_t.sample_layer(dt, torch.zeros(3000, dtype=torch.int32), 3000, 2,
                                   g, weighted=True)
    freq = np.bincount(nbr.numpy().ravel(), minlength=7)[1:] / 6000
    se = np.sqrt((1 / 6) * (5 / 6) / 6000)
    assert np.all(np.abs(freq - 1 / 6) <= 4 * se)
    # a take-all row keeps CSR order
    nbr, cnt = sample_t.sample_layer(dt, torch.zeros(1, dtype=torch.int32), 1, 8,
                                     g, weighted=True)
    _same(nbr.numpy(), np.array([[1, 2, 3, 4, 5, 6, -1, -1]], np.int32))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_weighted_sampler_matches_jax_sampler_under_jax_draws(wgraph, kernel):
    """GraphSageSampler(weighted=True).sample with draw_fn replaying the
    JAX sampler's key chain gives the JAX SampleOutput bitwise."""
    _coo, _w, tj, tt = wgraph
    sizes = [4, 3]
    sj = qj.GraphSageSampler(tj, sizes, seed=9, kernel=kernel, dedup="sort",
                             with_eid=True, weighted=True)
    st = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True, weighted=True)
    seeds = np.array([5, 7, 7, 300, 11, 21, 999], np.int64)
    out_j = sj.sample(seeds)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 1)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draw_fn(l, deg):
        return np.array(jax.random.uniform(subs[l], (deg.shape[0], sizes[l]), jnp.float32))
    out_t = st.sample(seeds, draw_fn=draw_fn)
    _same(out_t.n_id.numpy(), out_j.n_id)
    assert int(out_t.n_count) == int(out_j.n_count)
    assert int(out_t.overflow) == int(out_j.overflow) == 0
    for at, aj in zip(out_t.adjs, out_j.adjs):
        assert at.size == aj.size and at.fanout == aj.fanout
        _same(at.edge_index.numpy(), aj.edge_index)
        _same(at.e_id.numpy(), aj.e_id)
    for a, b in zip(out_t.edge_counts + out_t.frontier_counts,
                    out_j.edge_counts + out_j.frontier_counts):
        assert int(a) == int(b)


def test_weighted_sampler_own_draws_stay_in_rows(wgraph):
    """The port's own draws: every edge joins a frontier node to one of
    its CSR neighbours, and a call is reproducible from the seed."""
    _coo, _w, _tj, tt = wgraph
    outs = [qt.GraphSageSampler(tt, [5, 3], device="cpu", seed=4, weighted=True)
            .sample(np.arange(40, 60)) for _ in range(2)]
    for a, b in zip(outs[0].adjs, outs[1].adjs):
        _same(a.edge_index.numpy(), b.edge_index.numpy())
    n_id = outs[0].n_id.numpy()
    for adj in outs[0].adjs:
        src, dst = adj.edge_index.numpy()
        for s, d in zip(src[src >= 0], dst[src >= 0]):
            row = tt.indices[tt.indptr[n_id[d]]:tt.indptr[n_id[d] + 1]]
            assert n_id[s] in row


def test_weighted_guards(wgraph):
    coo, _w, _tj, tt = wgraph
    bare = qt.CSRTopo(edge_index=coo)
    with pytest.raises(ValueError, match="weighted"):
        qt.GraphSageSampler(bare, [2], device="cpu", weighted=True)
    with pytest.raises(ValueError, match="time_window cannot be combined"):
        qt.GraphSageSampler(tt, [2], device="cpu", weighted=True, time_window=(0, 1))
    dt = bare.to_device(device="cpu")
    with pytest.raises(ValueError, match="cum_weights"):
        sample_t.sample_layer(dt, torch.zeros(2, dtype=torch.int32), 2, 2,
                              weighted=True, u=torch.rand(2, 2))
    with pytest.raises(ValueError, match="generator or u"):
        sample_t.sample_layer(tt.to_device(device="cpu", with_weights=True),
                              torch.zeros(2, dtype=torch.int32), 2, 2, weighted=True)
