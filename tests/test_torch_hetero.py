"""Heterogeneous topology and sampler of quiver_tpu_torch
(``core/hetero.py``, ``sampling/hetero.py``) against quiver_tpu's.

The same numpy-seeded typed graphs (``tests/test_hetero.py``'s toy schema:
120 papers, 60 authors, 20 institutions) go through both packages.

Tolerance: bitwise throughout. The CSR arrays, the errors, and, under
JAX's replayed draws (``draw_fn``: ``fold_in(PRNGKey(seed), call)``, one
``split`` per relation per hop, as ``tests/test_torch_auto_caps.py``
replays the homogeneous sampler), every ``n_id``, ``n_count``,
``Adj.edge_index``, ``e_id``, capacity, ``overflow`` and
``frontier_counts`` are integers. The port's own draws are checked by
what any sample must satisfy (real edges, seeds first, exact counts) and
by the auto sampler equalling a worst-case one.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.sampling import hetero as hetero_t  # noqa: E402

CITES, WRITES, EMPLOYS = (("paper", "cites", "paper"), ("author", "writes", "paper"),
                          ("inst", "employs", "author"))


def toy_schema(seed=0, n_paper=120, n_author=60, n_inst=20):
    """``tests/test_hetero.py``'s toy schema: ``(num_nodes, edges)``."""
    rng = np.random.default_rng(seed)
    edges = {
        CITES: np.stack([rng.integers(0, n_paper, 400), rng.integers(0, n_paper, 400)]),
        WRITES: np.stack([rng.integers(0, n_author, 300), rng.integers(0, n_paper, 300)]),
        EMPLOYS: np.stack([rng.integers(0, n_inst, 100), rng.integers(0, n_author, 100)]),
    }
    return {"paper": n_paper, "author": n_author, "inst": n_inst}, edges


def both_topos(seed=0, weights=False, **kw):
    num_nodes, edges = toy_schema(seed, **kw)
    tj, tt = qj.HeteroCSRTopo(num_nodes, edges), qt.HeteroCSRTopo(num_nodes, edges)
    if weights:
        wrng = np.random.default_rng(seed + 5)
        for et in edges:
            w = np.exp(wrng.normal(size=edges[et].shape[1])).astype(np.float32)
            tj.set_edge_weight(et, w)
            tt.set_edge_weight(et, w)
    return tj, tt, edges


def jax_draw_fn(sampler, seed, call):
    """``draw_fn(hop, edge_type, deg)`` replaying the JAX hetero sampler's
    draws of call ``call``: each (hop, relation) takes the next ``split``
    of ``fold_in(PRNGKey(seed), call)`` the first time it is drawn (in the
    loop's order), and the same key again on a regrowth rerun."""
    state = {"key": jax.random.fold_in(jax.random.PRNGKey(seed), call)}
    subs = {}

    def draw(hop, et, deg):
        if (hop, et) not in subs:
            state["key"], subs[(hop, et)] = jax.random.split(state["key"])
        sub, k = subs[(hop, et)], sampler.sizes[hop][et]
        if et in sampler.weighted_rels:
            return torch.from_numpy(np.array(jax.random.uniform(
                sub, (deg.shape[0], k), jnp.float32)))
        return torch.from_numpy(np.array(_jax_offsets(sub, jnp.asarray(deg.numpy()), k)))
    return draw


@functools.partial(jax.jit, static_argnums=2)
def _jax_offsets(key, deg, k):
    """JAX's uniform hop draw (``ops.sample.sample_layer``): stratified
    offsets, then the rotation, from the two halves of ``key``."""
    kj, kr = jax.random.split(key)
    off, _ = sample_j.stratified_offsets(kj, deg, k)
    return sample_j.rotate_offsets(kr, off, deg, k)


def assert_same_output(ot, oj):
    assert ot.batch_size == oj.batch_size
    # JAX's outputs leave jit with their dicts in sorted key order
    assert sorted(ot.n_id) == sorted(oj.n_id)
    for t in oj.n_id:
        np.testing.assert_array_equal(ot.n_id[t].numpy(), np.asarray(oj.n_id[t]), err_msg=t)
        assert int(ot.n_count[t]) == int(oj.n_count[t]), t
    assert int(ot.overflow) == int(oj.overflow)
    assert len(ot.frontier_counts) == len(oj.frontier_counts)
    for ft, fj in zip(ot.frontier_counts, oj.frontier_counts):
        assert {t: int(v) for t, v in ft.items()} == {t: int(v) for t, v in fj.items()}
    assert len(ot.adjs) == len(oj.adjs)
    for lt, lj in zip(ot.adjs, oj.adjs):
        assert lt.src_caps == lj.src_caps and lt.dst_caps == lj.dst_caps
        assert sorted(lt.adjs, key=str) == sorted(lj.adjs, key=str)
        for et, at in lt.adjs.items():
            aj = lj.adjs[et]
            assert at.size == tuple(aj.size) and at.fanout == aj.fanout, et
            np.testing.assert_array_equal(at.edge_index.numpy(),
                                          np.asarray(aj.edge_index), err_msg=str(et))
            assert (at.e_id is None) == (aj.e_id is None)
            if at.e_id is not None:
                np.testing.assert_array_equal(at.e_id.numpy(), np.asarray(aj.e_id))


def test_topology_arrays_match_jax():
    tj, tt, edges = both_topos(seed=3, weights=True)
    assert tt.node_types == tj.node_types and tt.edge_types == tj.edge_types
    assert tt.num_nodes == tj.num_nodes
    assert tt.weighted_edge_types == tj.weighted_edge_types
    for t in ("paper", "author", "inst"):
        assert tt.rels_into(t) == tj.rels_into(t)
    for et in edges:
        rj, rt = tj.relations[et], tt.relations[et]
        assert (rt.node_count, rt.edge_count, rt.max_degree, rt.src_node_count) == (
            rj.node_count, rj.edge_count, rj.max_degree, rj.src_node_count)
        for name in ("indptr", "indices", "eid", "degree", "edge_weight", "cum_weights"):
            np.testing.assert_array_equal(getattr(rt, name), np.asarray(getattr(rj, name)),
                                          err_msg=f"{et} {name}")
    assert repr(tt) == repr(tj)
    # type names are normalised to strings; CSR-order weights skip eid
    num_nodes, edges = toy_schema(1)
    w = np.random.default_rng(2).random(400).astype(np.float32)
    tj2 = qj.HeteroCSRTopo(num_nodes, edges).set_edge_weight(CITES, w, coo_order=False)
    tt2 = qt.HeteroCSRTopo(num_nodes, edges).set_edge_weight(CITES, w, coo_order=False)
    np.testing.assert_array_equal(tt2.relations[CITES].cum_weights,
                                  tj2.relations[CITES].cum_weights)


@pytest.mark.parametrize("case", [
    "src_range", "dst_range", "unknown_type", "arity", "negative", "shape",
    "weight_relation", "weight_count", "weight_negative", "weighted_rels"])
def test_topology_errors_match_jax(case):
    num_nodes, edges = toy_schema()

    def build(pkg):
        if case == "src_range":
            return pkg.HeteroCSRTopo({"a": 5, "b": 5}, {("a", "r", "b"): np.array([[7], [0]])})
        if case == "dst_range":
            return pkg.HeteroCSRTopo({"a": 5, "b": 5}, {("a", "r", "b"): np.array([[0], [9]])})
        if case == "unknown_type":
            return pkg.HeteroCSRTopo({"a": 5}, {("a", "r", "zzz"): np.zeros((2, 0), np.int64)})
        if case == "arity":
            return pkg.HeteroCSRTopo({"a": 5}, {("a", "a"): np.zeros((2, 0), np.int64)})
        if case == "negative":
            return pkg.HeteroCSRTopo({"a": 5}, {("a", "r", "a"): np.array([[-1], [0]])})
        if case == "shape":
            return pkg.HeteroCSRTopo({"a": 5}, {("a", "r", "a"): np.zeros((3, 2), np.int64)})
        topo = pkg.HeteroCSRTopo(num_nodes, edges)
        if case == "weight_relation":
            return topo.set_edge_weight(("x", "y", "z"), np.ones(3))
        if case == "weight_count":
            return topo.set_edge_weight(CITES, np.ones(3))
        if case == "weight_negative":
            return topo.set_edge_weight(CITES, -np.ones(400))
        return topo.to_device(weighted_rels=[("x", "y", "z")],
                              **({} if pkg is qj else {"device": "cpu"}))

    with pytest.raises(ValueError) as ej:
        build(qj)
    with pytest.raises(ValueError) as et:
        build(qt)
    assert str(et.value) == str(ej.value)


def test_relation_placement_shares_csr_placement():
    _, tt, _ = both_topos(seed=2, weights=True)
    rel = tt.relations[WRITES]
    for mode in ("HBM", "HOST"):
        d = rel.to_device(mode, with_eid=True, with_weights=True, device="cpu")
        want = qt.core.topology.place_csr_arrays(
            rel.indptr, rel.indices, rel.eid, rel.cum_weights, rel.max_degree, mode, "cpu")
        for name in ("indptr", "indices", "eid", "cum_weights"):
            assert torch.equal(getattr(d, name), getattr(want, name))
        assert d.search_iters == want.search_iters > 0 and not d.host_indices
    with pytest.raises(ValueError, match="edge weights"):
        tt.relations[CITES].__class__.from_edge_index(
            np.array([[0], [0]]), 2, 2).to_device(with_weights=True, device="cpu")


def test_csr_to_device_unchanged_by_shared_placement():
    """CSRTopo.to_device goes through place_csr_arrays; its output is the
    direct placement's, array for array."""
    rng = np.random.default_rng(0)
    topo = qt.CSRTopo(edge_index=rng.integers(0, 50, (2, 300)),
                      edge_weight=rng.random(300), edge_time=rng.random(300))
    d = topo.to_device("HBM", "cpu", with_eid=True, with_weights=True, with_times=True)
    assert torch.equal(d.indptr, torch.from_numpy(topo.indptr))
    assert torch.equal(d.indices, torch.from_numpy(topo.indices))
    assert torch.equal(d.eid, torch.from_numpy(topo.eid))
    assert torch.equal(d.cum_weights, torch.from_numpy(topo.cum_weights))
    assert torch.equal(d.edge_time, torch.from_numpy(topo.edge_time))
    assert d.search_iters == max(int(np.ceil(np.log2(topo.max_degree + 1))), 1)
    assert d.max_degree == topo.max_degree
    assert topo.to_device("UVA", "cpu").search_iters == 0


def powerlaw_topos(weights=False, n_paper=3000, n_author=1200):
    """``tests/test_hetero.py``'s power-law schema (paper-cites-paper from
    ``generate_pareto_graph``, 4 writes per paper), where planned caps
    are tighter than the worst case and a diverse batch overflows a plan
    made on duplicate seeds."""
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(0)
    edges = {CITES: generate_pareto_graph(n_paper, 8.0, seed=0),
             WRITES: np.stack([rng.integers(0, n_author, 4 * n_paper),
                               rng.integers(0, n_paper, 4 * n_paper)])}
    num_nodes = {"paper": n_paper, "author": n_author}
    tj, tt = qj.HeteroCSRTopo(num_nodes, edges), qt.HeteroCSRTopo(num_nodes, edges)
    if weights:
        w = np.exp(rng.normal(size=edges[CITES].shape[1])).astype(np.float32)
        tj.set_edge_weight(CITES, w)
        tt.set_edge_weight(CITES, w)
    return tj, tt


SAMPLER_CASES = {
    # name: (topologies, sizes, sampler kwargs, seed batches)
    "uniform_with_eid": (lambda: both_topos(0)[:2], [3, 2], {"with_eid": True},
                         [np.arange(32)]),
    "weighted_dict_fanout": (lambda: both_topos(1, weights=True)[:2],
                             [{CITES: 3, WRITES: 0}, {CITES: 2, WRITES: 3}],
                             {"weighted": True}, [np.arange(24)]),
    "full_fanout_duplicate_seeds": (lambda: both_topos(4)[:2], [-1],
                                    {"seed_capacity": 64},
                                    [np.r_[np.zeros(30, int), np.arange(20)]]),
    # cites weighted, writes uniform; planned on duplicates, then regrown
    "auto_caps_regrowth": (lambda: powerlaw_topos(weights=True), [4, 3],
                           {"frontier_caps": "auto", "auto_margin": 1.0,
                            "seed_capacity": 32, "weighted": [CITES]},
                           [np.full(32, 7), np.random.default_rng(0).integers(0, 3000, 32),
                            np.random.default_rng(1).integers(0, 3000, 32)]),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_bitwise_under_jax_draws(case):
    topos, sizes, kw, batches = SAMPLER_CASES[case]
    tj, tt = topos()
    sj = qj.HeteroGraphSampler(tj, sizes, "paper", seed=9, dedup="sort", **kw)
    st = qt.HeteroGraphSampler(tt, sizes, "paper", seed=9, device="cpu", **kw)
    assert st.sizes == sj.sizes and st.weighted_rels == sj.weighted_rels
    for call, seeds in enumerate(batches, start=1):
        oj = sj.sample(seeds)
        ot = st.sample(seeds, draw_fn=jax_draw_fn(st, 9, call))
        assert st._cap_overrides == sj._cap_overrides
        assert_same_output(ot, oj)
        np.testing.assert_array_equal(ot.n_id["paper"][:len(seeds)].numpy(), seeds)
    if case == "auto_caps_regrowth":
        assert st.reruns >= 1  # the diverse batch regrew the duplicates' plan
        assert ot.n_id["paper"].shape[0] < st._plan(32)[-1][2]["paper"]


def test_plans_match_jax():
    tj, tt, _ = both_topos()
    for sizes in ([3, 2], [{CITES: 4}, 2], [-1, 5]):
        sj = qj.HeteroGraphSampler(tj, sizes, "paper")
        st = qt.HeteroGraphSampler(tt, sizes, "paper", device="cpu")
        for cap in (16, 128):
            assert st._plan(cap) == sj._plan(cap)
            ov = tuple({t: 50 + 37 * i for t in ("paper", "author", "inst")}
                       for i in range(len(sizes)))
            assert st._plan(cap, ov) == sj._plan(cap, ov)


def _real_edges(topo, out):
    """Every valid lane joins a real edge of its relation; returns the
    number of lanes checked."""
    n_id = {t: v.numpy() for t, v in out.n_id.items()}
    checked = 0
    for layer in out.adjs:
        for et, adj in layer.adjs.items():
            rel = topo.relations[et]
            col, row = adj.edge_index.numpy()
            valid = col >= 0
            for s, d in zip(n_id[et[0]][col[valid]], n_id[et[2]][row[valid]]):
                assert s in rel.indices[rel.indptr[d]:rel.indptr[d + 1]], et
                checked += 1
    return checked


@pytest.mark.parametrize("weighted", [False, True])
def test_own_draws_sample_real_edges(weighted):
    _, tt, _ = both_topos(seed=7, weights=weighted)
    s = qt.HeteroGraphSampler(tt, [4, 3], "paper", seed=1, weighted=weighted,
                              device="cpu")
    seeds = np.arange(24)
    out = s.sample(seeds)
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.n_id["paper"][:24].numpy(), seeds)
    assert _real_edges(tt, out) > 50
    # exact counts on the seed hop: min(deg, k) sampled lanes per seed
    adj = out.adjs[-1].adjs[CITES]
    col, row = adj.edge_index.numpy()
    deg = np.diff(tt.relations[CITES].indptr)[seeds]
    got = np.bincount(row[col >= 0], minlength=128)[:24]
    np.testing.assert_array_equal(got, np.minimum(deg, 4))
    # a new call draws anew
    assert not all(torch.equal(a.edge_index, b.edge_index)
                   for a, b in zip(s.sample(seeds).adjs[0].adjs.values(),
                                   out.adjs[0].adjs.values()))


def test_own_draws_auto_equals_worst_case():
    """An auto sampler's hops draw over the worst-case rows, so its samples
    equal a worst-case sampler's, call by call, regrowth included."""
    _, tt = powerlaw_topos(weights=True)
    kw = {"seed": 3, "seed_capacity": 32, "weighted": [CITES], "device": "cpu"}
    a = qt.HeteroGraphSampler(tt, [4, 3], "paper", **kw)
    b = qt.HeteroGraphSampler(tt, [4, 3], "paper", frontier_caps="auto",
                              auto_margin=1.0, **kw)
    for seeds in (np.full(32, 5), np.random.default_rng(2).integers(0, 3000, 32)):
        oa, ob = a.sample(seeds), b.sample(seeds)
        for t in oa.n_id:
            n = int(oa.n_count[t])
            assert int(ob.n_count[t]) == n
            np.testing.assert_array_equal(ob.n_id[t][:n].numpy(), oa.n_id[t][:n].numpy())
        for la, lb in zip(oa.adjs, ob.adjs):
            for et in la.adjs:
                # the same lanes for the rows both hold; the worst case's
                # extra rows are padding
                ea, eb = la.adjs[et].edge_index.numpy(), lb.adjs[et].edge_index.numpy()
                np.testing.assert_array_equal(ea[:, :eb.shape[1]], eb)
                assert (ea[:, eb.shape[1]:] == -1).all()
    assert b.reruns >= 1


def test_sampler_validation_matches_jax():
    tj, tt, _ = both_topos()
    for args, kw in [(([-3],), {}), (([2],), {"weighted": True}),
                     (([2],), {"weighted": [CITES]}),
                     (([{("x", "y", "z"): 2}],), {}),
                     (([2],), {"frontier_caps": "worst"}),
                     (([2],), {"auto_margin": 0.5})]:
        with pytest.raises(ValueError) as ej:
            qj.HeteroGraphSampler(tj, *args, input_type="paper", **kw)
        with pytest.raises(ValueError) as et:
            qt.HeteroGraphSampler(tt, *args, input_type="paper", device="cpu", **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="unknown input_type"):
        qt.HeteroGraphSampler(tt, [2], "venue", device="cpu")
    for dedup in ("auto", "sort", "map", "scan"):
        assert qt.HeteroGraphSampler(tt, [2], "paper", dedup=dedup,
                                     device="cpu").dedup == dedup
    with pytest.raises(ValueError, match="dedup"):
        qt.HeteroGraphSampler(tt, [2], "paper", dedup="hash", device="cpu")
    s = qt.HeteroGraphSampler(tt, [2], "paper", seed_capacity=16, device="cpu")
    with pytest.raises(ValueError, match="seed_capacity"):
        s.sample(np.arange(17))
    with pytest.raises(ValueError, match="seed ids"):
        s.sample(np.array([120]))


def test_layer_to_device_and_dedup_loop_seam():
    _, tt, _ = both_topos()
    out = qt.HeteroGraphSampler(tt, [3, 2], "paper", device="cpu").sample(np.arange(8))
    layer = out.adjs[0].to("cpu")
    assert layer.src_caps == out.adjs[0].src_caps and "cites" in repr(layer)
    with pytest.raises(ValueError, match="one of draw and bits"):
        hetero_t.hetero_multilayer_sample({}, torch.zeros(8, dtype=torch.int32), 8,
                                          "paper", ())


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    _, tt, _ = both_topos()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.HeteroGraphSampler(tt, [2], "paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.to_device()
