"""The reindex's dedup strategies in quiver_tpu_torch (``"sort"``,
``"map"``, and ``"scan"``, which runs the sort) against quiver_tpu's same
strategy, on the CPU:
the reindex itself and the replicated sampler and server
(``tests/test_torch_dedup_paths.py`` holds the typed and distributed
samplers, the trainer and a world of processes).

- ``masked_unique`` and ``reindex_layer`` with ``node_bound=`` (map) and
  ``scatter_free=True`` (scan), rows of JAX's 1-D calls against the port's
  leading dimensions ``R = 1`` and ``3``: forced duplicate seeds, every
  lane invalid, a capacity past ``T``, overflow past it, ids at
  ``node_bound - 1`` and one valid id past ``node_bound`` (the same wrong
  answer in both packages);
- the work each strategy runs, recorded by a ``TorchDispatchMode``: map
  runs no ``aten.sort``, scan the sort's ops; ``dedup_bound``;
- per strategy, on JAX's draws: ``GraphSageSampler`` (uniform with auto
  caps, weighted and temporal with ``with_eid``) and a small
  ``InferenceServer``, each against JAX's with the same strategy; two
  servers of different strategies over one placement and one program
  cache each capture their own sample programs.

Tolerance: bitwise throughout, dtypes included (ids, counts, edge lists
and local ids are integers), except the served log-probs against JAX's:
atol = rtol = 1e-5, as ``tests/test_torch_serve.py`` (float32, different
summation orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.ops import reindex as rj  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.ops import reindex as rt  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

from test_torch_auto_caps import _jax_draws  # noqa: E402
from test_torch_serve import jax_draw_fn as serve_draw_fn  # noqa: E402
from test_torch_temporal import _jax_offsets  # noqa: E402

STRATEGIES = ("sort", "map", "scan")
BOUND = 40  # the id bound of the reindex cases


def _jax_kw(dedup, bound):
    """JAX's arguments for a strategy (the port takes the same)."""
    return {"map": {"node_bound": bound}, "scan": {"scatter_free": True}}.get(dedup, {})


def _same(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# -- masked_unique and reindex_layer -------------------------------------------------

UNIQUE_CASES = ("duplicate_forced", "all_invalid", "size_past_T", "overflow",
                "bound_edge", "past_bound")


def _unique_row(case, seed, T=48):
    """One row's ``(ids, valid, size, num_forced)``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BOUND, T).astype(np.int32)
    valid = rng.random(T) < 0.8
    size, forced = 30, 4
    if case == "duplicate_forced":
        ids[1] = ids[0]
        ids[3] = ids[0]
        valid[:4] = True
    elif case == "all_invalid":
        valid[:] = False
    elif case == "size_past_T":
        size = T + 9
    elif case == "overflow":
        size, forced = 6, 2
    elif case == "bound_edge":
        ids[[2, 9, 30]] = BOUND - 1
        valid[[2, 9, 30]] = True
    elif case == "past_bound":
        ids[7] = BOUND + 3
        valid[7] = True
    return ids, valid, size, forced


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("case", UNIQUE_CASES)
@pytest.mark.parametrize("R", [1, 3])
def test_masked_unique_bitwise_jax(dedup, case, R):
    rows = [_unique_row(case, 10 * R + r) for r in range(R)]
    size, forced = rows[0][2], rows[0][3]
    ids = torch.from_numpy(np.stack([r[0] for r in rows]))
    valid = torch.from_numpy(np.stack([r[1] for r in rows]))
    if R == 1:
        ids, valid = ids[0], valid[0]
    got = rt.masked_unique(ids, valid, size, forced, **_jax_kw(dedup, BOUND))
    for r, (ids_r, valid_r, _, _) in enumerate(rows):
        want = rj.masked_unique(jnp.asarray(ids_r), jnp.asarray(valid_r), size, forced,
                                **_jax_kw(dedup, BOUND))
        for g, w in zip(got, want):
            _same(g if R == 1 else g[r], w, f"{case} row {r}")
    if case == "all_invalid":
        assert not got[1].any() and (got[0] == -1).all() and (got[2] == -1).all()


def _layer_row(case, seed, S=8, K=5):
    """One row's ``(seeds, num, neighbours, cap)``."""
    rng = np.random.default_rng(seed)
    seeds = np.full(S, -1, np.int32)
    num = 6
    seeds[:num] = rng.integers(0, BOUND, num)
    nbr = rng.integers(0, BOUND, (S, K)).astype(np.int32)
    nbr[rng.random((S, K)) < 0.25] = -1
    cap = 36
    if case == "duplicate_forced":
        seeds[1] = seeds[3] = seeds[0]
        nbr[2, 1] = seeds[0]
    elif case == "all_invalid":
        num = 0
        seeds[:] = -1
        nbr[:] = -1
    elif case == "size_past_T":
        cap = S + S * K + 7
    elif case == "overflow":
        cap = 9
    elif case == "bound_edge":
        seeds[4] = BOUND - 1
        nbr[0, :3] = BOUND - 1
    elif case == "past_bound":
        nbr[3, 2] = BOUND
    return seeds, num, nbr, cap


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("case", UNIQUE_CASES)
@pytest.mark.parametrize("R", [1, 3])
def test_reindex_layer_bitwise_jax(dedup, case, R):
    rows = [_layer_row(case, 7 * R + r) for r in range(R)]
    cap = rows[0][3]
    seeds = torch.from_numpy(np.stack([r[0] for r in rows]))
    nbr = torch.from_numpy(np.stack([r[2] for r in rows]))
    num = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    if R == 1:
        seeds, nbr, num = seeds[0], nbr[0], int(num[0])
    got = rt.reindex_layer(seeds, num, nbr, cap, **_jax_kw(dedup, BOUND))
    for r, (s_r, n_r, nbr_r, _) in enumerate(rows):
        want = rj.reindex_layer(jnp.asarray(s_r), jnp.int32(n_r), jnp.asarray(nbr_r), cap,
                                **_jax_kw(dedup, BOUND))
        for g, w in zip(got, want):
            _same(g if R == 1 else g[r], w, f"{case} row {r}")


def test_strategies_bitwise_each_other_with_int64_ids():
    """The three strategies agree on int64 ids too (SAINT's and a user's),
    keeping the ids' dtype and int32 ``local``."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 500, (4, 300)))
    valid = torch.from_numpy(rng.random((4, 300)) < 0.9)
    outs = [rt.masked_unique(ids, valid, 200, 5, **_jax_kw(d, 500)) for d in STRATEGIES]
    assert outs[0][0].dtype == torch.int64 and outs[0][2].dtype == torch.int32
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)


class _Ops(TorchDispatchMode):
    """The ATen ops a call runs, by overload packet name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _recorded(dedup, call):
    rows = [_layer_row("duplicate_forced", r) for r in range(3)]
    seeds = torch.from_numpy(np.stack([r[0] for r in rows]))
    nbr = torch.from_numpy(np.stack([r[2] for r in rows]))
    with _Ops() as ops:
        if call == "reindex_layer":
            rt.reindex_layer(seeds, 6, nbr, 20, **_jax_kw(dedup, BOUND))
        else:
            ids = torch.cat([seeds, nbr.flatten(1)], 1)
            rt.masked_unique(ids, ids >= 0, 20, 8, **_jax_kw(dedup, BOUND))
    return ops.names


@pytest.mark.parametrize("call", ["reindex_layer", "masked_unique"])
def test_each_strategy_runs_its_own_work(call):
    """map: a scatter-min and no sort or scan; sort: a sort, the running
    max and scatters, no scatter-min; scan (JAX's scatter-free strategy)
    runs exactly the sort's ops."""
    got = {d: _recorded(d, call) for d in STRATEGIES}
    assert not {"sort", "cummax"} & got["map"] and "scatter_reduce_" in got["map"]
    assert {"sort", "cummax", "scatter_"} <= got["sort"]
    assert "scatter_reduce_" not in got["sort"]
    assert got["scan"] == got["sort"]


def test_dedup_bound():
    """A resolved name to the functions' ``node_bound``: the bound under
    map (an int or a per-type dict), None under sort and scan; an
    unresolved name, or the map with no bound, raises."""
    assert rt.dedup_bound("map", 7) == 7
    assert rt.dedup_bound("map", {"paper": 3}) == {"paper": 3}
    assert rt.dedup_bound("sort", 7) is None and rt.dedup_bound("scan", 7) is None
    with pytest.raises(ValueError, match="resolved"):
        rt.dedup_bound("auto", 7)
    with pytest.raises(ValueError, match="node bound"):
        rt.dedup_bound("map", None)


def test_map_scratch_is_one_int32_map_per_row():
    """The map's scratch: one ``(R, node_bound)`` int32 map (its fill and
    scatter), seen as the largest tensor the call makes."""
    seen = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                seen.append((out.numel() * out.element_size(), out.dtype, tuple(out.shape)))
            return out

    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 5000, (3, 64)).astype(np.int32))
    with Sizes():
        rt.masked_unique(ids, ids >= 0, 32, node_bound=5000)
    assert max(seen, key=lambda t: t[0]) == (3 * 5000 * 4, torch.int32, (3, 5000))


# -- the samplers, on JAX's draws ------------------------------------------------------


def _graph(kind):
    """A 3,000-node Pareto graph in both packages, with exp(N(0, 1))
    weights or U[0, 1) times."""
    ei = generate_pareto_graph(3000, 8.0, seed=2)
    out = []
    for mod in (qj, qt):
        topo = mod.CSRTopo(edge_index=ei)
        if kind == "weighted":
            topo.set_edge_weight(np.exp(np.random.default_rng(5).normal(
                size=topo.edge_count)).astype(np.float32))
        elif kind == "temporal":
            topo.set_edge_time(np.random.default_rng(6).random(topo.edge_count)
                               .astype(np.float32))
        out.append(topo)
    return out


def _sampler_draw(kind, seed, call, sizes):
    """``draw_fn(layer, deg)`` replaying JAX's sampler call ``call``."""
    if kind == "uniform":
        return _jax_draws(seed, call, sizes)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), call)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)
    if kind == "weighted":
        return lambda l, deg: np.array(jax.random.uniform(subs[l], (deg.shape[0], sizes[l]),
                                                          jnp.float32))
    return lambda l, deg: _jax_offsets(subs[l], sizes[l])(deg)


SAMPLER_KINDS = {
    # kind: (sampler kwargs, seed batches)
    "uniform": ({"frontier_caps": "auto", "auto_margin": 1.0, "seed_capacity": 32},
                [np.full(32, 11), np.random.default_rng(2).integers(0, 3000, 32),
                 np.random.default_rng(3).integers(0, 3000, 32)]),
    "weighted": ({"weighted": True, "with_eid": True},
                 [np.array([5, 7, 7, 300, 11, 21, 2999])]),
    "temporal": ({"time_window": (0.1, 0.7), "with_eid": True},
                 [np.array([5, 7, 7, 300, 11, 15])]),
}


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("kind", list(SAMPLER_KINDS))
def test_sampler_bitwise_jax_same_strategy(kind, dedup):
    """``GraphSageSampler.sample`` under JAX's draws, call by call, against
    JAX's sampler with the same strategy: ids, edge lists, edge ids,
    counts, caps (the uniform case plans, regrows and reruns)."""
    kw, batches = SAMPLER_KINDS[kind]
    sizes = [4, 3]
    tj, tt = _graph(kind)
    sj = qj.GraphSageSampler(tj, sizes, seed=6, kernel="xla", dedup=dedup, **kw)
    st = qt.GraphSageSampler(tt, sizes, device="cpu", seed=6, dedup=dedup, **kw)
    assert st.dedup == sj.dedup == dedup
    for call, seeds in enumerate(batches, start=1):
        oj = sj.sample(seeds)
        ot = st.sample(seeds, draw_fn=_sampler_draw(kind, 6, call, sizes))
        assert st._frontier_caps == sj._frontier_caps
        _same(ot.n_id, oj.n_id, "n_id")
        assert int(ot.n_count) == int(oj.n_count)
        assert int(ot.overflow) == int(oj.overflow)
        for at, aj in zip(ot.adjs, oj.adjs):
            assert at.size == tuple(aj.size)
            _same(at.edge_index, aj.edge_index, "edge_index")
            assert (at.e_id is None) == (aj.e_id is None)
            if at.e_id is not None:
                _same(at.e_id, aj.e_id, "e_id")
        for a, b in zip(ot.edge_counts + ot.frontier_counts,
                        oj.edge_counts + oj.frontier_counts):
            assert int(a) == int(b)
    if kind == "uniform":
        assert st.reruns >= 1


@pytest.mark.parametrize("dedup", ["map", "scan"])
def test_sampler_own_draws_bitwise_sort(dedup):
    """The port's own draws: ``sample`` and ``sample_padded`` under map or
    scan are bitwise the sort's."""
    _, tt = _graph("uniform")
    seeds = np.random.default_rng(1).integers(0, 3000, 100)
    a, b = (qt.GraphSageSampler(tt, [5, 4, 3], device="cpu", seed=4, dedup=d)
            for d in ("sort", dedup))
    oa, ob = a.sample(seeds), b.sample(seeds)
    assert torch.equal(oa.n_id, ob.n_id)
    for x, y in zip(oa.adjs, ob.adjs):
        assert torch.equal(x.edge_index, y.edge_index)
    padded = torch.full((128,), -1, dtype=torch.int32)
    padded[:100] = torch.from_numpy(seeds)
    pa, pb = (s.sample_padded(padded, 100, generator=torch.Generator().manual_seed(9))
              for s in (a, b))
    assert torch.equal(pa[0], pb[0]) and torch.equal(pa[3], pb[3])
    for x, y in zip(pa[2], pb[2]):
        assert torch.equal(x.edge_index, y.edge_index)


F, HID, CLS = 12, 16, 5


@pytest.mark.parametrize("dedup", STRATEGIES)
def test_server_bitwise_jax_same_strategy(dedup):
    """A small ``InferenceServer`` per strategy against JAX's server with
    the same strategy: the oracle's samples bitwise, the ladder's lanes
    bitwise the port's oracle at every bucket, the served log-probs
    within 1e-5."""
    sizes = (4, 3)
    coo = generate_pareto_graph(400, 6.0, seed=5)
    x = np.random.default_rng(5).normal(size=(400, F)).astype(np.float32)
    mj = SageJ(hidden=HID, num_classes=CLS, num_layers=2)
    adjs = empty_adjs(list(sizes), batch=2, node_count=400)
    params = init_model(mj, jax.random.PRNGKey(3),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, HID, CLS, num_layers=2)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    sj = qj.InferenceServer(
        qj.GraphSageSampler(qj.CSRTopo(edge_index=coo), list(sizes), seed=3, dedup=dedup),
        mj, params, qj.Feature(device_cache_size="1G").from_cpu_tensor(x),
        buckets=(1, 2), seed=3)
    st = qt.InferenceServer(
        qt.GraphSageSampler(qt.CSRTopo(edge_index=coo), list(sizes), device="cpu", seed=3,
                            dedup=dedup),
        mt, qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x),
        device="cpu", buckets=(1, 2), seed=3, draw_fn=serve_draw_fn(3, sizes))
    assert st.sampler.dedup == sj.sampler.dedup == dedup
    for node, seq in [(0, 0), (7, 1), (123, 2), (399, 17)]:
        nj, ej, oj = sj._ladder.oracle_sample(sj.sampler.topo, node, seq, sj._base_key)
        nt, et, ot = st.ladder.oracle_sample(node, seq)
        _same(nt, nj, "n_id")
        for a, b in zip(et, ej):
            _same(a, b, "edge_index")
        assert int(ot) == int(oj)
    lad = st.ladder
    picks = [(3, 100), (250, 101)]
    for bucket in (1, 2):
        seeds = torch.tensor([n for n, _ in picks[:bucket]], dtype=torch.int32)
        n_ids, eis, _ = lad.sample_exec(bucket)(seeds, [s for _, s in picks[:bucket]])
        for j, (node, seq) in enumerate(picks[:bucket]):
            o_nid, o_eis, _ = lad.oracle_sample(node, seq)
            assert torch.equal(n_ids[j], o_nid)
            for e, oe in zip(eis, o_eis):
                assert torch.equal(e[j], oe)
    nodes = np.random.default_rng(0).integers(0, 400, 5)
    for a, b in zip(st.serve(nodes), sj.serve(nodes)):
        np.testing.assert_allclose(a.result, b.result, atol=1e-5, rtol=1e-5)


def test_strategies_do_not_share_cached_sample_programs(tmp_path):
    """Servers of different strategies over one placement and one program
    cache: the strategy forks the sample program's fingerprint, so each
    captures its own (no cache hit) and serves its oracle; a second map
    server loads the first's programs."""
    coo = generate_pareto_graph(300, 6.0, seed=4)
    topo = qt.CSRTopo(edge_index=coo)
    feat = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(
        np.random.default_rng(4).normal(size=(300, F)).astype(np.float32))
    placed = qt.GraphSageSampler(topo, [3, 2], device="cpu").topo
    cache = qt.AOTExecutableCache(str(tmp_path))
    servers = {}
    for dedup in ("sort", "map"):
        smp = qt.GraphSageSampler(topo, [3, 2], device="cpu", seed=1, dedup=dedup,
                                  device_topo=placed)
        servers[dedup] = qt.InferenceServer(smp, qt.GraphSAGE(F, HID, CLS), feat, device="cpu",
                                            max_batch=2, seed=1, aot_cache=cache)
        assert servers[dedup].warm_from_cache() == {"loaded": 0, "compiled": 4}
    assert cache.hits == 0 and cache.stores == 8
    fp = {d: s.ladder.fingerprint("sample", 2) for d, s in servers.items()}
    assert fp["sort"] != fp["map"]
    for dedup, server in servers.items():
        for r in server.serve([3, 4, 250]):
            np.testing.assert_array_equal(r.result, server.oracle(r.node, r.seq))
    again = qt.InferenceServer(servers["map"].sampler, servers["map"].model, feat,
                               device="cpu", max_batch=2, seed=1, aot_cache=cache)
    assert again.warm_from_cache() == {"loaded": 4, "compiled": 0}
