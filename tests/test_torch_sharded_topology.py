"""``ShardedTopology`` and ``routed_sample_cap`` of quiver_tpu_torch against
quiver_tpu's, on the CPU: the partition contracts of
``tests/test_sharded_topology.py``.

JAX places each array over its forced host devices; the port keeps one
tensor per shard, on a mesh whose device repeats (``["cpu"] * F``). Both
partition the same ``CSRTopo`` (the two builds are bitwise,
``tests/test_torch_topology.py``).

Tolerance: everything here is an integer, a byte count or a bitwise copy
of a float32 array, so every comparison is exact (dtypes included).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.core.sharded_topology import ShardedTopology as ShardedTopologyJ  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.sampling.dist import routed_sample_cap as routed_sample_cap_j  # noqa: E402
from quiver_tpu.utils.graphgen import generate_pareto_graph  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.sampling.dist import routed_sample_cap  # noqa: E402


def _edges(kind: str, n: int = 501):
    """A Pareto graph, or one whose edges crowd the first eighth of the
    rows (a skewed partition: shard 0 is the widest)."""
    if kind == "pareto":
        return generate_pareto_graph(n, 6.0, seed=0)
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.integers(0, n // 8, 2400), rng.integers(0, n, 300)])
    ei = np.stack([rows, rng.integers(0, n, rows.shape[0])])
    ei[:, -1] = n - 1  # the last node exists
    return ei


def _topos(kind: str):
    """The same graph in both packages, with weights and timestamps."""
    ei = _edges(kind)
    rng = np.random.default_rng(5)
    w = rng.random(ei.shape[1]).astype(np.float32) + 0.1
    t = rng.random(ei.shape[1]).astype(np.float32)
    out = []
    for mod in (qt, qj):
        topo = mod.CSRTopo(edge_index=ei)
        topo.set_edge_weight(w)
        topo.set_edge_time(t)
        out.append(topo)
    return out


def _meshes(F: int):
    return (qt.make_mesh(data=1, feature=F, devices=["cpu"] * F),
            make_mesh_j(data=1, feature=F, devices=jax.devices()[:F]))


def _assert_same_partition(st, sj):
    assert st.plan == sj.plan
    assert (st.rows_per_shard, st.num_shards, st.search_iters, st.node_count,
            st.edge_count, st.max_degree, st.version) == (
        sj.rows_per_shard, sj.num_shards, sj.search_iters, sj.node_count,
        sj.edge_count, sj.max_degree, sj.version)
    for name in ("indptr", "indices", "cum_weights", "edge_time"):
        want = getattr(sj, name)
        got = getattr(st, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        assert len(got) == want.shape[0], name
        for d, shard in enumerate(got):
            a = shard.numpy()
            assert a.dtype == want.dtype and np.array_equal(a, want[d]), (name, d)


@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["pareto", "skewed"])
def test_partition_bitwise_jax(kind, F):
    """Every shard's rebased ``indptr``, ``indices``, prefix weights and
    timestamps, the ``plan`` dict and the geometry, bitwise JAX's, on a
    graph whose 501 rows leave padding rows in the last shard."""
    tt, tj = _topos(kind)
    mt, mj = _meshes(F)
    st = qt.ShardedTopology(mt, tt, with_weights=True, with_times=True)
    sj = ShardedTopologyJ(mj, tj, with_weights=True, with_times=True)
    _assert_same_partition(st, sj)
    plain = qt.ShardedTopology(mt, tt)
    assert plain.cum_weights is None and plain.edge_time is None
    assert plain.plan == ShardedTopologyJ(mj, tj).plan
    # the partition covers the CSR: each shard reconstructs its row range
    rps, n = st.rows_per_shard, tt.node_count
    assert sum(st.plan["shard_edges"]) == tt.edge_count
    for d in range(F):
        lo, hi = min(d * rps, n), min((d + 1) * rps, n)
        ip = st.indptr[d].numpy().astype(np.int64)
        assert np.array_equal(ip[: hi - lo + 1] + tt.indptr[lo], tt.indptr[lo: hi + 1])
        assert np.all(ip[hi - lo:] == ip[hi - lo])  # padding rows: degree 0
    if kind == "skewed" and F > 1:
        assert st.plan["shrink_factor"] < F  # the widest shard sets the width


def test_routed_sample_cap_grid():
    """The bucket capacity equals JAX's over a grid of widths, mesh sizes
    and budgets (``None`` = uncapped), and both refuse alpha <= 0."""
    for L in (1, 7, 32, 128, 1000):
        for F in (1, 2, 4, 8):
            for alpha in (None, 0.01, 0.25, 1.0, 2.0, 3.5, 100.0):
                assert routed_sample_cap(L, F, alpha) == routed_sample_cap_j(L, F, alpha), \
                    (L, F, alpha)
    assert routed_sample_cap(128, 8, 2.0) == 32 and routed_sample_cap(8, 8, 0.01) == 1
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="alpha must be > 0"):
            routed_sample_cap(128, 8, bad)
        with pytest.raises(ValueError, match="alpha must be > 0"):
            routed_sample_cap_j(128, 8, bad)


def test_owner_of_and_replan():
    """``owner_of`` is JAX's; ``replan`` onto another width is a fresh
    partition of the same host CSR, equal to JAX's ``replan``."""
    tt, tj = _topos("pareto")
    mt, mj = _meshes(2)
    st = qt.ShardedTopology(mt, tt, with_weights=True)
    sj = ShardedTopologyJ(mj, tj, with_weights=True)
    ids = np.arange(tt.node_count, dtype=np.int32)
    assert np.array_equal(st.owner_of(torch.from_numpy(ids)).numpy(),
                          np.asarray(sj.owner_of(ids)))
    assert np.array_equal(st.owner_of(ids).numpy(), np.asarray(sj.owner_of(ids)))
    mt4, mj4 = _meshes(4)
    rt, rj = st.replan(mt4), sj.replan(mj4)
    assert rt is not st and rt.csr_topo is tt and rt.num_shards == 4
    _assert_same_partition(rt, rj)
    _assert_same_partition(rt, qt.ShardedTopology(mt4, tt, with_weights=True))
    assert st.num_shards == 2  # the old partition is untouched


def test_attribute_guards():
    topo = qt.CSRTopo(edge_index=_edges("pareto"))
    mesh = _meshes(2)[0]
    with pytest.raises(ValueError, match="requires edge weights"):
        qt.ShardedTopology(mesh, topo, with_weights=True)
    with pytest.raises(ValueError, match="requires edge timestamps"):
        qt.ShardedTopology(mesh, topo, with_times=True)
