"""quiver_tpu_torch's neighbour select (K1's plain version) and uniform hop
against quiver_tpu.

* ``select_plain``/``fused_select_hop`` against the Pallas
  ``fused_select_hop`` (interpret mode on the CPU) on shared ``start``/
  ``offs``, with and without the eid lane, with ``S % 8 != 0``.
* ``sample_layer`` with injected offsets against JAX ``sample_layer``: the
  offsets are drawn by JAX's ``stratified_offsets``/``rotate_offsets``
  under the same key discipline (``kj, kr = split(key)``).
* The port's own torch draws against the exact ``k/deg`` marginals of
  ``ops/cpu_ref.sample_layer_ref``.

Tolerance: bitwise for neighbours, counts and eids. The marginal test
allows 6 standard errors of a binomial frequency.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402
from quiver_tpu.ops.cpu_ref import sample_layer_ref  # noqa: E402
from quiver_tpu.ops.pallas.fused import fused_select_hop as hop_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops import sample as sample_t  # noqa: E402
from quiver_tpu_torch.ops.kernels import fused as fused_t  # noqa: E402
from quiver_tpu_torch.ops.kernels.sample import sample_layer_windowed  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    coo = generate_pareto_graph(600, 9.0, seed=7)
    return coo, qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)


@pytest.mark.parametrize("S,with_eid", [(13, False), (13, True), (16, True), (5, False)])
def test_select_plain_matches_pallas_hop(graph, S, with_eid):
    _coo, tj, _tt = graph
    window, k = 64, 4
    rng = np.random.default_rng(S)
    E = tj.edge_count
    start = rng.integers(0, E - window, S).astype(np.int32)
    offs = rng.integers(0, window, (S, k)).astype(np.int32)
    eid = tj.eid.astype(np.int32) if with_eid else None
    want = hop_j(jnp.asarray(tj.indices), jnp.asarray(start), jnp.asarray(offs),
                 eid=None if eid is None else jnp.asarray(eid), window=window)
    tabs = (torch.from_numpy(tj.indices),) + (
        (torch.from_numpy(eid),) if with_eid else ())
    got = fused_t.select_plain(tabs, torch.from_numpy(start).long(),
                               torch.from_numpy(offs))
    got_hop = fused_t.fused_select_hop(
        tabs[0], torch.from_numpy(start), torch.from_numpy(offs),
        eid=tabs[1] if with_eid else None)
    assert len(got) == len(want) == len(got_hop)
    for g, h, w in zip(got, got_hop, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(h.numpy(), np.asarray(w))


def test_select_count_masks_lanes():
    tab = torch.arange(100, dtype=torch.int32)
    start = torch.tensor([0, 10, 95], dtype=torch.int64)
    offs = torch.tensor([[0, 1, 2], [3, 4, 5], [0, 1, 2]], dtype=torch.int32)
    count = torch.tensor([3, 1, 0], dtype=torch.int32)
    (out,) = fused_t.select((tab,), start, offs, count)
    np.testing.assert_array_equal(
        out.numpy(), [[0, 1, 2], [13, -1, -1], [-1, -1, -1]])
    assert fused_t.select.launches == 0  # CPU tensors never launch K1


def _jax_offsets(key, k):
    """The JAX uniform draw, as a port ``offs`` callable of the degrees."""
    kj, kr = jax.random.split(key)

    def draw(deg):
        d = jnp.asarray(deg.numpy())
        off, _ = sample_j.stratified_offsets(kj, d, k)
        return torch.from_numpy(np.array(sample_j.rotate_offsets(kr, off, d, k)))
    return draw


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("with_eid,topo_eid", [(False, False), (True, True), (True, False)])
def test_sample_layer_injected_offsets_bitwise(graph, k, with_eid, topo_eid):
    _coo, tj, tt = graph
    dj = tj.to_device(with_eid=topo_eid)
    dt = tt.to_device(device="cpu", with_eid=topo_eid)
    rng = np.random.default_rng(k)
    seeds = rng.integers(0, tj.node_count, 40).astype(np.int32)
    seeds[[3, 17]] = seeds[5]  # duplicates
    seeds[35:] = -1  # padding
    num = 33  # lanes 33.. are invalid although 33, 34 hold ids
    key = jax.random.PRNGKey(11 + k)
    want = sample_j.sample_layer(dj, jnp.asarray(seeds), jnp.int32(num), k, key,
                                 with_eid=with_eid)
    got = sample_t.sample_layer(dt, torch.from_numpy(seeds), num, k,
                                with_eid=with_eid, offs=_jax_offsets(key, k))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def test_sample_layer_batched_equals_rows(graph):
    """Leading batch dims are independent rows (the serving ladder)."""
    _coo, _tj, tt = graph
    dt = tt.to_device(device="cpu")
    rng = np.random.default_rng(0)
    seeds = torch.from_numpy(rng.integers(0, tt.node_count, (3, 10)).astype(np.int32))
    num = torch.tensor([10, 4, 0], dtype=torch.int32)
    offs = torch.from_numpy(rng.integers(0, 1 << 20, (3, 10, 4)).astype(np.int32))

    def offs_fn(deg):  # any in-row offsets: reduce the raw draws per row
        return (offs.long() % deg.long().clamp(min=1)[..., None]).int()

    nbr, cnt = sample_t.sample_layer(dt, seeds, num, 4, offs=offs_fn)
    for b in range(3):
        nb, cb = sample_t.sample_layer(
            dt, seeds[b], int(num[b]), 4,
            offs=lambda d, b=b: (offs[b].long() % d.long().clamp(min=1)[:, None]).int())
        np.testing.assert_array_equal(nbr[b].numpy(), nb.numpy())
        np.testing.assert_array_equal(cnt[b].numpy(), cb.numpy())


def test_sample_layer_windowed_alias(graph):
    _coo, _tj, tt = graph
    dt = tt.to_device(device="cpu")
    seeds = torch.arange(20, dtype=torch.int32)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = sample_t.sample_layer(dt, seeds, 20, 5, g1)
    b = sample_layer_windowed(dt, seeds, 20, 5, g2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_uniform_draw_marginals_k_over_deg():
    """Every neighbour of a row is drawn with probability k/deg, the
    k picks are distinct, and rows with deg <= k take all in CSR order."""
    deg_hub, k, trials = 23, 5, 6000
    n = deg_hub + 3
    indptr = np.array([0, deg_hub] + [n] * (n - 1), dtype=np.int64)
    indices = np.arange(n, dtype=np.int32)  # row 0: 0..22, row 1: 23..25
    dt = qt.CSRTopo(indptr=indptr, indices=indices).to_device(device="cpu")
    seeds = torch.zeros(trials, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    nbr, cnt = sample_t.sample_layer(dt, seeds, trials, k, g)
    assert bool((cnt == k).all())
    picks = nbr.numpy()
    assert all(len(set(r)) == k for r in picks[:500])
    freq = np.bincount(picks.ravel(), minlength=deg_hub) / trials
    ref, _ = sample_layer_ref(indptr, indices, np.zeros(trials, np.int64), k,
                              rng=np.random.default_rng(0))
    freq_ref = np.bincount(ref.ravel(), minlength=deg_hub) / trials
    p = k / deg_hub
    se = np.sqrt(p * (1 - p) / trials)
    assert np.abs(freq - p).max() < 6 * se
    assert np.abs(freq_ref - p).max() < 6 * se
    # a take-all row keeps CSR order
    nbr1, cnt1 = sample_t.sample_layer(dt, torch.tensor([1], dtype=torch.int32), 1, k, g)
    np.testing.assert_array_equal(nbr1.numpy(), [[23, 24, 25, -1, -1]])
    assert cnt1.tolist() == [3]


def test_stratified_offsets_large_spans_stay_in_range():
    """Raw 62-bit draws reduced per stratum never reach the stratum end,
    even for degrees past 2^24 where a float draw could round up."""
    deg = torch.tensor([2**24 + 3, 2**30, 7, 0], dtype=torch.int32)
    g = torch.Generator().manual_seed(1)
    off = sample_t.uniform_offsets(deg, 6, g).long()
    for d, row in zip(deg.tolist(), off):
        hi = max(d, 1)
        assert bool(((row >= 0) & (row < hi)).all())
        if d > 6:
            assert len(set(row.tolist())) == 6


def test_sampler_matches_jax_sampler_under_jax_draws(graph):
    """GraphSageSampler.sample with draw_fn replaying the JAX sampler's
    key chain (fold_in(PRNGKey(seed), call), split per layer) gives the
    JAX SampleOutput bitwise: padded n_id, edges, eids and counts."""
    _coo, tj, tt = graph
    sizes = [4, 3]
    sj = qj.GraphSageSampler(tj, sizes, seed=9, kernel="xla", dedup="sort",
                             with_eid=True)
    st = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True)
    seeds = np.array([5, 7, 7, 300, 11], np.int64)
    out_j = sj.sample(seeds)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 1)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)
    out_t = st.sample(seeds, draw_fn=lambda l, deg: _jax_offsets(subs[l], sizes[l])(deg))
    np.testing.assert_array_equal(out_t.n_id.numpy(), np.asarray(out_j.n_id))
    assert int(out_t.n_count) == int(out_j.n_count)
    assert int(out_t.overflow) == int(out_j.overflow)
    for at, aj in zip(out_t.adjs, out_j.adjs):
        assert at.size == aj.size and at.fanout == aj.fanout
        np.testing.assert_array_equal(at.edge_index.numpy(), np.asarray(aj.edge_index))
        np.testing.assert_array_equal(at.e_id.numpy(), np.asarray(aj.e_id))
    for a, b in zip(out_t.edge_counts + out_t.frontier_counts,
                    out_j.edge_counts + out_j.frontier_counts):
        assert int(a) == int(b)
