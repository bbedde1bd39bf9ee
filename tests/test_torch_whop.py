"""K3's fused weighted hop (``weighted_hop``/``weighted_hop_plain``) against
quiver_tpu and against the port's composed path.

* ``weighted_hop_plain`` against the composed path (``seed_degrees``, then
  ``wselect_plain`` through ``sample_layer`` with a ``u`` callable of the
  degrees) on numpy-made ``u01``: rows with ``deg <= k``, empty and
  zero-total-weight rows, invalid and -1 seeds, leading lane dimensions
  with per-lane or scalar ``num_seeds``, int32 and int64 indptr, every eid
  lane form.
* ``weighted_hop_plain`` against JAX ``sample_layer(weighted=True)``, the
  Pallas ``fused_sample_layer`` and the Pallas ``fused_weighted_hop``
  (interpret mode on the CPU), all on JAX's own ``jax.random.uniform``
  draws; the tensor and ``bits=`` seams of ``sample_layer`` alike.
* The generator draws of ``sample_layer``, ``GraphSageSampler`` and the
  serving ladder (the fused hop) give bitwise what the composed path gives
  on the same generators; ladder == oracle at buckets 1-8, log-probs
  included.
* The draw seams exclude each other.

Tolerance: bitwise for neighbours, counts, eids and log-probs, dtypes
included.
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
from quiver_tpu_torch.ops.kernels.fused import (  # noqa: E402
    weighted_hop, weighted_hop_plain)
from quiver_tpu_torch.sampling.sampler import multilayer_sample  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

WINDOW = 2048  # the Pallas kernels' default row window
EIDS = [(False, False), (True, True), (True, False)]  # (with_eid, topo eid)


@pytest.fixture(scope="module")
def wgraph():
    """A pareto graph with rows 10..19 emptied and rows 20..29 carrying
    all-zero weights (the uniform-prefix rows), exp(N(0,1)) weights
    elsewhere."""
    coo = generate_pareto_graph(1000, 8.0, seed=11)
    coo = coo[:, (coo[0] < 10) | (coo[0] > 19)]
    w = np.exp(np.random.default_rng(12).normal(size=coo.shape[1])).astype(np.float32)
    w[(coo[0] >= 20) & (coo[0] < 30)] = 0.0
    tj = qj.CSRTopo(edge_index=coo, edge_weight=w)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=w)
    assert tj.edge_count >= WINDOW and tj.max_degree <= WINDOW
    assert (tj.degree[10:20] == 0).all()
    return tj, tt


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def _seeds(tt, lead, S, k, rng):
    """``lead + (S,)`` seeds holding, in every lane, an empty row, a
    zero-weight row, the max-degree row, a row of degree <= k, a -1 inside
    the valid prefix and -1 padding."""
    seeds = rng.integers(0, tt.node_count, lead + (S,)).astype(np.int32)
    seeds[..., 0] = 12
    seeds[..., 1] = 23
    seeds[..., 2] = int(np.argmax(tt.degree))
    seeds[..., 3] = int(np.flatnonzero((tt.degree > 0) & (tt.degree <= k))[0])
    seeds[..., 5] = -1
    seeds[..., S - 2:] = -1
    return torch.from_numpy(seeds)


@pytest.mark.parametrize("indptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("with_eid,topo_eid", EIDS)
@pytest.mark.parametrize("lanes", [None, "per-lane", "scalar"])
def test_weighted_hop_plain_equals_composed_path(wgraph, indptr_dtype, with_eid,
                                                 topo_eid, lanes):
    _tj, tt = wgraph
    placed = tt.to_device(device="cpu", with_eid=topo_eid, with_weights=True)
    dt = qt.DeviceTopology(placed.indptr.to(indptr_dtype), placed.indices, placed.eid,
                           cum_weights=placed.cum_weights,
                           search_iters=placed.search_iters)
    k, S = 6, 13
    rng = np.random.default_rng(3)
    lead = () if lanes is None else (3,)
    seeds = _seeds(tt, lead, S, k, rng)
    num = torch.tensor([11, 4, 0], dtype=torch.int32) if lanes == "per-lane" else 10
    u01 = torch.from_numpy(rng.random(lead + (S, k), dtype=np.float32))
    want = sample_t.sample_layer(dt, seeds, num, k, weighted=True, with_eid=with_eid,
                                 u=lambda deg: u01)
    got = weighted_hop_plain(dt.indptr, dt.indices, dt.cum_weights, seeds, num, u01,
                             dt.search_iters, eid=dt.eid, with_eid=with_eid)
    assert len(got) == (3 if with_eid else 2)
    _same(got, want)
    if with_eid and not topo_eid:
        assert got[2].dtype == indptr_dtype  # CSR slots in indptr's width
    # the fused route of sample_layer: the u tensor and the bits seam
    for seam in ({"u": u01}, {"bits": u01}, {"bits": lambda shape: u01}):
        _same(sample_t.sample_layer(dt, seeds, num, k, weighted=True,
                                    with_eid=with_eid, **seam), want)


def _pallas_hop(tj, seeds, num, u01, k, iters, eid):
    """JAX's Pallas ``fused_weighted_hop`` on the hop's own row starts and
    degrees, through the 2048-slot window the kernel reads."""
    S = seeds.shape[0]
    valid = (np.arange(S) < num) & (seeds >= 0)
    s = np.where(valid, seeds, 0)
    start = tj.indptr[s].astype(np.int64)
    deg = np.where(valid, tj.indptr[s + 1] - tj.indptr[s], 0).astype(np.int32)
    start_wide = np.clip(start, 0, tj.edge_count - WINDOW)
    out = whop_j(jnp.asarray(tj.indices.astype(np.int32)), jnp.asarray(tj.cum_weights),
                 jnp.asarray(start_wide.astype(np.int32)),
                 jnp.asarray((start - start_wide).astype(np.int32)), jnp.asarray(deg),
                 jnp.asarray(u01), iters, eid=None if eid is None else jnp.asarray(eid))
    mask = np.arange(k)[None, :] < np.minimum(deg, k)[:, None]
    return [np.where(mask, np.asarray(o), -1) for o in out]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("with_eid,topo_eid", EIDS)
def test_weighted_hop_plain_matches_jax(wgraph, k, with_eid, topo_eid):
    tj, tt = wgraph
    dj = tj.to_device(with_eid=topo_eid, with_weights=True)
    dt = tt.to_device(device="cpu", with_eid=topo_eid, with_weights=True)
    rng = np.random.default_rng(40 + k)
    seeds = rng.integers(0, tj.node_count, 40).astype(np.int32)
    seeds[:4] = [15, 22, int(np.argmax(tj.degree)), 3]  # empty, zero-weight, hub
    seeds[[5, 17]] = seeds[3]  # duplicates
    seeds[35:] = -1  # padding
    num = 33  # lanes 33.. are invalid although 33, 34 hold ids
    key = jax.random.PRNGKey(50 + k)
    args = (jnp.asarray(seeds), jnp.int32(num), k, key)
    want = sample_j.sample_layer(dj, *args, with_eid=with_eid, weighted=True)
    want_fused = fused_layer_j(dj, *args, weighted=True, with_eid=with_eid)
    u01 = torch.from_numpy(np.array(jax.random.uniform(key, (40, k), jnp.float32)))
    seeds_t = torch.from_numpy(seeds)
    got = weighted_hop_plain(dt.indptr, dt.indices, dt.cum_weights, seeds_t, num, u01,
                             dt.search_iters, eid=dt.eid, with_eid=with_eid)
    _same(got, want)
    _same(got, want_fused)
    before = weighted_hop.launches
    _same(weighted_hop(dt.indptr, dt.indices, dt.cum_weights, seeds_t, num, u01,
                       dt.search_iters, eid=dt.eid, with_eid=with_eid), want)
    assert weighted_hop.launches == before  # CPU tensors never launch K3
    # the Pallas hop itself, on the same rows: neighbours and eid lane
    pallas = _pallas_hop(
        tj, seeds, num, u01.numpy(), k, dj.search_iters,
        tj.eid.astype(np.int32) if with_eid and topo_eid else None)
    np.testing.assert_array_equal(got[0].numpy(), pallas[0])
    if with_eid and topo_eid:
        np.testing.assert_array_equal(got[2].numpy(), pallas[2])


def test_sample_layer_generator_draw_unchanged(wgraph):
    """With a generator the weighted hop is the fused one; it draws the
    same u01, in the same order, as the composed path did."""
    _tj, tt = wgraph
    dt = tt.to_device(device="cpu", with_eid=True, with_weights=True)
    seeds = _seeds(tt, (4,), 30, 5, np.random.default_rng(1))
    num = torch.tensor([30, 12, 1, 0])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = sample_t.sample_layer(dt, seeds, num, 5, g1, weighted=True, with_eid=True)
    u01 = sample_t.draw_u01(seeds.shape, 5, g2)
    want = sample_t.sample_layer(dt, seeds, num, 5, weighted=True, with_eid=True,
                                 u=lambda deg: u01)
    _same(got, want)


def test_sampler_own_draws_equal_composed_path(wgraph):
    """GraphSageSampler(weighted=True)'s generator draws (the fused hop)
    give bitwise the SampleOutput of the composed path on the same
    per-layer generators."""
    _tj, tt = wgraph
    sizes = [4, 3]
    seeds = np.array([5, 7, 7, 300, 11, 23, 999], np.int64)
    fused = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True,
                                weighted=True)
    composed = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True,
                                   weighted=True)
    out_f = fused.sample(seeds)
    out_c = composed.sample(seeds, draw_fn=lambda l, deg: sample_t.draw_u01(
        deg.shape, sizes[l], sample_t.seeded_generator("cpu", 9, 1, l)))
    assert torch.equal(out_f.n_id, out_c.n_id)
    assert int(out_f.n_count) == int(out_c.n_count)
    for a, b in zip(out_f.adjs, out_c.adjs):
        assert a.size == b.size
        assert torch.equal(a.edge_index, b.edge_index)
        assert torch.equal(a.e_id, b.e_id)
    for a, b in zip(out_f.edge_counts + out_f.frontier_counts,
                    out_c.edge_counts + out_c.frontier_counts):
        assert int(a) == int(b)


@pytest.fixture(scope="module")
def wserver():
    coo = generate_pareto_graph(500, 7.0, seed=4)
    w = np.exp(np.random.default_rng(8).normal(size=coo.shape[1])).astype(np.float32)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=w)
    x = np.random.default_rng(4).normal(size=(500, 6)).astype(np.float32)
    torch.manual_seed(0)
    st = qt.InferenceServer(
        qt.GraphSageSampler(tt, [5, 3], device="cpu", weighted=True),
        qt.GraphSAGE(6, 8, 3),
        qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(x),
        device="cpu", max_batch=8, seed=11)
    return tt, st


def test_ladder_draws_equal_composed_path(wserver):
    """The ladder's stacked per-lane u01 (padding lanes zero) through the
    fused hop give the composed path's hop on the same draws."""
    tt, st = wserver
    lad = st.ladder
    seqs = [3, None, 40, 41]
    seeds = torch.tensor([[int(np.argmax(tt.degree))], [-1], [2], [499]],
                         dtype=torch.int32)
    draws = lad._bits(seqs)(0, seeds.shape)
    assert draws.shape == (4, 1, 5) and draws.dtype == torch.float32
    assert not bool(draws[1].any())
    topo = st.sampler.topo
    got = sample_t.sample_layer(topo, seeds, 1, 5, weighted=True,
                                bits=lambda shape: lad._bits(seqs)(0, shape))
    want = sample_t.sample_layer(topo, seeds, 1, 5, weighted=True,
                                 u=lambda deg: draws)
    _same(got, want)


def test_ladder_equals_oracle_every_bucket(wserver):
    """The ladder samples all lanes in one fused weighted hop per layer;
    the oracle draws each lane's u01 from its degrees and runs the
    search-and-select entry. Ids, edges and log-probs agree bitwise at
    every bucket (1-8), full and padded."""
    tt, st = wserver
    lad = st.ladder
    assert tuple(st.batcher.buckets) == (1, 2, 4, 8)
    picks = [(int(np.argmax(tt.degree)), 3), (2, 40), (499, 41), (17, 7),
             (250, 8), (3, 9), (3, 10), (420, 11)]
    capL = lad.lane_caps[-1]
    for bucket in st.batcher.buckets:
        for group in (picks[:bucket], picks[1:bucket]):
            seeds = torch.full((bucket,), -1, dtype=torch.int32)
            seqs = [None] * bucket
            for j, (node, seq) in enumerate(group):
                seeds[j], seqs[j] = node, seq
            n_ids, eis, ovf = lad.sample_exec(bucket)(seeds, seqs)
            x = st.feature[n_ids.reshape(-1)].reshape(bucket, capL, lad.feature_dim)
            logp = lad.forward_exec(bucket)(x, eis).numpy()
            for j, (node, seq) in enumerate(group):
                o_nid, o_eis, o_ovf = lad.oracle_sample(node, seq)
                assert torch.equal(n_ids[j], o_nid)
                assert int(ovf[j]) == int(o_ovf)
                for e, oe in zip(eis, o_eis):
                    assert torch.equal(e[j], oe)
                np.testing.assert_array_equal(logp[j], st.oracle(node, seq))


def test_seams_exclude_each_other(wgraph):
    _tj, tt = wgraph
    dt = tt.to_device(device="cpu", with_weights=True)
    seeds = torch.arange(4, dtype=torch.int32)
    u01 = torch.rand(4, 2)
    offs = torch.zeros((4, 2), dtype=torch.int32)
    for seams in ({"u": u01, "bits": u01}, {"u": u01, "offs": offs},
                  {"bits": u01, "offs": offs}):
        with pytest.raises(ValueError, match="exclude each other"):
            sample_t.sample_layer(dt, seeds, 4, 2, weighted=True, **seams)
    with pytest.raises(ValueError, match="needs weighted=True"):
        sample_t.sample_layer(dt, seeds, 4, 2, u=u01)
    with pytest.raises(ValueError, match="excludes weighted=True"):
        sample_t.sample_layer(dt, seeds, 4, 2, weighted=True, offs=offs)
    with pytest.raises(ValueError, match="generator or u, or bits"):
        sample_t.sample_layer(dt, seeds, 4, 2, weighted=True)
    with pytest.raises(ValueError, match="one of draw and bits"):
        multilayer_sample(dt, seeds, 4, [2], [16], weighted=True)
