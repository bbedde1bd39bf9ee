"""K1's fused uniform hop (``uniform_hop``/``uniform_hop_plain``) against
quiver_tpu and against the port's composed path.

* ``uniform_hop_plain`` against JAX ``sample_layer`` on a Pareto graph,
  fed JAX's own draws as raw bits: the ``jax.random.randint`` calls of
  ``quiver_tpu/ops/sample.py`` ``stratified_offsets``/``rotate_offsets``
  with the same keys and spans, so ``% span`` is the identity.
* ``uniform_hop_plain`` against the composed path (``seed_degrees``,
  ``stratified_offsets``, ``rotate_offsets``, then ``sample_layer``'s
  select entry) on numpy-made 62-bit bits: rows with ``deg <= k``, invalid
  and -1 seeds, leading lane dimensions with per-lane ``num_seeds``, int32
  and int64 indptr, with and without an ``eid`` table.
* The generator draws of ``sample_layer``, ``GraphSageSampler`` and the
  serving ladder give bitwise what the composed path gives on the same
  generators.

Tolerance: bitwise for neighbours, counts and eids, dtypes included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops import sample as sample_t  # noqa: E402
from quiver_tpu_torch.ops.kernels.fused import (  # noqa: E402
    uniform_hop, uniform_hop_plain)
from quiver_tpu_torch.sampling.sampler import multilayer_sample  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    coo = generate_pareto_graph(600, 9.0, seed=7)
    return qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)


def _jax_bits(key, indptr, seeds, num, k):
    """JAX's uniform draw of ``sample_layer`` as raw bits: the jitter and
    rotation ``randint`` calls with the keys and spans JAX uses."""
    kj, kr = jax.random.split(key)
    S = seeds.shape[0]
    valid = (jnp.arange(S) < num) & (seeds >= 0)
    s = jnp.where(valid, seeds, 0)
    base = indptr[s]
    deg = jnp.where(valid, (indptr[s + 1] - base).astype(jnp.int32), 0)
    i = jnp.arange(k, dtype=jnp.int32)[None, :]
    degc = deg[:, None]
    q, r = degc // k, degc % k
    lo = i * q + (i * r) // k
    hi = (i + 1) * q + ((i + 1) * r) // k
    jitter = jax.random.randint(kj, (S, k), 0, jnp.maximum(hi - lo, 1),
                                dtype=jnp.int32)
    rot = jax.random.randint(kr, (S, 1), 0, jnp.maximum(degc, 1), dtype=jnp.int32)
    return (torch.from_numpy(np.array(jitter)).long(),
            torch.from_numpy(np.array(rot)).long())


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("with_eid,topo_eid", [(False, False), (True, True), (True, False)])
def test_uniform_hop_plain_matches_jax_sample_layer(graph, k, with_eid, topo_eid):
    tj, tt = graph
    dj = tj.to_device(with_eid=topo_eid)
    dt = tt.to_device(device="cpu", with_eid=topo_eid)
    rng = np.random.default_rng(100 + k)
    seeds = rng.integers(0, tj.node_count, 40).astype(np.int32)
    seeds[[3, 17]] = seeds[5]  # duplicates
    seeds[[0, 1]] = np.flatnonzero(tj.degree <= k)[:2]  # take-all rows
    seeds[35:] = -1  # padding
    num = 33  # lanes 33.. are invalid although 33, 34 hold ids
    key = jax.random.PRNGKey(31 + k)
    want = sample_j.sample_layer(dj, jnp.asarray(seeds), jnp.int32(num), k, key,
                                 with_eid=with_eid)
    jitter, rot = _jax_bits(key, dj.indptr, jnp.asarray(seeds), num, k)
    seeds_t = torch.from_numpy(seeds)
    got = uniform_hop_plain(dt.indptr, dt.indices, seeds_t, num, jitter, rot,
                            eid=dt.eid, with_eid=with_eid)
    _assert_same(got, want)
    before = uniform_hop.launches
    _assert_same(uniform_hop(dt.indptr, dt.indices, seeds_t, num, jitter, rot,
                             eid=dt.eid, with_eid=with_eid), want)
    assert uniform_hop.launches == before  # CPU tensors never launch K1
    # the bits seam of sample_layer, as a pair and as a callable of the shape
    _assert_same(sample_t.sample_layer(dt, seeds_t, num, k, with_eid=with_eid,
                                       bits=(jitter, rot)), want)
    _assert_same(sample_t.sample_layer(dt, seeds_t, num, k, with_eid=with_eid,
                                       bits=lambda shape: (jitter.reshape(shape + (k,)),
                                                           rot.reshape(shape + (1,)))),
                 want)


def _composed(dt, seeds, num, k, jitter, rot, with_eid):
    """The pre-fusion hop: offsets from the raw bits, then the select entry."""
    _valid, _base, deg = sample_t.seed_degrees(dt.indptr, seeds, num)
    off, _ = sample_t.stratified_offsets(deg, k, jitter)
    off = sample_t.rotate_offsets(off, deg, k, rot)
    return sample_t.sample_layer(dt, seeds, num, k, offs=off, with_eid=with_eid)


@pytest.mark.parametrize("indptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("with_eid,topo_eid", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("lanes", [None, "per-lane", "scalar"])
def test_uniform_hop_plain_equals_composed_path(graph, indptr_dtype, with_eid,
                                                topo_eid, lanes):
    _tj, tt = graph
    placed = tt.to_device(device="cpu", with_eid=topo_eid)
    dt = qt.DeviceTopology(placed.indptr.to(indptr_dtype), placed.indices, placed.eid)
    k, S = 6, 11
    rng = np.random.default_rng(7)
    lead = () if lanes is None else (3,)
    seeds = rng.integers(0, tt.node_count, lead + (S,)).astype(np.int32)
    low = np.flatnonzero(tt.degree <= k)
    seeds[..., 0] = low[0]  # deg <= k
    seeds[..., 1] = low[1]
    seeds[..., 2] = int(np.argmax(tt.degree))
    seeds[..., 9:] = -1
    seeds[..., 4] = -1  # a -1 inside the valid prefix
    if lanes == "per-lane":
        num = torch.tensor([9, 3, 0], dtype=torch.int32)
    else:
        num = 8
    seeds = torch.from_numpy(seeds)
    jitter = torch.from_numpy(rng.integers(0, 2**62, lead + (S, k), dtype=np.int64))
    rot = torch.from_numpy(rng.integers(0, 2**62, lead + (S, 1), dtype=np.int64))
    want = _composed(dt, seeds, num, k, jitter, rot, with_eid)
    got = uniform_hop_plain(dt.indptr, dt.indices, seeds, num, jitter, rot,
                            eid=dt.eid, with_eid=with_eid)
    assert len(got) == len(want) == (3 if with_eid else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if with_eid and not topo_eid:
        assert got[2].dtype == indptr_dtype  # CSR slots in indptr's width


def test_sample_layer_generator_draw_unchanged(graph):
    """With a generator the hop is the fused one; it draws the same bits,
    in the same order, as the composed path did."""
    _tj, tt = graph
    dt = tt.to_device(device="cpu", with_eid=True)
    seeds = torch.from_numpy(np.random.default_rng(1).integers(
        0, tt.node_count, (4, 30)).astype(np.int32))
    num = torch.tensor([30, 12, 1, 0])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = sample_t.sample_layer(dt, seeds, num, 5, g1, with_eid=True)
    jitter, rot = sample_t.draw_bits(seeds.shape, 5, g2)
    want = _composed(dt, seeds, num, 5, jitter, rot, True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_sampler_own_draws_equal_composed_path(graph):
    """GraphSageSampler's generator draws (the fused hop) give bitwise the
    SampleOutput of the composed path on the same per-layer generators."""
    _tj, tt = graph
    sizes = [4, 3]
    seeds = np.array([5, 7, 7, 300, 11, 599], np.int64)
    fused = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True)
    composed = qt.GraphSageSampler(tt, sizes, device="cpu", seed=9, with_eid=True)
    out_f = fused.sample(seeds)
    out_c = composed.sample(seeds, draw_fn=lambda l, deg: sample_t.uniform_offsets(
        deg, sizes[l], sample_t.seeded_generator("cpu", 9, 1, l)))
    assert torch.equal(out_f.n_id, out_c.n_id)
    assert int(out_f.n_count) == int(out_c.n_count)
    for a, b in zip(out_f.adjs, out_c.adjs):
        assert a.size == b.size
        assert torch.equal(a.edge_index, b.edge_index)
        assert torch.equal(a.e_id, b.e_id)
    for a, b in zip(out_f.edge_counts + out_f.frontier_counts,
                    out_c.edge_counts + out_c.frontier_counts):
        assert int(a) == int(b)


def test_ladder_fused_hop_equals_oracle_every_bucket():
    """The ladder samples all lanes in one fused hop per layer on their
    stacked bits; the oracle computes each lane's offsets and runs the
    select entry. Ids and edges agree bitwise at every bucket, full and
    padded."""
    coo = generate_pareto_graph(500, 7.0, seed=4)
    tt = qt.CSRTopo(edge_index=coo)
    st = qt.InferenceServer(
        qt.GraphSageSampler(tt, [5, 3], device="cpu"), qt.GraphSAGE(4, 8, 3),
        qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(
            np.ones((500, 4), np.float32)),
        device="cpu", max_batch=4, seed=11)
    lad = st.ladder
    picks = [(int(np.argmax(tt.degree)), 3), (2, 40), (499, 41), (17, 7)]
    for bucket in st.batcher.buckets:
        for group in (picks[:bucket], picks[1:bucket]):
            seeds = torch.full((bucket,), -1, dtype=torch.int32)
            seqs = [None] * bucket
            for j, (node, seq) in enumerate(group):
                seeds[j], seqs[j] = node, seq
            n_ids, eis, ovf = lad.sample_exec(bucket)(seeds, seqs)
            for j, (node, seq) in enumerate(group):
                o_nid, o_eis, o_ovf = lad.oracle_sample(node, seq)
                assert torch.equal(n_ids[j], o_nid)
                assert int(ovf[j]) == int(o_ovf)
                for e, oe in zip(eis, o_eis):
                    assert torch.equal(e[j], oe)


def test_seams_exclude_each_other(graph):
    _tj, tt = graph
    dt = tt.to_device(device="cpu")
    seeds = torch.arange(4, dtype=torch.int32)
    bits = sample_t.draw_bits((4,), 2, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bits"):
        sample_t.sample_layer(dt, seeds, 4, 2, bits=bits,
                              offs=torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="generator, bits or offs"):
        sample_t.sample_layer(dt, seeds, 4, 2)
    with pytest.raises(ValueError, match="one of draw and bits"):
        multilayer_sample(dt, seeds, 4, [2], [16])
