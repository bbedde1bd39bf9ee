"""``GraphSageSampler(device_topo=)`` of the port: samplers and serving
replicas sharing one placed topology, against unshared placements and the
JAX sampler's checks.

Tolerance: bitwise (sampled ids, edges, edge ids and served log-probs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu as qj  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


@pytest.fixture(scope="module")
def topo():
    coo = generate_pareto_graph(400, 6.0, seed=3)
    rng = np.random.default_rng(3)
    t = qt.CSRTopo(edge_index=coo, edge_weight=rng.random(coo.shape[1]))
    t.set_edge_time(rng.random(coo.shape[1]))
    return t


CASES = [{}, {"weighted": True}, {"with_eid": True}, {"time_window": (0.2, 0.7)},
         {"weighted": True, "with_eid": True, "kernel": "pallas"}]


@pytest.mark.parametrize("kw", CASES)
def test_shared_placement_samples_bitwise_as_unshared(topo, kw):
    placed = topo.to_device("GPU", "cpu", with_eid=True, with_weights=True,
                            with_times=True)
    shared = qt.GraphSageSampler(topo, [4, 3], device="cpu", seed=5,
                                 device_topo=placed, **kw)
    own = qt.GraphSageSampler(topo, [4, 3], device="cpu", seed=5, **kw)
    assert shared.topo is placed and own.topo is not placed
    for batch in (np.arange(7), np.array([399, 0, 0, 17])):
        a, b = shared.sample(batch), own.sample(batch)
        assert torch.equal(a.n_id, b.n_id)
        for x, y in zip(a.adjs, b.adjs):
            assert torch.equal(x.edge_index, y.edge_index)
            assert (x.e_id is None) == (y.e_id is None)
            if x.e_id is not None:
                assert torch.equal(x.e_id, y.e_id)


def test_missing_attribute_raises_as_jax(topo):
    """A placement without what the sampler reads raises ValueError, as
    the JAX sampler does for the same three attributes."""
    bare = topo.to_device("GPU", "cpu")
    tj = qj.CSRTopo(indptr=topo.indptr, indices=topo.indices)
    tj.set_edge_weight(topo.edge_weight, coo_order=False)
    tj.set_edge_time(topo.edge_time, coo_order=False)
    bare_j = tj.to_device("HBM")
    for kw, attr in (({"with_eid": True}, "eid"), ({"weighted": True}, "cum_weights"),
                     ({"time_window": (0.1, 0.5)}, "edge_time")):
        with pytest.raises(ValueError, match=f"lacks {attr}"):
            qt.GraphSageSampler(topo, [2], device="cpu", device_topo=bare, **kw)
        with pytest.raises(ValueError, match=f"lacks {attr}"):
            qj.GraphSageSampler(tj, [2], device_topo=bare_j, **kw)
    with pytest.raises(TypeError, match="DeviceTopology"):
        qt.GraphSageSampler(topo, [2], device="cpu", device_topo=bare_j)
    meta = qt.DeviceTopology(*(torch.empty(0, device="meta") for _ in range(2)))
    with pytest.raises(ValueError, match="lives on meta"):
        qt.GraphSageSampler(topo, [2], device="cpu", device_topo=meta)


def test_servers_share_one_placement(topo):
    """A uniform and a weighted server over one placement answer bitwise
    as servers over their own placements; refreshing after a mutation
    places the sampler's own copy, as in JAX."""
    placed = topo.to_device("GPU", "cpu", with_weights=True)
    feat = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(
        np.random.default_rng(0).normal(size=(400, 5)).astype(np.float32))
    torch.manual_seed(0)
    model = qt.GraphSAGE(5, 8, 3)
    nodes = [5, 77, 399, 5, 120]
    for weighted in (False, True):
        answers = []
        for dt in (placed, None):
            s = qt.InferenceServer(
                qt.GraphSageSampler(topo, [4, 3], device="cpu", weighted=weighted,
                                    device_topo=dt), model, feat, device="cpu",
                max_batch=4, seed=1)
            answers.append(np.stack([r.result for r in s.serve(nodes)]))
        np.testing.assert_array_equal(answers[0], answers[1])
    smp = qt.GraphSageSampler(topo, [4], device="cpu", device_topo=placed)
    smp.refresh_topology()
    assert smp.topo is placed  # the placement is current: nothing to do
    topo._version += 1  # what a committed mutation does
    smp.refresh_topology()
    assert smp.topo is not placed and smp.topo.cum_weights is None
    topo._version -= 1
