"""Full-neighbour layer-wise inference of quiver_tpu_torch
(``models/inference.py``) against quiver_tpu's.

The port has one aggregation strategy (a sorted accumulate per edge
chunk); the JAX package has two (``QUIVER_INFER_AGG=scatter|scan``), and
the port is held against both, at chunk sizes that split rows, on graphs
with zero-degree rows.

Tolerance: ``full_neighbor_mean`` within 1e-5 relative, plus 1e-5 of
the output's largest magnitude absolute: the JAX scan strategy differences
a running prefix sum, which loses about eps x |prefix| absolutely (its own
comment says so), so a mean that cancels to near zero is only that close
in absolute terms. Layer-wise log-probs within
atol = rtol = 1e-5 (float32; the frameworks sum in different orders). The
port's HOST placement against its HBM placement: bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import inference as inf_j  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import inference as inf_t  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402


def _graph(kind):
    """(JAX topo, port topo) of the same graph. "pareto": a power-law
    graph; "holes": rows of degree 0 between and after the others."""
    if kind == "pareto":
        coo = generate_pareto_graph(700, 8.0, seed=3)
        return qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    rng = np.random.default_rng(1)
    deg = rng.integers(0, 9, 300)
    deg[rng.random(300) < 0.3] = 0
    deg[-20:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, 300, int(indptr[-1]))
    return (qj.CSRTopo(indptr=indptr, indices=indices),
            qt.CSRTopo(indptr=indptr, indices=indices))


@pytest.mark.parametrize("strategy", ["scatter", "scan"])
@pytest.mark.parametrize("kind", ["pareto", "holes"])
@pytest.mark.parametrize("chunk", [7, 256, 1 << 21])
def test_full_neighbor_mean_matches_jax(monkeypatch, strategy, kind, chunk):
    tj, tt = _graph(kind)
    x = np.random.default_rng(chunk).normal(size=(tt.node_count, 6)).astype(np.float32)
    monkeypatch.setenv("QUIVER_INFER_AGG", strategy)
    want = np.asarray(inf_j.full_neighbor_mean(tj, jnp.asarray(x), chunk=chunk))
    got = inf_t.full_neighbor_mean(tt, torch.from_numpy(x), chunk=chunk, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    empty = tt.degree == 0
    assert empty.any() == (kind == "holes")
    assert not got.numpy()[empty].any()  # zero-degree rows aggregate to zeros


@pytest.mark.parametrize("chunk", [5, 1000, 1 << 21])
def test_host_mode_equals_hbm_bitwise(chunk):
    _tj, tt = _graph("pareto")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(tt.node_count, 9)).astype(np.float32))
    hbm = inf_t.full_neighbor_mean(tt, x, chunk=chunk, mode="HBM", device="cpu")
    host = inf_t.full_neighbor_mean(tt, x, chunk=chunk, mode="HOST", device="cpu")
    assert torch.equal(host, hbm)


@pytest.mark.parametrize("strategy", ["scatter", "scan"])
@pytest.mark.parametrize("layers", [2, 3])
def test_sage_layerwise_inference_matches_jax(monkeypatch, strategy, layers):
    tj, tt = _graph("pareto")
    F, hid, cls = 10, 16, 5
    x = np.random.default_rng(layers).normal(size=(tt.node_count, F)).astype(np.float32)
    mj = SageJ(hidden=hid, num_classes=cls, num_layers=layers)
    adjs = empty_adjs([3] * layers, batch=8, node_count=tt.node_count)
    params = init_model(mj, jax.random.PRNGKey(layers),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    monkeypatch.setenv("QUIVER_INFER_AGG", strategy)
    want = np.asarray(inf_j.sage_layerwise_inference(mj, params, tj, jnp.asarray(x),
                                                     chunk=1000))
    mt = qt.GraphSAGE(F, hid, cls, num_layers=layers)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    for mode in ("HBM", "HOST"):
        got = inf_t.sage_layerwise_inference(mt, tt, torch.from_numpy(x), chunk=1000,
                                             mode=mode, device="cpu")
        assert got.shape == (tt.node_count, cls) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_layerwise_matches_sampled_forward_at_full_fanout():
    """On a graph whose every degree fits the fanout, a sampled forward
    over all neighbours gives the layer-wise log-probs of its seeds."""
    coo = generate_pareto_graph(200, 3.0, seed=4, max_degree=6)
    tt = qt.CSRTopo(edge_index=coo)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(200, 7)).astype(np.float32))
    mt = qt.GraphSAGE(7, 12, 3).eval()
    want = inf_t.sage_layerwise_inference(mt, tt, x, device="cpu")
    k = tt.max_degree
    sampler = qt.GraphSageSampler(tt, [k, k], device="cpu")
    seeds = np.arange(0, 200, 9)
    out = sampler.sample(seeds)
    feat = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(x)
    with torch.no_grad():
        got = mt(feat[out.n_id], out.adjs)[:len(seeds)]
    np.testing.assert_allclose(got.numpy(), want[seeds].numpy(), atol=1e-5, rtol=1e-5)


def test_inference_raises_without_a_card(monkeypatch):
    _tj, tt = _graph("holes")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inf_t.full_neighbor_mean(tt, torch.zeros(tt.node_count, 2))
