"""Layer-wise full-neighbour inference of GCN, GIN and GAT in
quiver_tpu_torch (``models/inference.py``) against quiver_tpu's, and
against the port's own sampled models at full fanout.

The port has one aggregation strategy (a sorted accumulate per edge
chunk); the JAX package has two (``QUIVER_INFER_AGG=scatter|scan``), and
the port is held against both, in HBM and HOST placement, at chunk sizes
that split rows (7 and 97 edges) and at one chunk for the whole graph.

Tolerances (float32; the frameworks and the two paths sum in different
orders):
- against JAX's layer-wise log-probs: 1e-5 relative plus 1e-5 of the
  largest magnitude absolute (``tests/test_torch_inference.py``'s rule:
  JAX's scan strategy differences a running prefix sum, which loses about
  eps x |prefix| absolutely, and GIN's unnormalised sums grow it);
- the port's HOST placement against its HBM placement: bitwise;
- layer-wise against the sampled model at full fanout: rtol 1e-4, atol
  1e-5 (GAT: 2e-4 / 2e-5), the tolerances of ``tests/test_gcn.py:115``,
  ``tests/test_gin.py:110`` and ``tests/test_inference.py:71-102``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import GAT as GatJ, GCN as GcnJ, GIN as GinJ  # noqa: E402
from quiver_tpu.models import inference as inf_j  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import GAT, GCN, GIN, convert  # noqa: E402
from quiver_tpu_torch.models import inference as inf_t  # noqa: E402
from quiver_tpu_torch.parallel.train import init_model as init_port  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

F_IN, HID, CLS, HEADS = 10, 16, 4, 3


def _sym_coo(n, seed):
    """A symmetrised pareto graph (in-degree == out-degree), which GCN's
    one degree vector assumes."""
    coo = generate_pareto_graph(n, 4.0, seed=seed)
    return np.concatenate([coo, coo[::-1]], axis=1)


def _families(family, layers=2, train_eps=False):
    """(JAX model, JAX inference, port model, port inference, converter)."""
    if family == "gcn":
        return (GcnJ(hidden=HID, num_classes=CLS, num_layers=layers, dropout=0.0),
                inf_j.gcn_layerwise_inference,
                GCN(F_IN, HID, CLS, num_layers=layers, dropout=0.0),
                inf_t.gcn_layerwise_inference, convert.flax_gcn_to_state_dict)
    if family == "gin":
        return (GinJ(hidden=HID, num_classes=CLS, num_layers=layers, dropout=0.0,
                     train_eps=train_eps),
                inf_j.gin_layerwise_inference,
                GIN(F_IN, HID, CLS, num_layers=layers, dropout=0.0, train_eps=train_eps),
                inf_t.gin_layerwise_inference, convert.flax_gin_to_state_dict)
    return (GatJ(hidden=HID, num_classes=CLS, num_layers=layers, heads=HEADS, dropout=0.0),
            inf_j.gat_layerwise_inference,
            GAT(F_IN, HID, CLS, num_layers=layers, heads=HEADS, dropout=0.0),
            inf_t.gat_layerwise_inference, convert.flax_gat_to_state_dict)


def _params(mj, n, seed):
    """flax parameters, every leaf redrawn from numpy (non-zero biases)."""
    adjs = empty_adjs([3, 3], batch=8, node_count=n)
    p = init_model(mj, jax.random.PRNGKey(seed),
                   np.zeros((adjs[0].size[0], F_IN), np.float32), adjs)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), p)


@pytest.fixture(scope="module")
def graph():
    """(JAX topo, port topo, features) of a symmetric graph whose last 6
    nodes have no edges (GAT gives them their bias only)."""
    coo = _sym_coo(160, seed=3)
    coo = coo[:, (coo < 154).all(axis=0)]
    indptr = np.zeros(161, np.int64)
    np.add.at(indptr, coo[0] + 1, 1)
    order = np.lexsort((coo[1], coo[0]))
    indptr = np.cumsum(indptr)
    indices = coo[1][order]
    x = np.random.default_rng(4).normal(size=(160, F_IN)).astype(np.float32)
    return (qj.CSRTopo(indptr=indptr, indices=indices),
            qt.CSRTopo(indptr=indptr, indices=indices), x)


@pytest.mark.parametrize("strategy", ["scatter", "scan"])
@pytest.mark.parametrize("chunk", [7, 97, 1 << 21])
@pytest.mark.parametrize("family", ["gcn", "gin", "gat"])
def test_layerwise_matches_jax(monkeypatch, graph, family, chunk, strategy):
    tj, tt, x = graph
    mj, infer_j, mt, infer_t, conv_sd = _families(family)
    params = _params(mj, tt.node_count, seed=len(family))
    mt.load_state_dict(conv_sd(params))
    monkeypatch.setenv("QUIVER_INFER_AGG", strategy)
    want = np.asarray(infer_j(mj, params, tj, jnp.asarray(x), chunk=chunk))
    hbm = infer_t(mt, tt, torch.from_numpy(x), chunk=chunk, mode="HBM", device="cpu")
    host = infer_t(mt, tt, torch.from_numpy(x), chunk=chunk, mode="HOST", device="cpu")
    assert hbm.shape == (tt.node_count, CLS) and hbm.dtype == torch.float32
    np.testing.assert_allclose(hbm.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(host, hbm)


def test_gin_train_eps_layerwise_matches_jax(graph):
    tj, tt, x = graph
    mj, infer_j, mt, infer_t, conv_sd = _families("gin", train_eps=True)
    params = _params(mj, tt.node_count, seed=7)
    assert "eps" in params["conv1"]
    mt.load_state_dict(conv_sd(params))
    want = np.asarray(infer_j(mj, params, tj, jnp.asarray(x), chunk=53))
    got = infer_t(mt, tt, torch.from_numpy(x), chunk=53, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _sampled(mt, tt, x, seeds):
    """The port model's eval-mode log-probs of ``seeds`` from a sampled
    forward over every neighbour (fanout = the largest degree)."""
    k = tt.max_degree
    sampler = qt.GraphSageSampler(tt, [k] * mt.num_layers, device="cpu",
                                  seed_capacity=len(seeds), seed=0)
    out = sampler.sample(seeds)
    assert int(out.overflow) == 0
    feat = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(x)
    with torch.no_grad():
        return mt.eval()(feat[out.n_id], out.adjs)[:len(seeds)]


@pytest.mark.parametrize("family", ["gcn", "gin", "gat"])
def test_layerwise_matches_sampled_model_at_full_fanout(family):
    """GCN and GIN seed every node (block degrees and sums are then the
    whole graph's) of a symmetric graph; GAT seeds 48 of 200 nodes."""
    n = 80 if family != "gat" else 200
    coo = _sym_coo(n, seed=3) if family != "gat" else generate_pareto_graph(n, 5.0, seed=8)
    tt = qt.CSRTopo(edge_index=coo)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(tt.node_count, F_IN)).astype(np.float32))
    _, _, mt, infer_t, _ = _families(family)
    init_port(mt, torch.Generator().manual_seed(5))
    seeds = np.arange(tt.node_count) if family != "gat" else np.arange(48)
    got = _sampled(mt, tt, x, seeds)
    want = infer_t(mt, tt, x, chunk=97, device="cpu")[seeds]
    tol = dict(rtol=2e-4, atol=2e-5) if family == "gat" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_gat_isolated_nodes_get_bias_only(graph):
    """A one-layer GAT: nodes with no in-edges output their bias."""
    _, tt, x = graph
    mt = GAT(F_IN, HID, CLS, num_layers=1, heads=HEADS)
    with torch.no_grad():
        mt.convs[0].bias.normal_(generator=torch.Generator().manual_seed(1))
    got = inf_t.gat_layerwise_inference(mt, tt, torch.from_numpy(x), chunk=50,
                                        device="cpu")
    want = torch.log_softmax(mt.convs[0].bias.detach(), dim=-1)
    assert (tt.degree[-6:] == 0).all()
    for row in got[-6:]:
        torch.testing.assert_close(row, want, rtol=0, atol=1e-6)


def test_family_inference_raises_without_a_card(monkeypatch, graph):
    _, tt, x = graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, model in ((inf_t.gcn_layerwise_inference, GCN(F_IN, HID, CLS)),
                      (inf_t.gin_layerwise_inference, GIN(F_IN, HID, CLS)),
                      (inf_t.gat_layerwise_inference, GAT(F_IN, HID, CLS))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model, tt, torch.from_numpy(x))


@pytest.mark.parametrize("family", ["gcn", "gin", "gat"])
def test_layerwise_computes_in_float32_for_a_bf16_model(graph, family):
    """As the JAX package's fresh layers do: a bf16-compute model's pass
    equals its float32 twin's bitwise, and the model keeps its dtype."""
    _, tt, x = graph
    make = {"gcn": lambda d: GCN(F_IN, HID, CLS, dtype=d),
            "gin": lambda d: GIN(F_IN, HID, CLS, dtype=d),
            "gat": lambda d: GAT(F_IN, HID, CLS, heads=HEADS, dtype=d)}[family]
    f32 = init_port(make(None), torch.Generator().manual_seed(3))
    half = make("bfloat16")
    half.load_state_dict(f32.state_dict())
    infer = getattr(inf_t, f"{family}_layerwise_inference")
    want = infer(f32, tt, torch.from_numpy(x), chunk=97, device="cpu")
    got = infer(half, tt, torch.from_numpy(x), chunk=97, device="cpu")
    assert torch.equal(got, want)
    assert all(conv.dtype == torch.bfloat16 for conv in half.convs)
