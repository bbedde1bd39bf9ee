"""The layer-wise inference's ``QUIVER_INFER_AGG`` switch in
quiver_tpu_torch (``models/inference.py``) against quiver_tpu's.

The JAX package has two chunk aggregations (``scatter``, an accumulate,
and ``scan``, prefix differences); the port reads and checks the same
variable and runs its accumulate under both names. So each ``"scan"``
case holds the port against the JAX package's scan on the same graph,
features, chunk and (for the layer-wise passes) weights, carried across
by ``models/convert.py``, and against the port's own accumulate.

Tolerances:
- float32, against JAX's scan: 1e-5 relative plus 1e-5 of the output's
  largest magnitude absolute (``tests/test_torch_inference.py``'s rule: a
  differenced prefix loses about eps x |prefix| absolutely), at every
  chunk, one chunk over the whole graph included;
- the same-sign graph of ``tests/test_inference.py``: against JAX's scan
  within 2e-4 relative and absolute (the JAX package's own tolerance
  between its two strategies there) and against JAX's accumulate within
  1e-5 of the largest magnitude absolute;
- bfloat16 features: 8e-3 relative plus 8e-3 of the largest magnitude
  (bfloat16 keeps 8 bits; the two packages round the accumulator and the
  division separately);
- ``"scan"`` against ``"scatter"`` and unset, and HOST against HBM:
  bitwise.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import GAT as GatJ, GCN as GcnJ, GIN as GinJ  # noqa: E402
from quiver_tpu.models import inference as inf_j  # noqa: E402
from quiver_tpu.models import rgcn as rgcn_j  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import GAT, GCN, GIN, convert  # noqa: E402
from quiver_tpu_torch.models import inference as inf_t  # noqa: E402
from quiver_tpu_torch.models.rgcn import RGCN, rgcn_schema  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

from test_torch_hetero import toy_schema  # noqa: E402
from test_torch_rgcn import _jax_layers, _randomise  # noqa: E402

F_IN, HID, CLS, HEADS = 10, 16, 4, 3
CHUNKS = [7, 128, 256, 1 << 21]
SCATTER_OPS = {"index_add", "index_add_", "index_put", "index_put_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
               "scatter_reduce_"}


def _both(indptr=None, indices=None, edge_index=None):
    """The same CSR in both packages."""
    kw = dict(indptr=indptr, indices=indices, edge_index=edge_index)
    return qj.CSRTopo(**kw), qt.CSRTopo(**kw)


def _graph(kind):
    """(JAX topo, port topo). "pareto" and "holes" are
    ``tests/test_torch_inference.py``'s graphs; "hub" is
    ``tests/test_inference.py``'s: a row of degree 500, a zero-degree run
    (rows 40-79) and a ragged tail."""
    if kind == "pareto":
        return _both(edge_index=generate_pareto_graph(700, 8.0, seed=3))
    if kind == "holes":
        rng = np.random.default_rng(1)
        deg = rng.integers(0, 9, 300)
        deg[rng.random(300) < 0.3] = 0
        deg[-20:] = 0
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        return _both(indptr, rng.integers(0, 300, int(indptr[-1])))
    rng = np.random.default_rng(9)
    srcs, dsts = rng.integers(0, 200, 500).tolist(), [0] * 500
    for v in range(1, 40):
        d = int(rng.integers(1, 9))
        dsts += [v] * d
        srcs += rng.integers(0, 200, d).tolist()
    for v in range(80, 200):
        d = int(rng.integers(0, 5))
        dsts += [v] * d
        srcs += rng.integers(0, 200, d).tolist()
    return _both(edge_index=np.stack([np.array(dsts), np.array(srcs)]))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _mean(tt, x, chunk, **kw):
    return inf_t.full_neighbor_mean(tt, x, chunk=chunk, device="cpu", **kw)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["pareto", "holes", "hub"])
def test_forced_scan_matches_jax_scan(monkeypatch, kind, chunk):
    tj, tt = _graph(kind)
    x = np.random.default_rng(chunk).normal(size=(tt.node_count, 6)).astype(np.float32)
    monkeypatch.setenv("QUIVER_INFER_AGG", "scan")
    want = np.asarray(inf_j.full_neighbor_mean(tj, jnp.asarray(x), chunk=chunk))
    got = _mean(tt, torch.from_numpy(x), chunk)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    assert not got.numpy()[tt.degree == 0].any()  # zero-degree rows stay zeros
    monkeypatch.setenv("QUIVER_INFER_AGG", "scatter")
    assert torch.equal(got, _mean(tt, torch.from_numpy(x), chunk))


@pytest.mark.parametrize("strategy", ["scatter", "scan"])
def test_edgeless_graph_gives_zeros(monkeypatch, strategy):
    """The port walks no chunk (the JAX package's masked chunk cannot
    gather from an empty edge array, so it is not run here)."""
    tt = qt.CSRTopo(indptr=np.zeros(11, np.int64), indices=np.zeros(0, np.int64))
    x = torch.ones(10, 3)
    monkeypatch.setenv("QUIVER_INFER_AGG", strategy)
    for mode in ("HBM", "HOST"):
        got = _mean(tt, x, 4, mode=mode)
        assert got.shape == (10, 3) and not got.any()


def test_forced_scan_same_sign_graph(monkeypatch):
    """All-positive (post-ReLU-like) features through a 2^17-edge chunk
    (``tests/test_inference.py``'s regression for the JAX scan's
    centring): the port under ``"scan"`` is its accumulate, within the
    JAX package's tolerance of JAX's scan and close to JAX's accumulate."""
    rng = np.random.default_rng(11)
    n, e = 3000, 1 << 17
    tj, tt = _both(edge_index=np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    x = np.abs(rng.normal(size=(n, 8))).astype(np.float32) + 1.0
    want = {}
    for s in ("scatter", "scan"):
        monkeypatch.setenv("QUIVER_INFER_AGG", s)
        want[s] = np.asarray(inf_j.full_neighbor_mean(tj, jnp.asarray(x), chunk=1 << 17))
    got = _mean(tt, torch.from_numpy(x), 1 << 17)
    np.testing.assert_allclose(got.numpy(), want["scan"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want["scatter"], rtol=0,
                               atol=1e-5 * np.abs(want["scatter"]).max())
    monkeypatch.setenv("QUIVER_INFER_AGG", "scatter")
    assert torch.equal(got, _mean(tt, torch.from_numpy(x), 1 << 17))


@pytest.mark.parametrize("chunk", [256, 1 << 21])
def test_forced_scan_bf16_matches_jax_bf16_scan(monkeypatch, chunk):
    tj, tt = _graph("pareto")
    x = np.random.default_rng(5).normal(size=(tt.node_count, 6)).astype(np.float32)
    monkeypatch.setenv("QUIVER_INFER_AGG", "scan")
    want = inf_j.full_neighbor_mean(tj, jnp.asarray(x, jnp.bfloat16), chunk=chunk)
    got = _mean(tt, torch.from_numpy(x).to(torch.bfloat16), chunk)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), tol=8e-3)


# -- the layer-wise passes ---------------------------------------------------


@pytest.fixture(scope="module")
def sym_graph():
    """(JAX topo, port topo, features): a symmetrised pareto graph (GCN's
    one degree vector assumes in-degree == out-degree)."""
    coo = generate_pareto_graph(160, 4.0, seed=3)
    tj, tt = _both(edge_index=np.concatenate([coo, coo[::-1]], axis=1))
    x = np.random.default_rng(4).normal(size=(160, F_IN)).astype(np.float32)
    return tj, tt, x


def _homogeneous(family, n, seed):
    """(JAX model, its params redrawn from numpy, the port model loaded
    with them, the JAX pass, the port's pass)."""
    if family == "sage":
        mj, mt = SageJ(hidden=HID, num_classes=CLS, num_layers=2), qt.GraphSAGE(F_IN, HID, CLS)
        to_sd = convert.flax_sage_to_state_dict
    elif family == "gcn":
        mj = GcnJ(hidden=HID, num_classes=CLS, num_layers=2, dropout=0.0)
        mt, to_sd = GCN(F_IN, HID, CLS, dropout=0.0), convert.flax_gcn_to_state_dict
    elif family == "gin":
        mj = GinJ(hidden=HID, num_classes=CLS, num_layers=2, dropout=0.0)
        mt, to_sd = GIN(F_IN, HID, CLS, dropout=0.0), convert.flax_gin_to_state_dict
    else:
        mj = GatJ(hidden=HID, num_classes=CLS, num_layers=2, heads=HEADS, dropout=0.0)
        mt = GAT(F_IN, HID, CLS, heads=HEADS, dropout=0.0)
        to_sd = convert.flax_gat_to_state_dict
    adjs = empty_adjs([3, 3], batch=8, node_count=n)
    p = init_model(mj, jax.random.PRNGKey(seed),
                   np.zeros((adjs[0].size[0], F_IN), np.float32), adjs)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), p)
    mt.load_state_dict(to_sd(jax.tree_util.tree_map(np.asarray, params)))
    name = f"{family}_layerwise_inference"
    return mj, params, mt.eval(), getattr(inf_j, name), getattr(inf_t, name)


@pytest.mark.parametrize("chunk", [7, 97, 1 << 21])
@pytest.mark.parametrize("family", ["sage", "gcn", "gin"])
def test_layerwise_forced_scan_matches_jax_scan(monkeypatch, sym_graph, family, chunk):
    tj, tt, x = sym_graph
    mj, params, mt, infer_j, infer_t = _homogeneous(family, tt.node_count, seed=len(family))
    monkeypatch.setenv("QUIVER_INFER_AGG", "scan")
    want = np.asarray(infer_j(mj, params, tj, jnp.asarray(x), chunk=chunk))
    hbm = infer_t(mt, tt, torch.from_numpy(x), chunk=chunk, device="cpu")
    host = infer_t(mt, tt, torch.from_numpy(x), chunk=chunk, mode="HOST", device="cpu")
    assert hbm.shape == (tt.node_count, CLS) and hbm.dtype == torch.float32
    _close(hbm.numpy(), want)
    assert torch.equal(host, hbm)


@pytest.fixture(scope="module")
def typed_graph():
    num_nodes, edges = toy_schema(seed=5)
    return qj.HeteroCSRTopo(num_nodes, edges), qt.HeteroCSRTopo(num_nodes, edges), num_nodes


def _rgcn_pair(tt, num_nodes, num_bases, seed=7):
    """(JAX R-GCN, its params redrawn from numpy, the port's loaded with
    them, the feature tables), as ``tests/test_torch_rgcn.py`` builds them."""
    widths = {"paper": 24, "author": 8, "inst": 4}
    rng = np.random.default_rng(6)
    tables = {t: rng.normal(size=(n, widths[t])).astype(np.float32)
              for t, n in num_nodes.items()}
    out = qt.HeteroGraphSampler(tt, [3, 2], "paper", seed_capacity=16, seed=2,
                                device="cpu").sample(np.arange(16))
    xs = {t: np.where((ids.numpy() >= 0)[:, None], tables[t][np.maximum(ids.numpy(), 0)],
                      0).astype(np.float32) for t, ids in out.n_id.items()}
    mj = rgcn_j.RGCN(hidden=HID, num_classes=CLS, target_type="paper", num_layers=2,
                     num_bases=num_bases, dropout=0.0)
    shapes = jax.eval_shape(lambda: mj.init(
        {"params": jax.random.PRNGKey(0)}, {t: jnp.asarray(v) for t, v in xs.items()},
        _jax_layers(out.adjs)))["params"]
    params = _randomise(shapes, seed)
    mt = RGCN(rgcn_schema(out.adjs, widths), HID, CLS, "paper", num_layers=2,
              num_bases=num_bases, dropout=0.0)
    mt.load_state_dict(convert.flax_rgcn_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return mj, params, mt, tables


@pytest.mark.parametrize("chunk", [7, 97, 1 << 21])
@pytest.mark.parametrize("num_bases", [0, 3])
def test_rgcn_layerwise_forced_scan_matches_jax_scan(monkeypatch, typed_graph, num_bases, chunk):
    """Each relation walks its own rectangular CSR (rows are destination
    ids)."""
    tj, tt, num_nodes = typed_graph
    mj, params, mt, tables = _rgcn_pair(tt, num_nodes, num_bases)
    monkeypatch.setenv("QUIVER_INFER_AGG", "scan")
    want = np.asarray(inf_j.rgcn_layerwise_inference(mj, params, tj, tables, chunk=chunk))
    got = {mode: inf_t.rgcn_layerwise_inference(mt, tt, tables, chunk=chunk, mode=mode,
                                                device="cpu")
           for mode in ("HBM", "HOST")}
    assert want.shape == (num_nodes["paper"], CLS)
    _close(got["HBM"].numpy(), want)
    assert torch.equal(got["HOST"], got["HBM"])


@pytest.mark.parametrize("chunk", [5, 1000, 1 << 21])
@pytest.mark.parametrize("kind", ["pareto", "holes", "hub"])
def test_forced_scan_host_equals_hbm_bitwise(monkeypatch, kind, chunk):
    _, tt = _graph(kind)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(tt.node_count, 9)).astype(np.float32))
    monkeypatch.setenv("QUIVER_INFER_AGG", "scan")
    assert torch.equal(_mean(tt, x, chunk, mode="HOST"), _mean(tt, x, chunk, mode="HBM"))


@pytest.mark.parametrize("family", ["mean", "sage", "gcn", "gin"])
def test_every_value_is_the_accumulate_bitwise(monkeypatch, sym_graph, family):
    """Unset, ``"scatter"`` and ``"scan"`` run the same accumulate: the
    output before the switch was read, bitwise."""
    _, tt, x = sym_graph
    if family == "mean":
        def run():
            return _mean(tt, torch.from_numpy(x), 97)
    else:
        mt = _homogeneous(family, tt.node_count, seed=1)[2]

        def run():
            return getattr(inf_t, f"{family}_layerwise_inference")(
                mt, tt, torch.from_numpy(x), chunk=97, device="cpu")
    monkeypatch.delenv("QUIVER_INFER_AGG", raising=False)
    unset = run()
    for value in ("scatter", "scan"):
        monkeypatch.setenv("QUIVER_INFER_AGG", value)
        assert torch.equal(unset, run())


@pytest.mark.parametrize("value", ["SCAN", " Scatter ", "scan\n", ""])
def test_spellings_both_packages_accept(monkeypatch, value):
    """Case and surrounding blanks are ignored and an empty value is
    unset, in both packages; the port runs its accumulate under each."""
    tj, tt = _graph("holes")
    x = np.random.default_rng(8).normal(size=(tt.node_count, 5)).astype(np.float32)
    monkeypatch.delenv("QUIVER_INFER_AGG", raising=False)
    want = _mean(tt, torch.from_numpy(x), 97)
    monkeypatch.setenv("QUIVER_INFER_AGG", value)
    assert inf_t._read_infer_agg() == (value.strip().lower() or "scatter")
    assert np.isfinite(np.asarray(inf_j.full_neighbor_mean(tj, jnp.asarray(x), chunk=97))).all()
    assert torch.equal(_mean(tt, torch.from_numpy(x), 97), want)


def _reading_entries(tt_typed):
    """``(name, JAX call, port call)`` of the five entries that read the
    switch; models and parameters are None, since the bad value must
    raise before either is touched."""
    tj, tt = _graph("holes")
    x = np.zeros((tt.node_count, 2), np.float32)
    tjh, tth, num_nodes = tt_typed
    xs = {t: np.zeros((n, 2), np.float32) for t, n in num_nodes.items()}
    out = [("full_neighbor_mean", lambda: inf_j.full_neighbor_mean(tj, x),
            lambda: inf_t.full_neighbor_mean(tt, x, device="cpu"))]
    for fam in ("sage", "gcn", "gin"):
        name = f"{fam}_layerwise_inference"
        out.append((name, lambda f=getattr(inf_j, name): f(None, None, tj, x),
                    lambda f=getattr(inf_t, name): f(None, tt, x, device="cpu")))
    out.append(("rgcn_layerwise_inference",
                lambda: inf_j.rgcn_layerwise_inference(None, None, tjh, xs),
                lambda: inf_t.rgcn_layerwise_inference(None, tth, xs, device="cpu")))
    return out


@pytest.mark.parametrize("entry", range(5))
def test_bad_value_raises_before_placement(monkeypatch, typed_graph, entry):
    name, run_j, run_t = _reading_entries(typed_graph)[entry]
    monkeypatch.setenv("QUIVER_INFER_AGG", "scna")
    with pytest.raises(ValueError, match="QUIVER_INFER_AGG"):
        run_j()

    def placed(*_a, **_k):
        raise AssertionError(f"{name} placed or resolved a device before the switch")

    monkeypatch.setattr(inf_t, "_place", placed)
    monkeypatch.setattr(inf_t, "resolve_device", placed)
    with pytest.raises(ValueError, match="QUIVER_INFER_AGG"):
        run_t()


def test_gat_does_not_read_the_switch(monkeypatch, sym_graph):
    """In neither package: a bad value runs GAT's accumulate as unset."""
    tj, tt, x = sym_graph
    mj, params, mt, infer_j, infer_t = _homogeneous("gat", tt.node_count, seed=3)
    want = infer_t(mt, tt, torch.from_numpy(x), chunk=97, device="cpu")
    want_j = np.asarray(infer_j(mj, params, tj, jnp.asarray(x), chunk=97))
    monkeypatch.setenv("QUIVER_INFER_AGG", "scna")
    assert torch.equal(infer_t(mt, tt, torch.from_numpy(x), chunk=97, device="cpu"), want)
    np.testing.assert_array_equal(
        np.asarray(infer_j(mj, params, tj, jnp.asarray(x), chunk=97)), want_j)


@pytest.mark.parametrize("family", ["mean", "sage", "rgcn", "gat"])
def test_switch_is_read_once_per_call(monkeypatch, sym_graph, typed_graph, family):
    """Once per entry call, whatever the layer count or relation count (0
    for GAT), and never cached: the next call reads it again."""
    _, tt, x = sym_graph
    calls = []
    real = inf_t.resolve_platform_strategy

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(inf_t, "resolve_platform_strategy", counted)
    if family == "rgcn":
        _, tth, num_nodes = typed_graph
        mt, tables = _rgcn_pair(tth, num_nodes, 0)[2:]

        def run():
            return inf_t.rgcn_layerwise_inference(mt, tth, tables, chunk=97, device="cpu")
    elif family == "mean":
        def run():
            return _mean(tt, torch.from_numpy(x), 97)
    else:
        mt = _homogeneous(family, tt.node_count, seed=2)[2]

        def run():
            return getattr(inf_t, f"{family}_layerwise_inference")(
                mt, tt, torch.from_numpy(x), chunk=97, device="cpu")
    run()
    run()
    want = 0 if family == "gat" else 2
    assert calls == ["QUIVER_INFER_AGG"] * want


class _Ops(TorchDispatchMode):
    """How many times a call runs each ATen op, by overload packet name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["HBM", "HOST"])
def test_forced_scan_runs_the_accumulate_ops(monkeypatch, mode):
    """Under either value, the same ATen ops the same number of times:
    one ``index_add_`` per chunk (the CPU's accumulate), no other scatter
    and no prefix sum."""
    _, tt = _graph("pareto")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(tt.node_count, 4)).astype(np.float32))
    chunks = -(-tt.edge_count // 256)
    assert chunks > 1
    counts = {}
    for strategy in ("scan", "scatter"):
        monkeypatch.setenv("QUIVER_INFER_AGG", strategy)
        with _Ops() as ops:
            _mean(tt, x, 256, mode=mode)
        counts[strategy] = ops.counts
    assert counts["scan"] == counts["scatter"]
    scatters = {k: v for k, v in counts["scatter"].items() if k in SCATTER_OPS}
    assert scatters == {"index_add_": chunks}
    assert not {"cumsum", "cumsum_"} & set(counts["scatter"])
