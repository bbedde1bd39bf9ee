"""A topology mutation through the port (``CSRTopo._publish_mutation``),
the serving path's version drill, and the port's ``EmbeddingRefresher``
(quiver_tpu_torch/serving/refresh.py), against the JAX package.

JAX's ``StreamingGraph`` commits an edge insert on the JAX topology; the
merged arrays its commit publishes are recorded and published through the
port's seam, so both topologies hold the same mutation.

Tolerance: bitwise for the published CSR arrays, the version and the
port's serving answers against its oracle; the refreshers' tables within
atol = rtol = 1e-5 (``tests/test_torch_inference.py``'s tolerance for
layer-wise log-probs: float32, different summation orders).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402

N, E, F, SIZES, SEED = 60, 400, 6, (3, 2), 4


class FakeClock:
    def __call__(self):
        return 0.0


def _topos(kind, rng):
    coo = rng.integers(0, N, size=(2, E))
    kw = {}
    if kind == "weighted":
        kw["edge_weight"] = rng.random(E).astype(np.float32)
    if kind == "timed":
        kw["edge_time"] = rng.random(E).astype(np.float32)
    return qj.CSRTopo(edge_index=coo, **kw), qt.CSRTopo(edge_index=coo, **kw)


def _commit_both(tj, tt, rng, kind):
    """Commit one new edge on the JAX topology through StreamingGraph and
    publish the same merged arrays through the port's seam."""
    n = tj.node_count
    src = np.repeat(np.arange(n), tj.degree)
    live = set((src * n + np.asarray(tj.indices)).tolist())
    k = next(k for k in range(n * n) if k not in live)
    batch = {"edge_inserts": np.array([[k // n], [k % n]])}
    if kind == "weighted":
        batch["edge_weights"] = np.array([0.5], np.float32)
    if kind == "timed":
        batch["edge_times"] = np.array([0.25], np.float32)
    published = []
    inner = tj._publish_mutation

    def record(*args, **kw):
        published.append((args, kw))
        return inner(*args, **kw)

    tj._publish_mutation = record
    sg = qj.StreamingGraph(tj)
    assert sg.ingest(qj.DeltaBatch(**batch))
    sg.commit()
    (args, kw), = published
    tt._publish_mutation(*args, **kw)


@pytest.mark.parametrize("kind", ["plain", "weighted", "timed"])
def test_publish_mutation_equals_jax(kind):
    """The port's seam publishes what JAX's does: the same indptr and
    indices (dtypes narrowed alike), weights and prefix sums, times
    re-sorted per row, eid dropped, the version bumped; a mismatched
    publish raises in both."""
    rng = np.random.default_rng(7)
    tj, tt = _topos(kind, rng)
    _commit_both(tj, tt, rng, kind)
    assert tt.version == tj.version == 1 and tt.eid is None and tj.eid is None
    for name in ("indptr", "indices", "edge_weight", "cum_weights", "edge_time"):
        a, b = getattr(tt, name), getattr(tj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert tt.edge_count == E + 1 and tt.max_degree == tj.max_degree
    with pytest.raises(ValueError, match="weights"):
        tt._publish_mutation(tt.indptr, tt.indices,
                             edge_weight=None if kind == "weighted" else np.ones(E + 1),
                             edge_time=tt.edge_time)


def _stack(rng):
    tj, tt = _topos("plain", rng)
    x = rng.normal(size=(N, F)).astype(np.float32)
    mj = SageJ(hidden=8, num_classes=3, num_layers=2)
    adjs = empty_adjs(list(SIZES), batch=2, node_count=N)
    params = init_model(mj, jax.random.PRNGKey(SEED),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, 8, 3)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return tj, tt, x, mj, params, mt


def test_version_drill_refresh_rebuilds_then_loads(tmp_path):
    """After the commit both packages' servers and refreshers raise; the
    port's first replica's refresh captures again (its recompiles double)
    and the second's takes those programs (its aot_loads grow by the same
    count, recompiles stay 0), answering bitwise as each other and the
    oracle; the refreshers' tables match JAX's before and after."""
    rng = np.random.default_rng(SEED)
    tj, tt, x, mj, params, mt = _stack(rng)
    sj = qj.InferenceServer(qj.GraphSageSampler(tj, list(SIZES), seed=SEED), mj, params,
                            qj.Feature(device_cache_size="1G").from_cpu_tensor(x),
                            max_batch=1, clock=FakeClock(), seed=5)
    smp = qt.GraphSageSampler(tt, list(SIZES), device="cpu", seed=SEED)
    ft = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x)
    cd = str(tmp_path / "aot")
    f = qt.InferenceServer(smp, mt, ft, device="cpu", max_batch=1, clock=FakeClock(),
                           seed=5, aot_cache=cd)
    first = f.warm_from_cache()
    assert first == {"loaded": 0, "compiled": 2}
    g = qt.InferenceServer(smp, mt, ft, device="cpu", max_batch=1, clock=FakeClock(),
                           seed=5, aot_cache=cd)
    assert g.warm_from_cache() == {"loaded": first["compiled"], "compiled": 0}
    rj = qj.EmbeddingRefresher(mj, params, tj, x)
    rt = qt.EmbeddingRefresher(mt, tt, x, device="cpu")
    assert rj.refresh() == rt.refresh() == 0
    np.testing.assert_allclose(rt.table.numpy(), rj._table, atol=1e-5, rtol=1e-5)

    _commit_both(tj, tt, rng, "plain")
    for stale in (lambda: g.pump(force=True), f.check_version, lambda: g.oracle(7, 0),
                  lambda: sj.pump(force=True), lambda: rt.lookup([1]),
                  lambda: rj.lookup([1]), lambda: smp.sample(np.arange(3))):
        with pytest.raises((qt.VersionMismatchError, qj.VersionMismatchError)):
            stale()
    f.refresh()
    assert f.recompiles == 2 * first["compiled"]
    loads_before = g.aot_loads
    g.refresh()
    assert g.recompiles == 0
    assert g.aot_loads == loads_before + first["compiled"]
    rf, rg = f.serve([7])[0], g.serve([7])[0]
    assert (rf.node, rf.seq) == (rg.node, rg.seq)
    np.testing.assert_array_equal(rf.result, rg.result)
    np.testing.assert_array_equal(rg.result, g.oracle(rg.node, rg.seq))
    assert rj.refresh() == rt.refresh() == 1
    np.testing.assert_allclose(rt.table.numpy(), rj._table, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rt.lookup([3, 59, 3]).numpy(), rj.lookup([3, 59, 3]),
                               atol=1e-5, rtol=1e-5)


def test_refresher_background_lane_publishes_and_joins():
    """``start()`` publishes the first table from the background thread,
    recomputes after a commit, and ``stop()`` joins it; the context manager
    stops it too; a second ``start()`` while running raises."""
    rng = np.random.default_rng(1)
    _tj, tt, x, _mj, _params, mt = _stack(rng)
    calls = []
    done = threading.Event()

    def infer(model, topo, feats, **kw):
        out = qt.models.inference.sage_layerwise_inference(model, topo, feats, **kw)
        calls.append(int(topo.version))
        done.set()
        return out

    with qt.EmbeddingRefresher(mt, tt, lambda: x, infer_fn=infer, device="cpu") as r:
        with pytest.raises(qt.VersionMismatchError, match="no embedding table"):
            r.lookup([0])
        t = r.start(interval_s=0.01)
        with pytest.raises(RuntimeError, match="already running"):
            r.start()
        assert done.wait(30) and r.version == 0
        foreground = qt.models.inference.sage_layerwise_inference(mt, tt, x, device="cpu")
        # the stated tolerance: on the CPU a thread's GEMMs may block (and
        # round) differently from the main thread's
        np.testing.assert_allclose(r.lookup(np.arange(N)).numpy(), foreground.numpy(),
                                   atol=1e-5, rtol=1e-5)
        done.clear()
        indptr = tt.indptr.astype(np.int64)
        tt._publish_mutation(indptr, tt.indices.copy())  # a version bump
        assert done.wait(30)
        for _ in range(3000):
            if r.version == 1:
                break
            threading.Event().wait(0.01)
        assert r.version == 1 and calls[-1] == 1 and r.refreshes >= 2
    t.join(timeout=30)
    assert not t.is_alive() and r._thread is None
    r.stop()  # idempotent
