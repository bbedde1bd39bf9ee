"""The port's cache controller (quiver_tpu_torch/control/) against the JAX
package's (quiver_tpu/control/) on the same inputs: the sketch's state,
the heat histogram, the cost model's predictions, the tuners' and the
controller's decisions and audit records, and the server's serve feed
under the JAX server's draws.

Tolerance: exact (integer counts, float64 host arithmetic done op for op
alike); the cost model's predicted seconds within 1e-12 relative (the
same float64 formulas over the same stage means).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu import control as cj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.obs.timeline import StepTimeline as TimelineJ  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402
from test_torch_serve import jax_draw_fn  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch import control as ct  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.obs.export import read_jsonl  # noqa: E402
from quiver_tpu_torch.obs.timeline import StepTimeline as TimelineT  # noqa: E402


def _streams(seed=0, n=500):
    rng = np.random.default_rng(seed)
    zipf = np.minimum(rng.zipf(1.3, size=4000), n) - 1
    return [np.where(rng.random(s.shape) < 0.1, -1, s).astype(np.int32)
            for s in np.array_split(zipf, 7)]


@pytest.mark.parametrize("top_k,bins", [(1024, 256), (16, 64), (3, 1000), (1, 8), (7, 32)])
def test_sketch_state_equals_jax(top_k, bins):
    """Ids, histograms, priors and decays fold into the same state (heavy
    hitters exact, SpaceSaving evictions included), and the readers agree."""
    a, b = ct.FreqSketch(500, bins, top_k=top_k), cj.FreqSketch(500, bins, top_k=top_k)
    rng = np.random.default_rng(1)
    for i, ids in enumerate(_streams()):
        a.observe_ids(torch.from_numpy(ids))
        b.observe_ids(ids)
        hist = rng.integers(0, 9, a.num_bins)
        a.observe_histogram(torch.from_numpy(hist))
        b.observe_histogram(hist)
        if i % 3 == 2:
            a.decay()
            b.decay()
    prior = rng.random(500)
    a.observe_prior(prior)
    b.observe_prior(prior)
    assert a.state() == b.state()
    np.testing.assert_array_equal(a.heat, b.heat)
    np.testing.assert_array_equal(a.top_rows(20), b.top_rows(20))
    for row in (0, 1, 7, 250, 499, 500, 10_000):
        assert a.bin_mass_below(row) == b.bin_mass_below(row)
    stack = rng.integers(0, 5, (3, a.num_bins))
    a.observe_histogram(stack)
    b.observe_histogram(stack)
    assert a.state() == b.state()
    assert len(a._heap) <= 4 * top_k + 64  # stale eviction entries are dropped
    with pytest.raises(ValueError, match="histogram shape"):
        a.observe_histogram(np.zeros(a.num_bins + 1))


@pytest.mark.parametrize("order", [False, True])
@pytest.mark.parametrize("rows,bins", [(500, 256), (10, 256), (1000, 7)])
def test_row_heat_histogram_equals_jax(order, rows, bins):
    rng = np.random.default_rng(rows)
    n_id = rng.integers(-1, rows, (3, 41)).astype(np.int32)
    fo = rng.permutation(rows).astype(np.int32) if order else None
    nb = ct.heat_num_bins(rows, bins)
    assert nb == cj.heat_num_bins(rows, bins)
    got = ct.row_heat_histogram(torch.from_numpy(n_id),
                                None if fo is None else torch.from_numpy(fo), rows, nb)
    want = cj.row_heat_histogram(jnp.asarray(n_id), None if fo is None else jnp.asarray(fo),
                                 rows, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int((n_id >= 0).sum())


def test_cost_model_predictions_equal_jax():
    sk_t, sk_j = ct.FreqSketch(1000, 100), cj.FreqSketch(1000, 100)
    hist = np.random.default_rng(2).integers(0, 50, 100)
    sk_t.observe_histogram(hist)
    sk_j.observe_histogram(hist)
    tl_t, tl_j = TimelineT(), TimelineJ()
    for s in (0.010, 0.012, 0.011, 0.013):
        tl_t.observe("step", s)
        tl_j.observe("step", s)
    m_t, m_j = ct.CostModel(4096, 4), cj.CostModel(4096, 4)
    assert m_t.calibrate(tl_t, alpha=2.0, h0=0.25) == m_j.calibrate(tl_j, alpha=2.0, h0=0.25)
    for rep, hot, alpha in ((0, 100, None), (50, 300, 2.0), (250, 0, 0.5), (999, 1, 8.0)):
        p_t, p_j = m_t.predict(sk_t, rep, hot, alpha), m_j.predict(sk_j, rep, hot, alpha)
        assert set(p_t) == set(p_j)
        for k in p_t:
            if k == "est_step_s":
                assert p_t[k] == pytest.approx(p_j[k], rel=1e-12)
            else:
                assert p_t[k] == p_j[k], k
    assert ct.routed_lanes_per_hop(1000, 8, 2.0, 0.3) == cj.routed_lanes_per_hop(1000, 8, 2.0, 0.3)
    assert ct.predicted_hit_rates(sk_t, 10, 20) == cj.predicted_hit_rates(sk_j, 10, 20)
    assert m_t.predict_disk(sk_t, 300) == m_j.predict_disk(sk_j, 300)
    assert m_t.calibrate_hbm({"a": 5}) == m_j.calibrate_hbm({"a": 5})
    assert m_t.predict_hbm("a", 4) == m_j.predict_hbm("a", 4)


def test_tuners_decide_as_jax():
    """The same overflow and hit sequences give the same alpha and split
    decisions, floors and dead-bands included."""
    at_t, at_j = ct.AlphaTuner(shrink_after=2), cj.AlphaTuner(shrink_after=2)
    a_t = a_j = 2.0
    for ovf in [0, 0, 3, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 1, 0, 0]:
        d_t, d_j = at_t.decide(ovf, a_t, 8.0), at_j.decide(ovf, a_j, 8.0)
        assert d_t == d_j and at_t.floor == at_j.floor
        a_t = d_t if d_t is not None else a_t
        a_j = d_j if d_j is not None else a_j
    st_t, st_j = ct.SplitTuner(), cj.SplitTuner()
    rep = 64
    for h0, h1 in [(1, 100), (100, 1), (1, 100), (1, 100), (50, 60), (100, 1), (100, 1), (0, 0)]:
        d_t, d_j = st_t.decide(h0, h1, rep, 256), st_j.decide(h0, h1, rep, 256)
        assert d_t == d_j
        rep = d_t if d_t is not None else rep


class _Store:
    """A store with an L0 tier to re-tier (``rep_rows``, ``repin``)."""

    def __init__(self, rows, rep_rows, order):
        self.shape = (rows, 4)
        self.rep_rows = rep_rows
        self.feature_order = order
        self.pinned = None

    def repin(self, rows):
        self.pinned = np.asarray(rows)


class _OocStore:
    """An out-of-core store (``host_cache_rows``, ``restage``)."""

    def __init__(self, order):
        self.host_cache_rows, self.hot_rows = 8, 40
        self.feature_order = order
        self.staged_ids = np.zeros(0, np.int64)

    def restage(self, local):
        self.staged_ids = np.asarray(local)
        return int(self.staged_ids.size)


def test_controller_decisions_and_audit_equal_jax(tmp_path):
    """Alpha, split, repin and promote decisions, the audit records (the
    JSONL lines read back as ``ctrl.*`` snapshots) and the counters equal
    the JAX controller's; frozen controllers decide nothing."""
    order = np.random.default_rng(3).permutation(500).astype(np.int64)
    logs = {}
    outs = {}
    for name, pkg in (("t", ct), ("j", cj)):
        logs[name] = str(tmp_path / f"{name}.jsonl")
        ctl = pkg.CacheController(pkg.FreqSketch(500, 50, top_k=64),
                                  pkg.CostModel(1024, 4), decision_log=logs[name])
        for ids in _streams(4):
            ctl.observe_serve(ids)
        store = _Store(500, 16, order)
        ooc = _OocStore(order)
        got = [ctl.decide_alpha(3, 2.0, 8.0), ctl.decide_alpha(0, 4.0, 8.0),
               ctl.decide_split(1, 100, 16, 128), ctl.maybe_repin(store),
               ctl.maybe_promote(ooc)]
        ctl.end_epoch(store)
        frozen = pkg.CacheController(frozen=True)
        got += [frozen.decide_alpha(9, 1.0, 8.0), frozen.maybe_repin(store)]
        outs[name] = (got, store.pinned, ooc.staged_ids, ctl.decisions, ctl.stats(),
                      ctl.sketch.state())
    for a, b in zip(outs["t"], outs["j"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    # the epoch's repin repeats: the fake store's order does not move
    assert outs["t"][4]["repins"] == 2 and outs["t"][4]["decisions"] == 5
    with open(logs["t"]) as f, open(logs["j"]) as g:
        lt, lj = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert lt == lj
    assert [s.name for s in read_jsonl(logs["t"])] == [
        "ctrl.alpha_changes", "ctrl.split_moves", "ctrl.repins", "ctrl.ooc_promotions",
        "ctrl.repins"]


def test_server_serve_feed_equals_jax_server():
    """A controller attached to the port's server observes the same ids as
    one attached to the JAX server over the same stream (JAX's draws):
    the same sketch state, every valid served id counted."""
    n, F, sizes, seed = 300, 6, (3, 2), 5
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, size=(2, 2000))
    x = rng.normal(size=(n, F)).astype(np.float32)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    mj = SageJ(hidden=8, num_classes=3, num_layers=2)
    adjs = empty_adjs(list(sizes), batch=2, node_count=n)
    params = init_model(mj, jax.random.PRNGKey(seed),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, 8, 3)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    ctl_j = cj.CacheController(cj.FreqSketch(n, 32, top_k=50))
    ctl_t = ct.CacheController(ct.FreqSketch(n, 32, top_k=50))
    sj = qj.InferenceServer(qj.GraphSageSampler(tj, list(sizes), seed=seed), mj, params,
                            qj.Feature(device_cache_size="1G").from_cpu_tensor(x),
                            max_batch=4, seed=seed, controller=ctl_j)
    st = qt.InferenceServer(qt.GraphSageSampler(tt, list(sizes), device="cpu", seed=seed),
                            mt, qt.Feature(device_cache_size="1G", device="cpu")
                            .from_cpu_tensor(x), device="cpu", max_batch=4, seed=seed,
                            controller=ctl_t, draw_fn=jax_draw_fn(seed, sizes))
    nodes = rng.integers(0, n, 11)
    rj, rt = sj.serve(nodes), st.serve(nodes)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.result, b.result, atol=1e-5, rtol=1e-5)
    assert ctl_t.sketch.state() == ctl_j.sketch.state()
    served = np.concatenate([st.ladder.oracle_sample(r.node, r.seq)[0].numpy() for r in rt])
    assert ctl_t.sketch.observed == int((served >= 0).sum())
    assert ctl_t.sketch.state()["observed"] > 0
