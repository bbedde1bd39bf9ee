"""The sharded store's int8 tiers, split tuner, ``repin``, row updates and
degree feed in quiver_tpu_torch (``feature/shard.py``) against quiver_tpu's,
on the CPU.

JAX places the tiers on its 8 forced host devices; the port places the
same tiers as tensors on a mesh whose device repeats
(``make_mesh(devices=["cpu"] * 8)``). The counterparts of
``tests/test_threetier.py`` (int8 across tiers, the budget below the
scales, the auto split), ``tests/test_controller.py`` (repin against the
dense oracle, the degree prior) and ``tests/test_streaming.py`` (row
updates in every tier, requantisation, rejection, the degree feed).

Tolerance: bitwise everywhere. The rows against JAX's and against a numpy
oracle (the dense rows for float32; for int8 the codes times the scales
of numpy's own quantisation of the translated rows), the scales, the
feature orders, splits, versions, hit counts, overflow counts, the
controller's heavy hitters and the error messages. The int8 rows also
stay within half a quantisation step of the raw rows.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.feature.feature import quantize_rows_int8  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402

from test_torch_shard import ROW_B, _both, _graph, _meshes, _oracle  # noqa: E402

MESHES = [(2, 4), (1, 8)]
ROUTES = ({}, {"routed": True}, {"routed": True, "routed_cap": None},
          {"routed": True, "routed_cap": 1})


def _pair(mesh_shape, feat, ei=None, **kw):
    """The same store on both packages (``ei``: with a degree order)."""
    mesh_j, mesh_t = _meshes(*mesh_shape)
    topo = (None, None) if ei is None else (qj.CSRTopo(edge_index=ei),
                                            qt.CSRTopo(edge_index=ei))
    store_j = ShardedFeatureJ(mesh_j, csr_topo=topo[0], **kw).from_cpu_tensor(feat)
    store = qt.ShardedFeature(mesh_t, csr_topo=topo[1], **kw).from_cpu_tensor(feat)
    assert (store.rep_rows, store.hot_rows) == (store_j.rep_rows, store_j.hot_rows)
    return store_j, store


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])


def _dequant_oracle(feat, order, ids):
    """numpy's int8 rows of ``ids``: quantise the translated rows, then
    codes times scales; zero rows on ``-1`` lanes."""
    n = feat.shape[0]
    t = np.arange(n) if order is None else np.asarray(order).astype(np.int64)
    translated = np.empty_like(feat)
    translated[t] = feat
    q, scale = quantize_rows_int8(translated)
    rows = q.astype(np.float32) * scale[:, None]
    out = rows[t[np.where(ids >= 0, ids, 0)]]
    out[ids < 0] = 0
    return out


def _state(store):
    """Everything a rejected update must leave as it was: the rows of every
    id, the scales, the order, the host region, the version and the split."""
    n = store.shape[0]
    rows = store.gather(torch.arange(-1, n, dtype=torch.int32)).clone()
    return (rows, None if store.scale is None else store.scale.clone(),
            None if store.feature_order is None else store.feature_order.clone(),
            None if store._region_host is None else store._region_host.clone(),
            store.version, store.rep_rows, store.hot_rows)


def _same_state(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# -- int8 tiers --------------------------------------------------------------------


N8, F8 = 300, 16  # test_threetier.py's int8 store: rows of 16 B, scales 1,200 B


@pytest.mark.parametrize("data,feature", MESHES)
@pytest.mark.parametrize("budget,rep_rows", [
    ("1M", 0), ("1M", 24), ("1M", 300),  # test_int8_dequantizes_identically_across_tiers
    (4 * N8 + 10 * F8, 16),  # all three tiers, a pinned cold tier
    (4 * N8 - 200, 25),  # the scales eat 200 B of the replicate budget
    (0, 0)])  # cold only
def test_int8_lookups_equal_jax_across_tiers(data, feature, budget, rep_rows):
    """int8 storage in every tier layout: the split, the order and the
    scales JAX's; psum, routed, uncapped and capped-at-1 rows bitwise
    JAX's and the numpy dequant oracle, the hits and overflow JAX's."""
    ei = _edges(N8, 2000, 8)
    feat = np.random.default_rng(8).normal(size=(N8, F8)).astype(np.float32)
    store_j, store = _pair((data, feature), feat, ei, device_cache_size=budget,
                           replicate_budget=rep_rows * F8, dtype="int8")
    assert store.dtype == torch.int8 and store.scale.dtype == torch.float32
    assert np.array_equal(store.scale.numpy(), np.asarray(store_j.scale))
    if store_j.feature_order is None:
        assert store.feature_order is None
    else:
        assert np.array_equal(store.feature_order.numpy(), np.asarray(store_j.feature_order))
    rng = np.random.default_rng(9)
    ids = rng.integers(0, N8, 96).astype(np.int32)
    ids[rng.choice(96, 4, replace=False)] = -1
    want = _dequant_oracle(feat, store_j.feature_order, ids)
    for kw in ROUTES:
        got = _both(store_j, store, ids, **kw)
        assert got.dtype == np.float32 and np.array_equal(got, want), kw
        assert store.last_tier_hits.tolist() == np.asarray(store_j.last_tier_hits).tolist()
        if kw and store.hot is not None:
            assert int(store.last_routed_overflow) == int(store_j.last_routed_overflow), kw
    bound = np.abs(feat).max(axis=1)[np.where(ids >= 0, ids, 0)][:, None] / 127.0 + 1e-7
    assert np.all(np.abs(got - _oracle(feat, ids)) <= bound)


def test_int8_budget_below_scale_degrades_to_cold_only():
    """A combined budget below the ``(N,)`` scales' bytes: a cold-only
    store (no reorder), JAX's one-time info log, rows bitwise JAX's."""
    ei = _edges(N8, 2000, 11)
    feat = np.random.default_rng(11).normal(size=(N8, F8)).astype(np.float32)
    trace.reset_once()
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = trace.get_logger()
    handler, level = Capture(logging.INFO), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        store_j, store = _pair((2, 4), feat, ei, device_cache_size=4 * N8 - 1, dtype="int8")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert store.rep_rows == store.hot_rows == 0 and store.hot is None and store.rep is None
    assert store.cold is not None and store.feature_order is None
    assert sum("cold-only" in m for m in records) == 1, records
    ids = np.random.default_rng(12).integers(-1, N8, 48).astype(np.int32)
    for kw in ROUTES[:2]:
        assert np.array_equal(_both(store_j, store, ids, **kw), _dequant_oracle(feat, None, ids))


def test_int8_group_lookup_is_the_standalone_gather():
    """``ShardedFeature.lookup`` over int8 tiers (the trainer's per-group
    lookup): psum and routed (uncapped and capped at 2) give the
    standalone gather's float32 rows bitwise."""
    ei = _edges(N8, 2000, 3)
    feat = np.random.default_rng(3).normal(size=(N8, F8)).astype(np.float32)
    _, store = _pair((2, 4), feat, ei, device_cache_size=4 * N8 + 10 * F8,
                     replicate_budget=16 * F8, dtype="int8")
    ids = torch.from_numpy(np.random.default_rng(4).integers(-1, N8, (4, 50)).astype(np.int32))
    want = store.gather(ids.reshape(-1))
    rows, hits, _ = store.lookup(ids.reshape(-1))
    assert torch.equal(rows, want) and torch.equal(hits, store.last_tier_hits)
    for cap in (None, 2):
        rows, hits, ov = store.lookup(ids, routed=True, cap=cap)
        assert torch.equal(rows.reshape(200, F8), want)
        assert (cap is None) == (int(ov) == 0)


# -- the split tuner -----------------------------------------------------------------


def test_auto_split_shrinks_and_regrows_as_jax():
    """``test_auto_split_shrinks_unearned_l0_and_regrows`` on both
    packages: traffic that never reads L0 halves the boundary to 0, a
    manual resplit to 8 and L0-heavy traffic double it back to the budget
    ceiling; the boundary after every gather is JAX's and every gather's
    rows are bitwise JAX's and the dense rows."""
    n, f = 512, 8
    feat = np.random.default_rng(6).normal(size=(n, f)).astype(np.float32)
    store_j, store = _pair((2, 4), feat, device_cache_size=(n // 4) * ROW_B,
                           replicate_budget=64 * ROW_B, auto_split=True)
    assert store.rep_rows == 64 and store._rep_ceiling_rows == 64
    rng = np.random.default_rng(7)
    cold_ids = rng.integers(64, n, 128).astype(np.int32)
    seen = []
    for _ in range(10):
        assert np.array_equal(_both(store_j, store, cold_ids), feat[cold_ids])
        assert store.rep_rows == store_j.rep_rows
        seen.append(store.rep_rows)
    assert store.rep_rows == 0 and seen[:3] == [64, 32, 16]
    assert store._controller is not None  # the default controller, made lazily
    for s in (store_j, store):
        s.resplit(8)
    hot_ids = np.concatenate([rng.integers(0, 8, 32), rng.integers(64, n, 96)]).astype(np.int32)
    for _ in range(6):
        assert np.array_equal(_both(store_j, store, hot_ids), feat[hot_ids])
        assert store.rep_rows == store_j.rep_rows
    assert store.rep_rows == 64
    ids = rng.integers(0, n, 96).astype(np.int32)
    assert np.array_equal(_both(store_j, store, ids, routed=True), feat[ids])


def test_resplit_resets_the_tuner_and_budget_raises_the_ceiling():
    """A manual ``resplit`` voids the attached controller's direction
    history (a tuner move keeps it); ``resplit_budget`` raises the L0
    ceiling the tuner honours, as JAX's does."""
    n, f = 256, 8
    feat = np.random.default_rng(1).normal(size=(n, f)).astype(np.float32)
    store_j, store = _pair((2, 4), feat, device_cache_size=(n // 4) * ROW_B,
                           replicate_budget=16 * ROW_B, auto_split=True)
    ids = np.arange(100, 164).astype(np.int32)
    for _ in range(2):  # the second gather reads the first's hits: a shrink
        _both(store_j, store, ids)
    assert store.rep_rows == store_j.rep_rows == 8
    assert store._controller.split_tuner._last_dir == -1 == \
        store_j._controller.split_tuner._last_dir
    for s in (store_j, store):
        s.resplit(4)
        s.resplit_budget(40 * ROW_B)
    assert store._controller.split_tuner._last_dir == 0
    assert store._rep_ceiling_rows == store_j._rep_ceiling_rows == 40
    assert store.rep_rows == store_j.rep_rows == 40


def test_degree_update_feeds_split_tuner_as_jax():
    """``test_degree_update_feeds_split_tuner``: post-mutation degrees that
    put every hit past L0 halve the boundary once (one move per call),
    JAX's move; on a store without ``auto_split`` the call changes
    nothing."""
    n, f = 256, 8
    ei = _edges(n, 3000, 11)
    feat = np.random.default_rng(11).normal(size=(n, f)).astype(np.float32)
    kw = dict(device_cache_size=16 * f * 4, replicate_budget=8 * f * 4)
    store_j, store = _pair((1, 8), feat, ei, auto_split=True, **kw)
    rep0 = store.rep_rows
    assert rep0 > 0
    order = store.feature_order.numpy()
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    deg = np.zeros(n, np.int64)
    deg[inv[rep0: rep0 + store.hot_rows]] = 100
    for s in (store_j, store):
        s.note_degree_update(deg)
    assert store.rep_rows == store_j.rep_rows == rep0 // 2
    assert store.last_tier_hits is None and store.version == 0
    plain_j, plain = _pair((1, 8), feat, ei, **kw)
    for s in (plain_j, plain):
        s.note_degree_update(deg)
    assert plain.rep_rows == plain_j.rep_rows == rep0
    with pytest.raises(ValueError, match="degree must have") as err:
        store.note_degree_update(deg[:-1])
    with pytest.raises(ValueError, match="degree must have") as err_j:
        store_j.note_degree_update(deg[:-1])
    assert str(err.value) == str(err_j.value)


def test_degree_prior_feeds_controller_as_jax():
    """``test_streaming_degree_prior_feeds_controller``: an attached
    controller takes the new degrees as a prior; its heavy hitters are
    JAX's."""
    n, f = 200, 8
    ei = _edges(n, 1200, 3)
    feat = np.random.default_rng(3).normal(size=(n, f)).astype(np.float32)
    store_j, store = _pair((2, 4), feat, ei, device_cache_size="1M",
                           replicate_budget=8 * ROW_B)
    ctl_j, ctl = qj.CacheController().attach(store_j), qt.CacheController().attach(store)
    assert store._controller is ctl and not ctl.sketch.state()["hitters"]
    degree = np.arange(n, dtype=np.int64)
    store_j.note_degree_update(degree)
    store.note_degree_update(degree)
    assert ctl.sketch.state()["hitters"] == ctl_j.sketch.state()["hitters"]
    assert max(ctl.sketch.state()["hitters"]) == n - 1


# -- repin ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_repin_equals_jax_and_dense_oracle(dtype):
    """``test_repin_matches_dense_oracle_f32`` / ``_int8``: an arbitrary
    hot set (duplicates keep their first occurrence) pinned to the front:
    tier sizes kept, ``version`` bumped once, the composed order and the
    moved scales JAX's, every flavour's rows bitwise JAX's and the rows
    before the repin; out-of-range ids raise JAX's message."""
    topo_j, topo_t = _graph(n=300, e=2000, seed=8)
    n = topo_j.node_count
    f = 8 if dtype is None else 16
    feat = np.random.default_rng(1).normal(size=(n, f)).astype(np.float32)
    kw = (dict(device_cache_size=(n // 4 // 4) * f * 4, replicate_budget=16 * f * 4)
          if dtype is None else
          dict(device_cache_size=4 * n + 10 * f, replicate_budget=16 * f, dtype="int8"))
    mesh_j, mesh_t = _meshes(2, 4)
    store_j = ShardedFeatureJ(mesh_j, csr_topo=topo_j, **kw).from_cpu_tensor(feat)
    store = qt.ShardedFeature(mesh_t, csr_topo=topo_t, **kw).from_cpu_tensor(feat)
    assert store.rep_rows == 16 and store.cold is not None
    rng = np.random.default_rng(2)
    ids = rng.integers(0, n, 96).astype(np.int32)
    ids[:4] = -1
    before = _both(store_j, store, ids)
    hot = rng.choice(n, 40, replace=False)
    rows = np.concatenate([hot, hot[:5]])
    sizes = (store.rep_rows, store.hot_rows)
    for s in (store_j, store):
        s.repin(rows)
    assert store.version == store_j.version == 1
    assert (store.rep_rows, store.hot_rows) == sizes
    assert np.array_equal(store.feature_order.numpy(), np.asarray(store_j.feature_order))
    assert np.array_equal(topo_t.feature_order, np.asarray(topo_j.feature_order))
    np.testing.assert_array_equal(store.feature_order.numpy()[hot], np.arange(hot.size))
    if dtype is not None:
        assert np.array_equal(store.scale.numpy(), np.asarray(store_j.scale))
    assert store.last_tier_hits is None
    for kw_g in ROUTES:
        assert np.array_equal(_both(store_j, store, ids, **kw_g), before), kw_g
    if dtype is None:
        assert np.array_equal(before, _oracle(feat, ids))
    msgs = []
    for s in (store_j, store):
        with pytest.raises(ValueError, match="repin ids") as err:
            s.repin([n])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and store.version == 1


def test_repin_of_a_cold_only_store_is_a_no_op():
    feat = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    store_j, store = _pair((2, 4), feat)
    for s in (store_j, store):
        s.repin([3, 1])
    assert store.version == store_j.version == 0


# -- row updates ----------------------------------------------------------------------


def _update_store(dtype, mesh=(1, 8), auto_split=False, seed=6):
    n, f = 256, 16 if dtype is None else 8
    ei = _edges(n, 3000, seed)
    feat = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    kw = (dict(device_cache_size=16 * f * 4, replicate_budget=8 * f * 4)
          if dtype is None else
          dict(device_cache_size=4 * n + 16 * f, replicate_budget=8 * f, dtype="int8"))
    return feat, _pair(mesh, feat, ei, auto_split=auto_split, **kw)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_row_updates_in_every_tier_equal_jax(dtype):
    """``test_row_updates_serve_fresh_in_every_tier`` and
    ``test_row_updates_quantized_store_requantizes``: one transaction
    touching an L0 row, the first L1 row and the first cold row: ``version``
    bumped once, every flavour's rows of every id bitwise JAX's (the new
    rows, float32, or their requantised values, int8), every device's L0
    copy holds the new row, the patched scales JAX's, the other rows
    unchanged."""
    feat, (store_j, store) = _update_store(dtype)
    n = feat.shape[0]
    assert store.rep_rows > 0 and store.hot_rows > 0 and store.cold is not None
    inv = np.empty(n, np.int64)
    inv[store.feature_order.numpy()] = np.arange(n)
    end = store.rep_rows + store.hot_rows
    ids = np.array([inv[0], inv[store.rep_rows], inv[end], inv[end - 1]])
    rows = np.random.default_rng(1).normal(size=(4, feat.shape[1])).astype(np.float32) + 50.0
    for s in (store_j, store):
        s.apply_row_updates(ids, rows)
    assert store.version == store_j.version == 1
    all_ids = np.arange(-1, n).astype(np.int32)
    for kw in ROUTES:
        got = _both(store_j, store, all_ids, **kw)
    if dtype is None:
        assert np.array_equal(got[ids + 1], rows)
        for rep in store.reps.values():
            assert np.array_equal(rep[0].numpy(), rows[0])
    else:
        assert np.allclose(got[ids + 1], rows, atol=np.abs(rows).max() / 127 + 1e-6)
        assert np.array_equal(store.scale.numpy(), np.asarray(store_j.scale))
        codes, _ = quantize_rows_int8(rows)
        for rep in store.reps.values():
            assert np.array_equal(rep[0].numpy(), codes[0])
    others = np.setdiff1d(np.arange(n), ids)
    if dtype is None:
        assert np.array_equal(got[others + 1], feat[others])


@pytest.mark.parametrize("dtype", [None, "int8"])
@pytest.mark.parametrize("case", ["non-finite", "range", "duplicate", "feature dim"])
def test_row_update_rejection_leaves_store_bitwise(dtype, case):
    """``test_row_update_rejects_bad_input_bit_identically``: JAX's checks
    with JAX's messages, and a rejected transaction leaves every row, the
    scales, the order, the host region, the version and the split as
    they were."""
    feat, (store_j, store) = _update_store(dtype, mesh=(2, 4), seed=10)
    f, n = feat.shape[1], feat.shape[0]
    bad = np.ones((1, f), np.float32)
    bad[0, 0] = np.nan
    ids, rows, match = {
        "non-finite": (np.array([1]), bad, "non-finite"),
        "range": (np.array([n + 10]), np.ones((1, f), np.float32), r"in \[0, 256\)"),
        "duplicate": (np.array([1, 1]), np.ones((2, f), np.float32), "duplicate"),
        "feature dim": (np.array([1]), np.ones((1, f - 3), np.float32), "feature dim"),
    }[case]
    before = _state(store)
    msgs = []
    for s in (store_j, store):
        with pytest.raises(ValueError, match=match) as err:
            s.apply_row_updates(ids, rows)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    _same_state(_state(store), before)
    assert store.version == store_j.version == 0
