"""``ShardedTensor`` and ``ShardedFeature`` of quiver_tpu_torch
(``feature/shard.py``), the three-tier merge (``three_tier_lookup``) and
the ``mesh_shard`` cache policy, against quiver_tpu's, on the CPU.

JAX places the tables on its 8 forced host devices and gathers inside
``shard_map``; the port places the same shards as tensors on a mesh whose
device repeats (``make_mesh(devices=["cpu"] * 8)``). Meshes ``(data=4,
feature=2)`` and ``(1, 8)``. The counterparts of ``tests/test_shard.py``,
``tests/test_routed_cap.py`` and ``tests/test_threetier.py``; the int8
cases, the split tuner, ``repin`` and row updates are in
``tests/test_torch_shard_control.py``.

Tolerance: bitwise everywhere (rows are moved, never computed: the psum
flavour's sum adds one row to zeros), against JAX's rows and the dense
numpy rows; tier hits, overflow counts, splits and error types equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.core.config import CachePolicy as CachePolicyJ  # noqa: E402
from quiver_tpu.feature.feature import Feature as FeatureJ  # noqa: E402
from quiver_tpu.feature.feature import tiered_lookup as tiered_lookup_j  # noqa: E402
from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ  # noqa: E402
from quiver_tpu.feature.shard import ShardedTensor as ShardedTensorJ  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.utils.reorder import reorder_by_degree as reorder_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.core.config import CachePolicy  # noqa: E402
from quiver_tpu_torch.feature.feature import three_tier_lookup  # noqa: E402
from quiver_tpu_torch.utils.reorder import reorder_by_degree  # noqa: E402

MESHES = [(4, 2), (1, 8)]
ROW_B = 8 * 4  # float32 rows, dim 8


def _meshes(data, feature):
    return (make_mesh_j(data=data, feature=feature),
            qt.make_mesh(data=data, feature=feature, devices=["cpu"] * (data * feature)))


def _np(x):
    """A host array of a JAX array or a tensor (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _both(store_j, store_t, ids, **kw):
    """Rows of ``ids`` from both stores, checked bitwise equal; returns
    the port's."""
    want = _np(store_j.gather(jnp.asarray(ids), **kw))
    got = _np(store_t.gather(torch.from_numpy(np.asarray(ids)), **kw))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


def _oracle(feat, ids):
    ref = feat[np.where(ids >= 0, ids, 0)].copy()
    ref[ids < 0] = 0
    return ref


def _graph(n=400, e=3000, seed=5):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return qj.CSRTopo(edge_index=ei), qt.CSRTopo(edge_index=ei)


# -- the policy (§0 of the port's slice: the reference's spelling) ------------


@pytest.mark.parametrize("value", ["device_replicate", "mesh_shard", "p2p_clique_replicate",
                                   "clique", None])
def test_cache_policy_parse_equals_jax(value):
    results = []
    for policy in (CachePolicyJ, CachePolicy):
        try:
            results.append(policy.parse(value).value)
        except (ValueError, TypeError, KeyError) as e:
            results.append((type(e), str(e)))
    assert results[0] == results[1]
    assert CachePolicy.parse(CachePolicy.MESH_SHARD) is CachePolicy.MESH_SHARD


@pytest.mark.parametrize("policy", ["mesh_shard", "p2p_clique_replicate"])
def test_plain_feature_refuses_mesh_shard_as_jax(policy):
    feat = np.zeros((10, 4), np.float32)
    errors = []
    for make in (lambda: FeatureJ(cache_policy=policy),
                 lambda: qt.Feature(cache_policy=policy, device="cpu")):
        store = make()
        assert store.cache_policy.value == "mesh_shard"
        with pytest.raises(NotImplementedError, match="ShardedFeature") as err:
            store.from_cpu_tensor(feat)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


# -- ShardedTensor ---------------------------------------------------------------


@pytest.mark.parametrize("data,feature", MESHES)
@pytest.mark.parametrize("rows,width", [(777, 12), (37, 8)])
def test_sharded_tensor_equals_jax(data, feature, rows, width):
    """Uneven rows padded to the axis; psum, routed (auto cap), uncapped
    and capped at 1 (every bucket overflows): rows bitwise JAX's and the
    dense table's, the routed overflow JAX's."""
    mesh_j, mesh_t = _meshes(data, feature)
    t = np.random.default_rng(rows).normal(size=(rows, width)).astype(np.float32)
    st_j = ShardedTensorJ(mesh_j, kernel="xla").from_cpu_tensor(t)
    st = qt.ShardedTensor(mesh_t).from_cpu_tensor(t)
    assert st.rows_per_shard == st_j.rows_per_shard and st.shape == st_j.shape
    rng = np.random.default_rng(3)
    for n in (8, 301, 777):
        ids = rng.integers(0, rows, n).astype(np.int32)
        for kw in ({}, {"routed": True}, {"routed": True, "routed_cap": None},
                   {"routed": True, "routed_cap": 1}):
            got = _both(st_j, st, ids, **kw)
            assert np.array_equal(got, t[ids]), kw
            if kw:
                assert int(st.last_routed_overflow) == int(st_j.last_routed_overflow), kw


def test_capped_explicit_cap_invalid_lanes_and_forced_overflow():
    """``test_capped_explicit_cap_and_invalid_lanes``,
    ``test_forced_overflow_served_by_fallback`` and
    ``test_no_overflow_on_clean_batch_metadata_zero`` on both packages."""
    mesh_j, mesh_t = _meshes(2, 4)
    t = np.random.default_rng(0).normal(size=(800, 12)).astype(np.float32)
    st_j = ShardedTensorJ(mesh_j, kernel="xla").from_cpu_tensor(t)
    st = qt.ShardedTensor(mesh_t).from_cpu_tensor(t)
    ids = np.concatenate([np.random.default_rng(2).integers(0, 800, 90),
                          [-1] * 6]).astype(np.int32)
    out = _both(st_j, st, ids, routed=True, routed_cap=8)
    assert np.array_equal(out, _oracle(t, ids))
    ids = np.random.default_rng(3).integers(0, st.rows_per_shard, 256).astype(np.int32)
    assert np.array_equal(_both(st_j, st, ids, routed=True, routed_cap=4), t[ids])
    assert int(st.last_routed_overflow) == int(st_j.last_routed_overflow) == 8 * (32 - 4)
    lanes = np.arange(256)
    ids = ((lanes % 4) * st.rows_per_shard + (lanes // 4) % st.rows_per_shard).astype(np.int32)
    assert np.array_equal(_both(st_j, st, ids, routed=True), t[ids])
    assert int(st.last_routed_overflow) == int(st_j.last_routed_overflow) == 0


def test_auto_tuner_grows_alpha_as_jax():
    """``routed_cap="auto"`` doubles ``routed_alpha`` on the call after an
    overflowing batch, up to F (the uncapped mode): the same alphas and
    counts on both packages, the rows exact throughout."""
    mesh_j, mesh_t = _meshes(2, 4)
    t = np.random.default_rng(0).normal(size=(800, 12)).astype(np.float32)
    st_j = ShardedTensorJ(mesh_j, kernel="xla").from_cpu_tensor(t)
    st = qt.ShardedTensor(mesh_t).from_cpu_tensor(t)
    st_j.routed_alpha = st.routed_alpha = 1.0
    ids = np.random.default_rng(4).integers(0, st.rows_per_shard, 256).astype(np.int32)
    seen = []
    for _ in range(3):
        assert np.array_equal(_both(st_j, st, ids, routed=True), t[ids])
        assert st.routed_alpha == st_j.routed_alpha
        seen.append((st.routed_alpha, int(st.last_routed_overflow)))
        assert seen[-1][1] == int(st_j.last_routed_overflow)
    assert [a for a, _ in seen] == [1.0, 2.0, 4.0] and seen[0][1] > 0 and seen[-1][1] == 0


def test_routed_cap_planning_equals_jax():
    mesh_j, mesh_t = _meshes(2, 4)
    st_j, st = ShardedTensorJ(mesh_j), qt.ShardedTensor(mesh_t)
    for length, alpha in ((128, None), (128, 1.0), (128, 100.0), (2, 0.001), (301, 2.5)):
        assert st.routed_cap(length, alpha) == st_j.routed_cap(length, alpha)
    assert st.routed_cap(128) == 64
    for bad in (st.routed_cap, st_j.routed_cap):
        with pytest.raises(ValueError, match="alpha must be > 0"):
            bad(128, alpha=0)
    with pytest.raises(ValueError, match="routed_alpha"):
        qt.ShardedTensor(mesh_t, routed_alpha=0.0)


# -- ShardedFeature --------------------------------------------------------------


@pytest.mark.parametrize("data,feature", MESHES)
@pytest.mark.parametrize("budget,rep,reorder,dtype", [
    ("1G", 0, False, None),  # hot only
    (30 * ROW_B, 0, False, None),  # two tiers, a pinned cold tier
    (20 * ROW_B, 16 * ROW_B, True, None),  # three tiers, the degree order
    (12 * ROW_B, 64 * ROW_B, True, None),
    ("1G", 0, False, "bf16"),
    (20 * 16, 10 * 16, True, "bfloat16"),  # bf16 rows of 16 B
    (0, 0, True, None),  # cold only
])
def test_sharded_feature_equals_jax(data, feature, budget, rep, reorder, dtype):
    """Every tier layout: the split, the feature order, the rows of a
    degree-skewed draw with invalid lanes (psum, routed, uncapped, capped
    at 2) bitwise JAX's and the dense rows (bf16: JAX's rounding of
    them), and the tier hits and overflow JAX's."""
    topo_j, topo_t = _graph()
    n = topo_j.node_count
    feat = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    mesh_j, mesh_t = _meshes(data, feature)
    kw = {"device_cache_size": budget, "replicate_budget": rep, "dtype": dtype}
    store_j = ShardedFeatureJ(mesh_j, csr_topo=topo_j if reorder else None,
                              **kw).from_cpu_tensor(feat)
    store = qt.ShardedFeature(mesh_t, csr_topo=topo_t if reorder else None,
                              **kw).from_cpu_tensor(feat)
    assert (store.rep_rows, store.hot_rows) == (store_j.rep_rows, store_j.hot_rows)
    assert store.cache_ratio == store_j.cache_ratio
    assert store.replicated_ratio == store_j.replicated_ratio
    assert (store.cold is None) == (store_j.cold is None)
    if store_j.feature_order is None:
        assert store.feature_order is None
    else:
        assert np.array_equal(store.feature_order.numpy(), np.asarray(store_j.feature_order))
        assert np.array_equal(topo_t.feature_order, np.asarray(topo_j.feature_order))
    rng = np.random.default_rng(1)
    deg = topo_j.degree.astype(np.float64)
    ids = rng.choice(n, size=96, p=deg / deg.sum()).astype(np.int32)
    ids[rng.choice(96, 4, replace=False)] = -1
    ref = _oracle(feat, ids)
    if dtype is not None:
        ref = _oracle(np.asarray(jnp.asarray(feat, jnp.bfloat16)).astype(np.float32), ids)
    outs = []
    for kw in ({}, {"routed": True}, {"routed": True, "routed_cap": None},
               {"routed": True, "routed_cap": 2}):
        outs.append(_both(store_j, store, ids, **kw))
        assert np.array_equal(outs[-1], ref), kw
        assert store.last_tier_hits.tolist() == np.asarray(store_j.last_tier_hits).tolist()
        if kw and store.hot is not None:
            assert int(store.last_routed_overflow) == int(store_j.last_routed_overflow), kw


def test_tier_hits_exact_and_l0_lanes_take_no_bucket_capacity():
    """``test_tier_hit_telemetry_exact_counts`` and
    ``test_l0_lanes_cost_zero_routed_bucket_capacity`` on both packages:
    exact per-tier counts of valid lanes, and a batch that overflows the
    two-tier store's capped buckets overflows nothing once its rows are
    L0's."""
    n, f = 512, 8
    feat = np.random.default_rng(3).normal(size=(n, f)).astype(np.float32)
    mesh_j, mesh_t = _meshes(2, 4)
    kw = {"device_cache_size": (128 // 4) * ROW_B, "replicate_budget": 64 * ROW_B}
    store_j = ShardedFeatureJ(mesh_j, **kw).from_cpu_tensor(feat)
    store = qt.ShardedFeature(mesh_t, **kw).from_cpu_tensor(feat)
    assert (store.rep_rows, store.hot_rows) == (64, 128)
    ids = np.concatenate([np.arange(10), 64 + np.arange(20), 192 + np.arange(30),
                          [-1, -1]]).astype(np.int32)
    for routed in (False, True):
        assert np.array_equal(_both(store_j, store, ids, routed=routed), _oracle(feat, ids))
        assert store.last_tier_hits.tolist() == [10, 20, 30]
    ids = np.random.default_rng(5).integers(0, 64, 256).astype(np.int32)
    overflow = []
    for rep in (0, 64 * ROW_B):
        kw = {"device_cache_size": (n // 4) * ROW_B, "replicate_budget": rep}
        store_j = ShardedFeatureJ(mesh_j, **kw).from_cpu_tensor(feat)
        store = qt.ShardedFeature(mesh_t, **kw).from_cpu_tensor(feat)
        assert np.array_equal(_both(store_j, store, ids, routed=True, routed_cap=4), feat[ids])
        overflow.append(int(store.last_routed_overflow))
        assert overflow[-1] == int(store_j.last_routed_overflow)
    assert overflow[0] > 0 and overflow[1] == 0  # every lane L0's: no bucket taken
    assert store.last_tier_hits.tolist() == [256, 0, 0]


def test_budget_zero_bitwise_two_tier_and_every_split():
    """``replicate_budget=0`` is the two-tier store (same split, no L0,
    the same rows), and every L0/L1 split serves the dense rows: the
    split and the rows JAX's at each."""
    topo_j, topo_t = _graph()
    n = topo_j.node_count
    feat = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    mesh_j, mesh_t = _meshes(2, 4)
    budget = (n // 4 // 4) * ROW_B
    ids = np.random.default_rng(1).integers(-1, n, 128).astype(np.int32)
    two = qt.ShardedFeature(mesh_t, device_cache_size=budget,
                            csr_topo=topo_t).from_cpu_tensor(feat)
    zero = qt.ShardedFeature(mesh_t, device_cache_size=budget, csr_topo=topo_t,
                             replicate_budget=0).from_cpu_tensor(feat)
    assert zero.rep is None and zero.rep_rows == 0 and zero.hot_rows == two.hot_rows
    for routed in (False, True):
        a, b = two.gather(torch.from_numpy(ids), routed), zero.gather(torch.from_numpy(ids), routed)
        assert torch.equal(a, b) and np.array_equal(a.numpy(), _oracle(feat, ids))
    for rep_rows in (0, 1, 17, 64, n):
        kw = {"device_cache_size": budget, "replicate_budget": rep_rows * ROW_B}
        store_j = ShardedFeatureJ(mesh_j, csr_topo=topo_j, **kw).from_cpu_tensor(feat)
        store = qt.ShardedFeature(mesh_t, csr_topo=topo_t, **kw).from_cpu_tensor(feat)
        assert (store.rep_rows, store.hot_rows) == (store_j.rep_rows, store_j.hot_rows)
        for routed in (False, True):
            assert np.array_equal(_both(store_j, store, ids, routed=routed), _oracle(feat, ids))


def test_resplit_and_its_host_region():
    """``resplit`` needs the host region (JAX's ``ValueError``); with it,
    every boundary serves the same rows bitwise; ``resplit_budget`` in
    bytes; ``delete``."""
    n, f = 128, 8
    feat = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    mesh_j, mesh_t = _meshes(2, 4)
    msgs = []
    for store in (ShardedFeatureJ(mesh_j, device_cache_size="1G").from_cpu_tensor(feat),
                  qt.ShardedFeature(mesh_t, device_cache_size="1G").from_cpu_tensor(feat)):
        store.resplit(0)  # a no-op split passes
        with pytest.raises(ValueError, match="replicate_budget") as err:
            store.resplit(16)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    store = qt.ShardedFeature(mesh_t, device_cache_size=(n // 8) * ROW_B,
                              replicate_budget=8 * ROW_B).from_cpu_tensor(feat)
    ids = torch.arange(-1, n, dtype=torch.int32)
    for rows in (0, 3, 24, 8):
        store.resplit(rows)
        assert store.rep_rows == rows and store.last_tier_hits is None
        assert np.array_equal(store[ids].numpy(), _oracle(feat, ids.numpy()))
    store.resplit_budget(16 * ROW_B)
    assert store.rep_rows == 16 and store.last_tier_hits is None
    store.delete()
    assert store.hot is None and store.rep is None and store.cold is None


def test_pin_top_keeps_top_degree_rows_in_order():
    """``reorder_by_degree(pin_top=k)``, the L0 contract, bitwise JAX's."""
    rng = np.random.default_rng(2)
    degree = rng.integers(0, 1000, 200)
    feat = rng.normal(size=(200, 4)).astype(np.float32)
    got = reorder_by_degree(feat, degree, 0.5, seed=3, pin_top=16)
    want = reorder_j(feat, degree, 0.5, seed=3, pin_top=16)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    top = np.argsort(-degree.astype(np.int64), kind="stable")[:16]
    assert np.array_equal(got[0][:16], feat[top])


@pytest.mark.parametrize("rep_rows,hot_rows,cold,order,miss", [
    (10, 30, True, True, -1), (10, 30, True, False, 0), (0, 40, True, True, 0),
    (10, 90, False, True, -1), (0, 0, True, True, 0), (25, 0, True, False, -1),
    (0, 100, False, False, 0)])
def test_three_tier_lookup_equals_jax(rep_rows, hot_rows, cold, order, miss):
    """The port's three-tier merge against JAX's ``tiered_lookup`` with
    the same tier tables behind plain gathers: the rows and the hits
    bitwise, and the ids each hot gather receives (which decide routed
    bucket capacity) equal, for every tier layout, a feature order,
    invalid lanes and ids past the table."""
    n, f = 100, 5
    rng = np.random.default_rng(rep_rows + hot_rows)
    table = rng.normal(size=(n, f)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32) if order else None
    ids = np.concatenate([rng.integers(0, n, 60), [-1, -3, n + 4]]).astype(np.int32)
    hot_end = rep_rows + hot_rows
    seen = {}

    def gathers(side, xp, asarr):
        rep = asarr(table[:rep_rows])
        hot = asarr(table[rep_rows:hot_end])
        cld = asarr(table[hot_end:])

        def hot_g(i):
            seen[side] = np.asarray(i)
            return hot[xp.clip(i, 0, hot_rows - 1)] * (i >= 0)[..., None]
        return ((lambda i: rep[xp.clip(i, 0, rep_rows - 1)]) if rep_rows else None,
                hot_g if hot_rows else None,
                (lambda i: cld[xp.clip(i, 0, n - hot_end - 1)]) if cold else None)

    rj, hj, cj = gathers("jax", jnp, jnp.asarray)
    want, hits_j = tiered_lookup_j(jnp.asarray(ids), None if perm is None else jnp.asarray(perm),
                                   hot_rows, hj, cj, rep_rows=rep_rows, rep_gather=rj,
                                   hot_miss_id=miss, with_hits=True)
    rt, ht, ct = gathers("torch", torch, torch.from_numpy)
    got, hits = three_tier_lookup(torch.from_numpy(ids),
                                  None if perm is None else torch.from_numpy(perm),
                                  hot_rows, ht, ct, rep_rows=rep_rows, rep_gather=rt,
                                  hot_miss_id=miss, with_hits=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert hits.tolist() == np.asarray(hits_j).tolist()
    assert seen.keys() == ({"jax", "torch"} if hot_rows else set())
    if hot_rows:
        assert np.array_equal(seen["torch"], seen["jax"])
    two = three_tier_lookup(torch.from_numpy(ids).reshape(3, 21),
                            None if perm is None else torch.from_numpy(perm),
                            hot_rows, ht, ct, rep_rows=rep_rows, rep_gather=rt,
                            hot_miss_id=miss, with_hits=True)
    assert torch.equal(two[0].reshape(63, f), got) and torch.equal(two[1].sum(0), hits)


def test_lookup_of_a_group_is_the_standalone_gather():
    """``ShardedFeature.lookup``, the trainer's per-group lookup: the psum
    flavour on a shared vector and the routed one on ``(F, L)`` members'
    vectors return the standalone gather's rows, the hits per member, and
    the group's overflow as ``routed_gather`` counts it."""
    topo_j, topo_t = _graph()
    n = topo_t.node_count
    feat = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    mesh = _meshes(2, 4)[1]
    store = qt.ShardedFeature(mesh, device_cache_size=20 * ROW_B, replicate_budget=16 * ROW_B,
                              csr_topo=topo_t).from_cpu_tensor(feat)
    ids = torch.from_numpy(np.random.default_rng(4).integers(-1, n, (4, 50)).astype(np.int32))
    want = store.gather(ids.reshape(-1))
    hits_all = store.last_tier_hits
    rows, hits, ov = store.lookup(ids.reshape(-1))
    assert torch.equal(rows, want) and torch.equal(hits, hits_all) and int(ov) == 0
    for cap in (None, 2):
        rows, hits, ov = store.lookup(ids, routed=True, cap=cap)
        assert torch.equal(rows.reshape(200, 8), want) and hits.shape == (4, 3)
        assert torch.equal(hits.sum(0), hits_all)
        t = store.feature_order[ids.clamp(min=0).long()].long()
        l1 = (ids >= 0) & (t >= store.rep_rows) & (t < store.rep_rows + store.hot_rows)
        _, want_ov = store.hot.routed_gather(torch.where(l1, t - store.rep_rows, -1), cap,
                                             with_overflow=True)
        assert int(ov) == int(want_ov) and (cap is None) == (int(ov) == 0)


@pytest.mark.parametrize("call", ["int8", "auto_split", "repin", "apply_row_updates",
                                  "note_degree_update", "replan"])
def test_unported_store_features_raise(call):
    """``replan`` (ROADMAP A.11d) still raises. The calls that raised
    until A.11c was ported (int8 storage, ``auto_split``, ``repin``,
    ``apply_row_updates``, ``note_degree_update``) now run on both packages
    and leave the same store: its split, its version and its rows bitwise
    (``tests/test_torch_shard_control.py`` holds each at length)."""
    mesh_j, mesh = _meshes(2, 4)
    feat = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    if call == "replan":
        store = qt.ShardedFeature(mesh, device_cache_size="1M").from_cpu_tensor(feat)
        with pytest.raises(NotImplementedError, match="A.11d"):
            store.replan(mesh)
        return
    kw = {"device_cache_size": 3 * ROW_B, "replicate_budget": 4 * ROW_B,
          "auto_split": call == "auto_split"}
    if call == "int8":
        kw.update(device_cache_size=4 * 40 + 3 * 8, replicate_budget=4 * 8, dtype="int8")
    stores = (ShardedFeatureJ(mesh_j, **kw).from_cpu_tensor(feat),
              qt.ShardedFeature(mesh, **kw).from_cpu_tensor(feat))
    args = {"repin": ([7, 30, 7],), "apply_row_updates": ([3, 20], feat[:2] + 1.0),
            "note_degree_update": (np.arange(40)[::-1].copy(),)}.get(call)
    ids = np.arange(-1, 40).astype(np.int32)
    for _ in range(3 if call == "auto_split" else 1):
        if args is not None:
            for store in stores:
                getattr(store, call)(*args)
        rows = _both(*stores, ids)
    assert stores[1].rep_rows == stores[0].rep_rows and stores[1].version == stores[0].version
    if call == "apply_row_updates":
        assert np.array_equal(rows[[4, 21]], feat[:2] + 1.0) and stores[1].version == 1
    elif call != "int8":
        assert np.array_equal(rows, _oracle(feat, ids))
