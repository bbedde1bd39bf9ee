"""The API repairs of quiver_tpu_torch against quiver_tpu: each test makes
the same call on both packages.

- The ``parallel``, ``utils`` and ``sampling`` subpackages' export tables:
  every name resolves, and the JAX names the port lacks are exactly the
  ones left out by design (``honor_forced_platform``, a JAX platform
  switch).
- ``CSRTopo(use_native=...)`` builds the same arrays natively or with
  numpy.
- ``Timer(sync=...)`` takes a tensor or a nested list, tuple or dict of
  them, as JAX's takes an array or pytree.
- ``generate_uniform_graph``, ``reindex_by_config``, the permutation
  helpers, ``resolve_platform_strategy`` and ``SamplerConfig``.
- ``DistHeteroSampler.kernel`` (C.5); ``masked_unique`` and
  ``reindex_layer`` with ``node_bound`` and ``scatter_free``, and
  ``staged_gather`` with ``host`` (C.6); ``feature.tiered_lookup`` in
  JAX's gather contract (C.7).

Tolerance: bitwise everywhere (the outputs are integers, strings,
booleans, or float rows that are moved, never computed).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import quiver_tpu.parallel as parallel_j  # noqa: E402
import quiver_tpu.sampling as sampling_j  # noqa: E402
import quiver_tpu.utils as utils_j  # noqa: E402
from quiver_tpu.core import config as config_j  # noqa: E402
from quiver_tpu.core.topology import CSRTopo as CSRTopoJ  # noqa: E402
from quiver_tpu.ops import reindex as reindex_j  # noqa: E402
from quiver_tpu.utils import graphgen as graphgen_j  # noqa: E402
from quiver_tpu.utils import reorder as reorder_j  # noqa: E402

import quiver_tpu_torch.parallel as parallel_t  # noqa: E402
import quiver_tpu_torch.sampling as sampling_t  # noqa: E402
import quiver_tpu_torch.utils as utils_t  # noqa: E402
from quiver_tpu_torch.core import config as config_t  # noqa: E402
from quiver_tpu_torch.core.topology import CSRTopo  # noqa: E402
from quiver_tpu_torch.ops import reindex as reindex_t  # noqa: E402
from quiver_tpu_torch.utils import graphgen as graphgen_t  # noqa: E402
from quiver_tpu_torch.utils import reorder as reorder_t  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402

# JAX names the port's subpackages do not export, by design
NOT_PORTED = {"parallel": set(), "utils": {"honor_forced_platform"}, "sampling": set()}


@pytest.mark.parametrize("pkg,jax_pkg,torch_pkg", [
    ("parallel", parallel_j, parallel_t), ("utils", utils_j, utils_t),
    ("sampling", sampling_j, sampling_t)])
def test_export_tables(pkg, jax_pkg, torch_pkg):
    for name in torch_pkg.__all__:
        assert getattr(torch_pkg, name) is not None, name
    assert set(jax_pkg.__all__) - set(torch_pkg.__all__) == NOT_PORTED[pkg]
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(torch_pkg, "no_such_name")


def test_subpackage_names_are_the_top_level_ones():
    import quiver_tpu_torch as qt

    assert parallel_t.Prefetcher is qt.Prefetcher
    assert parallel_t.DataParallelTrainer is qt.DataParallelTrainer
    assert parallel_t.MeshTopo is qt.MeshTopo is qt.p2pCliqueTopo
    assert utils_t.Checkpointer is qt.Checkpointer
    assert utils_t.Timer is qt.Timer
    import quiver_tpu as qj
    from quiver_tpu_torch.feature import shard

    for name in ("ShardedFeature", "ShardedTensor"):
        assert name in qt.__all__ and name in qj.__all__
        assert getattr(qt, name) is getattr(shard, name)
    for name in ("ShardedTopology", "HeteroShardedTopology", "DistGraphSageSampler",
                 "DistHeteroSampler"):
        assert name in qt.__all__ and name in qj.__all__


@pytest.mark.parametrize("use_native", [True, False])
def test_csrtopo_use_native_builds_the_same_arrays(use_native):
    """``use_native=True`` takes the native host build (when the library builds
    here), ``False`` the numpy one: the same arrays and dtypes either way,
    and JAX's."""
    rng = np.random.default_rng(3)
    ei = rng.integers(0, 300, size=(2, 4000))
    default = CSRTopo(edge_index=ei)
    got = CSRTopo(edge_index=ei, use_native=use_native)
    ref = CSRTopoJ(edge_index=ei, use_native=use_native)
    for attr in ("indptr", "indices", "eid"):
        a, b = getattr(got, attr), getattr(default, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, attr)))
    csr = CSRTopo(indptr=default.indptr, indices=default.indices,
                  use_native=use_native)
    assert np.array_equal(csr.indices, default.indices)


@pytest.fixture
def records():
    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.DEBUG)
            self.records = []

        def emit(self, record):
            self.records.append(record)

    logger = trace.get_logger()
    level, handler = logger.level, Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.mark.parametrize("sync", [
    "tensor", "dict", "nested", None, False, True])
def test_timer_sync_takes_tensors(records, sync):
    """JAX's ``Timer(sync=array or pytree)``; the port's took a bool and
    raised "Boolean value of Tensor with more than one value is
    ambiguous" on a 3-element tensor."""
    t = torch.arange(3.0)
    arg = {"tensor": t, "dict": {"a": t, "b": t + 1},
           "nested": [t, (t, {"c": t})]}.get(sync, sync)
    with trace.Timer("stage", sync=arg) as timer:
        sum(range(20000))
    assert timer.seconds > 0
    msg = records[-1].getMessage()
    assert msg.startswith("[stage] ") and msg.endswith(" ms")
    jax_arg = {"tensor": jnp.arange(3.0), "dict": {"a": jnp.arange(3.0)},
               "nested": [jnp.arange(3.0)]}.get(sync, sync)
    with utils_j.Timer("stage", sync=jax_arg, quiet=True) as timer_j:
        pass
    assert timer_j.seconds >= 0


def test_cuda_devices_of_a_tree():
    t = torch.zeros(2)
    assert trace._cuda_devices({"a": [t, (t,)], "b": 3}) == set()


@pytest.mark.parametrize("n,deg,seed", [(50, 3, 0), (1000, 7, 5)])
def test_generate_uniform_graph(n, deg, seed):
    got = graphgen_t.generate_uniform_graph(n, deg, seed=seed)
    want = graphgen_j.generate_uniform_graph(n, deg, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (2, n * deg)


@pytest.mark.parametrize("portion", [0.0, 0.25, 1.0])
def test_reindex_by_config(portion):
    rng = np.random.default_rng(1)
    ei = rng.integers(0, 400, size=(2, 3000))
    feat = rng.normal(size=(400, 5)).astype(np.float32)
    got = reorder_t.reindex_by_config(CSRTopo(edge_index=ei), feat, portion, seed=4)
    want = reorder_j.reindex_by_config(CSRTopoJ(edge_index=ei), feat, portion, seed=4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    new_feat, order = got
    np.testing.assert_array_equal(new_feat[order], feat)


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (7, 2), (64, 3), (200, 4), (1000, 5)])
def test_inverse_permutations(n, seed):
    p = _perm(n, seed)
    want = np.asarray(reindex_j.inverse_permutation(jnp.asarray(p)))
    want_g = np.asarray(reindex_j.inverse_permutation_gather(jnp.asarray(p)))
    got = reindex_t.inverse_permutation(torch.from_numpy(p))
    got_g = reindex_t.inverse_permutation_gather(torch.from_numpy(p))
    assert got.dtype == got_g.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got.numpy()[p], np.arange(n))


@pytest.mark.parametrize("n,m_share,seed", [
    (1, 0.0, 0), (1, 1.0, 1), (9, 0.5, 2), (64, 0.0, 3), (64, 0.9, 4), (200, 1.0, 5),
    (1000, 0.37, 6)])
def test_complete_permutation(n, m_share, seed):
    m = int(m_share * n)
    p = _perm(n, seed)[:m]
    want = np.asarray(reindex_j.complete_permutation(jnp.asarray(p), n))
    got = reindex_t.complete_permutation(torch.from_numpy(p), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:m], p)


def test_complete_permutation_rejects_a_long_map():
    p = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="longer") as e_j:
        reindex_j.complete_permutation(jnp.asarray(p), 4)
    with pytest.raises(ValueError, match="longer") as e_t:
        reindex_t.complete_permutation(torch.from_numpy(p), 4)
    assert str(e_t.value) == str(e_j.value)


CHOICES = ("sort", "map", "scan")


@pytest.mark.parametrize("force", [None, "sort", "MAP", " scan "])
def test_resolve_platform_strategy_env(monkeypatch, force):
    if force is None:
        monkeypatch.delenv("QUIVER_TEST_STRATEGY", raising=False)
    else:
        monkeypatch.setenv("QUIVER_TEST_STRATEGY", force)
    args = ("QUIVER_TEST_STRATEGY", CHOICES, "scan", "map")
    # JAX runs on the CPU here, so its platform default is other_default
    want = config_j.resolve_platform_strategy(*args)
    assert config_t.resolve_platform_strategy(*args, device="cpu") == want
    assert config_t.resolve_platform_strategy(*args, device=torch.zeros(1)) == want
    # the argument JAX calls tpu_default is the card's default
    on_card = config_t.resolve_platform_strategy(*args, device="cuda")
    assert on_card == ("scan" if force is None else want)


def test_resolve_platform_strategy_typo_raises(monkeypatch):
    monkeypatch.setenv("QUIVER_TEST_STRATEGY", "sotr")
    args = ("QUIVER_TEST_STRATEGY", CHOICES, "scan", "map")
    with pytest.raises(ValueError) as e_j:
        config_j.resolve_platform_strategy(*args)
    with pytest.raises(ValueError) as e_t:
        config_t.resolve_platform_strategy(*args, device="cpu")
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("kwargs", [
    dict(sizes=(3, 2), seed_capacity=8, frontier_caps=(16, 64)),
    dict(sizes=(3, 2), seed_capacity=8, frontier_caps=(16,)),
    dict(sizes=(3,), seed_capacity=0, frontier_caps=(16,)),
    dict(sizes=(3,), seed_capacity=-2, frontier_caps=(16,), mode="host"),
])
def test_sampler_config_checks(kwargs):
    def build(mod):
        kw = dict(kwargs)
        if "mode" in kw:
            kw["mode"] = mod.SampleMode.parse(kw["mode"])
        try:
            return mod.SamplerConfig(**kw), None
        except ValueError as e:
            return None, str(e)

    (got, err_t), (want, err_j) = build(config_t), build(config_j)
    assert err_t == err_j
    if want is not None:
        assert (got.sizes, got.seed_capacity, got.frontier_caps, got.mode.value) == (
            want.sizes, want.seed_capacity, want.frontier_caps, want.mode.value)
        with pytest.raises(AttributeError):
            got.seed_capacity = 4  # frozen


# -- the repairs of a later re-anchor: C.5, C.6 and C.7 --------------------------


def test_dist_hetero_sampler_kernel_property():
    """C.5: ``DistHeteroSampler.kernel`` resolves lazily and is kept, as
    ``GraphSageSampler.kernel`` is, and equals JAX's (``"xla"`` on the
    CPU); an explicit request passes through."""
    import jax

    import quiver_tpu as qj
    import quiver_tpu_torch as qt
    from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j

    from test_torch_hetero import both_topos

    assert isinstance(getattr(qt.DistHeteroSampler, "kernel"), property)
    assert isinstance(getattr(qj.DistHeteroSampler, "kernel"), property)
    tj, tt, _ = both_topos(0)
    for kernel in ("auto", "xla"):
        port = qt.DistHeteroSampler(tt, [3, 2], "paper", kernel=kernel,
                                    mesh=qt.make_mesh(data=1, feature=2, devices=["cpu"] * 2))
        jx = qj.DistHeteroSampler(tj, [3, 2], "paper", kernel=kernel,
                                  mesh=make_mesh_j(data=1, feature=2,
                                                   devices=jax.devices()[:2]))
        assert getattr(port, "_kernel_resolved", None) is None  # nothing resolved yet
        assert port.kernel == jx.kernel == "xla"
        assert port._kernel_resolved == "xla" and port._kernel == kernel


def _dedup_inputs(seed):
    rng = np.random.default_rng(seed)
    S, K, n = 8, 5, 60
    seeds = np.full(S, -1, np.int32)
    num = 6
    seeds[:num] = rng.integers(0, n, num)
    nbr = rng.integers(-1, n, (S, K)).astype(np.int32)
    return seeds, num, nbr, n


@pytest.mark.parametrize("strategy", [
    {}, {"node_bound": 60}, {"scatter_free": True},
    {"node_bound": None, "scatter_free": True}, {"node_bound": 60, "scatter_free": True}])
@pytest.mark.parametrize("seed", [0, 1])
def test_reindex_takes_jax_strategy_arguments(strategy, seed):
    """C.6: ``masked_unique`` and ``reindex_layer`` take JAX's
    ``node_bound`` and ``scatter_free`` (by keyword and in JAX's
    positions); the port's outputs are bitwise JAX's under every strategy
    JAX picks with them, and bitwise the port's own default."""
    seeds, num, nbr, n = _dedup_inputs(seed)
    cap = 30
    nb, sf = strategy.get("node_bound"), strategy.get("scatter_free", False)
    want = reindex_j.reindex_layer(jnp.asarray(seeds), jnp.int32(num), jnp.asarray(nbr), cap,
                                   **strategy)
    got = reindex_t.reindex_layer(torch.from_numpy(seeds), num, torch.from_numpy(nbr), cap,
                                  nb, sf)
    base = reindex_t.reindex_layer(torch.from_numpy(seeds), num, torch.from_numpy(nbr), cap)
    for a, b, c in zip(got, want, base):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)
    ids = np.concatenate([seeds, nbr.reshape(-1)])
    valid = ids >= 0
    want = reindex_j.masked_unique(jnp.asarray(ids), jnp.asarray(valid), 25, 4, **strategy)
    got = reindex_t.masked_unique(torch.from_numpy(ids), torch.from_numpy(valid), 25, 4,
                                  node_bound=nb, scatter_free=sf)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_staged_gather_takes_host(host, shape):
    """C.6: ``staged_gather(table, idx, host)`` in JAX's order, for a 1-D
    and a 2-D table and ids of two dimensions; ``host`` is inert here (K2
    reads a pinned table over UVA either way): bitwise JAX's."""
    from quiver_tpu.ops.sample import staged_gather as staged_gather_j

    from quiver_tpu_torch.ops.sample import staged_gather

    rng = np.random.default_rng(len(shape))
    table = rng.integers(0, 1000, shape).astype(np.int32)
    idx = rng.integers(0, shape[0], (6, 4)).astype(np.int32)
    want = np.asarray(staged_gather_j(jnp.asarray(table), jnp.asarray(idx), False))
    got = staged_gather(torch.from_numpy(table), torch.from_numpy(idx), host)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rep_rows,hot_rows,cold,order,miss", [
    (10, 30, True, True, -1), (0, 40, True, False, 0), (10, 90, False, True, -1),
    (25, 0, True, True, 0)])
@pytest.mark.parametrize("form", ["positional", "keywords", "gathers only"])
def test_tiered_lookup_takes_jax_contract(rep_rows, hot_rows, cold, order, miss, form):
    """C.7: ``feature.tiered_lookup`` takes JAX's contract (gather
    callables, then ``rep_rows``, ``rep_gather``, ``hot_miss_id``,
    ``with_hits``; the sixth positional argument is ``rep_rows``), with
    each package's own gathers over the same tier tables: rows and hits
    bitwise JAX's. The port's table form keeps working beside it."""
    from quiver_tpu.feature.feature import tiered_lookup as tiered_lookup_j

    from quiver_tpu_torch.feature.feature import tiered_lookup
    from quiver_tpu_torch.ops.kernels.gather import gather_rows_plain

    n, f = 100, 5
    rng = np.random.default_rng(rep_rows + hot_rows)
    table = rng.normal(size=(n, f)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32) if order else None
    ids = np.concatenate([rng.integers(0, n, 60), [-1, -3]]).astype(np.int32)
    hot_end = rep_rows + hot_rows
    parts = (table[:rep_rows], table[rep_rows:hot_end], table[hot_end:])

    def jax_gather(part):
        t = jnp.asarray(part)
        return lambda i: t[jnp.clip(i, 0, part.shape[0] - 1)]

    def port_gather(part):
        t = torch.from_numpy(part)
        return lambda i: gather_rows_plain(t, i.reshape(-1).to(torch.int32)).reshape(
            tuple(i.shape) + (f,))

    def call(fn, gather, to):
        rep_g = gather(parts[0]) if rep_rows else None
        hot_g = gather(parts[1]) if hot_rows else None
        cold_g = gather(parts[2]) if cold else None
        o = None if perm is None else to(perm)
        if form == "positional":
            return fn(to(ids), o, hot_rows, hot_g, cold_g, rep_rows, rep_g, miss, True)
        if form == "keywords":
            return fn(to(ids), o, hot_rows, hot_g, cold_g, rep_rows=rep_rows,
                      rep_gather=rep_g, hot_miss_id=miss, with_hits=True)
        # no JAX keyword: the callables alone pick the contract
        return fn(to(ids), o, rep_rows + hot_rows, gather(table[:hot_end]) if hot_end else None,
                  cold_g), None

    want, hits_j = call(tiered_lookup_j, jax_gather, jnp.asarray)
    got, hits = call(tiered_lookup, port_gather, torch.from_numpy)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if hits is not None:
        assert hits.tolist() == np.asarray(hits_j).tolist()
    # the table form: a tensor hot tier and cold tier, the sixth positional
    # argument the scales (None here)
    if not rep_rows and cold and hot_rows:
        t = torch.from_numpy(table)
        o = None if perm is None else torch.from_numpy(perm)
        rows = tiered_lookup(torch.from_numpy(ids), o, hot_rows, t[:hot_rows], t[hot_rows:],
                             None)
        assert np.array_equal(rows.numpy(), got.numpy())


# -- C.8: resolve_dedup, and the samplers' resolved dedup ------------------------------


@pytest.fixture
def dedup_fresh(monkeypatch):
    """Both packages' QUIVER_DEDUP caches and once-keys reset, no force
    set; returns a function that resets the caches again."""
    from quiver_tpu.utils import trace as trace_j

    def reset():
        for mod in (reindex_j, reindex_t):
            monkeypatch.setattr(mod, "_forced_dedup", None)
            monkeypatch.setattr(mod, "_auto_dedup", None)

    monkeypatch.setattr(trace_j, "_ONCE_KEYS", set())
    monkeypatch.setattr(trace, "_ONCE_KEYS", set())
    monkeypatch.delenv("QUIVER_DEDUP", raising=False)
    reset()
    yield reset
    reset()


def _both(fn):
    """``fn(resolve_dedup)`` on the JAX package, then on the port: each
    result, or the ``ValueError``'s text."""
    out = []
    for mod in (reindex_j, reindex_t):
        try:
            out.append(fn(mod.resolve_dedup))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_resolve_dedup_twin_platform_and_env(dedup_fresh, monkeypatch):
    """``tests/test_reindex.py::test_resolve_dedup_platform_and_env`` on
    both packages: explicit names pass through, the resolution is pinned
    once per process (an env change after first use is inert until a
    reset), a force applies, a typo'd force and an unknown name raise the
    same ``ValueError``. ``auto`` is ``map`` on the CPU in both."""
    for name in ("sort", "map", "scan"):
        assert _both(lambda r: r(name)) == [name, name]
    assert _both(lambda r: r("auto")) == ["map", "map"]
    monkeypatch.setenv("QUIVER_DEDUP", "scan")
    assert _both(lambda r: r("auto")) == ["map", "map"]  # pinned at first use
    dedup_fresh()
    assert _both(lambda r: r("auto")) == ["scan", "scan"]
    dedup_fresh()
    monkeypatch.setenv("QUIVER_DEDUP", "bogus")
    jax_err, port_err = _both(lambda r: r("auto"))
    assert jax_err == port_err and jax_err[0] == "ValueError" and "QUIVER_DEDUP" in jax_err[1]
    jax_err, port_err = _both(lambda r: r("hash"))
    assert jax_err == port_err and jax_err[0] == "ValueError" and "dedup" in jax_err[1]


def test_dedup_env_ignored_for_explicit_logged_once_twin(dedup_fresh, monkeypatch, records):
    """``tests/test_guardrails.py:96-98`` on both packages: a force wins for
    ``auto``; an explicit name wins over it, and the ignored force is
    logged once, in the same words. Each package's records are taken by a
    handler on its own logger (not through propagation)."""
    from quiver_tpu.utils import trace as trace_j

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.DEBUG)
            self.records = []

        def emit(self, record):
            self.records.append(record)

    logger = trace_j.get_logger()
    level, handler = logger.level, Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        monkeypatch.setenv("QUIVER_DEDUP", "scan")
        assert _both(lambda r: r("auto")) == ["scan", "scan"]
        assert _both(lambda r: [r("sort"), r("sort")]) == [["sort", "sort"]] * 2
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    jax_lines = [r.getMessage() for r in handler.records if "QUIVER_DEDUP" in r.getMessage()]
    port_lines = [r.getMessage() for r in records if "QUIVER_DEDUP" in r.getMessage()]
    assert len(jax_lines) == 1 and port_lines == jax_lines
    assert "ignored" in jax_lines[0]


def test_samplers_resolve_dedup(dedup_fresh):
    """The port's samplers hold the resolved name, as JAX's do: ``auto``
    reads ``map`` on the CPU, an explicit name passes through, a typo
    raises."""
    from quiver_tpu_torch.core.hetero import HeteroCSRTopo
    from quiver_tpu_torch.sampling import HeteroGraphSampler

    rng = np.random.default_rng(0)
    ei = rng.integers(0, 50, (2, 400)).astype(np.int64)
    topo = CSRTopo(edge_index=ei)
    assert sampling_j.GraphSageSampler(CSRTopoJ(edge_index=ei), [3],
                                       seed_capacity=16).dedup == "map"
    assert sampling_t.GraphSageSampler(topo, [3], device="cpu").dedup == "map"
    assert sampling_t.GraphSageSampler(topo, [3], device="cpu", dedup="scan").dedup == "scan"
    mesh = parallel_t.make_mesh(data=1, feature=2, devices=["cpu"] * 2)
    assert sampling_t.GraphSageSampler(topo, [3], topo_sharding="mesh",
                                       mesh=mesh).dedup == "map"
    hetero = HeteroCSRTopo({"paper": 50}, {("paper", "cites", "paper"): ei})
    assert HeteroGraphSampler(hetero, [3], "paper", device="cpu").dedup == "map"
    with pytest.raises(ValueError, match="dedup must be"):
        sampling_t.GraphSageSampler(topo, [3], device="cpu", dedup="hash")


# -- C.9: to_pinned_host(x, device=None, mesh=None) ------------------------------------


def test_to_pinned_host_takes_jax_calls():
    """JAX's one-argument and ``mesh=`` calls on both packages, on one
    array: equal values; JAX's CPU backend has a pinned host memory space
    (``is_host`` True), the port keeps CPU tensors in ordinary memory
    (``is_host`` False). The port's one-argument call resolves the device
    as every entry point does: with no card it raises as
    ``resolve_device(None)`` does. The port's ``(x, device)`` calls keep
    working."""
    import jax

    from quiver_tpu.core.memory import to_pinned_host as pinned_j
    from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j
    from quiver_tpu_torch.core.memory import resolve_device, to_pinned_host

    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    arr, host = pinned_j(x)
    assert host is True and np.array_equal(np.asarray(arr), x)
    arr, host = pinned_j(x, mesh=make_mesh_j(data=2, feature=2, devices=jax.devices()[:4]))
    assert host is True and np.array_equal(np.asarray(arr), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError) as want:
            resolve_device(None)
        with pytest.raises(RuntimeError) as got:
            to_pinned_host(x)
        assert str(got.value) == str(want.value)
    t, host = to_pinned_host(x, mesh=parallel_t.make_mesh(data=2, feature=2,
                                                          devices=["cpu"] * 4))
    assert host is False and np.array_equal(t.numpy(), x)
    t, host = to_pinned_host(x, "cpu")
    assert host is False and np.array_equal(t.numpy(), x)
