"""The four API repairs of quiver_tpu_torch against quiver_tpu: each test
makes the same call on both packages.

- The ``parallel``, ``utils`` and ``sampling`` subpackages' export tables:
  every name resolves, and the JAX names the port lacks are exactly the
  ones left out by design (``honor_forced_platform``, a JAX platform
  switch).
- ``CSRTopo(use_native=...)`` is accepted and inert.
- ``Timer(sync=...)`` takes a tensor or a nested list, tuple or dict of
  them, as JAX's takes an array or pytree.
- ``generate_uniform_graph``, ``reindex_by_config``, the permutation
  helpers, ``resolve_platform_strategy`` and ``SamplerConfig``.

Tolerance: every output here is integer (or a string, or a boolean), so
every comparison is bitwise.
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
def test_csrtopo_use_native_is_inert(use_native):
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
