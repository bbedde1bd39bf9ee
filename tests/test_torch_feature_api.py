"""The feature store's and the sampler's API in quiver_tpu_torch against
quiver_tpu's: lookups of ids past the table, the constructors' argument
order, the ``kernel=`` / ``dedup=`` checks, the reference shims
(``from_numpy``, ``cache_ratio``, ``delete``, the IPC no-ops),
``HeteroFeature`` and the ``quiver_tpu_torch.pyg`` import path.

Tolerance: bitwise (lookups move bytes, or one float32 multiply per
element for int8 stores, on both sides).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

import quiver_tpu as qj  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops.kernels.gather import gather_rows  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402
from quiver_tpu_torch.utils.trace import reset_once  # noqa: E402

N, F = 500, 8


@pytest.fixture(autouse=True)
def _fresh_once():
    reset_once()
    yield
    reset_once()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def port_log():
    """Records of the ``quiver_tpu_torch`` logger at INFO and above,
    captured by a handler attached to it (not through propagation)."""
    logger = logging.getLogger("quiver_tpu_torch")
    level, handler = logger.level, _Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.fixture(scope="module")
def data():
    coo = generate_pareto_graph(N, 5.0, seed=31)
    x = np.random.default_rng(31).normal(size=(N, F)).astype(np.float32)
    return coo, x


def _bits(a):
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else np.asarray(a)
    return a.view(np.uint8)


def _stores(coo, x, store, reorder, dtype):
    itemsize = {None: 4, "bfloat16": 2, "int8": 1}[dtype]
    extra = 4 * N if dtype == "int8" else 0
    budget = {"hot": "1G", "cold": 0, "split": extra + 150 * F * itemsize}[store]
    tj = qj.CSRTopo(edge_index=coo) if reorder else None
    tt = qt.CSRTopo(edge_index=coo) if reorder else None
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, kernel="xla",
                    dtype=dtype).from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, csr_topo=tt, dtype=dtype,
                    device="cpu").from_cpu_tensor(x)
    return fj, ft


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("store,reorder", [("hot", False), ("cold", False), ("cold", True),
                                           ("split", False), ("split", True)])
def test_ids_past_the_table_clamp_like_jax(data, dtype, store, reorder):
    """An id >= N reads the row of id N - 1 (row N - 1, or order[N - 1]);
    ``-1`` lanes stay zero rows."""
    coo, x = data
    fj, ft = _stores(coo, x, store, reorder, dtype)
    assert ft.hot_rows == fj.hot_rows
    n_id = np.array([N - 1, N, N + 1, 10 * N, 2**31 - 1, -1, 0, 3, -1, N + 3], np.int32)
    want = np.asarray(fj[jnp.asarray(n_id)])
    got = ft[torch.from_numpy(n_id)]
    np.testing.assert_array_equal(_bits(got), want.view(np.uint8))
    for j in (1, 2, 3, 4, 9):
        assert torch.equal(got[j], got[0])
    assert not got[[5, 8]].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_gather_rows_clamps_like_jax(dtype):
    table = torch.from_numpy(np.random.default_rng(2).normal(size=(40, 5)).astype(
        np.float32) * 40).to(dtype)
    ids = np.array([39, 40, 1000, -1, 7], np.int32)
    got = gather_rows(table, torch.from_numpy(ids))
    tj = jnp.asarray(_bits(table).view({torch.float32: np.float32,
                                        torch.bfloat16: bfloat16,
                                        torch.int8: np.int8}[dtype]))
    want = np.array(tj[jnp.asarray(np.maximum(ids, 0))])
    want[ids < 0] = 0
    np.testing.assert_array_equal(_bits(got), want.view(np.uint8))


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_feature_positional_args_mean_what_they_mean_in_jax(data, dtype):
    coo, x = data
    budget = 4 * N + 120 * F if dtype else 120 * F * 4
    tj, tt, tk = (qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo),
                  qt.CSRTopo(edge_index=coo))
    fj = qj.Feature(0, [0], budget, "device_replicate", tj, 4, "xla", dtype,
                    0).from_cpu_tensor(x)
    pos = qt.Feature(0, [0], budget, "device_replicate", tt, 4, "auto", dtype, 0,
                     "cpu").from_cpu_tensor(x)
    kw = qt.Feature(rank=0, device_list=[0], device_cache_size=budget,
                    cache_policy="device_replicate", csr_topo=tk, hot_shuffle_seed=4,
                    kernel="auto", dtype=dtype, replicate_budget=0,
                    device="cpu").from_cpu_tensor(x)
    assert pos.hot_rows == kw.hot_rows == fj.hot_rows == 120
    assert pos.hot_shuffle_seed == 4 and pos.dtype == kw.dtype
    assert torch.equal(pos.feature_order, kw.feature_order)
    np.testing.assert_array_equal(pos.feature_order.numpy(), np.asarray(fj.feature_order))
    ids = np.arange(-1, N, 7, dtype=np.int32)
    assert torch.equal(pos[ids], kw[ids])
    np.testing.assert_array_equal(_bits(pos[ids]), np.asarray(fj[jnp.asarray(ids)]).view(np.uint8))


def test_feature_rank_device_list_budget_like_jax(data, port_log):
    """``Feature(0, [0], "1G")`` is a 1 GB hot tier in both packages;
    a non-default rank or device list is logged once and changes nothing."""
    _, x = data
    fj = qj.Feature(0, [0], "1G").from_cpu_tensor(x)
    ft = qt.Feature(0, [0], "1G", device="cpu").from_cpu_tensor(x)
    assert ft.hot_rows == fj.hot_rows == N and ft.cache_budget == 2**30
    assert not [r for r in port_log.records if "INERT" in r.getMessage()]
    for _ in range(3):
        other = qt.Feature(1, [0, 1], "1G", device="cpu").from_cpu_tensor(x)
    assert other.hot_rows == N and other.rank == 1 and other.device_list == [0, 1]
    inert = [r for r in port_log.records if "INERT" in r.getMessage()]
    assert len(inert) == 1 and inert[0].name == "quiver_tpu_torch.feature"


def test_replicate_budget_folds_into_the_budget(data, port_log):
    _, x = data
    kw = dict(device_cache_size=100 * F * 4, replicate_budget=50 * F * 4)
    fj = qj.Feature(**kw).from_cpu_tensor(x)
    ft = qt.Feature(**kw, device="cpu").from_cpu_tensor(x)
    qt.Feature(**kw, device="cpu")
    assert ft.hot_rows == fj.hot_rows == 150
    assert ft.cache_budget == fj.cache_budget
    folded = [r for r in port_log.records if "folded" in r.getMessage()]
    assert len(folded) == 1


def test_placement_report_once_per_store(data, port_log):
    _, x = data
    qt.Feature(device_cache_size=4 * N + 100 * F, dtype="int8",
               device="cpu").from_cpu_tensor(x)
    qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x)
    reports = [r.getMessage() for r in port_log.records if "of feature" in r.getMessage()]
    assert len(reports) == 2
    assert reports[0].startswith("20.00% of feature (100/500 rows")
    assert "100.00% of feature" in reports[1] and "cold tier: none" in reports[1]


def test_storage_dtype_checks(data):
    _, x = data
    for bad in ("int32", "uint8", "bool", "nonsense"):
        with pytest.raises(ValueError, match="storage dtype"):
            qt.Feature(dtype=bad, device="cpu")
    for bad in ("int32", "uint8"):
        with pytest.raises(ValueError, match="storage dtype"):
            qj.Feature(dtype=bad)
    for dtype, want in (("float16", torch.float16), (torch.float64, torch.float64),
                        (torch.int8, torch.int8), ("bf16", torch.bfloat16)):
        assert qt.Feature(dtype=dtype, device="cpu").from_cpu_tensor(x).dtype == want
    f16j = qj.Feature(device_cache_size="1G", dtype="float16").from_cpu_tensor(x)
    f16t = qt.Feature(device_cache_size="1G", dtype="float16", device="cpu").from_cpu_tensor(x)
    ids = np.array([0, 5, -1, 499], np.int32)
    np.testing.assert_array_equal(f16t[ids].numpy(), np.asarray(f16j[jnp.asarray(ids)]))


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
def test_kernel_argument(data, kernel):
    """Every request runs plain PyTorch on the CPU, where ``auto``
    resolves to ``xla`` as JAX's does off the TPU; explicit requests pass
    through. On a CUDA device every request is accepted at construction
    (checked without touching a card: the device is named, not probed;
    resolution waits for the first lookup or sample)."""
    coo, x = data
    want = "xla" if kernel == "auto" else kernel
    ft = qt.Feature(device_cache_size="1G", kernel=kernel, device="cpu").from_cpu_tensor(x)
    assert ft.kernel == want and torch.equal(ft[np.array([3])][0], torch.from_numpy(x[3]))
    tt = qt.CSRTopo(edge_index=coo)
    assert qt.GraphSageSampler(tt, [2], device="cpu", kernel=kernel).kernel == want
    assert qt.Feature(kernel=kernel, device="cuda:0")._kernel == kernel
    for bad in ("triton", "Auto"):
        with pytest.raises(ValueError, match="auto|pallas|xla"):
            qt.Feature(kernel=bad, device="cpu")
        with pytest.raises(ValueError, match="auto|pallas|xla"):
            qt.GraphSageSampler(tt, [2], device="cpu", kernel=bad)


def test_sampler_positional_args_mean_what_they_mean_in_jax(data):
    """The eighth positional argument is ``weighted`` in both packages,
    ``with_eid`` the twelfth."""
    coo, _ = data
    w = np.random.default_rng(3).random(coo.shape[1]).astype(np.float32)
    tj = qj.CSRTopo(edge_index=coo, edge_weight=w)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=w)
    sj = qj.GraphSageSampler(tj, [3, 2], None, "GPU", 64, None, 5, True, None, 1.25,
                             "xla", True, "sort")
    st = qt.GraphSageSampler(tt, [3, 2], "cpu", "GPU", 64, None, 5, True, None, 1.25,
                             "auto", True, "sort", None, "replicated", 4)
    kw = qt.GraphSageSampler(tt, [3, 2], device="cpu", mode="GPU", seed_capacity=64,
                             seed=5, weighted=True, with_eid=True, dedup="sort",
                             compiled_cache_size=4)
    assert sj.weighted and st.weighted and st.with_eid and sj.with_eid
    assert st.seed == 5 and st._seed_capacity == 64 and st.dedup == "sort"
    seeds = np.arange(0, 40, 3)
    a, b = st.sample(seeds), kw.sample(seeds)
    assert torch.equal(a.n_id, b.n_id)
    for x, y in zip(a.adjs, b.adjs):
        assert torch.equal(x.edge_index, y.edge_index) and torch.equal(x.e_id, y.e_id)


def test_sampler_argument_checks(data):
    coo, _ = data
    tt = qt.CSRTopo(edge_index=coo)
    for dedup in ("sort", "map", "scan", "auto"):
        assert qt.GraphSageSampler(tt, [2], device="cpu", dedup=dedup).dedup == dedup
    with pytest.raises(ValueError, match="dedup"):
        qt.GraphSageSampler(tt, [2], device="cpu", dedup="hash")
    with pytest.raises(TypeError, match="DeviceTopology"):
        qt.GraphSageSampler(tt, [2], device="cpu", device_topo=object())
    with pytest.raises(NotImplementedError, match="A.11"):
        qt.GraphSageSampler(tt, [2], device="cpu", topo_sharding="mesh")
    with pytest.raises(ValueError, match="topo_sharding"):
        qt.GraphSageSampler(tt, [2], device="cpu", topo_sharding="ring")
    with pytest.raises(ValueError, match="compiled_cache_size"):
        qt.GraphSageSampler(tt, [2], device="cpu", compiled_cache_size=0)
    # the same sample whatever the (inert) cache size or dedup strategy
    outs = [qt.GraphSageSampler(tt, [3, 2], device="cpu", seed=1, dedup=d,
                                compiled_cache_size=c).sample(np.arange(9))
            for d, c in (("sort", 8), ("map", 1), ("scan", 99))]
    for o in outs[1:]:
        assert torch.equal(o.n_id, outs[0].n_id)


def test_feature_shims_and_delete(data):
    coo, x = data
    ft = qt.Feature.from_numpy(x, device_cache_size=100 * F * 4,
                               csr_topo=qt.CSRTopo(edge_index=coo), device="cpu")
    fj = qj.Feature.from_numpy(x, device_cache_size=100 * F * 4,
                               csr_topo=qj.CSRTopo(edge_index=coo))
    assert ft.cache_ratio == fj.cache_ratio == 100 / N
    assert qt.Feature(device="cpu").cache_ratio == 0.0
    assert ft.share_ipc() is ft
    assert qt.Feature.new_from_ipc_handle(0, ft) is ft
    assert qt.Feature.lazy_from_ipc_handle(ft) is ft
    ids = np.array([1, 2, 3], np.int32)
    np.testing.assert_array_equal(ft[ids].numpy(), np.asarray(fj[jnp.asarray(ids)]))
    assert ft.size(0) == N and ft.size(1) == F
    ft.delete()
    assert ft.hot is None and ft.cold is None and ft.scale is None
    assert ft.feature_order is None and ft.hot_rows == 0


def test_sampler_ipc_shims(data):
    coo, _ = data
    tt = qt.CSRTopo(edge_index=coo)
    s = qt.GraphSageSampler(tt, [3, -1], device="cpu", mode="UVA", seed=2)
    handle = s.share_ipc()
    assert handle == (tt, s.sizes, s.mode)
    sj = qj.GraphSageSampler(qj.CSRTopo(edge_index=coo), [3, -1])
    assert s.sizes == sj.share_ipc()[1]
    r = qt.GraphSageSampler.lazy_from_ipc_handle(handle, device="cpu")
    assert r.sizes == s.sizes and r.mode == s.mode and r.csr_topo is tt


def test_hetero_feature_matches_jax():
    rng = np.random.default_rng(8)
    tables = {"paper": rng.normal(size=(50, 6)).astype(np.float32),
              "author": rng.normal(size=(30, 4)).astype(np.float32)}
    hj = qj.HeteroFeature.from_cpu_tensors(tables, device_cache_size=20 * 6 * 4)
    ht = qt.HeteroFeature.from_cpu_tensors(tables, device_cache_size=20 * 6 * 4,
                                           device="cpu")
    hq = qt.HeteroFeature.from_cpu_tensors(tables, device_cache_size="1G", dtype="int8",
                                           device="cpu")
    hqj = qj.HeteroFeature.from_cpu_tensors(tables, device_cache_size="1G", dtype="int8",
                                            kernel="xla")
    ids = {"paper": np.array([0, 49, -1, 60], np.int32), "author": np.array([29, 3], np.int32)}
    got, want = ht[ids], hj[{k: jnp.asarray(v) for k, v in ids.items()}]
    gq, wq = hq[ids], hqj[{k: jnp.asarray(v) for k, v in ids.items()}]
    assert set(got) == set(want) == set(gq) == {"paper", "author"}
    for t in ids:
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want[t]))
        np.testing.assert_array_equal(gq[t].numpy(), np.asarray(wq[t]))
    assert ht.size("paper", 1) == 6 and ht.size("author", 0) == 30
    assert ht.features["paper"].hot_rows == hj.features["paper"].hot_rows == 20


def test_pyg_import_path_and_exports():
    from quiver_tpu_torch.pyg import Adj, GraphSageSampler

    assert GraphSageSampler is qt.GraphSageSampler and Adj is qt.Adj
    for name in ("HeteroFeature", "GraphDataset", "load_dataset", "planted_partition",
                 "reorder_by_degree", "Timer", "enable_trace", "get_logger",
                 "trace_scope", "tensor_info", "show_tensor_info"):
        assert name in qt.__all__ and hasattr(qt, name) and hasattr(qj, name)
