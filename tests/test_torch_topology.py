"""quiver_tpu_torch topology, config, graph generator and degree reorder
against quiver_tpu.

Tolerance: bitwise. Every array here is integer (indptr, indices, eid,
feature_order) or a permutation of float rows, so the port must equal the
JAX package exactly, dtype included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.utils.graphgen import generate_pareto_graph as gen_j  # noqa: E402
from quiver_tpu.utils.reorder import reorder_by_degree as reorder_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph as gen_t  # noqa: E402
from quiver_tpu_torch.utils.reorder import reorder_by_degree as reorder_t  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_pareto_graph_bitwise():
    _same(gen_t(3000, 12.0, seed=3), gen_j(3000, 12.0, seed=3))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_csr_from_coo_bitwise(dtype):
    rng = np.random.default_rng(0)
    coo = rng.integers(0, 500, size=(2, 4000)).astype(dtype)
    coo[:, :10] = coo[:, :1]  # duplicate edges keep COO order in a row
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    for name in ("indptr", "indices", "eid", "degree"):
        _same(getattr(tt, name), getattr(tj, name))
    assert (tt.node_count, tt.edge_count, tt.max_degree, tt.version) == (
        tj.node_count, tj.edge_count, tj.max_degree, tj.version)


def test_csr_from_indptr_and_torch_input():
    rng = np.random.default_rng(1)
    tj = qj.CSRTopo(edge_index=rng.integers(0, 300, size=(2, 2000)))
    tt = qt.CSRTopo(indptr=torch.from_numpy(tj.indptr.astype(np.int64)),
                    indices=torch.from_numpy(tj.indices), eid=tj.eid)
    tj2 = qj.CSRTopo(indptr=tj.indptr, indices=tj.indices, eid=tj.eid)
    for name in ("indptr", "indices", "eid"):
        _same(getattr(tt, name), getattr(tj2, name))


def test_csr_rejects_bad_input():
    with pytest.raises(ValueError):
        qt.CSRTopo(edge_index=np.array([[0, -1], [1, 2]]))
    with pytest.raises(ValueError):
        qt.CSRTopo(indptr=np.array([0, 2, 1]), indices=np.array([0]))
    with pytest.raises(ValueError):
        qt.CSRTopo(indptr=np.array([0, 1]), indices=np.array([5]))


@pytest.mark.parametrize("hot_ratio,pin_top", [(0.0, 0), (0.3, 0), (0.5, 7), (1.0, 0)])
def test_reorder_by_degree_bitwise(hot_ratio, pin_top):
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(400, 6)).astype(np.float32)
    deg = rng.integers(0, 20, 400)
    nf_t, order_t = reorder_t(feat, deg, hot_ratio, seed=5, pin_top=pin_top)
    nf_j, order_j = reorder_j(feat, deg, hot_ratio, seed=5, pin_top=pin_top)
    _same(nf_t, nf_j)
    _same(order_t, order_j)
    np.testing.assert_array_equal(nf_t[order_t], feat)


def test_feature_order_bitwise():
    """The tiered store's degree reorder sets the same feature_order."""
    coo = gen_j(1500, 8.0, seed=4)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    x = np.random.default_rng(4).normal(size=(1500, 8)).astype(np.float32)
    qj.Feature(device_cache_size=400 * 32, csr_topo=tj).from_cpu_tensor(x)
    qt.Feature(device_cache_size=400 * 32, csr_topo=tt,
               device="cpu").from_cpu_tensor(x)
    _same(tt.feature_order, tj.feature_order)


@pytest.mark.parametrize("size", ["0.9M", "3GB", 200, "1.5k", "2T"])
def test_parse_size_bytes_matches(size):
    assert qt.parse_size_bytes(size) == qj.parse_size_bytes(size)


@pytest.mark.parametrize("spelling", ["GPU", "hbm", "UVA", "host", "zero_copy"])
def test_sample_mode_spellings(spelling):
    assert qt.SampleMode.parse(spelling).value == qj.SampleMode.parse(spelling).value


@pytest.mark.parametrize("mode", ["GPU", "UVA"])
def test_to_device_cpu(mode):
    coo = gen_t(300, 5.0, seed=0)
    tt = qt.CSRTopo(edge_index=coo)
    dt = tt.to_device(mode, device="cpu", with_eid=True)
    _same(dt.indptr.numpy(), tt.indptr)
    _same(dt.indices.numpy(), tt.indices)
    _same(dt.eid.numpy(), tt.eid)
    assert dt.host_indices is False  # no pinned memory without a card
    assert dt.node_count == tt.node_count and dt.edge_count == tt.edge_count


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    tt = qt.CSRTopo(edge_index=gen_t(100, 4.0, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.to_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.GraphSageSampler(tt, [2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.Feature(device_cache_size="1M")
