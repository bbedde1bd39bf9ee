"""K2's tiered entry (``tiered_gather``/``tiered_gather_plain``) against
quiver_tpu's ``Feature`` lookup.

The port's store holds the same tables as the JAX store (same budget
split, same degree reorder); ``tiered_gather_plain`` over the port's
``feature_order``/hot/cold tables must return JAX's rows for padded ids,
at f32 and bf16, for all-hot, all-cold and split stores, with and without
the reorder. ``tiered_gather`` on CPU tensors is the plain version and
never counts a launch.

Tolerance: bitwise. A gather moves bytes, and the bf16 cast rounds to
nearest even in both frameworks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

import quiver_tpu as qj  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops.kernels.gather import (  # noqa: E402
    tiered_gather, tiered_gather_plain)
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

N, F = 700, 9


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def data():
    coo = generate_pareto_graph(N, 6.0, seed=12)
    x = np.random.default_rng(12).normal(size=(N, F)).astype(np.float32)
    return coo, x


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("store,reorder", [
    ("hot", False), ("cold", False), ("cold", True), ("split", False), ("split", True),
])
def test_tiered_gather_plain_matches_jax_feature(data, dtype, store, reorder):
    coo, x = data
    row_bytes = F * (2 if dtype else 4)
    budget = {"hot": "1G", "cold": 0, "split": 250 * row_bytes}[store]
    tj = qj.CSRTopo(edge_index=coo) if reorder else None
    tt = qt.CSRTopo(edge_index=coo) if reorder else None
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, dtype=dtype).from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, csr_topo=tt, dtype=dtype,
                    device="cpu").from_cpu_tensor(x)
    assert ft.hot_rows == fj.hot_rows
    assert (ft.hot is None) == (store == "cold") and (ft.cold is None) == (store == "hot")
    assert (ft.feature_order is not None) == reorder
    if reorder:
        assert ft.feature_order.dtype == torch.int32  # cast once at placement
    rng = np.random.default_rng(len(store) + reorder)
    n_id = rng.integers(0, N, 257).astype(np.int32)
    n_id[rng.random(257) < 0.2] = -1
    want = np.asarray(fj[jnp.asarray(n_id)])
    args = (torch.from_numpy(n_id), ft.feature_order, ft.hot_rows, ft.hot, ft.cold)
    before = tiered_gather.launches
    for got in (tiered_gather_plain(*args), tiered_gather(*args)):
        got = _to_numpy(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert tiered_gather.launches == before  # CPU tensors never launch K2
    assert not _to_numpy(tiered_gather(*args))[n_id < 0].astype(np.float32).any()


def test_feature_lookup_takes_int64_ids(data):
    """``Feature[...]`` narrows any integer ids to K2's int32 and runs the
    tiered entry."""
    coo, x = data
    ft = qt.Feature(device_cache_size=200 * F * 4, csr_topo=qt.CSRTopo(edge_index=coo),
                    device="cpu").from_cpu_tensor(x)
    ids = np.array([0, 699, -1, 5, 5], np.int64)
    got = ft[ids]
    want = tiered_gather_plain(torch.from_numpy(ids.astype(np.int32)), ft.feature_order,
                               ft.hot_rows, ft.hot, ft.cold)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    np.testing.assert_array_equal(got[[0, 1, 3]].numpy(), x[[0, 699, 5]])
