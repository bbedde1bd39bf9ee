"""quiver_tpu_torch's row gather (K2's plain version) and tiered feature
store against quiver_tpu.

* ``gather_rows_plain``/``gather_rows`` against the Pallas ``gather_rows``
  (interpret mode on the CPU) on f32, bf16 and int8-code tables with a
  ragged id count.
* ``Feature`` against quiver_tpu's ``Feature``: hot-only, hot + cold with
  the degree reorder, a cold-only store, ``-1`` lanes, bf16 storage.

Tolerance: bitwise. A gather moves bytes, and the bf16 cast rounds to
nearest even in both frameworks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops.pallas.gather import gather_rows as gather_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

TORCH_OF = {np.dtype(np.float32): torch.float32, np.dtype(bfloat16): torch.bfloat16,
            np.dtype(np.int8): torch.int8}


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bfloat16)
    return t.numpy()


def _from_numpy(a):
    if a.dtype == np.dtype(bfloat16):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", [np.float32, bfloat16, np.int8])
@pytest.mark.parametrize("count,F", [(37, 12), (16, 100), (5, 3)])
def test_gather_rows_plain_matches_pallas(dtype, count, F):
    rng = np.random.default_rng(count + F)
    if dtype is np.int8:
        table = rng.integers(-127, 128, (90, F)).astype(np.int8)
    else:
        table = rng.normal(size=(90, F)).astype(np.float32).astype(dtype)
    ids = rng.integers(0, 90, count).astype(np.int32)
    want = np.asarray(gather_j(jnp.asarray(table), jnp.asarray(ids)))
    t = _from_numpy(table)
    for got in (gather_rows_plain(t, torch.from_numpy(ids)),
                gather_rows(t, torch.from_numpy(ids))):
        assert got.dtype == TORCH_OF[np.dtype(dtype)]
        got = _to_numpy(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert gather_rows.launches == 0  # CPU tensors never launch K2


def test_gather_negative_ids_zero_or_keep():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    ids = torch.tensor([2, -1, 0], dtype=torch.int32)
    np.testing.assert_array_equal(
        gather_rows(table, ids).numpy(), [[7, 8, 9], [0, 0, 0], [1, 2, 3]])
    out = torch.full((3, 3), -5.0)
    kept = gather_rows(table, torch.tensor([-1, 3, -1], dtype=torch.int32), out=out)
    np.testing.assert_array_equal(kept.numpy(), [[-5] * 3, [10, 11, 12], [-5] * 3])


@pytest.fixture(scope="module")
def graph():
    coo = generate_pareto_graph(800, 6.0, seed=2)
    x = np.random.default_rng(2).normal(size=(800, 10)).astype(np.float32)
    return coo, x


@pytest.mark.parametrize("budget,reorder,dtype", [
    ("1G", False, None),          # hot only
    (200 * 40, True, None),       # 200 hot rows, 600 cold, degree reorder
    (200 * 40, False, None),      # hot + cold, no reorder
    (0, False, None),             # cold only
    (300 * 20, True, "bfloat16"),  # bf16 rows, hot + cold
])
def test_feature_matches_jax(graph, budget, reorder, dtype):
    coo, x = graph
    tj = qj.CSRTopo(edge_index=coo) if reorder else None
    tt = qt.CSRTopo(edge_index=coo) if reorder else None
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, dtype=dtype).from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, csr_topo=tt, dtype=dtype,
                    device="cpu").from_cpu_tensor(x)
    assert ft.hot_rows == fj.hot_rows and ft.shape == fj.shape
    rng = np.random.default_rng(3)
    n_id = rng.integers(0, 800, 300).astype(np.int32)
    n_id[rng.random(300) < 0.2] = -1
    want = np.asarray(fj[jnp.asarray(n_id)])
    got = _to_numpy(ft[torch.from_numpy(n_id)])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert not got[n_id < 0].astype(np.float32).any()
