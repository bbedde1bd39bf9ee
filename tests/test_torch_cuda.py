"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips without a CUDA device. Run on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py -q -m cuda``.

Tolerance: bitwise (the kernels move integers or bytes; K3's one float
product and compares are the plain version's, op for op).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,k,two", [(1, 1, False), (1003, 5, True), (64, 25, False)])
def test_select_kernel_matches_plain(cuda, rows, k, two):
    from quiver_tpu_torch.ops.kernels.fused import select, select_plain

    rng = np.random.default_rng(rows)
    E = 5000
    tabs = tuple(torch.from_numpy(rng.integers(0, 1 << 30, E).astype(np.int32)).to(cuda)
                 for _ in range(2 if two else 1))
    start = torch.from_numpy(rng.integers(0, E - 64, rows)).to(cuda)
    offs = torch.from_numpy(rng.integers(0, 64, (rows, k)).astype(np.int32)).to(cuda)
    count = torch.from_numpy(rng.integers(0, k + 1, rows).astype(np.int32)).to(cuda)
    before = select.launches
    for cnt in (None, count):
        got = select(tabs, start, offs, cnt)
        want = select_plain(tabs, start, offs, cnt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert select.launches == before + 2


@pytest.mark.parametrize("dtype,F", [(torch.float32, 100), (torch.bfloat16, 100),
                                     (torch.int8, 100), (torch.float32, 3), (torch.int8, 7)])
@pytest.mark.parametrize("pinned", [False, True])
def test_gather_kernel_matches_plain(cuda, dtype, F, pinned):
    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    rng = np.random.default_rng(F)
    table = torch.from_numpy(rng.normal(size=(500, F)).astype(np.float32) * 50).to(dtype)
    table = table.pin_memory() if pinned else table.to(cuda)
    ids = rng.integers(0, 500, 333).astype(np.int32)
    ids[::7] = -1
    ids = torch.from_numpy(ids).to(cuda)
    assert torch.equal(gather_rows(table, ids), gather_rows_plain(table, ids))
    base = torch.full((333, F), 3, dtype=dtype, device=cuda)
    assert torch.equal(gather_rows(table, ids, out=base.clone()),
                       gather_rows_plain(table, ids, out=base))


def test_gather_refuses_pageable_host_table(cuda):
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="pinned"):
        gather_rows(torch.zeros((10, 4)), ids)


@pytest.mark.parametrize("rows,k", [(1, 1), (1003, 5), (64, 15)])
@pytest.mark.parametrize("with_eid,scale_u,pinned", [(False, True, False), (True, True, False),
                                                     (True, False, False), (True, True, True)])
def test_wselect_kernel_matches_plain(cuda, rows, k, with_eid, scale_u, pinned):
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.ops.kernels.fused import wselect, wselect_plain
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(rows * k)
    coo = generate_pareto_graph(3000, 12.0, seed=1)
    w = np.exp(rng.normal(size=coo.shape[1])).astype(np.float32)
    w[coo[0] < 20] = 0.0  # zero-total rows: uniform prefix
    topo = CSRTopo(edge_index=coo, edge_weight=w)
    dt = topo.to_device("UVA" if pinned else "GPU", cuda, with_eid=True, with_weights=True)
    seeds = rng.integers(0, topo.node_count, rows)
    seeds[0] = int(np.argmax(topo.degree))
    if rows > 2:
        seeds[1] = 3
    base = torch.from_numpy(topo.indptr[seeds].astype(np.int64)).to(cuda)
    deg = torch.from_numpy(topo.degree[seeds].astype(np.int32)).to(cuda)
    deg[::7] = 0  # invalid seeds
    u = torch.rand((rows, k), device=cuda)
    if not scale_u:
        end = (base + deg.long() - 1).clamp(min=0)
        u = u * torch.where(deg > 0, dt.cum_weights.to(cuda)[end], 1.0)[:, None]
    eid = dt.eid if with_eid else None
    before = wselect.launches
    got = wselect(dt.indices, dt.cum_weights, base, deg, u.contiguous(), dt.search_iters,
                  eid=eid, scale_u=scale_u)
    want = wselect_plain(dt.indices, dt.cum_weights, base, deg, u, dt.search_iters,
                         eid=eid, scale_u=scale_u)
    torch.cuda.synchronize()
    assert wselect.launches == before + 1
    assert len(got) == len(want) == (3 if with_eid else 2)
    for g, h in zip(got, want):
        assert torch.equal(g, h)
