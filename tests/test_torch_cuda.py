"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips without a CUDA device. Run on a GPU
machine with ``python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda``.

Tolerance: bitwise (the kernels move integers or bytes; K3's one float
product and compares are the plain version's, op for op). The training
step on the card against the same step on the CPU (TF32 off, dropout 0,
the same parameters and inputs): the loss within 1e-5 relative, each
gradient within 1e-4 x its max |g| (cuBLAS and the CPU's GEMMs sum in
different orders). ``full_neighbor_mean`` on the card against the CPU:
within 1e-5 relative and 1e-6 absolute (the card's accumulate may group
and round its float sums differently); HOST against HBM placement:
bitwise.
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


def _degree_graph(cuda, pinned, seed):
    """A weighted CSR whose rows take every degree of 0-40, 60-69, 250-262,
    500, 1000 and 3232 (the products graph's largest), short rows and
    long, some with all-zero weights (the uniform prefix)."""
    from quiver_tpu_torch import CSRTopo

    rng = np.random.default_rng(seed)
    degs = np.array(list(range(41)) + list(range(60, 70)) + list(range(250, 263))
                    + [500, 1000, 3232])
    n = len(degs)
    coo = np.stack([np.repeat(np.arange(n), degs), rng.integers(0, n, degs.sum())])
    w = np.exp(rng.normal(size=coo.shape[1])).astype(np.float32)
    w[coo[0] % 5 == 3] = 0.0
    topo = CSRTopo(edge_index=coo, edge_weight=w)
    dt = topo.to_device("UVA" if pinned else "GPU", cuda, with_eid=True, with_weights=True)
    return topo, dt


@pytest.mark.parametrize("k", [1, 5, 15, 40])
@pytest.mark.parametrize("scale_u,pinned", [(True, False), (False, False), (True, True)])
def test_wselect_kernel_every_degree(cuda, k, scale_u, pinned):
    from quiver_tpu_torch.ops.kernels.fused import wselect, wselect_plain

    topo, dt = _degree_graph(cuda, pinned, k)
    rows = np.tile(np.arange(topo.node_count), 3)
    base = torch.from_numpy(topo.indptr[rows].astype(np.int64)).to(cuda)
    deg = torch.from_numpy(topo.degree[rows].astype(np.int32)).to(cuda)
    u = torch.rand((rows.shape[0], k), device=cuda)
    if not scale_u:
        end = (base + deg.long() - 1).clamp(min=0)
        u = u * torch.where(deg > 0, dt.cum_weights.to(cuda)[end], 1.0)[:, None]
    args = (dt.indices, dt.cum_weights, base, deg, u.contiguous(), dt.search_iters)
    got = wselect(*args, eid=dt.eid, scale_u=scale_u)
    want = wselect_plain(*args, eid=dt.eid, scale_u=scale_u)
    torch.cuda.synchronize()
    for g, h in zip(got, want):
        assert torch.equal(g, h)


@pytest.mark.parametrize("indptr64", [False, True])
@pytest.mark.parametrize("with_eid,topo_eid,pinned", [(False, False, False), (True, True, False),
                                                      (True, False, False), (True, True, True)])
@pytest.mark.parametrize("k,lanes", [(5, False), (15, True), (40, True)])
def test_weighted_hop_kernel_matches_plain(cuda, indptr64, with_eid, topo_eid, pinned, k,
                                           lanes):
    from quiver_tpu_torch.ops.kernels.fused import weighted_hop, weighted_hop_plain

    topo, dt = _degree_graph(cuda, pinned, k + int(indptr64))
    indptr = dt.indptr.long() if indptr64 else dt.indptr
    eid = dt.eid if topo_eid else None
    rng = np.random.default_rng(k + 2 * int(with_eid))
    shape = (3, 64) if lanes else (1003,)
    seeds = rng.integers(0, topo.node_count, shape).astype(np.int32)
    seeds[..., :5] = [topo.node_count - 1, 1, 0, 45, 46]  # degrees 3232, 1, 0, 64, 65
    seeds[..., 5::9] = -1
    seeds = torch.from_numpy(seeds).to(cuda)
    num = torch.tensor([64, 20, 0], dtype=torch.int32, device=cuda) if lanes else 1000
    u01 = torch.rand(shape + (k,), device=cuda)
    before = weighted_hop.launches
    got = weighted_hop(indptr, dt.indices, dt.cum_weights, seeds, num, u01,
                       dt.search_iters, eid=eid, with_eid=with_eid)
    want = weighted_hop_plain(indptr, dt.indices, dt.cum_weights, seeds, num, u01,
                              dt.search_iters, eid=eid, with_eid=with_eid)
    torch.cuda.synchronize()
    assert weighted_hop.launches == before + 1
    assert len(got) == len(want) == (3 if with_eid else 2)
    for g, h in zip(got, want):
        assert g.dtype == h.dtype and torch.equal(g, h)


@pytest.mark.parametrize("indptr64", [False, True])
@pytest.mark.parametrize("with_eid,topo_eid,pinned", [(False, False, False), (True, True, False),
                                                      (True, False, False), (True, True, True)])
@pytest.mark.parametrize("lanes", [False, True])
def test_uniform_hop_kernel_matches_plain(cuda, indptr64, with_eid, topo_eid, pinned, lanes):
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, uniform_hop_plain
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(3000, 12.0, seed=2))
    dt = topo.to_device("UVA" if pinned else "GPU", cuda, with_eid=topo_eid)
    indptr = dt.indptr.long() if indptr64 else dt.indptr
    rng = np.random.default_rng(int(indptr64) + 2 * int(with_eid) + 4 * int(lanes))
    shape = (3, 64) if lanes else (1003,)
    seeds = rng.integers(0, topo.node_count, shape).astype(np.int32)
    seeds[..., 0] = int(np.argmax(topo.degree))
    seeds[..., 1] = int(np.flatnonzero(topo.degree <= 7)[0])
    seeds[..., 5::9] = -1
    seeds = torch.from_numpy(seeds).to(cuda)
    num = torch.tensor([64, 20, 0], dtype=torch.int32, device=cuda) if lanes else 1000
    k = 7
    jitter = torch.randint(0, 2**62, shape + (k,), device=cuda)
    rot = torch.randint(0, 2**62, shape + (1,), device=cuda)
    before = uniform_hop.launches
    got = uniform_hop(indptr, dt.indices, seeds, num, jitter, rot, eid=dt.eid,
                      with_eid=with_eid)
    want = uniform_hop_plain(indptr, dt.indices, seeds, num, jitter, rot, eid=dt.eid,
                             with_eid=with_eid)
    torch.cuda.synchronize()
    assert uniform_hop.launches == before + 1
    assert len(got) == len(want) == (3 if with_eid else 2)
    for g, h in zip(got, want):
        assert g.dtype == h.dtype and torch.equal(g, h)


# row widths that take every warp layout: four rows per warp (400 B, 200 B,
# 6 B), two (1 KB), one row in one chunk (1.6 KB), one in several (2.4 KB,
# and 516 B in 4 B words)
@pytest.mark.parametrize("dtype,F", [(torch.float32, 100), (torch.bfloat16, 100),
                                     (torch.bfloat16, 3), (torch.float32, 256),
                                     (torch.float32, 400), (torch.float32, 600),
                                     (torch.float32, 129)])
@pytest.mark.parametrize("store", ["hot", "cold", "split", "split, reorder"])
def test_tiered_gather_kernel_matches_plain(cuda, dtype, F, store):
    from quiver_tpu_torch import CSRTopo, Feature
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n = 2000
    rng = np.random.default_rng(F)
    x = rng.normal(size=(n, F)).astype(np.float32)
    row_bytes = F * torch.tensor([], dtype=dtype).element_size()
    budget = {"hot": n * row_bytes, "cold": 0}.get(store, 600 * row_bytes)
    topo = CSRTopo(edge_index=generate_pareto_graph(n, 5.0, seed=3)) if "reorder" in store else None
    feat = Feature(device_cache_size=budget, csr_topo=topo, dtype=dtype,
                   device=cuda).from_cpu_tensor(x)
    ids = rng.integers(0, n, 555).astype(np.int32)
    ids[::6] = -1
    ids = torch.from_numpy(ids).to(cuda)
    args = (ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold)
    before = gather.tiered_gather.launches
    got = gather.tiered_gather(*args)
    want = gather.tiered_gather_plain(*args)
    torch.cuda.synchronize()
    assert gather.tiered_gather.launches == before + 1
    assert torch.equal(got, want)
    if feat.hot is not None:  # the single-table entry, same kernel
        hot_ids = torch.where(ids < feat.hot_rows, ids, -1)
        assert torch.equal(gather.gather_rows(feat.hot, hot_ids),
                           gather.gather_rows_plain(feat.hot, hot_ids))


def test_tiered_gather_refuses_pageable_cold_table(cuda):
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather

    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    hot = torch.zeros((5, 4), device=cuda)
    with pytest.raises(ValueError, match="pinned"):
        tiered_gather(ids, None, 5, hot, torch.zeros((5, 4)))


def _train_grads(model, x, adjs, labels, mask):
    """One ``make_train_step`` call at SGD lr 0: (loss, gradients)."""
    from quiver_tpu_torch.parallel.train import make_train_step

    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
    loss = step(x, adjs, labels, mask)
    return float(loss), [p.grad.detach().cpu() for p in model.parameters()]


@pytest.mark.parametrize("batch,fanout", [(64, (10, 5)), (256, (25, 10)), (128, (10, 5, 3))])
def test_train_step_card_matches_cpu(cuda, batch, fanout):
    """A batch sampled and looked up on the card (K1's fused hop, K2's
    tiered lookup) trains one step on the card; the same x, Adjs, labels
    and parameters, copied to the CPU, train the same step there."""
    import copy

    from quiver_tpu_torch import Feature, GraphSAGE, GraphSageSampler
    from quiver_tpu_torch.datasets import planted_partition
    from quiver_tpu_torch.parallel.train import init_model

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ds = planted_partition(n=3000, num_classes=6, feature_dim=40, seed=1)
        feat = Feature(device_cache_size=600 * 40 * 4, csr_topo=ds.topo,
                       device=cuda).from_cpu_tensor(ds.features)
        sampler = GraphSageSampler(ds.topo, list(fanout), device=cuda, seed=3,
                                   seed_capacity=batch, frontier_caps="auto")
        out = sampler.sample(ds.train_idx[:batch])
        x = feat[out.n_id]
        seed_ids = out.n_id[:batch]
        labels = torch.from_numpy(ds.labels).to(cuda)[seed_ids.clamp(min=0)]
        mask = seed_ids >= 0
        model = GraphSAGE(40, 64, 6, num_layers=len(fanout), dropout=0.0)
        init_model(model, torch.Generator().manual_seed(0))
        cpu_model = copy.deepcopy(model)
        loss_g, grads_g = _train_grads(model.to(cuda), x, out.adjs, labels, mask)
        loss_c, grads_c = _train_grads(cpu_model, x.cpu(), [a.to("cpu") for a in out.adjs],
                                       labels.cpu(), mask.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert np.isfinite(loss_g)
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for g, c in zip(grads_g, grads_c):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


def test_layerwise_host_equals_hbm_on_card(cuda):
    """The HOST placement reads the edge array over UVA (K2 single-table
    entry) and must equal the HBM placement bitwise on the card."""
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.models.inference import full_neighbor_mean
    from quiver_tpu_torch.ops.kernels.gather import gather_rows
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(5000, 20.0, seed=2))
    x = torch.randn(topo.node_count, 33, device=cuda)
    hbm = full_neighbor_mean(topo, x, chunk=4096, mode="HBM", device=cuda)
    before = gather_rows.launches
    host = full_neighbor_mean(topo, x, chunk=4096, mode="HOST", device=cuda)
    assert gather_rows.launches > before
    assert torch.equal(host, hbm)
    cpu = full_neighbor_mean(topo, x.cpu(), chunk=4096, device="cpu")
    assert torch.allclose(hbm.cpu(), cpu, rtol=1e-5, atol=1e-6)
