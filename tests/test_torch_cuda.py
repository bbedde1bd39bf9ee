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
bitwise. ``DataParallelTrainer.step`` on the card against the same step
on the CPU: the training step's tolerances.
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


def _int8_store(cuda, n, F, store, seed):
    """An int8 ``Feature`` of ``n`` random rows (row 5 all zeros) in one of
    the store layouts, and its ids: ``-1`` lanes and ids past the table."""
    from quiver_tpu_torch import CSRTopo, Feature
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    x[5] = 0.0
    hot = {"hot": n, "cold": 0}.get(store, n // 3)
    topo = CSRTopo(edge_index=generate_pareto_graph(n, 5.0, seed=3)) if "reorder" in store else None
    feat = Feature(device_cache_size=4 * n + hot * F, csr_topo=topo, dtype="int8",
                   device=cuda).from_cpu_tensor(x)
    assert feat.hot_rows == hot
    ids = rng.integers(0, n + 50, 777).astype(np.int32)
    ids[::6] = -1
    ids[1:4] = [n - 1, n, 2**31 - 1]
    return feat, torch.from_numpy(ids).to(cuda)


# F=100: 4 codes a word, four rows a warp; F=602: 2 codes a word, one row in
# several chunks; F=7: single codes
@pytest.mark.parametrize("F", [100, 602, 7])
@pytest.mark.parametrize("store", ["hot", "cold", "split", "split, reorder", "cold, reorder"])
def test_tiered_gather_dequant_matches_plain(cuda, F, store):
    from quiver_tpu_torch.ops.kernels import gather

    feat, ids = _int8_store(cuda, 1500, F, store, F)
    args = (ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold, feat.scale)
    before = gather.tiered_gather_dequant.launches
    got = gather.tiered_gather_dequant(*args)
    want = gather.tiered_gather_plain(*args)
    torch.cuda.synchronize()
    assert gather.tiered_gather_dequant.launches == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(feat[ids], got)
    assert not got[ids < 0].any()
    # ids past the table read the row of id N - 1
    assert torch.equal(got[2], got[1]) and torch.equal(got[3], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", ["hot", "cold", "split", "split, reorder"])
def test_tiered_gather_clamps_like_plain(cuda, dtype, store):
    """Ids past the table read row N - 1 (or order[N - 1]) on the card, as
    in the plain version, in every store layout."""
    from quiver_tpu_torch import CSRTopo, Feature
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n, F = 1000, 100
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, F)).astype(np.float32)
    row_bytes = F * torch.tensor([], dtype=dtype).element_size()
    budget = {"hot": n * row_bytes, "cold": 0}.get(store, 300 * row_bytes)
    topo = CSRTopo(edge_index=generate_pareto_graph(n, 5.0, seed=3)) if "reorder" in store else None
    feat = Feature(device_cache_size=budget, csr_topo=topo, dtype=dtype,
                   device=cuda).from_cpu_tensor(x)
    ids = torch.tensor([n - 1, n, n + 7, 2**31 - 1, -1, 0], dtype=torch.int32, device=cuda)
    args = (ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold)
    got = gather.tiered_gather(*args)
    assert torch.equal(got, gather.tiered_gather_plain(*args))
    for j in (1, 2, 3):
        assert torch.equal(got[j], got[0])
    assert not got[4].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pinned", [False, True])
def test_gather_rows_clamps_like_plain(cuda, dtype, pinned):
    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(size=(300, 37)).astype(np.float32) * 50).to(dtype)
    table = table.pin_memory() if pinned else table.to(cuda)
    ids = torch.tensor([299, 300, 5000, 2**31 - 1, -1, 3], dtype=torch.int32, device=cuda)
    got = gather_rows(table, ids)
    assert torch.equal(got, gather_rows_plain(table, ids))
    assert torch.equal(got[1], got[0]) and torch.equal(got[3], got[0])
    base = torch.full((6, 37), 3, dtype=dtype, device=cuda)
    assert torch.equal(gather_rows(table, ids, out=base.clone()),
                       gather_rows_plain(table, ids, out=base))


# -- serving programs captured as CUDA graphs ------------------------------------


def _replay_stack(cuda, store="hot", weighted=False, kernel="pallas", nodes=5000,
                  mode="GPU", device_topo=None, tmp=None, max_batch=8, model=None):
    from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler,
                                  InferenceServer)
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    coo = generate_pareto_graph(nodes, 12.0, seed=3)
    w = np.exp(np.random.default_rng(4).normal(size=coo.shape[1])).astype(np.float32)
    topo = CSRTopo(edge_index=coo, edge_weight=w)
    x = np.random.default_rng(5).normal(size=(nodes, 24)).astype(np.float32)
    budget = {"hot": "1G", "split": nodes // 4 * 24 * 4}[store.split(",")[0]]
    dtype = "int8" if "int8" in store else None
    feat = Feature(device_cache_size=budget, csr_topo=topo, device=cuda,
                   **({"dtype": dtype} if dtype else {})).from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, [5, 5], device=cuda, seed=0, weighted=weighted,
                               kernel=kernel, mode=mode, device_topo=device_topo)
    if model is None:
        torch.manual_seed(0)
        model = GraphSAGE(24, 64, 7)
    server = InferenceServer(sampler, model, feat, device=cuda, max_batch=max_batch,
                             seed=0, aot_cache=tmp)
    return server


@pytest.mark.parametrize("store,weighted,kernel", [
    ("hot", False, "pallas"), ("split", False, "pallas"), ("hot", True, "pallas"),
    ("split, int8", False, "pallas"), ("hot", False, "xla"), ("hot", True, "xla")])
def test_replay_equals_eager_step_every_bucket(cuda, store, weighted, kernel):
    """Each bucket's captured programs against the same steps run eagerly on
    the same inputs, and the served answers against the single-query oracle:
    bitwise, full and padded lanes; each replay makes the launches its
    capture recorded, and no wrapper is called by a replay."""
    from quiver_tpu_torch.ops.kernels import launch_counts
    from quiver_tpu_torch.serving.ladder import REPLAYED_LAUNCHES

    server = _replay_stack(cuda, store, weighted, kernel)
    assert server.warmup() == 2 * len(server.batcher.buckets) == server.recompiles
    lad = server.ladder
    hop = ("weighted_hop" if weighted else "uniform_hop") if kernel == "pallas" else (
        "wselect" if weighted else "select")
    for prog in lad.programs():
        assert prog.graph is not None
    for b in server.batcher.buckets:
        assert lad.sample_program(b).launches == {hop: 2}
        assert lad.forward_program(b).launches == {}
    rng = np.random.default_rng(1)
    for bucket in server.batcher.buckets:
        for live in sorted({bucket, max(bucket - 1, 1)}):
            nodes = rng.integers(0, 5000, live)
            seqs = [int(s) for s in rng.integers(0, 1000, live)] + [None] * (bucket - live)
            seeds = torch.full((bucket,), -1, dtype=torch.int32)
            seeds[:live] = torch.from_numpy(nodes.astype(np.int32))
            before, replayed = launch_counts(), dict(REPLAYED_LAUNCHES)
            n_ids, eis, ovf = lad.sample_exec(bucket)(seeds, seqs)
            assert launch_counts() == before
            assert REPLAYED_LAUNCHES[hop] == replayed.get(hop, 0) + 2
            prog = lad.sample_program(bucket)
            eager = prog.step()  # the same step on the same static inputs
            for got, want in zip((n_ids, *eis, ovf), (eager[0], *eager[1], eager[2])):
                assert torch.equal(got, want)
            x = server.feature[n_ids.reshape(-1)].reshape(bucket, lad.lane_caps[-1], 24)
            out = lad.forward_exec(bucket)(x, eis).clone()
            fwd = lad.forward_program(bucket)
            assert torch.equal(out, fwd.step())
            for j in range(live):
                assert np.array_equal(out[j].cpu().numpy(),
                                      server.oracle(int(nodes[j]), seqs[j]))
    reqs = server.serve(rng.integers(0, 5000, 19))
    for r in reqs:
        assert np.array_equal(r.result, server.oracle(r.node, r.seq))
    assert server.recompiles == 2 * len(server.batcher.buckets)


def test_replay_under_quiver_check_and_uva(cuda, monkeypatch):
    """QUIVER_CHECK's readback runs in the eager pass and is skipped under
    capture; a UVA topology's pinned tables are read by the replays."""
    from quiver_tpu_torch.models import layers

    monkeypatch.setattr(layers, "_check_cache", True)
    server = _replay_stack(cuda, mode="UVA")
    server.warmup()
    for r in server.serve(np.arange(0, 5000, 371)):
        assert np.array_equal(r.result, server.oracle(r.node, r.seq))


def test_programs_never_shared_across_placements(cuda, tmp_path):
    """Two servers over one graph, model and cache but different placements
    share the forward programs and never a sample program; a sampler that
    adopts the first placement through device_topo shares both."""
    a = _replay_stack(cuda, tmp=str(tmp_path))
    first = a.warm_from_cache()
    assert first == {"loaded": 0, "compiled": 8}
    b = _replay_stack(cuda, tmp=str(tmp_path), model=a.model)  # another placement
    assert b.warm_from_cache() == {"loaded": 4, "compiled": 4}
    for pa, pb in zip(a.ladder.programs(), b.ladder.programs()):
        assert (pa is pb) == (pa.launches == {})
    c = _replay_stack(cuda, tmp=str(tmp_path), device_topo=a.sampler.topo,
                      model=a.model)
    assert c.warm_from_cache() == {"loaded": 8, "compiled": 0}
    nodes = np.arange(3, 5000, 517)
    for ra, rb, rc in zip(a.serve(nodes), b.serve(nodes), c.serve(nodes)):
        assert np.array_equal(ra.result, rb.result)
        assert np.array_equal(ra.result, rc.result)


def test_profiler_sees_the_hop_kernel_in_a_replay(cuda):
    """torch.profiler records the fused hop's kernel running inside a
    replayed sample program, which calls no wrapper."""
    for weighted, name in ((False, "uniform_hop_kernel"), (True, "weighted_hop_kernel")):
        server = _replay_stack(cuda, weighted=weighted)
        server.warmup()
        run = server.ladder.sample_exec(8)
        seeds = torch.arange(8, dtype=torch.int32)
        run(seeds, list(range(8)))
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run(seeds, list(range(8)))
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert any(name in k for k in names), names


def _prefetch_setup(cuda, kernel="auto"):
    from quiver_tpu_torch import Feature, GraphSageSampler
    from quiver_tpu_torch.datasets import planted_partition

    ds = planted_partition(n=4000, num_classes=6, feature_dim=24, seed=2)
    feat = Feature(device_cache_size=1000 * 24 * 4, csr_topo=ds.topo, kernel=kernel,
                   device=cuda).from_cpu_tensor(ds.features)

    def sampler():
        return GraphSageSampler(ds.topo, [10, 5], device=cuda, seed=4,
                                seed_capacity=128, frontier_caps="auto")

    seeds = [np.random.default_rng(i).choice(ds.train_idx, 128, replace=False)
             for i in range(8)]
    return ds, feat, sampler, seeds


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_prefetcher_on_card_equals_serial_loop(cuda, kernel):
    """The Prefetcher's batches, dispatched on its worker's own stream
    while the main stream runs matmuls on each batch, are bitwise the
    serial loop's; every sampler launch is counted from the worker."""
    from quiver_tpu_torch import Prefetcher
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop

    _ds, feat, sampler, seeds = _prefetch_setup(cuda, kernel)
    serial = sampler()
    want = []
    for s in seeds:
        out = serial.sample(s)
        want.append((out.n_id.clone(), [a.edge_index.clone() for a in out.adjs],
                     feat[out.n_id].clone()))
    pf = Prefetcher(sampler(), feat, depth=2)
    assert pf.device == cuda or pf.device.type == "cuda"
    before = uniform_hop.launches
    got = 0
    w = torch.randn(24, 2048, device=cuda)
    for b, (n_id, eis, x) in zip(pf.run(seeds), want):
        torch.relu(b.x @ w).sum()  # the consumer's stream works on the batch
        assert torch.equal(b.out.n_id, n_id)
        assert all(torch.equal(a.edge_index, e) for a, e in zip(b.out.adjs, eis))
        assert torch.equal(b.x, x)
        got += 1
    assert got == len(seeds)
    if kernel == "auto":
        assert uniform_hop.launches - before >= 2 * len(seeds)


def test_xla_store_read_from_two_threads(cuda):
    """One ``kernel="xla"`` tiered store read at once from two threads
    (each on its own stream): every lookup equals K2's rows bitwise."""
    import threading

    from quiver_tpu_torch.feature.feature import tiered_lookup

    _ds, feat, _sampler, _seeds = _prefetch_setup(cuda, "xla")
    n = feat.shape[0]
    errors = []

    def reader(seed):
        stream = torch.cuda.Stream(cuda)
        rng = np.random.default_rng(seed)
        try:
            with torch.cuda.stream(stream):
                for _ in range(40):
                    ids = torch.from_numpy(rng.integers(0, n, 3000).astype(np.int32)).to(cuda)
                    got = feat[ids]
                    want = tiered_lookup(ids, feat.feature_order, feat.hot_rows,
                                         feat.hot, feat.cold, feat.scale)
                    if not torch.equal(got, want):
                        errors.append(seed)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_first_kernel_load_from_two_threads_builds_once(cuda, monkeypatch):
    """Two threads' first use of the kernels: one build, one load."""
    import threading
    import time

    from quiver_tpu_torch.ops.kernels import build

    calls = []
    real = build._build_locked

    def counted(names):
        calls.append(threading.current_thread().name)
        time.sleep(0.2)
        return real(names)

    monkeypatch.setattr(build, "_LIBS", None)
    monkeypatch.setattr(build, "_build_locked", counted)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build._libraries()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(got) == 2 and got[0] is got[1]
    assert sorted(got[0]) == sorted(build.KERNELS)


def _hetero_topo(weights: bool):
    """A MAG-shaped typed graph (paper-cites-paper, author-writes-paper,
    inst-employs-author) with exp(N(0, 1)) weights on every relation."""
    from quiver_tpu_torch import HeteroCSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(0)
    n_paper, n_author, n_inst = 3000, 1500, 75
    topo = HeteroCSRTopo(
        {"paper": n_paper, "author": n_author, "inst": n_inst},
        {("paper", "cites", "paper"): generate_pareto_graph(n_paper, 10.0, seed=0),
         ("author", "writes", "paper"): np.stack([rng.integers(0, n_author, 3 * n_paper),
                                                  rng.integers(0, n_paper, 3 * n_paper)]),
         ("inst", "employs", "author"): np.stack([rng.integers(0, n_inst, 2 * n_author),
                                                  rng.integers(0, n_author, 2 * n_author)])})
    if weights:
        for et, rel in topo.relations.items():
            topo.set_edge_weight(et, np.exp(rng.normal(size=rel.edge_count)))
    return topo


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["GPU", "UVA"])
def test_hetero_sampler_card_matches_plain(cuda, weighted, mode):
    """The hetero loop on the card (one fused K1 or K3 launch per relation
    per hop) against its plain run on the CPU, on the same raw draws:
    frontiers, counts, every Adj and e_id, overflow, bitwise."""
    from quiver_tpu_torch import HeteroGraphSampler
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, weighted_hop
    from quiver_tpu_torch.ops.sample import hop_draws
    from quiver_tpu_torch.sampling.hetero import hetero_multilayer_sample

    topo = _hetero_topo(weighted)
    kw = {"weighted": weighted, "with_eid": True}
    card = HeteroGraphSampler(topo, [8, 4], "paper", mode=mode, device=cuda, **kw)
    cpu = HeteroGraphSampler(topo, [8, 4], "paper", device="cpu", **kw)
    plans = card._plan(512)
    rel = {et: i for i, et in enumerate(topo.edge_types)}

    def bits_on(dev):
        def bits(hop, et, shape):
            g = torch.Generator().manual_seed(10 * hop + rel[et])
            d = hop_draws(shape, plans[hop][0][et], g, weighted=weighted)
            return d.to(dev) if weighted else tuple(x.to(dev) for x in d)
        return bits

    seeds = np.random.default_rng(1).integers(0, 3000, 500).astype(np.int32)
    before = (uniform_hop.launches, weighted_hop.launches)
    got = hetero_multilayer_sample(card.dev_topos, torch.from_numpy(seeds).to(cuda), 500,
                                   "paper", plans, bits=bits_on(cuda),
                                   weighted_rels=card.weighted_rels, with_eid=True)
    hops = sum(len(p[0]) for p in plans)
    assert hops == 5
    assert (uniform_hop.launches - before[0], weighted_hop.launches - before[1]) == (
        (0, hops) if weighted else (hops, 0))
    want = hetero_multilayer_sample(cpu.dev_topos, torch.from_numpy(seeds), 500, "paper",
                                    plans, bits=bits_on("cpu"),
                                    weighted_rels=cpu.weighted_rels, with_eid=True)
    frontier, counts, layers, overflow, fcounts = got
    assert all(torch.equal(frontier[t].cpu(), want[0][t]) for t in want[0])
    assert all(int(counts[t]) == int(want[1][t]) for t in want[1])
    for lg, lc in zip(layers, want[2]):
        for et, a in lc.adjs.items():
            assert torch.equal(lg.adjs[et].edge_index.cpu(), a.edge_index), et
            assert torch.equal(lg.adjs[et].e_id.cpu(), a.e_id), et
    assert int(overflow) == int(want[3]) == 0


@pytest.mark.parametrize("mode", ["GPU", "UVA"])
def test_saint_subgraph_card_matches_plain(cuda, mode):
    """The induced subgraph on the card (the (C, D) window read by one K2
    ``gather_rows`` launch, over UVA in UVA mode) against its plain run on
    the CPU, bitwise; and each sampler's launches per draw."""
    from quiver_tpu_torch import (CSRTopo, SAINTEdgeSampler, SAINTNodeSampler,
                                  SAINTRandomWalkSampler)
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop
    from quiver_tpu_torch.ops.kernels.gather import gather_rows
    from quiver_tpu_torch.sampling.saint import saint_subgraph
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(20_000, 20.0, seed=3))
    rng = np.random.default_rng(2)
    nodes = rng.integers(0, 20_000, 4096).astype(np.int32)  # repeats: first wins
    nodes[4000:] = -1
    before = gather_rows.launches
    got = saint_subgraph(topo.to_device(mode, cuda), torch.from_numpy(nodes).to(cuda),
                         4000, 64)
    assert gather_rows.launches - before == 1
    want = saint_subgraph(topo.to_device(mode, "cpu"), torch.from_numpy(nodes), 4000, 64)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(got.num_edges) > 0
    for sampler, k2, k1 in ((SAINTNodeSampler(topo, 1024, device=cuda), 1, 0),
                            (SAINTEdgeSampler(topo, 512, device=cuda), 2, 0),
                            (SAINTRandomWalkSampler(topo, 256, 3, device=cuda), 1, 3)):
        before = (gather_rows.launches, uniform_hop.launches)
        sub = sampler.sample()
        assert (gather_rows.launches - before[0], uniform_hop.launches - before[1]) == (k2, k1)
        valid = sub.node_id[sub.node_id >= 0]
        assert valid.unique().numel() == valid.numel() == int(sub.num_nodes)


def _host_offload_setup(cuda, mode, caps=None):
    from quiver_tpu_torch import CSRTopo, Feature, GraphSageSampler
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(0)
    topo = CSRTopo(edge_index=generate_pareto_graph(20_000, 15.0, seed=0))
    feat = rng.normal(size=(topo.node_count, 32)).astype(np.float32)
    feature = Feature(device_cache_size=2_000 * 32 * 4, csr_topo=topo,
                      device=cuda).from_cpu_tensor(feat)
    sampler = GraphSageSampler(topo, [12, 8], mode=mode, seed_capacity=256, seed=4,
                               frontier_caps=caps or "auto", device=cuda)
    return topo, feature, sampler


def test_host_mode_sampling_equals_hbm_on_card(cuda):
    """The beyond-HBM path's sampler: a HOST-mode topology (K1 reading
    ``indices`` over UVA) samples bitwise as an HBM-mode one with the same
    seed and caps, call after call."""
    _, _, host = _host_offload_setup(cuda, "HOST")
    _, _, hbm = _host_offload_setup(cuda, "HBM")
    assert host.topo.indices.device.type == "cpu" and host.topo.indices.is_pinned()
    rng = np.random.default_rng(1)
    for _ in range(3):
        seeds = rng.integers(0, 20_000, 256)
        a, b = host.sample(seeds), hbm.sample(seeds)
        assert torch.equal(a.n_id, b.n_id) and torch.equal(a.overflow, b.overflow)
        for x, y in zip(a.adjs, b.adjs):
            assert torch.equal(x.edge_index, y.edge_index)
    assert host._frontier_caps == hbm._frontier_caps


def test_data_parallel_step_card_matches_cpu(cuda):
    """One ``DataParallelTrainer.step`` on the card (a HOST-mode batch and
    a tiered lookup) against the same step, batch and weights on a CPU
    mesh: the loss within 1e-5 relative, each gradient within 1e-4 x its
    max |g|."""
    import copy

    from quiver_tpu_torch import Batch, DataParallelTrainer, GraphSAGE, make_mesh
    from quiver_tpu_torch.parallel.train import init_model

    topo, feature, sampler = _host_offload_setup(cuda, "HOST")
    labels = torch.from_numpy(
        np.random.default_rng(2).integers(0, 10, topo.node_count).astype(np.int32))
    model = GraphSAGE(32, 64, 10, num_layers=2, dropout=0.0)
    init_model(model, torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = DataParallelTrainer(make_mesh(devices=[cuda]), sampler, feature,
                                   model.to(cuda),
                                   torch.optim.SGD(model.parameters(), lr=0.0),
                                   local_batch=256)
        seeds = np.arange(200)
        out = sampler.sample(seeds)
        batch = Batch(seeds, out, feature[out.n_id])
        loss_g = float(card.step([batch], labels.to(cuda)))
        grads_g = [p.grad.detach().cpu() for p in model.parameters()]
        host = DataParallelTrainer(make_mesh(devices=["cpu"]), sampler, feature,
                                   cpu_model,
                                   torch.optim.SGD(cpu_model.parameters(), lr=0.0),
                                   local_batch=256)
        cpu_out = out._replace(n_id=out.n_id.cpu(), adjs=[a.to("cpu") for a in out.adjs])
        loss_c = float(host.step([Batch(seeds, cpu_out, batch.x.cpu())], labels))
        grads_c = [p.grad.detach() for p in cpu_model.parameters()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert np.isfinite(loss_g)
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for g, c in zip(grads_g, grads_c):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
