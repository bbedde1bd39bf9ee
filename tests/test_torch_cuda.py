"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips without a CUDA device. Run on a GPU
machine with ``python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda``.

Tolerance: bitwise (the kernels move integers or bytes; K3's one float
product and compares are the plain version's, op for op). The training
step on the card against the same step on the CPU (TF32 off, dropout 0,
the same parameters and inputs): the loss within 1e-5 relative, each
gradient within 1e-4 x its max |g| (cuBLAS and the CPU's GEMMs sum in
different orders). ``full_neighbor_mean`` on the card against the CPU:
within 1e-5 relative and 1e-6 absolute; HOST against HBM placement:
bitwise. The segment-mean kernel: a float32 table bitwise the CPU's
``index_add_`` path at every width (both add a row's edges one after
another in CSR order), and bitwise the card's chunked, sorted accumulate
at widths of more than 32 floats, where ATen adds each edge to the stored
row; at 32 floats or fewer ATen sums a chunk's run of a row apart and adds
it to the stored row (rows that straddle a chunk) or groups a row's sums
(1 float), so the kernel is held there within the bound of a reordered
sum, 2^-23 x (degree x mean |x| + |mean|) a row. A
bfloat16 or float16 table: bitwise the CPU's float32 path rounded once;
against the card's accumulate over the 16-bit table, which rounds the
running sum to 16 bits after every edge, within 2^-8 x (degree x mean |x|
+ |mean|) a row (each edge's rounding is at most 2^-9 of a running sum,
which is at most the row's sum of |x|). ``DataParallelTrainer.step`` and
a ``DistributedTrainer`` step on the card against the same step on the
CPU: the training step's tolerances. The fused trainer's guard on the
card: bitwise within one run (a skipped step changes nothing); no test
holds two card runs of a float trajectory bitwise (the backward's
scatter-adds use float atomics).
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
    """The HOST placement's kernel reads the edge array over UVA (one
    ``segment_mean`` launch, no K2) and must equal the HBM placement
    bitwise on the card."""
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.models.inference import full_neighbor_mean
    from quiver_tpu_torch.ops.kernels.gather import gather_rows
    from quiver_tpu_torch.ops.kernels.segment import segment_mean
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(5000, 20.0, seed=2))
    x = torch.randn(topo.node_count, 33, device=cuda)
    hbm = full_neighbor_mean(topo, x, chunk=4096, mode="HBM", device=cuda)
    before = gather_rows.launches, segment_mean.launches
    host = full_neighbor_mean(topo, x, chunk=4096, mode="HOST", device=cuda)
    assert (gather_rows.launches, segment_mean.launches) == (before[0], before[1] + 1)
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


def _dequant_once(args):
    """One ``tiered_gather_dequant`` call on ``args``: one launch, bitwise
    its plain version; returns the rows."""
    from quiver_tpu_torch.ops.kernels import gather

    before = gather.tiered_gather_dequant.launches
    got = gather.tiered_gather_dequant(*args)
    want = gather.tiered_gather_plain(*args)
    torch.cuda.synchronize()
    assert gather.tiered_gather_dequant.launches == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    return got


# every case of the granule arithmetic: F = 1 (one code), 7, 15, 17 (rows
# that straddle granules), 16, 100 (float4 stores), 602 (float2 stores, a
# 2 B-aligned row), 1000 (one item filling a slot)
DEQUANT_WIDTHS = [1, 7, 15, 16, 17, 100, 602, 1000]


@pytest.mark.parametrize("F", DEQUANT_WIDTHS)
@pytest.mark.parametrize("store", ["hot", "cold", "split", "split, reorder", "cold, reorder"])
def test_tiered_gather_dequant_matches_plain(cuda, F, store):
    feat, ids = _int8_store(cuda, 1500, F, store, F)
    ids[4:6] = torch.tensor([0, 1499], dtype=torch.int32)  # the first and last rows
    got = _dequant_once((ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold,
                         feat.scale))
    assert torch.equal(feat[ids], got)
    assert not got[ids < 0].any()
    # ids past the table read the row of id N - 1
    assert torch.equal(got[2], got[1]) and torch.equal(got[3], got[1])


def _offset_table(codes, where: str, skip: int):
    """``codes`` copied into a contiguous view that starts ``skip`` bytes
    into a buffer on the card or in pinned host memory: a base that is not
    16 B aligned."""
    n, F = codes.shape
    flat = torch.empty(n * F + skip, dtype=torch.int8)
    flat = flat.pin_memory() if where == "pinned" else flat.to("cuda")
    view = flat[skip:].view(n, F)
    view.copy_(codes)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("F", DEQUANT_WIDTHS)
@pytest.mark.parametrize("layout", ["pinned", "device", "split", "pinned rows[1:]"])
def test_tiered_gather_dequant_unaligned_tables(cuda, F, layout):
    """Code tables whose base is not 16 B aligned: a pinned and a device
    view at byte offset 1, both tiers so, and a pinned ``codes[1:]`` (F
    bytes in: aligned only where 16 divides F)."""
    rng = np.random.default_rng(F)
    n = 700
    codes = torch.from_numpy(rng.integers(-127, 128, (n + 1, F)).astype(np.int8))
    scale = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    if layout == "pinned rows[1:]":
        full = codes.pin_memory()
        hot, cold, hot_rows = None, full[1:], 0
    elif layout == "split":
        hot_rows = n // 3
        hot = _offset_table(codes[1:hot_rows + 1], "device", 1)
        cold = _offset_table(codes[hot_rows + 1:], "pinned", 1)
    else:
        hot_rows = n if layout == "device" else 0
        table = _offset_table(codes[1:], layout, 1)
        hot, cold = (table, None) if layout == "device" else (None, table)
    ids = rng.integers(0, n + 9, 333).astype(np.int32)
    ids[::7] = -1
    ids[1:5] = [0, n - 1, n, 2**31 - 1]
    _dequant_once((torch.from_numpy(ids).to(cuda), None, hot_rows, hot, cold, scale))


@pytest.mark.parametrize("F", [7, 100, 602])
def test_tiered_gather_dequant_loops_the_persistent_grid(cuda, F):
    """More than 2^20 ids: every warp of the persistent grid walks many
    stages; hot, cold, -1 lanes and ids past the table together."""
    feat, _ = _int8_store(cuda, 5000, F, "split, reorder", F)
    rng = np.random.default_rng(F + 1)
    ids = rng.integers(-1, 5010, (1 << 20) + 4099).astype(np.int32)
    ids[:2] = [0, 4999]
    ids = torch.from_numpy(ids).to(cuda)
    _dequant_once((ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold, feat.scale))


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


def _fused_setup(cuda, model, optimizer, **kw):
    """A ``DistributedTrainer`` on the card over ``_host_offload_setup``'s
    HBM graph and tiered store (caps planned by one sample call)."""
    from quiver_tpu_torch import DistributedTrainer, make_mesh

    topo, feature, sampler = _host_offload_setup(cuda, "HBM")
    sampler.sample(np.arange(256))
    labels = torch.from_numpy(
        np.random.default_rng(2).integers(0, 10, topo.node_count).astype(np.int32)).to(cuda)
    trainer = DistributedTrainer(make_mesh(devices=[cuda]), sampler, feature,
                                 model.to(cuda), optimizer, local_batch=256, **kw)
    return trainer, labels


def test_fused_sample_padded_equals_sample_on_card(cuda):
    """``sample_padded`` on padded device seeds is bitwise ``sample`` of
    the same seeds at the same caps and call count, each hop one
    ``uniform_hop`` launch."""
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop

    _, _, planned = _host_offload_setup(cuda, "HBM")
    planned.sample(np.arange(256))
    a, b = (GraphSageSampler(planned.csr_topo, [12, 8], seed_capacity=256, seed=4,
                             frontier_caps=planned._frontier_caps, device=cuda,
                             device_topo=planned.topo) for _ in range(2))
    rng = np.random.default_rng(3)
    for _ in range(3):
        seeds = rng.integers(0, 20_000, 200)
        padded = np.full(256, -1, np.int32)
        padded[:200] = seeds
        want = a.sample(seeds)
        before = uniform_hop.launches
        got = b.sample_padded(torch.from_numpy(padded).to(cuda),
                              torch.tensor(200, device=cuda))
        assert uniform_hop.launches == before + 2
        assert torch.equal(got[0], want.n_id) and torch.equal(got[3], want.overflow)
        for x, y in zip(got[2], want.adjs):
            assert torch.equal(x.edge_index, y.edge_index)


def test_fused_step_card_matches_cpu(cuda):
    """One ``DistributedTrainer`` step on the card (SGD lr 0, dropout 0)
    against the train half of the same step on a CPU trainer, on the
    card's issued block and the same weights: the loss within 1e-5
    relative, each gradient within 1e-4 x its max |g|."""
    import copy

    from quiver_tpu_torch import DistributedTrainer, GraphSAGE, make_mesh
    from quiver_tpu_torch.parallel.train import init_model
    from quiver_tpu_torch.parallel.trainer import fold_key

    model = GraphSAGE(32, 64, 10, num_layers=2, dropout=0.0)
    init_model(model, torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    trainer, labels = _fused_setup(cuda, model, torch.optim.SGD(model.parameters(), lr=0.0))
    blocks = []
    issue = trainer.issue_block
    trainer.issue_block = lambda *a, **kw: blocks.append(issue(*a, **kw)) or blocks[-1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss_g = float(trainer.step(np.arange(200), labels, 9))
        grads_g = [p.grad.detach().cpu() for p in model.parameters()]
        host = DistributedTrainer(make_mesh(devices=["cpu"]), trainer.sampler,
                                  trainer.feature, cpu_model,
                                  torch.optim.SGD(cpu_model.parameters(), lr=0.0),
                                  local_batch=256)
        b = blocks[0]
        loss_c, grads_c = host.train_block(b.n_id.cpu(), b.x.cpu(),
                                           [a.to("cpu") for a in b.adjs],
                                           b.num_seeds.cpu(), labels.cpu(),
                                           fold_key(9, 1, 0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert np.isfinite(loss_g)
    assert abs(loss_g - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for g, c in zip(grads_g, grads_c):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


def test_fused_guard_passes_state_through_on_card(cuda):
    """The guard drill on the card: Adam, NaN rows planned at step 1; that
    step leaves the parameters and Adam's whole state bitwise as they were
    in the same run, and the next step trains."""
    import copy

    from quiver_tpu_torch import FaultPlan, GraphSAGE
    from quiver_tpu_torch.parallel.train import init_model

    model = GraphSAGE(32, 64, 10, num_layers=2)
    init_model(model, torch.Generator().manual_seed(0))
    trainer, labels = _fused_setup(
        cuda, model, torch.optim.Adam(model.parameters(), lr=1e-3), nonfinite_guard=True,
        fault_plan=FaultPlan(nan_feature_steps=(1,)))

    def state():
        return (copy.deepcopy(model.state_dict()),
                copy.deepcopy(trainer.optimizer.state_dict()["state"]))

    rng = np.random.default_rng(5)
    assert np.isfinite(float(trainer.step(rng.integers(0, 20_000, 256), labels, 0)))
    params, opt = state()
    assert not np.isfinite(float(trainer.step(rng.integers(0, 20_000, 256), labels, 1)))
    params_after, opt_after = state()
    assert int(trainer.metrics.value("resilience.skipped_steps")) == 1
    for k in params:
        assert torch.equal(params[k], params_after[k]), k
    for i in opt:
        for k in opt[i]:
            assert torch.equal(opt[i][k], opt_after[i][k]), (i, k)
    assert np.isfinite(float(trainer.step(rng.integers(0, 20_000, 256), labels, 2)))
    assert not torch.equal(model.state_dict()["convs.0.lin_l.weight"],
                           params["convs.0.lin_l.weight"])


def _sharded_setup(cuda, n=20_000, f=32):
    """A three-tier ``ShardedFeature`` on a ``(2, 2)`` logical mesh of the
    card (L0 1,000 rows, L1 4,000, the rest pinned) and a replicated
    ``Feature`` of the same rows (20% hot), over a 20,000-node graph."""
    from quiver_tpu_torch import CSRTopo, Feature, ShardedFeature, make_mesh
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(n, 10.0, seed=8))
    x = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    store = ShardedFeature(make_mesh(data=2, feature=2, devices=[cuda] * 4),
                           device_cache_size=2_000 * f * 4, csr_topo=topo,
                           replicate_budget=1_000 * f * 4).from_cpu_tensor(x)
    replicated = Feature(device_cache_size=(n // 5) * f * 4, csr_topo=topo,
                         device=cuda).from_cpu_tensor(x)
    return topo, x, store, replicated


def test_sharded_gathers_equal_the_replicated_lookup(cuda):
    """The psum and routed gathers (uncapped, planned, a cap of 1 that
    overflows) of a three-tier store on the card: bitwise the replicated
    store's K2 lookup and the numpy rows; K2 launches: one for L0, one per
    shard per feature group, one for the cold rows."""
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    topo, x, store, replicated = _sharded_setup(cuda)
    assert store.cold.is_pinned() and store.rep_rows == 1_000 and store.hot_rows == 4_000
    rng = np.random.default_rng(1)
    ids_np = np.concatenate([rng.integers(0, topo.node_count, 5000), [-1] * 7]).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(cuda)
    want = replicated[ids]
    dense = torch.from_numpy(np.where(ids_np[:, None] >= 0, x[np.maximum(ids_np, 0)], 0)).to(cuda)
    assert torch.equal(want, dense)
    for kw, launches in (({}, 4), ({"routed": True, "routed_cap": None}, 6),
                         ({"routed": True}, 6), ({"routed": True, "routed_cap": 1}, 6)):
        before = gather_rows.launches
        got = store.gather(ids, **kw)
        assert gather_rows.launches == before + launches, kw
        assert torch.equal(got, want), kw
    assert int(store.last_routed_overflow) > 0


def test_sharded_shard_gather_matches_plain(cuda):
    """K2's ``gather_rows`` on each L1 shard, the L0 block and the pinned
    cold rows, with the ids a lookup sends each, bitwise its plain version."""
    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    _, _, store, _ = _sharded_setup(cuda)
    rng = np.random.default_rng(2)
    for table in [store.rep, store.cold, *store.hot.shards]:
        ids = torch.from_numpy(rng.integers(-1, table.shape[0] + 3, 3000).astype(np.int32)).to(cuda)
        assert torch.equal(gather_rows(table, ids), gather_rows_plain(table, ids))


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
def test_sharded_trainer_step_rows_equal_replicated(cuda, seed_sharding):
    """One ``DistributedTrainer`` step on the logical ``(2, 2)`` mesh: its
    workers' ids and gathered rows bitwise the same step's over the
    replicated store; K1 2 launches per worker, K2 4 per feature group."""
    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE, make_mesh
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    topo, _, store, replicated = _sharded_setup(cuda)
    labels = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10, topo.node_count).astype(np.int32)).to(cuda)
    issued = {}
    for name, feat in (("sharded", store), ("replicated", replicated)):
        model = GraphSAGE(32, 64, 10, num_layers=2).to(cuda)
        trainer = DistributedTrainer(
            make_mesh(data=2, feature=2, devices=[cuda] * 4),
            GraphSageSampler(topo, [12, 8], seed=4, device=cuda), feat, model,
            torch.optim.Adam(model.parameters(), lr=1e-3), local_batch=128,
            seed_sharding=seed_sharding)
        trainer.init(0)
        issue = trainer._issue
        issued[name] = []
        trainer._issue = lambda *a, _i=issue, _l=issued[name]: _l.append(_i(*a)) or _l[-1]
        hops, k2 = uniform_hop.launches, gather_rows.launches
        loss = trainer.step(np.random.default_rng(5).integers(0, topo.node_count,
                                                              trainer.global_batch), labels, 9)
        assert np.isfinite(float(loss))
        if name == "sharded":
            assert uniform_hop.launches - hops == 2 * trainer.workers  # [12, 8]: 2 hops
            assert gather_rows.launches - k2 == 4 * trainer.data_size
    for a, b in zip(issued["sharded"][0].blocks, issued["replicated"][0].blocks):
        assert torch.equal(a.n_id, b.n_id) and torch.equal(a.x, b.x)


def _dist_graph(cuda, weighted=False, temporal=False):
    """A 20,000-node Pareto graph (with weights or timestamps) for the
    distributed sampler's card tests."""
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(20_000, 10.0, seed=11))
    rng = np.random.default_rng(12)
    if weighted:
        topo.set_edge_weight(np.exp(rng.normal(size=topo.edge_count)).astype(np.float32))
    if temporal:
        topo.set_edge_time(rng.random(topo.edge_count, dtype=np.float32))
    return topo


@pytest.mark.parametrize("kind", ["uniform", "weighted", "temporal"])
def test_dist_owner_side_kernels_match_plain(cuda, kind, monkeypatch):
    """On a ``(1, 4)`` logical mesh of the card, a capped distributed
    sample (its buckets overflow): every owner-side K1 ``select`` (K3
    ``wselect`` when weighted) bitwise its plain version on the same
    arguments, one launch per owner per hop, and no fused hop launched."""
    from quiver_tpu_torch import GraphSageSampler, make_mesh
    from quiver_tpu_torch.ops.kernels import fused
    from quiver_tpu_torch.sampling import dist

    topo = _dist_graph(cuda, kind == "weighted", kind == "temporal")
    kw = {"weighted": {"weighted": True}, "temporal": {"time_window": (0.25, 0.75)}}.get(kind, {})
    smp = GraphSageSampler(topo, [10, 5], topo_sharding="mesh", routed_alpha=0.5,
                           mesh=make_mesh(data=1, feature=4, devices=[cuda] * 4), **kw)
    checked = []

    def recording(kernel, plain):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            host = [a.cpu() if isinstance(a, torch.Tensor) else
                    (tuple(t.cpu() for t in a) if isinstance(a, tuple) else a) for a in args]
            want = plain(*host, **kwargs)
            checked.append(all(torch.equal(g.cpu(), w) for g, w in zip(out, want)))
            return out
        return call

    name = "wselect" if kind == "weighted" else "select"
    monkeypatch.setattr(dist, name, recording(getattr(fused, name),
                                              getattr(fused, f"{name}_plain")))
    counts = {e: getattr(fused, e).launches for e in ("select", "wselect", "uniform_hop",
                                                      "weighted_hop")}
    smp.sample(np.random.default_rng(3).integers(0, topo.node_count, 4 * 500), key=4)
    launched = {e: getattr(fused, e).launches - c for e, c in counts.items()}
    assert len(checked) == 2 * 4 and all(checked)
    assert launched == {"select": 0 if kind == "weighted" else 8,
                        "wselect": 8 if kind == "weighted" else 0,
                        "uniform_hop": 0, "weighted_hop": 0}
    assert int(smp.last_sample_overflow.sum()) > 0


@pytest.mark.parametrize("kind", ["uniform", "weighted", "temporal"])
def test_dist_sample_on_card_bitwise_replicated(cuda, kind):
    """A ``(1, 4)`` distributed sample on the card (owner-side ``select`` /
    ``wselect``) is bitwise the replicated sampler's (the fused
    ``uniform_hop`` / ``weighted_hop``, the temporal ``select``) on every
    worker's block with the same generator draws."""
    from quiver_tpu_torch import GraphSageSampler, make_mesh
    from quiver_tpu_torch.ops.sample import seeded_generator

    topo = _dist_graph(cuda, kind == "weighted", kind == "temporal")
    kw = {"weighted": {"weighted": True}, "temporal": {"time_window": (0.25, 0.75)}}.get(kind, {})
    dist = GraphSageSampler(topo, [15, 10, 5], topo_sharding="mesh", routed_alpha=0.5,
                            seed_capacity=512,
                            mesh=make_mesh(data=1, feature=4, devices=[cuda] * 4), **kw)
    rep = GraphSageSampler(topo, [15, 10, 5], device=cuda, seed_capacity=512,
                           kernel="pallas", **kw)
    seeds = np.random.default_rng(5).integers(0, topo.node_count, 4 * 500)
    per = dist.sample_per_worker(seeds, key=6)
    for w, blk in enumerate(np.array_split(seeds, 4)):
        padded = torch.full((512,), -1, dtype=torch.int32)
        padded[:len(blk)] = torch.from_numpy(blk.astype(np.int32))
        n_id, _, adjs, *_ = rep.sample_padded(padded.to(cuda), len(blk),
                                              generator=seeded_generator(cuda, 6, w))
        assert torch.equal(per[w].n_id, n_id), w
        assert all(torch.equal(a.edge_index, b.edge_index) for a, b in zip(per[w].adjs, adjs))


def test_dist_trainer_step_on_card_equals_replicated_topology(cuda):
    """One ``DistributedTrainer`` step on the logical ``(2, 2)`` mesh over a
    topology-sharded sampler: K1 ``select`` 2 groups x 2 owners x 2 hops,
    no ``uniform_hop``; every worker's ids and rows bitwise the same step's
    over the replicated topology."""
    from quiver_tpu_torch import DistributedTrainer, Feature, GraphSageSampler, GraphSAGE
    from quiver_tpu_torch import make_mesh
    from quiver_tpu_torch.ops.kernels.fused import select, uniform_hop

    topo = _dist_graph(cuda)
    x = np.random.default_rng(2).normal(size=(topo.node_count, 32)).astype(np.float32)
    feat = Feature(device_cache_size=topo.node_count * 32 * 4, device=cuda).from_cpu_tensor(x)
    labels = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10, topo.node_count).astype(np.int32)).to(cuda)
    issued = {}
    for mode in ("mesh", "replicated"):
        mesh = make_mesh(data=2, feature=2, devices=[cuda] * 4)
        kw = {"topo_sharding": "mesh", "mesh": mesh} if mode == "mesh" else {"device": cuda}
        model = GraphSAGE(32, 64, 10, num_layers=2).to(cuda)
        trainer = DistributedTrainer(mesh, GraphSageSampler(topo, [12, 8], seed=4, **kw),
                                     feat, model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                     local_batch=128, seed_sharding="all")
        trainer.init(0)
        issue = trainer._issue
        issued[mode] = []
        trainer._issue = lambda *a, _i=issue, _l=issued[mode]: _l.append(_i(*a)) or _l[-1]
        sel, hops = select.launches, uniform_hop.launches
        loss = trainer.step(np.random.default_rng(5).integers(0, topo.node_count,
                                                              trainer.global_batch), labels, 9)
        assert np.isfinite(float(loss))
        if mode == "mesh":
            assert (select.launches - sel, uniform_hop.launches - hops) == (2 * 2 * 2, 0)
    for a, b in zip(issued["mesh"][0].blocks, issued["replicated"][0].blocks):
        assert torch.equal(a.n_id, b.n_id) and torch.equal(a.x, b.x)


def _sharded_int8_setup(cuda, n=20_000, f=32):
    """``_sharded_setup``'s store stored as int8 (the scales charged first:
    L0 1,000 rows, L1 4,000, the rest pinned) and the replicated int8
    ``Feature`` of the same rows (every row on the card)."""
    from quiver_tpu_torch import CSRTopo, Feature, ShardedFeature, make_mesh
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    topo = CSRTopo(edge_index=generate_pareto_graph(n, 10.0, seed=8))
    x = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    store = ShardedFeature(make_mesh(data=2, feature=2, devices=[cuda] * 4),
                           device_cache_size=4 * n + 2_000 * f, csr_topo=topo,
                           replicate_budget=1_000 * f, dtype="int8").from_cpu_tensor(x)
    replicated = Feature(device_cache_size=4 * n + n * f, csr_topo=topo, dtype="int8",
                         device=cuda).from_cpu_tensor(x)
    return topo, x, store, replicated


def test_sharded_int8_tiers_match_plain(cuda):
    """K2's ``tiered_gather_dequant`` on the int8 tiers it reads (the L0
    block, the pinned cold rows, the L1 shards' codes with the zero-padded
    L1 scales), with ids past and below the table, bitwise
    ``tiered_gather_plain(..., scale)``, and ``gather_rows`` on each L1
    shard's codes bitwise ``gather_rows_plain``; then every lookup flavour
    bitwise the replicated int8 store's, with exact launch counts (L0 and
    cold one ``tiered_gather_dequant`` each; each shard's codes by
    ``gather_rows`` and one ``tiered_gather_dequant`` after their sum
    (psum) or per feature group after the exchange (routed))."""
    from quiver_tpu_torch.ops.kernels.gather import (gather_rows_plain, tiered_gather_dequant,
                                                     tiered_gather_plain)

    topo, _, store, replicated = _sharded_int8_setup(cuda)
    assert (store.rep_rows, store.hot_rows) == (1_000, 4_000) and store.cold.is_pinned()
    rng = np.random.default_rng(2)
    l1 = torch.cat(store.hot.shards)
    assert store.hot.scale.shape == (l1.shape[0],) and store.hot.scale.is_cuda
    tiers = [(store.rep, store._rep_scales[store.rep.device]),
             (store.cold, store._cold_scale), (l1, store.hot.scale)]
    for table, scale in tiers:
        assert scale.shape == (table.shape[0],) and scale.is_cuda
        ids = torch.from_numpy(rng.integers(-1, table.shape[0] + 3, 3000).astype(np.int32)).to(cuda)
        args = (ids, None, table.shape[0], table, None, scale)
        assert torch.equal(tiered_gather_dequant(*args), tiered_gather_plain(*args))
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    for shard in store.hot.shards:
        ids = torch.from_numpy(rng.integers(-1, shard.shape[0] + 3, 3000).astype(np.int32)).to(cuda)
        assert torch.equal(gather_rows(shard, ids), gather_rows_plain(shard, ids))
    ids = torch.from_numpy(np.concatenate([rng.integers(0, topo.node_count, 5000),
                                           [-1] * 7]).astype(np.int32)).to(cuda)
    want = replicated[ids]
    # L0 and cold one dequantising launch each; psum: the 2 shards' codes
    # by gather_rows, one dequantising launch after their sum; routed: each
    # shard's codes (2 groups x 2 shards), one dequantising launch per group
    # after the exchange
    for kw, launches, codes in (({}, 3, 2), ({"routed": True, "routed_cap": None}, 4, 4),
                                ({"routed": True}, 4, 4),
                                ({"routed": True, "routed_cap": 1}, 4, 4)):
        before = tiered_gather_dequant.launches, gather_rows.launches
        got = store.gather(ids, **kw)
        assert tiered_gather_dequant.launches == before[0] + launches, kw
        assert gather_rows.launches == before[1] + codes, kw
        assert torch.equal(got, want), kw


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_sharded_repin_and_update_bitwise_dense(cuda, dtype):
    """A repinned store (an arbitrary hot set to the front) and then a row
    update in every tier, on the card: every lookup flavour bitwise the
    dense rows (float32) or the unpinned store's rows (int8), and the
    updated rows read back; ``version`` bumped once each."""
    from quiver_tpu_torch import ShardedFeature, make_mesh

    n, f = 20_000, 32
    x = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    mesh = make_mesh(data=2, feature=2, devices=[cuda] * 4)
    kw = ({"device_cache_size": 2_000 * f * 4, "replicate_budget": 1_000 * f * 4}
          if dtype is None else {"device_cache_size": 4 * n + 2_000 * f,
                                 "replicate_budget": 1_000 * f, "dtype": "int8"})
    store = ShardedFeature(mesh, **kw).from_cpu_tensor(x)
    ids = torch.from_numpy(np.random.default_rng(1).integers(-1, n, 6000).astype(np.int32)).to(cuda)
    before = store.gather(ids)
    store.repin(np.random.default_rng(2).choice(n, 3_000, replace=False))
    assert store.version == 1
    for g in ({}, {"routed": True}, {"routed": True, "routed_cap": 1}):
        assert torch.equal(store.gather(ids, **g), before), g
    if dtype is None:
        dense = np.where(ids.cpu().numpy()[:, None] >= 0, x[ids.cpu().numpy().clip(0)], 0)
        assert np.array_equal(before.cpu().numpy(), dense)
    order = store.feature_order.cpu().numpy()
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    upd = np.array([inv[0], inv[1_000], inv[5_000]])
    rows = np.full((3, f), 3.0, np.float32)
    store.apply_row_updates(upd, rows)
    assert store.version == 2
    if dtype is not None:  # the rows read back requantised
        from quiver_tpu_torch.feature.feature import quantize_rows_int8

        q, sc = quantize_rows_int8(rows)
        rows = q.astype(np.float32) * sc[:, None]
    for g in ({}, {"routed": True}):
        got = store.gather(torch.from_numpy(upd.astype(np.int32)).to(cuda), **g)
        assert torch.equal(got, torch.from_numpy(rows).to(cuda)), g


@pytest.mark.parametrize("access", ["mmap", "pread"])
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_ooc_store_k2_over_staged_block_matches_plain(cuda, tmp_path, dtype, access):
    """``MmapFeatureStore`` on the card: each lookup is one K2 launch
    (``tiered_gather``, or ``tiered_gather_dequant`` for int8) over the
    device hot rows and the pinned staged block, bitwise the in-RAM
    ``Feature``'s K2 lookup and K2's plain version on the same ids, table
    and scales, before and after a ``restage``; the staging buffer is
    pinned and reused."""
    from quiver_tpu_torch import CSRTopo, Feature, MmapFeatureStore
    from quiver_tpu_torch.ops.kernels import gather as k2
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n, f = 20_000, 32
    ei = generate_pareto_graph(n, 10.0, seed=8)
    x = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    budget = (4 * n + 2_000 * f) if dtype == "int8" else 2_000 * f * 4
    feat = Feature(device_cache_size=budget, csr_topo=CSRTopo(edge_index=ei), dtype=dtype,
                   device=cuda).from_cpu_tensor(x)
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, x, device_cache_size=budget, csr_topo=CSRTopo(edge_index=ei),
                           dtype=dtype)
    store = MmapFeatureStore(p, access=access, window_rows=256, cache_windows=16,
                             host_cache_rows=500, device=cuda, kernel="pallas")
    entry = k2.tiered_gather_dequant if dtype == "int8" else k2.tiered_gather
    rng = np.random.default_rng(1)
    ptrs = set()
    for step in range(3):
        ids = rng.integers(-1, n + 3, 4096).astype(np.int32)
        if step == 2:
            store.restage(np.arange(0, 4_000, 3))
        before = entry.launches
        got = store[torch.from_numpy(ids).to(cuda)]
        assert entry.launches == before + 1
        assert torch.equal(got, feat[torch.from_numpy(ids).to(cuda)])
        staged = store._staging.rows[:ids.size]
        assert staged.is_pinned()
        ptrs.add(staged.data_ptr())
        t = torch.from_numpy(store._translate(ids).astype(np.int32)).to(cuda)
        k_ids, _, scale = store._launch_args(t, staged)
        plain = k2.tiered_gather_plain(k_ids, None, store.hot_rows, store.hot, staged, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
    assert len(ptrs) == 1 and store.cold_cache_hits_total > 0
    store.close()


def test_ooc_data_parallel_on_card_equals_in_ram(cuda, tmp_path):
    """``DataParallelTrainer`` on the card over the disk-backed store,
    through the Prefetcher's worker thread, gives the in-RAM store's
    epoch losses and parameters bitwise under deterministic kernels, with
    one K2 launch per lookup."""
    from quiver_tpu_torch import (CSRTopo, DataParallelTrainer, Feature, GraphSageSampler,
                                  GraphSAGE, MmapFeatureStore, make_mesh)
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n, f, classes = 20_000, 32, 8
    ei = generate_pareto_graph(n, 10.0, seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, f)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, classes, n).astype(np.int32)).to(cuda)
    budget = 2_000 * f * 4
    idx = rng.integers(0, n, 8 * 256)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for kind in ("ram", "disk"):
            topo = CSRTopo(edge_index=ei)
            if kind == "ram":
                feature = Feature(device_cache_size=budget, csr_topo=topo,
                                  device=cuda).from_cpu_tensor(x)
            else:
                p = str(tmp_path / "rows")
                MmapFeatureStore.write(p, x, device_cache_size=budget, csr_topo=topo)
                feature = MmapFeatureStore(p, access="pread", window_rows=256,
                                           cache_windows=8, device=cuda)
            sampler = GraphSageSampler(topo, [5, 5], seed=3, seed_capacity=128, device=cuda)
            model = GraphSAGE(f, 32, classes, num_layers=2).to(cuda)
            trainer = DataParallelTrainer(make_mesh(data=2, devices=[cuda] * 2), sampler,
                                          feature, model,
                                          torch.optim.SGD(model.parameters(), lr=1e-2),
                                          local_batch=128)
            trainer.init(torch.Generator().manual_seed(0))
            before = tiered_gather.launches
            loss, steps = trainer.train_epoch(idx, labels,
                                              torch.Generator().manual_seed(1),
                                              rng=np.random.default_rng(1), depth=2)
            assert steps == 8 and tiered_gather.launches - before == 16
            runs[kind] = (loss, {k: v.clone() for k, v in model.state_dict().items()})
            if kind == "disk":
                assert feature.stager.readahead_hits_total > 0
                feature.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs["ram"][0] == runs["disk"][0]
    assert all(torch.equal(runs["ram"][1][k], runs["disk"][1][k]) for k in runs["ram"][1])


def test_elastic_step_on_card_mesh_independent(cuda):
    """``DistributedTrainer(logical_workers=4)`` over a topology-sharded
    sampler and a sharded store on the logical meshes ``(1, 4)``, ``(1,
    2)`` and ``(1, 1)`` of the card: two steps' losses and the parameters
    after them bitwise alike under deterministic kernels."""
    from quiver_tpu_torch import (DistributedTrainer, GraphSageSampler, GraphSAGE,
                                  ShardedFeature, make_mesh)

    topo = _dist_graph(cuda)
    x = np.random.default_rng(2).normal(size=(topo.node_count, 32)).astype(np.float32)
    labels = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10, topo.node_count).astype(np.int32)).to(cuda)
    seeds = np.random.default_rng(5).integers(0, topo.node_count, 4 * 128)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fsize in (4, 2, 1):
            mesh = make_mesh(data=1, feature=fsize, devices=[cuda] * fsize)
            store = ShardedFeature(mesh, device_cache_size=2_000 * 32 * 4, csr_topo=topo,
                                   replicate_budget=500 * 32 * 4).from_cpu_tensor(x)
            model = GraphSAGE(32, 64, 10, num_layers=2).to(cuda)
            trainer = DistributedTrainer(
                mesh, GraphSageSampler(topo, [12, 8], seed=4, topo_sharding="mesh", mesh=mesh),
                store, model, torch.optim.Adam(model.parameters(), lr=1e-3), local_batch=128,
                seed_sharding="all", logical_workers=4)
            trainer.init(0)
            assert trainer.blocks_per_device == 4 // fsize
            losses = [trainer.step(seeds, labels, 9 + t) for t in range(2)]
            runs.append((torch.stack(losses), {k: v.clone()
                                               for k, v in model.state_dict().items()}))
    finally:
        torch.use_deterministic_algorithms(False)
    for losses, state in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        assert all(torch.equal(state[k], runs[0][1][k]) for k in state)


def _streaming_delta(ei, n, f, seed=21):
    """A delta of 400 inserts, 100 deletes of live edges and 50 row
    updates over a COO ``ei``; the final COO a rebuild starts from; the
    updated rows."""
    from collections import Counter

    from quiver_tpu_torch import DeltaBatch

    rng = np.random.default_rng(seed)
    ins = rng.integers(0, n, size=(2, 400))
    dele = ei[:, rng.choice(ei.shape[1], 100, replace=False)]
    ids = rng.choice(n, 50, replace=False)
    rows = rng.normal(size=(50, f)).astype(np.float32)
    want = Counter((dele[0] * n + dele[1]).tolist())
    enc = ei[0] * n + ei[1]
    remove = np.zeros(ei.shape[1], bool)
    for pos in np.argsort(ei[0], kind="stable").tolist():
        if want.get(int(enc[pos]), 0) > 0:
            want[int(enc[pos])] -= 1
            remove[pos] = True
    final = np.concatenate([ei[:, ~remove], ins], axis=1)
    delta = DeltaBatch(edge_inserts=ins, edge_deletes=dele, update_ids=ids, update_rows=rows)
    return delta, final, ids, rows


def test_streaming_commit_on_card_equals_rebuild(cuda):
    """A commit on the card's resident state: the topology-sharded
    sampler raises until ``refresh_topology()``, then samples bitwise what
    a sampler over the rebuilt graph samples (K1 ``select`` once per owner
    per hop), and every tier of the sharded store serves the new rows."""
    from quiver_tpu_torch import (CSRTopo, GraphSageSampler, ShardedFeature, StreamingGraph,
                                  VersionMismatchError, make_mesh)
    from quiver_tpu_torch.ops.kernels.fused import select
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n, f = 20_000, 32
    ei = generate_pareto_graph(n, 10.0, seed=11)
    topo = CSRTopo(edge_index=ei)
    x = np.random.default_rng(2).normal(size=(n, f)).astype(np.float32)
    mesh = make_mesh(data=1, feature=4, devices=[cuda] * 4)
    store = ShardedFeature(mesh, device_cache_size=2_000 * f * 4, csr_topo=topo,
                           replicate_budget=500 * f * 4).from_cpu_tensor(x)
    kw = {"seed": 4, "topo_sharding": "mesh", "mesh": mesh}
    sampler = GraphSageSampler(topo, [12, 8], **kw)
    seeds = np.random.default_rng(5).integers(0, n, 512)
    sampler.sample(seeds, key=3)
    delta, final, ids, rows = _streaming_delta(ei, n, f)
    sg = StreamingGraph(topo, feature=store, duplicates="allow")
    assert sg.ingest(delta)
    sg.commit()
    assert (topo.version, store.version) == (1, 1)
    with pytest.raises(VersionMismatchError):
        sampler.sample(seeds, key=3)
    sampler.refresh_topology()
    rebuilt = GraphSageSampler(CSRTopo(edge_index=final), [12, 8], **kw)
    before = select.launches
    out = sampler.sample(seeds, key=3)
    assert select.launches - before == 4 * 2
    ref = rebuilt.sample(seeds, key=3)
    assert torch.equal(out.n_id, ref.n_id)
    for a, b in zip(out.adjs, ref.adjs):
        assert torch.equal(a.edge_index, b.edge_index)
    want = torch.from_numpy(x)
    want[torch.from_numpy(ids)] = torch.from_numpy(rows)
    all_ids = torch.arange(n, device=cuda)
    assert torch.equal(store.gather(all_ids).cpu(), want)
    assert torch.equal(store.gather(all_ids, routed=True).cpu(), want)


def test_streaming_epoch_differential_on_card(cuda):
    """Under deterministic kernels: two steps after a commit and refresh
    on the card bitwise two steps of a trainer built on the rebuilt graph
    and rows from the same state; a commit crashed at ``verify`` leaves
    the next steps bitwise an uncrashed run's."""
    import copy

    from quiver_tpu_torch import (CSRTopo, CommitAborted, DistributedTrainer, GraphSageSampler,
                                  GraphSAGE, ShardedFeature, StreamingGraph, make_mesh)
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    n, f = 20_000, 32
    ei = generate_pareto_graph(n, 10.0, seed=11)
    x = np.random.default_rng(2).normal(size=(n, f)).astype(np.float32)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, 10, n)).to(cuda)
    seeds = np.random.default_rng(5).integers(0, n, 4 * 128)
    delta, final, ids, rows = _streaming_delta(ei, n, f)
    x_final = x.copy()
    x_final[ids] = rows

    def trainer(coo, feats, state=None):
        topo = CSRTopo(edge_index=coo)
        mesh = make_mesh(data=1, feature=4, devices=[cuda] * 4)
        store = ShardedFeature(mesh, device_cache_size=2_000 * f * 4,
                               replicate_budget=500 * f * 4).from_cpu_tensor(feats)
        model = GraphSAGE(f, 64, 10, num_layers=2).to(cuda)
        tr = DistributedTrainer(
            mesh, GraphSageSampler(topo, [12, 8], seed=4, topo_sharding="mesh", mesh=mesh),
            store, model, torch.optim.Adam(model.parameters(), lr=1e-3), local_batch=128,
            seed_sharding="all")
        tr.init(0)
        if state is not None:
            model.load_state_dict(state[0])
            tr.optimizer.load_state_dict(state[1])
        return tr, topo, store

    def steps(tr, first):
        return torch.stack([tr.step(seeds, labels, first + t) for t in range(2)])

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for kind in ("commit", "crash", "none"):
            tr, topo, store = trainer(ei, x)
            steps(tr, 1)
            state = ({k: v.clone() for k, v in tr.model.state_dict().items()},
                     copy.deepcopy(tr.optimizer.state_dict()))
            sg = StreamingGraph(topo, feature=store, duplicates="allow")
            if kind != "none":
                assert sg.ingest(delta)
            if kind == "commit":
                sg.commit()
                tr.refresh()
            if kind == "crash":
                with pytest.raises(CommitAborted):
                    sg.commit(inject_failure="verify")
            runs[kind] = (steps(tr, 7), tr.model.state_dict())
            if kind == "commit":
                reb = trainer(final, x_final, state)[0]
                runs["rebuild"] = (steps(reb, 7), reb.model.state_dict())
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in (("commit", "rebuild"), ("crash", "none")):
        assert torch.equal(runs[a][0], runs[b][0]), (a, b)
        assert all(torch.equal(runs[a][1][k], runs[b][1][k]) for k in runs[a][1])


@pytest.mark.parametrize("weighted", [False, True])
def test_rgcn_stream_sample_padded_card_matches_plain(cuda, weighted):
    """``sample_padded`` on the card with a device ``num_seeds`` (one fused
    K1 or K3 launch per relation per hop, drawn from the generator's
    initial seed) against the plain loop on the CPU over the same raw
    draws: frontiers, counts, every Adj, overflow, bitwise."""
    from quiver_tpu_torch import HeteroGraphSampler
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, weighted_hop
    from quiver_tpu_torch.sampling.hetero import hetero_multilayer_sample

    topo = _hetero_topo(weighted)
    kw = {"weighted": weighted, "with_eid": True, "seed_capacity": 512}
    card = HeteroGraphSampler(topo, [8, 4], "paper", device=cuda, **kw)
    cpu = HeteroGraphSampler(topo, [8, 4], "paper", device="cpu", **kw)
    seeds = np.full(512, -1, np.int32)
    seeds[:500] = np.random.default_rng(4).integers(0, 3000, 500)
    g = torch.Generator(device=cuda)
    g.manual_seed(23)
    num = torch.full((), 500, dtype=torch.int32, device=cuda)
    before = (uniform_hop.launches, weighted_hop.launches)
    got = card.sample_padded(torch.from_numpy(seeds).to(cuda), num, generator=g)
    assert (uniform_hop.launches - before[0], weighted_hop.launches - before[1]) == (
        (0, 5) if weighted else (5, 0))
    card_bits = card._bits_seam(512, (23,))

    def bits(hop, et, shape):
        d = card_bits(hop, et, shape)
        return d.cpu() if weighted else tuple(x.cpu() for x in d)

    want = hetero_multilayer_sample(cpu.dev_topos, torch.from_numpy(seeds), 500, "paper",
                                    cpu._plan(512), bits=bits,
                                    weighted_rels=cpu.weighted_rels, with_eid=True)
    assert all(torch.equal(got[0][t].cpu(), want[0][t]) for t in want[0])
    assert all(int(got[1][t]) == int(want[1][t]) for t in want[1])
    for lg, lc in zip(got[2], want[2]):
        for et, a in lc.adjs.items():
            assert torch.equal(lg.adjs[et].edge_index.cpu(), a.edge_index), et
            assert torch.equal(lg.adjs[et].e_id.cpu(), a.e_id), et
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("weighted", [False, True])
def test_rgcn_stream_no_sync_under_debug_mode(cuda, weighted):
    """``hetero_stream_steps`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read in 4 R-GCN
    steps (sample, lookup, labels, forward, backward, Adam), exactly 5
    hops and 3 ``tiered_gather`` launches a step, finite losses."""
    from quiver_tpu_torch import HeteroFeature, HeteroGraphSampler, RGCN
    from quiver_tpu_torch.models.rgcn import rgcn_schema
    from quiver_tpu_torch.ops.kernels import launch_counts
    from quiver_tpu_torch.parallel.train import (hetero_stream_steps, init_model,
                                                 make_train_step)

    topo = _hetero_topo(weighted)
    sampler = HeteroGraphSampler(topo, [8, 4], "paper", seed_capacity=256,
                                 frontier_caps="auto", weighted=weighted, device=cuda)
    rng = np.random.default_rng(5)
    out = sampler.sample(rng.integers(0, 3000, 256))  # plans the caps
    feats = {t: rng.normal(size=(n, 16)).astype(np.float32) for t, n in topo.num_nodes.items()}
    feature = HeteroFeature.from_cpu_tensors(feats, device_cache_size="1G", device=cuda)
    model = RGCN(rgcn_schema(out.adjs, {t: 16 for t in feats}), 8, 4, "paper")
    init_model(model, torch.Generator().manual_seed(0))
    model.to(cuda)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-3))
    labels = torch.from_numpy(rng.integers(0, 4, 3000)).to(cuda)
    seed_mat = torch.from_numpy(rng.integers(0, 3000, (4, 256)).astype(np.int32)).to(cuda)
    num = torch.full((), 256, dtype=torch.int32, device=cuda)
    hetero_stream_steps(sampler, feature, labels, step, seed_mat, num, 0)  # warm-up
    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, overflow = hetero_stream_steps(sampler, feature, labels, step, seed_mat, num, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = launch_counts()
    hop = "weighted_hop" if weighted else "uniform_hop"
    assert after[hop] - before[hop] == 5 * 4
    assert after["tiered_gather"] - before["tiered_gather"] == 3 * 4
    assert bool(torch.isfinite(losses).all()) and losses.shape == (4,)
    assert int(overflow) >= 0


def test_kernel_attrs_entry(cuda):
    """Every kernel library's ``quiver_kernel_attrs``: each ``__global__``
    instantiation with its ``cudaFuncGetAttributes`` and launch block, each
    within Hopper's limits (the audit's vmem-budget rule)."""
    from quiver_tpu_torch.ops.kernels.build import kernel_attrs
    from quiver_tpu_torch.tools.audit.mem import DEFAULT_VMEM_BUDGET, REGISTERS_PER_SM

    attrs = kernel_attrs()
    entries = {a["entry"] for a in attrs}
    assert entries == {"select", "uniform_hop", "gather", "gather_dequant", "wselect",
                       "weighted_hop", "segment_mean"}
    assert len(attrs) == 35
    # only the int8 entry's ring asks for dynamic shared memory
    assert {a["kernel"] for a in attrs if a["shared_dynamic"]} == {
        f"gather_dequant_kernel<{s}>" for s in (4, 2, 1)}
    for a in attrs:
        assert a["block"] == 256 and 0 < a["regs"] <= 255, a
        assert a["shared_static"] + a["shared_dynamic"] <= DEFAULT_VMEM_BUDGET, a
        assert a["regs"] * a["block"] <= REGISTERS_PER_SM, a
        assert a["block"] <= a["max_threads"], a


@pytest.fixture(scope="module")
def audit_cache():
    from quiver_tpu_torch.tools.audit import audit_targets

    yield audit_targets
    audit_targets.clear_cache()


@pytest.mark.parametrize("name", ["routed_gather", "tiered_lookup_int8", "sample_hop",
                                  "epoch_body_alpha1", "serve_sample", "pallas_fused_interp",
                                  "mmap_tiered_gather"])
def test_audit_kernel_nodes_card_equal_cpu(cuda, audit_cache, name):
    """A target recorded on the card has the kernel nodes of its CPU
    recording: the same entries, shapes and dtypes, in order; and no rule
    finds anything on the card."""
    from quiver_tpu_torch.tools.audit import ir
    from quiver_tpu_torch.tools.audit.runner import run_audit

    card = ir.kernel_nodes(audit_cache.build(name, "cuda").program)
    cpu = ir.kernel_nodes(audit_cache.build(name, "cpu").program)
    assert card == cpu and card
    result = run_audit(targets=[name], device="cuda")
    assert result.findings == []
    assert not [f for f in result.suppressed if f.rule == "vmem-budget"]


def test_audit_mem_cuda_column(cuda, audit_cache, capsys):
    """``--mem-table --mem-cuda``: the card's measured growth joins every
    row, within the stated band of the estimate."""
    from quiver_tpu_torch.tools.audit.cli import main

    assert main(["--mem-table", "--mem-cuda", "--targets",
                 "routed_gather,mmap_tiered_gather,serve_forward"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "cuda-grow" in out[0] and len(out) == 4
    lo, hi = audit_cache.PEAK_BAND
    for line in out[1:]:
        ratio = float(line.split()[-1])
        assert lo <= ratio <= hi, line


@pytest.mark.parametrize("seed_sharding,dtype", [("all", None), ("data", "int8")])
def test_world_of_one_over_nccl_equals_logical(cuda, tmp_path, seed_sharding, dtype):
    """A world of one rank over ``nccl`` (``init_distributed`` through a
    file store, the world mesh ``(1, 1)``): 3 ``DistributedTrainer`` steps
    over a three-tier store, the routed f32 and the psum int8 flavours,
    bitwise the logical ``(1, 1)`` mesh's on the same card under
    deterministic kernels (losses, tier hits and parameters), every
    collective on CUDA tensors; then ``DataParallelTrainer`` steps alike."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.models.sage import GraphSAGE
    from quiver_tpu_torch.parallel import world
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    from torch_world_worker import GRAPH, SIZES, STORES

    ei, feat, labels = GRAPH
    labels = torch.from_numpy(labels.astype(np.int32)).to(cuda)

    def sharded_run(mesh):
        topo = qt.CSRTopo(edge_index=ei)
        store = qt.ShardedFeature(mesh, csr_topo=topo, dtype=dtype, kernel="pallas",
                                  **STORES[dtype]).from_cpu_tensor(feat)
        model = GraphSAGE(4, 16, 4, num_layers=2).to(cuda)
        trainer = qt.DistributedTrainer(
            mesh, qt.GraphSageSampler(topo, list(SIZES), device=cuda, seed=9,
                                      kernel="pallas"),
            store, model, torch.optim.Adam(model.parameters(), lr=5e-3), local_batch=32,
            seed_sharding=seed_sharding, routed_alpha=0.05, nonfinite_guard=True)
        trainer.init(0)
        rng = np.random.default_rng(3)
        out = [(trainer.step(rng.integers(0, 300, trainer.global_batch), labels, 5 + t),
                trainer.last_tier_hits.clone()) for t in range(3)]
        return out, dict(model.state_dict())

    def dp_run(mesh):
        topo = qt.CSRTopo(edge_index=ei)
        store = qt.Feature(device_cache_size=1600, csr_topo=topo, device=cuda,
                           kernel="pallas").from_cpu_tensor(feat)
        model = GraphSAGE(4, 16, 4, num_layers=2).to(cuda)
        trainer = qt.DataParallelTrainer(
            mesh, qt.GraphSageSampler(topo, list(SIZES), device=cuda, seed=4,
                                      kernel="pallas"),
            store, model, torch.optim.Adam(model.parameters(), lr=5e-3), local_batch=32)
        trainer.init(torch.Generator().manual_seed(0))
        loss = trainer.train_epoch(np.arange(96), labels, torch.Generator().manual_seed(7),
                                   depth=0)
        return loss, dict(model.state_dict())

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cuda")
        try:
            wmesh = qt.make_mesh(data=1, feature=1)
            world.reset_calls()
            got, got_dp = sharded_run(wmesh), dp_run(wmesh)
            calls = dict(world.CALLS)
        finally:
            shutdown_distributed()
        lmesh = qt.make_mesh(data=1, feature=1, devices=[cuda])
        want, want_dp = sharded_run(lmesh), dp_run(lmesh)
    finally:
        torch.use_deterministic_algorithms(False)
    assert calls and all(dev == "cuda" for _, dev in calls)
    for (a, ha), (b, hb) in zip(got[0], want[0]):
        assert torch.equal(a, b) and torch.equal(ha, hb)
    assert all(torch.equal(got[1][k], v) for k, v in want[1].items())
    assert got_dp[0] == want_dp[0]
    assert all(torch.equal(got_dp[1][k], v) for k, v in want_dp[1].items())


def _world_topo_trainer(mesh, cuda, weighted=False, **kw):
    """The topology-sharded trainer of ``tests/torch_world_topo_worker.py``
    on ``mesh``, over the card: a topology-sharded sampler (uniform or
    weighted) and a three-tier store, routed alpha 0.05, the guard on."""
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.models.sage import GraphSAGE

    from torch_world_topo_worker import topo_of
    from torch_world_worker import GRAPH, LOCAL, SIZES, STORES

    topo = topo_of("weighted" if weighted else "uniform")
    store = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05, kernel="pallas",
                              **STORES[None]).from_cpu_tensor(GRAPH[1])
    sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  topo_sharding="mesh", mesh=mesh, routed_alpha=0.05,
                                  weighted=weighted, kernel="pallas")
    model = GraphSAGE(4, 16, 4, num_layers=2).to(cuda)
    trainer = qt.DistributedTrainer(mesh, sampler, store, model,
                                    torch.optim.Adam(model.parameters(), lr=5e-3),
                                    local_batch=LOCAL, seed_sharding="all", routed_alpha=0.05,
                                    nonfinite_guard=True, **kw)
    trainer.init(0)
    return trainer


@pytest.mark.parametrize("weighted", [False, True])
def test_world_of_one_topo_sharded_equals_logical(cuda, tmp_path, weighted):
    """A world of one rank over ``nccl``: 3 steps of the topology-sharded
    trainer (uniform or weighted) bitwise the logical ``(1, 1)`` mesh's on
    the card under deterministic kernels (losses, tier hits, routed and
    per-hop overflow, parameters), the owner side launching K1 ``select``
    (K3 ``wselect``) once per hop in both forms, the rank's topology shard
    on the card, every collective on CUDA tensors."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.ops.kernels.fused import select, wselect
    from quiver_tpu_torch.parallel import world
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    from torch_world_worker import GRAPH, SIZES

    labels = torch.from_numpy(GRAPH[2].astype(np.int32)).to(cuda)
    entry = wselect if weighted else select

    def run(mesh):
        trainer = _world_topo_trainer(mesh, cuda, weighted)
        assert all(t.is_cuda for t in trainer.sampler.topo.indices)
        rng = np.random.default_rng(3)
        before = entry.launches
        out = [(trainer.step(rng.integers(0, 300, trainer.global_batch), labels, 5 + t),
                trainer.last_tier_hits.clone(), trainer.last_routed_overflow.clone(),
                trainer.last_sample_overflow.clone()) for t in range(3)]
        torch.cuda.synchronize()
        return out, dict(trainer.model.state_dict()), entry.launches - before

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cuda")
        try:
            world.reset_calls()
            got = run(qt.make_mesh(data=1, feature=1))
            calls = dict(world.CALLS)
        finally:
            shutdown_distributed()
        want = run(qt.make_mesh(data=1, feature=1, devices=[cuda]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert calls and all(dev == "cuda" for _, dev in calls)
    for a, b in zip(got[0], want[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(got[1][k], v) for k, v in want[1].items())
    assert got[2] == want[2] == 3 * len(SIZES)


def test_world_checkpoint_resume_across_two_worlds(cuda, tmp_path):
    """``logical_workers=4`` on a world of one over ``nccl``: a 9-step epoch
    checkpointed every 3 steps and preempted at step 3; the group torn
    down; a second world of one (a new file store) builds a fresh trainer
    and resumes with ``resume(mesh=trainer.mesh)``: its 6 remaining losses
    and the final parameters bitwise the uninterrupted logical ``(1, 4)``
    run's, under deterministic kernels."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from quiver_tpu_torch.resilience import FaultPlan, Preemption

    from torch_world_worker import GRAPH

    labels = torch.from_numpy(GRAPH[2].astype(np.int32)).to(cuda)
    ckpt = str(tmp_path / "ckpt")

    def elastic(mesh, **kw):
        return _world_topo_trainer(mesh, cuda, logical_workers=4, **kw)

    def matrix(trainer):
        return trainer.pack_epoch(np.random.default_rng(9).integers(
            0, 300, 9 * trainer.global_batch), seed=6)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = elastic(qt.make_mesh(data=1, feature=4, devices=[cuda] * 4))
        full = ref.epoch_scan(matrix(ref), labels, 23)
        final = dict(ref.model.state_dict())
        init_distributed(f"file://{tmp_path / 'store1'}", 1, 0, device="cuda")
        try:
            first = elastic(qt.make_mesh(data=1, feature=1), checkpoint_dir=ckpt,
                            checkpoint_every=3, fault_plan=FaultPlan(preempt_at_step=3))
            with pytest.raises(Preemption):
                first.epoch_scan(matrix(first), labels, 23)
            first.checkpointer.close()
        finally:
            shutdown_distributed()
        init_distributed(f"file://{tmp_path / 'store2'}", 1, 0, device="cuda")
        try:
            fresh = elastic(qt.make_mesh(data=1, feature=1), checkpoint_dir=ckpt,
                            checkpoint_every=3)
            _, _, key, step, epoch = fresh.resume(mesh=fresh.mesh)
            tail = fresh.epoch_scan(matrix(fresh), labels, key, epoch=epoch, start_step=step)
            fresh.checkpointer.close()
        finally:
            shutdown_distributed()
    finally:
        torch.use_deterministic_algorithms(False)
    assert step == 3 and torch.equal(tail, full[3:])
    assert all(torch.equal(v, final[k]) for k, v in fresh.model.state_dict().items())


@pytest.mark.parametrize("seed_sharding,topo_sharding", [("data", "replicated"),
                                                         ("all", "mesh")])
def test_world_of_one_tuners_equal_logical(cuda, tmp_path, seed_sharding, topo_sharding):
    """A world of one rank over ``nccl`` with the tuners on: ``auto_alpha``
    from 0.05, ``CacheController(heat_bins=16, repin_min_gain=0)`` and an
    int8 ``auto_split`` store re-split to 15 L0 rows; 3 steps, a 3-step
    ``epoch_scan`` whose end repins, a commit of row updates in every tier,
    ``refresh`` and one more step, bitwise the logical ``(1, 1)`` mesh's on
    the card under deterministic kernels (losses, alpha, the split, the
    order, the version, the decision list, the fresh rows and the
    parameters), every collective on CUDA tensors; the split tuner moved
    the boundary."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.models.sage import GraphSAGE
    from quiver_tpu_torch.parallel import world
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from quiver_tpu_torch.streaming import DeltaBatch, StreamingGraph

    from torch_world_worker import GRAPH, LOCAL, SIZES, STORES

    ei, feat, labels = GRAPH
    labels = torch.from_numpy(labels.astype(np.int32)).to(cuda)

    def run(mesh):
        topo = qt.CSRTopo(edge_index=ei)
        store = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05, dtype="int8",
                                  kernel="pallas", auto_split=True,
                                  **STORES["int8"]).from_cpu_tensor(feat)
        where = ({"device": cuda} if topo_sharding == "replicated" else
                 {"topo_sharding": "mesh", "mesh": mesh, "routed_alpha": 0.05})
        sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                      kernel="pallas", **where)
        model = GraphSAGE(4, 16, 4, num_layers=2).to(cuda)
        trainer = qt.DistributedTrainer(
            mesh, sampler, store, model, torch.optim.Adam(model.parameters(), lr=5e-3),
            local_batch=LOCAL, seed_sharding=seed_sharding, routed_alpha=0.05,
            auto_alpha=True, replicate_budget=15 * 4,
            controller=qt.CacheController(heat_bins=16, repin_min_gain=0.0))
        trainer.init(0)
        rng = np.random.default_rng(3)
        losses, states = [], []
        for t in range(3):
            losses.append(trainer.step(rng.integers(0, 300, trainer.global_batch), labels, 5 + t))
            states.append((trainer.routed_alpha, store.rep_rows, store.version))
        mat = trainer.pack_epoch(rng.integers(0, 300, 3 * trainer.global_batch), seed=2)
        losses.append(trainer.epoch_scan(mat, labels, 11))
        states.append((trainer.routed_alpha, store.rep_rows, store.version))
        order = store.feature_order.clone()
        graph = StreamingGraph(topo, feature=store)
        ids = np.array([0, 150, 299])
        assert graph.ingest(DeltaBatch(update_ids=ids, update_rows=np.full((3, 4), 2.0,
                                                                           np.float32)))
        graph.commit()
        trainer.refresh()
        fresh = store.gather(torch.from_numpy(ids).to(cuda))
        losses.append(trainer.step(rng.integers(0, 300, trainer.global_batch), labels, 20))
        states.append((trainer.routed_alpha, store.rep_rows, store.version))
        torch.cuda.synchronize()
        return (losses, states, order, fresh, list(trainer.controller.decisions),
                dict(model.state_dict()))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cuda")
        try:
            world.reset_calls()
            got = run(qt.make_mesh(data=1, feature=1))
            calls = dict(world.CALLS)
        finally:
            shutdown_distributed()
        want = run(qt.make_mesh(data=1, feature=1, devices=[cuda]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert calls and all(dev == "cuda" for _, dev in calls)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == want[1] and got[4] == want[4]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert all(torch.equal(got[5][k], v) for k, v in want[5].items())
    assert got[1][3][2] == 1 and got[1][4][2] == 2  # the epoch's repin, then the commit
    # the split tuner moved the boundary from its 15 rows (re-placing L0 and L1)
    assert any(d["decision"] == "split" for d in got[4]) and {s[1] for s in got[1]} != {15}
    assert (got[3] - 2.0).abs().max() <= 2.0 / 127  # one int8 code step
    if seed_sharding == "all":
        assert got[1][-1][0] > 0.05


def test_dedup_auto_is_sort_on_the_card(cuda, monkeypatch):
    """``resolve_dedup("auto")`` reads ``"sort"`` where a CUDA device is
    present (the CPU's is ``"map"``, the JAX package's), and a sampler on
    the card holds it."""
    from quiver_tpu_torch import CSRTopo, GraphSageSampler
    from quiver_tpu_torch.ops import reindex

    monkeypatch.setattr(reindex, "_forced_dedup", None)
    monkeypatch.setattr(reindex, "_auto_dedup", None)
    monkeypatch.delenv("QUIVER_DEDUP", raising=False)
    assert reindex.resolve_dedup("auto") == "sort"
    topo = CSRTopo(edge_index=np.random.default_rng(0).integers(0, 50, (2, 400)))
    assert GraphSageSampler(topo, [3], device=cuda).dedup == "sort"


@pytest.mark.parametrize("dedup", ["map", "scan"])
def test_dedup_strategies_bitwise_on_card(cuda, dedup):
    """``masked_unique`` on the card under map or scan (leading rows,
    forced seeds, overflow) bitwise the CPU's sort, and a sampler's own
    draws under it bitwise a sort sampler's on the card."""
    from quiver_tpu_torch import CSRTopo, GraphSageSampler
    from quiver_tpu_torch.ops.reindex import masked_unique
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 3000, (5, 900)).astype(np.int32))
    valid = torch.from_numpy(rng.random((5, 900)) < 0.85)
    kw = {"node_bound": 3000} if dedup == "map" else {"scatter_free": True}
    want = masked_unique(ids, valid, 400, 16)
    got = masked_unique(ids.to(cuda), valid.to(cuda), 400, 16, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    topo = CSRTopo(edge_index=generate_pareto_graph(5000, 8.0, seed=1))
    seeds = rng.integers(0, 5000, 300)
    a, b = (GraphSageSampler(topo, [10, 5], device=cuda, seed=2, dedup=d).sample(seeds)
            for d in ("sort", dedup))
    assert torch.equal(a.n_id, b.n_id) and int(a.n_count) == int(b.n_count)
    for x, y in zip(a.adjs, b.adjs):
        assert torch.equal(x.edge_index, y.edge_index)


def _segment_graph(seed: int, n: int = 3000):
    """A CSR over ``utils/graphgen.py``'s Pareto graph of ``n`` nodes with
    five zero-degree rows inserted after row 100, a row of degree 20,000
    (past 2^14) after them, and three zero-degree rows at the end: int64
    ``indptr`` and int32 ``indices`` into an ``n``-row table."""
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(seed)
    topo = CSRTopo(edge_index=generate_pareto_graph(n, 12.0, seed=seed))
    indptr, indices = topo.indptr.astype(np.int64), topo.indices.astype(np.int32)
    cut = int(indptr[100])
    long_row = rng.integers(0, n, 20_000).astype(np.int32)
    deg = np.concatenate([np.diff(indptr)[:100], [0] * 5, [long_row.shape[0]],
                          np.diff(indptr)[100:], [0] * 3])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = np.concatenate([indices[:cut], long_row, indices[cut:]])
    return torch.from_numpy(indptr), torch.from_numpy(indices)


def _segment_table(seed: int, n: int, F: int):
    """``(n, F)`` float32 rows over six decades, so that a sum's bits
    depend on its order of adds."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)) * 10.0 ** rng.uniform(-3, 3, (n, 1))
    return torch.from_numpy(x.astype(np.float32))


SEGMENT_CHUNK = 4096  # edges per accumulate of the references: many rows straddle


def _within_reordering(got, want, ptr, ids, tab):
    """Two orders of a float32 row sum of n terms differ by at most
    2^-23 x n x (their sum of |x|), and each mean's division rounds once:
    |got - want| <= 2^-23 x (degree x mean |x| + |want|), row by row."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean_plain

    deg = (ptr[1:] - ptr[:-1]).clamp(min=1).to(tab.dtype)[:, None]
    abs_mean = segment_mean_plain(ptr, ids, tab.abs())
    return bool(((got - want).abs() <= 2.0**-23 * (deg * abs_mean + want.abs())).all())


@pytest.mark.parametrize("F", [32, 100, 256, 602])
def test_segment_mean_bitwise_the_chunked_accumulate(cuda, F):
    """float32 at the widths the passes use: one launch, bitwise the CPU's
    ``index_add_`` path and the card's chunked, sorted ``index_put_``
    accumulate and divide (the long row and the zero-degree rows
    included). At more than 32 floats the accumulate adds each edge to the
    stored row, so rows that straddle its chunks are bitwise too; at 32 or
    fewer it sums a chunk's run from zero and adds that to the stored row,
    so only they differ, within the bound of a reordered sum."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean, segment_mean_plain

    indptr, indices = _segment_graph(F)
    table = _segment_table(F, 3000, F)
    ptr, ids, tab = indptr.to(cuda), indices.to(cuda), table.to(cuda)
    starts = indptr[:-1].numpy()
    assert int((np.diff(indptr.numpy()) == 0).sum()) >= 8
    assert int(np.diff(indptr.numpy()).max()) > 2**14
    assert any(s // SEGMENT_CHUNK != (e - 1) // SEGMENT_CHUNK
               for s, e in zip(starts, indptr[1:].numpy()) if e - s < 100)
    before = segment_mean.launches
    got = segment_mean(ptr, ids, tab)
    torch.cuda.synchronize()
    assert segment_mean.launches == before + 1
    assert got.shape == (indptr.shape[0] - 1, F) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), segment_mean_plain(indptr, indices, table, SEGMENT_CHUNK))
    assert torch.equal(got, segment_mean_plain(ptr, ids, tab))  # one chunk
    want = segment_mean_plain(ptr, ids, tab, SEGMENT_CHUNK)
    if F > 32:
        assert torch.equal(got, want)
    else:
        ends = indptr[1:].numpy()
        straddle = torch.from_numpy(starts // SEGMENT_CHUNK != (ends - 1) // SEGMENT_CHUNK)
        straddle &= torch.from_numpy(ends > starts)
        assert torch.equal(got[~straddle.to(cuda)], want[~straddle.to(cuda)])
        assert _within_reordering(got, want, ptr, ids, tab)
    assert not got[100:105].any()


@pytest.mark.parametrize("F,offset", [(1, 0), (3, 0), (100, 1), (256, 2)])
def test_segment_mean_narrow_and_unaligned_widths(cuda, F, offset):
    """Widths of 1 and 3 floats, and tables that start 4 or 8 B past an
    aligned address (narrower words): bitwise the CPU's path, and within
    the bound of a reordered sum of the card's accumulate (which may group
    a narrow row's sums)."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean, segment_mean_plain

    indptr, indices = _segment_graph(F + 7)
    table = _segment_table(F, 3000, F)
    flat = torch.zeros(3000 * F + offset, device=cuda)
    tab = flat[offset:].view(3000, F)
    tab.copy_(table)
    assert tab.is_contiguous() and tab.data_ptr() % 16 == 4 * offset
    ptr, ids = indptr.to(cuda), indices.to(cuda)
    got = segment_mean(ptr, ids, tab)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), segment_mean_plain(indptr, indices, table, SEGMENT_CHUNK))
    want = segment_mean_plain(ptr, ids, tab, SEGMENT_CHUNK)
    assert _within_reordering(got, want, ptr, ids, tab)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("F", [3, 100, 256])
def test_segment_mean_16bit_tables(cuda, dtype, F):
    """A bfloat16 or float16 table: a float32 sum rounded once, bitwise the
    CPU's float32 path over the same values, rounded; against the card's
    accumulate over the 16-bit table, within the module's bound."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean, segment_mean_plain

    indptr, indices = _segment_graph(F + 11)
    ptr, ids = indptr.to(cuda), indices.to(cuda)
    table = torch.from_numpy(np.random.default_rng(F).normal(
        size=(3000, F)).astype(np.float32)).to(cuda).to(dtype)
    got = segment_mean(ptr, ids, table)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    want = segment_mean_plain(indptr, indices, table.float().cpu()).to(dtype)
    assert torch.equal(got.cpu(), want)
    today = segment_mean_plain(ptr, ids, table, SEGMENT_CHUNK).float()
    deg = (ptr[1:] - ptr[:-1]).clamp(min=1).float()[:, None]
    abs_mean = segment_mean_plain(ptr, ids, table.float().abs())
    bound = 2.0**-8 * (deg * abs_mean + got.float().abs())
    assert bool(((got.float() - today).abs() <= bound).all())


def test_segment_mean_host_ids_equal_device_ids(cuda):
    """The ids in pinned host memory (HOST, read over UVA) give the same
    rows bitwise as the ids on the card (HBM)."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean

    indptr, indices = _segment_graph(5)
    tab = _segment_table(5, 3000, 100).to(cuda)
    ptr = indptr.to(cuda)
    hbm = segment_mean(ptr, indices.to(cuda), tab)
    host = segment_mean(ptr, indices.pin_memory(), tab)
    torch.cuda.synchronize()
    assert torch.equal(host, hbm)


@pytest.mark.parametrize("mode", ["HBM", "HOST"])
def test_sage_pass_on_card_bitwise_the_chunked_accumulate(cuda, monkeypatch, mode):
    """``sage_layerwise_inference`` on the card: exactly ``layers``
    ``segment_mean`` launches and no K2, and log-probs bitwise the same
    pass with its mean taken by the chunked, sorted accumulate (the pass
    as it ran before the kernel)."""
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.models import inference
    from quiver_tpu_torch.models.sage import GraphSAGE
    from quiver_tpu_torch.ops.kernels import launch_counts
    from quiver_tpu_torch.ops.kernels.segment import segment_mean_plain
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        topo = CSRTopo(edge_index=generate_pareto_graph(20_000, 25.0, seed=7))
        torch.manual_seed(7)
        model = GraphSAGE(100, 256, 47, num_layers=3, dropout=0.0).to(cuda).eval()
        x = torch.randn(topo.node_count, 100, device=cuda)
        before = launch_counts()
        got = inference.sage_layerwise_inference(model, topo, x, mode=mode, device=cuda)
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "segment_mean": 3}
        monkeypatch.setattr(inference, "segment_mean", segment_mean_plain)
        want = inference.sage_layerwise_inference(model, topo, x, chunk=1 << 16, mode=mode,
                                                  device=cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_segment_mean_refuses_what_it_cannot_take(cuda):
    """An integer table, a non-contiguous table, an ``indptr`` on another
    device, ids in pageable host memory, int64 ids: ``ValueError``."""
    from quiver_tpu_torch.ops.kernels.segment import segment_mean

    indptr, indices = _segment_graph(9)
    ptr, ids = indptr.to(cuda), indices.to(cuda)
    tab = torch.randn(3000, 8, device=cuda)
    cases = {"dtype": (ptr, ids, tab.to(torch.int32)),
             "contiguous": (ptr, ids, torch.randn(8, 3000, device=cuda).t()),
             "indptr on the host": (indptr, ids, tab),
             "pageable ids": (ptr, indices, tab),
             "int64 ids": (ptr, ids.long(), tab)}
    for what, args in cases.items():
        with pytest.raises(ValueError):
            segment_mean(*args)
            pytest.fail(what)
