"""The reindex's three dedup strategies through the typed and distributed
samplers, the trainer and a world of processes, on the CPU (the reindex
itself, the replicated sampler and the server: ``tests/test_torch_dedup.py``).

- per strategy, on JAX's draws: ``HeteroGraphSampler`` (the map bounded
  per node type), ``DistGraphSageSampler`` and ``DistHeteroSampler`` on a
  logical ``(1, 2)`` mesh (the map bounded by the global node count), each
  against JAX's with the same strategy;
- one ``DistributedTrainer`` step under ``dedup="map"`` and ``"scan"``
  against its ``"sort"`` step, over a topology-sharded and a replicated
  sampler;
- a ``gloo`` world of 2 (``tests/torch_world_topo_worker.py`` case
  ``dedup``) running the topology-sharded samplers with ``dedup="map"``
  against the logical mesh under ``"map"`` and ``"sort"``.

Tolerance: bitwise throughout (ids, counts and edge lists are integers; a
trainer step over bitwise samples runs the same float ops).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

import torch_world_topo_worker as worker  # noqa: E402
from test_torch_dedup import STRATEGIES  # noqa: E402
from test_torch_dist_hetero import _assert_same_block, jax_dist_hetero_draw_fn  # noqa: E402
from test_torch_dist_sampler import _assert_same_output, jax_dist_draw_fn  # noqa: E402
from test_torch_hetero import SAMPLER_CASES, assert_same_output, both_topos  # noqa: E402
from test_torch_hetero import jax_draw_fn as hetero_draw_fn  # noqa: E402
from test_torch_world import _join, _ref, same  # noqa: E402
from test_torch_world_topo import _spawn  # noqa: E402


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("case", ["uniform_with_eid", "auto_caps_regrowth"])
def test_hetero_sampler_bitwise_jax_same_strategy(case, dedup):
    """``HeteroGraphSampler`` per strategy (the map bounded per node type)
    against JAX's with the same strategy, under JAX's draws; the padded
    entry bitwise the port's sort."""
    topos, sizes, kw, batches = SAMPLER_CASES[case]
    tj, tt = topos()
    sj = qj.HeteroGraphSampler(tj, sizes, "paper", seed=9, dedup=dedup, **kw)
    st = qt.HeteroGraphSampler(tt, sizes, "paper", seed=9, device="cpu", dedup=dedup, **kw)
    assert st.dedup == sj.dedup == dedup
    for call, seeds in enumerate(batches, start=1):
        oj = sj.sample(seeds)
        ot = st.sample(seeds, draw_fn=hetero_draw_fn(st, 9, call))
        assert st._cap_overrides == sj._cap_overrides
        assert_same_output(ot, oj)
    ref = qt.HeteroGraphSampler(tt, sizes, "paper", seed=9, device="cpu", dedup="sort", **kw)
    ref._cap_overrides = st._cap_overrides  # the same planned caps
    padded = torch.full((st._seed_capacity or 128,), -1, dtype=torch.int32)
    padded[:len(batches[-1])] = torch.from_numpy(batches[-1].astype(np.int32))
    got, want = (s.sample_padded(padded, len(batches[-1]),
                                 generator=torch.Generator().manual_seed(2))
                 for s in (st, ref))
    same(got[0], want[0])
    same([[a.edge_index for a in layer.adjs.values()] for layer in got[2]],
         [[a.edge_index for a in layer.adjs.values()] for layer in want[2]])


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("kind,alpha", [("uniform", 0.25), ("weighted", None)])
def test_dist_sampler_bitwise_jax_same_strategy(kind, alpha, dedup):
    """``DistGraphSageSampler`` on a logical ``(1, 2)`` mesh per strategy
    (the map bounded by the global node count) against JAX's."""
    ei = generate_pareto_graph(500, 6.0, seed=0)
    topos = []
    for mod in (qt, qj):
        topo = mod.CSRTopo(edge_index=ei)
        if kind == "weighted":
            topo.set_edge_weight(np.random.default_rng(5).random(topo.edge_count) + 0.1)
        topos.append(topo)
    common = dict(seed=7, seed_capacity=32, topo_sharding="mesh", routed_alpha=alpha,
                  dedup=dedup, weighted=kind == "weighted")
    port = qt.GraphSageSampler(topos[0], [4, 3], mesh=qt.make_mesh(
        data=1, feature=2, devices=["cpu"] * 2), **common)
    jx = qj.GraphSageSampler(topos[1], [4, 3], mesh=make_mesh_j(
        data=1, feature=2, devices=jax.devices()[:2]), **common)
    assert port.dedup == jx.dedup == dedup
    seeds = np.random.default_rng(2).integers(0, 500, 59)
    key = jax.random.PRNGKey(5)
    want = jx.sample(seeds, key=key)
    got = port.sample(seeds, draw_fn=jax_dist_draw_fn(key, kind == "weighted", (4, 3)))
    _assert_same_output(got, want)
    assert int(got.n_count) == int(want.n_count) and int(got.overflow) == int(want.overflow)
    assert got.frontier_counts == want.frontier_counts
    assert np.array_equal(port.last_sample_overflow.numpy(), np.asarray(jx.last_sample_overflow))


@pytest.mark.parametrize("dedup", STRATEGIES)
@pytest.mark.parametrize("weighted", [False, True])
def test_dist_hetero_sampler_bitwise_jax_same_strategy(weighted, dedup):
    """``DistHeteroSampler`` on a logical ``(1, 2)`` mesh per strategy
    against JAX's, worker-major and per worker."""
    tj, tt, _ = both_topos(0, weights=weighted)
    port = qt.DistHeteroSampler(tt, [3, 2], "paper", routed_alpha=0.25, weighted=weighted,
                                seed=0, dedup=dedup,
                                mesh=qt.make_mesh(data=1, feature=2, devices=["cpu"] * 2))
    jx = qj.DistHeteroSampler(tj, [3, 2], "paper", routed_alpha=0.25, weighted=weighted,
                              seed=0, dedup=dedup,
                              mesh=make_mesh_j(data=1, feature=2, devices=jax.devices()[:2]))
    assert port.dedup == jx.dedup == dedup
    seeds = np.arange(48)
    key = jax.random.PRNGKey(7)
    want = jx.sample(seeds, key=key)
    draw = jax_dist_hetero_draw_fn(port, key)
    got = port.sample(seeds, draw_fn=draw)
    _assert_same_block(got, want)
    assert int(got.overflow) == int(want.overflow)
    assert got.frontier_counts == want.frontier_counts
    for got_w, want_w in zip(port.sample_per_worker(seeds, draw_fn=draw),
                             jx.sample_per_worker(seeds, key=key)):
        _assert_same_block(got_w, want_w)


# -- the trainer, and a world of processes ---------------------------------------------


@pytest.mark.parametrize("topo_sharding", ["mesh", "replicated"])
def test_trainer_step_map_and_scan_bitwise_sort(topo_sharding):
    """One ``DistributedTrainer`` step on a logical ``(1, 2)`` mesh (over a
    topology-sharded or a replicated sampler, ``"all"``) under
    ``dedup="map"`` and ``"scan"``: its issued blocks, loss, overflow
    counters and parameters bitwise the ``"sort"`` step's."""
    from quiver_tpu_torch.models.sage import GraphSAGE
    from quiver_tpu_torch.parallel.trainer import DistributedTrainer

    ei, feat, labels = worker.GRAPH
    results = {}
    for dedup in STRATEGIES:
        mesh = qt.make_mesh(data=1, feature=2, devices=["cpu"] * 2)
        topo = qt.CSRTopo(edge_index=ei)
        feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=worker.ALPHA,
                                    **worker.STORES[None]).from_cpu_tensor(feat)
        extra = ({"topo_sharding": "mesh", "mesh": mesh, "routed_alpha": worker.ALPHA}
                 if topo_sharding == "mesh" else {"device": "cpu"})
        sampler = qt.GraphSageSampler(topo, list(worker.SIZES), seed_capacity=worker.LOCAL,
                                      seed=9, dedup=dedup, **extra)
        model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.5)
        trainer = DistributedTrainer(mesh, sampler, feature, model,
                                     torch.optim.Adam(model.parameters(), lr=5e-3),
                                     local_batch=worker.LOCAL, seed_sharding="all",
                                     routed_alpha=worker.ALPHA)
        trainer.init(0)
        issued = []
        issue = trainer._issue
        trainer._issue = lambda *a, issue=issue: issued.append(issue(*a)) or issued[-1]
        seeds = np.random.default_rng(3).integers(0, worker.N, trainer.global_batch)
        loss = trainer.step(seeds, torch.from_numpy(labels.astype(np.int32)), 5)
        results[dedup] = {
            "loss": loss, "params": {k: v.clone() for k, v in model.state_dict().items()},
            "sample_overflow": trainer.last_sample_overflow,
            "routed": trainer.last_routed_overflow,
            "blocks": [(b.n_id, [a.edge_index for a in b.adjs])
                       for s in issued for b in s.blocks]}
    for dedup in ("map", "scan"):
        same(results[dedup], results["sort"], dedup)


@pytest.fixture(scope="module")
def world_pair(tmp_path_factory):
    """A world of 2 ``gloo`` processes on ``(1, 2)`` running the worker's
    ``dedup`` case (rank 0 also runs the logical references)."""
    return _join(_spawn(2, "dedup:12", tmp_path_factory.mktemp("world_dedup")))


@pytest.mark.parametrize("kind", ["uniform", "weighted", "hetero"])
def test_world_map_bitwise_logical(world_pair, kind):
    """Every rank's ``sample()`` (the merged output), its own worker's
    blocks and, for the plain samplers, its ``sample_padded``: bitwise the
    logical mesh's under ``dedup="map"``, which is bitwise its
    ``"sort"``; the capped buckets overflow."""
    res = world_pair
    case = f"dedup12_{kind}"
    own = "own" if kind == "hetero" else "worker"
    for dedup in ("map", "sort"):
        want = _ref(res, case, f"out_{dedup}", 0)
        for w, r in enumerate(res):
            same(r[f"{case}/out"], want, f"{case} {dedup}")
            same(r[f"{case}/{own}"], _ref(res, case, f"{own}_{dedup}", w), f"{case} {dedup}")
    if kind != "hetero":
        assert int(_ref(res, case, "out_map", 0)["hop_overflow"].sum()) > 0
