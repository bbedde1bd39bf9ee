"""``DistributedTrainer`` of quiver_tpu_torch over a topology-sharded sampler
(``GraphSageSampler(topo_sharding="mesh")``) against quiver_tpu's, on the
CPU, and the port's own contracts of ``tests/test_sharded_topology.py``'s
trainer tests.

JAX runs its fused step in ``shard_map`` on the forced host devices, a
``(data=2, feature=2)`` mesh under ``seed_sharding="all"``; the port runs
each feature group's two workers together, one routed hop at a time
(``DistGraphSageSampler.sample_group``), on one CPU device. Both sides get
the same draws (``draw_fn`` replays JAX's key chain,
``tests/test_torch_fused_trainer.py``), the same initial parameters
(``models/convert.py``) and dropout 0. The store is a three-tier
``ShardedFeature`` or a replicated ``Feature``.

Tolerances, float32:
- one step's loss: 1e-5 relative; the parameters after it (SGD 0.1):
  within 1e-6 absolute and 1e-5 relative (the frameworks order their float
  sums differently; ``tests/test_torch_fused_trainer.py``'s bars);
- the per-hop overflow, tier hits and routed overflow: equal integers;
- the port against itself (replicated topology, depth 1, a resumed
  epoch): bitwise (one device, the same ops on the same ids and rows).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.feature import Feature as FeatureJ  # noqa: E402
from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402

from test_torch_fused_trainer import SIZES, _cpu_mesh, _labeled_graph, jax_draw_fn  # noqa: E402

LOCAL = 32
ROW_B = 4 * 4  # float32 rows of the planted graph's 4 features
STORE = {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B}
ALPHA = 0.25  # tight enough that the hops' buckets overflow


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


def _seeds(n, global_batch):
    return np.random.default_rng(3).integers(0, n, global_batch)


@pytest.fixture(scope="module", params=["sharded", "replicated"])
def jax_run(request, graph):
    """JAX's fused trainer on a (2, 2) mesh over a topology-sharded
    sampler and a three-tier sharded (or a replicated) store, SGD 0.1: the
    initial parameters, one step's loss, its metrics and the parameters
    after it."""
    ei, feat, labels = graph
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    if request.param == "sharded":
        feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=ALPHA,
                                  **STORE).from_cpu_tensor(feat)
    else:
        feature = FeatureJ(device_cache_size=100 * ROW_B, csr_topo=topo).from_cpu_tensor(feat)
    sampler = qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  topo_sharding="mesh", mesh=mesh)
    trainer = TrainerJ(mesh, sampler, feature,
                       SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all",
                       routed_alpha=ALPHA)
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    seeds = _seeds(topo.node_count, trainer.global_batch)
    params, _, loss = trainer.step(params, opt, seeds, jnp.asarray(labels.astype(np.int32)),
                                   jax.random.PRNGKey(5))
    return {"store": request.param, "params0": params0, "loss": float(loss), "seeds": seeds,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "sample_overflow": np.asarray(trainer.last_sample_overflow).tolist(),
            "hits": np.asarray(trainer.last_tier_hits).tolist(),
            "routed_overflow": int(np.asarray(trainer.last_routed_overflow))}


def _port_trainer(graph, store="sharded", topo_sharding="mesh", params0=None,
                  optimizer="sgd", mesh=None, **kw):
    """The port's trainer on a (2, 2) CPU mesh under ``"all"`` over a
    topology-sharded (or replicated) sampler and a three-tier sharded (or
    replicated) store."""
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    mesh = mesh or _cpu_mesh(2, 2)
    if store == "sharded":
        feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=ALPHA,
                                    **STORE).from_cpu_tensor(feat)
    else:
        feature = qt.Feature(device_cache_size=100 * ROW_B, csr_topo=topo,
                             device="cpu").from_cpu_tensor(feat)
    extra = ({"topo_sharding": "mesh", "mesh": mesh, "routed_alpha": ALPHA}
             if topo_sharding == "mesh" else {"device": "cpu"})
    sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9, **extra)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    trainer = DistributedTrainer(mesh, sampler, feature, model, opt, local_batch=LOCAL,
                                 seed_sharding="all", routed_alpha=ALPHA, **kw)
    trainer.init(0)
    if params0 is not None:
        model.load_state_dict(flax_sage_to_state_dict(params0))
    return trainer


def _labels(graph):
    return torch.from_numpy(graph[2].astype(np.int32))


def test_step_equals_jax(graph, jax_run):
    """One step on JAX's draws and parameters: the loss, the per-hop
    overflow vector (the tight buckets overflow and the fallback serves
    them), the tier hits and routed overflow, then every parameter."""
    trainer = _port_trainer(graph, jax_run["store"], params0=jax_run["params0"])
    trainer.draw_fn = jax_draw_fn
    loss = trainer.step(jax_run["seeds"], _labels(graph), 5)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-5)
    assert trainer.last_sample_overflow.tolist() == jax_run["sample_overflow"]
    assert sum(jax_run["sample_overflow"]) > 0
    assert trainer.last_tier_hits.tolist() == jax_run["hits"]
    assert int(trainer.last_routed_overflow) == jax_run["routed_overflow"]
    want = flax_sage_to_state_dict(jax_run["params"])
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _steps(trainer, graph, steps=3):
    """``steps`` steps on fixed seeds; each step's issued blocks kept."""
    blocks = []
    issue = trainer._issue
    trainer._issue = lambda *a: blocks.append(issue(*a)) or blocks[-1]
    rng = np.random.default_rng(7)
    n = trainer.sampler.csr_topo.node_count
    losses = [trainer.step(rng.integers(0, n, trainer.global_batch), _labels(graph), t)
              for t in range(steps)]
    return losses, blocks


@pytest.mark.parametrize("store", ["sharded", "replicated"])
def test_trajectory_bitwise_replicated_topology(graph, store):
    """The port's trajectory contract (JAX's
    ``test_trainer_loss_trajectory_parity``): three Adam steps over the
    topology-sharded sampler, its buckets overflowing, are the replicated
    topology's bitwise: ids, rows, losses and parameters."""
    runs = {}
    for topo_sharding in ("mesh", "replicated"):
        trainer = _port_trainer(graph, store, topo_sharding, optimizer="adam")
        losses, blocks = _steps(trainer, graph)
        runs[topo_sharding] = (losses, blocks, trainer.model.state_dict(),
                               trainer.last_sample_overflow)
    (la, ba, pa, oa), (lb, bb, pb, ob) = runs["mesh"], runs["replicated"]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for sa, sb in zip(ba, bb):
        assert len(sa.blocks) == len(sb.blocks) == 4
        for a, b in zip(sa.blocks, sb.blocks):
            assert torch.equal(a.n_id, b.n_id) and torch.equal(a.x, b.x)
            assert all(torch.equal(x.edge_index, y.edge_index) for x, y in zip(a.adjs, b.adjs))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert int(oa.sum()) > 0 and not ob.any()


def _epoch(trainer, graph, **kw):
    n = trainer.sampler.csr_topo.node_count
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, n, 4 * trainer.global_batch),
                             seed=2)
    return mat, trainer.epoch_scan(mat, _labels(graph), 11, **kw)


def test_depth1_and_resume_bitwise_depth0(graph, tmp_path):
    """``epoch_scan`` over the sharded sampler keeps a ``(steps, L)``
    per-hop overflow matrix; depth 1 gives depth 0's losses, metrics and
    parameters bitwise; a run preempted after step 3 resumes from its
    step-2 checkpoint and ends bitwise the uninterrupted run."""
    runs = {}
    for depth in (0, 1):
        trainer = _port_trainer(graph, optimizer="adam", pipeline_depth=depth)
        mat, losses = _epoch(trainer, graph)
        runs[depth] = (losses, trainer.last_sample_overflow, trainer.last_tier_hits,
                       trainer.model.state_dict())
    (l0, s0, h0, p0), (l1, s1, h1, p1) = runs[0], runs[1]
    assert s0.shape == (4, 2) and int(s0.sum()) > 0 and bool(torch.isfinite(l0).all())
    assert torch.equal(l0, l1) and torch.equal(s0, s1) and torch.equal(h0, h1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    first = _port_trainer(graph, optimizer="adam", checkpoint_dir=tmp_path / "ck",
                          checkpoint_every=2, fault_plan=qt.FaultPlan(preempt_at_step=3))
    with pytest.raises(qt.Preemption):
        first.epoch_scan(mat, _labels(graph), 11)
    again = _port_trainer(graph, optimizer="adam", checkpoint_dir=tmp_path / "ck",
                          checkpoint_every=2)
    _, _, key, step, epoch = again.resume()
    assert (key, step, epoch) == (11, 2, 0)
    rest = again.epoch_scan(mat, _labels(graph), key, epoch=epoch, start_step=step)
    assert torch.equal(rest, l0[2:])
    got = again.model.state_dict()
    assert all(torch.equal(p0[k], got[k]) for k in p0)


def test_constructor_checks_match_jax(graph):
    """JAX's three checks, with JAX's messages: ``seed_sharding="all"``,
    the sampler's mesh is the trainer's, its axis is ``"feature"``."""
    ei, feat, _ = graph
    topo_t, topo_j = qt.CSRTopo(edge_index=ei), qj.CSRTopo(edge_index=ei)
    mesh_t = _cpu_mesh(2, 2)
    mesh_j = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    other_t = _cpu_mesh(1, 4)
    other_j = make_mesh_j(data=1, feature=4, devices=jax.devices()[:4])
    model_t = GraphSAGE(4, 8, 4, num_layers=2)
    model_j = SageJ(hidden=8, num_classes=4, num_layers=2)
    feat_t = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(feat)
    feat_j = FeatureJ(device_cache_size="1M").from_cpu_tensor(feat)
    cases = [({}, {"seed_sharding": "data"}), ({}, {"other": True}),
             ({"axis": "data"}, {})]
    for sampler_kw, trainer_kw in cases:
        msgs = []
        for mod, topo, mesh, other, build in (
                (qt, topo_t, mesh_t, other_t, lambda m, s: DistributedTrainer(
                    m, s, feat_t, model_t, torch.optim.SGD(model_t.parameters(), lr=0.1),
                    local_batch=8, seed_sharding=trainer_kw.get("seed_sharding", "all"))),
                (qj, topo_j, mesh_j, other_j, lambda m, s: TrainerJ(
                    m, s, feat_j, model_j, optax.sgd(0.1), local_batch=8,
                    seed_sharding=trainer_kw.get("seed_sharding", "all")))):
            sampler = mod.GraphSageSampler(topo, [4, 3], topo_sharding="mesh", mesh=mesh,
                                           **sampler_kw)
            with pytest.raises(ValueError) as err:
                build(other if trainer_kw.get("other") else mesh, sampler)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], (sampler_kw, trainer_kw)
