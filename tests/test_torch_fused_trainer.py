"""``DistributedTrainer`` of quiver_tpu_torch (``parallel/trainer.py``)
against quiver_tpu's, on the CPU: the contracts of
``tests/test_distributed.py``'s fused-trainer tests against the JAX
package itself, where the two can be compared (one step, the seed
packing, the constructor's checks, the guard's counters).

The port's own epoch contracts (``tests/test_resilience.py``'s and
``tests/test_pipelined_epoch.py``'s: depth 1, the guard, checkpoints and
resume, each against the serial run) are in
``tests/test_torch_fused_epoch.py``.

JAX runs its mesh on the forced host devices; the port runs the same
workers in turn on one CPU device (a mesh whose device repeats). Both
sides of a step get the same sample draws: the port's ``draw_fn`` replays
JAX's key chain (``fold_in(key, worker)``, the first ``split`` of that
for the sample stream, one ``split`` per layer, then the stratum and
rotation keys), with flax's parameters carried across by
``models/convert.py`` and dropout 0.

Tolerances, float32:
- one step's loss: 1e-5 relative (the two frameworks order their float
  sums differently);
- the parameters after one SGD step at lr 0.1: within 1e-6 absolute and
  1e-5 relative;
- seed matrices, tier hits, guard counters and error messages: bitwise;
- learning: the loss after 25 steps below 0.75x the first step's, JAX's
  own bar; an int8 store's first loss within 5% of the float32 store's,
  JAX's bar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.feature import Feature as FeatureJ  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED  # noqa: E402
from quiver_tpu.ops.sample import rotate_offsets, stratified_offsets  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402

SIZES = (4, 3)
LOCAL = 32


def _labeled_graph(n=400, classes=4, seed=0):
    """``tests/test_distributed.py``'s planted graph: class-homophilous
    edges, one-hot features with noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    feat = np.eye(classes, dtype=np.float32)[labels] * 2.0
    feat += rng.normal(scale=0.8, size=(n, classes)).astype(np.float32)
    rows, cols = [], []
    for c in range(classes):
        members = np.where(labels == c)[0]
        rows.extend(rng.choice(members, 6 * len(members)))
        cols.extend(rng.choice(members, 6 * len(members)))
    return np.stack([np.asarray(rows), np.asarray(cols)]), feat, labels


def _cpu_mesh(data, feature=1):
    return qt.make_mesh(data=data, feature=feature, devices=["cpu"] * (data * feature))


def jax_draw_fn(key, w, layer, deg):
    """Worker ``w``'s hop ``layer`` offsets in JAX's fused step keyed
    ``PRNGKey(key)`` (``issue_block``: the sample stream is the first
    ``split`` of ``fold_in(key, w)``; ``multilayer_sample`` splits once
    per layer; a uniform hop splits into its stratum and rotation keys)."""
    sample_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(key), w))[0]
    for _ in range(layer + 1):
        sample_key, sub = jax.random.split(sample_key)
    kj, kr = jax.random.split(sub)
    d = jnp.asarray(deg.numpy())
    off, _ = stratified_offsets(kj, d, SIZES[layer])
    return torch.from_numpy(np.array(rotate_offsets(kr, off, d, SIZES[layer])))


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


@pytest.fixture(scope="module")
def jax_run(graph):
    """The JAX trainer on 2 data workers over a tiered store (half the
    rows hot), SGD 0.1, the guard on and NaN rows planned at step 1: its
    initial parameters, step 0 (clean) and step 1 (poisoned)."""
    ei, feat, labels = graph
    topo = qj.CSRTopo(edge_index=ei)
    n = topo.node_count
    feature = FeatureJ(device_cache_size=(n // 2) * 4 * 4,
                       csr_topo=topo).from_cpu_tensor(feat)
    trainer = TrainerJ(make_mesh_j(data=2, feature=1, devices=jax.devices()[:2]),
                       qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9),
                       feature, SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, nonfinite_guard=True,
                       fault_plan=qj.FaultPlan(nan_feature_steps=(1,), nan_rows=4))
    params, opt = trainer.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    seeds = [rng.permutation(n)[: 2 * LOCAL - 5] for _ in range(2)]
    lab = jnp.asarray(labels.astype(np.int32))
    p1, o1, loss0 = trainer.step(params, opt, seeds[0], lab, jax.random.PRNGKey(5))
    hits0 = np.asarray(trainer.last_tier_hits)
    p2, _, loss1 = trainer.step(p1, o1, seeds[1], lab, jax.random.PRNGKey(6))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params0": as_np(params), "params1": as_np(p1), "params2": as_np(p2),
            "loss0": float(loss0), "loss1": float(loss1), "hits0": hits0,
            "skipped": int(np.asarray(trainer.metrics.value(GUARD_SKIPPED))),
            "nonfinite": int(np.asarray(trainer.metrics.value(GUARD_NONFINITE))),
            "seeds": seeds}


def _port_twin(graph, params0, **kw):
    """The port's counterpart of ``jax_run``'s trainer, holding JAX's
    initial parameters and replaying its draws."""
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    n = topo.node_count
    feature = qt.Feature(device_cache_size=(n // 2) * 4 * 4, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    trainer = DistributedTrainer(
        _cpu_mesh(2), qt.GraphSageSampler(topo, list(SIZES), device="cpu",
                                          seed_capacity=LOCAL, seed=9),
        feature, model, torch.optim.SGD(model.parameters(), lr=0.1),
        local_batch=LOCAL, **kw)
    trainer.init(0)  # the sampler call of JAX's init, then JAX's parameters
    model.load_state_dict(flax_sage_to_state_dict(params0))
    trainer.draw_fn = jax_draw_fn
    return trainer


def _assert_params(model, params_j):
    want = flax_sage_to_state_dict(params_j)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_step_equals_jax(graph, jax_run):
    """One fused step of two workers on JAX's draws and parameters: the
    loss, the per-tier hits, then every parameter after one SGD step."""
    trainer = _port_twin(graph, jax_run["params0"])
    labels = torch.from_numpy(graph[2].astype(np.int32))
    loss = trainer.step(jax_run["seeds"][0], labels, 5)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jax_run["loss0"], rtol=1e-5)
    hits = trainer.last_tier_hits
    np.testing.assert_array_equal(hits.numpy(), jax_run["hits0"])
    assert hits[1] > 0 and hits[2] > 0  # both tiers served this step
    _assert_params(trainer.model, jax_run["params1"])


def test_guard_counters_equal_jax(graph, jax_run):
    """The poisoned step 1 with the guard on: skipped on both sides, the
    same non-finite count, the parameters bit-unchanged (JAX's too)."""
    trainer = _port_twin(graph, jax_run["params0"], nonfinite_guard=True,
                         fault_plan=qt.FaultPlan(nan_feature_steps=(1,), nan_rows=4))
    labels = torch.from_numpy(graph[2].astype(np.int32))
    trainer.step(jax_run["seeds"][0], labels, 5)
    assert int(trainer.metrics.value(GUARD_SKIPPED)) == 0
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss1 = trainer.step(jax_run["seeds"][1], labels, 6)
    assert np.isnan(float(loss1)) and np.isnan(jax_run["loss1"])
    assert int(trainer.metrics.value(GUARD_SKIPPED)) == jax_run["skipped"] == 1
    assert int(trainer.metrics.value(GUARD_NONFINITE)) == jax_run["nonfinite"] > 0
    for name, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[name]), name
    for a, b in zip(jax.tree_util.tree_leaves(jax_run["params1"]),
                    jax.tree_util.tree_leaves(jax_run["params2"])):
        np.testing.assert_array_equal(a, b)
    report = trainer.metrics_report()
    assert GUARD_SKIPPED in report and GUARD_NONFINITE in report


def _pair(graph, data, feature, local, seed_sharding="data"):
    """A JAX trainer (never initialised: nothing compiles) and the port's,
    of the same geometry."""
    ei, feat, _ = graph
    topo_j = qj.CSRTopo(edge_index=ei)
    trainer_j = TrainerJ(
        make_mesh_j(data=data, feature=feature, devices=jax.devices()[:data * feature]),
        qj.GraphSageSampler(topo_j, [3], seed=0, seed_capacity=local),
        FeatureJ(device_cache_size="1M").from_cpu_tensor(feat),
        SageJ(hidden=8, num_classes=4, num_layers=1), optax.sgd(0.1),
        local_batch=local, seed_sharding=seed_sharding)
    topo = qt.CSRTopo(edge_index=ei)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    trainer = DistributedTrainer(
        _cpu_mesh(data, feature),
        qt.GraphSageSampler(topo, [3], device="cpu", seed=0, seed_capacity=local),
        qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(feat),
        model, torch.optim.SGD(model.parameters(), lr=0.1), local_batch=local,
        seed_sharding=seed_sharding)
    return trainer_j, trainer


@pytest.mark.parametrize("data,feature,local,seed_sharding,n_idx", [
    (4, 2, 8, "data", 100), (4, 2, 8, "all", 100), (2, 1, 32, "data", 300),
    (1, 1, 64, "data", 257)])
def test_pack_epoch_and_shard_seeds_equal_jax(graph, data, feature, local,
                                              seed_sharding, n_idx):
    trainer_j, trainer = _pair(graph, data, feature, local, seed_sharding)
    assert trainer.workers == trainer_j.workers
    assert trainer.global_batch == trainer_j.global_batch
    train_idx = np.random.default_rng(n_idx).integers(0, 300, n_idx)
    for seed in (7, 0, None, np.array([0, 7], np.uint32)):
        got = trainer.pack_epoch(train_idx, seed=seed)
        want = trainer_j.pack_epoch(train_idx, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want), seed
    assert np.array_equal(trainer.pack_epoch(train_idx, key=3),
                          trainer_j.pack_epoch(train_idx, key=3))
    packed = trainer.shard_seeds(np.arange(20))
    assert packed.dtype == np.int32
    assert np.array_equal(packed, trainer_j.shard_seeds(np.arange(20)))


def test_shard_seeds_packing(graph):
    """``test_shard_seeds_packing``: valid-prefix blocks, -1 padded, every
    seed once; an overfull block raises."""
    _, trainer = _pair(graph, 4, 2, 8)
    blocks = trainer.shard_seeds(np.arange(20)).reshape(4, 8)
    for b in blocks:
        valid = b[b >= 0]
        assert np.all(b[: len(valid)] == valid)
    assert np.array_equal(np.sort(blocks[blocks >= 0]), np.arange(20))
    with pytest.raises(ValueError, match="exceeds local_batch"):
        trainer.shard_seeds(np.arange(4 * 8 + 4))


def _build_both(graph, tmp_path=None, **kw):
    """Construct a trainer of each package with ``kw``; return the two
    exceptions' messages (or None for a package that accepted)."""
    ei, feat, _ = graph
    msgs = []
    for side in ("jax", "torch"):
        try:
            if side == "jax":
                topo = qj.CSRTopo(edge_index=ei)
                TrainerJ(make_mesh_j(data=2, feature=1, devices=jax.devices()[:2]),
                         qj.GraphSageSampler(topo, [3], seed=0, seed_capacity=8),
                         FeatureJ(device_cache_size="1M").from_cpu_tensor(feat),
                         SageJ(hidden=8, num_classes=4, num_layers=1), optax.sgd(0.1),
                         local_batch=8, **kw)
            else:
                topo = qt.CSRTopo(edge_index=ei)
                model = GraphSAGE(4, 8, 4, num_layers=1)
                DistributedTrainer(
                    _cpu_mesh(2), qt.GraphSageSampler(topo, [3], device="cpu", seed=0,
                                                      seed_capacity=8),
                    qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(feat),
                    model, torch.optim.SGD(model.parameters(), lr=0.1), local_batch=8,
                    **kw)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


@pytest.mark.parametrize("kw,match", [
    ({"seed_sharding": "rows"}, "seed_sharding"),
    ({"routed_alpha": 0.0}, "routed_alpha"),
    ({"routed_alpha": -1.0}, "routed_alpha"),
    ({"pipeline_depth": 2}, "pipeline_depth"),
    ({"pipeline_depth": -1}, "pipeline_depth"),
    ({"checkpoint_dir": "CK", "checkpoint_every": 0}, "checkpoint_every"),
    ({"checkpoint_every": 4}, "nothing to write"),
])
def test_constructor_errors_equal_jax(graph, tmp_path, kw, match):
    if "checkpoint_dir" in kw:
        kw = {**kw, "checkpoint_dir": tmp_path / "ck"}
    msg_j, msg = _build_both(graph, **kw)
    assert msg is not None and msg == msg_j and match in msg


def test_trainer_takes_a_sharded_feature(graph):
    """A ``ShardedFeature`` on the trainer's mesh is taken (its step is
    held against JAX's in ``tests/test_torch_sharded_trainer.py``)."""
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    mesh = _cpu_mesh(2, 2)
    feature = qt.ShardedFeature(mesh, device_cache_size="1M").from_cpu_tensor(feat)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    trainer = DistributedTrainer(
        mesh, qt.GraphSageSampler(topo, [3], device="cpu", seed=0, seed_capacity=8),
        feature, model, torch.optim.SGD(model.parameters(), lr=0.1), local_batch=8,
        seed_sharding="all")
    trainer.init(0)
    loss = trainer.step(np.arange(32), torch.from_numpy(graph[2].astype(np.int32)), 0)
    assert np.isfinite(float(loss)) and trainer.last_tier_hits.tolist()[1] > 0


def test_mesh_sampler_requires_all_seed_sharding(graph):
    """A topology-sharded sampler under the default ``seed_sharding="data"``
    raises JAX's ``ValueError`` (each feature group would route one
    frontier F times); the other checks are in
    ``tests/test_torch_topo_sharded_trainer.py``."""
    ei, feat, _ = graph
    mesh = _cpu_mesh(2)
    sampler = qt.GraphSageSampler(qt.CSRTopo(edge_index=ei), [3], seed=0, seed_capacity=8,
                                  topo_sharding="mesh", mesh=mesh)
    feature = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(feat)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    with pytest.raises(ValueError, match="requires seed_sharding='all'"):
        DistributedTrainer(mesh, sampler, feature, model,
                           torch.optim.SGD(model.parameters(), lr=0.1), local_batch=8)


@pytest.mark.parametrize("what", ["logical_workers", "auto_alpha", "controller",
                                  "two_devices"])
def test_unported_features_raise(graph, what):
    """A mesh of two distinct devices builds and steps (A.11e (b)), and a
    device that cannot compute (``meta``) is refused by ``make_mesh``.
    ``logical_workers``, ported with A.11d, needs ``seed_sharding="all"``
    (JAX's ``ValueError``) and then runs two blocks a slot.
    ``auto_alpha=True`` and a ``controller``, ported with A.11c, now build
    over a replicated store: ``auto_alpha`` makes an alpha-only controller
    (no heat feed), and a controller is not attached to a ``Feature``, as
    in the JAX package."""
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    sampler = qt.GraphSageSampler(topo, [3], device="cpu", seed=0, seed_capacity=8)
    feature = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(feat)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    mesh, kw = _cpu_mesh(2), {}
    if what == "two_devices":
        with pytest.raises(ValueError, match="meta"):
            qt.make_mesh(devices=["cpu", "meta"])
        mesh = qt.make_mesh(devices=["cpu:0", "cpu:1"])
    else:
        kw = {"logical_workers": {"logical_workers": 4}, "auto_alpha": {"auto_alpha": True},
              "controller": {"controller": qt.CacheController()}}[what]

    def build():
        return DistributedTrainer(mesh, sampler, feature, model,
                                  torch.optim.SGD(model.parameters(), lr=0.1),
                                  local_batch=8, **kw)

    if what == "two_devices":
        trainer = build()
        trainer.init(0)
        loss = trainer.step(np.arange(16), torch.from_numpy(graph[2].astype(np.int32)), 3)
        assert trainer.device == torch.device("cpu", 0) and torch.isfinite(loss)
        return
    if what == "logical_workers":
        with pytest.raises(ValueError, match="requires seed_sharding='all'"):
            build()
        kw["seed_sharding"] = "all"
        trainer = build()
        assert (trainer.elastic, trainer.workers, trainer.blocks_per_device) == (True, 4, 2)
        return
    trainer = build()
    assert trainer.controller is not None and not hasattr(feature, "_controller")
    assert trainer.controller.wants_heat == (what == "controller")
    assert trainer.auto_alpha == (what == "auto_alpha")


def _learning_trainer(graph_n400, mesh, seed_sharding="data", dtype=None, local=64,
                      mode="HBM", budget="1G", hidden=32):
    ei, feat, _ = graph_n400
    topo = qt.CSRTopo(edge_index=ei)
    sampler = qt.GraphSageSampler(topo, [5, 5], device="cpu", seed=3, mode=mode,
                                  seed_capacity=local)
    feature = qt.Feature(device_cache_size=budget, dtype=dtype, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat[:topo.node_count])
    model = GraphSAGE(4, hidden, 4, num_layers=2)
    trainer = DistributedTrainer(mesh, sampler, feature, model,
                                 torch.optim.Adam(model.parameters(), lr=5e-3),
                                 local_batch=local, seed_sharding=seed_sharding)
    trainer.init(0)
    return trainer


@pytest.fixture(scope="module")
def graph400():
    return _labeled_graph()


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
def test_fused_training_learns(graph400, seed_sharding):
    """``test_fused_training_learns``: a (4, 2) mesh, Adam 5e-3, 25
    steps; the last loss below 0.75x the first."""
    trainer = _learning_trainer(graph400, _cpu_mesh(4, 2), seed_sharding)
    assert trainer.global_batch == (512 if seed_sharding == "all" else 256)
    n = trainer.sampler.csr_topo.node_count
    labels = torch.from_numpy(graph400[2][:n].astype(np.int32))
    rng = np.random.default_rng(0)
    losses = [float(trainer.step(rng.integers(0, n, trainer.global_batch), labels, s))
              for s in range(25)]
    assert losses[-1] < losses[0] * 0.75, losses


def test_fused_beyond_hbm_epoch_scan_learns(graph400):
    """``test_fused_beyond_hbm_epoch_scan_learns``: a HOST-mode topology
    and a store with half its rows cold, one 8-step epoch."""
    ei, feat, _ = graph400
    n = int(ei.max()) + 1
    trainer = _learning_trainer(graph400, _cpu_mesh(4, 2), mode="HOST",
                                budget=(n // 2) * 4 * 4)
    assert trainer.feature.cold is not None
    assert 0.3 < trainer.feature.cache_ratio < 0.7
    labels = torch.from_numpy(graph400[2][:n].astype(np.int32))
    train_idx = np.random.default_rng(0).integers(0, n, 8 * trainer.global_batch)
    losses = trainer.epoch_scan(trainer.pack_epoch(train_idx, seed=7), labels, 42)
    assert losses.shape == (8,) and bool(torch.isfinite(losses).all())
    hits = trainer.last_tier_hits
    assert hits.shape == (8, 3) and bool((hits[:, 2] > 0).all())
    assert losses[-1] < losses[0] * 0.75, losses


def test_fused_int8_feature_dequantizes(graph400):
    """``test_fused_int8_feature_dequantizes``: the first step's loss over
    an int8 store within 5% of the float32 store's (raw codes, about 127x
    the scale, would blow it apart)."""
    first = {}
    for dtype in (None, "int8"):
        trainer = _learning_trainer(graph400, _cpu_mesh(4, 2), "all", dtype=dtype,
                                    local=32, hidden=16)
        n = trainer.sampler.csr_topo.node_count
        labels = torch.from_numpy(graph400[2][:n].astype(np.int32))
        seeds = np.random.default_rng(0).integers(0, n, trainer.global_batch)
        first[dtype] = float(trainer.step(seeds, labels, 1))
    assert abs(first["int8"] - first[None]) < 0.05 * abs(first[None]), first


def test_seed_sharding_all_equals_data_on_feature_1(graph):
    """On a ``feature=1`` mesh both placements run the same workers."""
    losses = {}
    for seed_sharding in ("data", "all"):
        trainer = _learning_trainer(graph, _cpu_mesh(2), seed_sharding, local=32,
                                    hidden=16)
        n = trainer.sampler.csr_topo.node_count
        labels = torch.from_numpy(graph[2][:n].astype(np.int32))
        losses[seed_sharding] = trainer.epoch_scan(
            trainer.pack_epoch(np.arange(n), seed=1), labels, 3)
    assert torch.equal(losses["data"], losses["all"])


def test_health_versions_and_refresh(graph):
    """``health()``; a committed mutation of the topology makes the step
    raise until ``refresh()`` re-places the sampler's topology."""
    trainer = _learning_trainer(graph, _cpu_mesh(2), local=32, hidden=16)
    health = trainer.health()
    assert health == {"workers": 2, "global_batch": 64, "topology_version": 0,
                      "feature_version": 0, "checkpoint_seq": 0, "guard_trips": 0}
    topo = trainer.sampler.csr_topo
    labels = torch.from_numpy(graph[2][:topo.node_count].astype(np.int32))
    indptr, indices = np.asarray(topo.indptr), np.asarray(topo.indices)
    topo._publish_mutation(indptr.copy(), indices.copy())
    with pytest.raises(qt.VersionMismatchError, match="refresh"):
        trainer.step(np.arange(64), labels, 0)
    with pytest.raises(qt.VersionMismatchError):
        trainer.epoch_scan(trainer.pack_epoch(np.arange(64)), labels, 0)
    assert trainer.refresh() is trainer
    assert trainer.health()["topology_version"] == 1
    assert torch.isfinite(trainer.step(np.arange(64), labels, 0))


def test_serve_telemetry_reads_the_trainer(graph):
    import json
    import urllib.request

    trainer = _learning_trainer(graph, _cpu_mesh(2), local=32, hidden=16)
    n = trainer.sampler.csr_topo.node_count
    trainer.step(np.arange(64), torch.from_numpy(graph[2][:n].astype(np.int32)), 0)
    with trainer.serve_telemetry() as ep:
        with urllib.request.urlopen(ep.url + "/healthz", timeout=10) as r:
            body = json.loads(r.read())
        with urllib.request.urlopen(ep.url + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
    assert body["workers"] == 2 and body["global_batch"] == 64
    assert "feature_tier_hits" in metrics or "feature.tier_hits" in metrics
