"""Elastic resume across mesh shapes in quiver_tpu_torch against
quiver_tpu: ``worker_ordered_mean``, ``ShardedFeature.replan``,
``DistributedTrainer(logical_workers=)`` and ``resume(mesh=)``.

JAX runs on the 8 host devices ``tests/conftest.py`` forces; the port on
meshes whose slots are all the CPU (``make_mesh(devices=["cpu"] * n)``).

Tolerances:
- ``worker_ordered_mean``: bitwise JAX's (the same left fold of the same
  float32 values, then one division);
- the replanned stores: ``rep_rows`` and ``hot_rows`` equal JAX's; the
  reassembled translated rows and every gather bitwise JAX's and the
  store's own before the replan (f32, bf16 and int8);
- the validation errors: JAX's messages;
- the cross-mesh drill, port against port: the remaining losses and the
  final parameters bitwise the uninterrupted run (one process, the same
  ops on the same blocks in the same fold order);
- the elastic step against JAX's on JAX's draws and parameters (SGD 0.1,
  dropout 0): the loss within 1e-5 relative, each parameter within 1e-6
  absolute and 1e-5 relative (the frameworks order their float sums
  differently; ``tests/test_torch_fused_trainer.py``'s bars).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.mesh import DATA_AXIS, FEATURE_AXIS, shard_map  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402
from quiver_tpu.resilience.elastic import worker_ordered_mean as wom_j  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch import FaultPlan, Preemption  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402
from quiver_tpu_torch.resilience import worker_ordered_mean  # noqa: E402

from test_torch_fused_trainer import SIZES, _cpu_mesh, _labeled_graph, jax_draw_fn  # noqa: E402


# -- worker_ordered_mean -------------------------------------------------------


@pytest.mark.parametrize("workers", [2, 4, 8])
def test_worker_ordered_mean_bitwise_jax(workers):
    """JAX's inside ``shard_map`` on ``workers / 2`` devices of two blocks
    each (a 1-device mesh at W = 2), against the port's on the same
    ``(W, ...)`` stack in logical-worker order: bitwise, for the leaves of
    a dict tree; the result is the left fold, then one division."""
    rng = np.random.default_rng(workers)
    # magnitudes over many octaves, so that the association shows
    x = (rng.normal(size=(workers, 3, 5)) * 10.0 ** rng.integers(-6, 6, (workers, 3, 5))
         ).astype(np.float32)
    y = rng.normal(size=(workers,)).astype(np.float32)
    devices = max(workers // 2, 1)
    mesh = make_mesh_j(n_devices=devices, data=1, feature=devices,
                       devices=jax.devices()[:devices])
    axes = (DATA_AXIS, FEATURE_AXIS)
    fn = jax.jit(shard_map(lambda t: wom_j(t, axes, workers), mesh=mesh,
                           in_specs=({"x": P(axes), "y": P(axes)},),
                           out_specs={"x": P(), "y": P()}, check_vma=False))
    want = jax.tree_util.tree_map(np.asarray, fn({"x": jnp.asarray(x), "y": jnp.asarray(y)}))
    got = worker_ordered_mean({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                              None, workers)
    assert got["x"].numpy().view(np.uint32).tolist() == want["x"].view(np.uint32).tolist()
    assert got["y"].numpy().view(np.uint32).tolist() == want["y"].view(np.uint32).tolist()
    with pytest.raises(ValueError, match="does not stack"):
        worker_ordered_mean(torch.from_numpy(x)[1:], None, workers)
    fold = torch.from_numpy(x)[0]
    for i in range(1, workers):
        fold = fold + torch.from_numpy(x)[i]
    assert torch.equal(got["x"], fold / workers)


# -- ShardedFeature.replan -----------------------------------------------------


def _line_topo(pkg, n=96, seed=0):
    rng = np.random.default_rng(seed)
    return pkg.CSRTopo(edge_index=rng.integers(0, n, size=(2, 800)).astype(np.int64))


def _reassemble_j(s):
    parts = []
    if s.rep is not None:
        parts.append(np.asarray(s.rep))
    if s.hot is not None:
        parts.append(np.asarray(s.hot.table)[: s.hot_rows])
    if s.cold is not None:
        parts.append(np.asarray(s.cold))
    return np.concatenate(parts)


def _reassemble(s):
    region = s._device_region()
    full = torch.cat([region, s.cold.cpu()]) if s.cold is not None else region
    return full.float().numpy() if full.dtype == torch.bfloat16 else full.numpy()


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_sharded_feature_replan_preserves_rows(dtype):
    """JAX's ``test_sharded_feature_replan_preserves_rows``, both packages:
    F = 8 -> 4 -> 2 at the same per-device budgets. The tier sizes are
    JAX's at every F; the translated rows, ``feature_order``, the scales
    and every psum and routed gather are bitwise JAX's and the store's own
    before the replan; the tier hits reset."""
    n, d = 96, 8
    feat = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    row_b = d * (1 if dtype == "int8" else 2 if dtype == "bfloat16" else 4)
    scale_b = 4 * n if dtype == "int8" else 0
    kw = dict(device_cache_size=scale_b + 6 * row_b, replicate_budget=8 * row_b, dtype=dtype)
    sj = ShardedFeatureJ(make_mesh_j(data=1, feature=8), csr_topo=_line_topo(qj),
                         **kw).from_cpu_tensor(feat)
    st = qt.ShardedFeature(_cpu_mesh(1, 8), csr_topo=_line_topo(qt),
                           **kw).from_cpu_tensor(feat)
    order = st.feature_order.numpy()
    np.testing.assert_array_equal(order, np.asarray(sj.feature_order))
    base = _reassemble(st)
    ids = np.random.default_rng(2).integers(-1, n, 40).astype(np.int32)
    ids[[3, 7]] = ids[[11, 13]]  # repeated ids
    t_ids = torch.from_numpy(ids)
    before = {"psum": st.gather(t_ids), "routed": st.gather(t_ids, routed=True)}
    st.gather(t_ids)
    assert st.last_tier_hits is not None
    for f in (8, 4, 2):
        if f != 8:
            sj.replan(make_mesh_j(n_devices=f, data=1, feature=f))
            mesh = _cpu_mesh(1, f)
            assert st.replan(mesh) is st and st.mesh is mesh
            assert st.last_tier_hits is None
        assert (st.rep_rows, st.hot_rows) == (sj.rep_rows, sj.hot_rows)
        assert st.hot_rows == 6 * f and st.rep_rows == 8
        np.testing.assert_array_equal(st.feature_order.numpy(), order)
        rows_j = _reassemble_j(sj)
        if dtype == "bfloat16":
            rows_j = rows_j.astype(np.float32)
        np.testing.assert_array_equal(_reassemble(st), rows_j)
        np.testing.assert_array_equal(_reassemble(st), base)
        if dtype == "int8":
            np.testing.assert_array_equal(st.scale.numpy(), np.asarray(sj.scale))
        for routed in (False, True):
            got = st.gather(t_ids, routed=routed)
            want = np.asarray(sj.gather(jnp.asarray(ids), routed=routed))
            label = "routed" if routed else "psum"
            assert torch.equal(got, before[label]), (f, label)
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_replan_before_placement_raises():
    store = qt.ShardedFeature(_cpu_mesh(1, 4), device_cache_size=1024)
    with pytest.raises(ValueError, match="replan\\(\\) before from_cpu_tensor"):
        store.replan(_cpu_mesh(1, 2))


# -- the elastic trainer's validation --------------------------------------------


def _build_elastic(mesh, workers, checkpoint_dir=None, topo=None, feat=None, plan=None,
                   keep=3):
    """JAX's ``_build_elastic`` in the port: a three-tier store (6 sharded
    rows per device, 8 on L0), a topology-sharded sampler [3, 2],
    GraphSAGE 8 x 2, SGD 1e-2, local batch 8, ``"all"``."""
    topo = _line_topo(qt) if topo is None else topo
    n = topo.node_count
    if feat is None:
        feat = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    store = qt.ShardedFeature(mesh, device_cache_size=6 * 8 * 4, replicate_budget=8 * 8 * 4,
                              csr_topo=topo).from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, [3, 2], seed=0, seed_capacity=8,
                                  topo_sharding="mesh", mesh=mesh)
    model = GraphSAGE(8, 8, 4, num_layers=2)
    kw = {}
    if checkpoint_dir is not None:
        kw = dict(checkpoint_dir=checkpoint_dir, checkpoint_every=3, checkpoint_keep=keep)
    return DistributedTrainer(mesh, sampler, store, model,
                              torch.optim.SGD(model.parameters(), lr=1e-2), local_batch=8,
                              seed_sharding="all", logical_workers=workers, fault_plan=plan,
                              **kw)


def test_logical_workers_validation():
    """JAX's ``test_logical_workers_validation``: a count that is not a
    multiple of the mesh's slots, and ``seed_sharding="data"``."""
    mesh = _cpu_mesh(2, 4)
    with pytest.raises(ValueError, match="multiple"):
        _build_elastic(mesh, workers=12)
    with pytest.raises(ValueError, match="seed_sharding"):
        topo = _line_topo(qt)
        store = qt.ShardedFeature(mesh, device_cache_size=96 * 8 * 4)
        store = store.from_cpu_tensor(np.zeros((96, 8), np.float32))
        model = GraphSAGE(8, 8, 4, num_layers=1)
        DistributedTrainer(
            mesh, qt.GraphSageSampler(topo, [3], seed=0, seed_capacity=8, device="cpu"),
            store, model, torch.optim.SGD(model.parameters(), lr=1e-2), local_batch=8,
            seed_sharding="data", logical_workers=8)
    trainer = _build_elastic(mesh, workers=16)
    assert (trainer.workers, trainer.blocks_per_device, trainer.global_batch) == (16, 2, 128)


def test_resume_mesh_mismatch_requires_elastic_opt_in(tmp_path):
    """JAX's ``test_resume_mesh_mismatch_requires_elastic_opt_in``: a
    fresh trainer on a smaller mesh needs ``resume(mesh=)``; a wrong
    logical worker count and a step outside the saved epoch raise; a
    non-elastic trainer refuses ``mesh=``; a mesh whose slots do not
    divide the workers raises JAX's message."""
    topo = _line_topo(qt)
    writer = _build_elastic(_cpu_mesh(1, 8), workers=8, checkpoint_dir=tmp_path / "ck",
                            topo=topo)
    writer.init(0)
    writer._save_checkpoint(7, 0, 3, steps_per_epoch=9)
    writer.checkpointer.close()

    reader = _build_elastic(_cpu_mesh(1, 4), workers=8, checkpoint_dir=tmp_path / "ck",
                            topo=topo)
    with pytest.raises(ValueError, match="resume\\(mesh="):
        reader.resume()
    _, _, key, step, epoch = reader.resume(mesh=reader.mesh)
    assert (key, step, epoch) == (7, 3, 0)
    assert reader.blocks_per_device == 2
    with pytest.raises(ValueError, match="must divide evenly"):
        reader.resume(mesh=_cpu_mesh(1, 3))

    wrong = _build_elastic(_cpu_mesh(1, 4), workers=4, checkpoint_dir=tmp_path / "ck",
                           topo=topo)
    with pytest.raises(ValueError, match="logical workers"):
        wrong.resume(mesh=wrong.mesh)
    wrong.checkpointer.close()

    writer2 = _build_elastic(_cpu_mesh(1, 8), workers=8, checkpoint_dir=tmp_path / "ck2",
                             topo=topo)
    writer2._save_checkpoint(7, 0, 99, steps_per_epoch=9)
    writer2.checkpointer.wait_until_finished()
    with pytest.raises(ValueError, match="outside"):
        writer2.resume()
    writer2.checkpointer.close()
    reader.checkpointer.close()

    mesh = _cpu_mesh(1, 2)
    store = qt.ShardedFeature(mesh, device_cache_size=6 * 8 * 4,
                              csr_topo=topo).from_cpu_tensor(
        np.zeros((96, 8), np.float32))
    model = GraphSAGE(8, 8, 4, num_layers=2)
    plain = DistributedTrainer(
        mesh, qt.GraphSageSampler(topo, [3, 2], seed=0, seed_capacity=8, device="cpu"),
        store, model, torch.optim.SGD(model.parameters(), lr=1e-2), local_batch=8,
        seed_sharding="all", checkpoint_dir=tmp_path / "ck3", checkpoint_every=1)
    plain._save_checkpoint(7, 0, 1, steps_per_epoch=9)
    with pytest.raises(ValueError, match="needs an elastic trainer"):
        plain.resume(mesh=_cpu_mesh(1, 2))
    plain.checkpointer.close()


# -- the cross-mesh drill (port against port) ------------------------------------


def _labels_t(topo):
    return torch.from_numpy(np.random.default_rng(0).integers(0, 4, topo.node_count)
                            .astype(np.int32))


def _bitwise_state(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_elastic_resume_cross_mesh_bit_parity(tmp_path):
    """JAX's ``test_elastic_resume_cross_mesh_bit_parity`` in the port: an
    uninterrupted F = 8 epoch; the same epoch preempted after step 3,
    resumed on F = 4 (two blocks a slot) and again from the first
    checkpoint on F = 2 (four blocks a slot); and a trainer built afresh
    on F = 4 resuming it. Every remaining loss and the final parameters
    bitwise the uninterrupted run's; the sampler and store re-partitioned."""
    topo = _line_topo(qt)
    labels = _labels_t(topo)
    trainer_a = _build_elastic(_cpu_mesh(1, 8), 8, tmp_path / "a", topo)
    seed_mat = trainer_a.pack_epoch(np.tile(np.arange(96), 6), seed=0)
    assert seed_mat.shape[0] == 9
    trainer_a.init(0)
    losses_a = trainer_a.epoch_scan(seed_mat, labels, 7).numpy()
    final_a = {k: v.clone() for k, v in trainer_a.model.state_dict().items()}

    trainer_b = _build_elastic(_cpu_mesh(1, 8), 8, tmp_path / "b", topo,
                               plan=FaultPlan(preempt_at_step=4), keep=8)
    trainer_b.init(0)
    with pytest.raises(Preemption, match="step 4"):
        trainer_b.epoch_scan(seed_mat, labels, 7)
    first_seq = trainer_b.checkpointer.all_steps()[0]
    mesh4 = _cpu_mesh(1, 4)
    _, _, key, step, epoch = trainer_b.resume(mesh=mesh4)
    assert step == 3 and trainer_b.blocks_per_device == 2
    assert trainer_b.feature.mesh is mesh4 and trainer_b.sampler.topo.num_shards == 4
    assert trainer_b.sampler.mesh is mesh4 and trainer_b.mesh is mesh4
    losses_r = trainer_b.epoch_scan(seed_mat, labels, key, epoch=epoch, start_step=step)
    assert losses_r.numpy().view(np.uint32).tolist() == \
        losses_a[step:].view(np.uint32).tolist()
    assert _bitwise_state(trainer_b.model.state_dict(), final_a)

    mesh2 = _cpu_mesh(1, 2)
    _, _, key2, step2, epoch2 = trainer_b.resume(mesh=mesh2, checkpoint_step=first_seq)
    assert step2 == 3 and trainer_b.blocks_per_device == 4
    losses_r2 = trainer_b.epoch_scan(seed_mat, labels, key2, epoch=epoch2, start_step=step2)
    assert losses_r2.numpy().view(np.uint32).tolist() == \
        losses_a[step2:].view(np.uint32).tolist()
    assert _bitwise_state(trainer_b.model.state_dict(), final_a)
    trainer_b.checkpointer.close()

    # the process-death flow: a trainer built afresh on the smaller mesh
    fresh = _build_elastic(_cpu_mesh(1, 4), 8, tmp_path / "b", topo, keep=8)
    fresh.init(1)
    _, _, key3, step3, epoch3 = fresh.resume(mesh=fresh.mesh, checkpoint_step=first_seq)
    assert step3 == 3 and fresh.blocks_per_device == 2
    losses_r3 = fresh.epoch_scan(seed_mat, labels, key3, epoch=epoch3, start_step=step3)
    assert losses_r3.numpy().view(np.uint32).tolist() == \
        losses_a[step3:].view(np.uint32).tolist()
    assert _bitwise_state(fresh.model.state_dict(), final_a)
    fresh.checkpointer.close()
    trainer_a.checkpointer.close()


def test_elastic_step_mesh_independent():
    """One elastic step on F = 8, 4, 2 and 1 (1, 2, 4 and 8 blocks a
    slot): the same loss and parameters, bitwise (the tier hits and the
    hop overflows follow each mesh's tiers and buckets, and are not
    compared)."""
    topo = _line_topo(qt)
    labels = _labels_t(topo)
    seeds = np.random.default_rng(4).integers(0, 96, 64)
    runs = []
    for f in (8, 4, 2, 1):
        trainer = _build_elastic(_cpu_mesh(1, f), 8, topo=topo)
        trainer.init(0)
        loss = trainer.step(seeds, labels, 3)
        runs.append((loss, trainer.model.state_dict()))
    for loss, state in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and _bitwise_state(state, runs[0][1])


# -- the elastic step against JAX's ------------------------------------------------

LOCAL = 16
ROW_B = 4 * 4
STORE = {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B}


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


@pytest.mark.parametrize("feature", [4, 2])
def test_elastic_step_equals_jax(graph, feature):
    """JAX's elastic trainer (8 logical workers on a ``(1, F)`` mesh of
    host devices, ``F`` = 4 and 2: 2 and 4 blocks a device) over a
    topology-sharded sampler and a three-tier store, against the port's on
    a ``(1, F)`` CPU mesh, on JAX's draws and initial parameters: two
    steps' losses, tier hits and hop overflows, and the parameters after
    them."""
    ei, feat, labels = graph
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(n_devices=feature, data=1, feature=feature,
                       devices=jax.devices()[:feature])
    store = ShardedFeatureJ(mesh, csr_topo=topo, **STORE).from_cpu_tensor(feat)
    sampler = qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  topo_sharding="mesh", mesh=mesh)
    tj = TrainerJ(mesh, sampler, store, SageJ(hidden=16, num_classes=4, num_layers=2,
                                              dropout=0.0),
                  optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all", logical_workers=8)
    params, opt = tj.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    lab = labels.astype(np.int32)
    rng = np.random.default_rng(3)
    seeds = [rng.integers(0, topo.node_count, tj.global_batch) for _ in range(2)]
    want = []
    for t, s in enumerate(seeds):
        params, opt, loss = tj.step(params, opt, s, jnp.asarray(lab), jax.random.PRNGKey(5 + t))
        want.append((float(loss), np.asarray(tj.last_tier_hits).tolist(),
                     np.asarray(tj.last_sample_overflow).tolist()))

    tt = qt.CSRTopo(edge_index=ei)
    pmesh = _cpu_mesh(1, feature)
    pstore = qt.ShardedFeature(pmesh, csr_topo=tt, **STORE).from_cpu_tensor(feat)
    psampler = qt.GraphSageSampler(tt, list(SIZES), seed_capacity=LOCAL, seed=9,
                                   topo_sharding="mesh", mesh=pmesh)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    trainer = DistributedTrainer(pmesh, psampler, pstore, model,
                                 torch.optim.SGD(model.parameters(), lr=0.1),
                                 local_batch=LOCAL, seed_sharding="all", logical_workers=8)
    trainer.init(0)
    model.load_state_dict(flax_sage_to_state_dict(params0))
    trainer.draw_fn = jax_draw_fn
    assert trainer.blocks_per_device == tj.blocks_per_device == 8 // feature
    for t, s in enumerate(seeds):
        loss = trainer.step(s, torch.from_numpy(lab), 5 + t)
        np.testing.assert_allclose(float(loss), want[t][0], rtol=1e-5)
        assert trainer.last_tier_hits.tolist() == want[t][1]
        assert trainer.last_sample_overflow.tolist() == want[t][2]
    ref = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    got = trainer.model.state_dict()
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
