"""Both trainers of quiver_tpu_torch on a logical mesh of distinct
devices (one process over several devices), on the CPU.

A mesh over ``["cpu:0", "cpu:1", ...]`` names distinct devices that all
address host memory (``torch.zeros(2).to("cpu:1").device`` is ``cpu``).
It runs every path that distinct devices open: one model replica per
distinct device and the refresh of its parameters from the lead device
(``devices.flat[0]``), the store's L0 block on every device and its
order, scales and replicas per device, the sampler's placement on each
device, the moves of seeds, frontiers, rows and gradients to each slot's
device, and the reduction of the losses, gradients and counters on the
lead device. Every tensor still lies in host memory and every generator is
a CPU generator, so the results must be bitwise those of the mesh of one
repeated ``cpu``, the mesh the other tests of the port hold against the
JAX package. The card's own paths (CUDA contexts, streams, UVA) are
``chip_smoke.py`` phase 9r's, over a mesh of the card and the host.

Against the JAX package: its trainers run ``shard_map`` over distinct
forced host devices (``make_mesh(..., devices=jax.devices()[:4])``), the
port runs the same mesh shapes over ``cpu:0`` ... ``cpu:3``; both sides
get JAX's sample draws (the port's ``draw_fn`` replays JAX's key chain, as
``tests/test_torch_fused_trainer.py`` does), the same initial parameters
(``models/convert.py``) and dropout 0.

Tolerances, float32:
- the port on distinct devices against the port on one repeated device:
  bitwise (losses, parameters, tier hits, overflows, guard counters,
  alphas and the split);
- against JAX: the losses of SGD steps at lr 0.1 within 1e-5 relative, the
  parameters after them within 1e-5 relative and 1e-6 absolute (the two
  frameworks order their float sums differently; the bars of
  ``tests/test_torch_sharded_trainer.py``); tier hits, overflows and the
  guard's counts equal.
"""

import copy

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
from quiver_tpu.ops.sample import rotate_offsets, stratified_offsets  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.pipeline import Batch as BatchJ  # noqa: E402
from quiver_tpu.parallel.trainer import DataParallelTrainer as DPTrainerJ  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.core.memory import to_pinned_host  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED  # noqa: E402
from quiver_tpu_torch.parallel.mesh import lead_device, mesh_devices  # noqa: E402
from quiver_tpu_torch.parallel.trainer import (  # noqa: E402
    DataParallelTrainer,
    DistributedTrainer,
)

from test_torch_dp_trainer import _to_port  # noqa: E402
from test_torch_fused_trainer import SIZES, _labeled_graph  # noqa: E402

LOCAL = 32
ROW_B = 4 * 4  # float32 rows of the planted graph's 4 features
STORE = {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B}
# int8: the (300,) f32 scales charged first, then 4 B code rows: 30 L0 and
# 80 L1 rows, as the f32 store's split
STORE_INT8 = {"device_cache_size": 300 * 4 + 40 * 4, "replicate_budget": 30 * 4}
ALPHA = 0.05  # tight enough that the routed buckets overflow
STEPS = 3
# the chip's mixed meshes, with cpu:1 in the host's place
MIXED = {(2, 1): ["cpu:0", "cpu:1"], (1, 2): ["cpu:0", "cpu:1"],
         (2, 2): ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]}
FOUR = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


def _labels(graph):
    return torch.from_numpy(graph[2].astype(np.int32))


def _mesh(shape, devices=None):
    data, feature = shape
    return qt.make_mesh(data=data, feature=feature,
                        devices=devices or ["cpu"] * (data * feature))


def _draw_from(key, w, layer, deg):
    """Worker ``w``'s hop ``layer`` offsets of JAX's step keyed by the JAX
    key ``key`` (``tests/test_torch_fused_trainer.py``'s ``jax_draw_fn``
    from a key, not an int)."""
    sample_key = jax.random.split(jax.random.fold_in(key, w))[0]
    for _ in range(layer + 1):
        sample_key, sub = jax.random.split(sample_key)
    kj, kr = jax.random.split(sub)
    d = jnp.asarray(deg.numpy())
    off, _ = stratified_offsets(kj, d, SIZES[layer])
    return torch.from_numpy(np.array(rotate_offsets(kr, off, d, SIZES[layer])))


def jax_draws(keymap=None):
    """``draw_fn(key, w, layer, deg)`` of the port replaying JAX's draws:
    the step keyed ``key`` is JAX's ``PRNGKey(key)``, or ``keymap[key]``
    (an epoch's per-step JAX keys, by the port's step key)."""
    keymap = keymap or {}

    def draw(key, w, layer, deg):
        return _draw_from(keymap.get(key, jax.random.PRNGKey(key)), w, layer, deg)

    return draw


def _store(graph, mesh, kind, topo, dtype=None, **kw):
    feat = graph[1]
    if kind == "sharded":
        return qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=ALPHA, dtype=dtype,
                                 **(STORE_INT8 if dtype else STORE), **kw).from_cpu_tensor(feat)
    return qt.Feature(device_cache_size=100 * ROW_B if dtype is None else 60 * 4 + 300 * 4,
                      csr_topo=topo, dtype=dtype,
                      device=lead_device(mesh)).from_cpu_tensor(feat)


def _trainer(graph, mesh, store="sharded", seed_sharding="all", dtype=None,
             topo_sharding="replicated", weighted=False, params0=None, store_kw=None,
             optimizer="sgd", **kw):
    """The port's fused trainer on ``mesh`` (GraphSAGE 16 x 2, SGD 0.1 or
    Adam 5e-3, local batch 32, [4, 3]) over a three-tier sharded store (or
    a tiered ``Feature``), a replicated or topology-sharded sampler; its
    own ``init(0)``, or JAX's ``params0``."""
    ei = graph[0]
    topo = qt.CSRTopo(edge_index=ei)
    if weighted:
        topo.set_edge_weight(np.random.default_rng(4).random(topo.edge_count)
                             .astype(np.float32) + 0.1)
    feature = _store(graph, mesh, store, topo, dtype, **(store_kw or {}))
    where = ({"topo_sharding": "mesh", "mesh": mesh, "routed_alpha": ALPHA}
             if topo_sharding == "mesh" else {"device": lead_device(mesh)})
    sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  weighted=weighted, **where)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    trainer = DistributedTrainer(mesh, sampler, feature, model, opt, local_batch=LOCAL,
                                 seed_sharding=seed_sharding, routed_alpha=ALPHA, **kw)
    trainer.init(0)
    if params0 is not None:
        model.load_state_dict(flax_sage_to_state_dict(params0))
    return trainer


def _seeds(n, global_batch, steps=STEPS):
    rng = np.random.default_rng(3)
    return [rng.integers(0, n, global_batch) for _ in range(steps)]


def _steps(trainer, graph, steps=STEPS):
    """``steps`` steps keyed ``5 + t``: per step the loss and every
    counter the step records, then the parameters."""
    out = []
    for t, seeds in enumerate(_seeds(trainer.sampler.csr_topo.node_count,
                                     trainer.global_batch, steps)):
        loss = trainer.step(seeds, _labels(graph), 5 + t)
        m = trainer.metrics
        out.append({"loss": loss.clone(), "alpha": trainer.routed_alpha,
                    "hits": trainer.last_tier_hits.clone(),
                    "routed_overflow": trainer.last_routed_overflow.clone(),
                    "sample_overflow": trainer.last_sample_overflow.clone(),
                    "skipped": m.value(GUARD_SKIPPED), "nonfinite": m.value(GUARD_NONFINITE),
                    "rep_rows": getattr(trainer.feature, "rep_rows", None)})
    return out, {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        # bytes, so that a NaN loss of a guarded step equals its twin
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _assert_close_to_jax(got_losses, got_params, want_losses, want_params):
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, want_params))
    assert got_params.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got_params[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# -- the mesh ------------------------------------------------------------------


def test_mesh_of_distinct_devices():
    """``make_mesh`` keeps each device as given, ``mesh_devices`` lists the
    distinct ones in slot order and ``lead_device`` is the first slot's; a
    device that cannot compute raises; pinned placement follows the mesh's
    devices (the host alone pins nothing)."""
    mesh = qt.make_mesh(data=2, feature=2, devices=MIXED[(2, 2)])
    assert mesh_devices(mesh) == [torch.device("cpu", 0), torch.device("cpu", 1)]
    assert lead_device(mesh) == torch.device("cpu", 0)
    assert mesh_devices(_mesh((2, 2))) == [torch.device("cpu")]
    for bad in (["cpu", "meta"], ["meta"]):
        with pytest.raises(ValueError, match="meta"):
            qt.make_mesh(devices=bad)
    t, pinned = to_pinned_host(np.zeros((3, 2), np.float32), mesh=mesh)
    assert not pinned and t.shape == (3, 2)


# -- the port on distinct devices against one repeated device ------------------

CASES = {
    # name: (mesh shape, trainer kwargs)
    "replicated-data": ((2, 1), {"store": "replicated", "seed_sharding": "data"}),
    "replicated-all": ((2, 2), {"store": "replicated"}),
    "replicated-int8": ((1, 2), {"store": "replicated", "dtype": "int8"}),
    "psum-f32": ((2, 2), {"seed_sharding": "data"}),
    "psum-int8": ((1, 2), {"seed_sharding": "data", "dtype": "int8"}),
    "routed-f32": ((2, 2), {}),
    "routed-int8": ((2, 2), {"dtype": "int8"}),
    "topo-uniform": ((2, 2), {"topo_sharding": "mesh"}),
    "topo-weighted-replicated": ((1, 2), {"topo_sharding": "mesh", "weighted": True,
                                          "store": "replicated"}),
    "guard": ((2, 1), {"store": "replicated", "seed_sharding": "data",
                       "nonfinite_guard": True,
                       "fault_plan": qt.FaultPlan(nan_feature_steps=(1,), nan_rows=4)}),
    "tuners": ((2, 2), {"auto_alpha": True, "controller": True, "optimizer": "adam",
                        "store_kw": {"auto_split": True}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_distinct_devices_bitwise_repeated(graph, case):
    """Three steps of each configuration on the mixed mesh (``cpu:1`` in
    the host's place of the chip's ``["cuda:0", "cpu", ...]``) against the
    same mesh shape over one repeated ``cpu``: every loss, counter and
    parameter bitwise. The distinct mesh keeps one model replica per
    non-lead device, and a replicated sampler and store place themselves on
    each."""
    shape, kw = CASES[case]
    kw = dict(kw)
    runs = {}
    for form, devices in (("repeated", None), ("distinct", MIXED[shape])):
        if kw.get("controller") is True:
            kw["controller"] = qt.CacheController()
        trainer = _trainer(graph, _mesh(shape, devices), **kw)
        runs[form] = _steps(trainer, graph)
    assert _same(runs["distinct"], runs["repeated"])
    # the devices other than the lead that run a worker
    others = {trainer._worker_device(w) for w in range(trainer.workers)} - {trainer.device}
    assert set(trainer._replicas.copies) == others
    if kw.get("topo_sharding") != "mesh":
        assert set(trainer.sampler._placements) == others
    if kw.get("store") == "replicated":
        assert set(trainer.feature._replicas) == others
    else:
        store = trainer.feature
        assert store.rep_rows and store.hot_rows and store.cold is not None
        assert set(store.reps) == set(mesh_devices(trainer.mesh))
    if case == "guard":
        assert [int(s["skipped"]) for s in runs["distinct"][0]] == [0, 1, 0]
    if case == "tuners":
        assert runs["distinct"][0][-1]["alpha"] > ALPHA


def test_epoch_end_repin_bitwise_repeated(graph):
    """Two epochs under an attached ``CacheController`` and ``auto_alpha``
    over an ``auto_split`` store (the heat feed on, ``epoch_scan``'s end
    hooks: the split tuner and a repin at any gain), on the mixed ``(2, 2)`` mesh and
    on the repeated one: the losses, the alphas, the boundary, the store's
    version and its order bitwise, and a repin happened."""
    runs = {}
    for form, devices in (("repeated", None), ("distinct", MIXED[(2, 2)])):
        trainer = _trainer(graph, _mesh((2, 2), devices), optimizer="adam",
                           auto_alpha=True, controller=qt.CacheController(repin_min_gain=0.0),
                           store_kw={"auto_split": True})
        seed_mat = trainer.pack_epoch(np.arange(300), seed=4)
        out = []
        for epoch in range(2):
            losses = trainer.epoch_scan(seed_mat, _labels(graph), 40 + epoch, epoch=epoch)
            store = trainer.feature
            out.append((losses, trainer.routed_alpha, store.rep_rows, store.version,
                        store.feature_order.clone(), trainer.last_tier_hits.clone()))
        runs[form] = out
    assert _same(runs["distinct"], runs["repeated"])
    assert runs["distinct"][-1][3] > 0


@pytest.mark.parametrize("depth", [0, 1])
def test_epoch_scan_preempt_resume_bitwise_repeated(graph, tmp_path, depth):
    """``epoch_scan`` in checkpoint chunks of 2 with a preemption at step 2
    and a resume, at ``pipeline_depth`` 0 and 1, on the four-device mesh:
    the losses of the resumed tail and the parameters bitwise the repeated
    mesh's uninterrupted epoch."""
    shape = (2, 2)
    ref = _trainer(graph, _mesh(shape), optimizer="adam", pipeline_depth=depth)
    seed_mat = ref.pack_epoch(np.arange(300), seed=1)
    want = ref.epoch_scan(seed_mat, _labels(graph), 11)
    plan = qt.FaultPlan(preempt_at_step=2)
    ckpt = {"checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 2}
    first = _trainer(graph, _mesh(shape, FOUR), optimizer="adam", pipeline_depth=depth,
                     fault_plan=plan, **ckpt)
    with pytest.raises(qt.Preemption):
        first.epoch_scan(seed_mat, _labels(graph), 11)
    second = _trainer(graph, _mesh(shape, FOUR), optimizer="adam", pipeline_depth=depth,
                      **ckpt)
    _, _, key, step, epoch = second.resume()
    assert (key, step) == (11, 2)
    tail = second.epoch_scan(seed_mat, _labels(graph), key, epoch=epoch, start_step=step)
    assert torch.equal(tail, want[step:])
    assert _same(second.model.state_dict(), ref.model.state_dict())


def test_elastic_resume_onto_distinct_devices_bitwise(graph, tmp_path):
    """An elastic run of 8 logical workers checkpointed on the repeated
    ``(1, 4)`` mesh resumes with ``resume(mesh=)`` onto the mixed ``(2, 2)``
    mesh (the replan places the store and the topology shards on its
    devices): the tail's losses and the parameters bitwise the
    uninterrupted run."""
    kw = {"topo_sharding": "mesh", "logical_workers": 8, "optimizer": "adam"}
    ref = _trainer(graph, _mesh((1, 4)), **kw)
    seed_mat = ref.pack_epoch(np.arange(300), seed=2)
    want = ref.epoch_scan(seed_mat, _labels(graph), 13)
    ckpt = {"checkpoint_dir": str(tmp_path / "elastic"), "checkpoint_every": 1}
    first = _trainer(graph, _mesh((1, 4)), fault_plan=qt.FaultPlan(preempt_at_step=1),
                     **ckpt, **kw)
    with pytest.raises(qt.Preemption):
        first.epoch_scan(seed_mat, _labels(graph), 13)
    mixed = _mesh((2, 2), MIXED[(2, 2)])
    _, _, key, step, epoch = first.resume(mesh=mixed)
    assert first.mesh is mixed and first.feature.mesh is mixed and step == 1
    tail = first.epoch_scan(seed_mat, _labels(graph), key, epoch=epoch, start_step=step)
    assert torch.equal(tail, want[step:])
    assert _same(first.model.state_dict(), ref.model.state_dict())
    assert set(first._replicas.copies) == {torch.device("cpu", 1)}


def _dp(graph, mesh, model, **kw):
    topo = qt.CSRTopo(edge_index=graph[0])
    lead = lead_device(mesh)
    sampler = qt.GraphSageSampler(topo, list(SIZES), device=lead, seed_capacity=16, seed=9)
    feature = qt.Feature(device_cache_size=150 * ROW_B, csr_topo=topo,
                         device=lead).from_cpu_tensor(graph[1])
    return DataParallelTrainer(mesh, sampler, feature, model,
                               torch.optim.Adam(model.parameters(), lr=5e-3),
                               local_batch=16, **kw)


@pytest.mark.parametrize("depth", [0, 2])
def test_data_parallel_bitwise_repeated(graph, depth):
    """``DataParallelTrainer.train_epoch`` over 4 data workers, serial and
    under the Prefetcher (one sampler and one store per slot, cycled), on
    four distinct devices and on one repeated: the mean loss and the
    parameters bitwise; the distinct run sampled and gathered on every
    slot's placement. A ``draw_fn`` keyed by the sampler's call number
    reaches every slot."""
    model = GraphSAGE(4, 16, 4, num_layers=2)
    qt.parallel.init_model(model, torch.Generator().manual_seed(0))
    out, calls = {}, []
    for form, devices in (("repeated", None), ("distinct", FOUR)):
        trainer = _dp(graph, _mesh((4, 1), devices), copy.deepcopy(model))
        rng = np.random.default_rng(7)

        def draw(call, layer, deg, rng=rng):
            calls.append(call)
            hi = np.maximum(deg.numpy(), 1)[:, None]
            return torch.from_numpy((rng.integers(0, 1 << 30, (len(hi), SIZES[layer]))
                                     % hi).astype(np.int32))

        trainer.draw_fn = draw
        mean = trainer.train_epoch(np.arange(300), _labels(graph),
                                   torch.Generator().manual_seed(3),
                                   rng=np.random.default_rng(1), depth=depth)
        out[form] = (mean, {k: v.clone() for k, v in trainer.model.state_dict().items()})
    assert out["distinct"][0] == out["repeated"][0]
    assert _same(out["distinct"][1], out["repeated"][1])
    others = {torch.device("cpu", i) for i in (1, 2, 3)}
    assert set(trainer.sampler._placements) == set(trainer.feature._replicas) == others
    assert set(trainer._replicas.copies) == others
    steps = out["distinct"][0][1]
    assert calls == [c for _ in range(2) for c in range(1, 4 * steps + 1)
                     for _ in SIZES]


# -- against the JAX package on distinct forced devices -------------------------


def _jax_sharded(graph, mesh, seed_sharding, dtype=None, topo_sharding="replicated",
                 **kw):
    ei, feat, _ = graph
    topo = qj.CSRTopo(edge_index=ei)
    store = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=ALPHA, dtype=dtype,
                            **(STORE_INT8 if dtype else STORE)).from_cpu_tensor(feat)
    extra = {"topo_sharding": "mesh", "mesh": mesh} if topo_sharding == "mesh" else {}
    sampler = qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9, **extra)
    return TrainerJ(mesh, sampler, store,
                    SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                    optax.sgd(0.1), local_batch=LOCAL, seed_sharding=seed_sharding,
                    routed_alpha=ALPHA, **kw)


def _jax_steps(trainer, graph, steps=STEPS):
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    lab = jnp.asarray(graph[2].astype(np.int32))
    out = []
    for t, seeds in enumerate(_seeds(trainer.sampler.csr_topo.node_count,
                                     trainer.global_batch, steps)):
        params, opt, loss = trainer.step(params, opt, seeds, lab, jax.random.PRNGKey(5 + t))
        sov = trainer.last_sample_overflow
        out.append({"loss": float(loss), "hits": np.asarray(trainer.last_tier_hits).tolist(),
                    "routed_overflow": int(np.asarray(trainer.last_routed_overflow)),
                    "sample_overflow": None if sov is None else np.asarray(sov).tolist()})
    return params0, out, params


@pytest.mark.parametrize("seed_sharding,dtype,topo_sharding", [
    ("data", None, "replicated"), ("all", None, "replicated"),
    ("data", "int8", "replicated"), ("all", "int8", "replicated"),
    ("all", None, "mesh")])
def test_distributed_equals_jax_on_distinct_devices(graph, seed_sharding, dtype,
                                                    topo_sharding):
    """Three steps of the psum (``"data"``) and routed (``"all"``) flavours
    over a three-tier store, f32 and int8, and of the routed flavour under
    a topology-sharded sampler: JAX on four distinct host devices, the port
    on ``cpu:0`` ... ``cpu:3``; losses and parameters at the stated
    tolerance, tier hits and overflows equal."""
    mesh_j = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    params0, want, params_j = _jax_steps(
        _jax_sharded(graph, mesh_j, seed_sharding, dtype, topo_sharding), graph)
    trainer = _trainer(graph, _mesh((2, 2), FOUR), seed_sharding=seed_sharding,
                       dtype=dtype, topo_sharding=topo_sharding, params0=params0)
    trainer.draw_fn = jax_draws()
    got, params = _steps(trainer, graph)
    for g, w in zip(got, want):
        assert g["hits"].tolist() == w["hits"]
        assert int(g["routed_overflow"]) == w["routed_overflow"]
        if w["sample_overflow"] is not None:
            assert g["sample_overflow"].tolist() == w["sample_overflow"]
    assert seed_sharding == "data" or sum(w["routed_overflow"] for w in want) > 0
    _assert_close_to_jax([float(g["loss"]) for g in got], params,
                         [w["loss"] for w in want], params_j)


def test_epoch_scan_depth1_equals_jax(graph):
    """A 4-step ``epoch_scan`` at ``pipeline_depth=1`` over the routed
    three-tier store with the non-finite guard on: JAX's (per-step keys
    split from the epoch key) on four distinct host devices, the port's on
    ``cpu:0`` ... ``cpu:3`` replaying JAX's per-step draws; the losses and
    parameters at the stated tolerance, the per-step tier hits equal."""
    mesh_j = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    tj = _jax_sharded(graph, mesh_j, "all", nonfinite_guard=True, pipeline_depth=1)
    params, opt = tj.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    seed_mat = tj.pack_epoch(np.arange(4 * tj.global_batch) % 300, seed=5)
    key = jax.random.PRNGKey(17)
    params_j, _, losses_j = tj.epoch_scan(params, opt, seed_mat,
                                          jnp.asarray(graph[2].astype(np.int32)), key)
    hits_j = np.asarray(tj.last_tier_hits).tolist()

    trainer = _trainer(graph, _mesh((2, 2), FOUR), params0=params0, nonfinite_guard=True,
                       pipeline_depth=1)
    steps = seed_mat.shape[0]
    keys_j = jax.random.split(key, steps)
    trainer.draw_fn = jax_draws({trainer.step_key(17, t): keys_j[t] for t in range(steps)})
    losses = trainer.epoch_scan(np.asarray(seed_mat), _labels(graph), 17)
    assert trainer.last_tier_hits.tolist() == hits_j
    assert int(trainer.metrics.value(GUARD_SKIPPED).sum()) == 0
    _assert_close_to_jax(losses.tolist(), trainer.model.state_dict(),
                         np.asarray(losses_j).tolist(), params_j)


def test_elastic_resume_equals_jax(graph, tmp_path):
    """8 logical workers over a topology-sharded sampler and a three-tier
    store, two steps: JAX's uninterrupted run on a ``(1, 4)`` mesh of
    distinct host devices; the port's first step on ``cpu:0`` ... ``cpu:3``
    as ``(1, 4)``, checkpointed, then resumed onto the mixed ``(2, 2)`` mesh
    for the second. Losses and parameters at the stated tolerance, the
    tier hits of the step that the mesh shape does not change (the first)
    equal."""
    ei, feat, labels = graph
    mesh_j = make_mesh_j(n_devices=4, data=1, feature=4, devices=jax.devices()[:4])
    tj = _jax_sharded(graph, mesh_j, "all", topo_sharding="mesh", logical_workers=8)
    params0, want, params_j = _jax_steps(tj, graph, steps=2)

    ckpt = {"checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 1}
    trainer = _trainer(graph, _mesh((1, 4), FOUR), topo_sharding="mesh", logical_workers=8,
                       params0=params0, **ckpt)
    seeds = _seeds(trainer.sampler.csr_topo.node_count, trainer.global_batch, 2)
    seed_mat = np.stack([trainer.shard_seeds(s) for s in seeds])
    # epoch_scan keys step t by step_key(key0, t): replay JAX's step t key
    # PRNGKey(5 + t) under that int
    keymap = {trainer.step_key(21, t): jax.random.PRNGKey(5 + t) for t in range(2)}
    trainer.draw_fn = jax_draws(keymap)
    first = trainer.epoch_scan(seed_mat[:1], _labels(graph), 21)
    hits0 = trainer.last_tier_hits[0].tolist()
    trainer.checkpointer.wait_until_finished()
    _, _, key, step, epoch = trainer.resume(mesh=_mesh((2, 2), MIXED[(2, 2)]))
    assert (key, step) == (21, 1)
    second = trainer.epoch_scan(seed_mat, _labels(graph), key, epoch=epoch, start_step=step)
    assert hits0 == want[0]["hits"]
    _assert_close_to_jax([float(first[0]), float(second[0])], trainer.model.state_dict(),
                         [w["loss"] for w in want], params_j)


def test_data_parallel_step_equals_jax(graph):
    """One step of 4 data workers (the last block short) from JAX's own
    batches: JAX's ``DataParallelTrainer`` on four distinct host devices,
    the port's on ``cpu:0`` ... ``cpu:3`` (each batch on its worker's
    device, the gradients added on the lead); the loss and the parameters
    after one SGD step at the stated tolerance."""
    ei, feat, labels = graph
    topo_j = qj.CSRTopo(edge_index=ei)
    sampler_j = qj.GraphSageSampler(topo_j, [4, 3], seed_capacity=LOCAL, seed=9)
    feature_j = FeatureJ(device_cache_size="1G").from_cpu_tensor(feat)
    trainer_j = DPTrainerJ(make_mesh_j(data=4, feature=1, devices=jax.devices()[:4]),
                           sampler_j, feature_j,
                           SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                           optax.sgd(0.1), local_batch=LOCAL)
    params, opt_state = trainer_j.init(jax.random.PRNGKey(0))
    seeds = np.random.default_rng(3).permutation(300)[: LOCAL * 4 - 5]
    batches_j = []
    for block in trainer_j.seed_blocks(seeds):
        out = sampler_j.sample(block)
        batches_j.append(BatchJ(block, out, feature_j[out.n_id]))
    new_params, _, loss_j = trainer_j.step(params, opt_state, batches_j,
                                           jnp.asarray(labels), jax.random.PRNGKey(5))

    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    mesh = _mesh((4, 1), FOUR)
    topo = qt.CSRTopo(edge_index=ei)
    trainer = DataParallelTrainer(
        mesh, qt.GraphSageSampler(topo, [4, 3], device="cpu:0", seed_capacity=LOCAL, seed=9),
        qt.Feature(device_cache_size="1G", device="cpu:0").from_cpu_tensor(feat), model,
        torch.optim.SGD(model.parameters(), lr=0.1), local_batch=LOCAL)
    loss = trainer.step([_to_port(b) for b in batches_j],
                        torch.from_numpy(labels.astype(np.int32)))
    assert set(trainer._replicas.copies) == {torch.device("cpu", i) for i in (1, 2, 3)}
    _assert_close_to_jax([float(loss)], model.state_dict(), [float(loss_j)], new_params)
