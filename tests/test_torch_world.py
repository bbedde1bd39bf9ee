"""The port's world mesh: one ``gloo`` CPU process per mesh slot, held
against the logical mesh of the same shape, bitwise, and one ``(2, 2)``
step against the JAX package's trainer.

Two worlds are spawned (``tests/torch_world_worker.py``, joined through a
file store under ``tmp_path``, each child at one thread): a world of 2
(meshes ``(1, 2)`` and ``(2, 1)``) and a world of 4 (mesh ``(2, 2)``).
Each rank runs its cases on world meshes, and rank 0 also on logical
meshes of the same shapes, at the same thread count; this file compares
them:

- (i) the CSR digests gathered over the world are every rank's, an
  ordered sum over the world is the left fold of the ranks' vectors, the
  metrics tape's ``psum=`` and the guard's verdict span the world;
- (ii) ``BucketRoute`` capped (overflowing), uncapped and with a payload;
- (iii) ``ShardedFeature`` in f32 and int8, psum and routed, standalone
  and per feature group, on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``;
- (iv) ``DistributedTrainer``: 3 steps (the guard skips step 1, whose rows
  a ``FaultPlan`` poisons) and a 3-step ``epoch_scan``, at depth 0 and 1,
  under both seed shardings on ``(2, 2)``: ids, rows, losses, metrics and
  parameters;
- (v) ``DataParallelTrainer`` on a world of 2 against ``(2, 1)``: two
  epochs (serial and prefetched), their losses, parameters and the
  sampler's call counter;
- (vi) the ten options that A.11e (a1) left refused no longer raise:
  five were ported by ROADMAP A.11e (a2), five by A.11e (a3);
- the program audit records the same collectives for a rank's step as
  for the logical ``(1, 2)`` step;
- (vii) one ``(2, 2)`` routed step on the JAX trainer's draws and initial
  parameters against JAX's ``DistributedTrainer`` on its forced host
  devices, within ``tests/test_torch_sharded_trainer.py``'s tolerances
  (losses 1e-5 relative; parameters 1e-5 relative and 1e-6 absolute);
  its tier hits and routed overflow equal.

Everything else is bitwise (``torch.equal``).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402

from test_torch_fused_trainer import jax_draw_fn  # noqa: E402
from torch_world_worker import GRAPH, LOCAL, SIZES, STORES  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_world_worker.py")
JOIN_S = 120  # each world's deadline; past it the children are killed
PAIR = "world,route:12,store:12,store:21,dp,refusals,audit"
QUAD = "world,route:22,store:22,trainer:22"
JAX_KEY = 5


def _spawn(size, cases, tmp):
    """Start a world of ``size`` children; returns what :func:`_join`
    needs."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for rank in range(size):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(size), str(tmp / "store"), str(tmp),
             cases], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs, tmp


def _join(handle):
    """Wait for every child under the deadline (killing them all past it),
    then load each rank's results."""
    procs, tmp = handle
    deadline = time.time() + JOIN_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:] for r in range(len(procs)))
    codes = [p.returncode for p, _ in procs]
    assert codes == [0] * len(procs), f"exit codes {codes}\n{logs}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_inputs(tmp):
    """JAX's (2, 2) routed step, and the draws and initial parameters that
    the children replay: the draws are recorded from the port's logical
    (2, 2) step on JAX's key chain (its asks equal the world's, bitwise)."""
    ei, feat, labels = GRAPH
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=0.05,
                              **STORES[None]).from_cpu_tensor(feat)
    trainer = TrainerJ(mesh, qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9),
                       feature, SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all",
                       routed_alpha=0.05)
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    seeds = np.random.default_rng(3).integers(0, topo.node_count, trainer.global_batch)
    params, opt, loss = trainer.step(params, opt, seeds, jnp.asarray(labels.astype(np.int32)),
                                     jax.random.PRNGKey(JAX_KEY))
    want = {"loss": float(loss), "hits": np.asarray(trainer.last_tier_hits).tolist(),
            "overflow": int(np.asarray(trainer.last_routed_overflow)),
            "params": flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))}

    draws = {}

    def record(key, w, layer, deg):
        draws[f"{key}:{w}:{layer}"] = out = jax_draw_fn(key, w, layer, deg)
        return out

    mesh_t = qt.make_mesh(data=2, feature=2, devices=["cpu"] * 4)
    port = qt.ShardedFeature(mesh_t, csr_topo=qt.CSRTopo(edge_index=ei), routed_alpha=0.05,
                             **STORES[None]).from_cpu_tensor(feat)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    logical = DistributedTrainer(
        mesh_t, qt.GraphSageSampler(qt.CSRTopo(edge_index=ei), list(SIZES), device="cpu",
                                    seed_capacity=LOCAL, seed=9),
        port, model, torch.optim.SGD(model.parameters(), lr=0.1), local_batch=LOCAL,
        seed_sharding="all", routed_alpha=0.05)
    logical.init(0)
    model.load_state_dict(params0)
    logical.draw_fn = record
    logical.step(seeds, torch.from_numpy(labels.astype(np.int32)), JAX_KEY)
    path = tmp / "jax_draws.pt"
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save({"draws": draws, "params0": params0, "seeds": torch.from_numpy(seeds),
                "key": JAX_KEY}, path)
    return path, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results: the world of 2 runs while the parent computes
    JAX's step, then the world of 4 (with the JAX replay)."""
    root = tmp_path_factory.mktemp("worlds")
    pair = _spawn(2, PAIR, root / "pair")
    try:
        draws, want = _jax_inputs(root / "jax")
        quad = _spawn(4, f"{QUAD},jax:{draws}", root / "quad")
    finally:
        pair_res = _join(pair)
    return {2: pair_res, 4: _join(quad), "jax": want}


def same(a, b, path="value"):
    """Bitwise equality of nested results (tensors by ``torch.equal``,
    arrays by ``np.array_equal``, NaN equal to NaN)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        equal = torch.equal(a, b) or torch.equal(torch.nan_to_num(a, nan=7.0),
                                                 torch.nan_to_num(b, nan=7.0))
        assert equal, path
        return
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{path}/{k}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}/{i}")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), path
        return
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
        return
    assert a == b, (path, a, b)


def _ref(res, case, name, worker):
    return res[0][f"ref/{case}/{name}/{worker}"]


@pytest.mark.parametrize("size", [2, 4])
def test_world_forms_digests_and_sums(worlds, size):
    """(i): every rank's CSR digest equals every other's, the ordered sum
    is the left fold in rank order, the tape's sums span the world and a
    NaN on the last rank turns every rank's verdict."""
    res = worlds[size]
    for r in res:
        assert torch.equal(r["world/digests"], r["world/digest"][None].expand(size, -1))
        assert torch.equal(r["world/osum"], r["world/fold"])
        got, want = r["world/tape"], r["world/tape_want"]
        assert np.array_equal(got["test.count"], want["test.count"])
        assert got["test.mass"] == want["test.mass"]
        assert r["world/guard"][0] is False
    assert [r["world/guard"][1] for r in res] == [0] * (size - 1) + [1]


@pytest.mark.parametrize("size,shape", [(2, "12"), (4, "22")])
def test_bucket_route_world_bitwise(worlds, size, shape):
    """(ii): each rank's capped, uncapped and payload answers are the
    logical plan's row for its member, and the overflow its group's; the
    capped plan overflows."""
    res = worlds[size]
    for w, r in enumerate(res):
        for cap in (2, None):
            same(r[f"route{shape}/cap{cap}"], _ref(res, f"route{shape}", f"cap{cap}", w))
        assert int(r[f"route{shape}/cap2"][2]) > 0
        assert int(r[f"route{shape}/capNone"][2]) == 0


@pytest.mark.parametrize("size,shape", [(2, "12"), (2, "21"), (4, "22")])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_sharded_feature_world_bitwise(worlds, size, shape, dtype):
    """(iii): the standalone psum and routed gathers (auto and capped) and
    the feature group's lookups (psum, routed per member: rows, hits and
    the group's overflow) of every rank equal the logical store's."""
    res = worlds[size]
    case = f"store{shape}_{dtype}"
    for w, r in enumerate(res):
        assert r[f"{case}/split"][0] > 0 and r[f"{case}/split"][1] > 0
        same(r[f"{case}/out"], _ref(res, case, "out", w), case)
    if shape != "21":
        assert int(res[0][f"{case}/out"]["routed_ov"]) > 0  # the fallback served


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
@pytest.mark.parametrize("depth", [0, 1])
def test_distributed_trainer_world_bitwise(worlds, seed_sharding, depth):
    """(iv): on (2, 2), each rank's step ids and rows are its worker's in
    the logical step, and its losses, tier hits, overflow, guard counters
    and parameters (after the steps and after the epoch) are the logical
    trainer's; step 1 is skipped by the guard."""
    res = worlds[4]
    case = f"trainer22_{seed_sharding}_{depth}"
    want = _ref(res, case, "res", 0)
    for r in res:
        same(r[f"{case}/res"], want, case)
        same(r[f"{case}/blocks"], _ref(res, case, "blocks", r[f"{case}/worker"]), case)
    steps = want["steps"]
    assert [int(np.asarray(s["skipped"])) for s in steps] == [0, 1, 0]
    assert int(np.asarray(steps[1]["nonfinite"])) > 0
    assert np.isnan(float(steps[1]["loss"]))
    if seed_sharding == "all":
        assert sum(int(s["overflow"]) for s in steps) > 0


def test_data_parallel_trainer_world_bitwise(worlds):
    """(v): a world of 2 against the logical (2, 1) mesh: both epochs'
    mean losses and step counts, the parameters after each, and the
    sampler's call counter."""
    res = worlds[2]
    want = _ref(res, "dp", "res", 0)
    assert want[0][1] == 3 and want["calls"] > 6
    for r in res:
        same(r["dp/res"], want, "dp")


PORTED_A2 = {"topo_sharded_sampler", "logical_workers", "checkpoint_dir", "resume_mesh",
             "replan"}
PORTED_A3 = {"controller", "auto_alpha", "repin", "row_updates", "split_tuner"}


def test_a2_options_raise_on_a_world_mesh(worlds):
    """(vi): the ten options A.11e (a1) left refused all run on every rank
    now: the five that A.11e (a2) ported and the five that A.11e (a3)
    ported (the controller, ``auto_alpha``, ``repin``, row updates, the
    split tuner); none raises."""
    for r in worlds[2]:
        said = r["refusals/said"]
        assert set(said) == PORTED_A2 | PORTED_A3
        for name, text in said.items():
            assert text == "no raise", (name, text)


def test_audit_records_the_logical_collectives(worlds):
    """A rank's recorded step carries the logical (1, 2) step's collective
    list: the routed exchange's, the metric sums and the guard's."""
    res = worlds[2]
    want = _ref(res, "audit", "world", 0)
    assert len(want) >= 8
    for r in res:
        assert r["audit/world"] == want


def test_world_step_equals_jax(worlds):
    """(vii): the (2, 2) routed world step on JAX's draws and parameters
    against JAX's step: loss and parameters within the tolerances, tier
    hits and overflow equal, on every rank."""
    want = worlds["jax"]
    for r in worlds[4]:
        got = r["jax/res"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        assert got["hits"].tolist() == want["hits"]
        assert int(got["overflow"]) == want["overflow"]
        for name, value in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
