"""The port's adaptive tuners on a world of ``gloo`` CPU processes: the
cache controller and ``auto_alpha`` under ``DistributedTrainer``,
``repin``, row updates and the split tuner of a ``ShardedFeature``, and a
``StreamingGraph`` commit with row updates into a world store, each held
against the logical mesh of the same shape, bitwise, and one ``(2, 2)``
run against the JAX package's trainer.

Two worlds run at once (``tests/torch_world_control_worker.py``, joined
through a file store under ``tmp_path``, each child at one thread; rank 0
also runs the logical references at that thread count): a world of 2 on
``(1, 2)`` and a world of 4 on ``(2, 2)``, while the parent computes JAX's
run and records its draws, which the world of 4 replays last. This file
compares them:

- (i) ``controller=CacheController(heat_bins=16, repin_min_gain=0)`` and
  ``auto_alpha=True`` from alpha 0.05 (the routed buckets and hops
  overflow) over an ``auto_split`` store whose L0 the trainer re-splits to
  15 rows: ``"data"`` over the replicated sampler (int8), ``"all"`` over
  the replicated sampler (f32) and over the topology-sharded one (int8),
  at depth 0 and 1: 3 steps, a 3-step ``epoch_scan`` and one step more.
  The losses, parameters, ``routed_alpha``, the overflow counts, tier
  hits, the heat histogram, the sketch's heat and heavy hitters,
  ``rep_rows``, ``feature_order`` (the store's and the topology's), the
  store's version and the controller's decision list, after every step;
- (ii) ``end_epoch``'s repin then the next step (in (i)); a frozen
  controller against none, and against the logical frozen one;
- (iii) a standalone world store, f32, int8 and an L1 + cold f32 store
  (whose device region a repin gathers over the feature group): ``repin``,
  row updates touching L0, every L1 shard and cold rows, a duplicate id
  and a NaN row rejected with the store bitwise unchanged, every row by
  the psum and the routed gather; the split tuner of an ``auto_split``
  store halving its L0 and doubling it back (a confirmed reversal), f32
  and int8;
- (iv) a ``StreamingGraph`` commit of edge inserts and row updates into
  the topology-sharded trainer's int8 world store: the stale step raises,
  and after ``refresh`` the store serves the fresh rows in every tier and
  the next step runs as the logical one; then ``inject_failure`` on rank
  1 alone aborts every rank with the state intact;
- (v) the program audit records the same collectives for a rank's
  controlled step (the heat feed on) as for the logical ``(1, 2)`` step.

Every rank's results are the logical ones, so every rank decided the
same. Against JAX (``tests/test_torch_trainer_control.py``'s tolerances):
the ``(2, 2)`` world's 4 SGD steps with ``auto_alpha``, a controller and
an ``auto_split`` store have JAX's ``routed_alpha`` trajectory, overflow
counts, tier hits, boundary moves and decisions, its sketch's heat and
heavy hitters equal, and its losses within 1e-5 relative.

Everything else is bitwise (``torch.equal``).
"""

import os
import subprocess
import sys

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

from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402

import torch_world_control_worker as worker  # noqa: E402
from test_torch_fused_trainer import jax_draw_fn  # noqa: E402
from test_torch_world import _join, _ref, same  # noqa: E402
from torch_world_worker import GRAPH, LOCAL, ROW_B, SIZES, logical  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_world_control_worker.py")
CASES = "train:{s},store:{s},stream:{s}"
PAIR = CASES.format(s="12") + ",frozen:12,audit:12"
QUAD = CASES.format(s="22")
SHAPES = [(2, "12"), (4, "22")]


def _spawn(size, cases, tmp):
    """Start a world of ``size`` children of this file's worker; returns
    what ``test_torch_world._join`` needs (which holds them to its
    deadline)."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for rank in range(size):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(size), str(tmp / "store"), str(tmp),
             cases], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs, tmp


def _seeds(global_batch):
    rng = np.random.default_rng(3)
    return [rng.integers(0, worker.N, global_batch) for _ in range(worker.JAX_STEPS)]


def _jax_inputs(path):
    """JAX's (2, 2) run with the tuners on, and the draws and initial
    parameters that the world of 4 replays (written to ``path`` at once,
    when complete): the draws are recorded from the port's logical (2, 2)
    run on JAX's key chain (its asks equal the world's, bitwise)."""
    ei, feat, labels = GRAPH
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=worker.ALPHA,
                              **worker.tuned_store(None)).from_cpu_tensor(feat)
    ctl = qj.CacheController(heat_bins=worker.HEAT_BINS)
    trainer = TrainerJ(mesh, qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9),
                       feature, SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all",
                       routed_alpha=worker.ALPHA, auto_alpha=True, controller=ctl,
                       replicate_budget=15 * ROW_B)
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    lab = jnp.asarray(labels.astype(np.int32))
    seeds = _seeds(trainer.global_batch)
    want = []
    for t, s in enumerate(seeds):
        params, opt, loss = trainer.step(params, opt, s, lab, jax.random.PRNGKey(5 + t))
        want.append({"loss": float(loss), "alpha": trainer.routed_alpha,
                     "overflow": int(np.asarray(trainer.last_routed_overflow)),
                     "hits": np.asarray(trainer.last_tier_hits).tolist(),
                     "rep_rows": trainer.feature.rep_rows,
                     "decisions": list(ctl.decisions)})
    sketch = {"heat": ctl.sketch.heat.copy(), "hitters": ctl.sketch.state()["hitters"]}

    draws = {}

    def record(key, w, layer, deg):
        draws[f"{key}:{w}:{layer}"] = out = jax_draw_fn(key, w, layer, deg)
        return out

    port = worker.jax_trainer(logical(2, 2), record)
    port.model.load_state_dict(params0)
    worker.jax_steps(port, seeds)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"draws": draws, "params0": params0,
                "seeds": torch.from_numpy(np.stack(seeds))}, str(path) + ".part")
    os.replace(str(path) + ".part", path)
    return want, sketch


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results: they run while the parent computes JAX's run,
    whose draws the world of 4 replays after its other cases."""
    root = tmp_path_factory.mktemp("worlds_control")
    draws = root / "jax" / "jax_draws.pt"
    pair = _spawn(2, PAIR, root / "pair")
    try:
        quad = _spawn(4, f"{QUAD},jax:{draws}", root / "quad")
        try:
            want = _jax_inputs(draws)
        finally:
            quad_res = _join(quad)
    finally:
        pair_res = _join(pair)
    return {2: pair_res, 4: quad_res, "jax": want}


@pytest.mark.parametrize("size,shape", SHAPES)
@pytest.mark.parametrize("config", list(worker.CONFIGS))
@pytest.mark.parametrize("depth", [0, 1])
def test_controlled_trainer_world_bitwise(worlds, size, shape, config, depth):
    """(i)-(ii): every rank's losses, parameters, metrics, alpha trajectory,
    split, order, version, decision list and sketch, step by step, are the
    logical trainer's; the split moved, the epoch's end repinned and the
    next step ran on the new order; on the routed configurations alpha grew
    from overflow (the hops' too over the topology-sharded sampler)."""
    res = worlds[size]
    case = f"train{shape}_{config}_{depth}"
    want = _ref(res, case, "res", 0)
    for r in res:
        same(r[f"{case}/res"], want, case)
    steps, epoch, after = want["steps"], want["epoch"], want["after"]
    kinds = [d["decision"] for d in after["decisions"]]
    assert "split" in kinds and kinds.count("repin") == 1
    assert steps[-1]["version"] == 0 and epoch["version"] == after["version"] == 1
    assert not np.array_equal(steps[-1]["topo_order"], epoch["topo_order"])
    assert np.array_equal(epoch["order"].numpy(), epoch["topo_order"])
    assert np.isfinite(float(after["loss"]))
    assert int(steps[0]["heat"].sum()) == int(steps[0]["hits"].sum())
    if worker.CONFIGS[config][0] == "all":
        assert int(steps[0]["overflow"]) > 0 and after["alpha"] > worker.ALPHA
        assert "alpha" in kinds
    if worker.CONFIGS[config][1] == "mesh":
        assert int(steps[0]["sample_overflow"].sum()) > 0


def test_frozen_controller_world(worlds):
    """(ii): a frozen controller observes and decides nothing: every rank's
    losses, parameters and metrics are those of no controller, and of the
    logical frozen run, whose sketch (heat and heavy hitters) every rank's
    equals."""
    res = worlds[2]
    want = _ref(res, "frozen", "frozen", 0)
    for r in res:
        same(r["frozen/frozen"], want)
        same(r["frozen/none"], want)
        same(r["frozen/sketch"], _ref(res, "frozen", "sketch", 0))
    sketch = res[0]["frozen/sketch"]
    assert sketch["decisions"] == [] and sketch["version"] == 0 and sketch["hitters"]


@pytest.mark.parametrize("size,shape", SHAPES)
@pytest.mark.parametrize("name", list(worker.STANDALONE))
def test_standalone_store_world_bitwise(worlds, size, shape, name):
    """(iii): every rank's rows (psum and routed), hits, split, order and
    scales after placement, ``repin`` and the row updates are the logical
    store's; the repin moved no row's value; the updates reached L0, every
    L1 shard and the cold rows; the two rejections left the store bitwise
    as it was."""
    res = worlds[size]
    case = f"store{shape}_{name}"
    want = _ref(res, case, "res", 0)
    for r in res:
        same(r[f"{case}/res"], want, case)
    placed, repinned, updated = want["placed"], want["repinned"], want["updated"]
    assert (placed["version"], repinned["version"], updated["version"]) == (0, 1, 2)
    assert torch.equal(placed["rows"], repinned["rows"])
    assert not torch.equal(placed["order"], repinned["order"])
    ids, rows = want["touched"]
    got = updated["rows"].numpy()[ids + 1]  # row 0 answers id -1
    if name == "int8":
        tol = np.abs(rows).max(1, keepdims=True) / 127
        assert (np.abs(got - rows) <= tol).all()
    else:
        assert np.array_equal(got, rows)
    t = updated["order"].numpy()[ids]
    rep, hot = updated["split"]
    F = int(shape[1])
    shards = {(x - rep) * F // hot for x in t if rep <= x < rep + hot}
    assert shards == set(range(F)) and (t >= rep + hot).any()
    assert (t < rep).any() == (rep > 0)
    assert "duplicate ids" in want["rejected"][0] and "non-finite" in want["rejected"][1]
    same(want["after_rejections"], updated)


@pytest.mark.parametrize("size,shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_split_tuner_world(worlds, size, shape, dtype):
    """(iii): every rank's split tuner moves as the logical store's: mostly
    L1 hits halve the 30-row L0, then hit mass past the boundary doubles it
    back on its second sighting; the rows stay the logical ones."""
    res = worlds[size]
    case = f"split{shape}_{dtype}"
    want = _ref(res, case, "seq", 0)
    for r in res:
        same(r[f"{case}/seq"], want, case)
    assert [s["split"][0] for s in want] == [30, 15, 15, 30, 30]


@pytest.mark.parametrize("size,shape", SHAPES)
def test_streaming_commit_world(worlds, size, shape):
    """(iv): every rank publishes the commit (edge inserts and row updates)
    as the logical store does; the step before ``refresh`` raises, after it
    every tier serves the fresh rows and the next step's loss, parameters,
    metrics and tuners are the logical ones. A failure injected on rank 1
    alone aborts every rank: each raises ``CommitAborted``, the others
    naming rank 1's abort, with the store, the CSR and the versions as
    they were and the batch quarantined. So does a ``RuntimeError`` in
    rank 1's merge (rank 1 raises it as it is; every rank drops the batch,
    where the logical graph, with no world, keeps it staged), and an
    injected abort on rank 1 of a topology-only commit with no store, whose
    world the CSR's shards name; that graph's next commit publishes on
    every rank as on the logical one."""
    res = worlds[size]
    want = _ref(res, "stream", "res", 0)
    said_keys = ("aborted", "crash", "bare", "staged_after_crash")
    for rank, r in enumerate(res):
        got = dict(r["stream/res"])
        said = {k: got.pop(k) for k in said_keys}
        same(got, {k: v for k, v in want.items() if k not in said_keys})
        if rank == 1:
            assert "injected commit failure at stage 'features'" in said["aborted"], said
            assert said["crash"] == "RuntimeError: merge_csr ran out of memory", said
            assert "injected commit failure at stage 'merge'" in said["bare"], said
        else:
            for k in ("aborted", "crash", "bare"):
                assert "1 other rank(s) of the world aborted this commit" in said[k], said
            assert said["crash"].startswith("CommitAborted: "), said
            assert said["bare"].startswith("CommitAborted: "), said
        assert said["staged_after_crash"] == (0, 2), said
    assert "injected commit failure" in want["aborted"]
    assert want["crash"] == "RuntimeError: merge_csr ran out of memory"
    assert "injected commit failure at stage 'merge'" in want["bare"]
    assert want["staged_after_crash"] == (1, 1)
    kept, now, indptr_kept, topo_version, bare_staged, bare_quarantined = \
        want["intact_after_crash"]
    same(now, kept)
    assert indptr_kept and topo_version == 1 and (bare_staged, bare_quarantined) == (0, 1)
    assert want["bare_published"][0] == 2
    assert want["result"][1:] == (len(want["touched"][0]), 64)
    assert want["stale"] == "VersionMismatchError"
    ids, rows = want["touched"]
    got = want["store"]["rows"].numpy()[ids + 1]
    assert (np.abs(got - rows) <= np.abs(rows).max(1, keepdims=True) / 127).all()
    before, after, indptr_kept, topo_version, quarantined = want["intact"]
    same(after, before)
    assert indptr_kept and topo_version == 1 and quarantined == 1
    assert np.isfinite(float(want["next"]["loss"]))


def test_audit_records_the_logical_collectives(worlds):
    """(v): a rank's recorded controlled step carries the logical (1, 2)
    step's collective list, the heat histogram's sum over the world
    included."""
    res = worlds[2]
    want = _ref(res, "audit", "ctl", 0)
    heat = ("psum", ("data", "feature"), (worker.HEAT_BINS,), "int32")
    assert heat in [tuple(c) for c in want]
    for r in res:
        assert r["audit/ctl"] == want


def test_world_tuners_equal_jax(worlds):
    """The (2, 2) world's 4 steps on JAX's draws and parameters against
    JAX's: the alpha trajectory, the overflow counts, tier hits, boundary
    moves and decision lists equal, the sketch's heat and heavy hitters
    equal, the losses within 1e-5 relative, on every rank."""
    want, sketch = worlds["jax"]
    assert want[-1]["alpha"] > worker.ALPHA and want[0]["overflow"] > 0
    assert len({s["rep_rows"] for s in want}) > 1
    for r in worlds[4]:
        got = r["jax/steps"]
        np.testing.assert_allclose([float(s["loss"]) for s in got], [s["loss"] for s in want],
                                   rtol=1e-5)
        assert [s["alpha"] for s in got] == [s["alpha"] for s in want]
        assert [int(s["overflow"]) for s in got] == [s["overflow"] for s in want]
        assert [s["hits"].tolist() for s in got] == [s["hits"] for s in want]
        assert [s["rep_rows"] for s in got] == [s["rep_rows"] for s in want]
        assert got[-1]["decisions"] == want[-1]["decisions"]
        assert np.array_equal(got[-1]["heat"], sketch["heat"])
        assert got[-1]["hitters"] == sketch["hitters"]
