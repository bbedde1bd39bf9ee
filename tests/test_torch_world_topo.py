"""The port's topology-sharded samplers, their trainer, rank-0 checkpoints
and the elastic resume on a world of ``gloo`` CPU processes, held against
the logical mesh of the same shape, bitwise, and one ``(2, 2)`` step
against the JAX package's trainer.

Three worlds are spawned (``tests/torch_world_topo_worker.py``, joined
through a file store under ``tmp_path``, each child at one thread; rank 0
also runs the logical references at that thread count): a world of 2 on
``(1, 2)`` (shards, samplers, the typed sampler); a world of 4 on ``(2,
2)`` and ``(1, 4)`` (shards, samplers, the trainer, checkpoints, the
elastic runs and the JAX replay); then a world of 2 that resumes the world
of 4's preempted elastic run. This file compares them:

- (i) each rank's shard of the plain and the typed CSR is the logical
  partition's shard ``d``, and its bytes are one shard's;
- (ii) ``DistGraphSageSampler`` on ``(1, 2)`` and ``(2, 2)``: uniform,
  weighted and temporal; capped (overflowing), uncapped and auto caps;
  ``sample()`` (the same merged output on every rank), the rank's
  ``sample_per_worker`` and its ``sample_padded``;
- (iii) ``DistHeteroSampler``, uniform and weighted, on ``(1, 2)``; a
  ``StreamingGraph`` over a world store: a commit of row updates
  publishes into every rank's parts as into the logical store, a
  topology-only commit runs and the sampler's refreshed shard samples as
  the logical one;
- (iv) ``DistributedTrainer`` over a topology-sharded sampler on ``(2,
  2)``: 3 steps (the guard skips step 1, whose rows a ``FaultPlan``
  poisons) and a 3-step ``epoch_scan``, at depth 0 and 1; the program
  audit records the same collectives for a rank's step as for the
  logical ``(1, 2)`` step;
- (v) checkpoints: rank 0 alone writes; a corrupt newest checkpoint is
  quarantined once and every rank restores the older step; a world
  checkpoint restores on the logical mesh and a logical one on the world;
  a rank that cannot see the directory makes every rank raise;
- (vi) elastic: a world of 4 on ``(1, 4)`` with ``logical_workers=4`` is
  preempted at step 3 of 9 and a world of 2 on ``(1, 2)`` resumes it; an
  in-place ``(2, 2)`` -> ``(1, 4)`` replan on 4 ranks; both tails bitwise
  the uninterrupted logical ``(1, 4)`` run; ``worker_ordered_mean`` over
  the world bitwise the logical fold;
- (vii) one ``(2, 2)`` topology-sharded world step on the JAX trainer's
  draws and initial parameters against JAX's ``DistributedTrainer``,
  within ``tests/test_torch_topo_sharded_trainer.py``'s tolerances (loss
  1e-5 relative; parameters 1e-5 relative and 1e-6 absolute; the integer
  counters equal).

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

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402

import torch_world_topo_worker as worker  # noqa: E402
from test_torch_fused_trainer import jax_draw_fn  # noqa: E402
from test_torch_world import _join, _ref, same  # noqa: E402
from torch_world_worker import GRAPH, LOCAL, SIZES, STORES  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_world_topo_worker.py")
PAIR = "topo:12,sampler:12,hetero:12,audit:12,stream:12"
QUAD = "topo:22,sampler:22,trainer:22,ckpt:22,elastic"
JAX_KEY = 5
JAX_ALPHA = 0.25


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


def _jax_inputs(tmp):
    """JAX's (2, 2) step over a topology-sharded sampler and a three-tier
    store, and the draws and initial parameters that the children replay:
    the draws are recorded from the port's logical (2, 2) step on JAX's key
    chain (its asks equal the world's, bitwise)."""
    ei, feat, labels = GRAPH
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=JAX_ALPHA,
                              **STORES[None]).from_cpu_tensor(feat)
    sampler = qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  topo_sharding="mesh", mesh=mesh)
    trainer = TrainerJ(mesh, sampler, feature,
                       SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all",
                       routed_alpha=JAX_ALPHA)
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    seeds = np.random.default_rng(3).integers(0, topo.node_count, trainer.global_batch)
    params, _, loss = trainer.step(params, opt, seeds, jnp.asarray(labels.astype(np.int32)),
                                   jax.random.PRNGKey(JAX_KEY))
    want = {"loss": float(loss), "hits": np.asarray(trainer.last_tier_hits).tolist(),
            "overflow": int(np.asarray(trainer.last_routed_overflow)),
            "sample_overflow": np.asarray(trainer.last_sample_overflow).tolist(),
            "params": flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params))}

    draws = {}

    def record(key, w, layer, deg):
        draws[f"{key}:{w}:{layer}"] = out = jax_draw_fn(key, w, layer, deg)
        return out

    port = worker.topo_trainer(qt.make_mesh(data=2, feature=2, devices=["cpu"] * 4),
                               optimizer="sgd", dropout=0.0, alpha=JAX_ALPHA)
    port.model.load_state_dict(params0)
    port.draw_fn = record
    port.step(seeds, torch.from_numpy(labels.astype(np.int32)), JAX_KEY)
    path = tmp / "jax_draws.pt"
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save({"draws": draws, "params0": params0, "seeds": torch.from_numpy(seeds),
                "key": JAX_KEY}, path)
    return path, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results: the world of 2 runs while the parent computes
    JAX's step and then while the world of 4 runs (with the JAX replay);
    the resume world of 2 follows the world of 4."""
    root = tmp_path_factory.mktemp("worlds_topo")
    pair = _spawn(2, PAIR, root / "pair")
    try:
        draws, want = _jax_inputs(root / "jax")
        quad = _spawn(4, f"{QUAD},jax:{draws}", root / "quad")
        quad_res = _join(quad)
        again = _spawn(2, f"resume:{root / 'quad' / 'elastic14'}", root / "resume")
        resume_res = _join(again)
    finally:
        pair_res = _join(pair)
    return {2: pair_res, 4: quad_res, "resume": resume_res, "jax": want,
            "root": root}


@pytest.mark.parametrize("size,shape", [(2, "12"), (4, "22")])
def test_topology_shards_bitwise(worlds, size, shape):
    """(i): each rank's shard (indptr, indices, prefix weights, times) and
    every typed relation's are the logical partition's shard ``d``, with
    the same plan; the rank holds one shard's bytes, the logical mesh
    all F."""
    res = worlds[size]
    F = int(shape[1])
    for rank, r in enumerate(res):
        got = r[f"topo{shape}/out"]
        d = got["member"]
        assert d == rank % F
        want = _ref(res, f"topo{shape}", "out", d)
        same(got["shard"], want["shard"])
        same(got["typed"], want["typed"])
        assert got["plan"] == want["plan"] and got["typed_plan"] == want["typed_plan"]
        assert got["bytes"] == (got["plan"]["per_chip_bytes"],
                                got["typed_plan"]["per_chip_bytes"])
        assert want["bytes"] == (F * got["bytes"][0], F * got["bytes"][1])


@pytest.mark.parametrize("size,shape", [(2, "12"), (4, "22")])
@pytest.mark.parametrize("kind", list(worker.KINDS))
@pytest.mark.parametrize("caps", list(worker.CAPS))
def test_dist_sampler_world_bitwise(worlds, size, shape, kind, caps):
    """(ii): every rank's ``sample()`` is the logical merged output (ids,
    edge lists, counts, overflow, per-hop overflow, planned caps), and its
    ``sample_per_worker`` and ``sample_padded`` blocks are its worker's;
    the capped hops overflow, the uncapped ones do not."""
    res = worlds[size]
    case = f"sampler{shape}_{kind}_{caps}"
    want = _ref(res, case, "out", 0)
    for w, r in enumerate(res):
        same(r[f"{case}/out"], want, case)
        same(r[f"{case}/worker"], _ref(res, case, "worker", w), case)
    ovf = int(want["hop_overflow"].sum())
    assert ovf > 0 if caps == "capped" else ovf == 0
    if caps == "auto":
        assert want["caps"] is not None


@pytest.mark.parametrize("kind", ["uniform", "weighted"])
def test_dist_hetero_world_bitwise(worlds, kind):
    """(iii): ``DistHeteroSampler`` on a world of 2: ``sample()`` (ids of
    every type, every relation's edge list, overflow per (hop, relation))
    and each rank's own worker equal the logical mesh's."""
    res = worlds[2]
    case = f"hetero12_{kind}"
    for w, r in enumerate(res):
        same(r[f"{case}/out"], _ref(res, case, "out", 0), case)
        same(r[f"{case}/own"], _ref(res, case, "own", w), case)


def test_streaming_commit_on_a_world(worlds):
    """(iii): a commit with row updates into a world store publishes on
    every rank: the store's version moves once and every rank's rows
    (psum and routed) are the logical store's, the new values included; a
    topology-only commit runs, and each rank's refreshed sampler samples
    bitwise as the logical one, before and after the commit."""
    res = worlds[2]
    want = _ref(res, "stream", "samples", 0)
    updated = _ref(res, "stream", "updates", 0)
    for r in res:
        same(r["stream/updates"], updated)
        same(r["stream/samples"], want)
    assert list(updated["result"]) == [4, 0] and list(updated["versions"]) == [0, 1]
    ids = [0, 7, 150, 299]
    rows = np.random.default_rng(41).normal(size=(4, 4)).astype(np.float32)
    assert np.array_equal(updated["rows"].numpy()[ids], rows)
    assert torch.equal(updated["rows"], updated["routed"])
    assert not torch.equal(want[0]["n_id"], want[1]["n_id"])


@pytest.mark.parametrize("depth", [0, 1])
def test_topo_sharded_trainer_world_bitwise(worlds, depth):
    """(iv): on (2, 2), each rank's step ids, rows and edge lists are its
    worker's in the logical step, and its losses, tier hits, routed and
    per-hop overflow, guard counters and parameters (after the steps and
    after the epoch) are the logical trainer's; step 1 is skipped by the
    guard; each rank holds one topology shard's bytes."""
    res = worlds[4]
    case = f"trainer22_{depth}"
    want = _ref(res, case, "res", 0)
    for r in res:
        same(r[f"{case}/res"], want, case)
        same(r[f"{case}/blocks"], _ref(res, case, "blocks", r[f"{case}/worker"]), case)
        assert 2 * r[f"{case}/held_bytes"] == _ref(res, case, "held_bytes", 0)
    steps = want["steps"]
    assert [int(np.asarray(s["skipped"])) for s in steps] == [0, 1, 0]
    assert np.isnan(float(steps[1]["loss"]))
    assert sum(int(s["sample_overflow"].sum()) for s in steps) > 0
    assert int(want["epoch"]["sample_overflow"].sum()) > 0


def test_audit_records_the_logical_collectives(worlds):
    """(iv): a rank's recorded topology-sharded step carries the logical
    (1, 2) step's collective list: every hop's routed exchanges, the
    lookup's, the metric sums and the guard's."""
    res = worlds[2]
    want = _ref(res, "audit", "topo", 0)
    assert sum("all_to_all" in str(c) for c in want) >= 2 * len(SIZES)
    for r in res:
        assert r["audit/topo"] == want


def test_checkpoints_rank0_quarantine_and_cross_form(worlds):
    """(v): rank 0 alone wrote the three checkpoints (the other ranks'
    checkpointers are readers), every rank kept the save ids in step; rank
    0 quarantined the corrupt newest one once and every rank restored the
    older step, as a logical trainer restores it; a world trainer restores
    a logical checkpoint; a rank blind to the directory makes all raise."""
    res = worlds[4]
    assert res[0]["ckpt/written"] == ["step-0", "step-1", "step-2"]
    assert [r["ckpt/writer"] for r in res] == [(False, 3)] + [(True, 3)] * 3
    after = res[0]["ckpt/after"]
    quarantined = [name for name in after if "quarantine" in name]
    assert len(quarantined) == 1 and "step-2" in quarantined[0]
    assert sorted(set(after) - set(quarantined)) == ["step-0", "step-1"]
    want = _ref(res, "ckpt", "restored", 0)
    assert want["step"] == 2
    for r in res:
        same(r["ckpt/restored"], want)
        got = r["ckpt/from_logical"]
        assert got["step"] == 3
        same(got["params"], _ref(res, "ckpt", "logical_params", 0))
        assert "not visible to rank(s) [1, 2, 3]" in r["ckpt/blind"], r["ckpt/blind"]


def test_elastic_resume_across_world_sizes(worlds):
    """(vi): a world of 2 resumes the world of 4's run preempted at step 3:
    its 6 remaining losses and the final parameters are the uninterrupted
    logical (1, 4) run's; so is the in-place (2, 2) -> (1, 4) replan's
    tail; a logical mesh passed to a world trainer raises naming the
    process-death flow."""
    quad, pair = worlds[4], worlds["resume"]
    full = _ref(quad, "elastic", "full", 0)
    tail = worker.ELASTIC_STEPS - worker.ELASTIC_PREEMPT
    for rank, r in enumerate(quad):
        assert r["elastic/preempted14"] and r["elastic/preempted22"]
        got = r["elastic/replanned"]
        assert got["step"] == worker.ELASTIC_PREEMPT and got["losses"].shape == (tail,)
        same(got["losses"], full["losses"][worker.ELASTIC_PREEMPT:])
        same(got["params"], full["params"])
        rep, hot, bpd, held = r["elastic/replanned_store"]
        assert bpd == 1 and held == [rank] and hot > 0
    for r in pair:
        got = r["resume/tail"]
        assert got["step"] == worker.ELASTIC_PREEMPT
        same(got["losses"], full["losses"][worker.ELASTIC_PREEMPT:])
        same(got["params"], full["params"])
        assert "resume(mesh=trainer.mesh)" in r["resume/other_form"]


def test_worker_ordered_mean_world_bitwise(worlds):
    """(vi): ``worker_ordered_mean`` of each rank's ``(2, 7)`` block stack
    over the world is the logical left fold of the ``(8, 7)`` stack."""
    res = worlds[4]
    want = _ref(res, "elastic", "wom", 0)
    for r in res:
        same(r["elastic/wom"], want)


def test_topo_sharded_world_step_equals_jax(worlds):
    """(vii): the (2, 2) topology-sharded world step on JAX's draws and
    parameters against JAX's step: loss and parameters within the
    tolerances; tier hits, routed and per-hop overflow equal, on every
    rank."""
    want = worlds["jax"]
    assert sum(want["sample_overflow"]) > 0
    for r in worlds[4]:
        got = r["jax/res"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        assert got["hits"].tolist() == want["hits"]
        assert int(got["overflow"]) == want["overflow"]
        assert got["sample_overflow"].tolist() == want["sample_overflow"]
        for name, value in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
