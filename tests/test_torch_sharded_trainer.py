"""``DistributedTrainer`` of quiver_tpu_torch over a ``ShardedFeature``
against quiver_tpu's, on the CPU, and the twin of
``examples/train_multichip.py``.

JAX runs the fused step in ``shard_map`` on its forced host devices (a
``(data=2, feature=2)`` mesh); the port runs the same mesh as four workers
in turn on one CPU device, with the psum flavour under
``seed_sharding="data"`` and the routed one under ``"all"``. Both sides get
the same sample draws (``draw_fn`` replays JAX's key chain, as
``tests/test_torch_fused_trainer.py`` does), the same initial parameters
(``models/convert.py``) and dropout 0. The store has all three tiers: an
L0 block, a sharded L1 and a cold tier, over the degree order.

Tolerances, float32:
- the losses of 3 SGD steps at lr 0.1: 1e-5 relative; the parameters after
  them: 1e-5 relative and 1e-6 absolute (the two frameworks order their
  float sums differently; ``tests/test_torch_fused_trainer.py``'s bars);
- tier hits and routed overflow of every step: equal integers;
- the port's sharded step against its step over a replicated ``Feature``
  of the same rows, depth 1 against depth 0, a resumed epoch against the
  uninterrupted one: bitwise (one device, the same ops on the same rows).
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
from quiver_tpu.parallel.trainer import DataParallelTrainer as DPTrainerJ  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.parallel.trainer import (  # noqa: E402
    DataParallelTrainer,
    DistributedTrainer,
)

from test_torch_fused_trainer import SIZES, _cpu_mesh, _labeled_graph, jax_draw_fn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL = 32
ROW_B = 4 * 4  # float32 rows of the planted graph's 4 features
STORE = {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B}
STEPS = 3


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


def _seeds(n, global_batch):
    rng = np.random.default_rng(3)
    return [rng.integers(0, n, global_batch) for _ in range(STEPS)]


@pytest.fixture(scope="module", params=["data", "all"])
def jax_run(request, graph):
    """JAX's fused trainer over a three-tier sharded store on a (2, 2)
    mesh, SGD 0.1, 3 steps: the initial parameters, every step's loss,
    tier hits and routed overflow, and the parameters after."""
    seed_sharding = request.param
    ei, feat, labels = graph
    topo = qj.CSRTopo(edge_index=ei)
    n = topo.node_count
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=0.05,
                              **STORE).from_cpu_tensor(feat)
    assert feature.rep_rows and feature.hot_rows and feature.cold is not None
    trainer = TrainerJ(mesh, qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL,
                                                 seed=9),
                       feature, SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                       optax.sgd(0.1), local_batch=LOCAL, seed_sharding=seed_sharding,
                       routed_alpha=0.05)
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    lab = jnp.asarray(labels.astype(np.int32))
    losses, hits, ovs = [], [], []
    for t, seeds in enumerate(_seeds(n, trainer.global_batch)):
        params, opt, loss = trainer.step(params, opt, seeds, lab, jax.random.PRNGKey(5 + t))
        losses.append(float(loss))
        hits.append(np.asarray(trainer.last_tier_hits).tolist())
        ovs.append(int(np.asarray(trainer.last_routed_overflow)))
    return {"seed_sharding": seed_sharding, "params0": params0,
            "params": jax.tree_util.tree_map(np.asarray, params), "losses": losses,
            "hits": hits, "overflow": ovs, "split": (feature.rep_rows, feature.hot_rows)}


def _port_trainer(graph, seed_sharding, store="sharded", params0=None, optimizer="sgd",
                  **kw):
    """The port's trainer on a (2, 2) CPU mesh over a three-tier sharded
    store (or, ``store="replicated"``, a ``Feature`` of the same rows),
    holding JAX's initial parameters (or ``init(0)``'s) and replaying JAX's
    draws."""
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    mesh = _cpu_mesh(2, 2)
    if store == "sharded":
        feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05,
                                    **STORE).from_cpu_tensor(feat)
    else:
        feature = qt.Feature(device_cache_size=100 * ROW_B, csr_topo=topo,
                             device="cpu").from_cpu_tensor(feat)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    trainer = DistributedTrainer(
        mesh, qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=LOCAL,
                                  seed=9),
        feature, model, opt, local_batch=LOCAL, seed_sharding=seed_sharding,
        routed_alpha=0.05, **kw)
    trainer.init(0)
    if params0 is not None:
        model.load_state_dict(flax_sage_to_state_dict(params0))
    trainer.draw_fn = jax_draw_fn
    return trainer


def _labels(graph):
    return torch.from_numpy(graph[2].astype(np.int32))


def test_sharded_steps_equal_jax(graph, jax_run):
    """Three steps of each flavour on JAX's draws and parameters: the
    losses, every step's tier hits and routed overflow (the routed
    flavour's tight buckets overflow and the fallback serves them), then
    every parameter."""
    trainer = _port_trainer(graph, jax_run["seed_sharding"], params0=jax_run["params0"])
    assert (trainer.feature.rep_rows, trainer.feature.hot_rows) == jax_run["split"]
    labels = _labels(graph)
    losses, hits, ovs = [], [], []
    for t, seeds in enumerate(_seeds(trainer.sampler.csr_topo.node_count,
                                     trainer.global_batch)):
        loss = trainer.step(seeds, labels, 5 + t)
        losses.append(float(loss))
        hits.append(trainer.last_tier_hits.tolist())
        ovs.append(int(trainer.last_routed_overflow))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    assert hits == jax_run["hits"] and ovs == jax_run["overflow"]
    assert all(h[0] > 0 and h[1] > 0 and h[2] > 0 for h in hits)  # every tier served
    if jax_run["seed_sharding"] == "all":
        assert sum(ovs) > 0  # the fallback ran
    else:
        assert ovs == [0] * STEPS  # the psum flavour routes nothing
    assert torch.equal(trainer.feature.last_tier_hits, trainer.last_tier_hits)
    want = flax_sage_to_state_dict(jax_run["params"])
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
def test_sharded_step_bitwise_replicated(graph, seed_sharding):
    """The sharded store's step is the replicated ``Feature``'s step
    bitwise: the same ids, the same rows, so the same losses and Adam
    parameters; only the tier hits differ."""
    out = {}
    for store in ("sharded", "replicated"):
        trainer = _port_trainer(graph, seed_sharding, store, optimizer="adam")
        blocks = []
        issue = trainer._issue
        trainer._issue = lambda *a: blocks.append(issue(*a)) or blocks[-1]
        losses = [trainer.step(s, _labels(graph), t) for t, s in enumerate(
            _seeds(trainer.sampler.csr_topo.node_count, trainer.global_batch))]
        out[store] = (losses, blocks, dict(trainer.model.state_dict()))
    (la, ba, pa), (lb, bb, pb) = out["sharded"], out["replicated"]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for sa, sb in zip(ba, bb):
        for a, b in zip(sa.blocks, sb.blocks):
            assert torch.equal(a.n_id, b.n_id) and torch.equal(a.x, b.x)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def _epoch(trainer, graph, **kw):
    n = trainer.sampler.csr_topo.node_count
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, n, 4 * trainer.global_batch),
                             seed=2)
    return mat, trainer.epoch_scan(mat, _labels(graph), 11, **kw)


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
def test_epoch_scan_vectors_and_depth1_bitwise(graph, seed_sharding):
    """``epoch_scan`` keeps a ``(steps, 3)`` tier-hit matrix and a
    ``(steps,)`` overflow vector (JAX's ``test_trainer_epoch_scan_*``),
    and at ``pipeline_depth=1`` gives depth 0's losses, metrics and
    parameters bitwise (depth 1 issues a whole feature group ahead)."""
    runs = {}
    for depth in (0, 1):
        trainer = _port_trainer(graph, seed_sharding, optimizer="adam", pipeline_depth=depth)
        trainer.draw_fn = None
        _, losses = _epoch(trainer, graph)
        runs[depth] = (losses, trainer.last_tier_hits, trainer.last_routed_overflow,
                       dict(trainer.model.state_dict()))
    (l0, h0, o0, p0), (l1, h1, o1, p1) = runs[0], runs[1]
    assert h0.shape == (4, 3) and o0.shape == (4,) and bool((h0[:, 0] > 0).all())
    assert bool(torch.isfinite(l0).all())
    assert torch.equal(l0, l1) and torch.equal(h0, h1) and torch.equal(o0, o1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    if seed_sharding == "all":
        assert int(o0.sum()) > 0


def test_resume_and_guard_with_sharded_store(graph, tmp_path):
    """Checkpoints every 2 steps; a fresh trainer resumes the epoch at
    step 2 and ends bitwise the uninterrupted run; the guard skips the
    planned NaN step of a sharded store's epoch as of a replicated one's."""
    ref = _port_trainer(graph, "all", optimizer="adam")
    ref.draw_fn = None
    mat, want = _epoch(ref, graph)
    first = _port_trainer(graph, "all", optimizer="adam", checkpoint_dir=tmp_path / "ck",
                          checkpoint_every=2,
                          fault_plan=qt.FaultPlan(preempt_at_step=3))
    first.draw_fn = None
    with pytest.raises(qt.Preemption):
        first.epoch_scan(mat, _labels(graph), 11)
    again = _port_trainer(graph, "all", optimizer="adam", checkpoint_dir=tmp_path / "ck",
                          checkpoint_every=2)
    again.draw_fn = None
    _, _, key, step, epoch = again.resume()
    assert (key, step, epoch) == (11, 2, 0)
    rest = again.epoch_scan(mat, _labels(graph), key, epoch=epoch, start_step=step)
    assert torch.equal(rest, want[2:])
    ref_state, got_state = ref.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(ref_state[k], got_state[k]) for k in ref_state)
    guarded = _port_trainer(graph, "all", optimizer="adam", nonfinite_guard=True,
                            fault_plan=qt.FaultPlan(nan_feature_steps=(1,), nan_rows=4))
    guarded.draw_fn = None
    _, losses = _epoch(guarded, graph)
    assert int(guarded.metrics.value("resilience.skipped_steps").sum()) == 1
    assert not np.isfinite(float(losses[1])) and bool(torch.isfinite(losses[2:]).all())


def test_replicate_budget_override(graph):
    """``replicate_budget=`` re-splits the sharded store before the first
    step (JAX's override), the rows serve the same, and the hits move to
    L0; on a replicated store it stays inert."""
    trainer = _port_trainer(graph, "all", replicate_budget=5 * ROW_B)
    assert trainer.feature.rep_rows == 5
    wide = _port_trainer(graph, "all", replicate_budget=60 * ROW_B)
    assert wide.feature.rep_rows == 60
    ids = torch.arange(-1, 300, dtype=torch.int32)
    assert torch.equal(trainer.feature[ids], wide.feature[ids])
    assert int(wide.feature.last_tier_hits[0]) > int(trainer.feature.last_tier_hits[0])
    plain = _port_trainer(graph, "data", store="replicated", replicate_budget="1M")
    assert plain.feature.hot_rows == 100


def test_trainer_takes_sharded_store_and_dp_rejects_it(graph):
    """The fused trainer takes a ``ShardedFeature`` (``feature.mesh`` must
    be the trainer's shape); ``DataParallelTrainer`` refuses one with JAX's
    ``ValueError``."""
    ei, feat, _ = graph
    trainer = _port_trainer(graph, "data")
    assert isinstance(trainer.feature, qt.ShardedFeature) and trainer.workers == 2
    store = qt.ShardedFeature(_cpu_mesh(4, 1), device_cache_size="1M").from_cpu_tensor(feat)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    sampler = qt.GraphSageSampler(qt.CSRTopo(edge_index=ei), [3], device="cpu", seed=0)
    with pytest.raises(ValueError, match="mesh"):
        DistributedTrainer(_cpu_mesh(2, 2), sampler, store, model,
                           torch.optim.SGD(model.parameters(), lr=0.1), local_batch=8)
    msgs = []
    mesh_j = make_mesh_j(data=4, feature=1, devices=jax.devices()[:4])
    store_j = ShardedFeatureJ(mesh_j, device_cache_size="1M").from_cpu_tensor(feat)
    for build in (
            lambda: DPTrainerJ(mesh_j, qj.GraphSageSampler(qj.CSRTopo(edge_index=ei), [3]),
                               store_j, SageJ(hidden=8, num_classes=4, num_layers=1),
                               optax.sgd(0.1), local_batch=8),
            lambda: DataParallelTrainer(_cpu_mesh(4, 1), sampler, store, model,
                                        torch.optim.SGD(model.parameters(), lr=0.1),
                                        local_batch=8)):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "DataParallelTrainer" in msgs[0]


def _twin(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "examples.train_multichip_torch", "--device", "cpu",
         "--nodes", "3000", "--avg-degree", "8", "--feature-dim", "16", "--hidden", "32",
         "--classes", "4", "--fanout", "5", "5", "--local-batch", "32", "--steps", "101",
         "--data-axis", "2", "--feature-axis", "2", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("seed_sharding", ["data", "all"])
def test_multichip_twin_runs_on_the_cpu(seed_sharding):
    """``examples/train_multichip_torch.py --device cpu`` at a small size:
    it prints the mesh, its loss falls (the mean of the last three printed
    losses below the first three's; the labels are random, as the JAX
    example's, so the loss falls toward ln 4 as the model drops its
    initial guesses), and it prints the tier hits (and, routed, the
    overflow)."""
    out = _twin("--seed-sharding", seed_sharding, "--replicate-budget", "4K")
    lines = out.splitlines()
    assert "mesh over 4 devices: {'data': 2, 'feature': 2}" in lines[0]
    losses = [float(ln.split("loss ")[1]) for ln in lines if ln.startswith("step ")
              and "loss" in ln]
    assert len(losses) == 10 and np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert any(ln.startswith("feature tier hits (last step): L0 replicated") for ln in lines)
    assert any(ln.startswith("routed overflow") for ln in lines) == (seed_sharding == "all")
