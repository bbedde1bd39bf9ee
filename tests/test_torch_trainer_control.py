"""``DistributedTrainer(auto_alpha=, controller=)`` of quiver_tpu_torch
against quiver_tpu's, on the CPU: the shared ``routed_alpha`` tuner, the
cache controller's heat feed and epoch hooks, and a store's split tuner
under the trainer.

JAX runs its fused step in ``shard_map`` on the forced host devices, a
``(data=2, feature=2)`` mesh under ``seed_sharding="all"``; the port runs
the same mesh as four workers in turn on one CPU device. Both sides get
the same draws (``draw_fn`` replays JAX's key chain,
``tests/test_torch_fused_trainer.py``), the same initial parameters
(``models/convert.py``) and dropout 0. The store is a three-tier
``ShardedFeature`` (an L0 block, a sharded L1, a cold tier).

The counterparts of ``tests/test_sharded_topology.py``'s
``test_trainer_shared_auto_alpha_tuner``, ``tests/test_controller.py``'s
``test_frozen_controller_bitwise_parity`` and ``tests/test_threetier.py``'s
``test_trainer_replicate_budget_override_and_auto_split_consumption``.

Tolerances:
- the ``routed_alpha`` trajectory, the per-step overflow counts and tier
  hits, the boundary moves, the controller's heat histogram and heavy
  hitters: equal;
- the losses of SGD steps against JAX's: 1e-5 relative (the two
  frameworks order their float sums differently,
  ``tests/test_torch_fused_trainer.py``'s bar);
- the port against itself (a frozen controller against none, a repinned
  store against the same store unpinned): bitwise.
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
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.trainer import DistributedTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import (  # noqa: E402
    FEATURE_ROW_HEAT,
    ROUTED_OVERFLOW,
    TIER_HITS,
)
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402

from test_torch_fused_trainer import SIZES, _cpu_mesh, _labeled_graph, jax_draw_fn  # noqa: E402

LOCAL = 32
ROW_B = 4 * 4  # float32 rows of the planted graph's 4 features
STORE = {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B}
ALPHA = 0.05  # tight enough that the buckets overflow
STEPS = 4


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


def _seeds(n, global_batch, steps=STEPS):
    rng = np.random.default_rng(3)
    return [rng.integers(0, n, global_batch) for _ in range(steps)]


def _jax_trainer(graph, topo_sharding="replicated", store=None, **kw):
    ei, feat, _ = graph
    topo = qj.CSRTopo(edge_index=ei)
    mesh = make_mesh_j(data=2, feature=2, devices=jax.devices()[:4])
    feature = ShardedFeatureJ(mesh, csr_topo=topo, routed_alpha=ALPHA,
                              **(store or STORE)).from_cpu_tensor(feat)
    extra = {"topo_sharding": "mesh", "mesh": mesh} if topo_sharding == "mesh" else {}
    sampler = qj.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9, **extra)
    return TrainerJ(mesh, sampler, feature,
                    SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0),
                    optax.sgd(0.1), local_batch=LOCAL, seed_sharding="all",
                    routed_alpha=ALPHA, **kw)


def _jax_steps(trainer, graph, steps=STEPS):
    """``steps`` SGD steps keyed ``PRNGKey(5 + t)``: the initial
    parameters and, per step, the loss, ``routed_alpha`` after it, the
    overflow counts, the tier hits and the split."""
    params, opt = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    lab = jnp.asarray(graph[2].astype(np.int32))
    out = []
    for t, seeds in enumerate(_seeds(trainer.sampler.csr_topo.node_count,
                                     trainer.global_batch, steps)):
        params, opt, loss = trainer.step(params, opt, seeds, lab, jax.random.PRNGKey(5 + t))
        sov = trainer.last_sample_overflow
        out.append({"loss": float(loss), "alpha": trainer.routed_alpha,
                    "routed_overflow": int(np.asarray(trainer.last_routed_overflow)),
                    "sample_overflow": None if sov is None else np.asarray(sov).tolist(),
                    "hits": np.asarray(trainer.last_tier_hits).tolist(),
                    "rep_rows": trainer.feature.rep_rows})
    return params0, out


def _port_trainer(graph, topo_sharding="replicated", params0=None, optimizer="sgd",
                  store=None, alpha=ALPHA, **kw):
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    mesh = _cpu_mesh(2, 2)
    feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=ALPHA,
                                **(store or STORE)).from_cpu_tensor(feat)
    extra = ({"topo_sharding": "mesh", "mesh": mesh} if topo_sharding == "mesh"
             else {"device": "cpu"})
    sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9, **extra)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    trainer = DistributedTrainer(mesh, sampler, feature, model, opt, local_batch=LOCAL,
                                 seed_sharding="all", routed_alpha=alpha, **kw)
    trainer.init(0)
    if params0 is not None:
        model.load_state_dict(flax_sage_to_state_dict(params0))
    trainer.draw_fn = jax_draw_fn
    return trainer


def _labels(graph):
    return torch.from_numpy(graph[2].astype(np.int32))


def _port_steps(trainer, graph, steps=STEPS):
    out = []
    for t, seeds in enumerate(_seeds(trainer.sampler.csr_topo.node_count,
                                     trainer.global_batch, steps)):
        loss = trainer.step(seeds, _labels(graph), 5 + t)
        out.append({"loss": float(loss), "alpha": trainer.routed_alpha,
                    "routed_overflow": int(trainer.last_routed_overflow),
                    "sample_overflow": trainer.last_sample_overflow.tolist(),
                    "hits": trainer.last_tier_hits.tolist(),
                    "rep_rows": trainer.feature.rep_rows})
    return out


def _assert_same_steps(got, want, sample_overflow=True):
    np.testing.assert_allclose([s["loss"] for s in got], [s["loss"] for s in want], rtol=1e-5)
    keys = ["alpha", "routed_overflow", "hits", "rep_rows"]
    if sample_overflow:
        keys.append("sample_overflow")
    for key in keys:
        assert [s[key] for s in got] == [s[key] for s in want], key


@pytest.mark.parametrize("topo_sharding", ["mesh", "replicated"])
def test_auto_alpha_trajectory_equals_jax(graph, topo_sharding):
    """``auto_alpha=True`` from ``routed_alpha=0.05``: one tuner reads the
    routed lookup's and (topology-sharded) the hops' overflow of the
    previous step and doubles the shared budget; the alphas, every step's
    overflow counts and tier hits and the losses are JAX's, alpha grows
    after the first overflowing step, and the grown alpha caps the next
    step's hops (``sample_group`` receives it)."""
    params0, want = _jax_steps(_jax_trainer(graph, topo_sharding, auto_alpha=True), graph)
    trainer = _port_trainer(graph, topo_sharding, params0=params0, auto_alpha=True)
    assert trainer.controller is not None and trainer.controller.heat_bins == 0
    assert trainer.feature._controller is None  # alpha-only: not attached
    alphas = []
    if topo_sharding == "mesh":
        group = trainer.sampler.sample_group

        def recording(*a, **kw):
            alphas.append(kw["routed_alpha"])
            return group(*a, **kw)

        trainer.sampler.sample_group = recording
    got = _port_steps(trainer, graph)
    _assert_same_steps(got, want, sample_overflow=topo_sharding == "mesh")
    assert got[0]["alpha"] == ALPHA and got[0]["routed_overflow"] > 0
    assert got[-1]["alpha"] > ALPHA
    if topo_sharding == "mesh":
        # the tuner runs before each step: two feature groups per step,
        # each capped by the alpha the step ran with
        assert alphas == [s["alpha"] for s in got for _ in range(2)]
        assert sum(sum(s["sample_overflow"]) for s in got) > 0


def test_auto_alpha_off_keeps_alpha_and_losses(graph):
    """Without the tuner alpha never moves; with it, the overflowed lanes
    were served exactly, so the losses of uncapped buckets are those of
    ``auto_alpha=True`` bitwise (the port against itself)."""
    fixed = _port_steps(_port_trainer(graph, auto_alpha=False, optimizer="adam"), graph)
    assert {s["alpha"] for s in fixed} == {ALPHA}
    tuned = _port_steps(_port_trainer(graph, auto_alpha=True, optimizer="adam"), graph)
    uncapped = _port_steps(_port_trainer(graph, optimizer="adam", alpha=None), graph)
    assert {s["routed_overflow"] for s in uncapped} == {0} and fixed[0]["routed_overflow"] > 0
    assert [s["loss"] for s in tuned] == [s["loss"] for s in fixed] == \
        [s["loss"] for s in uncapped]


@pytest.fixture(scope="module")
def frozen_jax(graph):
    ctl = qj.CacheController(frozen=True)
    trainer = _jax_trainer(graph, controller=ctl)
    params0, steps = _jax_steps(trainer, graph, 3)
    return params0, steps, ctl


def test_frozen_controller_bitwise_parity(graph, frozen_jax):
    """A frozen controller observes everything and decides nothing: the
    losses, parameters and telemetry bitwise those of ``controller=None``
    (the port against itself), and against JAX's frozen run the losses,
    the step's heat histogram folded into the sketch and the heavy
    hitters of the seeds equal."""
    params0, want, ctl_j = frozen_jax
    runs = {}
    for name, ctl in (("none", None), ("frozen", qt.CacheController(frozen=True))):
        trainer = _port_trainer(graph, params0=params0, controller=ctl)
        steps = _port_steps(trainer, graph, 3)
        telemetry = {m: trainer.metrics.snapshot(m).numpy for m in (ROUTED_OVERFLOW, TIER_HITS)}
        runs[name] = (steps, dict(trainer.model.state_dict()), telemetry, trainer)
    (s0, p0, t0, _), (s1, p1, t1, tr) = runs["none"], runs["frozen"]
    assert [s["loss"] for s in s0] == [s["loss"] for s in s1]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(np.array_equal(t0[k], t1[k]) for k in t0)
    _assert_same_steps(s1, want, sample_overflow=False)
    ctl = tr.controller
    assert tr.feature._controller is ctl and FEATURE_ROW_HEAT in tr.metrics.names()
    assert ctl.stats()["decisions"] == 0 and not ctl.decisions
    assert ctl.sketch.total_mass > 0 and ctl.stats()["observed"] == ctl_j.stats()["observed"]
    assert np.array_equal(ctl.sketch.heat, ctl_j.sketch.heat)
    assert ctl.sketch.state()["hitters"] == ctl_j.sketch.state()["hitters"]
    assert int(tr.metrics.value(FEATURE_ROW_HEAT).sum()) == sum(s1[-1]["hits"])


def test_trainer_auto_split_consumes_hits_as_jax(graph):
    """``test_trainer_replicate_budget_override_and_auto_split_consumption``:
    the trainer's ``replicate_budget=`` re-splits an ``auto_split`` store
    to one L0 row; the step's hit totals then move the boundary between
    steps (a one-row L0 serves far under 1/8 of the traffic, so it
    shrinks away), step for step as JAX's, and the losses are JAX's."""
    store = dict(STORE, replicate_budget=8 * ROW_B, auto_split=True)
    jt = _jax_trainer(graph, store=store, replicate_budget=ROW_B)
    assert jt.feature.rep_rows == 1
    params0, want = _jax_steps(jt, graph)
    trainer = _port_trainer(graph, params0=params0, store=store, replicate_budget=ROW_B)
    got = _port_steps(trainer, graph)
    _assert_same_steps(got, want, sample_overflow=False)
    assert {s["rep_rows"] for s in got} == {1, 0}


def test_repin_needs_refresh_and_keeps_the_losses(graph):
    """A ``repin`` bumps the store's version: the next step raises
    ``VersionMismatchError`` until ``refresh()``; after it the step's rows
    are the same rows (moved with their bytes), so its loss and
    parameters are bitwise a trainer's that never repinned."""
    ref = _port_trainer(graph, optimizer="adam")
    trainer = _port_trainer(graph, optimizer="adam")
    seeds = _seeds(300, ref.global_batch, 2)
    for tr in (ref, trainer):
        tr.step(seeds[0], _labels(graph), 5)
    trainer.feature.repin(np.arange(40)[::-1].copy())
    with pytest.raises(qt.VersionMismatchError):
        trainer.step(seeds[1], _labels(graph), 6)
    assert trainer.refresh() is trainer
    loss = trainer.step(seeds[1], _labels(graph), 6)
    assert torch.equal(loss, ref.step(seeds[1], _labels(graph), 6))
    a, b = ref.model.state_dict(), trainer.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_epoch_end_repins_and_the_next_step_runs(graph):
    """``epoch_scan`` ends with the controller's hooks: the epoch's heat
    and summed tier hits observed, then ``end_epoch`` repins the store to
    the measured-hot seeds (the controller refreshes the trainer), so the
    next step runs, and a repinned lookup is bitwise the dense rows."""
    ctl = qt.CacheController(heat_bins=16, repin_min_gain=0.0)
    trainer = _port_trainer(graph, controller=ctl, optimizer="adam")
    trainer.draw_fn = None
    n = trainer.sampler.csr_topo.node_count
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, n, 3 * trainer.global_batch),
                             seed=2)
    losses = trainer.epoch_scan(mat, _labels(graph), 11)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert trainer.metrics.value(FEATURE_ROW_HEAT).shape == (3, 16)
    assert ctl.stats()["repins"] == 1 and trainer.feature.version == 1
    assert trainer._bound_versions == trainer._current_versions()
    assert trainer.feature.last_tier_hits is None  # the repin voided the epoch's hits
    loss = trainer.step(np.arange(trainer.global_batch) % n, _labels(graph), 12)
    assert np.isfinite(float(loss))
    feat = graph[1]
    ids = torch.arange(-1, n, dtype=torch.int32)
    rows = trainer.feature.gather(ids).numpy()
    assert np.array_equal(rows[1:], feat) and not rows[0].any()


def test_row_update_reaches_the_next_step(graph):
    """``apply_row_updates`` bumps the version; after ``refresh()`` the
    next step's gathered rows hold the new values in every tier."""
    trainer = _port_trainer(graph)
    trainer.draw_fn = None
    n = trainer.sampler.csr_topo.node_count
    order = trainer.feature.feature_order.numpy()
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    end = trainer.feature.rep_rows + trainer.feature.hot_rows
    ids = np.array([inv[0], inv[trainer.feature.rep_rows], inv[end]])
    rows = np.full((3, 4), 7.0, np.float32)
    trainer.feature.apply_row_updates(ids, rows)
    with pytest.raises(qt.VersionMismatchError):
        trainer.step(ids, _labels(graph), 1)
    trainer.refresh()
    blocks = []
    issue = trainer._issue
    trainer._issue = lambda *a: blocks.append(issue(*a)) or blocks[-1]
    trainer.step(np.repeat(ids, trainer.global_batch // 3 + 1)[:trainer.global_batch],
                 _labels(graph), 1)
    for b in blocks[0].blocks:
        seeds = b.n_id[:int(b.num_seeds)]
        assert bool((b.x[:seeds.shape[0]] == 7.0).all())
