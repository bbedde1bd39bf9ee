"""``DistributedTrainer.epoch_scan`` of quiver_tpu_torch against its own
serial run, on the CPU: the contracts of ``tests/test_resilience.py``'s
guard and checkpoint tests and ``tests/test_pipelined_epoch.py``'s
(the JAX package's own, which hold its epoch against its step).

- ``epoch_scan`` equals the step loop over the same rows and step keys;
- ``pipeline_depth=1`` is the serial epoch, plain, chunked by checkpoints
  (each later chunk issuing its first batch again, counted) and across a
  preemption and ``resume()``;
- the guard on is the guard off on a clean run; on a NaN step it skips
  exactly that update (Adam's state included), counts it and dumps one
  flight-recorder bundle;
- the preemption drill resumes the uninterrupted run; a corrupt newest
  checkpoint falls back to the previous one; a finished epoch resumes to
  no steps; ``resume()``'s checks;
- GCN, GIN and GAT train through ``epoch_scan``.

On the CPU one run of the port is deterministic, so every comparison of
two trajectories here is bitwise (losses, parameters, optimizer state,
per-step telemetry). Learning: the last epoch's last loss below the first
epoch's first, JAX's bar.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import GAT, GCN, GIN  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import (  # noqa: E402
    GUARD_NONFINITE,
    GUARD_SKIPPED,
    PIPELINE_REISSUES,
    TIER_HITS,
    TRAIN_OVERLAP_EFFICIENCY,
)
from quiver_tpu_torch.parallel.train import init_model  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402

N = 96


def _graph():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, N, size=(2, 800)).astype(np.int64)
    feat = rng.normal(size=(N, 8)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, N).astype(np.int32))
    return ei, feat, labels


def _build(depth=0, guard=False, plan=None, checkpoint_dir=None, checkpoint_every=0,
           model=None, local=32, **kw):
    """``tests/test_resilience.py``'s small trainer (96 nodes, [3, 2]
    fanouts, a global batch of 64) on two data workers, over a store with
    half its rows cold, with Adam."""
    ei, feat, labels = _graph()
    topo = qt.CSRTopo(edge_index=ei)
    store = qt.Feature(device_cache_size=(N // 2) * 8 * 4, csr_topo=topo,
                       device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu", seed=0, seed_capacity=local)
    model = model or GraphSAGE(8, 8, 4, num_layers=2)
    if checkpoint_dir is not None:
        kw.update(checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    trainer = DistributedTrainer(
        qt.make_mesh(data=2, devices=["cpu"] * 2), sampler, store, model,
        torch.optim.Adam(model.parameters(), lr=1e-2), local_batch=local,
        nonfinite_guard=guard, fault_plan=plan, pipeline_depth=depth, **kw)
    trainer.init(0)
    return trainer, labels


def _seed_mat(trainer, reps=6):
    return trainer.pack_epoch(np.tile(np.arange(N), reps), seed=0)


def _state(trainer):
    """Host copies of the parameters and the optimizer's state."""
    params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.optimizer.state_dict()["state"]
    return params, {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                    for i, s in opt.items()}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _bitwise(a, b) -> bool:
    """Bitwise equality of two float tensors, NaNs included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_epoch_scan_matches_step_loop():
    """``test_epoch_scan_matches_step_loop``: the epoch's losses and final
    state are the step loop's over the same rows and step keys."""
    trainer, labels = _build()
    seed_mat = _seed_mat(trainer, 3)
    steps = seed_mat.shape[0]
    assert np.array_equal(np.sort(seed_mat[seed_mat >= 0]),
                          np.sort(np.tile(np.arange(N), 3)))
    losses = trainer.epoch_scan(seed_mat, labels, 42)
    assert losses.shape == (steps,)
    scan_state = _state(trainer)
    loop, labels = _build()
    loop_losses = []
    for t, row in enumerate(seed_mat):
        loop_losses.append(loop.step(row[row >= 0], labels,
                                     DistributedTrainer.step_key(42, t)))
    assert _bitwise(losses, torch.stack(loop_losses))
    assert _same(scan_state, _state(loop))


@pytest.mark.parametrize("chunked", [False, True])
def test_pipelined_epoch_bitwise_matches_serial(tmp_path, chunked):
    """``test_pipelined_epoch_bitwise_matches_serial`` and its chunked
    twin: depth 1 gives the serial epoch's losses, state and per-step tier
    hits; chunked by 3 steps, the two later chunks each issue their first
    batch again."""
    serial, labels = _build()
    seed_mat = _seed_mat(serial)
    assert seed_mat.shape[0] == 9
    want = serial.epoch_scan(seed_mat, labels, 7)
    kw = {"checkpoint_dir": tmp_path / "p", "checkpoint_every": 3} if chunked else {}
    piped, _ = _build(depth=1, **kw)
    got = piped.epoch_scan(seed_mat, labels, 7)
    assert _bitwise(got, want)
    assert _same(_state(piped), _state(serial))
    hits = piped.last_tier_hits
    assert torch.equal(hits, serial.last_tier_hits) and hits.shape == (9, 3)
    assert int(hits[:, 1].sum()) > 0 and int(hits[:, 2].sum()) > 0
    reissues = piped.metrics.value(PIPELINE_REISSUES)
    assert (int(reissues) if chunked else reissues) == (2 if chunked else None)
    if chunked:
        piped.checkpointer.close()


@pytest.mark.parametrize("depth", [0, 1])
def test_preempt_resume_bitwise_matches_serial(tmp_path, depth):
    """``test_preemption_drill_resume_bit_parity`` (depth 0) and
    ``test_pipelined_preempt_resume_bitwise_matches_serial`` (depth 1):
    killed at step 4 with checkpoints every 3 steps, a FRESH trainer
    resumes at step 3 and finishes the epoch as the uninterrupted serial
    run did; a finished epoch resumes to no steps."""
    serial, labels = _build()
    seed_mat = _seed_mat(serial)
    want = serial.epoch_scan(seed_mat, labels, 7)
    victim, _ = _build(depth=depth, checkpoint_dir=tmp_path / "p", checkpoint_every=3,
                       plan=qt.FaultPlan(preempt_at_step=4))
    with pytest.raises(qt.Preemption, match="step 4"):
        victim.epoch_scan(seed_mat, labels, 7)
    victim.checkpointer.close()
    fresh, _ = _build(depth=depth, checkpoint_dir=tmp_path / "p", checkpoint_every=3)
    model, opt, key, step, epoch = fresh.resume()
    assert (model, opt) == (fresh.model, fresh.optimizer)
    assert (key, step, epoch) == (7, 3, 0)  # chunk [3, 6) died un-checkpointed
    got = fresh.epoch_scan(seed_mat, labels, key, epoch=epoch, start_step=step)
    assert _bitwise(got, want[step:])
    assert _same(_state(fresh), _state(serial))
    _, _, key2, step2, _ = fresh.resume()
    assert step2 == 9
    empty = fresh.epoch_scan(seed_mat, labels, key2, start_step=step2)
    assert empty.shape == (0,)
    fresh.checkpointer.close()


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    trainer, labels = _build(checkpoint_dir=tmp_path / "ck", checkpoint_every=3)
    seed_mat = _seed_mat(trainer)
    saved = {}
    save = trainer.checkpointer.save

    def record(step, state, **kw):
        saved[int(state["step"])] = _state_tree(state)
        return save(step, state, **kw)

    trainer.checkpointer.save = record
    trainer.epoch_scan(seed_mat, labels, 7)
    trainer.checkpointer.wait_until_finished()
    assert sorted(saved) == [3, 6, 9] and trainer.checkpointer.all_steps() == [0, 1, 2]
    with open(tmp_path / "ck" / "step-2" / "arrays.bin", "r+b") as fh:
        fh.seek(100)
        b = fh.read(1)
        fh.seek(100)
        fh.write(bytes([b[0] ^ 0xFF]))
    fresh, _ = _build(checkpoint_dir=tmp_path / "ck", checkpoint_every=3)
    _, _, key, step, _ = fresh.resume()
    assert (key, step) == (7, 6)
    assert _same(_state_tree({"params": fresh.model.state_dict(),
                              "opt_state": fresh.optimizer.state_dict()}),
                 {k: saved[6][k] for k in ("params", "opt_state")})
    assert any(n.startswith("quarantine-step-2-") for n in os.listdir(tmp_path / "ck"))
    trainer.checkpointer.close()
    fresh.checkpointer.close()


def _state_tree(tree):
    if isinstance(tree, dict):
        return {k: _state_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_state_tree(v) for v in tree)
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def test_guard_on_off_bitwise_identical():
    """``test_guard_on_off_loss_bitwise_identical``: no fault, the same
    losses and state with the guard on as off."""
    runs = {}
    for guard in (False, True):
        trainer, labels = _build(guard=guard)
        losses = trainer.epoch_scan(_seed_mat(trainer, 4), labels, 7)
        runs[guard] = (losses, _state(trainer))
    assert _bitwise(runs[True][0], runs[False][0])
    assert _same(runs[True][1], runs[False][1])


@pytest.mark.parametrize("depth", [0, 1])
def test_guarded_epoch_skips_injected_nan_step(tmp_path, depth):
    """``test_guarded_epoch_scan_skips_injected_nan_step`` and
    ``test_pipelined_guard_skips_injected_nan_step``: the skip vector
    marks exactly the poisoned step, whose loss is NaN and the others
    finite; the flight recorder dumps one bundle; at depth 1 the
    trajectory is the serial guarded run's."""
    plan = qt.FaultPlan(nan_feature_steps=(2,), nan_rows=4)
    recorder = qt.FlightRecorder(tmp_path / "fr")
    trainer, labels = _build(depth=depth, guard=True, plan=plan, recorder=recorder)
    losses = trainer.epoch_scan(_seed_mat(trainer, 4), labels, 7)
    steps = losses.shape[0]
    expect = np.zeros(steps, np.int32)
    expect[2] = 1
    np.testing.assert_array_equal(trainer.metrics.value(GUARD_SKIPPED).numpy(), expect)
    bad = trainer.metrics.value(GUARD_NONFINITE).numpy()
    assert bad[2] > 0 and (np.delete(bad, 2) == 0).all()
    assert not np.isfinite(float(losses[2]))
    assert np.isfinite(np.delete(losses.numpy(), 2)).all()
    assert len(recorder.bundles()) == 1 and trainer.health()["guard_trips"] == 1
    if depth:
        serial, _ = _build(guard=True, plan=qt.FaultPlan(nan_feature_steps=(2,), nan_rows=4))
        want = serial.epoch_scan(_seed_mat(serial, 4), labels, 7)
        assert _bitwise(losses, want) and _same(_state(trainer), _state(serial))


def test_guard_skip_keeps_adam_state_in_step(tmp_path):
    """``test_guard_skips_poisoned_step_and_counts`` over eager steps with
    Adam: the poisoned step leaves the parameters and Adam's step,
    exp_avg and exp_avg_sq bit-unchanged; the next clean step trains."""
    trainer, labels = _build(guard=True, plan=qt.FaultPlan(nan_feature_steps=(1,)))
    rng = np.random.default_rng(3)
    assert torch.isfinite(trainer.step(rng.integers(0, N, 16), labels, 0))
    assert int(trainer.metrics.value(GUARD_SKIPPED)) == 0
    before = _state(trainer)
    assert all(int(s["step"]) == 1 for s in before[1].values())
    assert not torch.isfinite(trainer.step(rng.integers(0, N, 16), labels, 1))
    assert _same(_state(trainer), before)
    assert int(trainer.metrics.value(GUARD_SKIPPED)) == 1
    assert int(trainer.metrics.value(GUARD_NONFINITE)) > 0
    assert torch.isfinite(trainer.step(rng.integers(0, N, 16), labels, 2))
    assert not _same(_state(trainer)[0], before[0])
    assert int(trainer.metrics.value(GUARD_SKIPPED)) == 0


def test_registry_per_depth_and_guard():
    plain, _ = _build()
    names = plain.metrics.names()
    assert GUARD_SKIPPED not in names and GUARD_NONFINITE not in names
    assert PIPELINE_REISSUES not in names and TRAIN_OVERLAP_EFFICIENCY not in names
    piped, _ = _build(depth=1, guard=True)
    names = piped.metrics.names()
    assert {GUARD_SKIPPED, GUARD_NONFINITE, PIPELINE_REISSUES,
            TRAIN_OVERLAP_EFFICIENCY} <= set(names)
    quiet, labels = _build(collect_metrics=False)
    quiet.step(np.arange(16), labels, 0)
    assert quiet.last_tier_hits is None
    assert "collect_metrics=False" in quiet.metrics_report()


def test_step_preemption_and_tracer():
    tracer = qt.Tracer()
    trainer, labels = _build(plan=qt.FaultPlan(preempt_at_step=1), tracer=tracer)
    trainer.step(np.arange(16), labels, 0)
    with pytest.raises(qt.Preemption, match="step 1"):
        trainer.step(np.arange(16), labels, 1)
    trainer.step(np.arange(16), labels, 2)  # fires once per trainer
    names = [s.name for s in tracer.spans()]
    assert names.count("train.step") == 3
    assert "step" in trainer.metrics_report()


def test_resume_checks(tmp_path):
    """``resume()`` without checkpointing raises; an empty directory passes
    through; a ``mesh=`` of another shape, a checkpoint of another
    ``local_batch`` and a step outside the saved epoch raise."""
    plain, _ = _build()
    with pytest.raises(ValueError, match="resume"):
        plain.resume()
    trainer, labels = _build(checkpoint_dir=tmp_path / "ck", checkpoint_every=2)
    before = _state(trainer)
    model, opt, key, step, epoch = trainer.resume()
    assert (key, step, epoch) == (None, 0, 0) and _same(_state(trainer), before)
    trainer._save_checkpoint(7, 0, 3, steps_per_epoch=9)
    trainer.checkpointer.wait_until_finished()
    with pytest.raises(ValueError, match="elastic"):
        trainer.resume(mesh=qt.make_mesh(data=1, feature=2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="elastic trainer"):
        trainer.resume(mesh=qt.make_mesh(data=2, devices=["cpu"] * 2))
    other, _ = _build(checkpoint_dir=tmp_path / "ck", checkpoint_every=2, local=16)
    with pytest.raises(ValueError, match="local_batch=32"):
        other.resume()
    trainer._save_checkpoint(7, 0, 99, steps_per_epoch=9)
    with pytest.raises(ValueError, match="outside"):
        trainer.resume()
    meta = trainer.checkpointer.metadata(0)
    assert meta["mesh"] == {"data": 2, "feature": 1} and meta["workers"] == 2
    assert meta["local_batch"] == 32 and meta["steps_per_epoch"] == 9
    with pytest.raises(ValueError, match="start_step"):
        trainer.epoch_scan(_seed_mat(trainer), labels, 7, start_step=10)
    for t in (trainer, other):
        t.checkpointer.close()


@pytest.mark.parametrize("family", ["gcn", "gin", "gat"])
def test_epoch_scan_families_learn(family):
    """``test_epoch_scan_gcn``/``_gin``/``_gat``: three epochs through
    ``epoch_scan`` (Adam 5e-3), finite, the last loss below the first."""
    rng = np.random.default_rng(0)
    n, classes = 400, 4
    labels = rng.integers(0, classes, n)
    feat = np.eye(classes, dtype=np.float32)[labels] * 2.0
    feat += rng.normal(scale=0.8, size=(n, classes)).astype(np.float32)
    rows, cols = [], []
    for c in range(classes):
        members = np.where(labels == c)[0]
        rows.extend(rng.choice(members, 6 * len(members)))
        cols.extend(rng.choice(members, 6 * len(members)))
    topo = qt.CSRTopo(edge_index=np.stack([rows, cols]))
    n = topo.node_count
    if family == "gat":
        model = GAT(classes, 16, classes, num_layers=2, heads=2)
    else:
        model = {"gcn": GCN, "gin": GIN}[family](classes, 16, classes, num_layers=2)
    init_model(model, torch.Generator().manual_seed(0))
    trainer = DistributedTrainer(
        qt.make_mesh(data=4, feature=2, devices=["cpu"] * 8),
        qt.GraphSageSampler(topo, [5, 5], device="cpu", seed=3, seed_capacity=32),
        qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(feat[:n]),
        model, torch.optim.Adam(model.parameters(), lr=5e-3), local_batch=32)
    trainer.init(0)
    lab = torch.from_numpy(labels[:n].astype(np.int32))
    idx = np.random.default_rng(1).integers(0, n, 4 * trainer.global_batch)
    first = last = None
    for e in range(3):
        losses = trainer.epoch_scan(trainer.pack_epoch(idx, seed=e), lab, e)
        assert bool(torch.isfinite(losses).all())
        first = float(losses[0]) if first is None else first
        last = float(losses[-1])
    assert last < first, (first, last)
    assert trainer.last_tier_hits.shape == (4, 3)
    assert int(trainer.metrics.snapshot(TIER_HITS).numpy[:, 1].sum()) > 0
