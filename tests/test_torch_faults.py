"""The fault plans of quiver_tpu_torch (``resilience/faults.py``) against
quiver_tpu's: ``FaultPlan.chaos`` field for field from one seed, the
step-indexed queries, the validation messages, and the wrappers'
schedules (the same calls raise on both packages, and a recovered
sampler stream is the fault-free one). ``FaultyFeature``'s NaN rows are
written into a clone of the looked-up tensor on that tensor's own device.

Tolerance: plans, masks, schedules, ids and rows are compared exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.resilience import faults as faults_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.resilience import faults as faults_t  # noqa: E402


def _fields(plan):
    return {f.name: (dict(v) if isinstance(v := getattr(plan, f.name), dict) else v)
            for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("seed,steps,nan_p,transient_p,max_transient,preempt", [
    (0, 50, 0.1, 0.2, 2, None),
    (7, 200, 0.0, 0.5, 4, 17),
    (123, 1, 1.0, 1.0, 1, 0),
    (5, 0, 0.3, 0.3, 2, None),
])
def test_chaos_plans_equal_jax(seed, steps, nan_p, transient_p, max_transient, preempt):
    kw = dict(nan_p=nan_p, transient_p=transient_p, max_transient=max_transient,
              nan_rows=3, preempt_at_step=preempt)
    got = faults_t.FaultPlan.chaos(seed, steps, **kw)
    want = faults_j.FaultPlan.chaos(seed, steps, **kw)
    assert _fields(got) == _fields(want)
    assert got.injects_nan() == want.injects_nan()
    for n in (0, steps, steps + 3):
        np.testing.assert_array_equal(got.nan_mask(n), want.nan_mask(n))
    for s in range(-1, steps + 2):
        assert got.nan_at(s) == want.nan_at(s)
    for lo, hi in ((0, 1), (0, steps + 1), (5, 20), (17, 18), (18, 40)):
        assert got.preempts_in(lo, hi) == want.preempts_in(lo, hi)


def test_the_top_level_names():
    assert qt.FaultPlan is faults_t.FaultPlan
    assert qt.Preemption is faults_t.Preemption
    assert qt.TransientFault is faults_t.TransientFault
    assert issubclass(qt.TransientFault, RuntimeError)
    with pytest.raises(dataclasses.FrozenInstanceError):
        qt.FaultPlan().nan_rows = 2


@pytest.mark.parametrize("kwargs", [
    dict(nan_rows=0),
    dict(sampler_faults={-1: 2}),
    dict(feature_faults={3: 0}),
])
def test_validation_equals_jax(kwargs):
    with pytest.raises(ValueError) as e_t:
        faults_t.FaultPlan(**kwargs)
    with pytest.raises(ValueError) as e_j:
        faults_j.FaultPlan(**kwargs)
    assert str(e_t.value) == str(e_j.value)


class _Sampler:
    """Counts the calls that reach it."""

    def __init__(self):
        self.calls = []
        self.sizes = (3,)

    def sample(self, seeds):
        self.calls.append(int(seeds[0]))
        return int(seeds[0])


def _schedule(mod, plan_kw, attempts):
    """Drive a wrapped sampler through ``attempts`` (seed-array indices;
    a repeated index re-enters with the same array, as a retry does):
    ``(per-attempt outcome, calls that reached the sampler)``."""
    inner = _Sampler()
    wrapped = mod.FaultPlan(**plan_kw).wrap_sampler(inner)
    arrays = [np.array([i]) for i in range(max(attempts) + 1)]
    outcome = []
    for i in attempts:
        try:
            outcome.append(wrapped.sample(arrays[i]))
        except mod.TransientFault as e:
            outcome.append(str(e))
    assert wrapped.sizes == (3,)  # attributes forward to the sampler
    return outcome, inner.calls


@pytest.mark.parametrize("plan_kw,attempts", [
    (dict(sampler_faults={1: 2}), [0, 1, 1, 1, 2, 3]),
    (dict(sampler_faults={0: 1, 2: 3}), [0, 0, 1, 2, 2, 2, 2, 3]),
    (dict(sampler_faults={1: 9}), [0, 1, 1, 2, 3]),  # batch 1 given up
])
def test_sampler_schedule_equals_jax(plan_kw, attempts):
    got = _schedule(faults_t, plan_kw, attempts)
    assert got == _schedule(faults_j, plan_kw, attempts)
    # failed calls never reach the sampler: its call order is kept
    assert got[1] == sorted(set(got[1]))


class _Store:
    def __init__(self, table):
        self.table = table
        self.shape = tuple(table.shape)

    def __getitem__(self, ids):
        return self.table[ids]


@pytest.mark.parametrize("plan_kw", [
    dict(feature_faults={1: 2}),
    dict(feature_faults={0: 1, 3: 1}, nan_feature_steps=(0, 2), nan_rows=2),
    dict(nan_feature_steps=(1,), nan_rows=5),
])
def test_feature_schedule_equals_jax(plan_kw):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 3)).astype(np.float32)
    before = table.copy()
    ids = np.arange(6)
    runs = {}
    for name, mod, store in (("jax", faults_j, _Store(table)),
                             ("torch", faults_t, _Store(torch.from_numpy(table.copy())))):
        wrapped = mod.FaultPlan(**plan_kw).wrap_feature(store)
        out = []
        for _ in range(6):
            try:
                out.append(np.asarray(wrapped[ids]))
            except mod.TransientFault as e:
                out.append(str(e))
        assert wrapped.shape == (20, 3)
        runs[name] = out
    for a, b in zip(runs["torch"], runs["jax"]):
        if isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)  # NaN rows in the same places
    np.testing.assert_array_equal(table, before)  # the store's rows are untouched


class _ViewStore(_Store):
    """Returns a view of its table: a lookup that poisoned in place would
    write into the table."""

    def __getitem__(self, ids):
        return self.table[: len(ids)]


def test_faulty_feature_poisons_a_clone_on_the_rows_device():
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    store = _ViewStore(table)
    wrapped = faults_t.FaultPlan(nan_feature_steps=(0,), nan_rows=2).wrap_feature(store)
    rows = wrapped[torch.arange(5)]
    assert isinstance(rows, torch.Tensor) and rows.device == table.device
    assert bool(torch.isnan(rows[:2]).all()) and not bool(torch.isnan(rows[2:]).any())
    assert not bool(torch.isnan(table).any())  # the lookup's source is untouched
    again = wrapped[torch.arange(5)]  # lookup 1: not planned
    assert torch.equal(again, table[:5])


def test_recovered_stream_is_fault_free():
    """A real sampler behind the wrapper: retried batches give the
    fault-free stream (the wrapper never advances the sampler's call
    counter on a failed call)."""
    rng = np.random.default_rng(2)
    topo = qt.CSRTopo(edge_index=rng.integers(0, 100, size=(2, 800)))
    seeds = [rng.integers(0, 100, 16) for _ in range(4)]

    def sampler():
        return qt.GraphSageSampler(topo, [3], device="cpu", seed_capacity=16, seed=1)

    plain = sampler()
    clean = [plain.sample(s) for s in seeds]
    wrapped = faults_t.FaultPlan(sampler_faults={1: 2, 3: 1}).wrap_sampler(sampler())
    got = []
    for s in seeds:
        while True:
            try:
                got.append(wrapped.sample(s))
                break
            except faults_t.TransientFault:
                continue
    for a, b in zip(got, clean):
        assert torch.equal(a.n_id, b.n_id)
