"""The Prefetcher of quiver_tpu_torch (``parallel/pipeline.py``): the
contracts of ``tests/test_pipeline.py`` over the port's sampler and
``Feature`` on the CPU, with the port's ``FaultPlan``
(``resilience/faults.py``), and its retry schedule and counters against
the JAX package's ``Prefetcher`` for one fault plan (each package's own)
and ``retry_seed``.

Tolerances: batches, ids, counters and the retry-delay sequence are
compared bitwise (the delays are the same float formula over the same
``random.Random`` draws).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.obs.registry import MetricsRegistry as MetricsRegistryJ  # noqa: E402
from quiver_tpu.parallel.pipeline import Prefetcher as PrefetcherJ  # noqa: E402
from quiver_tpu.resilience import FaultPlan as FaultPlanJ  # noqa: E402
from quiver_tpu.resilience import TransientFault as TransientFaultJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.obs import StepTimeline  # noqa: E402
from quiver_tpu_torch.obs.registry import (PREFETCH_QUEUE_DEPTH,  # noqa: E402
                                           PREFETCH_RETRIES, PREFETCH_SKIPS,
                                           MetricsRegistry)
from quiver_tpu_torch.parallel.pipeline import Batch, Prefetcher  # noqa: E402
from quiver_tpu_torch.resilience import FaultPlan, TransientFault  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, 200, size=(2, 2000)).astype(np.int64)
    topo = qt.CSRTopo(edge_index=ei)
    feat = rng.normal(size=(topo.node_count, 16)).astype(np.float32)
    feature = qt.Feature(device_cache_size=40 * 16 * 4, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    return topo, feature, ei, feat


def _seed_stream(n_batches, batch, n_nodes, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_nodes, batch) for _ in range(n_batches)]


def _sampler(topo, sizes=(3,), cap=16, seed=0):
    return qt.GraphSageSampler(topo, list(sizes), device="cpu", seed_capacity=cap,
                               seed=seed)


def test_prefetch_matches_sequential(setup):
    topo, feature, _, _ = setup
    seeds = _seed_stream(6, 32, topo.node_count)
    seq_sampler = _sampler(topo, [4, 3], 32, seed=3)
    seq = [(seq_sampler.sample(s), s) for s in seeds]
    seq_x = [feature[out.n_id] for out, _ in seq]
    pf = Prefetcher(_sampler(topo, [4, 3], 32, seed=3), feature, depth=3)
    assert pf.device is None  # no card, no streams
    batches = list(pf.run(seeds))
    assert len(batches) == len(seq)
    for (out, s), x, b in zip(seq, seq_x, batches):
        np.testing.assert_array_equal(b.seeds, s)
        assert torch.equal(b.out.n_id, out.n_id)
        for a_seq, a_pre in zip(out.adjs, b.out.adjs):
            assert torch.equal(a_seq.edge_index, a_pre.edge_index)
        assert torch.equal(b.x, x)


def test_sampler_only_mode(setup):
    topo, _, _, _ = setup
    batches = list(Prefetcher(_sampler(topo), None).run(
        _seed_stream(3, 16, topo.node_count)))
    assert all(b.x is None for b in batches)
    assert all(int(b.out.n_count) >= 16 for b in batches)


def test_transform_runs_on_worker(setup):
    topo, feature, _, _ = setup
    labels = torch.arange(topo.node_count, dtype=torch.int32)
    threads = set()

    def with_labels(seeds, out, x):
        threads.add(threading.current_thread().name)
        return Batch(seeds, out, (x, labels[out.n_id[:16].clamp(min=0)]))

    for b in Prefetcher(_sampler(topo), feature, transform=with_labels).run(
            _seed_stream(2, 16, topo.node_count)):
        _, lab = b.x
        assert torch.equal(lab, b.out.n_id[:16].clamp(min=0))
    assert threads and all(t.startswith("quiver-prefetch") for t in threads)


def test_depth_validation(setup):
    topo, _, _, _ = setup
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(_sampler(topo), depth=0)


def test_worker_exception_propagates(setup):
    topo, _, _, _ = setup
    streams = [np.arange(16), np.full(16, topo.node_count + 5), np.arange(16)]
    got = []
    with pytest.raises(ValueError, match="seed ids"):
        for b in Prefetcher(_sampler(topo), None, depth=1).run(streams):
            got.append(b)
    assert len(got) == 1  # the first batch came before the failure surfaced


def test_early_exit_cancels_cleanly(setup):
    topo, _, _, _ = setup
    gen = Prefetcher(_sampler(topo), None, depth=2).run(
        _seed_stream(10, 16, topo.node_count))
    next(gen)
    gen.close()  # no hang, no exception


def test_early_exit_returns_promptly_despite_inflight_dispatch(setup):
    """``close()`` must not wait for the in-flight dispatch: the worker
    blocks on an event released only after close() returns."""
    topo, _, _, _ = setup
    inner = _sampler(topo)
    release = threading.Event()
    calls = []

    class SlowSampler:
        def sample(self, seeds):
            calls.append(1)
            if len(calls) > 1:  # first batch fast, second blocks
                release.wait(20)
            return inner.sample(seeds)

    gen = Prefetcher(SlowSampler(), None, depth=2).run(
        _seed_stream(6, 16, topo.node_count))
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    dt = time.perf_counter() - t0
    release.set()
    assert dt < 5.0, f"early exit blocked {dt:.1f}s on the in-flight batch"


def test_retry_recovers_transient_faults_bit_identically(setup):
    topo, _, _, _ = setup
    seeds = _seed_stream(4, 16, topo.node_count)
    oracle = _sampler(topo)
    clean = [oracle.sample(s) for s in seeds]
    faulty = FaultPlan(sampler_faults={1: 2}).wrap_sampler(_sampler(topo))
    tl = StepTimeline()
    pf = Prefetcher(faulty, None, depth=2, retries=3, backoff=1e-4, timeline=tl)
    batches = list(pf.run(seeds))
    assert len(batches) == 4
    assert pf.retries_total == 2 and pf.skips_total == 0
    assert tl.stats("prefetch.retry_wait").count == 2
    assert tl.stats("prefetch.dispatch").count == 4
    for c, b in zip(clean, batches):
        assert torch.equal(c.n_id, b.out.n_id)


def test_retry_skip_counters_land_on_registry(setup):
    topo, _, _, _ = setup
    seeds = _seed_stream(4, 16, topo.node_count)
    faulty = FaultPlan(sampler_faults={1: 2, 3: 5}).wrap_sampler(_sampler(topo))
    reg = MetricsRegistry()
    pf = Prefetcher(faulty, None, depth=1, retries=2, backoff=0.0,
                    skip_policy="skip", metrics=reg)
    assert len(list(pf.run(seeds))) == 3  # batch 3 dropped
    assert pf.retries_total == 4 and pf.skips_total == 1
    assert int(np.asarray(reg.value(PREFETCH_RETRIES))) == 4
    assert int(np.asarray(reg.value(PREFETCH_SKIPS))) == 1


def test_retry_exhaustion_raises_in_order(setup):
    topo, _, _, _ = setup
    faulty = FaultPlan(sampler_faults={1: 3}).wrap_sampler(_sampler(topo))
    got = []
    with pytest.raises(TransientFault, match="batch 1"):
        for b in Prefetcher(faulty, None, depth=1, retries=1, backoff=0.0).run(
                _seed_stream(4, 16, topo.node_count)):
            got.append(b)
    assert len(got) == 1


def test_skip_policy_drops_poisoned_batch_keeps_order(setup):
    topo, _, _, _ = setup
    seeds = _seed_stream(4, 16, topo.node_count)
    faulty = FaultPlan(sampler_faults={1: 10**9}).wrap_sampler(_sampler(topo))
    tl = StepTimeline()
    pf = Prefetcher(faulty, None, depth=2, retries=1, backoff=0.0,
                    skip_policy="skip", timeline=tl)
    batches = list(pf.run(seeds))
    assert len(batches) == 3
    assert pf.skips_total == 1 and pf.retries_total == 1
    assert tl.stats("prefetch.skip").count == 1
    survivor = _sampler(topo)
    for s, b in zip((seeds[0], seeds[2], seeds[3]), batches):
        assert torch.equal(survivor.sample(s).n_id, b.out.n_id)


def test_retry_knob_validation(setup):
    topo, _, _, _ = setup
    with pytest.raises(ValueError, match="retries"):
        Prefetcher(_sampler(topo), retries=-1)
    with pytest.raises(ValueError, match="skip_policy"):
        Prefetcher(_sampler(topo), skip_policy="drop")
    with pytest.raises(ValueError, match="backoff"):
        Prefetcher(_sampler(topo), backoff=-0.1)


def test_retry_backoff_is_bounded_and_jitter_deterministic(setup):
    topo, _, _, _ = setup
    seeds = _seed_stream(2, 16, topo.node_count)

    def waits(retry_seed):
        faulty = FaultPlan(sampler_faults={0: 4}).wrap_sampler(_sampler(topo))
        tl = StepTimeline()
        pf = Prefetcher(faulty, None, retries=4, backoff=1e-3, backoff_cap=2e-3,
                        jitter=0.5, timeline=tl, retry_seed=retry_seed)
        assert len(list(pf.run(seeds))) == 2
        st = tl.stats("prefetch.retry_wait")
        return st.count, st.max

    count_a, max_a = waits(5)
    count_b, max_b = waits(5)
    assert count_a == count_b == 4
    assert max_a == max_b
    assert max_a <= 2e-3 * 1.5 + 1e-9  # cap * (1 + jitter)


def test_queue_depth_gauge_tracks_inflight(setup):
    topo, _, _, _ = setup
    reg = MetricsRegistry()
    pf = Prefetcher(_sampler(topo), None, depth=2, metrics=reg)
    observed = [int(np.asarray(reg.value(PREFETCH_QUEUE_DEPTH)))
                for _ in pf.run(_seed_stream(6, 16, topo.node_count))]
    assert 2 <= max(observed) <= 3
    assert observed[-1] == 0


class _Recorder:
    """A timeline that keeps every observation in order."""

    def __init__(self):
        self.seen = []

    def observe(self, name, seconds):
        self.seen.append((name, seconds))


def _value(reg, name):
    v = reg.value(name)
    return None if v is None else int(np.asarray(v))


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_retry_schedule_and_counters_equal_jax(setup, policy):
    """One fault plan and ``retry_seed`` through both packages'
    Prefetchers: the same retry delays (bitwise) and skips in order, the
    same counters and the same batches delivered (batch 3 fails past its
    retries: it surfaces, or is skipped)."""
    topo, _, ei, _ = setup
    seeds = _seed_stream(5, 16, topo.node_count)
    plan = {0: 2, 2: 1, 3: 9}
    kw = dict(depth=2, retries=3, backoff=1e-4, backoff_cap=3e-4, jitter=0.5,
              retry_seed=11, skip_policy=policy)
    runs = {}
    for name, pf_cls, plan_cls, reg, sampler in (
            ("jax", PrefetcherJ, FaultPlanJ, MetricsRegistryJ(),
             qj.GraphSageSampler(qj.CSRTopo(edge_index=ei), [3], seed_capacity=16,
                                 seed=0)),
            ("torch", Prefetcher, FaultPlan, MetricsRegistry(), _sampler(topo))):
        rec = _Recorder()
        pf = pf_cls(plan_cls(sampler_faults=plan).wrap_sampler(sampler), None,
                    timeline=rec, metrics=reg, **kw)
        delivered, err = 0, None
        try:
            for _ in pf.run(seeds):
                delivered += 1
        except (TransientFault, TransientFaultJ) as e:
            err = str(e)
        runs[name] = ([(n, s) for n, s in rec.seen if n != "prefetch.dispatch"],
                      pf.retries_total, pf.skips_total, delivered, err,
                      _value(reg, PREFETCH_RETRIES), _value(reg, PREFETCH_SKIPS))
    assert runs["torch"] == runs["jax"]
    waits, retries, skips, delivered, err = runs["torch"][:5]
    assert retries == 6 and len(waits) == 6 + skips
    assert (skips, delivered, err is None) == ((1, 4, True) if policy == "skip"
                                               else (0, 3, False))


def test_first_kernel_load_holds_the_build_lock(monkeypatch):
    """Two threads' first use of the kernel libraries runs one build (a
    Prefetcher's worker and the main thread must not run ``nvcc`` twice
    into one temporary file); the build is faked here, where no
    ``nvcc`` runs."""
    from quiver_tpu_torch.ops.kernels import build

    calls = []

    def slow_build(names):
        calls.append(threading.current_thread().name)
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(build, "_LIBS", None)
    monkeypatch.setattr(build, "_build_locked", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build._libraries()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(got) == 3
    assert all(g is got[0] for g in got)
