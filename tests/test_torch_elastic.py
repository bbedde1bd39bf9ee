"""The port's circuit breaker and degraded-mode store
(quiver_tpu_torch/resilience/elastic.py) against the JAX package's, under
one failure schedule.

Tolerance: exact for breaker states and counters, bitwise for rows (the
stores under both wrappers are the same table, and a fallback row is
either zeros or a row the store returned earlier).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.obs.recorder import FlightRecorder as RecorderJ  # noqa: E402
from quiver_tpu.resilience import elastic as elastic_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.obs.recorder import FlightRecorder as RecorderT  # noqa: E402
from quiver_tpu_torch.obs.recorder import verify_bundle  # noqa: E402
from quiver_tpu_torch.obs.registry import DEGRADED_LOOKUPS  # noqa: E402
from quiver_tpu_torch.resilience import elastic as elastic_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

N, F = 300, 6


class _Flaky:
    """A store whose lookups raise on the scheduled call indices."""

    def __init__(self, store, fail_calls):
        self.store = store
        self.fail_calls = set(fail_calls)
        self.calls = 0

    def __getitem__(self, ids):
        call = self.calls
        self.calls += 1
        if call in self.fail_calls:
            raise ConnectionError(f"cold tier down (call {call})")
        return self.store[ids]

    def __getattr__(self, name):
        return getattr(self.store, name)


def test_breaker_state_sequences_equal_jax():
    rng = np.random.default_rng(1)
    for failures, probe_every in ((1, 1), (3, 2), (2, 5)):
        opened = {"j": 0, "t": 0}
        bj = elastic_j.CircuitBreaker(failures, probe_every,
                                      on_open=lambda: opened.__setitem__("j", opened["j"] + 1))
        bt = elastic_t.CircuitBreaker(failures, probe_every,
                                      on_open=lambda: opened.__setitem__("t", opened["t"] + 1))
        for outcome in rng.random(300) < 0.4:  # True: the operation fails
            allowed = bt.allow()
            assert allowed == bj.allow()
            if allowed:
                for b in (bj, bt):
                    b.record_failure() if outcome else b.record_success()
            assert bt.state == bj.state
        assert opened["t"] == opened["j"] > 0
    with pytest.raises(ValueError, match="failures/probe_every"):
        elastic_t.CircuitBreaker(0, 1)
    flaky = elastic_t.CircuitBreaker(1, 1, on_open=lambda: 1 / 0)
    flaky.record_failure()  # a raising on_open is swallowed
    assert flaky.state == "open"


def _stores(dtype, reorder):
    coo = generate_pareto_graph(N, 5.0, seed=2)
    x = np.random.default_rng(2).normal(size=(N, F)).astype(np.float32)
    budget = (4 * N if dtype == "int8" else 0) + 100 * F * (1 if dtype == "int8" else 4)
    fj = qj.Feature(device_cache_size=budget, kernel="xla", dtype=dtype,
                    csr_topo=qj.CSRTopo(edge_index=coo) if reorder else None
                    ).from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, dtype=dtype, device="cpu",
                    csr_topo=qt.CSRTopo(edge_index=coo) if reorder else None
                    ).from_cpu_tensor(x)
    return fj, ft


@pytest.mark.parametrize("fallback,cache_rows", [("zeros", 65536), ("last-good", 65536),
                                                 ("last-good", 23)])
@pytest.mark.parametrize("dtype,reorder", [(None, False), ("int8", True)])
def test_degraded_rows_and_counters_equal_jax(fallback, cache_rows, dtype, reorder):
    """One failure schedule through both wrappers: each call raises on
    both sides or returns bitwise the same rows; states, degraded counts
    and the registry counter agree after every call. ``cache_rows=23``
    stops the last-good cache mid-stream, and some ids are ``-1`` or lie
    past the table. The port takes those raw and JAX takes them clamped to
    the last id: the port's cache holds an id past the table under the
    last id, whose row the store's lookup reads for it."""
    fj, ft = _stores(dtype, reorder)
    fail = {3, 4, 5, 6, 7, 12, 13, 14, 15, 16, 17, 18, 19, 25, 26, 27, 28, 29, 30}
    dj = elastic_j.DegradedFeature(_Flaky(fj, fail), failures=3, probe_every=2,
                                   fallback=fallback, cache_rows=cache_rows)
    dt = elastic_t.DegradedFeature(_Flaky(ft, fail), failures=3, probe_every=2,
                                   fallback=fallback, cache_rows=cache_rows)
    rng = np.random.default_rng(3)
    served = 0
    for step in range(34):
        ids = rng.integers(-1, N + 5, 12).astype(np.int32)
        if step % 4 == 0:
            ids[:6] = ids[6:]  # duplicate ids in one lookup
        try:
            want = np.asarray(dj[jnp.asarray(np.minimum(ids, N - 1))])
        except ConnectionError:
            with pytest.raises(ConnectionError):
                dt[torch.from_numpy(ids)]
        else:
            got = dt[torch.from_numpy(ids)]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
            served += 1
        assert dt.breaker.state == dj.breaker.state, step
        assert dt.degraded_total == dj.degraded_total, step
    assert dt.degraded_total > 0 and served > 20
    assert int(dt.metrics.value(DEGRADED_LOOKUPS)) == dt.degraded_total
    if fallback == "last-good":
        assert int(dt._held) == min(cache_rows, len(dj._cache))


def test_breaker_open_dumps_a_bundle_like_jax(tmp_path):
    fj, ft = _stores(None, False)
    rj, rt = RecorderJ(tmp_path / "j"), RecorderT(tmp_path / "t")
    dj = elastic_j.DegradedFeature(_Flaky(fj, {0, 1, 2}), failures=3, recorder=rj)
    dt = elastic_t.DegradedFeature(_Flaky(ft, {0, 1, 2}), failures=3, recorder=rt)
    ids = np.array([1, 2], np.int32)
    for _ in range(2):  # closed: failures propagate
        for d, i in ((dj, jnp.asarray(ids)), (dt, torch.from_numpy(ids))):
            with pytest.raises(ConnectionError):
                d[i]
    out = dt[torch.from_numpy(ids)]  # the third failure opens: zero rows
    dj[jnp.asarray(ids)]
    assert dt.breaker.state == dj.breaker.state == "open"
    assert torch.equal(out, torch.zeros(2, F))
    (bt,), (bj,) = rt.bundles(), rj.bundles()
    assert bt[1]["reason"] == bj[1]["reason"] == "breaker_open"
    assert bt[1]["stage"] == bj[1]["stage"] == "gather"
    assert bt[1]["attrs"] == bj[1]["attrs"] == {"fallback": "zeros"}
    verify_bundle(bt[0])


def test_degraded_wrapper_delegates_and_checks():
    _fj, ft = _stores(None, False)
    d = elastic_t.DegradedFeature(ft)
    assert d.shape == ft.shape and d.device == ft.device and d.hot_rows == ft.hot_rows
    with pytest.raises(ValueError, match="fallback"):
        elastic_t.DegradedFeature(ft, fallback="stale")
