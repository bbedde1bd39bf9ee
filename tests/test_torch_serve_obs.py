"""The port's InferenceServer under telemetry and in degraded mode
(quiver_tpu_torch/serving/server.py with obs/ and resilience/), against
the JAX server on one fake clock and one request stream, and the logs and
checks of the model and sampler layers.

The port's ``draw_fn`` replays the JAX server's draws
(``test_torch_serve.jax_draw_fn``), so both servers gather the same ids.
Tolerance: exact for counters, states and stage counts; the
``queue_wait`` stage (timed on the fake clock) equal in every field;
bitwise for the rows a degraded store serves; served log-probs within
atol = rtol = 1e-5 across the packages (float32, different summation
orders) and bitwise within the port.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import layers as layers_j  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.obs.recorder import verify_bundle as verify_j  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402
from quiver_tpu.resilience.elastic import DegradedFeature as DegradedJ  # noqa: E402
from test_torch_serve import jax_draw_fn  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import layers as layers_t  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.obs import export  # noqa: E402
from quiver_tpu_torch.obs.recorder import verify_bundle as verify_t  # noqa: E402
from quiver_tpu_torch.resilience.elastic import DegradedFeature as DegradedT  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402
from quiver_tpu_torch.utils.trace import reset_once  # noqa: E402

N, F, HID, CLS, SIZES, SEED = 400, 12, 16, 5, (4, 3), 3
STAGES = ("queue_wait", "pad", "sample", "gather", "forward", "readback")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


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


@pytest.fixture(scope="module")
def stack():
    coo = generate_pareto_graph(N, 6.0, seed=5)
    x = np.random.default_rng(5).normal(size=(N, F)).astype(np.float32)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    fj = qj.Feature(device_cache_size=100 * F * 4, csr_topo=tj).from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=100 * F * 4, csr_topo=tt,
                    device="cpu").from_cpu_tensor(x)
    mj = SageJ(hidden=HID, num_classes=CLS, num_layers=2)
    adjs = empty_adjs(list(SIZES), batch=2, node_count=N)
    params = init_model(mj, jax.random.PRNGKey(SEED),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, HID, CLS, num_layers=2)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return {"tj": tj, "tt": tt, "fj": fj, "ft": ft, "mj": mj, "params": params, "mt": mt}


def _servers(stack, fj=None, ft=None, **kw):
    cj, ct = FakeClock(), FakeClock()
    sj = qj.InferenceServer(
        qj.GraphSageSampler(stack["tj"], list(SIZES), seed=SEED), stack["mj"],
        stack["params"], fj if fj is not None else stack["fj"], buckets=(1, 2),
        seed=SEED, clock=cj, **kw)
    st = qt.InferenceServer(
        qt.GraphSageSampler(stack["tt"], list(SIZES), device="cpu", seed=SEED),
        stack["mt"], ft if ft is not None else stack["ft"], device="cpu",
        buckets=(1, 2), seed=SEED, clock=ct, draw_fn=jax_draw_fn(SEED, SIZES), **kw)
    return (sj, cj), (st, ct)


def _drive(server, clock, ops):
    """Run one op stream; returns each op's outcome (completed requests'
    (node, seq, result), a raise's type name, or a shed)."""
    out = []
    for op, arg in ops:
        if op == "submit":
            node, pri = arg
            try:
                server.submit(node, priority=pri)
                out.append(("admitted",))
            except qt.ServeQueueFull:
                out.append(("full",))
            except qj.ServeQueueFull:
                out.append(("full",))
        elif op == "advance":
            clock.advance(arg)
        else:
            try:
                done = server.pump(force=arg)
            except ConnectionError:
                out.append(("raised",))
            else:
                out.append(("done", [(r.node, r.seq, np.asarray(r.result)) for r in done]))
    return out


def _same_outcomes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        if x[0] == "done":
            assert [(n, s) for n, s, _ in x[1]] == [(n, s) for n, s, _ in y[1]]
            for (_, _, r1), (_, _, r2) in zip(x[1], y[1]):
                np.testing.assert_allclose(r1, r2, atol=1e-5, rtol=1e-5)


OPS = ([("submit", (5, "gold")), ("submit", (7, "bronze")), ("submit", (9, "bronze")),
        ("submit", (11, "gold")),  # a full queue sheds the newest bronze
        ("pump", False), ("advance", 0.2), ("pump", False), ("pump", True)]
       + [("submit", (int(n), "gold")) for n in (3, 250, 17)]
       + [("advance", 0.01), ("pump", False), ("pump", True), ("pump", True)]
       + [("submit", (n, "bronze")) for n in (1, 2, 3)]
       + [("submit", (4, "gold")), ("submit", (6, "gold")), ("submit", (8, "gold")),
          ("submit", (10, "gold")), ("advance", 0.03), ("pump", True), ("pump", True),
          ("pump", True)])


def test_stats_equal_jax_server(stack):
    """Step 0: the port's stats() has the JAX server's layout and values on
    one fake clock and request stream: every counter, the per-class
    misses and sheds, the queue depth, every stage's count, and the
    fake-clock ``queue_wait`` stage in every field. ``recompiles`` counts
    the warm-up's program builds (two per bucket in both packages) and
    ``aot_loads`` is 0 with no program cache."""
    (sj, cj), (st, ct) = _servers(stack, max_queue=3)
    sj.warmup()
    st.warmup()
    _same_outcomes(_drive(st, ct, OPS), _drive(sj, cj, OPS))
    a, b = st.stats(), sj.stats()
    assert set(a) == set(b)
    assert a["recompiles"] == b["recompiles"] == 2 * len(st.batcher.buckets)
    assert a["aot_loads"] == b["aot_loads"] == 0
    for key in ("requests", "deadline_misses", "class_deadline_misses", "shed",
                "degraded_lookups", "queue_depth"):
        assert a[key] == b[key], key
    assert a["shed"]["bronze"] > 0 and a["deadline_misses"] > 0
    assert set(a["stages"]) == set(b["stages"]) == set(STAGES)
    for name in STAGES:
        assert set(a["stages"][name]) == set(b["stages"][name])
        assert a["stages"][name]["count"] == b["stages"][name]["count"], name
    assert a["stages"]["queue_wait"] == b["stages"]["queue_wait"]
    # the registry's serve.* counters, as the JAX server's
    for name in ("serve.requests", "serve.deadline_misses", "serve.shed_requests",
                 "serve.class_deadline_misses"):
        np.testing.assert_array_equal(st.metrics.snapshot(name).numpy,
                                      sj.metrics.snapshot(name).numpy)


def test_controller_and_aot_cache_raise(stack):
    """Both are ported: a controller without ``observe_serve`` and an
    ``aot_cache`` that is no cache, path or True raise."""
    for kw, match in (({"controller": object()}, "observe_serve"),
                      ({"aot_cache": 3.5}, "aot_cache")):
        with pytest.raises(TypeError, match=match):
            qt.InferenceServer(qt.GraphSageSampler(stack["tt"], [2], device="cpu"),
                               stack["mt"], stack["ft"], device="cpu", **kw)


def _port_server(stack, feature=None, **kw):
    return qt.InferenceServer(
        qt.GraphSageSampler(stack["tt"], list(SIZES), device="cpu", seed=SEED),
        stack["mt"], feature if feature is not None else stack["ft"], device="cpu",
        max_batch=4, seed=SEED, clock=FakeClock(), **kw)


def test_six_stage_request_traces_and_exports(stack):
    reg = qt.MetricsRegistry()
    tracer = qt.Tracer(metrics=reg)
    server = _port_server(stack, tracer=tracer, metrics=reg)
    reqs = server.serve([3, 11, 19, 42, 7])
    by_trace = {}
    for s in tracer.spans():
        by_trace.setdefault(s.trace_id, []).append(s)
    assert len(by_trace) == len(reqs)
    for r in reqs:
        spans = by_trace[r.trace_id]
        (root,) = [s for s in spans if s.name == "serve.request"]
        assert root.parent_id == "" and root.attrs["node"] == r.node
        children = [s.name for s in spans if s.parent_id == root.span_id]
        assert sorted(children) == sorted(f"serve.{s}" for s in STAGES)
        assert [s.name for s in spans if s.parent_id == ""] == ["serve.enqueue",
                                                                "serve.request"]
    assert tracer.subsystems() == {"serve"}
    stats = server.stats()
    assert int(reg.value("serve.requests")) == stats["requests"] == 5
    assert int(reg.value("trace.spans")) == tracer.spans_total
    snaps = reg.snapshots()
    for back in (export.from_prometheus(export.to_prometheus(snaps)),):
        assert [s.name for s in back] == [s.name for s in snaps]
    doc = tracer.to_chrome()
    assert {e["name"] for e in doc["traceEvents"]} >= {f"serve.{s}" for s in STAGES}


def test_tracing_on_off_bitwise(stack, tmp_path):
    """Tracing, the registry and the recorder change no response: a traced
    server and an untraced one answer every (node, seq) bitwise alike,
    log-probs included. This is the contract the reference's own
    ``test_serve_disabled_tracing_bitwise`` states (that test fails on
    this image for its AOT cache, ROADMAP C); the port is held to the
    contract, not to the reference's output."""
    nodes = [3, 11, 19, 42, 7, 250, 399]
    plain = _port_server(stack)
    traced = _port_server(stack, tracer=qt.Tracer(), metrics=qt.MetricsRegistry(),
                          recorder=qt.FlightRecorder(tmp_path / "pm"))
    out_a, out_b = plain.serve(nodes), traced.serve(nodes)
    assert plain.tracer.enabled is False and not plain.tracer.spans()
    assert traced.tracer.spans()
    for ra, rb in zip(out_a, out_b):
        assert (ra.node, ra.seq) == (rb.node, rb.seq)
        np.testing.assert_array_equal(ra.result.view(np.uint8), rb.result.view(np.uint8))


def test_shed_burst_dumps_a_bundle(stack, tmp_path):
    rec = qt.FlightRecorder(tmp_path / "pm", tracer=qt.Tracer())
    server = _port_server(stack, recorder=rec, max_queue=4, shed_burst=2)
    for n in (1, 2, 6, 7):
        server.submit(n, priority="bronze")
    server.submit(3, priority="gold")  # sheds a bronze: noted, no dump yet
    assert rec.bundles() == [] and rec.events()[-1]["kind"] == "serve.shed"
    server.submit(4, priority="gold")  # the second shed: a burst
    (path, manifest), = rec.bundles()
    assert manifest["reason"] == "shed_burst" and manifest["stage"] == "queue"
    assert manifest["attrs"]["shed_total"] == 2
    assert verify_j(path) == verify_t(path)
    for n in (5, 8):
        server.submit(n, priority="gold")  # the last two bronze go
    with pytest.raises(qt.ServeQueueFull):
        server.submit(9, priority="gold")  # no lower class left to shed
    assert server.stats()["shed"] == {"gold": 1, "bronze": 4}  # the rejected gold counts
    assert [m["reason"] for _p, m in rec.bundles()] == ["shed_burst"] * 2


def _tap(server, cls, rows):
    """Record every lookup the server's degraded store serves."""
    class Tap(cls):
        def __getitem__(self, ids):
            out = super().__getitem__(ids)
            rows.append(np.array(out.numpy() if isinstance(out, torch.Tensor) else out))
            return out
    server.feature.__class__ = Tap


@pytest.mark.parametrize("fallback", ["zeros", "last-good"])
def test_degraded_server_equals_jax(stack, fallback, tmp_path):
    """A store that fails lookups 4-9 and 13-15 (the construction probe is
    lookup 0) behind both servers: closed-breaker failures raise out of
    the same pumps, the open breaker serves the same fallback rows
    bitwise, probes close it, and the counters agree; the breaker-open
    bundle verifies under both packages."""
    fail = {4, 5, 6, 7, 8, 9, 13, 14, 15}
    rec = qt.FlightRecorder(tmp_path / "pm")
    (sj, cj), (st, ct) = _servers(
        stack, fj=_Flaky(stack["fj"], fail), ft=_Flaky(stack["ft"], fail),
        degraded=fallback, breaker_failures=2, probe_every=2)
    st_rec = qt.InferenceServer(
        qt.GraphSageSampler(stack["tt"], list(SIZES), device="cpu", seed=SEED),
        stack["mt"], _Flaky(stack["ft"], fail), device="cpu", buckets=(1, 2),
        seed=SEED, clock=FakeClock(), draw_fn=jax_draw_fn(SEED, SIZES),
        degraded=fallback, breaker_failures=2, probe_every=2, recorder=rec)
    assert isinstance(st.feature, DegradedT) and isinstance(sj.feature, DegradedJ)
    rows_j, rows_t = [], []
    _tap(sj, DegradedJ, rows_j)
    _tap(st, DegradedT, rows_t)
    ops = []
    for n in (5, 9, 17, 5, 120, 9, 300, 17, 41, 5, 9, 77, 200, 17, 5, 9, 3, 250):
        ops += [("submit", (n, "gold")), ("pump", True)]
    out_t = _drive(st, ct, ops)
    _same_outcomes(out_t, _drive(sj, cj, ops))
    # a recorder on the same stream changes no outcome
    assert [o[0] for o in _drive(st_rec, st_rec.clock, ops)] == [o[0] for o in out_t]
    assert ("raised",) in out_t
    assert len(rows_t) == len(rows_j) > 0
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
    a, b = st.stats(), sj.stats()
    assert a["degraded_lookups"] == b["degraded_lookups"] > 0
    assert a["requests"] == b["requests"]
    assert st.feature.breaker.state == sj.feature.breaker.state == "closed"
    assert int(st.metrics.value("serve.degraded_lookups")) == a["degraded_lookups"]
    assert int(st.metrics.value("resilience.degraded_lookups")) == st.feature.degraded_total
    bundles = rec.bundles()
    assert bundles and all(m["reason"] == "breaker_open" for _p, m in bundles)
    for path, _m in bundles:
        assert verify_j(path) == verify_t(path)


# -- model and sampler layers ------------------------------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def port_log():
    """Records of the ``quiver_tpu_torch`` logger at INFO and above,
    captured by a handler attached to it (not through propagation)."""
    reset_once()
    logger = logging.getLogger("quiver_tpu_torch")
    level, handler = logger.level, _Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)
    logger.setLevel(level)
    reset_once()


def _adj(num_dst=4, fanout=3, dim=2):
    msgs = np.arange(num_dst * fanout * dim, dtype=np.float32).reshape(num_dst * fanout, dim)
    return msgs, np.repeat(np.arange(num_dst), fanout), np.ones(num_dst * fanout, bool)


@pytest.mark.parametrize("on", [False, True])
def test_quiver_check_in_both_packages(monkeypatch, on):
    """``QUIVER_CHECK`` (read once per process) asserts the regular layout
    in both packages; off, the dense path trusts the claim in both."""
    for mod in (layers_t, layers_j):
        monkeypatch.setattr(mod, "_check_cache", None)
    if on:
        monkeypatch.setenv("QUIVER_CHECK", "1")
    else:
        monkeypatch.delenv("QUIVER_CHECK", raising=False)
    msgs, dst, valid = _adj()
    bad = np.roll(dst, 1)
    good_t = layers_t.segment_mean_aggregate(torch.from_numpy(msgs), torch.from_numpy(dst),
                                             torch.from_numpy(valid), 4, fanout=3)
    good_j = layers_j.segment_mean_aggregate(jnp.asarray(msgs), jnp.asarray(dst),
                                             jnp.asarray(valid), 4, fanout=3)
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    lanes = torch.from_numpy(np.stack([dst, bad]))  # a lane-batched Adj, one lane broken
    if on:
        with pytest.raises(AssertionError, match="QUIVER_CHECK: 4 valid"):
            layers_t.segment_mean_aggregate(torch.from_numpy(np.stack([msgs] * 2)), lanes,
                                            torch.from_numpy(np.stack([valid] * 2)), 4,
                                            fanout=3)
        with pytest.raises(Exception, match="QUIVER_CHECK"):
            np.asarray(layers_j.segment_mean_aggregate(jnp.asarray(msgs), jnp.asarray(bad),
                                                       jnp.asarray(valid), 4, fanout=3))
    else:
        layers_t.segment_mean_aggregate(torch.from_numpy(msgs), torch.from_numpy(bad),
                                        torch.from_numpy(valid), 4, fanout=3)
    monkeypatch.setenv("QUIVER_CHECK", "0" if on else "1")
    assert layers_t._check_enabled() is on  # pinned at first use


def test_dense_gate_fallback_logged_once(port_log):
    msgs, dst, valid = (torch.from_numpy(a) for a in _adj())
    want = layers_t.segment_mean_aggregate(msgs, dst, valid, 4)
    for _ in range(2):
        out = layers_t.segment_mean_aggregate(msgs, dst, valid, 4, fanout=5)  # wrong
        assert torch.equal(out, want)
    lines = [r.getMessage() for r in port_log if "segment-scatter" in r.getMessage()]
    assert lines == ["Adj.fanout=5 set but E=12 != num_dst*fanout=20; falling back "
                     "to the segment-scatter aggregation path"]


def test_auto_caps_planned_and_regrown_logged(stack, port_log):
    smp = qt.GraphSageSampler(stack["tt"], list(SIZES), device="cpu", seed=1,
                              frontier_caps="auto", auto_margin=1.0, seed_capacity=16)
    smp.sample(np.arange(2))
    smp.sample(np.arange(16))  # more seeds than planned for: regrowth
    lines = [r.getMessage() for r in port_log if r.getMessage().startswith("auto caps")]
    assert lines[0].startswith("auto caps planned: None -> (")
    assert smp.reruns == 0 or any(m.startswith("auto caps regrown") for m in lines)
