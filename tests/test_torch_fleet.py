"""The port's serving fleet and program cache (quiver_tpu_torch/serving/
fleet.py, aot.py, ladder.py's programs) against the JAX package's.

The port's versions of ``tests/test_serving_fleet.py``'s warm-replica,
two-replica, shed-metrics and refresh-after-commit tests, on the CPU,
where a program is the eager step bound to static buffers and is built,
counted, cached and replayed as a CUDA graph is on the card; then the
fleet against the JAX fleet under one fake clock and request stream.
The JAX fleets run with ``aot_cache=None``: this image's JAX cannot load
its own serialised executables (``tests/test_serving_fleet.py`` fails
here for that), and routing, shedding and the stats layout do not depend
on the cache.

Tolerance: bitwise within the port (responses against ``fleet.oracle``,
replica against replica); exact for counters, routing and layouts;
served log-probs within atol = rtol = 1e-5 across the packages under the
JAX draws (``test_torch_serve.jax_draw_fn``; float32, different summation
orders).
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402
from quiver_tpu.serving.aot import AOTExecutableCache as CacheJ  # noqa: E402
from test_torch_serve import jax_draw_fn  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.obs.registry import (  # noqa: E402
    SERVE_AOT_LOADS,
    SERVE_CLASS_MISSES,
    SERVE_RECOMPILES,
    SERVE_SHED,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _stacks(n, e, seed, F=8, hidden=8, classes=3, sizes=(3, 2)):
    """One graph, feature table and set of weights in both packages:
    ``(port (sampler, model, feature), jax (sampler, model, params,
    feature), port topology)``."""
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, size=(2, e)).astype(np.int64)
    x = rng.normal(size=(n, F)).astype(np.float32)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    mj = SageJ(hidden=hidden, num_classes=classes, num_layers=len(sizes))
    adjs = empty_adjs(list(sizes), batch=4, node_count=n)
    params = init_model(mj, jax.random.PRNGKey(seed),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, hidden, classes, num_layers=len(sizes))
    mt.load_state_dict(flax_sage_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    port = (qt.GraphSageSampler(tt, list(sizes), device="cpu", seed=seed), mt,
            qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x))
    ref = (qj.GraphSageSampler(tj, list(sizes), seed=seed), mj, params,
           qj.Feature(device_cache_size="1G").from_cpu_tensor(x))
    return port, ref, tt


@pytest.fixture(scope="module")
def warm_stack(tmp_path_factory):
    """One port stack and one program cache populated by a first replica
    (4 programs: sample and forward at buckets 1 and 2)."""
    cache_dir = str(tmp_path_factory.mktemp("aot") / "programs")
    (sampler, model, feat), ref, _ = _stacks(160, 900, 2)
    server = qt.InferenceServer(sampler, model, feat, device="cpu", max_batch=2,
                                clock=FakeClock(), seed=7, aot_cache=cache_dir)
    first = server.warm_from_cache()

    def replica(**kw):
        kw.setdefault("max_batch", 2)
        kw.setdefault("clock", FakeClock())
        kw.setdefault("seed", 7)
        kw.setdefault("aot_cache", cache_dir)
        return qt.InferenceServer(sampler, model, feat, device="cpu", **kw)

    return {"server": server, "first": first, "cache_dir": cache_dir,
            "replica": replica, "stack": (sampler, model, feat), "ref": ref}


def test_warm_replica_zero_compiles_bitwise(warm_stack):
    """A second replica in the process takes every program from the cache
    (zero captures) and answers every (node, seq) bitwise as the replica
    that captured, and as the oracle."""
    a = warm_stack["server"]
    assert warm_stack["first"] == {"loaded": 0, "compiled": 4}
    assert a.recompiles == 4 and int(a.metrics.value(SERVE_RECOMPILES)) == 4
    b = warm_stack["replica"]()
    ws = b.warm_from_cache()
    assert ws == {"loaded": 4, "compiled": 0}
    assert b.recompiles == 0
    assert b.aot_loads == ws["loaded"]
    assert int(b.metrics.value(SERVE_AOT_LOADS)) == ws["loaded"]
    # the replicas hold the same program objects
    assert all(p is q for p, q in zip(a.ladder.programs(), b.ladder.programs()))

    nodes = [3, 11, 19]  # batches of 2 + a forced tail of 1
    out_a = a.serve(nodes)
    out_b = b.serve(nodes)
    assert b.recompiles == 0  # steady state builds nothing
    for ra, rb in zip(out_a, out_b):
        assert (ra.node, ra.seq) == (rb.node, rb.seq)
        np.testing.assert_array_equal(ra.result, rb.result)
        np.testing.assert_array_equal(rb.result, b.oracle(rb.node, rb.seq))
    # every answer is its own copy: a later batch overwrites the programs'
    # outputs, never a returned result
    np.testing.assert_array_equal(out_a[0].result, a.oracle(3, out_a[0].seq))


def test_server_shed_and_class_miss_metrics(warm_stack):
    """Shed and deadline-miss counts land per class on the server's
    registry (vectors in PRIORITIES order: gold, bronze)."""
    clock = FakeClock()
    e = warm_stack["replica"](clock=clock, max_queue=2,
                              class_deadlines={"gold": 1.0, "bronze": 0.5})
    assert e.warm_from_cache()["compiled"] == 0
    e.submit(1, priority="bronze")
    e.submit(2, priority="bronze")
    e.submit(3, priority="gold")  # sheds bronze node 2
    np.testing.assert_array_equal(
        np.asarray(e.metrics.value(SERVE_SHED)), [0, 1])
    clock.advance(5.0)  # both survivors blow their class deadline
    out = e.pump(force=True)
    assert sorted(r.node for r in out) == [1, 3]
    np.testing.assert_array_equal(
        np.asarray(e.metrics.value(SERVE_CLASS_MISSES)), [1, 1])
    st = e.stats()
    assert st["shed"] == {"gold": 0, "bronze": 1}
    assert st["class_deadline_misses"] == {"gold": 1, "bronze": 1}
    assert st["deadline_misses"] == 2


def test_fleet_two_replicas_share_cache(warm_stack):
    """A 2-replica fleet over the populated cache joins with no capture,
    and every response equals the shared oracle bitwise."""
    sampler, model, feat = warm_stack["stack"]
    fleet = qt.ServingFleet(sampler, model, feat, replicas=2,
                            aot_cache=warm_stack["cache_dir"], seed=7,
                            max_batch=2, clock=FakeClock(), device="cpu")
    assert [c["compiled"] for c in fleet.cold_starts] == [0, 0]
    assert fleet.recompiles == 0 and fleet.aot_loads == 8
    assert len(fleet.aot_cache) == warm_stack["first"]["compiled"]
    out = fleet.serve(range(6))
    assert all(r.done and not r.shed for r in out)
    for r in out:
        np.testing.assert_array_equal(r.result, fleet.oracle(r.node, r.seq))
    st = fleet.stats()
    assert st["requests"] == 6 and st["recompiles"] == 0
    assert st["replicas"] == 2


def _insert_one_edge(topo):
    """The merged CSR of ``topo`` plus one edge it lacks, appended at its
    source row's end (a streaming insert's publish)."""
    n = topo.node_count
    src = np.repeat(np.arange(n), topo.degree)
    live = set((src * n + np.asarray(topo.indices)).tolist())
    k = next(k for k in range(n * n) if k not in live)
    u, v = divmod(k, n)
    indptr = np.asarray(topo.indptr, np.int64).copy()
    indices = np.insert(np.asarray(topo.indices), indptr[u + 1], v)
    indptr[u + 1:] += 1
    return indptr, indices


def test_refresh_after_commit_rechecks_cache(tmp_path):
    """A mutation forks every fingerprint (csr_version is keyed): the first
    replica to refresh re-places the shared sampler and captures the new
    version's programs; the second finds the sampler placed and takes
    them from the cache, staying at zero lifetime captures, bitwise."""
    (sampler, model, feat), _ref, tt = _stacks(60, 400, 4, F=6)
    cd = str(tmp_path / "aot")
    f = qt.InferenceServer(sampler, model, feat, device="cpu", max_batch=1,
                           clock=FakeClock(), seed=5, aot_cache=cd)
    first = f.warm_from_cache()
    assert first["compiled"] > 0
    g = qt.InferenceServer(sampler, model, feat, device="cpu", max_batch=1,
                           clock=FakeClock(), seed=5, aot_cache=cd)
    assert g.warm_from_cache() == {"loaded": first["compiled"], "compiled": 0}

    placed = sampler.topo
    tt._publish_mutation(*_insert_one_edge(tt))
    with pytest.raises(qt.VersionMismatchError):
        g.pump(force=True)
    f.refresh()  # re-places, captures the new version's programs, publishes
    assert f.recompiles == 2 * first["compiled"]
    assert sampler.topo is not placed
    replaced = sampler.topo
    loads_before = g.aot_loads
    g.refresh()  # the sampler is placed: takes f's programs
    assert sampler.topo is replaced  # re-placing at a placed version is a no-op
    assert g.recompiles == 0
    assert g.aot_loads == loads_before + first["compiled"]
    rf = f.serve([7])[0]
    rg = g.serve([7])[0]
    assert (rf.node, rf.seq) == (rg.node, rg.seq)
    np.testing.assert_array_equal(rf.result, rg.result)
    np.testing.assert_array_equal(rg.result, g.oracle(rg.node, rg.seq))


# -- the fleet against the JAX fleet -----------------------------------------

OPS = ([("submit", (n, "gold")) for n in (5, 9, 13)]
       + [("submit", (n, "bronze")) for n in (2, 4, 6, 8)]
       + [("pump", False), ("submit", (21, "gold")), ("advance", 0.04),
          ("pump", False), ("submit", (30, "bronze")), ("submit", (31, "gold")),
          ("pump", True), ("pump", True), ("pump", True), ("pump", True)])


def _drive(fleet, clock, ops):
    """Run ``ops`` on a fleet; returns what each op did: the replica and
    request a submit landed on (or the rejection), the (node, seq,
    replica) of every completed request."""
    out, reqs = [], []
    for op, arg in ops:
        if op == "submit":
            node, prio = arg
            try:
                r = fleet.submit(node, priority=prio)
            except qj.ServeQueueFull:
                out.append(("full", node))
                continue
            except qt.ServeQueueFull:
                out.append(("full", node))
                continue
            reqs.append(r)
            out.append(("admit", node, r.seq, prio))
        elif op == "pump":
            done = fleet.pump(force=arg)
            out.append(("done", [(r.node, r.seq) for r in done]))
        else:
            clock.advance(arg)
    out.append(("shed", sorted((r.node, r.seq) for r in reqs if r.shed)))
    return out, reqs


def _fleets(n=160, e=900, seed=2, **kw):
    (st, mt, ft), (sj, mj, pj, fj), _ = _stacks(n, e, seed)
    cj, ct = FakeClock(), FakeClock()
    tj, tt = qj.Tracer(), qt.Tracer()
    fleet_j = qj.ServingFleet(sj, mj, pj, fj, aot_cache=None, seed=7,
                              clock=cj, tracer=tj, **kw)
    fleet_t = qt.ServingFleet(st, mt, ft, aot_cache=None, seed=7, clock=ct,
                              tracer=tt, device="cpu", **kw)
    return (fleet_j, cj), (fleet_t, ct)


def test_routing_and_failover_match_jax_fleet():
    """Least-depth routing, per-replica shedding and full-queue failover
    and rejection follow the JAX fleet's order exactly under one clock and
    request stream; so do the fleet's trace events and the counters."""
    (fj, cj), (ft, ct) = _fleets(replicas=2, max_batch=2, max_queue=2,
                                 class_deadlines={"gold": 0.05, "bronze": 0.02})
    got, _ = _drive(ft, ct, OPS)
    want, _ = _drive(fj, cj, OPS)
    assert got == want
    assert ("full", 8) in got  # both replicas full of gold: rejected
    ev_t = [(s.name, s.attrs.get("replica"), s.attrs.get("node"))
            for s in ft.tracer.spans() if s.name.startswith("fleet.")]
    ev_j = [(s.name, s.attrs.get("replica"), s.attrs.get("node"))
            for s in fj.tracer.spans() if s.name.startswith("fleet.")]
    assert ev_t == ev_j and any(n == "fleet.failover" for n, _, _ in ev_t)
    a, b = ft.stats(), fj.stats()
    for key in ("replicas", "requests", "deadline_misses",
                "class_deadline_misses", "shed", "queue_depth"):
        assert a[key] == b[key], key
    assert ft.health() == fj.health()


def test_stats_layout_matches_jax_fleet(tmp_path):
    """``stats()`` has the JAX fleet's keys, per replica too, and the
    cache's ``stats()`` the JAX cache's; the join records carry the same
    fields and, with no cache, the same capture counts as JAX's
    compiles."""
    (fj, _), (ft, _) = _fleets(replicas=2, max_batch=2)
    a, b = ft.stats(), fj.stats()
    assert set(a) == set(b)
    assert [set(p) for p in a["per_replica"]] == [set(p) for p in b["per_replica"]]
    assert [set(c) for c in a["cold_starts"]] == [set(c) for c in b["cold_starts"]]
    assert ([(c["loaded"], c["compiled"]) for c in a["cold_starts"]]
            == [(c["loaded"], c["compiled"]) for c in b["cold_starts"]] == [(0, 4), (0, 4)])
    assert a["recompiles"] == b["recompiles"] == 8
    assert set(qt.AOTExecutableCache(str(tmp_path)).stats()) == set(
        CacheJ(str(tmp_path)).stats())


def test_jax_draws_fleet_matches_jax_fleet(tmp_path):
    """Under the JAX fleet's draws the port's replicas answer as the JAX
    fleet's, and the second replica still joins with no capture (its
    eager sample step is shared through the cache too)."""
    (st, mt, ft), (sj, mj, pj, fj), _ = _stacks(160, 900, 3)
    fleet_j = qj.ServingFleet(sj, mj, pj, fj, replicas=2, aot_cache=None, seed=7,
                              max_batch=2, clock=FakeClock())
    fleet_t = qt.ServingFleet(st, mt, ft, replicas=2, aot_cache=str(tmp_path),
                              seed=7, max_batch=2, clock=FakeClock(), device="cpu",
                              draw_fn=jax_draw_fn(7, (3, 2)))
    assert [c["compiled"] for c in fleet_t.cold_starts] == [4, 0]
    nodes = np.random.default_rng(0).integers(0, 160, 9)
    rt, rj = fleet_t.serve(nodes), fleet_j.serve(nodes)
    assert [(r.node, r.seq) for r in rt] == [(r.node, r.seq) for r in rj]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.result, b.result, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(a.result, fleet_t.oracle(a.node, a.seq))


def test_add_replica_health_and_telemetry(warm_stack):
    """A replica added mid-traffic joins with no capture; the telemetry
    endpoint serves the fleet's health over localhost."""
    sampler, model, feat = warm_stack["stack"]
    fleet = qt.ServingFleet(sampler, model, feat, replicas=1,
                            aot_cache=warm_stack["cache_dir"], seed=7,
                            max_batch=2, clock=FakeClock(), device="cpu")
    first = fleet.serve([1, 2, 3])
    fleet.add_replica()
    assert fleet.cold_starts[-1]["compiled"] == 0 and len(fleet.servers) == 2
    more = fleet.serve([4, 5, 6, 7])
    for r in first + more:
        np.testing.assert_array_equal(r.result, fleet.oracle(r.node, r.seq))
    with fleet.serve_telemetry() as ep:
        with urllib.request.urlopen(f"{ep.url}/healthz", timeout=10) as resp:
            body = json.loads(resp.read())
    assert body["replicas"] == 2 and len(body["per_replica"]) == 2
    fleet.check_version()
