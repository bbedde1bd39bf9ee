"""One rank of a world of ``gloo`` CPU processes, for tests/test_torch_world.py.

    python tests/torch_world_worker.py RANK WORLD_SIZE STORE_FILE OUT_DIR CASES

joins the world through a file store (``file://STORE_FILE``), runs the
comma-separated CASES on world meshes (``make_mesh(data=, feature=)``
after ``init_distributed``) and, on rank 0, the same calls on logical
meshes of the same shapes (``make_mesh(devices=["cpu"] * n)``), then
writes its results to ``OUT_DIR/rank<RANK>.pt``: ``{name: value}``, a
world result under ``"<case>/<name>"`` and rank 0's logical reference for
worker ``w`` under ``"ref/<case>/<name>/<w>"``. The test compares them.

Every process runs at one thread, the logical reference too, so that the
CPU's float reductions do not depend on a thread count. It imports
neither JAX nor the JAX package.
"""

import hashlib
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import (GUARD_NONFINITE, GUARD_SKIPPED,  # noqa: E402
                                           MetricsRegistry)
from quiver_tpu_torch.parallel import world  # noqa: E402
from quiver_tpu_torch.parallel.mesh import (DATA_AXIS, FEATURE_AXIS,  # noqa: E402
                                            init_distributed, shutdown_distributed)
from quiver_tpu_torch.parallel.routing import BucketRoute  # noqa: E402
from quiver_tpu_torch.parallel.trainer import (DataParallelTrainer,  # noqa: E402
                                               DistributedTrainer)
from quiver_tpu_torch.resilience import FaultPlan  # noqa: E402
from quiver_tpu_torch.resilience.guard import guard_verdict  # noqa: E402

SIZES = (4, 3)
LOCAL = 32
ROW_B = 4 * 4  # float32 rows of the planted graph's 4 features
# three tiers over 300 rows: 30 on L0, 40 per L1 shard, the rest cold
STORES = {None: {"device_cache_size": 40 * ROW_B, "replicate_budget": 30 * ROW_B},
          "int8": {"device_cache_size": 4 * 300 + 40 * 4, "replicate_budget": 30 * 4}}
BOTH = (DATA_AXIS, FEATURE_AXIS)


def labeled_graph(n=300, classes=4, seed=0):
    """``tests/test_torch_fused_trainer.py``'s planted graph."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    feat = np.eye(classes, dtype=np.float32)[labels] * 2.0
    feat += rng.normal(scale=0.8, size=(n, classes)).astype(np.float32)
    rows, cols = [], []
    for c in range(classes):
        members = np.where(labels == c)[0]
        rows.extend(rng.choice(members, 6 * len(members)))
        cols.extend(rng.choice(members, 6 * len(members)))
    return np.stack([np.asarray(rows), np.asarray(cols)]), feat, labels


GRAPH = labeled_graph()


def logical(data, feature):
    return qt.make_mesh(data=data, feature=feature, devices=["cpu"] * (data * feature))


class Run:
    """One process's results, and whether it holds the references."""

    def __init__(self, rank, size):
        self.rank, self.size, self.out = rank, size, {}

    @property
    def ref(self):
        return self.rank == 0

    def put(self, case, name, value):
        self.out[f"{case}/{name}"] = value

    def put_ref(self, case, name, worker, value):
        self.out[f"ref/{case}/{name}/{worker}"] = value


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clone(x) for x in v]
    return v


# -- (i) the job forms; digests and sums ------------------------------------------------


def case_world(run):
    """The CSR digests gathered over the world, an ordered sum, the
    metrics tape's sums and the guard's verdict."""
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    mesh = qt.make_mesh(data=run.size)
    topo = qt.CSRTopo(edge_index=generate_pareto_graph(5000, 8.0, seed=7))
    h = hashlib.sha256()
    for arr in (topo.indptr, topo.indices, topo.eid):
        h.update(np.ascontiguousarray(arr).tobytes())
    words = torch.from_numpy(np.frombuffer(h.digest(), dtype=np.int32).copy())
    run.put("world", "digests", world.all_gather(words, mesh.group(BOTH), BOTH))
    run.put("world", "digest", words)
    vecs = [torch.from_numpy(np.random.default_rng(r).normal(size=64).astype(np.float32))
            for r in range(run.size)]
    run.put("world", "osum", world.ordered_sum(vecs[run.rank], mesh.group(BOTH), BOTH))
    fold = vecs[0]
    for v in vecs[1:]:
        fold = fold + v
    run.put("world", "fold", fold)
    reg = MetricsRegistry()
    reg.counter("test.count", shape=(2,))
    reg.gauge("test.mass", dtype=torch.float32)
    tape = reg.tape()
    tape.add("test.count", torch.tensor([run.rank, 1], dtype=torch.int32), psum=BOTH)
    tape.set("test.mass", vecs[run.rank][0], psum=DATA_AXIS)
    run.put("world", "tape", tape.finalize(mesh=mesh))
    run.put("world", "tape_want", {"test.count": np.array([sum(range(run.size)), run.size]),
                                   "test.mass": np.float32(fold[0])})
    loss = torch.tensor(float("nan") if run.rank == run.size - 1 else 1.0)
    ok, bad = guard_verdict(loss, [torch.ones(3)], BOTH, mesh=mesh)
    run.put("world", "guard", (bool(ok), int(bad)))


# -- (ii) BucketRoute ----------------------------------------------------------------------

ROUTE_N, ROUTE_L = 60, 24
ROUTE_TABLE = torch.from_numpy(
    np.random.default_rng(5).normal(size=(ROUTE_N, 3)).astype(np.float32))


def route_inputs(flat):
    """Worker ``flat``'s requests: skewed towards shard 0, some invalid."""
    rng = np.random.default_rng(100 + flat)
    ids = np.where(rng.random(ROUTE_L) < 0.6, rng.integers(0, 10, ROUTE_L),
                   rng.integers(0, ROUTE_N, ROUTE_L))
    valid = rng.random(ROUTE_L) > 0.15
    pay = rng.normal(size=(ROUTE_L, 3)).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(valid),
            torch.from_numpy(pay))


def route_serve(F):
    rps = -(-ROUTE_N // F)

    def serve(member, req, pay=None):
        own = (req >= 0) & (torch.div(req, rps, rounding_mode="floor") == member)
        rows = ROUTE_TABLE[req.clamp(min=0)]
        if pay is not None:
            rows = rows * 2.0 + pay
        return torch.where(own[:, None], rows, torch.zeros(()))

    return serve, rps


def route_exchanges(route, serve, pay):
    first = route.exchange(serve)
    second = route.exchange(serve, pay)
    return first, second, route.overflow


def case_route(run, data, feature):
    """Capped (overflowing), uncapped and payload exchanges through one
    plan per cap, on the world's feature groups."""
    case = f"route{data}{feature}"
    mesh = qt.make_mesh(data=data, feature=feature)
    serve, rps = route_serve(feature)
    ids, valid, pay = route_inputs(run.rank)
    for cap in (2, None):
        route = BucketRoute(ids, valid, torch.div(ids, rps, rounding_mode="floor"),
                            num_shards=feature, cap=cap, group=mesh.group(FEATURE_AXIS))
        run.put(case, f"cap{cap}", route_exchanges(route, serve, pay))
    if run.ref:
        for g in range(data):
            members = [g * feature + f for f in range(feature)]
            ins = [route_inputs(w) for w in members]
            i, v, p = (torch.stack(t) for t in zip(*ins))
            for cap in (2, None):
                route = BucketRoute(i, v, torch.div(i, rps, rounding_mode="floor"),
                                    num_shards=feature, cap=cap)
                first, second, ov = route_exchanges(route, serve, p)
                for f, w in enumerate(members):
                    run.put_ref(case, f"cap{cap}", w, (first[f], second[f], ov))


# -- (iii) ShardedFeature ------------------------------------------------------------------


def store_calls(store, routed_ids, group_ids):
    """The standalone gathers of a global id vector (psum, routed auto,
    routed capped), then one feature group's lookups: the psum flavour on
    the group's shared ids and the routed one on each member's."""
    rng = np.random.default_rng(7)
    gids = torch.from_numpy(rng.integers(-1, 300, 203).astype(np.int64))
    out = {"psum": store.gather(gids)}
    out["hits"] = store.last_tier_hits.clone()
    out["routed"] = store.gather(gids, routed=True)
    out["routed_ov"] = store.last_routed_overflow.clone()
    out["routed_cap"] = store.gather(gids, routed=True, routed_cap=3)
    out["routed_cap_ov"] = store.last_routed_overflow.clone()
    out["lookup_psum"] = store.lookup(group_ids)
    cap = store.hot.routed_cap(int(routed_ids.shape[-1]), 0.05)
    out["lookup_routed"] = store.lookup(routed_ids, routed=True, cap=cap)
    return out


def lookup_ids(seed, n=40):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-1, 300, n).astype(np.int64))


def case_store(run, data, feature):
    ei, feat, _ = GRAPH
    d = run.rank // feature
    for dtype in (None, "int8"):
        case = f"store{data}{feature}_{dtype or 'f32'}"
        topo = qt.CSRTopo(edge_index=ei)
        mesh = qt.make_mesh(data=data, feature=feature)
        store = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05, dtype=dtype,
                                  **STORES[dtype]).from_cpu_tensor(feat)
        assert store.rep_rows and store.hot_rows and store.cold is not None
        run.put(case, "split", (store.rep_rows, store.hot_rows))
        run.put(case, "out", _clone(store_calls(store, lookup_ids(300 + run.rank),
                                                lookup_ids(200 + d))))
        if run.ref:
            for g in range(data):
                # a fresh store per group: the auto cap grows after a call
                ref = qt.ShardedFeature(logical(data, feature), csr_topo=qt.CSRTopo(edge_index=ei),
                                        routed_alpha=0.05, dtype=dtype,
                                        **STORES[dtype]).from_cpu_tensor(feat)
                members = [g * feature + i for i in range(feature)]
                out = _clone(store_calls(
                    ref, torch.stack([lookup_ids(300 + w) for w in members]),
                    lookup_ids(200 + g)))
                rows, hits, ov = out.pop("lookup_routed")
                for i, w in enumerate(members):
                    run.put_ref(case, "out", w, {**out, "lookup_routed": (rows[i], hits[i], ov)})


# -- (iv) DistributedTrainer ---------------------------------------------------------------

TRAIN_STEPS = 3


def make_trainer(mesh, seed_sharding, depth, draw_fn=None, **kw):
    ei, feat, _ = GRAPH
    topo = qt.CSRTopo(edge_index=ei)
    feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05,
                                **STORES[None]).from_cpu_tensor(feat)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=kw.pop("dropout", 0.5))
    opt = kw.pop("optimizer", None) or torch.optim.Adam(model.parameters(), lr=5e-3)
    trainer = DistributedTrainer(
        mesh, qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=LOCAL,
                                  seed=9),
        feature, model, opt, local_batch=LOCAL, seed_sharding=seed_sharding,
        routed_alpha=0.05, pipeline_depth=depth, **kw)
    trainer.init(0)
    trainer.draw_fn = draw_fn
    return trainer


def train_record(trainer, workers):
    """3 steps (the guard skips step 1, whose rows the plan poisons), then a
    3-step ``epoch_scan``: every step's ids and rows of ``workers``, the
    losses, the metrics and the parameters after each part."""
    labels = torch.from_numpy(GRAPH[2].astype(np.int32))
    issued = []
    issue = trainer._issue
    trainer._issue = lambda *a: issued.append(issue(*a)) or issued[-1]
    n = trainer.sampler.csr_topo.node_count
    rng = np.random.default_rng(3)
    steps = []
    for t in range(TRAIN_STEPS):
        loss = trainer.step(rng.integers(0, n, trainer.global_batch), labels, 5 + t)
        steps.append({"loss": loss, "hits": trainer.last_tier_hits,
                      "overflow": trainer.last_routed_overflow,
                      "skipped": trainer.metrics.value(GUARD_SKIPPED),
                      "nonfinite": trainer.metrics.value(GUARD_NONFINITE)})
    params = dict(trainer.model.state_dict())
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, n, 3 * trainer.global_batch),
                             seed=2)
    losses = trainer.epoch_scan(mat, labels, 11)
    epoch = {"losses": losses, "hits": trainer.last_tier_hits,
             "overflow": trainer.last_routed_overflow,
             "skipped": trainer.metrics.value(GUARD_SKIPPED)}
    blocks = {w: [(b.n_id, b.x) for b in (s.blocks[i] for s in issued)]
              for i, w in enumerate(workers)}
    return _clone({"steps": steps, "params": params, "epoch": epoch,
                   "epoch_params": dict(trainer.model.state_dict())}), _clone(blocks)


def case_trainer(run, data, feature):
    plan = FaultPlan(nan_feature_steps=(1,))
    for seed_sharding in ("data", "all"):
        for depth in (0, 1):
            case = f"trainer{data}{feature}_{seed_sharding}_{depth}"
            trainer = make_trainer(qt.make_mesh(data=data, feature=feature), seed_sharding,
                                   depth, nonfinite_guard=True, fault_plan=plan)
            res, blocks = train_record(trainer, trainer._held)
            (w, b), = blocks.items()
            run.put(case, "res", res)
            run.put(case, "worker", w)
            run.put(case, "blocks", b)
            if run.ref:
                ref = make_trainer(logical(data, feature), seed_sharding, depth,
                                   nonfinite_guard=True, fault_plan=plan)
                res, blocks = train_record(ref, list(range(ref.workers)))
                run.put_ref(case, "res", 0, res)
                for w, b in blocks.items():
                    run.put_ref(case, "blocks", w, b)


# -- (v) DataParallelTrainer ---------------------------------------------------------------


def dp_record(mesh):
    ei, feat, labels = GRAPH
    topo = qt.CSRTopo(edge_index=ei)
    feature = qt.Feature(device_cache_size=100 * ROW_B, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=LOCAL,
                                  seed=4)
    model = GraphSAGE(4, 16, 4, num_layers=2)
    trainer = DataParallelTrainer(mesh, sampler, feature, model,
                                  torch.optim.Adam(model.parameters(), lr=5e-3),
                                  local_batch=LOCAL)
    trainer.init(torch.Generator().manual_seed(0))
    labels = torch.from_numpy(labels.astype(np.int32))
    out = {}
    for depth in (0, 2):
        loss, steps = trainer.train_epoch(np.arange(200), labels,
                                          torch.Generator().manual_seed(7 + depth),
                                          rng=np.random.default_rng(depth), depth=depth)
        out[depth] = (loss, steps, _clone(dict(model.state_dict())))
    out["calls"] = sampler._call
    return out


def case_dp(run):
    run.put("dp", "res", dp_record(qt.make_mesh(data=run.size)))
    if run.ref:
        run.put_ref("dp", "res", 0, dp_record(logical(run.size, 1)))


# -- (vi) the options A.11e (a1) left refused, which A.11e (a2) and (a3) ported -----------


def case_refusals(run, out_dir):
    """Each option of the ten that A.11e (a1) left refused: what it raised
    (``NotImplementedError``'s message), or ``"no raise"``. Every rank
    calls each with the same inputs."""
    ei, feat, _ = GRAPH
    mesh = qt.make_mesh(data=1, feature=run.size)
    topo = qt.CSRTopo(edge_index=ei)
    said = {}

    def attempt(name, fn):
        try:
            fn()
            said[name] = "no raise"
        except NotImplementedError as e:
            said[name] = str(e)

    from quiver_tpu_torch.control import CacheController

    attempt("topo_sharded_sampler", lambda: qt.GraphSageSampler(
        topo, list(SIZES), topo_sharding="mesh", mesh=mesh))
    attempt("logical_workers", lambda: make_trainer(mesh, "all", 0,
                                                    logical_workers=2 * run.size))
    attempt("controller", lambda: make_trainer(mesh, "all", 0,
                                               controller=CacheController()))
    attempt("auto_alpha", lambda: make_trainer(mesh, "all", 0, auto_alpha=True))
    held = {}
    attempt("checkpoint_dir", lambda: held.setdefault("ckpt", make_trainer(
        mesh, "all", 0, checkpoint_dir=os.path.join(out_dir, "ckpt"), checkpoint_every=1)))
    attempt("resume_mesh", lambda: held["ckpt"].resume(mesh=mesh))
    trainer = make_trainer(mesh, "all", 0)
    store = trainer.feature
    attempt("replan", lambda: store.replan(mesh))
    attempt("repin", lambda: store.repin(np.arange(5)))
    attempt("row_updates", lambda: store.apply_row_updates(np.arange(2),
                                                           np.ones((2, 4), np.float32)))
    tuned = qt.ShardedFeature(mesh, csr_topo=qt.CSRTopo(edge_index=ei), auto_split=True,
                              **STORES[None]).from_cpu_tensor(feat)
    attempt("split_tuner", lambda: tuned.gather(torch.arange(10)))
    run.put("refusals", "said", said)


# -- the audit's collective list -------------------------------------------------------------


def audit_collectives(mesh):
    from quiver_tpu_torch.tools.audit import ir

    trainer = make_trainer(mesh, "all", 0, nonfinite_guard=True)
    labels = torch.from_numpy(GRAPH[2].astype(np.int32))
    packed = torch.from_numpy(trainer.shard_seeds(np.arange(trainer.global_batch) % 300))
    program = ir.record(lambda p, lab: trainer._run_step(p, lab, 1, False), packed, labels)
    return [c.signature() for c in ir.collectives_of(program)]


def case_audit(run):
    run.put("audit", "world", audit_collectives(qt.make_mesh(data=1, feature=run.size)))
    if run.ref:
        run.put_ref("audit", "world", 0, audit_collectives(logical(1, run.size)))


# -- (vii) one world step on the JAX package's draws -------------------------------------------


def case_jax(run, draws_file):
    """One (2, 2) step, ``seed_sharding="all"``, SGD 0.1, dropout 0, from
    the JAX trainer's initial parameters, replaying its sample draws."""
    got = torch.load(draws_file)
    draws, params0 = got["draws"], got["params0"]

    def draw_fn(key, w, layer, deg):
        return draws[f"{key}:{w}:{layer}"]

    mesh = qt.make_mesh(data=2, feature=2)
    holder = {}

    def sgd(params):
        holder["opt"] = torch.optim.SGD(params, lr=0.1)
        return holder["opt"]

    ei, feat, labels = GRAPH
    topo = qt.CSRTopo(edge_index=ei)
    feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=0.05,
                                **STORES[None]).from_cpu_tensor(feat)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    trainer = DistributedTrainer(
        mesh, qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=LOCAL,
                                  seed=9),
        feature, model, sgd(model.parameters()), local_batch=LOCAL, seed_sharding="all",
        routed_alpha=0.05)
    trainer.init(0)
    model.load_state_dict(params0)
    trainer.draw_fn = draw_fn
    seeds = got["seeds"].numpy()
    loss = trainer.step(seeds, torch.from_numpy(labels.astype(np.int32)), got["key"])
    run.put("jax", "res", _clone({"loss": loss, "hits": trainer.last_tier_hits,
                                  "overflow": trainer.last_routed_overflow,
                                  "params": dict(model.state_dict())}))


def main():
    rank, size, store, out_dir, cases = sys.argv[1:6]
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", size, rank, device="cpu")
    run = Run(rank, size)
    try:
        for case in cases.split(","):
            name, _, arg = case.partition(":")
            if name == "world":
                case_world(run)
            elif name == "route":
                case_route(run, int(arg[0]), int(arg[1]))
            elif name == "store":
                case_store(run, int(arg[0]), int(arg[1]))
            elif name == "trainer":
                case_trainer(run, int(arg[0]), int(arg[1]))
            elif name == "dp":
                case_dp(run)
            elif name == "refusals":
                case_refusals(run, out_dir)
            elif name == "audit":
                case_audit(run)
            elif name == "jax":
                case_jax(run, arg)
            else:
                raise ValueError(f"unknown case {case!r}")
    except Exception:
        traceback.print_exc()
        run.out["error"] = traceback.format_exc()
    finally:
        shutdown_distributed()
    torch.save(run.out, os.path.join(out_dir, f"rank{rank}.pt"))
    return 1 if "error" in run.out else 0


if __name__ == "__main__":
    sys.exit(main())
