"""One rank of a world of ``gloo`` CPU processes, for tests/test_torch_world_control.py.

    python tests/torch_world_control_worker.py RANK WORLD_SIZE STORE_FILE OUT_DIR CASES

as ``tests/torch_world_worker.py`` (whose helpers it shares): it joins the
world through a file store, runs the comma-separated CASES on world meshes
and, on rank 0, the same calls on logical meshes of the same shapes, then
writes ``OUT_DIR/rank<RANK>.pt``: a world result under ``"<case>/<name>"``
and rank 0's logical reference under ``"ref/<case>/<name>/<w>"``. The
cases cover the adaptive tuners on a world mesh: the cache controller and
``auto_alpha`` under the trainer, ``repin``, row updates and the split
tuner of a standalone store, and a streaming commit with row updates.

A ``jax:FILE`` case waits for FILE (the draws the parent records while
the world runs its other cases) before it replays them.

Every process runs at one thread, the logical reference too. It imports
neither JAX nor the JAX package.
"""

import os
import sys
import time
import traceback

import numpy as np
import torch

# first: it puts the repository's root on sys.path
from torch_world_worker import GRAPH, LOCAL, ROW_B, SIZES, STORES, Run, _clone, logical

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.control import CacheController  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import FEATURE_ROW_HEAT  # noqa: E402
from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402
from quiver_tpu_torch.streaming import CommitAborted, DeltaBatch, StreamingGraph  # noqa: E402

N = 300  # the planted graph's nodes
ALPHA = 0.05  # tight enough that the routed buckets and hops overflow
HEAT_BINS = 16
# (seed sharding, sampler topology, store dtype) of the controlled trainers
CONFIGS = {"data": ("data", "replicated", "int8"), "all": ("all", "replicated", None),
           "topo": ("all", "mesh", "int8")}
JAX_STEPS = 4


def row_bytes(dtype):
    return ROW_B if dtype is None else 4


def tuned_store(dtype):
    """The three-tier store with the split tuner on (an L0 of 30 rows, the
    ceiling it may grow back to)."""
    return dict(STORES[dtype], auto_split=True)


def labels():
    return torch.from_numpy(GRAPH[2].astype(np.int32))


def controlled_trainer(mesh, seed_sharding="all", topo_sharding="replicated", dtype=None,
                       depth=0, controller=True, store=None, rep_rows=15, alpha=ALPHA,
                       optimizer="adam", dropout=0.5, draw_fn=None, auto_alpha=True):
    """A trainer over ``mesh`` with the tuners on: ``auto_alpha`` from
    ``alpha``, a ``CacheController(heat_bins=16, repin_min_gain=0)``
    (``controller=True``; a controller object, or None) and an
    ``auto_split`` store re-split to ``rep_rows`` L0 rows (the tuner may
    grow it back to 30). GraphSAGE 16 x 2 over the planted graph;
    ``init(0)``."""
    ei, feat, _ = GRAPH
    topo = qt.CSRTopo(edge_index=ei)
    feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=alpha, dtype=dtype,
                                **(tuned_store(dtype) if store is None else store)
                                ).from_cpu_tensor(feat)
    if topo_sharding == "mesh":
        sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                      topo_sharding="mesh", mesh=mesh, routed_alpha=alpha)
    else:
        sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=LOCAL,
                                      seed=9)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=dropout)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    if controller is True:
        controller = CacheController(heat_bins=HEAT_BINS, repin_min_gain=0.0)
    trainer = DistributedTrainer(
        mesh, sampler, feature, model, opt, local_batch=LOCAL, seed_sharding=seed_sharding,
        routed_alpha=alpha, pipeline_depth=depth, auto_alpha=auto_alpha, controller=controller,
        replicate_budget=None if rep_rows is None else rep_rows * row_bytes(dtype))
    trainer.init(0)
    trainer.draw_fn = draw_fn
    return trainer


def decisions(trainer):
    """What the tuners decided and saw so far: alpha, the split, the order,
    the store's version, the controller's decision list and its sketch."""
    ctl = trainer.controller
    sketch = ctl.sketch
    return {"alpha": trainer.routed_alpha, "rep_rows": trainer.feature.rep_rows,
            "order": trainer.feature.feature_order,
            "topo_order": trainer.sampler.csr_topo.feature_order,
            "version": trainer.feature.version, "decisions": list(ctl.decisions),
            "hitters": None if sketch is None else dict(sketch.state()["hitters"]),
            "heat": None if sketch is None else sketch.heat.copy()}


def step_metrics(trainer):
    return {"hits": trainer.last_tier_hits, "overflow": trainer.last_routed_overflow,
            "sample_overflow": trainer.last_sample_overflow,
            "heat": trainer.metrics.value(FEATURE_ROW_HEAT)}


def controlled_record(trainer):
    """3 steps, a 3-step ``epoch_scan`` (whose ``end_epoch`` may repin),
    then one step more: the losses, every step's metrics and the tuners'
    state after each part, and the parameters."""
    rng = np.random.default_rng(3)
    steps = []
    for t in range(3):
        loss = trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 5 + t)
        steps.append(_clone({"loss": loss, **step_metrics(trainer), **decisions(trainer)}))
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, N, 3 * trainer.global_batch),
                             seed=2)
    losses = trainer.epoch_scan(mat, labels(), 11)
    epoch = _clone({"losses": losses, **step_metrics(trainer), **decisions(trainer)})
    loss = trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 20)
    after = _clone({"loss": loss, **step_metrics(trainer), **decisions(trainer),
                    "params": dict(trainer.model.state_dict())})
    return {"steps": steps, "epoch": epoch, "after": after}


# -- (i) + (ii): the controller and auto_alpha under the trainer ------------------------


def case_train(run, data, feature):
    for name, (seed_sharding, topo_sharding, dtype) in CONFIGS.items():
        for depth in (0, 1):
            case = f"train{data}{feature}_{name}_{depth}"
            kw = {"seed_sharding": seed_sharding, "topo_sharding": topo_sharding,
                  "dtype": dtype, "depth": depth}
            run.put(case, "res", controlled_record(controlled_trainer(
                qt.make_mesh(data=data, feature=feature), **kw)))
            if run.ref:
                run.put_ref(case, "res", 0, controlled_record(controlled_trainer(
                    logical(data, feature), **kw)))


def frozen_record(trainer):
    rng = np.random.default_rng(4)
    losses = [trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 30 + t)
              for t in range(2)]
    mat = trainer.pack_epoch(np.random.default_rng(6).integers(0, N, 2 * trainer.global_batch),
                             seed=3)
    losses.append(trainer.epoch_scan(mat, labels(), 13))
    return _clone({"losses": losses, "params": dict(trainer.model.state_dict()),
                   "hits": trainer.last_tier_hits, "overflow": trainer.last_routed_overflow,
                   "alpha": trainer.routed_alpha, "version": trainer.feature.version})


def case_frozen(run, data, feature):
    """A frozen controller against none on the world (``auto_alpha`` off,
    a store without the split tuner): the same trajectory; and the frozen
    one against the logical frozen one, with what its sketch saw."""
    kw = {"store": STORES[None], "rep_rows": None, "auto_alpha": False}

    def make(mesh, ctl):
        return controlled_trainer(mesh, controller=ctl, **kw)

    mesh = qt.make_mesh(data=data, feature=feature)
    frozen = make(mesh, CacheController(frozen=True, heat_bins=HEAT_BINS))
    run.put("frozen", "frozen", frozen_record(frozen))
    run.put("frozen", "sketch", _clone(decisions(frozen)))
    run.put("frozen", "none", frozen_record(make(mesh, None)))
    if run.ref:
        ref = make(logical(data, feature), CacheController(frozen=True, heat_bins=HEAT_BINS))
        run.put_ref("frozen", "frozen", 0, frozen_record(ref))
        run.put_ref("frozen", "sketch", 0, _clone(decisions(ref)))


# -- (iii) a standalone world store --------------------------------------------------------

# f32 and int8 with the split tuner (their host copy of the device region),
# and an L1 + cold f32 store whose device region is gathered over the group
STANDALONE = {"f32": (None, tuned_store(None)), "int8": ("int8", tuned_store("int8")),
              "l1": (None, {"device_cache_size": STORES[None]["device_cache_size"]})}
ALL_IDS = torch.arange(-1, N)


def inverse(store):
    order = store.feature_order.numpy().astype(np.int64)
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N)
    return inv


def store_state(store):
    """Every row by the psum and the routed gather (all ids and -1), the
    tiers and the order."""
    rows = store.gather(ALL_IDS)
    hits = store.last_tier_hits
    return _clone({"rows": rows, "hits": hits, "routed": store.gather(ALL_IDS, routed=True),
                   "split": (store.rep_rows, store.hot_rows), "version": store.version,
                   "order": store.feature_order, "topo_order": store.csr_topo.feature_order,
                   "scale": store.scale})


def attempt(fn):
    try:
        fn()
        return "no raise"
    except ValueError as e:
        return str(e)


def store_record(mesh, dtype, cfg):
    """``repin``, row updates touching L0, every L1 shard and the cold rows,
    the two rejections, and the state after each."""
    ei, feat, _ = GRAPH
    store = qt.ShardedFeature(mesh, csr_topo=qt.CSRTopo(edge_index=ei), routed_alpha=ALPHA,
                              dtype=dtype, **cfg).from_cpu_tensor(feat)
    out = {"placed": store_state(store)}
    store.repin(np.random.default_rng(12).permutation(N)[:50])
    out["repinned"] = store_state(store)
    inv = inverse(store)
    rps = store.hot.rows_per_shard
    F = store.hot.num_shards
    end = store.rep_rows + store.hot_rows
    touched = [store.rep_rows + d * rps + 1 for d in range(F)] + [end + 2]
    if store.rep_rows:
        touched.insert(0, 1)
    ids = inv[touched]
    rows = np.random.default_rng(13).normal(size=(len(ids), 4)).astype(np.float32)
    store.apply_row_updates(ids, rows)
    out["updated"] = store_state(store)
    out["touched"] = (ids, rows)
    bad = rows.copy()
    bad[0, 1] = np.nan
    out["rejected"] = [attempt(lambda: store.apply_row_updates(ids[[0, 0]], rows[[0, 1]])),
                       attempt(lambda: store.apply_row_updates(ids, bad))]
    out["after_rejections"] = store_state(store)
    return out


def split_record(mesh, dtype):
    """The split tuner of a fresh ``auto_split`` store on a gather sequence:
    mostly L1 hits (it halves the 30-row L0), then twice a mix whose hit
    mass sits past the boundary (the reversal, confirmed on the second
    sighting, doubles it back to 30); each call's split and hits."""
    ei, feat, _ = GRAPH
    store = qt.ShardedFeature(mesh, csr_topo=qt.CSRTopo(edge_index=ei), routed_alpha=ALPHA,
                              dtype=dtype, **tuned_store(dtype)).from_cpu_tensor(feat)
    inv = inverse(store)
    l1_heavy = inv[np.r_[0:2, 30:90]]
    past = inv[np.r_[0:15, 30:50]]
    seq = []
    for ids in (l1_heavy, past, past, past, past):
        rows = store.gather(torch.from_numpy(ids))
        seq.append(_clone({"rows": rows, "split": (store.rep_rows, store.hot_rows),
                           "hits": store.last_tier_hits}))
    return seq


def case_store(run, data, feature):
    for name, (dtype, cfg) in STANDALONE.items():
        case = f"store{data}{feature}_{name}"
        run.put(case, "res", store_record(qt.make_mesh(data=data, feature=feature), dtype, cfg))
        if run.ref:
            run.put_ref(case, "res", 0, store_record(logical(data, feature), dtype, cfg))
    for dtype in (None, "int8"):
        case = f"split{data}{feature}_{dtype or 'f32'}"
        run.put(case, "seq", split_record(qt.make_mesh(data=data, feature=feature), dtype))
        if run.ref:
            run.put_ref(case, "seq", 0, split_record(logical(data, feature), dtype))


# -- (iv) a streaming commit with row updates into a world store ---------------------------


def stream_record(mesh, fail_rank, rank):
    """The slice's topology-sharded trainer with the tuners on: a step, a
    commit of edge inserts and row updates touching every tier, the
    trainer's ``refresh`` and the next step; then a commit whose
    ``inject_failure`` fires on rank ``fail_rank`` alone (None: on every
    caller), which every rank aborts, and the state after it."""
    trainer = controlled_trainer(mesh, topo_sharding="mesh", dtype="int8")
    store = trainer.feature
    graph = StreamingGraph(trainer.sampler.csr_topo, feature=store)
    rng = np.random.default_rng(40)
    trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 3)
    inv = inverse(store)
    end = store.rep_rows + store.hot_rows
    touched = [0, store.rep_rows] + [store.rep_rows + d * store.hot.rows_per_shard + 3
                                     for d in range(store.hot.num_shards)] + [end, N - 1]
    ids = inv[touched]
    rows = np.random.default_rng(41).normal(size=(len(ids), 4)).astype(np.float32)
    assert graph.ingest(DeltaBatch(edge_inserts=rng.integers(0, N, (2, 64)),
                                   update_ids=ids, update_rows=rows))
    result = graph.commit()
    out = {"result": (result.version, result.rows_updated, result.edges_inserted),
           "touched": (ids, rows), "stale": attempt_stale(trainer, rng)}
    trainer.refresh()
    out["store"] = store_state(store)
    loss = trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 4)
    out["next"] = _clone({"loss": loss, **step_metrics(trainer), **decisions(trainer),
                          "params": dict(trainer.model.state_dict())})
    before = store_state(store)
    indptr = trainer.sampler.csr_topo.indptr.copy()
    assert graph.ingest(DeltaBatch(edge_inserts=rng.integers(0, N, (2, 16)),
                                   update_ids=ids[:2], update_rows=rows[:2] + 1.0))
    fail = "features" if fail_rank is None or fail_rank == rank else None
    try:
        graph.commit(inject_failure=fail)
        out["aborted"] = "no raise"
    except CommitAborted as e:
        out["aborted"] = str(e)
    after = store_state(store)
    topo = trainer.sampler.csr_topo
    out["intact"] = (before, after, bool(np.array_equal(indptr, topo.indptr)), topo.version,
                     len(graph.quarantined))
    # an error of another kind (a RuntimeError in the merge) on the same
    # rank(s), then an injected abort of a topology-only commit with no
    # store attached: the CSR's shards alone name the world
    failing = fail_rank is None or fail_rank == rank
    assert graph.ingest(DeltaBatch(edge_inserts=rng.integers(0, N, (2, 16))))
    out["crash"] = commit_said(graph, crash=failing)
    bare = StreamingGraph(topo)
    assert bare.ingest(DeltaBatch(edge_inserts=rng.integers(0, N, (2, 16))))
    out["bare"] = commit_said(bare, inject="merge" if failing else None)
    out["intact_after_crash"] = (
        after, store_state(store), bool(np.array_equal(indptr, topo.indptr)), topo.version,
        len(bare.staged), len(bare.quarantined))
    out["staged_after_crash"] = (len(graph.staged), len(graph.quarantined))
    assert bare.ingest(DeltaBatch(edge_inserts=rng.integers(0, N, (2, 16))))
    out["bare_published"] = (bare.commit().version, topo.indptr.copy(), topo.indices.copy())
    return out


def commit_said(graph, inject=None, crash=False):
    """What ``graph.commit(inject_failure=inject)`` raised (its type and
    text; ``"no raise"``), with ``merge_csr`` failing by a ``RuntimeError``
    under ``crash``."""
    from quiver_tpu_torch.streaming import commit as commit_mod

    merge = commit_mod.merge_csr

    def out_of_memory(*args, **kwargs):
        raise RuntimeError("merge_csr ran out of memory")

    if crash:
        commit_mod.merge_csr = out_of_memory
    try:
        graph.commit(inject_failure=inject)
        return "no raise"
    except Exception as e:  # the error is the record
        return f"{type(e).__name__}: {e}"
    finally:
        commit_mod.merge_csr = merge


def attempt_stale(trainer, rng):
    """The step before ``refresh`` raises ``VersionMismatchError``."""
    try:
        trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 99)
        return "no raise"
    except qt.VersionMismatchError as e:
        return type(e).__name__


def case_stream(run, data, feature):
    run.put("stream", "res", stream_record(qt.make_mesh(data=data, feature=feature), 1,
                                           run.rank))
    if run.ref:
        run.put_ref("stream", "res", 0, stream_record(logical(data, feature), None, 0))


# -- (v) the audit's collective list ----------------------------------------------------


def audit_collectives(mesh):
    """The collectives the program audit records for one controlled step
    (the heat feed on) of the routed trainer."""
    from quiver_tpu_torch.tools.audit import ir

    trainer = controlled_trainer(mesh, store=STORES[None], rep_rows=None)
    packed = torch.from_numpy(trainer.shard_seeds(np.arange(trainer.global_batch) % N))
    program = ir.record(lambda p, lab: trainer._run_step(p, lab, 1, False), packed, labels())
    return [c.signature() for c in ir.collectives_of(program)]


def case_audit(run, data, feature):
    run.put("audit", "ctl", audit_collectives(qt.make_mesh(data=data, feature=feature)))
    if run.ref:
        run.put_ref("audit", "ctl", 0, audit_collectives(logical(data, feature)))


# -- against the JAX package's trainer --------------------------------------------------------


def jax_trainer(mesh, draw_fn=None):
    """The (2, 2) run held against JAX's: SGD 0.1, dropout 0, the replicated
    sampler, ``auto_alpha`` from 0.05, a controller with the heat feed and
    an f32 ``auto_split`` store re-split to 15 L0 rows."""
    return controlled_trainer(mesh, controller=CacheController(heat_bins=HEAT_BINS),
                              optimizer="sgd", dropout=0.0, draw_fn=draw_fn)


def jax_steps(trainer, seeds):
    out = []
    for t, s in enumerate(seeds):
        loss = trainer.step(s, labels(), 5 + t)
        out.append(_clone({"loss": loss, **step_metrics(trainer), **decisions(trainer)}))
    return out


def case_jax(run, draws_file):
    while not os.path.exists(draws_file):
        time.sleep(0.05)
    got = torch.load(draws_file)
    draws = got["draws"]
    trainer = jax_trainer(qt.make_mesh(data=2, feature=2),
                          lambda key, w, layer, deg: draws[f"{key}:{w}:{layer}"])
    trainer.model.load_state_dict(got["params0"])
    run.put("jax", "steps", jax_steps(trainer, list(got["seeds"].numpy())))


def main():
    rank, size, store, out_dir, cases = sys.argv[1:6]
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", size, rank, device="cpu")
    run = Run(rank, size)
    try:
        for case in cases.split(","):
            name, _, arg = case.partition(":")
            if name in ("train", "frozen", "store", "stream", "audit"):
                globals()[f"case_{name}"](run, int(arg[0]), int(arg[1]))
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
