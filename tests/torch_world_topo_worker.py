"""One rank of a world of ``gloo`` CPU processes, for tests/test_torch_world_topo.py.

    python tests/torch_world_topo_worker.py RANK WORLD_SIZE STORE_FILE OUT_DIR CASES

as ``tests/torch_world_worker.py`` (whose helpers it shares): it joins the
world through a file store, runs the comma-separated CASES on world meshes
and, on rank 0, the same calls on logical meshes of the same shapes, then
writes ``OUT_DIR/rank<RANK>.pt``: a world result under ``"<case>/<name>"``
and rank 0's logical reference for worker ``w`` under
``"ref/<case>/<name>/<w>"``. The cases cover the topology-sharded samplers
(also under ``dedup="map"``), the trainer over them, rank-0 checkpoints and
the elastic resume.

Every process runs at one thread, the logical reference too. It imports
neither JAX nor the JAX package.
"""

import os
import sys
import traceback

import numpy as np
import torch

# first: it puts the repository's root on sys.path
from torch_world_worker import BOTH, GRAPH, LOCAL, SIZES, STORES, Run, _clone, logical

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.core.hetero_sharded import HeteroShardedTopology  # noqa: E402
from quiver_tpu_torch.core.sharded_topology import ShardedTopology  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED  # noqa: E402
from quiver_tpu_torch.ops.sample import fold_key  # noqa: E402
from quiver_tpu_torch.parallel import world  # noqa: E402
from quiver_tpu_torch.parallel.mesh import (FEATURE_AXIS, axis_groups,  # noqa: E402
                                            init_distributed, shutdown_distributed)
from quiver_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: E402
from quiver_tpu_torch.resilience import FaultPlan, Preemption  # noqa: E402
from quiver_tpu_torch.resilience.elastic import worker_ordered_mean  # noqa: E402
from quiver_tpu_torch.resilience.integrity import ARRAYS_NAME  # noqa: E402

N = 300  # the planted graph's nodes
ALPHA = 0.05  # tight enough that the hops' and the lookups' buckets overflow
SAMPLE_SEEDS = np.random.default_rng(21).integers(0, N, 150)
KINDS = {"uniform": {}, "weighted": {"weighted": True},
         "temporal": {"time_window": (0.25, 0.75)}}
CAPS = {"capped": {"routed_alpha": ALPHA}, "uncapped": {"routed_alpha": None},
        "auto": {"frontier_caps": "auto"}}
CITES, WRITES, EMPLOYS = (("paper", "cites", "paper"), ("author", "writes", "paper"),
                          ("inst", "employs", "author"))
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_PREEMPT = 9, 3, 3
ELASTIC_WORKERS = 4


def topo_of(kind: str):
    """The planted graph's CSR, with ``exp(N(0, 1))`` weights (weighted)
    or uniform timestamps (temporal) attached in COO order."""
    ei = GRAPH[0]
    rng = np.random.default_rng(4)
    if kind == "weighted":
        return qt.CSRTopo(edge_index=ei, edge_weight=np.exp(rng.normal(
            size=ei.shape[1])).astype(np.float32))
    topo = qt.CSRTopo(edge_index=ei)
    if kind == "temporal":
        topo.set_edge_time(rng.random(ei.shape[1]).astype(np.float32))
    return topo


def hetero_topo(weighted: bool):
    """``tests/test_torch_hetero.py``'s toy schema (120 papers, 60 authors,
    20 institutions), weighted relations ``exp(N(0, 1))``."""
    rng = np.random.default_rng(0)
    edges = {
        CITES: np.stack([rng.integers(0, 120, 400), rng.integers(0, 120, 400)]),
        WRITES: np.stack([rng.integers(0, 60, 300), rng.integers(0, 120, 300)]),
        EMPLOYS: np.stack([rng.integers(0, 20, 100), rng.integers(0, 60, 100)]),
    }
    topo = qt.HeteroCSRTopo({"paper": 120, "author": 60, "inst": 20}, edges)
    if weighted:
        wrng = np.random.default_rng(5)
        for et in edges:
            topo.set_edge_weight(et, np.exp(wrng.normal(size=edges[et].shape[1]))
                                 .astype(np.float32))
    return topo


# -- (i) the topology shards ------------------------------------------------------------


def shard_tensors(part, i):
    return [t[i] for t in (part.indptr, part.indices, part.cum_weights, part.edge_time)
            if t is not None]


def case_topo(run, data, feature):
    """Each rank's shard of the plain CSR (weights and times attached) and
    of the typed one, its geometry and its bytes."""
    case = f"topo{data}{feature}"
    topo = topo_of("weighted")
    topo.set_edge_time(np.random.default_rng(6).random(topo.edge_count).astype(np.float32))
    htopo = hetero_topo(True)

    def record(mesh, i):
        part = ShardedTopology(mesh, topo, with_weights=True, with_times=True)
        typed = HeteroShardedTopology(mesh, htopo, weighted_rels=[CITES, WRITES])
        return {"shard": shard_tensors(part, i), "plan": part.plan,
                "rows_per_shard": part.rows_per_shard,
                "typed": {et: shard_tensors(r, i) for et, r in typed.rels.items()},
                "typed_plan": typed.plan,
                "bytes": (part.held_bytes, typed.held_bytes)}

    mesh = qt.make_mesh(data=data, feature=feature)
    out = record(mesh, 0)
    out["member"] = ShardedTopology(mesh, topo).member
    run.put(case, "out", out)
    if run.ref:
        for d in range(feature):
            run.put_ref(case, "out", d, record(logical(data, feature), d))


# -- (ii) DistGraphSageSampler ---------------------------------------------------------------


def sample_record(out):
    return {"n_id": out.n_id, "edges": [a.edge_index for a in out.adjs],
            "sizes": [a.size for a in out.adjs], "n_count": out.n_count,
            "overflow": out.overflow, "edge_counts": out.edge_counts,
            "frontier_counts": out.frontier_counts, "batch": out.batch_size}


def sampler_calls(sampler, workers):
    """``sample`` (keyed 11), ``sample_per_worker`` (keyed 12) and the
    padded entry of each of ``workers`` (a generator seeded
    ``fold_key(13, w)``): ``sample_padded`` on a world mesh, the group's
    ``sample_group`` row on a logical one."""
    out = {"sample": sample_record(sampler.sample(SAMPLE_SEEDS, key=11)),
           "hop_overflow": sampler.last_sample_overflow.clone(),
           "caps": sampler._frontier_caps}
    per = sampler.sample_per_worker(SAMPLE_SEEDS, key=12)
    cap = int(out["sample"]["batch"])
    packed = torch.from_numpy(sampler.shard_seeds(SAMPLE_SEEDS, cap))
    num = (packed >= 0).sum(1, dtype=torch.int32)
    padded = {}
    if len(workers) == 1:
        (w,) = workers
        n_id, n_count, adjs, ovf, ecs, fcs = sampler.sample_padded(
            packed[w], num[w], generator=torch.Generator().manual_seed(fold_key(13, w)))
        padded[w] = (n_id, n_count, [a.edge_index for a in adjs], ovf, ecs, fcs)
        per = {w: per[0]}
    else:
        for members in axis_groups(sampler.mesh, FEATURE_AXIS):
            idx = torch.tensor(members)
            res = sampler.sample_group(packed[idx], num[idx], generators=[
                torch.Generator().manual_seed(fold_key(13, w)) for w in members])
            n_id, n_count, adjs, ovf, ecs, fcs, _ = res
            for i, w in enumerate(members):
                padded[w] = (n_id[i], n_count[i], [a.edge_index[i] for a in adjs], ovf[i],
                             tuple(c[i] for c in ecs), tuple(c[i] for c in fcs))
        per = dict(enumerate(per))
    return _clone(out), {w: (_clone([per[w].n_id] + [a.edge_index for a in per[w].adjs]),
                             _clone(padded[w])) for w in workers}


def case_sampler(run, data, feature):
    for kind, kw in KINDS.items():
        topo = topo_of(kind)
        for caps, ckw in CAPS.items():
            case = f"sampler{data}{feature}_{kind}_{caps}"

            def make(mesh):
                return qt.GraphSageSampler(topo, list(SIZES), topo_sharding="mesh", mesh=mesh,
                                           seed=3, **kw, **ckw)

            out, mine = sampler_calls(make(qt.make_mesh(data=data, feature=feature)),
                                      [run.rank])
            run.put(case, "out", out)
            run.put(case, "worker", mine[run.rank])
            if run.ref:
                out, every = sampler_calls(make(logical(data, feature)),
                                           list(range(data * feature)))
                run.put_ref(case, "out", 0, out)
                for w, v in every.items():
                    run.put_ref(case, "worker", w, v)


# -- (iii) DistHeteroSampler -------------------------------------------------------------------


def hetero_calls(sampler, rank):
    seeds = np.arange(48)
    out = sampler.sample(seeds, key=7)
    res = {"n_id": out.n_id, "edges": [{et: a.edge_index for et, a in layer.adjs.items()}
                                       for layer in out.adjs],
           "overflow": out.overflow, "frontier_counts": out.frontier_counts,
           "by_rel": sampler.last_sample_overflow_by_rel}
    per = sampler.sample_per_worker(seeds, key=8)
    own = per[0] if rank is not None else None
    return _clone(res), _clone(own.n_id if own is not None else [p.n_id for p in per])


def case_hetero(run, data, feature):
    for weighted in (False, True):
        case = f"hetero{data}{feature}_{'weighted' if weighted else 'uniform'}"

        def make(mesh):
            return qt.DistHeteroSampler(hetero_topo(weighted), [3, 2], "paper", mesh=mesh,
                                        routed_alpha=0.25, weighted=weighted, seed=0)

        out, own = hetero_calls(make(qt.make_mesh(data=data, feature=feature)), run.rank)
        run.put(case, "out", out)
        run.put(case, "own", own)
        if run.ref:
            out, every = hetero_calls(make(logical(data, feature)), None)
            run.put_ref(case, "out", 0, out)
            for w, v in enumerate(every):
                run.put_ref(case, "own", w, v)


def case_dedup(run, data, feature):
    """The topology-sharded sampler (uniform and weighted, capped buckets)
    and the typed one with ``dedup="map"``, each rank's against the logical
    mesh's; rank 0 also records the logical mesh under ``dedup="sort"``."""
    for kind in ("uniform", "weighted"):
        topo = topo_of(kind)
        case = f"dedup{data}{feature}_{kind}"

        def make(mesh, dedup="map"):
            return qt.GraphSageSampler(topo, list(SIZES), topo_sharding="mesh", mesh=mesh,
                                       seed=3, routed_alpha=ALPHA, dedup=dedup, **KINDS[kind])

        out, mine = sampler_calls(make(qt.make_mesh(data=data, feature=feature)), [run.rank])
        run.put(case, "out", out)
        run.put(case, "worker", mine[run.rank])
        if run.ref:
            workers = list(range(data * feature))
            for dedup in ("map", "sort"):
                out, every = sampler_calls(make(logical(data, feature), dedup), workers)
                run.put_ref(case, f"out_{dedup}", 0, out)
                for w, v in every.items():
                    run.put_ref(case, f"worker_{dedup}", w, v)

    def make_typed(mesh, dedup="map"):
        return qt.DistHeteroSampler(hetero_topo(False), [3, 2], "paper", mesh=mesh,
                                    routed_alpha=0.25, seed=0, dedup=dedup)

    case = f"dedup{data}{feature}_hetero"
    out, own = hetero_calls(make_typed(qt.make_mesh(data=data, feature=feature)), run.rank)
    run.put(case, "out", out)
    run.put(case, "own", own)
    if run.ref:
        for dedup in ("map", "sort"):
            out, every = hetero_calls(make_typed(logical(data, feature), dedup), None)
            run.put_ref(case, f"out_{dedup}", 0, out)
            for w, v in enumerate(every):
                run.put_ref(case, f"own_{dedup}", w, v)


# -- (iv) DistributedTrainer over a topology-sharded sampler ------------------------------------


def topo_trainer(mesh, depth=0, store=None, optimizer="adam", dropout=0.5, alpha=ALPHA,
                 **kw):
    """The slice's trainer: a topology-sharded sampler (seed 9, the
    planted graph's worst-case caps at ``LOCAL``) and a three-tier
    ``ShardedFeature`` over ``mesh``, ``seed_sharding="all"``, GraphSAGE 16
    x 2; ``init(0)``."""
    ei, feat, _ = GRAPH
    topo = qt.CSRTopo(edge_index=ei)
    feature = qt.ShardedFeature(mesh, csr_topo=topo, routed_alpha=alpha,
                                **(STORES[None] if store is None else store)).from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, list(SIZES), seed_capacity=LOCAL, seed=9,
                                  topo_sharding="mesh", mesh=mesh, routed_alpha=alpha)
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=dropout)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=5e-3))
    trainer = DistributedTrainer(mesh, sampler, feature, model, opt, local_batch=LOCAL,
                                 seed_sharding="all", routed_alpha=alpha,
                                 pipeline_depth=depth, **kw)
    trainer.init(0)
    return trainer


def labels():
    return torch.from_numpy(GRAPH[2].astype(np.int32))


def topo_record(trainer):
    """3 steps (the guard skips step 1, whose rows the plan poisons), then a
    3-step ``epoch_scan``: each step's ids, rows and edge lists of the
    workers held, the losses, every metric and the parameters after each
    part."""
    issued = []
    issue = trainer._issue
    trainer._issue = lambda *a: issued.append(issue(*a)) or issued[-1]
    rng = np.random.default_rng(3)
    steps = []
    for t in range(3):
        loss = trainer.step(rng.integers(0, N, trainer.global_batch), labels(), 5 + t)
        steps.append({"loss": loss, "hits": trainer.last_tier_hits,
                      "overflow": trainer.last_routed_overflow,
                      "sample_overflow": trainer.last_sample_overflow,
                      "skipped": trainer.metrics.value(GUARD_SKIPPED),
                      "nonfinite": trainer.metrics.value(GUARD_NONFINITE)})
        steps[-1] = _clone(steps[-1])
    params = _clone(dict(trainer.model.state_dict()))
    mat = trainer.pack_epoch(np.random.default_rng(1).integers(0, N, 3 * trainer.global_batch),
                             seed=2)
    losses = trainer.epoch_scan(mat, labels(), 11)
    epoch = {"losses": losses, "hits": trainer.last_tier_hits,
             "overflow": trainer.last_routed_overflow,
             "sample_overflow": trainer.last_sample_overflow,
             "skipped": trainer.metrics.value(GUARD_SKIPPED)}
    blocks = {w: [(b.n_id, b.x, [a.edge_index for a in b.adjs])
                  for b in (s.blocks[i] for s in issued)]
              for i, w in enumerate(trainer._held)}
    return _clone({"steps": steps, "params": params, "epoch": epoch,
                   "epoch_params": dict(trainer.model.state_dict())}), _clone(blocks)


def case_trainer(run, data, feature):
    plan = FaultPlan(nan_feature_steps=(1,))
    for depth in (0, 1):
        case = f"trainer{data}{feature}_{depth}"
        trainer = topo_trainer(qt.make_mesh(data=data, feature=feature), depth,
                               nonfinite_guard=True, fault_plan=plan)
        res, blocks = topo_record(trainer)
        (w, b), = blocks.items()
        run.put(case, "res", res)
        run.put(case, "worker", w)
        run.put(case, "blocks", b)
        run.put(case, "held_bytes", trainer.sampler.topo.held_bytes)
        if run.ref:
            ref = topo_trainer(logical(data, feature), depth, nonfinite_guard=True,
                               fault_plan=plan)
            res, blocks = topo_record(ref)
            run.put_ref(case, "res", 0, res)
            run.put_ref(case, "held_bytes", 0, ref.sampler.topo.held_bytes)
            for w, b in blocks.items():
                run.put_ref(case, "blocks", w, b)


def audit_collectives(mesh):
    """The collective list the program audit records for one step of the
    topology-sharded trainer (one rank's, or the logical step's)."""
    from quiver_tpu_torch.tools.audit import ir

    trainer = topo_trainer(mesh, nonfinite_guard=True)
    packed = torch.from_numpy(trainer.shard_seeds(np.arange(trainer.global_batch) % N))
    program = ir.record(lambda p, lab: trainer._run_step(p, lab, 1, False), packed, labels())
    return [c.signature() for c in ir.collectives_of(program)]


def case_audit(run, data, feature):
    run.put("audit", "topo", audit_collectives(qt.make_mesh(data=data, feature=feature)))
    if run.ref:
        run.put_ref("audit", "topo", 0, audit_collectives(logical(data, feature)))


def stream_sample(sampler):
    out = sampler.sample(SAMPLE_SEEDS, key=11)
    return _clone({"n_id": out.n_id, "edges": [a.edge_index for a in out.adjs]})


def case_stream(run, data, feature):
    """A ``StreamingGraph`` over a world store: a commit of row updates
    publishes into the rank's parts of the store (its rows, version and
    result against the logical store's); then a topology-only commit runs,
    and the topology-sharded sampler's ``refresh_topology`` re-places the
    rank's shard (its samples against the logical sampler's over the same
    mutated CSR)."""
    from quiver_tpu_torch.streaming import DeltaBatch, StreamingGraph

    ei, feat, _ = GRAPH
    inserts = np.random.default_rng(40).integers(0, N, (2, 64))
    update_ids = np.array([0, 7, 150, 299])
    update_rows = np.random.default_rng(41).normal(size=(4, 4)).astype(np.float32)

    def committed(mesh):
        topo = qt.CSRTopo(edge_index=ei)
        store = qt.ShardedFeature(mesh, csr_topo=topo, **STORES[None]).from_cpu_tensor(feat)
        sampler = qt.GraphSageSampler(topo, list(SIZES), topo_sharding="mesh", mesh=mesh,
                                      seed=3)
        graph = StreamingGraph(topo, feature=store)
        before = stream_sample(sampler)
        assert graph.ingest(DeltaBatch(update_ids=update_ids, update_rows=update_rows))
        result = graph.commit()
        updates = _clone({"rows": store.gather(torch.arange(N)),
                          "routed": store.gather(torch.arange(N), routed=True),
                          "result": (result.rows_updated, result.version),
                          "versions": (topo.version, store.version)})
        assert graph.ingest(DeltaBatch(edge_inserts=inserts))
        graph.commit()
        sampler.refresh_topology()
        return updates, (before, stream_sample(sampler))

    updates, samples = committed(qt.make_mesh(data=data, feature=feature))
    run.put("stream", "updates", updates)
    run.put("stream", "samples", samples)
    if run.ref:
        updates, samples = committed(logical(data, feature))
        run.put_ref("stream", "updates", 0, updates)
        run.put_ref("stream", "samples", 0, samples)


# -- (v) checkpoints -------------------------------------------------------------------------------


def ckpt_epoch(trainer, steps=3):
    mat = trainer.pack_epoch(np.random.default_rng(8).integers(0, N, steps * trainer.global_batch),
                             seed=4)
    return trainer.epoch_scan(mat, labels(), 17)


def restored(trainer):
    model, opt, key, step, epoch = trainer.resume()
    return _clone({"key": key, "step": step, "epoch": epoch,
                   "params": dict(model.state_dict())})


def case_ckpt(run, out_dir, data, feature):
    """Rank 0 alone writes a 3-checkpoint epoch; its corrupt newest one is
    quarantined once and every rank restores the older one; a logical
    trainer restores the world's checkpoint, and a world trainer a logical
    one."""
    mesh = qt.make_mesh(data=data, feature=feature)
    wdir = os.path.join(out_dir, "ckpt_world")
    trainer = topo_trainer(mesh, checkpoint_dir=wdir, checkpoint_every=1)
    ckpt_epoch(trainer)
    if run.ref:
        trainer.checkpointer.wait_until_finished()
    world.barrier(mesh)
    run.put("ckpt", "writer", (trainer.checkpointer.read_only, trainer._ckpt_seq))
    if run.ref:
        run.put("ckpt", "written", sorted(os.listdir(wdir)))
        with open(os.path.join(wdir, "step-2", ARRAYS_NAME), "r+b") as fh:
            byte = fh.read(1)
            fh.seek(0)
            fh.write(bytes([byte[0] ^ 0xFF]))
    world.barrier(mesh)
    run.put("ckpt", "restored", restored(trainer))
    world.barrier(mesh)
    if run.ref:
        run.put("ckpt", "after", sorted(os.listdir(wdir)))
        ref = topo_trainer(logical(data, feature), checkpoint_dir=wdir, checkpoint_every=1)
        run.put_ref("ckpt", "restored", 0, restored(ref))
        ldir = os.path.join(out_dir, "ckpt_logical")
        src = topo_trainer(logical(data, feature), checkpoint_dir=ldir, checkpoint_every=1)
        ckpt_epoch(src)
        src.checkpointer.wait_until_finished()
        run.put_ref("ckpt", "logical_params", 0, _clone(dict(src.model.state_dict())))
    world.barrier(mesh)
    fresh = topo_trainer(mesh, checkpoint_dir=os.path.join(out_dir, "ckpt_logical"),
                         checkpoint_every=1)
    run.put("ckpt", "from_logical", restored(fresh))
    missing = os.path.join(out_dir, f"ckpt_rank{run.rank}")
    try:
        topo_trainer(mesh, checkpoint_dir=missing, checkpoint_every=1)
        run.put("ckpt", "blind", "no raise")
    except FileNotFoundError as e:
        run.put("ckpt", "blind", str(e))


# -- (vi) the elastic resume -----------------------------------------------------------------------


def elastic_trainer(mesh, ckpt=None, plan=None, store=None):
    kw = {"checkpoint_dir": ckpt, "checkpoint_every": ELASTIC_EVERY} if ckpt else {}
    return topo_trainer(mesh, store=store, logical_workers=ELASTIC_WORKERS, fault_plan=plan,
                        **kw)


def elastic_matrix(trainer):
    return trainer.pack_epoch(np.random.default_rng(9).integers(
        0, N, ELASTIC_STEPS * trainer.global_batch), seed=6)


def preempted(trainer):
    """The elastic epoch keyed 23, preempted after step ``ELASTIC_PREEMPT``'s
    chunk ran (its checkpoint at step 3 landed)."""
    try:
        trainer.epoch_scan(elastic_matrix(trainer), labels(), 23)
    except Preemption:
        return True
    return False


def resumed_tail(trainer, mesh=None):
    """``resume(mesh=)`` and the rest of the epoch: the losses and the
    parameters."""
    _, _, key, step, epoch = trainer.resume(mesh=mesh or trainer.mesh)
    losses = trainer.epoch_scan(elastic_matrix(trainer), labels(), key, epoch=epoch,
                                start_step=step)
    return _clone({"step": step, "losses": losses, "params": dict(trainer.model.state_dict())})


def case_elastic(run, out_dir):
    """A world of 4: the (1, 4) elastic run preempted at step 3 (the
    directory a world of 2 resumes), the in-place (2, 2) -> (1, 4) replan
    of a run preempted on (2, 2), ``worker_ordered_mean`` over the world,
    and (rank 0) the uninterrupted logical (1, 4) run."""
    plan = FaultPlan(preempt_at_step=ELASTIC_PREEMPT)
    mesh14 = qt.make_mesh(data=1, feature=4)
    run.put("elastic", "preempted14", preempted(
        elastic_trainer(mesh14, os.path.join(out_dir, "elastic14"), plan)))
    # L1 and cold tiers only: the replan gathers the L1 shards over the group
    store = {"device_cache_size": STORES[None]["device_cache_size"]}
    mesh22 = qt.make_mesh(data=2, feature=2)
    trainer = elastic_trainer(mesh22, os.path.join(out_dir, "elastic22"), plan, store)
    run.put("elastic", "preempted22", preempted(trainer))
    run.put("elastic", "replanned", resumed_tail(trainer, qt.make_mesh(data=1, feature=4)))
    run.put("elastic", "replanned_store", (trainer.feature.rep_rows, trainer.feature.hot_rows,
                                           trainer.blocks_per_device, list(trainer._held)))
    bpd = 2
    vals = torch.from_numpy(np.random.default_rng(30 + run.rank).normal(
        size=(bpd, 7)).astype(np.float32))
    run.put("elastic", "wom", worker_ordered_mean({"g": vals}, BOTH, bpd * run.size,
                                                  mesh=mesh14))
    if run.ref:
        every = torch.cat([torch.from_numpy(np.random.default_rng(30 + r).normal(
            size=(bpd, 7)).astype(np.float32)) for r in range(run.size)])
        run.put_ref("elastic", "wom", 0, worker_ordered_mean({"g": every}, None,
                                                             bpd * run.size))
        ref = elastic_trainer(logical(1, 4))
        losses = ref.epoch_scan(elastic_matrix(ref), labels(), 23)
        run.put_ref("elastic", "full", 0, _clone({"losses": losses,
                                                  "params": dict(ref.model.state_dict())}))


def case_resume(run, ckpt):
    """A fresh world (here of 2, on (1, 2)) resumes the world of 4's
    preempted elastic run from its directory."""
    trainer = elastic_trainer(qt.make_mesh(data=1, feature=run.size), ckpt)
    run.put("resume", "tail", resumed_tail(trainer))
    try:
        trainer.resume(mesh=logical(1, run.size))
        run.put("resume", "other_form", "no raise")
    except ValueError as e:
        run.put("resume", "other_form", str(e))


# -- (vii) one world step on the JAX package's draws -------------------------------------------------


def case_jax(run, draws_file):
    """One (2, 2) topology-sharded step, SGD 0.1, dropout 0, routed alpha
    0.25, from the JAX trainer's initial parameters, replaying its draws."""
    got = torch.load(draws_file)
    draws = got["draws"]
    trainer = topo_trainer(qt.make_mesh(data=2, feature=2), optimizer="sgd", dropout=0.0,
                           alpha=0.25)
    trainer.model.load_state_dict(got["params0"])
    trainer.draw_fn = lambda key, w, layer, deg: draws[f"{key}:{w}:{layer}"]
    loss = trainer.step(got["seeds"].numpy(), labels(), got["key"])
    run.put("jax", "res", _clone({"loss": loss, "hits": trainer.last_tier_hits,
                                  "overflow": trainer.last_routed_overflow,
                                  "sample_overflow": trainer.last_sample_overflow,
                                  "params": dict(trainer.model.state_dict())}))


def main():
    rank, size, store, out_dir, cases = sys.argv[1:6]
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", size, rank, device="cpu")
    run = Run(rank, size)
    try:
        for case in cases.split(","):
            name, _, arg = case.partition(":")
            if name in ("topo", "sampler", "hetero", "dedup", "trainer", "audit", "stream"):
                globals()[f"case_{name}"](run, int(arg[0]), int(arg[1]))
            elif name == "ckpt":
                case_ckpt(run, out_dir, int(arg[0]), int(arg[1]))
            elif name == "elastic":
                case_elastic(run, out_dir)
            elif name == "resume":
                case_resume(run, arg)
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
