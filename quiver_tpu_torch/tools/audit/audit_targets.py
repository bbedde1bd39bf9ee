"""The audit's registry: the canonical programs it records and walks.

The port of ``quiver_tpu/tools/audit/audit_targets.py``, under JAX's
target names, so ``--targets`` and ``--changed`` read the same. Each
:class:`Target` names one program the repo stakes an invariant on, a
builder that sets up its fixtures on a device and returns a :class:`Case`
(the callable, its inputs, and optionally a second input set and the
tensors it claims to write in place), the port files whose edits make it
worth auditing again (``--changed``), and per-rule metadata and waivers.

The fixtures are the JAX package's sizes: the 96-node trainer (``[3, 2]``
x 8, ``seed_sharding="all"``) on a logical ``(data=1, feature=2)`` mesh of
ONE device, the 240-node ladder, the 160-node fleet and the 64-row mmap
store. Stores and samplers ask for the kernels (``kernel="pallas"``), so a
CPU recording calls the same kernel wrappers, in the same order, as one on
the card. Each target's ``hbm_budget`` is the port's own: its CPU
estimate (``mem.estimate_peak``) with about 50% headroom, rounded up to
KiB; the JAX package's budgets do not carry over (the port's routed
fallback always runs, and a CPU recording prices the host tables too).

Builds are memoized per ``(target, device type)``: a full run records
each program once (twice with a second input set) and every rule walks
the shared :class:`Built`.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np

__all__ = ["Built", "Case", "PEAK_BAND", "REGISTRY", "Target", "build", "build_from",
           "clear_cache"]

# the estimate's growth, rounded to the allocator's 512 B blocks, against
# the card's measured growth (cuda_memory_stats): the estimate cannot see
# cub's scratch in a CUDA sort/unique/cumsum, cuBLAS's workspace or the
# wrappers' small argument tensors; on an H100 the registry's programs read
# 1.0, and 0.923 on the two serve forwards (one 512 B block the dispatcher
# never returned), so the band leaves a margin on both sides (chip_smoke
# phase 2c checks it)
PEAK_BAND = (0.8, 1.25)

_REGISTRY: dict = {}
_BUILT: dict = {}
_SHARED: dict = {}  # memoized fixtures (trainers, ladders), per device type
_TEMP_DIRS: list = []


@dataclasses.dataclass
class Case:
    """What a builder returns: ``fn(*inputs)`` is the program; ``second``
    a second input set (the collective-parity rule records both);
    ``donated`` the tensors it claims to write in place; ``meta`` facts
    the build learned (joined to the target's meta)."""

    fn: object
    inputs: tuple = ()
    second: tuple | None = None
    donated: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Built:
    """One audited program: its recording on the inputs, on the second
    input set (or None), the inputs themselves (to run it again) and the
    target's meta."""

    name: str
    program: object  # ir.Program
    second: object  # ir.Program or None
    inputs: tuple
    meta: dict


@dataclasses.dataclass(frozen=True)
class Target:
    name: str
    doc: str
    builder: object  # (device) -> Case
    sources: tuple  # repo-relative files this program is recorded from
    meta: dict = dataclasses.field(default_factory=dict)
    # rule -> reason: registry-side reasoned waivers (suppressed findings)
    waivers: dict = dataclasses.field(default_factory=dict)


def _register(name, doc, sources, meta=None, waivers=None):
    def deco(fn):
        _REGISTRY[name] = Target(name=name, doc=doc, builder=fn, sources=tuple(sources),
                                 meta=dict(meta or {}), waivers=dict(waivers or {}))
        return fn

    return deco


REGISTRY = _REGISTRY


def _device(device):
    from ...core.memory import resolve_device

    return resolve_device(device)


def build_from(t: Target, device=None) -> Built:
    """Set up and record one target on ``device`` (the card unless the
    caller names another; raises without one). Also the entry point tests
    use to audit fixture programs that are not in the registry."""
    from .ir import record

    dev = _device(device)
    case = t.builder(dev)
    meta = {**t.meta, **case.meta}
    donated = tuple(case.donated)
    if donated:
        meta["donated_leaves"] = len(donated)
    program = record(case.fn, *case.inputs, name=t.name, device=dev.type,
                     donated=donated, meta=meta)
    second = None
    if case.second is not None:
        second = record(case.fn, *case.second, name=t.name, device=dev.type, meta=meta)
    return Built(name=t.name, program=program, second=second,
                 inputs=tuple(case.inputs), meta=meta)


def build(name: str, device=None) -> Built:
    """Memoized :func:`build_from` over the registry."""
    key = (name, _device(device).type)
    if key not in _BUILT:
        _BUILT[key] = build_from(_REGISTRY[name], device)
    return _BUILT[key]


def clear_cache() -> None:
    _BUILT.clear()
    _SHARED.clear()
    while _TEMP_DIRS:
        shutil.rmtree(_TEMP_DIRS.pop(), ignore_errors=True)


def _temp_dir(prefix: str) -> str:
    path = tempfile.mkdtemp(prefix=prefix)
    _TEMP_DIRS.append(path)
    return path


# -- shared fixtures ----------------------------------------------------------------


def _mesh(dev):
    """The audit mesh: a logical ``(data=1, feature=2)`` mesh of one device."""
    from ...parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * 2, data=1, feature=2)


def _tiny_trainer(dev, **kw):
    """The JAX package's acceptance trainer on the audit mesh: 96 nodes,
    8-dim features, [3, 2] fanouts, local_batch=8, ``seed_sharding="all"``,
    so the sharded lookup routes and the step carries the full exchange.
    SGD at 1e-2 (optax.sgd's counterpart; it keeps no state)."""
    key = (dev.type, "trainer", tuple(sorted(kw.items())))
    if key in _SHARED:
        return _SHARED[key]
    import torch

    from ...core.topology import CSRTopo
    from ...feature.shard import ShardedFeature
    from ...models.sage import GraphSAGE
    from ...parallel.trainer import DistributedTrainer
    from ...sampling.sampler import GraphSageSampler

    kw = dict(kw)
    rng = np.random.default_rng(0)
    n = 96
    topo = CSRTopo(edge_index=rng.integers(0, n, size=(2, 800)).astype(np.int64))
    feat = rng.normal(size=(n, 8)).astype(np.float32)
    dtype = "int8" if kw.pop("int8", False) else None
    mesh = _mesh(dev)
    store = ShardedFeature(mesh, device_cache_size="1G", csr_topo=topo, kernel="pallas",
                           dtype=dtype).from_cpu_tensor(feat)
    sampler = GraphSageSampler(topo, [3, 2], device=dev, seed=0, seed_capacity=8,
                               kernel="pallas")
    model = GraphSAGE(8, 8, 4, num_layers=2).to(dev)
    trainer = DistributedTrainer(mesh, sampler, store, model,
                                 torch.optim.SGD(model.parameters(), lr=1e-2),
                                 local_batch=8, seed_sharding="all", **kw)
    trainer.init(0)
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(dev)
    out = (trainer, labels)
    _SHARED[key] = out
    return out


def _packed(trainer, steps: int, seed: int):
    import torch

    mat = trainer.pack_epoch(np.arange(steps * trainer.global_batch), seed=seed)
    return torch.from_numpy(mat.astype(np.int32)).to(trainer.device)


def _epoch_case(trainer, labels, steps: int = 1) -> Case:
    """The epoch body (``_run_chunk``: the scan over the steps of a packed
    seed matrix), on two seed matrices."""
    inject = np.zeros(steps, dtype=bool)

    def run(packed, labels):
        losses, _ = trainer._run_chunk(packed, labels, 1, inject, 0, steps)
        return losses

    return Case(run, (_packed(trainer, steps, 0), labels),
                second=(_packed(trainer, steps, 1), labels))


def _step_case(trainer, labels) -> Case:
    """One step's body (``_run_step`` on a packed device seed row)."""
    def run(packed, labels):
        return trainer._run_step(packed, labels, 1, False)

    return Case(run, (_packed(trainer, 1, 0)[0], labels),
                second=(_packed(trainer, 1, 1)[0], labels))


# the comm model of the audited epoch body: 2 workers (seed_sharding="all"
# => every mesh slot) of local_batch 8, [3, 2] fanouts: each member routes
# its worst-case frontier, 8 x (1 + 3) x (1 + 2) = 96 lanes
_EPOCH_COMM = dict(feature_shards=2, local_len=8 * (1 + 3) * (1 + 2), feature_dim=8)

# the tiny step's metric reductions beyond the training math: the routed
# overflow's sum over "data" and the (3,) tier hits' sum over ("data",
# "feature") (parallel/trainer.py _update; the JAX package's two tape
# psums). A topology-sharded sampler adds the hops' overflow, and a guard
# its non-finite count's own sum (3 then, as in the JAX package); the
# guard's verdict sum runs with metrics off too and is not one of them
_EXPECTED_METRIC_REDUCTIONS = 2


# -- targets -------------------------------------------------------------------------


@_register(
    "routed_gather",
    "capped-bucket routed feature gather (cap 2), recorded on ids that fit "
    "the buckets and on ids that overflow them (the fallback serves)",
    sources=("quiver_tpu_torch/feature/shard.py", "quiver_tpu_torch/parallel/routing.py",
             "quiver_tpu_torch/parallel/mesh.py", "quiver_tpu_torch/parallel/world.py",
             "quiver_tpu_torch/obs/marks.py"),
    meta={"hbm_budget": 3 * 1024},
)
def _routed_gather(dev):
    import torch

    from ...feature.shard import ShardedTensor

    tbl = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    st = ShardedTensor(_mesh(dev), kernel="pallas").from_cpu_tensor(tbl)

    def ids(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    def run(i):
        return st.routed_gather(i, cap=2, with_overflow=True)

    # two ids per owner per member fit cap 2; JAX's arange(8) sends every
    # id to shard 0, 4 lanes into each 2-lane bucket
    return Case(run, (ids([[0, 8, 1, 9], [2, 10, 3, 11]]),),
                second=(ids([[0, 1, 2, 3], [4, 5, 6, 7]]),))


@_register(
    "tiered_lookup_int8",
    "trainer step over an int8 ShardedFeature: the three-tier lookup with "
    "int8 codes riding the routed all_to_all",
    sources=("quiver_tpu_torch/feature/shard.py", "quiver_tpu_torch/feature/feature.py",
             "quiver_tpu_torch/parallel/trainer.py"),
    meta={"int8_path": True, "hbm_budget": 53 * 1024},
)
def _tiered_lookup_int8(dev):
    return _step_case(*_tiny_trainer(dev, int8=True, collect_metrics=False))


@_register(
    "sample_hop",
    "topology-sharded multilayer sample of one feature group "
    "(DistGraphSageSampler.sample_group: owner-routed hops, K1 select on "
    "the owner side)",
    sources=("quiver_tpu_torch/sampling/dist.py", "quiver_tpu_torch/sampling/sampler.py",
             "quiver_tpu_torch/core/topology.py", "quiver_tpu_torch/core/sharded_topology.py",
             "quiver_tpu_torch/ops/reindex.py"),
    meta={"hbm_budget": 68 * 1024},
)
def _sample_hop(dev):
    import torch

    from ...core.topology import CSRTopo
    from ...ops.sample import seeded_generator
    from ...sampling.sampler import GraphSageSampler

    rng = np.random.default_rng(7)
    topo = CSRTopo(edge_index=rng.integers(0, 120, size=(2, 900)).astype(np.int64))
    sampler = GraphSageSampler(topo, [3, 2], device=dev, seed=7, seed_capacity=16,
                               dedup="sort", topo_sharding="mesh", mesh=_mesh(dev))

    def seeds(seed):
        s = np.random.default_rng(seed).integers(0, 120, (2, 16)).astype(np.int32)
        return (torch.from_numpy(s).to(dev),
                torch.full((2,), 16, dtype=torch.int32, device=dev))

    def run(s, num):
        gens = [seeded_generator(dev, 7, w) for w in range(2)]
        return sampler.sample_group(s, num, generators=gens)

    return Case(run, seeds(0), second=seeds(1))


@_register(
    "epoch_body_alpha1",
    "fused epoch body (the loop over the one-program step) at "
    "routed_alpha=1: the comm-budget anchor at the tight cap",
    sources=("quiver_tpu_torch/parallel/trainer.py", "quiver_tpu_torch/control/cost.py",
             "quiver_tpu_torch/feature/shard.py"),
    meta={"comm": dict(_EPOCH_COMM, alpha=1.0), "hbm_budget": 105 * 1024},
)
def _epoch_alpha1(dev):
    return _epoch_case(*_tiny_trainer(dev, routed_alpha=1.0))


@_register(
    "epoch_body_alpha2",
    "fused epoch body at routed_alpha=2 (the default budget): comm lanes "
    "double against the same analytic model",
    sources=("quiver_tpu_torch/parallel/trainer.py", "quiver_tpu_torch/control/cost.py",
             "quiver_tpu_torch/feature/shard.py"),
    meta={"comm": dict(_EPOCH_COMM, alpha=2.0), "hbm_budget": 103 * 1024},
)
def _epoch_alpha2(dev):
    return _epoch_case(*_tiny_trainer(dev, routed_alpha=2.0))


@_register(
    "epoch_pipelined",
    "software-pipelined epoch body (pipeline_depth=1, one-step skew): the "
    "same invariants as the serial loop",
    sources=("quiver_tpu_torch/parallel/trainer.py",
             "quiver_tpu_torch/parallel/pipeline.py"),
    meta={"hbm_budget": 115 * 1024},
)
def _epoch_pipelined(dev):
    return _epoch_case(*_tiny_trainer(dev, pipeline_depth=1), steps=2)


@_register(
    "epoch_donating",
    "epoch body with donate_epoch_state=True: every parameter and "
    "optimizer-state tensor is written in place, its storage kept",
    sources=("quiver_tpu_torch/parallel/trainer.py",),
    meta={"donation": "claimed", "hbm_budget": 103 * 1024},
)
def _epoch_donating(dev):
    trainer, labels = _tiny_trainer(dev, donate_epoch_state=True)
    case = _epoch_case(trainer, labels)
    opt = trainer.optimizer
    state = [v for s in opt.state.values() for v in s.values()
             if hasattr(v, "data_ptr")]
    case.donated = tuple(trainer._params()) + tuple(state)
    case.second = None  # a second run would only update the same state again
    return case


def _ladder(dev):
    key = (dev.type, "ladder")
    if key in _SHARED:
        return _SHARED[key]
    import torch

    from ...core.topology import CSRTopo
    from ...models.sage import GraphSAGE
    from ...parallel.train import init_model
    from ...sampling.sampler import GraphSageSampler
    from ...serving.ladder import ServeLadder

    rng = np.random.default_rng(0)
    n, e = 240, 1600
    topo = CSRTopo(edge_index=np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    sampler = GraphSageSampler(topo, [4, 3], device=dev, seed=1, seed_capacity=4,
                               kernel="pallas")
    model = GraphSAGE(12, 16, 5, num_layers=2)
    init_model(model, torch.Generator().manual_seed(0))
    lad = ServeLadder(sampler, model.to(dev).eval(), feature_dim=12)
    _SHARED[key] = lad
    return lad


def _forward_case(lad) -> Case:
    """A bucket-4 forward program's eager step over its static buffers
    (rows drawn from seed 0)."""
    import torch

    program = lad.forward_program(4)
    x = program.inputs["x"]
    g = torch.Generator(device=x.device).manual_seed(0)
    x.copy_(torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype))
    return Case(lambda *_: program.step(), (x, *program.inputs["eis"]))


@_register(
    "serve_forward",
    "serving-ladder forward program (bucket 4): the eager pass its CUDA "
    "graph is captured from",
    sources=("quiver_tpu_torch/serving/ladder.py", "quiver_tpu_torch/models/sage.py",
             "quiver_tpu_torch/models/layers.py", "quiver_tpu_torch/parallel/train.py"),
    meta={"donation": "none", "hbm_budget": 19 * 1024},
)
def _serve_forward(dev):
    return _forward_case(_ladder(dev))


@_register(
    "serve_sample",
    "serving-ladder per-bucket sample program (the lanes' hops, one fused "
    "launch per hop)",
    sources=("quiver_tpu_torch/serving/ladder.py", "quiver_tpu_torch/ops/sample.py",
             # the ladder's launch tally (ops.kernels.launch_counts) reads it
             "quiver_tpu_torch/ops/kernels/segment.py"),
    meta={"donation": "none", "hbm_budget": 33 * 1024},
)
def _serve_sample(dev):
    import torch

    lad = _ladder(dev)
    program = lad.sample_program(4)
    seeds = program.inputs["seeds"]
    seeds.copy_(torch.arange(4, dtype=torch.int32, device=dev))
    seqs = [0, 1, 2, 3]
    program.inputs["seqs"] = seqs
    lad._fill_draws(program.inputs["draws"], seqs)
    draws = [t for d in program.inputs["draws"] for t in (d if isinstance(d, tuple) else (d,))]
    return Case(lambda *_: program.step(), (seeds, *draws))


@_register(
    "metrics_on",
    "trainer step with collect_metrics=True: the telemetry-carrying half "
    "of the metrics-strip differential",
    sources=("quiver_tpu_torch/parallel/trainer.py", "quiver_tpu_torch/obs/registry.py"),
    meta={"hbm_budget": 103 * 1024},
)
def _metrics_on(dev):
    return _step_case(*_tiny_trainer(dev, collect_metrics=True))


@_register(
    "metrics_off",
    "trainer step with collect_metrics=False: must equal metrics_on minus "
    "exactly the declared metric reductions",
    sources=("quiver_tpu_torch/parallel/trainer.py", "quiver_tpu_torch/obs/registry.py"),
    meta={"metrics_pair": "metrics_on",
          "expected_metric_reductions": _EXPECTED_METRIC_REDUCTIONS,
          "hbm_budget": 103 * 1024},
)
def _metrics_off(dev):
    return _step_case(*_tiny_trainer(dev, collect_metrics=False))


@_register(
    "pallas_fused_interp",
    "the kernels of the election paths in one program: the uniform hop "
    "with its eid lane (K1 uniform_hop), the weighted hop (K3 "
    "weighted_hop) and the row gather (K2 gather_rows)",
    sources=("quiver_tpu_torch/ops/kernels/fused.py", "quiver_tpu_torch/ops/kernels/gather.py",
             "quiver_tpu_torch/ops/kernels/build.py", "quiver_tpu_torch/ops/kernels/sample.py",
             "quiver_tpu_torch/ops/election.py", "quiver_tpu_torch/obs/marks.py"),
    meta={"hbm_budget": 22 * 1024},
)
def _pallas_fused(dev):
    import torch

    from ...core.topology import CSRTopo
    from ...ops.kernels.fused import fused_sample_layer
    from ...ops.kernels.gather import gather_rows
    from ...ops.sample import seeded_generator

    rng = np.random.default_rng(0)
    topo = CSRTopo(edge_index=np.stack([rng.integers(0, 64, 900), rng.integers(0, 64, 900)]))
    topo.set_edge_weight(rng.random(900).astype(np.float32) + 0.1)
    placed = topo.to_device("GPU", dev, with_eid=True, with_weights=True)
    seeds = torch.from_numpy(rng.integers(0, 64, 16).astype(np.int32)).to(dev)
    tbl = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 64, 16).astype(np.int32)).to(dev)

    def run(s, t, i):
        uni = fused_sample_layer(placed, s, 16, 4, seeded_generator(dev, 0, 0),
                                 with_eid=True)
        wei = fused_sample_layer(placed, s, 16, 4, seeded_generator(dev, 0, 1),
                                 weighted=True)
        return uni, wei, gather_rows(t, i)

    return Case(run, (seeds, tbl, ids))


@_register(
    "serve_fleet_forward",
    "fleet replica forward program, the warm joiner's: a second replica "
    "takes the first replica's programs from the shared cache (zero "
    "captures on join) and serves the same forward",
    sources=("quiver_tpu_torch/serving/fleet.py", "quiver_tpu_torch/serving/aot.py",
             "quiver_tpu_torch/serving/server.py", "quiver_tpu_torch/serving/ladder.py"),
    meta={"donation": "none", "hbm_budget": 19 * 1024},
)
def _serve_fleet_forward(dev):
    import torch

    from ...core.topology import CSRTopo
    from ...feature.feature import Feature
    from ...models.sage import GraphSAGE
    from ...parallel.train import init_model
    from ...sampling.sampler import GraphSageSampler
    from ...serving.fleet import ServingFleet

    rng = np.random.default_rng(3)
    n, e = 160, 900
    topo = CSRTopo(edge_index=np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    feat = Feature(device_cache_size="1G", kernel="pallas", device=dev).from_cpu_tensor(
        rng.normal(size=(n, 12)).astype(np.float32))
    sampler = GraphSageSampler(topo, [4, 3], device=dev, seed=1, seed_capacity=4,
                               kernel="pallas")
    model = GraphSAGE(12, 16, 5, num_layers=2)
    init_model(model, torch.Generator().manual_seed(0))
    fleet = ServingFleet(sampler, model.to(dev).eval(), feat, replicas=1,
                         aot_cache=_temp_dir("quiver-audit-aot-"), seed=7, warm=True,
                         max_batch=4, buckets=(4,), device=dev)
    fleet.add_replica(warm=True)
    _SHARED[(dev.type, "fleet")] = fleet
    case = _forward_case(fleet.servers[-1]._ladder)
    # the join ledger: the audited program is the warm joiner's (no capture)
    case.meta["warm_join"] = {"loaded": int(fleet.cold_starts[-1]["loaded"]),
                              "compiled": int(fleet.cold_starts[-1]["compiled"])}
    return case


@_register(
    "mmap_tiered_gather",
    "MmapFeatureStore's tier merge (quiver-ooc): the one K2 launch a staged "
    "batch runs, with the host-assembled cold block as an operand",
    sources=("quiver_tpu_torch/ooc/store.py", "quiver_tpu_torch/ooc/format.py",
             "quiver_tpu_torch/ooc/stager.py", "quiver_tpu_torch/feature/feature.py"),
    meta={"hbm_budget": 4 * 1024},
)
def _mmap_tiered_gather(dev):
    program = _mmap_store(dev).trace_lookup(16)
    return Case(program.fn, program.args)


def _mmap_store(dev):
    """A tiny raw feature dir and its reopened ``MmapFeatureStore``, with a
    hot AND a cold tier (device_cache_size splits the 64 rows)."""
    key = (dev.type, "mmap_store")
    if key in _SHARED:
        return _SHARED[key]
    from ...core.topology import CSRTopo
    from ...ooc.store import MmapFeatureStore

    rng = np.random.default_rng(5)
    n, f = 64, 8
    topo = CSRTopo(edge_index=np.stack([rng.integers(0, n, 400), rng.integers(0, n, 400)]))
    tensor = rng.normal(size=(n, f)).astype(np.float32)
    path = _temp_dir("quiver-audit-ooc-")
    MmapFeatureStore.write(path, tensor, device_cache_size=16 * f * 4, csr_topo=topo)
    store = MmapFeatureStore(path, kernel="pallas", access="mmap", window_rows=16,
                             device=dev)
    _SHARED[key] = store
    return store
