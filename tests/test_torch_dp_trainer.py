"""``DataParallelTrainer`` of quiver_tpu_torch (``parallel/trainer.py``)
against quiver_tpu's: the contracts of ``tests/test_distributed.py``'s
data-parallel tests and ``tests/test_guardrails.py``'s auto-cap pinning,
on the CPU. JAX runs ``data=8`` on its 8 forced host devices; the port
runs the same 8 workers in turn on one CPU device (a mesh whose device
repeats).

Both sides of a step get the same batches: the JAX package's samples and
gathers, converted, with flax's parameters carried across by
``models/convert.py`` and dropout 0.

Tolerances, float32:
- one step's loss: 1e-5 relative. The port sums ``loss_w / D`` over the
  workers through one backward each, accumulating ``.grad`` in worker
  order; JAX's ``pmean`` sums the workers' gradients and divides, and the
  two frameworks order their float sums differently;
- the parameters after one SGD step at lr 0.1: within 1e-6 absolute and
  1e-5 relative (the step moves each by 0.1 x a gradient that agrees to
  about 1e-6 of its size);
- blocks, ids, caps and counts: bitwise; the short-block mask against
  the port's own single-step oracle: 1e-6 relative (the same ops on the
  same inputs);
- learning: the 6-epoch HOST-mode run ends below 0.7x its first loss,
  JAX's own bar.
"""

import copy
import logging

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np
import optax  # noqa: E402
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.feature import Feature as FeatureJ  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.parallel.pipeline import Batch as BatchJ  # noqa: E402
from quiver_tpu.parallel.trainer import DataParallelTrainer as TrainerJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE  # noqa: E402
from quiver_tpu_torch.ops.sample import seeded_generator  # noqa: E402
from quiver_tpu_torch.parallel.pipeline import Batch  # noqa: E402
from quiver_tpu_torch.parallel.train import make_train_step  # noqa: E402
from quiver_tpu_torch.parallel.trainer import DataParallelTrainer  # noqa: E402
from quiver_tpu_torch.sampling.sampler import Adj, SampleOutput  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402


def _labeled_graph(n=400, classes=4, seed=0):
    """``tests/test_distributed.py``'s planted graph: class-homophilous
    edges, one-hot features with noise."""
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


def _cpu_mesh(data, feature=1):
    return qt.make_mesh(data=data, feature=feature, devices=["cpu"] * (data * feature))


def _port_trainer(ei, feat, data, local_batch, sizes=(4, 3), lr=0.1, model=None,
                  **kw):
    topo = qt.CSRTopo(edge_index=ei)
    sampler = qt.GraphSageSampler(topo, list(sizes), device="cpu",
                                  seed_capacity=local_batch, seed=9,
                                  frontier_caps=kw.pop("frontier_caps", None))
    feature = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(feat)
    model = model or GraphSAGE(feat.shape[1], 16, 4, num_layers=len(sizes), dropout=0.0)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    return DataParallelTrainer(_cpu_mesh(data), sampler, feature, model, opt,
                               local_batch=local_batch, **kw)


def _to_port(batch_j):
    """A JAX ``Batch`` as the port's (the same ids, Adjs and rows)."""
    out = batch_j.out

    def t(a):
        return torch.from_numpy(np.array(a))

    adjs = [Adj(t(a.edge_index), None, a.size, fanout=a.fanout) for a in out.adjs]
    return Batch(batch_j.seeds, SampleOutput(t(out.n_id), out.batch_size, adjs,
                                             t(out.n_count), t(out.overflow)),
                 t(batch_j.x))


@pytest.fixture(scope="module")
def graph():
    return _labeled_graph(n=300)


@pytest.mark.parametrize("data", [1, 8])
def test_step_equals_jax(graph, data):
    """One step of D blocks (the last one short) on both packages: loss,
    then every parameter after one SGD step."""
    ei, feat, labels = graph
    local = 32
    topo_j = qj.CSRTopo(edge_index=ei)
    sampler_j = qj.GraphSageSampler(topo_j, [4, 3], seed_capacity=local, seed=9)
    feature_j = FeatureJ(device_cache_size="1G").from_cpu_tensor(feat)
    model_j = SageJ(hidden=16, num_classes=4, num_layers=2, dropout=0.0)
    devices = jax.devices()[:data]
    trainer_j = TrainerJ(make_mesh_j(data=data, feature=1, devices=devices),
                         sampler_j, feature_j, model_j, optax.sgd(0.1),
                         local_batch=local)
    params, opt_state = trainer_j.init(jax.random.PRNGKey(0))
    seeds = np.random.default_rng(3).permutation(300)[: local * data - 5]
    batches_j = []
    for block in trainer_j.seed_blocks(seeds):
        out = sampler_j.sample(block)
        batches_j.append(BatchJ(block, out, feature_j[out.n_id]))
    new_params, _, loss_j = trainer_j.step(params, opt_state, batches_j,
                                           jnp.asarray(labels), jax.random.PRNGKey(5))

    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    trainer = _port_trainer(ei, feat, data, local, model=model)
    loss = trainer.step([_to_port(b) for b in batches_j],
                        torch.from_numpy(labels.astype(np.int32)))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, new_params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_short_blocks_mask_frontier_lanes(graph):
    """For a block shorter than local_batch, n_id lanes past batch_size
    hold frontier nodes; they must not train. Oracle: a data=1 step on a
    short block equals the single-device train step masked to the true
    batch, dropout included (worker 0's generator derives from the step
    generator's seed and 0)."""
    ei, feat, labels = graph
    local = 32
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.5)
    qt.parallel.init_model(model, torch.Generator().manual_seed(0))
    oracle_model = copy.deepcopy(model)
    trainer = _port_trainer(ei, feat, 1, local, model=model, lr=0.0)
    short = np.arange(10)
    out = trainer.sampler.sample(short)
    x = trainer.feature[out.n_id]
    labels_t = torch.from_numpy(labels.astype(np.int32))
    gen = torch.Generator().manual_seed(5)
    dp_loss = trainer.step([Batch(short, out, x)], labels_t, gen)

    step = make_train_step(oracle_model,
                           torch.optim.SGD(oracle_model.parameters(), lr=0.0))
    seed_ids = out.n_id[:local]
    mask = (torch.arange(local) < 10) & (seed_ids >= 0)
    assert int((seed_ids[10:] >= 0).sum()) > 0  # frontier nodes sit there
    ref = step(x, out.adjs, labels_t[seed_ids.clamp(min=0)], mask,
               seeded_generator("cpu", gen.initial_seed(), 0))
    np.testing.assert_allclose(float(dp_loss), float(ref), rtol=1e-6)


def _recorder(sampler, raise_after=False):
    """A sampler wrapper keeping every seed array it is asked for; with
    ``raise_after`` each call then raises (the epoch skips every batch
    and runs no step)."""

    class Recorder:
        seen = []

        def sample(self, seeds):
            self.seen.append(np.array(seeds))
            if raise_after:
                raise RuntimeError("recorded")
            return sampler.sample(seeds)

        def __getattr__(self, name):
            return getattr(sampler, name)

    return Recorder()


@pytest.mark.parametrize("n_train,data,local", [(300, 8, 16), (100, 8, 32), (257, 1, 64)])
def test_epoch_blocks_equal_jax(graph, n_train, data, local):
    ei, feat, labels = graph
    train_idx = np.random.default_rng(n_train).permutation(300)[:n_train]
    sampler_j = qj.GraphSageSampler(qj.CSRTopo(edge_index=ei), [3], seed_capacity=local,
                                    seed=0)
    trainer_j = TrainerJ(make_mesh_j(data=data, feature=1, devices=jax.devices()[:data]),
                         sampler_j, FeatureJ(device_cache_size="1G").from_cpu_tensor(feat),
                         SageJ(hidden=8, num_classes=4, num_layers=1), optax.sgd(0.0),
                         local_batch=local, prefetch_skip_policy="skip")
    trainer_j.sampler = rec_j = _recorder(sampler_j, raise_after=True)
    _, _, loss_j, steps_j = trainer_j.train_epoch(
        None, None, train_idx, None, None, rng=np.random.default_rng(11))
    assert steps_j == 0 and np.isnan(loss_j)

    trainer = _port_trainer(ei, feat, data, local, sizes=(3,))
    trainer.sampler = rec = _recorder(trainer.sampler)
    loss, steps = trainer.train_epoch(train_idx, torch.from_numpy(labels),
                                      torch.Generator().manual_seed(1),
                                      rng=np.random.default_rng(11))
    assert steps == max(n_train // (data * local), 1) and np.isfinite(loss)
    assert len(rec.seen) == len(rec_j.seen) == steps * data
    for a, b in zip(rec.seen, rec_j.seen):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_epoch_errors_and_a_small_epoch(graph):
    ei, feat, labels = graph
    trainer = _port_trainer(ei, feat, 8, 32)
    labels_t = torch.from_numpy(labels)
    with pytest.raises(ValueError, match="empty seed set"):
        trainer.train_epoch(np.arange(0), labels_t, torch.Generator())
    loss, steps = trainer.train_epoch(np.arange(100), labels_t, torch.Generator())
    assert steps == 1 and np.isfinite(loss)
    with pytest.raises(ValueError, match="need 8 batches"):
        trainer.step([], labels_t)
    with pytest.raises(ValueError, match="exceeds local_batch"):
        trainer.seed_blocks(np.arange(8 * 32 + 8))


def test_constructor_errors(graph):
    ei, feat, _ = graph
    topo = qt.CSRTopo(edge_index=ei)
    sampler = qt.GraphSageSampler(topo, [3], device="cpu", seed=0)
    feature = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(feat)
    model = GraphSAGE(4, 8, 4, num_layers=1)
    opt = torch.optim.Adam(model.parameters())

    class Sharded:  # a store whose hot tier is sharded across the mesh
        cache_policy = "mesh_shard"

    with pytest.raises(ValueError, match="fused DistributedTrainer"):
        DataParallelTrainer(_cpu_mesh(4), sampler, Sharded(), model, opt)
    with pytest.raises(ValueError, match="feature=1"):
        DataParallelTrainer(_cpu_mesh(4, 2), sampler, feature, model, opt)
    two = qt.make_mesh(devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="A.11"):
        DataParallelTrainer(two, sampler, feature, model, opt)


def test_adj_sizes_unbound_equals_jax():
    caps = (40, 200)
    stub = type("T", (), {"local_batch": 32})()
    assert (DataParallelTrainer._adj_sizes(stub, caps)
            == TrainerJ._adj_sizes(stub, caps) == [(200, 40), (40, 32)])


def test_stack_reads_fanouts_and_rejects_disagreeing_blocks(graph):
    ei, feat, _ = graph
    trainer = _port_trainer(ei, feat, 2, 16)
    batches = []
    for b in trainer.seed_blocks(np.arange(32)):
        out = trainer.sampler.sample(b)
        batches.append(Batch(b, out, trainer.feature[out.n_id]))
    caps, fanouts = trainer._stack(batches)
    assert fanouts == tuple(trainer.sampler.sizes)[::-1]
    assert caps == tuple(trainer.sampler._caps_for(16))
    odd = batches[1].out._replace(adjs=[Adj(a.edge_index, None, (a.size[0] + 8, a.size[1]),
                                            a.fanout) for a in batches[1].out.adjs])
    with pytest.raises(ValueError, match="disagree"):
        trainer._stack([batches[0], batches[1]._replace(out=odd)])


def test_host_offload_training_learns():
    """``test_host_offload_multichip_training_learns`` on the port: a
    HOST-mode topology and a 30%-hot store with a cold tier, data=8,
    Adam 5e-3, 6 epochs; the last epoch's loss below 0.7x the first's."""
    ei, feat, labels = _labeled_graph(n=600)
    topo = qt.CSRTopo(edge_index=ei)
    n = topo.node_count
    local = 32
    sampler = qt.GraphSageSampler(topo, [5, 5], mode="HOST", seed_capacity=local,
                                  seed=5, device="cpu")
    feature = qt.Feature(device_cache_size=int(0.3 * n) * feat.shape[1] * 4,
                         csr_topo=topo, device="cpu").from_cpu_tensor(feat)
    assert feature.cold is not None  # a genuinely beyond-"HBM" store
    model = GraphSAGE(feat.shape[1], 32, 4, num_layers=2)
    trainer = DataParallelTrainer(_cpu_mesh(8), sampler, feature, model,
                                  torch.optim.Adam(model.parameters(), lr=5e-3),
                                  local_batch=local)
    trainer.init(torch.Generator().manual_seed(0))
    lab = torch.from_numpy(labels.astype(np.int32))
    losses = []
    for epoch in range(6):
        mean_loss, steps = trainer.train_epoch(
            np.arange(n), lab, torch.Generator().manual_seed(100 + epoch),
            rng=np.random.default_rng(epoch))
        assert steps == max(n // trainer.global_batch, 1)
        losses.append(mean_loss)
    assert losses[-1] < losses[0] * 0.7, losses


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def records():
    logger = trace.get_logger()
    level, handler = logger.level, _Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)
    logger.setLevel(level)


def _skewed_graph():
    """Nodes 0-15 (the probe batch) have 2 neighbours each, with none of
    their own; hubs 100-115 have 40 distinct neighbours each, and each of
    those 5 more."""
    rng = np.random.default_rng(0)
    low = np.stack([np.repeat(np.arange(16), 2), rng.integers(16, 100, 32)])
    hub_nbrs = 200 + np.arange(16 * 40)
    hubs = np.stack([np.repeat(np.arange(100, 116), 40), hub_nbrs])
    leaves = np.stack([np.repeat(hub_nbrs, 5), 2000 + np.arange(640 * 5)])
    ei = np.concatenate([low, hubs, leaves], axis=1)
    n = int(ei.max()) + 1
    return ei, rng.normal(size=(n, 4)).astype(np.float32), rng.integers(0, 4, n)


def test_auto_caps_pinned_after_the_probe(records):
    """``frontier_caps="auto"``: construction pins the plan from one probe
    batch (the sampler's call counter advances by one) and logs JAX's
    line; a skewed batch later is clipped and reported, and the caps do
    not regrow; an epoch of diverse blocks then runs."""
    ei, feat, labels = _skewed_graph()
    trainer = _port_trainer(ei, feat, 2, 16, frontier_caps="auto")
    sampler = trainer.sampler
    assert sampler._auto_caps is False and sampler._call == 1
    caps = sampler._frontier_caps
    assert caps is not None and caps[1] < sampler._worst_caps(16)[1]
    msgs = [r.getMessage() for r in records if "PINNED" in r.getMessage()]
    assert msgs == [
        f"auto frontier caps planned from a probe batch and PINNED at {caps} for "
        "the epoch loop (mid-epoch replanning would make stacked blocks "
        "disagree; overflowing batches are clipped and reported instead)"]
    out = sampler.sample(np.arange(100, 116))
    assert int(out.overflow) > 0 and sampler._frontier_caps == caps
    assert sampler.reruns == 0
    seeds = np.concatenate([np.arange(100, 116), np.arange(16), np.arange(200, 232)])
    loss, steps = trainer.train_epoch(seeds, torch.from_numpy(labels), torch.Generator())
    assert steps == 2 and np.isfinite(loss) and sampler._frontier_caps == caps


def test_fixed_caps_untouched(graph):
    ei, feat, _ = graph
    trainer = _port_trainer(ei, feat, 2, 16)
    assert trainer.sampler._auto_caps is False and trainer.sampler._call == 0


def test_prefetch_retries_keep_the_losses(graph):
    """A sampler fault plan with ``prefetch_retries=2``: the same epoch
    losses as a fault-free trainer (bitwise: the same batches and ops),
    and the retries show in ``metrics_report()``."""
    ei, feat, labels = graph
    model = GraphSAGE(4, 16, 4, num_layers=2, dropout=0.5)
    qt.parallel.init_model(model, torch.Generator().manual_seed(0))
    labels_t = torch.from_numpy(labels)
    runs = []
    for plan in (None, qt.FaultPlan(sampler_faults={1: 2, 4: 1})):
        trainer = _port_trainer(ei, feat, 2, 16, model=copy.deepcopy(model),
                                prefetch_retries=2, prefetch_backoff=0.0)
        if plan is not None:
            trainer.sampler = plan.wrap_sampler(trainer.sampler)
        losses = [trainer.train_epoch(np.arange(300), labels_t,
                                      torch.Generator().manual_seed(e),
                                      rng=np.random.default_rng(e))
                  for e in range(2)]
        runs.append((losses, trainer.metrics_report()))
    (clean, report_clean), (faulty, report) = runs
    assert clean == faulty
    assert "prefetch.retries (counter): total=3" in report
    assert "prefetch.retries" not in report_clean
    assert "prefetch.dispatch" in report and "timeline:" in report


def test_exhausted_retries_raise_the_fault(graph):
    ei, feat, labels = graph
    trainer = _port_trainer(ei, feat, 2, 16, prefetch_retries=1, prefetch_backoff=0.0)
    trainer.sampler = qt.FaultPlan(sampler_faults={0: 5}).wrap_sampler(trainer.sampler)
    with pytest.raises(qt.TransientFault, match="batch 0"):
        trainer.train_epoch(np.arange(64), torch.from_numpy(labels), torch.Generator())


def test_serial_epoch_equals_prefetched(graph):
    """``depth=0`` runs the same blocks on the caller's thread: the same
    losses as the Prefetcher's (bitwise)."""
    ei, feat, labels = graph
    model = GraphSAGE(4, 16, 4, num_layers=2)
    qt.parallel.init_model(model, torch.Generator().manual_seed(0))
    got = []
    for depth in (2, 0):
        trainer = _port_trainer(ei, feat, 4, 16, model=copy.deepcopy(model))
        got.append(trainer.train_epoch(np.arange(300), torch.from_numpy(labels),
                                       torch.Generator().manual_seed(3),
                                       rng=np.random.default_rng(1), depth=depth))
    assert got[0] == got[1]
