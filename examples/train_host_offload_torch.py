"""Beyond-HBM training with quiver_tpu_torch (PyTorch/CUDA).

The torch twin of ``examples/train_host_offload.py``, with the same flags,
defaults and progress lines: the papers100M-scale configuration, whose
graph and feature table outgrow device memory.

* A ``mode="HOST"`` sampler: the large ``indices`` array stays in pinned
  host memory, and each hop's kernel (K1 ``uniform_hop``) reads it over
  UVA, the reference's zero-copy design.
* A small degree-ordered hot tier of features on the card and the cold
  rest pinned on the host, both read by one K2 ``tiered_gather`` launch
  per step.
* ``Prefetcher`` double-buffering: batch i+1's sample and lookup run on a
  worker thread and its own CUDA stream while batch i trains.

``--trainer loop`` (the default) is the example's own loop; ``--trainer
dp`` trains the same configuration through
``DataParallelTrainer.train_epoch`` on a one-worker mesh, over ``--steps``
x ``--batch`` seeds. ``--prefetch-depth 0`` runs either serially. It runs
on the CUDA card unless ``--device`` names another (``--device cpu`` runs
the kernels' plain versions); with no card and no ``--device`` it raises.

    python -m examples.train_host_offload_torch                 # ~1M nodes
    python -m examples.train_host_offload_torch --trainer dp
    python -m examples.train_host_offload_torch --nodes 5000 --steps 5 --device cpu
"""

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from quiver_tpu_torch import (Batch, CSRTopo, DataParallelTrainer, Feature,
                              GraphSageSampler, Prefetcher, make_mesh)
from quiver_tpu_torch.core.memory import resolve_device
from quiver_tpu_torch.models.sage import GraphSAGE
from quiver_tpu_torch.ops.sample import seeded_generator
from quiver_tpu_torch.parallel.train import init_model, make_train_step
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=1_000_000)
    p.add_argument("--avg-degree", type=float, default=15.0)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--classes", type=int, default=172)  # papers100M: 172
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--fanout", type=int, nargs="+", default=[12, 8])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--cache-ratio", type=float, default=0.1)
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trainer", choices=("loop", "dp"), default="loop",
                   help="the example's loop, or DataParallelTrainer.train_epoch")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def setup(args):
    """The graph, the HOST-mode sampler (auto caps, planned by its first
    call), the tiered store, the labels, the model and Adam. Returns a
    namespace of them and the run's numpy generator."""
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    print(f"building synthetic graph ({args.nodes} nodes)...")
    topo = CSRTopo(edge_index=generate_pareto_graph(args.nodes, args.avg_degree,
                                                    seed=args.seed))
    n = topo.node_count
    # HOST mode: topology beyond device memory, read over UVA
    sampler = GraphSageSampler(topo, args.fanout, mode="HOST",
                               seed_capacity=args.batch, seed=args.seed,
                               frontier_caps="auto", device=device)
    feat = rng.normal(size=(n, args.feature_dim)).astype(np.float32)
    budget = int(args.cache_ratio * n) * args.feature_dim * 4
    feature = Feature(device_cache_size=budget, csr_topo=topo,
                      device=device).from_cpu_tensor(feat)
    del feat
    labels_all = torch.from_numpy(
        rng.integers(0, args.classes, n).astype(np.int32)).to(device)
    model = GraphSAGE(args.feature_dim, args.hidden, args.classes,
                      num_layers=len(args.fanout))
    init_model(model, torch.Generator().manual_seed(0))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    return SimpleNamespace(args=args, device=device, rng=rng, topo=topo,
                           sampler=sampler, feature=feature,
                           labels_all=labels_all, model=model,
                           optimizer=optimizer)


def loop_batches(run, stream, depth: int):
    """Batches of ``stream``'s seed arrays with ``x = (rows, labels,
    mask)``: through a ``Prefetcher`` ``depth`` batches ahead, or
    serially on this thread when ``depth`` is 0."""
    batch = run.args.batch

    def with_labels(seeds, out, x):
        sid = out.n_id[:batch]
        return Batch(seeds, out, (x, run.labels_all[sid.clamp(min=0)], sid >= 0))

    if depth > 0:
        yield from Prefetcher(run.sampler, run.feature, depth=depth,
                              transform=with_labels).run(stream)
        return
    for seeds in stream:
        out = run.sampler.sample(seeds)
        yield with_labels(seeds, out, run.feature[out.n_id])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(run):
    """The example's loop: ``--steps`` batches of random seeds through
    :func:`loop_batches` and ``make_train_step``. Returns ``(last loss,
    seconds, timed steps)``; the first step is not timed."""
    args, n = run.args, run.topo.node_count
    # the JAX example samples a first batch to shape its parameters; here
    # it plans the auto caps, and keeps the sampler's call count the same
    out0 = run.sampler.sample(run.rng.integers(0, n, args.batch))
    run.feature[out0.n_id]
    step = make_train_step(run.model, run.optimizer)
    stream = (run.rng.integers(0, n, args.batch) for _ in range(args.steps))
    t0 = time.time()
    loss = None
    for i, b in enumerate(loop_batches(run, stream, args.prefetch_depth)):
        x, labels, mask = b.x
        loss = step(x, b.out.adjs, labels, mask,
                    seeded_generator(run.device, args.seed, i))
        if i == 0:
            _sync(run.device)
            print(f"step 0 (first step): {time.time() - t0:.1f}s")
            t0 = time.time()
        elif i % 20 == 0:
            print(f"step {i}: loss {float(loss):.4f}")
    _sync(run.device)
    return float(loss), time.time() - t0, max(args.steps - 1, 1)


def train_dp(run):
    """The same configuration through ``DataParallelTrainer.train_epoch``
    over ``--steps`` x ``--batch`` random seeds, on a one-worker mesh of
    the run's device (``make_mesh()`` on a one-card machine; the trainer
    pins the auto caps from a probe batch). Returns ``(mean loss, seconds,
    steps)``."""
    args, n = run.args, run.topo.node_count
    trainer = DataParallelTrainer(make_mesh(devices=[run.device]), run.sampler,
                                  run.feature, run.model, run.optimizer,
                                  local_batch=args.batch)
    trainer.init(torch.Generator().manual_seed(0))
    train_idx = run.rng.integers(0, n, args.steps * args.batch)
    t0 = time.time()
    loss, steps = trainer.train_epoch(
        train_idx, run.labels_all, torch.Generator().manual_seed(args.seed),
        rng=run.rng, depth=args.prefetch_depth)
    seconds = time.time() - t0
    print(f"epoch of {steps} steps: mean loss {loss:.4f}")
    return loss, seconds, steps


def main(argv=None):
    """Train; returns ``(loss, steps/s)``: the last loss of the loop, or
    the epoch's mean loss under ``--trainer dp``."""
    args = parse_args(argv)
    run = setup(args)
    loss, seconds, timed = (train_dp if args.trainer == "dp" else train_loop)(run)
    per_step = seconds / timed
    steps_per_s = 1.0 / per_step
    print(
        f"done: {args.steps} steps at {per_step * 1e3:.1f} ms/step, "
        f"{steps_per_s:.2f} steps/s, loss {loss:.4f} "
        f"(cache {run.feature.cache_ratio:.0%} hot, topology host-resident)"
    )
    return loss, steps_per_s


if __name__ == "__main__":
    main()
