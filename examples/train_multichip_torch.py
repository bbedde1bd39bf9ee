"""Mesh training with quiver_tpu_torch (PyTorch/CUDA): a sharded feature store.

The torch twin of ``examples/train_multichip.py``, with the same flags,
defaults and progress lines, plus ``--device``. It trains GraphSAGE with
``DistributedTrainer`` over a ``(data, feature)`` mesh: per-worker seed
blocks on the data axis, the feature table in a ``ShardedFeature`` whose
rows are sharded over the feature axis (the reference's
``p2p_clique_replicate`` cache), with an optional L0 block of the
top-degree rows on every device (``--replicate-budget``), and the
gradients averaged over the workers.

The mesh is ``--data-axis x --feature-axis`` repeats of one device, a
logical mesh: each slot is a worker and each feature-axis member holds its
own shard, and the routed lookup (``--seed-sharding all``) really moves
requests and rows between the shards, on one card. This is the counterpart
of the JAX example's ``--xla_force_host_platform_device_count`` meshes of
virtual devices. ``--data-axis`` defaults to 1 (the JAX example's device
count over ``--feature-axis``, on one device). It runs on the CUDA card
unless ``--device`` names another (``--device cpu`` runs the kernels' plain
versions); with no card and no ``--device`` it raises.

``--devices`` (a comma list, such as ``cuda:0,cuda:1``, or a card and the
host, ``cuda:0,cpu``) builds the mesh over those devices instead, one slot
each in order, as the JAX example's mesh spans ``jax.devices()``: one
process runs every slot, each worker on its slot's device, and the step
reduces on the first (``--data-axis`` defaults to the device count over
``--feature-axis``).

Under ``torchrun`` (``WORLD_SIZE`` set) it runs one process per mesh slot:
each calls ``init_distributed()`` (``nccl`` on the card ``LOCAL_RANK``
names; ``gloo`` with ``--device cpu``) and builds the world mesh
(``--data-axis`` defaults to the world size over ``--feature-axis``), whose
collectives run over ``torch.distributed``; only rank 0 prints. With
``--topo-sharding mesh`` each process holds only its own row range of the
CSR (its feature-axis shard) and every hop routes over its feature group.

    python -m examples.train_multichip_torch --data-axis 2 --feature-axis 2 \\
        --seed-sharding all --replicate-budget 4M
    torchrun --nproc_per_node=4 examples/train_multichip_torch.py \\
        --feature-axis 2 --seed-sharding all [--topo-sharding mesh]
    python -m examples.train_multichip_torch --device cpu --nodes 3000 \\
        --feature-dim 16 --hidden 32 --fanout 5 5 --local-batch 32 \\
        --data-axis 2 --feature-axis 2
    python -m examples.train_multichip_torch --devices cuda:0,cuda:1 \\
        --feature-axis 2 --seed-sharding all
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script (torchrun): the repo root first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quiver_tpu_torch import CSRTopo, GraphSageSampler, ShardedFeature, make_mesh
from quiver_tpu_torch.core.memory import resolve_device
from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
from quiver_tpu_torch.models.sage import GraphSAGE
from quiver_tpu_torch.parallel.trainer import DistributedTrainer
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--avg-degree", type=float, default=25.0)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--classes", type=int, default=47)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--fanout", type=int, nargs="+", default=[15, 10, 5])
    p.add_argument("--local-batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--data-axis", type=int, default=None)
    p.add_argument("--feature-axis", type=int, default=1)
    p.add_argument("--seed-sharding", default="data", choices=["data", "all"],
                   help="'all': every mesh slot a data worker; the sharded "
                   "lookup routes each worker's ids to their owning shards "
                   "(recommended when feature-axis > 1: no redundant sampling)")
    p.add_argument("--routed-alpha", type=float, default=2.0,
                   help="bucket factor of the routed lookup (seed-sharding=all): "
                   "each exchange moves ~alpha*L lanes instead of F*L; overflow "
                   "is served exactly and reported. 0 = uncapped")
    p.add_argument("--replicate-budget", default="0", metavar="BYTES",
                   help="per-device byte budget ('4M', '0.5G') of the L0 tier: "
                   "the top-degree rows on every device, read with no routing; "
                   "per-tier hit counts are reported after training. 0 = "
                   "two-tier store")
    p.add_argument("--topo-sharding", default="replicated", choices=["replicated", "mesh"],
                   help="'mesh': the CSR itself partitioned over the feature axis "
                   "(each process holds its own row range; hops route to the owners; "
                   "needs --seed-sharding all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--devices", default=None, metavar="LIST",
                   help="a comma list of devices (cuda:0,cuda:1 or cuda:0,cpu): "
                   "the mesh's slots, one per device, in one process")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the trainer. Under ``torchrun`` (``WORLD_SIZE`` set),
    one process per slot of a world mesh."""
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        return train(args)
    init_distributed(device=args.device)
    try:
        return train(args)
    finally:
        shutdown_distributed()


def train(args):
    if "WORLD_SIZE" in os.environ:
        mesh = make_mesh(data=args.data_axis, feature=args.feature_axis)
        device, lead = mesh.device, mesh.rank == 0
        say = print if lead else (lambda *a, **k: None)
        say(f"world mesh over {mesh.world_size} processes: {dict(mesh.shape)} "
            f"(rank 0 on {device})")
    elif args.devices:
        devices = [d.strip() for d in args.devices.split(",") if d.strip()]
        mesh = make_mesh(data=args.data_axis, feature=args.feature_axis, devices=devices)
        device, say = mesh.devices.flat[0], print
        say(f"mesh over {len(devices)} devices: {dict(mesh.shape)} "
            f"({', '.join(str(d) for d in mesh.devices.ravel())})")
    else:
        device, say = resolve_device(args.device), print
        data = args.data_axis or 1
        slots = data * args.feature_axis
        mesh = make_mesh(data=data, feature=args.feature_axis, devices=[device] * slots)
        say(f"mesh over {slots} devices: {dict(mesh.shape)} ({slots} x {device})")

    rng = np.random.default_rng(args.seed)
    topo = CSRTopo(edge_index=generate_pareto_graph(args.nodes, args.avg_degree,
                                                    seed=args.seed))
    n = topo.node_count
    feat = rng.normal(size=(n, args.feature_dim)).astype(np.float32)
    # as the JAX example: every row on the devices, sharded over the feature
    # axis behind the L0 block
    feature = ShardedFeature(
        mesh, device_cache_size=n * args.feature_dim * 4, csr_topo=topo,
        replicate_budget=args.replicate_budget,
    ).from_cpu_tensor(feat)
    del feat
    labels = torch.from_numpy(rng.integers(0, args.classes, n).astype(np.int32)).to(device)

    where = ({"device": device} if args.topo_sharding == "replicated"
             else {"topo_sharding": "mesh", "mesh": mesh, "routed_alpha": args.routed_alpha or None})
    sampler = GraphSageSampler(topo, args.fanout, seed=args.seed, **where)
    if args.topo_sharding == "mesh":
        say(f"topology shard: {sampler.topo.held_bytes / 2**20:.2f} MB on this process's "
            f"device ({sampler.topo.plan['replicated_bytes'] / 2**20:.2f} MB replicated)")
    model = GraphSAGE(args.feature_dim, args.hidden, args.classes,
                      num_layers=len(args.fanout)).to(device)
    trainer = DistributedTrainer(mesh, sampler, feature, model,
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=args.local_batch,
                                 seed_sharding=args.seed_sharding,
                                 routed_alpha=args.routed_alpha or None)
    trainer.init(args.seed)

    global_batch = trainer.global_batch
    t0 = time.time()
    for i in range(args.steps):
        seeds = rng.integers(0, n, global_batch)
        loss = trainer.step(seeds, labels, 1000 + i)
        if i == 0:
            float(loss)  # waits for the first step
            say(f"step 0 (first step): {time.time() - t0:.1f}s")
            t0 = time.time()
        elif i % 10 == 0:
            say(f"step {i}: loss {float(loss):.4f}")
    float(loss)
    per_step = (time.time() - t0) / max(args.steps - 1, 1)
    say(
        f"done: {args.steps} steps, global batch {global_batch} "
        f"({per_step * 1e3:.1f} ms/step, {global_batch / per_step:,.0f} seeds/s)"
    )
    if args.seed_sharding == "all" and trainer.last_routed_overflow is not None:
        say(f"routed overflow (last step): "
              f"{int(trainer.last_routed_overflow)} lanes fallback-served "
              f"(grow --routed-alpha if persistent)")
    if trainer.last_tier_hits is not None:
        h = trainer.last_tier_hits.tolist()
        tot = max(sum(h), 1)
        say(f"feature tier hits (last step): L0 replicated {h[0]} "
              f"({100 * h[0] / tot:.1f}%, zero-comm), sharded {h[1]} "
              f"({100 * h[1] / tot:.1f}%), cold {h[2]} "
              f"({100 * h[2] / tot:.1f}%)")
    return trainer


if __name__ == "__main__":
    main()
