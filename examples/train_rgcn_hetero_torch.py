"""Heterogeneous R-GCN training with quiver_tpu_torch (PyTorch/CUDA).

The torch twin of ``examples/train_rgcn_hetero.py``, with the same flags
and progress lines: a synthetic OGB-MAG-shaped schema (paper-cites-paper,
author-writes-paper, inst-employs-author), per-relation neighbour sampling
(``HeteroGraphSampler``: each relation's hop one launch of kernel K1),
per-type feature lookup (``HeteroFeature``: one K2 launch per type), and a
relational GCN trained with Adam on random paper labels (so there is no
accuracy to reach; the losses must stay finite).

It runs on the CUDA card unless ``--device`` names another (``--device
cpu`` runs the kernels' plain versions); with no card and no ``--device``
it raises.

    python -m examples.train_rgcn_hetero_torch                  # 20,000 papers
    python -m examples.train_rgcn_hetero_torch --papers 2000 --device cpu
"""

import argparse
import time

import numpy as np
import torch

from quiver_tpu_torch import HeteroCSRTopo, HeteroFeature, HeteroGraphSampler
from quiver_tpu_torch.core.memory import resolve_device
from quiver_tpu_torch.models.rgcn import RGCN, rgcn_schema
from quiver_tpu_torch.ops.sample import seeded_generator
from quiver_tpu_torch.parallel.train import init_model, make_train_step


def synthetic_mag(rng, n_paper, n_author, n_inst, deg=12):
    edges = {
        ("paper", "cites", "paper"): np.stack([
            rng.integers(0, n_paper, n_paper * deg),
            rng.integers(0, n_paper, n_paper * deg),
        ]),
        ("author", "writes", "paper"): np.stack([
            rng.integers(0, n_author, n_paper * 3),
            rng.integers(0, n_paper, n_paper * 3),
        ]),
        ("inst", "employs", "author"): np.stack([
            rng.integers(0, n_inst, n_author * 2),
            rng.integers(0, n_author, n_author * 2),
        ]),
    }
    num_nodes = {"paper": n_paper, "author": n_author, "inst": n_inst}
    return HeteroCSRTopo(num_nodes, edges), num_nodes


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--papers", type=int, default=20_000)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--fanout", type=int, nargs="+", default=[8, 4])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the list of per-step losses."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    topo, num_nodes = synthetic_mag(
        rng, args.papers, args.papers // 2, max(args.papers // 40, 4))
    feats = {
        t: rng.normal(size=(c, args.feature_dim)).astype(np.float32)
        for t, c in num_nodes.items()
    }
    feature = HeteroFeature.from_cpu_tensors(feats, device_cache_size="2G",
                                             device=device)
    labels_all = torch.from_numpy(
        rng.integers(0, args.classes, num_nodes["paper"]).astype(np.int32)).to(device)

    sampler = HeteroGraphSampler(topo, args.fanout, input_type="paper",
                                 seed_capacity=args.batch, seed=args.seed,
                                 device=device)
    # torch creates parameters up front: the first sample gives the schema
    out = sampler.sample(np.arange(args.batch) % num_nodes["paper"])
    model = RGCN(rgcn_schema(out.adjs, {t: args.feature_dim for t in num_nodes}),
                 args.hidden, args.classes, "paper", num_layers=len(args.fanout))
    init_model(model, torch.Generator().manual_seed(0))
    model.to(device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-3))

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        seeds = rng.integers(0, num_nodes["paper"], args.batch)
        out = sampler.sample(seeds)
        seed_ids = out.n_id["paper"][: args.batch]
        labels = labels_all[seed_ids.clamp(min=0)]
        mask = seed_ids >= 0
        loss = step(feature[out.n_id], out.adjs, labels, mask,
                    seeded_generator(device, args.seed, i))
        losses.append(float(loss))
        if i == 0:
            print(f"step 0 (first step): {time.time() - t0:.1f}s")
        elif i % 20 == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    print(f"final loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
