"""GraphSAINT subgraph training with quiver_tpu_torch (PyTorch/CUDA).

The torch twin of ``examples/train_saint.py``, with the same flags and
progress lines: a SAINT sampler draws one induced subgraph per step
(``sampling/saint.py``: the draw, the dedup and the induction on the
device; the neighbour window read by kernel K2, random-walk steps by K1),
a GraphSAGE model runs full message passing over it (one square ``(C,
C)`` Adj at every layer), and GraphSAINT's loss normalisation
(``estimate_saint_norm``) unbiases the node-sampling law (Zeng et al.,
eq. 2). Test accuracy comes from full-neighbour layer-wise inference.

Acceptance: on the planted-partition dataset the SAINT-trained model must
clear the feature-only Bayes accuracy, as the neighbour-sampling path
does.

It runs on the CUDA card unless ``--device`` names another (``--device
cpu`` runs the kernels' plain versions); with no card and no ``--device``
it raises.

    python -m examples.train_saint_torch --dataset planted:8000:6 --steps 300
    python -m examples.train_saint_torch --sampler rw --roots 256 --walk-length 3
"""

import argparse
import time

import numpy as np
import torch

from quiver_tpu_torch import Adj, SAINTEdgeSampler, SAINTNodeSampler, SAINTRandomWalkSampler
from quiver_tpu_torch.core.memory import resolve_device
from quiver_tpu_torch.datasets import load_dataset
from quiver_tpu_torch.models.inference import sage_layerwise_inference
from quiver_tpu_torch.models.sage import GraphSAGE
from quiver_tpu_torch.ops.sample import seeded_generator
from quiver_tpu_torch.parallel.train import init_model
from quiver_tpu_torch.sampling.saint import estimate_saint_norm


def subgraph_adjs(sub, num_layers: int):
    """Full subgraph message passing: the same square ``(C, C)`` Adj at
    every layer (every layer sees all induced edges, GraphSAINT's regime,
    against the neighbour sampler's shrinking frontiers)."""
    C = sub.node_id.shape[0]
    return [Adj(sub.edge_index, None, (C, C))] * num_layers


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="planted:8000:6")
    p.add_argument("--root", default=None)
    p.add_argument("--sampler", default="node", choices=["node", "edge", "rw"])
    p.add_argument("--budget", type=int, default=1024)
    p.add_argument("--roots", type=int, default=256)
    p.add_argument("--walk-length", type=int, default=3)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--norm-iters", type=int, default=30,
                   help="pre-sampling draws for the loss-normalization "
                   "estimate (0 disables normalization)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    """Train, then evaluate; returns ``(test accuracy, dataset)``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds = load_dataset(args.dataset, root=args.root)
    topo, n = ds.topo, ds.node_count
    print(f"{ds.name}: {n} nodes, {topo.edge_count} edges, "
          f"{ds.num_classes} classes")

    if args.sampler == "node":
        sampler = SAINTNodeSampler(topo, budget=args.budget, seed=args.seed,
                                   device=device)
    elif args.sampler == "edge":
        sampler = SAINTEdgeSampler(topo, budget=args.budget, seed=args.seed,
                                   device=device)
    else:
        sampler = SAINTRandomWalkSampler(
            topo, roots=args.roots, walk_length=args.walk_length,
            seed=args.seed, device=device,
        )

    # GraphSAINT loss normalisation: node_norm[v] ~ 1 / P(v in subgraph)
    if args.norm_iters > 0:
        norm, _ = estimate_saint_norm(sampler, num_iters=args.norm_iters)
        # nodes unseen in the pre-sampling draws report norm 0: default
        # them to 1 so they still train when they do appear
        norm = np.where(norm > 0, norm, 1.0).astype(np.float32)
        node_norm = torch.from_numpy(norm).to(device)
    else:
        node_norm = torch.ones(n, dtype=torch.float32, device=device)

    feats_all = torch.from_numpy(ds.features).to(device)
    labels_all = torch.from_numpy(ds.labels).to(device)
    train_mask_all = torch.zeros(n, dtype=torch.bool, device=device)
    train_mask_all[torch.as_tensor(ds.train_idx, device=device)] = True

    model = GraphSAGE(ds.feature_dim, args.hidden, ds.num_classes,
                      num_layers=args.layers)
    init_model(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)

    def step(sub, generator):
        ids = sub.node_id.clamp(min=0).to(torch.int64)
        x = feats_all[ids]
        labels = labels_all[ids].to(torch.int64)
        # loss over the subgraph's train nodes, weighted by the SAINT norm
        w = ((sub.node_id >= 0) & train_mask_all[ids]).float() * node_norm[ids]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logp = model(x, subgraph_adjs(sub, args.layers), generator)
        ll = torch.gather(logp, 1, labels[:, None])[:, 0]
        loss = -(ll * w).sum() / w.sum().clamp(min=1.0)
        loss.backward()
        optimizer.step()
        return loss.detach()

    t0 = time.time()
    for i in range(args.steps):
        loss = step(sampler.sample(), seeded_generator(device, args.seed, 1000 + i))
        if (i + 1) % 50 == 0:
            print(f"Step {i + 1:4d}, Loss: {float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)")

    # test accuracy by full-neighbour layer-wise inference over all nodes
    logp = sage_layerwise_inference(model, topo, feats_all, device=device)
    test_idx = torch.as_tensor(ds.test_idx, device=device)
    pred = logp[test_idx].argmax(dim=-1)
    acc = float((pred == labels_all[test_idx]).float().mean())
    line = f"Test Acc: {acc:.4f}"
    if "feature_bayes_acc" in ds.meta:
        line += f" (feature-only Bayes: {ds.meta['feature_bayes_acc']:.4f})"
    print(line)
    return acc, ds


if __name__ == "__main__":
    main()
