"""Single-card GraphSAGE training with quiver_tpu_torch (PyTorch/CUDA).

The torch twin of ``examples/train_sage.py``, with the same flags and the
same progress lines: build the topology, a [25, 10] neighbour sampler with
auto frontier caps, a 20%-cached feature store (hot rows on the card, cold
rows pinned on the host and read over UVA), a 2-layer GraphSAGE; train
with Adam and print "Epoch xx, Loss ..., Approx. Train Acc ...", then the
held-out test accuracy.

Datasets (quiver_tpu_torch.datasets):
    --dataset synthetic            random power-law graph, random labels
                                   (a throughput exercise; accuracy ~1/C)
    --dataset planted[:n[:C]]      stochastic-block-model acceptance graph:
                                   test accuracy must clear the
                                   feature-only Bayes accuracy by a margin
    --dataset reddit --root DIR    PyG Reddit npz layout
    --dataset ogbn-products --root DIR   OGB raw CSV layout

It runs on the CUDA card unless ``--device`` names another (``--device
cpu`` runs the kernels' plain versions); with no card and no ``--device``
it raises. ``--int8`` stores the features as int8 codes under the same
byte budget (about four times the rows on the card). ``--save-dir``
checkpoints the model and Adam state after each epoch into an atomic
manifest store (``quiver_tpu_torch.utils.checkpoint.Checkpointer``) and
resumes from its latest checkpoint, as the JAX twin does: the epochs up
to the checkpoint are skipped, and the dropout generators' step count
starts again at 0.

    python -m examples.train_sage_torch --dataset planted:20000 --epochs 4
    python -m examples.train_sage_torch --dataset planted:4000:6 --device cpu \\
        --epochs 8 --batch 256 --hidden 64 --fanout 10 5 --feature-dim 6
"""

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from quiver_tpu_torch import CSRTopo, Feature, GraphSageSampler
from quiver_tpu_torch.core.memory import resolve_device
from quiver_tpu_torch.datasets import GraphDataset, load_dataset
from quiver_tpu_torch.models.sage import GraphSAGE
from quiver_tpu_torch.ops.sample import seeded_generator
from quiver_tpu_torch.parallel.train import (init_model, make_eval_step,
                                             make_train_step)
from quiver_tpu_torch.utils.checkpoint import Checkpointer
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph


def synthetic_dataset(args) -> GraphDataset:
    rng = np.random.default_rng(args.seed)
    topo = CSRTopo(
        edge_index=generate_pareto_graph(args.nodes, args.avg_degree, seed=args.seed)
    )
    n = topo.node_count
    labels = rng.integers(0, args.classes, n).astype(np.int32)
    feat = rng.normal(size=(n, args.feature_dim)).astype(np.float32)
    perm = rng.permutation(n)
    return GraphDataset(
        name="synthetic", topo=topo, features=feat, labels=labels,
        train_idx=perm[: n // 10], val_idx=perm[n // 10 : n // 5],
        test_idx=perm[n // 5 : n // 2], num_classes=args.classes,
    )


def evaluate_layerwise(model, topo, feature, labels_all, idx, device):
    """Full-neighbour layer-wise inference over the whole graph (the
    reference's ``model.inference`` evaluation). Features are read back out
    of the tiered store in blocks, so the cold tier is read too."""
    from quiver_tpu_torch.models.inference import sage_layerwise_inference

    n, _ = feature.shape
    block = 65536
    x_all = torch.cat([
        feature[torch.arange(lo, min(lo + block, n), device=device)]
        for lo in range(0, n, block)
    ])
    logp = sage_layerwise_inference(model, topo, x_all, device=device)
    idx = torch.as_tensor(idx, device=device)
    pred = logp[idx].argmax(dim=-1)
    return float((pred == labels_all[idx]).float().mean())


def evaluate(sampler, feature, eval_step, labels_all, idx, batch):
    """Batched accuracy over a node-id split."""
    correct = total = 0
    for lo in range(0, len(idx), batch):
        seeds = idx[lo : lo + batch]
        out = sampler.sample(seeds)
        x = feature[out.n_id]
        # logits span the padded seed capacity; lanes past batch_size hold
        # frontier nodes (not -1), so mask by the true batch size
        cap = out.adjs[-1].size[1]
        seed_ids = out.n_id[:cap]
        labels = labels_all[seed_ids.clamp(min=0)]
        mask = ((torch.arange(cap, device=seed_ids.device) < out.batch_size)
                & (seed_ids >= 0))
        c, t = eval_step(x, out.adjs, labels, mask)
        correct += int(c)
        total += int(t)
    return correct / max(total, 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | planted[:n[:C]] | reddit | ogbn-* ")
    p.add_argument("--root", default=None, help="on-disk dataset directory")
    p.add_argument("--nodes", type=int, default=232_965)  # Reddit scale
    p.add_argument("--avg-degree", type=float, default=100.0)
    p.add_argument("--feature-dim", type=int, default=602)  # Reddit: 602
    p.add_argument("--classes", type=int, default=41)  # Reddit: 41
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--fanout", type=int, nargs="+", default=[25, 10])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--cache-ratio", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 feature storage + mixed-precision model compute",
    )
    p.add_argument(
        "--int8", action="store_true",
        help="int8 feature storage (per-row absmax codes and float32 scales; "
        "lookups return float32) under the same byte budget",
    )
    p.add_argument(
        "--save-dir", default=None,
        help="checkpoint directory (atomic manifest Checkpointer): training "
        "resumes from the latest checkpoint there and saves each epoch",
    )
    p.add_argument(
        "--eval", default="sampled", choices=["sampled", "layerwise"],
        help="test-time evaluation: batched sampled fanout (fast) or "
        "full-neighbour layer-wise inference over all edges",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def setup(args, budget=None):
    """The dataset, feature store, sampler, model, optimizer and steps of
    a run, the model initialised from ``--seed`` and the auto caps planned
    on the first training batch. ``budget`` overrides the feature store's
    byte budget (by default ``--cache-ratio`` of the rows at 4 B per
    element). Returns a namespace of them."""
    if args.bf16 and args.int8:
        raise ValueError("--bf16 and --int8 are two storage dtypes; pick one")
    device = resolve_device(args.device)
    if args.dataset == "synthetic":
        ds = synthetic_dataset(args)
    else:
        ds = load_dataset(args.dataset, root=args.root)
    topo, n = ds.topo, ds.node_count
    print(f"{ds.name}: {n} nodes, {topo.edge_count} edges, "
          f"{ds.feature_dim} features, {ds.num_classes} classes, "
          f"{len(ds.train_idx)} train / {len(ds.test_idx)} test")

    # degree-ordered cache of cache_ratio of the rows; the rest pinned
    if budget is None:
        budget = int(args.cache_ratio * n) * ds.feature_dim * 4
    feature = Feature(
        device_cache_size=budget, csr_topo=topo,
        dtype="bfloat16" if args.bf16 else ("int8" if args.int8 else None),
        device=device,
    ).from_cpu_tensor(ds.features)
    feature_dim = ds.feature_dim
    # drop the source array: the tiered store holds the only copy now
    ds = ds._replace(features=None)
    labels_all = torch.from_numpy(ds.labels).to(device)

    sampler = GraphSageSampler(topo, args.fanout, device=device,
                               seed_capacity=args.batch, seed=args.seed,
                               frontier_caps="auto")
    model = GraphSAGE(feature_dim, args.hidden, ds.num_classes,
                      num_layers=len(args.fanout),
                      dtype="bfloat16" if args.bf16 else None)
    # drawn on the host, so every device starts from the same parameters
    init_model(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    # the JAX twin samples a first batch to shape its parameters; here it
    # plans the auto caps, and keeps the sampler's call count the same
    sampler.sample(np.asarray(ds.train_idx)[: args.batch])
    return SimpleNamespace(
        device=device, ds=ds, topo=topo, feature=feature,
        labels_all=labels_all, sampler=sampler, model=model,
        optimizer=optimizer, train_step=make_train_step(model, optimizer),
        eval_step=make_eval_step(model))


def batch_inputs(run, seeds):
    """``(out, x, labels, mask)`` of one training batch of ``seeds``."""
    out = run.sampler.sample(seeds)
    x = run.feature[out.n_id]
    seed_ids = out.n_id[: len(seeds)]
    labels = run.labels_all[seed_ids.clamp(min=0)]
    return out, x, labels, seed_ids >= 0


def main(argv=None):
    args = parse_args(argv)
    run = setup(args)
    ds = run.ds
    train_idx = np.asarray(ds.train_idx)

    ckpt = start_epoch = None
    if args.save_dir:
        ckpt = Checkpointer(args.save_dir)
        start_epoch = ckpt.latest_step()
        if start_epoch is not None:
            state = ckpt.restore()
            run.model.load_state_dict(state["params"])
            run.optimizer.load_state_dict(state["opt_state"])
            print(f"resumed from {args.save_dir} at epoch {start_epoch}")

    step_i = 0
    for epoch in range(1, args.epochs + 1):
        if start_epoch is not None and epoch <= start_epoch:
            continue  # already trained in a previous run
        t0 = time.time()
        order = np.random.default_rng(epoch).permutation(train_idx)
        losses, correct, total = [], 0, 0
        for lo in range(0, len(order) - args.batch + 1, args.batch):
            out, x, labels, mask = batch_inputs(run, order[lo : lo + args.batch])
            loss = run.train_step(x, out.adjs, labels, mask,
                                  seeded_generator(run.device, args.seed, step_i))
            losses.append(float(loss))
            c, t = run.eval_step(x, out.adjs, labels, mask)
            correct += int(c)
            total += int(t)
            step_i += 1
        print(
            f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
            f"Approx. Train Acc: {correct / max(total, 1):.4f} "
            f"({time.time() - t0:.1f}s)"
        )
        if ckpt is not None:
            ckpt.save(epoch, {"params": run.model.state_dict(),
                              "opt_state": run.optimizer.state_dict()})

    if ckpt is not None:
        ckpt.close()  # waits for the last save

    if args.eval == "layerwise":
        test_acc = evaluate_layerwise(
            run.model, run.topo, run.feature, run.labels_all,
            np.asarray(ds.test_idx), run.device,
        )
    else:
        test_acc = evaluate(
            run.sampler, run.feature, run.eval_step, run.labels_all,
            np.asarray(ds.test_idx), args.batch,
        )
    line = f"Test Acc: {test_acc:.4f}"
    if "feature_bayes_acc" in ds.meta:
        line += f" (feature-only Bayes: {ds.meta['feature_bayes_acc']:.4f})"
    print(line)
    return test_acc, ds


if __name__ == "__main__":
    main()
