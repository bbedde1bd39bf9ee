"""Dataset ingestion: real-graph loaders and a synthetic acceptance graph.

The port of ``quiver_tpu/datasets.py``. The loaders read the datasets'
standard on-disk layouts with numpy (no torch_geometric, no ogb package):

* ``load_ogb_raw``: the OGB raw CSV layout (``raw/edge.csv.gz``,
  ``node-feat.csv.gz``, ``node-label.csv.gz``, ``split/<scheme>/*.csv.gz``)
  that every ogbn-* download unpacks to.
* ``load_reddit``: the PyG Reddit layout (``reddit_data.npz`` and the
  scipy-sparse adjacency ``reddit_graph.npz``).
* ``planted_partition``: a stochastic-block-model graph with noisy one-hot
  features and a computable feature-only Bayes accuracy, the acceptance
  graph where no dataset can be downloaded: a correct sampler, feature
  store and model clear that accuracy by a wide margin, a broken one
  cannot.

Everything here is numpy, so the same seed gives bitwise the same arrays
as the JAX package. Every loader returns a :class:`GraphDataset` whose
``topo`` is the port's :class:`~.core.topology.CSRTopo`.
"""

from __future__ import annotations

import gzip
import os
import types
from typing import NamedTuple

import numpy as np

from .core.topology import CSRTopo

__all__ = [
    "GraphDataset",
    "feature_bayes_accuracy",
    "load_dataset",
    "load_ogb_raw",
    "load_reddit",
    "planted_partition",
]


class GraphDataset(NamedTuple):
    """Everything a training script needs: topology, features, labels and
    the canonical splits."""

    name: str
    topo: CSRTopo
    features: np.ndarray  # (N, F) float32
    labels: np.ndarray  # (N,) int32, -1 where unlabeled
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    # immutable default: a plain {} would be shared by every instance
    meta: dict = types.MappingProxyType({})

    @property
    def node_count(self) -> int:
        return self.topo.node_count

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]


def load_dataset(name: str, root: str | None = None, **kwargs) -> GraphDataset:
    """Dispatch by name: "reddit", "ogbn-*", or "planted[:n[:classes]]"."""
    if name.startswith("planted"):
        parts = name.split(":")
        n = int(parts[1]) if len(parts) > 1 else 10_000
        classes = int(parts[2]) if len(parts) > 2 else 8
        return planted_partition(n=n, num_classes=classes, **kwargs)
    if root is None:
        raise ValueError(
            f"dataset {name!r} needs root= pointing at its on-disk copy "
            "(downloads are not performed)"
        )
    if name == "reddit":
        return load_reddit(root)
    if name.startswith("ogbn-"):
        return load_ogb_raw(name, root, **kwargs)
    raise ValueError(f"unknown dataset {name!r}")


def _read_csv_gz(path, dtype) -> np.ndarray:
    """A headerless gzip CSV as a 2-D ``dtype`` array (one row per line)."""
    with gzip.open(path, "rt") as fh:
        return np.loadtxt(fh, delimiter=",", dtype=dtype, ndmin=2)


def load_ogb_raw(
    name: str, root: str, split_scheme: str | None = None, undirected: bool = True
) -> GraphDataset:
    """Load an ogbn-* dataset from its raw CSV layout.

    ``root`` is the directory holding ``raw/`` and ``split/`` (what the ogb
    package unpacks, e.g. ``<root>/ogbn_products``), or its parent.
    ``undirected=True`` symmetrises the edge list, as PyG/ogb's
    ToUndirected does for products.
    """
    base = root
    if not os.path.isdir(os.path.join(base, "raw")):
        cand = os.path.join(root, name.replace("-", "_"))
        if os.path.isdir(os.path.join(cand, "raw")):
            base = cand
        else:
            raise FileNotFoundError(
                f"no raw/ under {root} (or {cand}): point root at the "
                "unpacked ogb dataset directory"
            )
    raw = os.path.join(base, "raw")
    edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T  # (2, E)
    feat = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    labels = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.int64).ravel()
    if undirected:
        edges = np.concatenate([edges, edges[::-1]], axis=1)

    split_dir = os.path.join(base, "split")
    if split_scheme is None:
        schemes = sorted(os.listdir(split_dir)) if os.path.isdir(split_dir) else []
        if not schemes:
            raise FileNotFoundError(f"no split/ under {base}")
        split_scheme = schemes[0]
    sdir = os.path.join(split_dir, split_scheme)
    train_idx = _read_csv_gz(os.path.join(sdir, "train.csv.gz"), np.int64).ravel()
    val_idx = _read_csv_gz(os.path.join(sdir, "valid.csv.gz"), np.int64).ravel()
    test_idx = _read_csv_gz(os.path.join(sdir, "test.csv.gz"), np.int64).ravel()

    return GraphDataset(
        name=name,
        topo=CSRTopo(edge_index=edges),
        features=feat,
        labels=labels.astype(np.int32),
        train_idx=train_idx,
        val_idx=val_idx,
        test_idx=test_idx,
        num_classes=int(labels.max()) + 1,
        meta={"split_scheme": split_scheme, "undirected": undirected},
    )


def load_reddit(root: str) -> GraphDataset:
    """Load Reddit from the PyG raw layout: ``reddit_data.npz`` (feature,
    label, node_types: 1=train, 2=val, 3=test) and ``reddit_graph.npz``
    (scipy sparse adjacency)."""
    import scipy.sparse as sp

    data = np.load(os.path.join(root, "reddit_data.npz"))
    adj = sp.load_npz(os.path.join(root, "reddit_graph.npz")).tocsr()
    node_types = data["node_types"]
    labels = data["label"].astype(np.int32)
    topo = CSRTopo(indptr=adj.indptr.astype(np.int64),
                   indices=adj.indices.astype(np.int64))
    return GraphDataset(
        name="reddit",
        topo=topo,
        features=data["feature"].astype(np.float32),
        labels=labels,
        train_idx=np.where(node_types == 1)[0],
        val_idx=np.where(node_types == 2)[0],
        test_idx=np.where(node_types == 3)[0],
        num_classes=int(labels.max()) + 1,
    )


def planted_partition(
    n: int = 10_000,
    num_classes: int = 8,
    avg_degree: float = 12.0,
    homophily: float = 0.9,
    feature_noise: float = 2.0,
    feature_dim: int | None = None,
    train_frac: float = 0.5,
    val_frac: float = 0.1,
    seed: int = 0,
) -> GraphDataset:
    """Stochastic-block-model graph with noisy one-hot features.

    Each node gets a uniform class; each edge picks its endpoint from the
    source's class with probability ``homophily``, else uniformly. Features
    are ``onehot(label) + N(0, feature_noise)``: weak alone, so a model
    must aggregate neighbourhoods to do well. ``meta["feature_bayes_acc"]``
    carries the Monte-Carlo feature-only Bayes accuracy
    (:func:`feature_bayes_accuracy`).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    feature_dim = feature_dim or num_classes

    m = int(n * avg_degree)
    src = rng.integers(0, n, m)
    same = rng.random(m) < homophily
    class_pool = [np.where(labels == c)[0] for c in range(num_classes)]
    dst = np.empty(m, dtype=np.int64)
    for c in range(num_classes):
        lane = same & (labels[src] == c)
        pool = class_pool[c]
        dst[lane] = pool[rng.integers(0, len(pool), int(lane.sum()))]
    rand_lane = ~same
    dst[rand_lane] = rng.integers(0, n, int(rand_lane.sum()))
    ei = np.stack([src, dst])
    ei = np.concatenate([ei, ei[::-1]], axis=1)  # undirected

    feat = np.zeros((n, feature_dim), np.float32)
    feat[np.arange(n), labels % feature_dim] = 1.0
    feat += rng.normal(scale=feature_noise, size=(n, feature_dim)).astype(
        np.float32
    )

    perm = rng.permutation(n)
    n_train = int(n * train_frac)
    n_val = int(n * val_frac)
    bayes = feature_bayes_accuracy(num_classes, feature_noise, seed=seed + 1)
    return GraphDataset(
        name=f"planted:{n}:{num_classes}",
        topo=CSRTopo(edge_index=ei),
        features=feat,
        labels=labels,
        train_idx=perm[:n_train],
        val_idx=perm[n_train:n_train + n_val],
        test_idx=perm[n_train + n_val:],
        num_classes=num_classes,
        meta={
            "homophily": homophily,
            "feature_noise": feature_noise,
            "feature_bayes_acc": bayes,
        },
    )


def feature_bayes_accuracy(
    num_classes: int, noise: float, trials: int = 200_000, seed: int = 0
) -> float:
    """Monte-Carlo accuracy of the feature-only Bayes classifier of the
    planted-partition model (argmax of onehot + N(0, noise): the best rule
    given one node's features and no graph)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=noise, size=(trials, num_classes))
    x[:, 0] += 1.0  # true class 0 by symmetry
    return float((np.argmax(x, axis=1) == 0).mean())
