"""quiver_tpu_torch.datasets against quiver_tpu.datasets.

Both are numpy, so the same seed (or the same files on disk) must give the
same arrays. Tolerance: bitwise for every array (features included, same
dtype), every split, the meta and the topology's ``indptr``/``indices``/
``eid``; ``feature_bayes_accuracy`` exactly equal.

The on-disk fixtures are the port's own copies of the writers of
``tests/test_datasets.py``: a PyG Reddit ``npz`` pair and an OGB raw
gzip-CSV tree.
"""

import gzip
import os

import numpy as np
import pytest

import quiver_tpu.datasets as dj
import quiver_tpu_torch.datasets as dt


def _assert_same_dataset(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    for field in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert dict(a.meta) == dict(b.meta)
    for field in ("indptr", "indices", "eid"):
        x, y = getattr(a.topo, field), getattr(b.topo, field)
        if x is None:
            assert y is None, field
            continue
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("n,classes", [(1500, 5), (4000, 8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_planted_partition_bitwise(n, classes, seed):
    _assert_same_dataset(dt.planted_partition(n=n, num_classes=classes, seed=seed),
                         dj.planted_partition(n=n, num_classes=classes, seed=seed))


def test_load_dataset_planted_dispatch():
    _assert_same_dataset(dt.load_dataset("planted:1200:3"),
                         dj.load_dataset("planted:1200:3"))
    with pytest.raises(ValueError, match="root"):
        dt.load_dataset("reddit")
    with pytest.raises(ValueError, match="unknown"):
        dt.load_dataset("cora", root="/nonexistent")


@pytest.mark.parametrize("classes,noise,seed", [(4, 0.3, 0), (8, 2.0, 1), (41, 1.0, 7)])
def test_feature_bayes_accuracy_equal(classes, noise, seed):
    assert (dt.feature_bayes_accuracy(classes, noise, trials=20_000, seed=seed)
            == dj.feature_bayes_accuracy(classes, noise, trials=20_000, seed=seed))


def _write_reddit_fixture(root, n=60, f=9, classes=4, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, f)).astype(np.float32)
    label = rng.integers(0, classes, n)
    types = rng.choice([1, 2, 3], n, p=[0.6, 0.2, 0.2])
    np.savez(os.path.join(root, "reddit_data.npz"),
             feature=feat, label=label, node_types=types)
    m = 300
    adj = sp.coo_matrix(
        (np.ones(m), (rng.integers(0, n, m), rng.integers(0, n, m))),
        shape=(n, n),
    ).tocsr()
    sp.save_npz(os.path.join(root, "reddit_graph.npz"), adj)


def _write_csv_gz(path, arr):
    with gzip.open(path, "wt") as fh:
        for row in np.atleast_2d(arr.T if arr.ndim == 1 else arr):
            fh.write(",".join(str(v) for v in np.atleast_1d(row)) + "\n")


def _write_ogb_fixture(base, n=40, f=5, e=120, seed=3):
    rng = np.random.default_rng(seed)
    (base / "raw").mkdir(parents=True)
    (base / "split" / "sales").mkdir(parents=True)
    _write_csv_gz(base / "raw" / "edge.csv.gz", rng.integers(0, n, (e, 2)))
    _write_csv_gz(base / "raw" / "node-feat.csv.gz",
                  rng.normal(size=(n, f)).astype(np.float32))
    _write_csv_gz(base / "raw" / "node-label.csv.gz", rng.integers(0, 3, n)[:, None])
    perm = rng.permutation(n)
    for name, part in (("train", perm[:20]), ("valid", perm[20:30]), ("test", perm[30:])):
        _write_csv_gz(base / "split" / "sales" / f"{name}.csv.gz", part[:, None])


@pytest.mark.parametrize("seed", [0, 4])
def test_load_reddit_equal(tmp_path, seed):
    _write_reddit_fixture(str(tmp_path), seed=seed)
    _assert_same_dataset(dt.load_reddit(str(tmp_path)), dj.load_reddit(str(tmp_path)))


@pytest.mark.parametrize("undirected", [True, False])
def test_load_ogb_raw_equal(tmp_path, undirected):
    base = tmp_path / "ogbn_toy"
    _write_ogb_fixture(base)
    got = dt.load_ogb_raw("ogbn-toy", str(base), undirected=undirected)
    _assert_same_dataset(got, dj.load_ogb_raw("ogbn-toy", str(base),
                                              undirected=undirected))
    assert got.topo.edge_count == (240 if undirected else 120)
    # resolved from the parent directory by name, as the JAX loader does
    _assert_same_dataset(dt.load_dataset("ogbn-toy", root=str(tmp_path)),
                         dj.load_dataset("ogbn-toy", root=str(tmp_path)))


def test_load_ogb_raw_missing_layout(tmp_path):
    with pytest.raises(FileNotFoundError, match="raw"):
        dt.load_ogb_raw("ogbn-toy", str(tmp_path))
