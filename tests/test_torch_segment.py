"""The segment mean's plain version (``ops/kernels/segment.py``) on the CPU:
what the CPU's layer-wise passes run, and the reference the card's kernel
is held to bitwise in ``tests/test_torch_cuda.py``.

Tolerance: against a float64 mean, 1e-5 relative to the row's mean |x|
(a float32 sum of n terms in any order is within n x 2^-24 of its sum of
|x|, and the rows here are short); across chunk sizes, bitwise (the CPU's
``index_add_`` adds a row's edges one after another in CSR order, so the
chunks do not change a sum).
"""

import numpy as np
import pytest
import torch

from quiver_tpu_torch.ops.kernels.segment import segment_mean, segment_mean_plain


def _csr(seed: int, n: int = 400):
    """A CSR of ``n`` rows with degrees 0-30 (a run of zero-degree rows)
    over an ``n``-row table."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 31, n)
    deg[50:60] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return torch.from_numpy(indptr), torch.from_numpy(indices)


@pytest.mark.parametrize("F", [1, 3, 100])
def test_plain_is_the_mean_of_each_row(F):
    indptr, indices = _csr(F)
    rng = np.random.default_rng(F + 1)
    table = rng.normal(size=(400, F)).astype(np.float32)
    got = segment_mean_plain(indptr, indices, torch.from_numpy(table))
    ptr, ids = indptr.numpy(), indices.numpy()
    for r in range(400):
        rows = table[ids[ptr[r]:ptr[r + 1]]].astype(np.float64)
        want = rows.mean(0) if rows.shape[0] else np.zeros(F)
        scale = np.abs(rows).mean() if rows.shape[0] else 1.0
        assert np.abs(got[r].numpy() - want).max() <= 1e-5 * scale, r
    assert not got[50:60].any()


@pytest.mark.parametrize("F", [2, 33])
def test_plain_bitwise_across_chunk_sizes(F):
    indptr, indices = _csr(F + 7)
    table = torch.from_numpy(np.random.default_rng(F).normal(
        size=(400, F)).astype(np.float32) * 10.0 ** np.random.default_rng(0).uniform(
        -3, 3, (400, 1)).astype(np.float32))
    whole = segment_mean_plain(indptr, indices, table)
    for chunk in (7, 64, 1000):
        assert torch.equal(segment_mean_plain(indptr, indices, table, chunk), whole)


def test_cpu_table_takes_the_plain_version_and_counts_nothing():
    indptr, indices = _csr(3)
    table = torch.randn(400, 5)
    before = segment_mean.launches
    got = segment_mean(indptr, indices, table, 16)
    assert segment_mean.launches == before
    assert torch.equal(got, segment_mean_plain(indptr, indices, table, 16))
    assert got.shape == (400, 5) and got.dtype == torch.float32


def test_plain_keeps_a_16bit_dtype_and_empty_edges():
    indptr = torch.zeros(6, dtype=torch.int64)
    indices = torch.zeros(0, dtype=torch.int32)
    table = torch.randn(4, 3).to(torch.bfloat16)
    got = segment_mean_plain(indptr, indices, table)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 3) and not got.any()
