"""The native host runtime of quiver_tpu_torch (``native/``) against
quiver_tpu's native library and against numpy, on the CPU.

The twins of ``tests/test_native.py``'s ten tests, then the cross-package
cases: ``csr_from_coo``, ``gather_rows``, ``reindex`` and
``sample_neighbors`` against the JAX package's library on the same
inputs; ``CSRTopo`` and ``HeteroCSRTopo`` built natively against their
numpy builds for int32 and int64 COO; the OpenMP thread count (1 and 4,
each in a subprocess) against the draws; and a build from an empty build
directory.

Tolerance: bitwise everywhere (integer CSR arrays, eids, sampled ids,
frontiers, gathered rows), dtypes included.
"""

import hashlib
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu import native as native_j  # noqa: E402
from quiver_tpu.core.hetero import HeteroCSRTopo as HeteroCSRTopoJ  # noqa: E402

from quiver_tpu_torch import native  # noqa: E402
from quiver_tpu_torch.core.hetero import HeteroCSRTopo  # noqa: E402
from quiver_tpu_torch.core.topology import CSRTopo  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no C++ toolchain to build the native library")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# -- the twins of tests/test_native.py ---------------------------------------------


def test_csr_from_coo_matches_numpy():
    rng = np.random.default_rng(0)
    n, e = 200, 2000
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    indptr, indices, eid = native.csr_from_coo(rows, cols, n)
    expect_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=expect_ptr[1:])
    assert np.array_equal(indptr, expect_ptr)
    # stable: slots within a row follow COO order exactly
    for v in range(n):
        lo, hi = indptr[v], indptr[v + 1]
        assert indices[lo:hi].tolist() == cols[rows == v].tolist()
    assert np.array_equal(rows[eid], np.repeat(np.arange(n), np.diff(indptr)))
    assert np.array_equal(cols[eid], indices)
    indptr2, indices2, eid2 = native.csr_from_coo(rows, cols, n)
    assert np.array_equal(indices, indices2) and np.array_equal(eid, eid2)
    assert (indptr.dtype, indices.dtype, eid.dtype) == (np.int64, np.int32, np.int64)


def test_csr_int32_entry_point():
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 50, 300).astype(np.int32)
    cols = rng.integers(0, 50, 300).astype(np.int32)
    indptr, indices, eid = native.csr_from_coo(rows, cols, 50)
    assert indptr[-1] == 300
    assert np.array_equal(cols[eid], indices)
    _, _, none = native.csr_from_coo(rows, cols, 50, with_eid=False)
    assert none is None
    with pytest.raises(ValueError, match="2\\^31"):
        native.csr_from_coo(rows, cols, 2**31)


def test_gather_rows_matches_numpy():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(500, 64)).astype(np.float32)
    ids = rng.integers(0, 500, 200)
    assert np.array_equal(native.gather_rows(table, ids), table[ids])


def test_gather_rows_sentinels():
    table = np.arange(20, dtype=np.float32).reshape(10, 2)
    out = native.gather_rows(table, np.array([3, -1, 9, 100]))
    assert np.array_equal(out[0], table[3])
    assert np.all(out[1] == 0)
    assert np.array_equal(out[2], table[9])
    assert np.all(out[3] == 0)  # past the table: a zero row


def test_gather_rows_dtypes():
    for dtype in (np.float32, np.float64, np.int32):
        table = np.arange(24).reshape(6, 4).astype(dtype)
        out = native.gather_rows(table, np.array([5, 0]))
        assert _same(out, table[[5, 0]])


def test_native_sampler_validity():
    rng = np.random.default_rng(3)
    n, e = 100, 1500
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    indptr, indices, _ = native.csr_from_coo(rows, cols, n)
    seeds = rng.integers(0, n, 64).astype(np.int32)
    k = 5
    out, counts = native.sample_neighbors(indptr, indices, seeds, k, seed=7)
    for i, s in enumerate(seeds):
        deg = indptr[s + 1] - indptr[s]
        assert counts[i] == min(deg, k)
        row = set(indices[indptr[s]:indptr[s + 1]].tolist())
        got = out[i][out[i] >= 0]
        assert len(got) == counts[i]
        assert set(got.tolist()) <= row
        if deg > k:
            assert len(got) == k  # distinct positions
    out, counts = native.sample_neighbors(indptr, indices, np.array([-1], np.int32), k)
    assert counts[0] == 0 and np.all(out[0] == -1)


def test_csrtopo_uses_native_builder(monkeypatch):
    rng = np.random.default_rng(4)
    ei = np.stack([rng.integers(0, 30, 200), rng.integers(0, 30, 200)])
    calls = []
    inner = native.csr_from_coo
    monkeypatch.setattr(native, "csr_from_coo",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    t_native = CSRTopo(edge_index=ei, use_native=True)
    t_numpy = CSRTopo(edge_index=ei, use_native=False)
    assert calls == [1]  # only the native build called it
    assert np.array_equal(t_native.indptr, t_numpy.indptr)
    assert np.array_equal(t_native.indices, t_numpy.indices)


def test_csrtopo_rejects_negative_ids():
    ei = np.array([[0, 1, -1], [1, 2, 0]])
    with pytest.raises(ValueError, match="negative"):
        CSRTopo(edge_index=ei)


def test_native_reindex_matches_masked_unique():
    """The native hash reindex equals the port's sort-based
    ``reindex_layer`` (first-occurrence order, forced seed lanes, -1)."""
    from quiver_tpu_torch.ops.reindex import reindex_layer

    rng = np.random.default_rng(7)
    S, K = 40, 6
    seeds = rng.integers(0, 50, S).astype(np.int32)
    seeds[35:] = -1
    nbr = rng.integers(0, 50, (S, K)).astype(np.int32)
    nbr[rng.random((S, K)) < 0.3] = -1
    nbr[35:] = -1
    nf, ncol = native.reindex(seeds, nbr)
    f, nfr, col, ov = reindex_layer(torch.from_numpy(seeds), torch.tensor(35, dtype=torch.int32),
                                    torch.from_numpy(nbr), S * (K + 1))
    m = int(nfr)
    assert int(ov) == 0 and m == nf.shape[0]
    np.testing.assert_array_equal(f.numpy()[:m], nf)
    np.testing.assert_array_equal(col.numpy(), ncol)


def test_native_reindex_duplicate_seeds_forced():
    seeds = np.array([7, 7, 3], np.int32)
    nbr = np.array([[7, 3], [9, -1], [7, 9]], np.int32)
    f, col = native.reindex(seeds, nbr)
    # both 7 lanes kept; neighbours resolve to the first occurrence
    np.testing.assert_array_equal(f, [7, 7, 3, 9])
    np.testing.assert_array_equal(col, [[0, 2], [3, -1], [0, 3]])
    with pytest.raises(ValueError, match="seeds"):
        native.reindex(seeds[:2], nbr)


# -- against the JAX package's library ---------------------------------------------


requires_jax_native = pytest.mark.skipif(not native_j.available,
                                         reason="the JAX package's library did not build")


@requires_jax_native
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("with_eid", [True, False])
def test_csr_from_coo_equals_jax(dtype, with_eid):
    rng = np.random.default_rng(8)
    n, e = 1000, 40_000  # enough edges for every thread's chunk
    rows = rng.integers(0, n, e).astype(dtype)
    cols = rng.integers(0, n, e).astype(dtype)
    got = native.csr_from_coo(rows, cols, n, with_eid=with_eid)
    want = native_j.csr_from_coo(rows, cols, n, with_eid=with_eid)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _same(a, b)


@requires_jax_native
@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.float64])
def test_gather_rows_equals_jax(dtype):
    rng = np.random.default_rng(9)
    table = (rng.normal(size=(300, 7)) * 50).astype(dtype)
    ids = rng.integers(-3, 310, 500)
    assert _same(native.gather_rows(table, ids), native_j.gather_rows(table, ids))


@requires_jax_native
@pytest.mark.parametrize("seed", [0, 7, 2**40])
def test_sample_neighbors_equals_jax(seed):
    rng = np.random.default_rng(10)
    n = 400
    indptr, indices, _ = native.csr_from_coo(rng.integers(0, n, 12_000),
                                             rng.integers(0, n, 12_000), n)
    seeds = rng.integers(-1, n, 300).astype(np.int32)
    for k in (1, 5, 40):
        got = native.sample_neighbors(indptr, indices, seeds, k, seed=seed)
        want = native_j.sample_neighbors(indptr, indices, seeds, k, seed=seed)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


@requires_jax_native
def test_reindex_equals_jax():
    rng = np.random.default_rng(11)
    for S, K in ((1, 1), (64, 10), (200, 3)):
        seeds = rng.integers(-1, 80, S).astype(np.int32)
        nbr = rng.integers(-1, 80, (S, K)).astype(np.int32)
        got, want = native.reindex(seeds, nbr), native_j.reindex(seeds, nbr)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert native.num_threads() == native_j.num_threads() >= 1


# -- the topologies, native against numpy ----------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,e", [(300, 5000), (70_000, 20_000), (1, 0)])
def test_csrtopo_native_equals_numpy(dtype, n, e):
    """Both builds end in the same arrays and dtypes (``CSRTopo`` narrows
    the native int32 indices and numpy's COO-typed ones alike), and so
    does JAX's ``CSRTopo``."""
    from quiver_tpu import CSRTopo as CSRTopoJ

    rng = np.random.default_rng(12)
    ei = rng.integers(0, n, size=(2, e)).astype(dtype)
    if e:
        ei[:, -1] = n - 1  # node_count is n
    a, b = CSRTopo(edge_index=ei, use_native=True), CSRTopo(edge_index=ei, use_native=False)
    j = CSRTopoJ(edge_index=ei, use_native=True)
    for name in ("indptr", "indices", "eid"):
        assert _same(getattr(a, name), getattr(b, name)), name
        np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(j, name)))
    # the attributes follow eid, so they agree too
    w = rng.random(e)
    a.set_edge_weight(w)
    b.set_edge_weight(w)
    assert _same(a.cum_weights, b.cum_weights)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hetero_native_equals_numpy(dtype):
    """Every relation of a MAG-shaped typed graph: native and numpy builds
    give the same arrays and dtypes, and JAX's native build the same
    values."""
    rng = np.random.default_rng(13)
    num = {"paper": 3000, "author": 2000, "field": 50}
    edges = {
        ("author", "writes", "paper"): (2000, 3000, 9000),
        ("paper", "cites", "paper"): (3000, 3000, 12000),
        ("paper", "has_topic", "field"): (3000, 50, 6000),
        ("field", "rev_has_topic", "paper"): (50, 3000, 6000),
    }
    eid = {k: np.stack([rng.integers(0, s, m), rng.integers(0, d, m)]).astype(dtype)
           for k, (s, d, m) in edges.items()}
    a = HeteroCSRTopo(num, eid, use_native=True)
    b = HeteroCSRTopo(num, eid, use_native=False)
    j = HeteroCSRTopoJ(num, eid, use_native=True)
    for et in edges:
        for name in ("indptr", "indices", "eid"):
            x, y = getattr(a.relations[et], name), getattr(b.relations[et], name)
            assert _same(x, y), (et, name)
            np.testing.assert_array_equal(x, np.asarray(getattr(j.relations[et], name)))


def test_unavailable_library_falls_back_to_numpy(monkeypatch):
    """With no library, ``CSRTopo(use_native=True)`` builds with numpy."""
    rng = np.random.default_rng(14)
    ei = rng.integers(0, 90, size=(2, 800))
    want = CSRTopo(edge_index=ei, use_native=True)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.available is False and native.num_threads() == 0
    got = CSRTopo(edge_index=ei, use_native=True)
    for name in ("indptr", "indices", "eid"):
        assert _same(getattr(got, name), getattr(want, name))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.csr_from_coo(ei[0], ei[1], 90)


# -- threads, builds ----------------------------------------------------------------

_DIGEST = """
import hashlib, numpy as np
from quiver_tpu_torch import native
rng = np.random.default_rng(15)
n = 5000
rows, cols = rng.integers(0, n, 300_000), rng.integers(0, n, 300_000)
h = hashlib.sha256()
indptr, indices, eid = native.csr_from_coo(rows, cols, n)
for a in (indptr, indices, eid):
    h.update(a.tobytes())
out, counts = native.sample_neighbors(indptr, indices, rng.integers(0, n, 4000), 7, seed=3)
h.update(out.tobytes()); h.update(counts.tobytes())
print(native.num_threads(), h.hexdigest())
"""


def test_thread_count_does_not_change_results():
    """``csr_from_coo`` and ``sample_neighbors`` under ``OMP_NUM_THREADS``
    1 and 4 (each in its own process) give the same bytes."""
    seen = {}
    for threads in ("1", "4"):
        env = dict(os.environ, OMP_NUM_THREADS=threads, PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", _DIGEST], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        n_threads, digest = out.stdout.split()
        assert n_threads == threads
        seen[threads] = digest
    assert seen["1"] == seen["4"]


def test_build_from_an_empty_directory(tmp_path, monkeypatch):
    """A build into an empty directory compiles the library under its
    digest name, through a temporary file, and a second build reuses it;
    the library loads and builds the CSR."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    first = native.build()
    assert os.path.dirname(first) == str(tmp_path / "b")
    assert os.path.basename(first).startswith("libquiver_host_")
    assert sorted(os.listdir(tmp_path / "b")) == [".lock", os.path.basename(first)]
    mtime = os.path.getmtime(first)
    assert native.build() == first and os.path.getmtime(first) == mtime
    lib = native._bind(first)
    rows = np.array([2, 0, 2, 1], np.int64)
    indptr = np.empty(4, np.int64)
    indices = np.empty(4, np.int32)
    lib.csr_from_coo_i64(native._ptr(rows, native.ctypes.c_int64),
                         native._ptr(rows, native.ctypes.c_int64), 4, 3,
                         native._ptr(indptr, native.ctypes.c_int64),
                         native._ptr(indices, native.ctypes.c_int32), None)
    assert indptr.tolist() == [0, 1, 2, 4] and indices.tolist() == [0, 1, 2, 2]
    # the digest names the source and the flags
    h = hashlib.sha256(open(native._SRC, "rb").read())
    h.update(" ".join(native.FLAGS).encode())
    assert h.hexdigest()[:16] in first and "-march=native" not in native.FLAGS


def test_out_of_range_inputs_are_refused():
    """Ids the native code would index out of bounds with raise first."""
    rows, cols = np.array([0, 3]), np.array([1, 2])
    for r, c, needle in [(rows, cols, r"rows must lie in \[0, 3\)"),
                         (-rows, cols, "rows must"),
                         (rows[:1], cols[:1] - 5, "cols must"),
                         (rows, cols[:1], "differ")]:
        with pytest.raises(ValueError, match=needle):
            native.csr_from_coo(r, c, 3)
    indptr, indices, _ = native.csr_from_coo(np.array([0, 1]), np.array([1, 0]), 2)
    with pytest.raises(ValueError, match="below 2"):
        native.sample_neighbors(indptr, indices, np.array([2], np.int32), 1)
    with pytest.raises(ValueError, match="slots"):
        native.sample_neighbors(indptr, indices[:1], np.array([0], np.int32), 1)


def test_build_failure_is_logged_once(tmp_path, monkeypatch):
    """A source the compiler refuses: ``build`` raises with the compiler's
    output, the loader logs it once and reports the library unavailable,
    and nothing is left in the build directory but the lock."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed") as err:
        native.build()
    assert "broken.cpp" in str(err.value)
    assert os.listdir(tmp_path / "b") == [".lock"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = trace.get_logger("native")
    logger.addHandler(handler)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    try:
        assert native.available is False and native.available is False
    finally:
        logger.removeHandler(handler)
    assert len(records) == 1 and "broken.cpp" in records[0].getMessage()
