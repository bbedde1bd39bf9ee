"""The out-of-core tier of quiver_tpu_torch against quiver_tpu: the raw
on-disk format, ``CSRTopo.save``/``load``, ``AsyncStager`` and
``MmapFeatureStore`` (twins of ``tests/test_ooc.py``), and files written
by one package loaded by the other.

Everything runs on the CPU (``device="cpu"``): a store's lookup there is
K2's plain version (``kernel="pallas"``) or the stock lookup (``"auto"``),
both bitwise K2 on the card (``tests/test_torch_cuda.py -k ooc`` holds the
launch there).

Tolerances: none. Arrays loaded across packages, gathers against the
in-RAM ``Feature`` (f32 and int8, ``mmap`` and ``pread``, padding lanes,
repeated ids, after a ``restage``) and an epoch's losses against the
in-RAM epoch's are all bitwise.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
import quiver_tpu.ooc as ooc_j  # noqa: E402
import quiver_tpu.resilience as resilience_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
import quiver_tpu_torch.ooc as ooc_t  # noqa: E402
import quiver_tpu_torch.resilience as resilience_t  # noqa: E402
from quiver_tpu_torch import CSRTopo, Feature, GraphSageSampler  # noqa: E402
from quiver_tpu_torch.ooc import (  # noqa: E402
    AsyncStager,
    CorruptRawDir,
    MmapFeatureStore,
    load_raw_dir,
    quarantine_raw_dir,
    save_raw_dir,
    verify_raw_dir,
)


def _graph(n=200, deg=6, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, deg * n)).astype(np.int64)
    feat = rng.standard_normal((n, 16)).astype(np.float32)
    return ei, feat


# -- export tables ----------------------------------------------------------------

# the top-level names still missing are the streaming layer's (ROADMAP A.12c)
NOT_PORTED = {"top": {"CommitAborted", "DeltaBatch", "DeltaRejected", "StreamingGraph"},
              "ooc": set(), "resilience": set()}


@pytest.mark.parametrize("pkg,jax_pkg,torch_pkg", [
    ("top", qj, qt), ("ooc", ooc_j, ooc_t), ("resilience", resilience_j, resilience_t)])
def test_export_tables(pkg, jax_pkg, torch_pkg):
    for name in torch_pkg.__all__:
        assert getattr(torch_pkg, name) is not None, name
    assert set(jax_pkg.__all__) - set(torch_pkg.__all__) == NOT_PORTED[pkg]
    assert ooc_t.RAW_FORMAT == ooc_j.RAW_FORMAT
    assert qt.MmapFeatureStore is MmapFeatureStore


# -- raw format ---------------------------------------------------------------


def test_raw_dir_roundtrip_and_verify(tmp_path):
    p = str(tmp_path / "raw")
    arrays = {
        "a": np.arange(100, dtype=np.int64),
        "b": np.random.default_rng(0).random((10, 4)).astype(np.float32),
    }
    manifest = save_raw_dir(p, arrays, meta={"k": "v"})
    assert set(manifest["arrays"]) == {"a", "b"}
    for mmap in (False, True):
        loaded, meta = load_raw_dir(p, mmap=mmap)
        assert meta == {"k": "v"}
        for name in arrays:
            np.testing.assert_array_equal(np.asarray(loaded[name]), arrays[name])
    verify_raw_dir(p)  # the full CRC sweep passes


def test_raw_dir_replaces_existing_atomically(tmp_path):
    p = str(tmp_path / "raw")
    save_raw_dir(p, {"a": np.zeros(4)})
    save_raw_dir(p, {"a": np.ones(4)})
    loaded, _ = load_raw_dir(p, mmap=False)
    np.testing.assert_array_equal(np.asarray(loaded["a"]), np.ones(4))
    # no temporary or old directory survives the replace
    assert sorted(os.listdir(tmp_path)) == ["raw"]


def test_torn_raw_dir_detected_and_quarantined(tmp_path):
    p = str(tmp_path / "raw")
    save_raw_dir(p, {"a": np.arange(1000, dtype=np.float64)})
    fpath = os.path.join(p, "a.npy")
    with open(fpath, "r+b") as fh:
        fh.truncate(os.path.getsize(fpath) - 16)  # a torn write
    with pytest.raises(CorruptRawDir, match="truncated or torn"):
        load_raw_dir(p, mmap=True)
    dest = quarantine_raw_dir(p)
    assert not os.path.exists(p)
    assert os.path.basename(dest).startswith("quarantine-")


def test_raw_dir_crc_catches_flipped_bytes(tmp_path):
    p = str(tmp_path / "raw")
    save_raw_dir(p, {"a": np.arange(1000, dtype=np.float64)})
    fpath = os.path.join(p, "a.npy")
    size = os.path.getsize(fpath)
    with open(fpath, "r+b") as fh:  # the same size, other bytes
        fh.seek(size // 2)
        fh.write(b"\xff\xfe")
    load_raw_dir(p, mmap=True)  # the structural checks alone cannot see it
    with pytest.raises(CorruptRawDir, match="checksum mismatch"):
        verify_raw_dir(p)


def test_uncommitted_raw_dir_rejected(tmp_path):
    p = str(tmp_path / "raw")
    save_raw_dir(p, {"a": np.zeros(4)})
    os.unlink(os.path.join(p, "COMMIT"))
    with pytest.raises(CorruptRawDir, match="COMMIT"):
        load_raw_dir(p)


_SAVERS = {"jax": ooc_j.save_raw_dir, "torch": save_raw_dir}
_LOADERS = {"jax": ooc_j.load_raw_dir, "torch": load_raw_dir}
_VERIFIERS = {"jax": (ooc_j.verify_raw_dir, ooc_j.CorruptRawDir),
              "torch": (verify_raw_dir, CorruptRawDir)}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_raw_dir_cross_package_bitwise(tmp_path, writer, reader):
    """A directory one package writes loads in the other, bitwise, with
    the same manifest (every key, every CRC32) and the same file bytes as
    the other package's own save; both verify it."""
    rng = np.random.default_rng(4)
    arrays = {"ids": rng.integers(0, 2**31 - 1, 333).astype(np.int32),
              "rows": rng.normal(size=(17, 5)).astype(np.float32),
              "codes": rng.integers(-127, 128, (9, 3)).astype(np.int8)}
    p, q = str(tmp_path / "w"), str(tmp_path / "r")
    manifest = _SAVERS[writer](p, arrays, meta={"kind": "x", "n": 3})
    assert manifest == _SAVERS[reader](q, arrays, meta={"kind": "x", "n": 3})
    for name in sorted(arrays) + ["manifest.json", "COMMIT"]:
        fname = name if "." in name or name == "COMMIT" else f"{name}.npy"
        with open(os.path.join(p, fname), "rb") as a, open(os.path.join(q, fname), "rb") as b:
            assert a.read() == b.read(), fname
    for mmap in (False, True):
        loaded, meta = _LOADERS[reader](p, mmap=mmap)
        assert meta == {"kind": "x", "n": 3}
        for name, arr in arrays.items():
            got = np.asarray(loaded[name])
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
    _VERIFIERS[reader][0](p)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_raw_dir_flipped_bytes_rejected_by_both(tmp_path, writer):
    """Flipped bytes in a directory either package wrote fail both
    packages' CRC sweeps with ``CorruptRawDir``."""
    p = str(tmp_path / "raw")
    _SAVERS[writer](p, {"a": np.arange(1000, dtype=np.float64)})
    fpath = os.path.join(p, "a.npy")
    with open(fpath, "r+b") as fh:
        fh.seek(os.path.getsize(fpath) // 2)
        fh.write(b"\x01\x02")
    for verify, err in _VERIFIERS.values():
        with pytest.raises(err, match="checksum mismatch"):
            verify(p)


# -- CSRTopo persistence --------------------------------------------------------


def test_topology_raw_save_load_bitwise(tmp_path):
    ei, _ = _graph()
    topo = CSRTopo(edge_index=ei)
    topo.set_edge_weight(np.random.default_rng(1).random(ei.shape[1]))
    topo.feature_order = np.random.default_rng(2).permutation(topo.node_count)
    p = str(tmp_path / "topo.raw")
    topo.save(p, format="raw")
    for mmap in (False, True):
        t = CSRTopo.load(p, mmap=mmap)
        np.testing.assert_array_equal(np.asarray(t.indptr), topo.indptr)
        np.testing.assert_array_equal(np.asarray(t.indices), topo.indices)
        np.testing.assert_array_equal(np.asarray(t.eid), topo.eid)
        # cum_weights persisted, not computed again: bitwise
        np.testing.assert_array_equal(np.asarray(t.cum_weights), topo.cum_weights)
        np.testing.assert_array_equal(np.asarray(t.feature_order), topo.feature_order)
        assert t.max_degree == topo.max_degree  # from the manifest
        assert t.node_count == topo.node_count
        assert t.edge_count == topo.edge_count
    t = CSRTopo.load(p, mmap=True)
    assert isinstance(t.indices, np.memmap)  # paged in lazily
    assert t._max_degree == topo.max_degree  # no O(N) scan at load


def test_topology_mmap_load_samples_identically(tmp_path):
    """A sampler over the memory-mapped topology draws the same batches as
    one over the in-memory original."""
    ei, _ = _graph(n=150)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "topo.raw")
    topo.save(p, format="raw")
    mtopo = CSRTopo.load(p, mmap=True)
    seeds = np.random.default_rng(3).integers(0, 150, 32)
    a = GraphSageSampler(topo, [4, 3], seed_capacity=32, seed=7, device="cpu").sample(seeds)
    b = GraphSageSampler(mtopo, [4, 3], seed_capacity=32, seed=7, device="cpu").sample(seeds)
    assert torch.equal(a.n_id, b.n_id)
    for adj_a, adj_b in zip(a.adjs, b.adjs):
        assert torch.equal(adj_a.edge_index, adj_b.edge_index)


def test_topology_mmap_on_npz_raises_clear_error(tmp_path):
    ei, _ = _graph(n=50)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "topo.npz")
    topo.save(p)
    with pytest.raises(ValueError, match='format="raw"'):
        CSRTopo.load(p, mmap=True)


_TOPOS = {"jax": qj.CSRTopo, "torch": CSRTopo}


@pytest.mark.parametrize("fmt", ["npz", "raw"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_topology_cross_package_bitwise(tmp_path, fmt, writer, reader):
    """A weighted, timestamped topology with a feature order, saved by one
    package (npz or raw) and loaded by the other: every array bitwise the
    writer's, dtypes included (int32 ids, ``indptr``'s width kept), and
    the same ``max_degree`` and ``version``; a raw directory's manifest is
    the one the reader's own save writes."""
    ei, _ = _graph(n=120)
    rng = np.random.default_rng(5)
    w, tm = rng.random(ei.shape[1]), rng.random(ei.shape[1])
    order = rng.permutation(120)
    topos = {}
    for pkg, cls in _TOPOS.items():
        t = cls(edge_index=ei)
        t.set_edge_weight(w)
        t.set_edge_time(tm)
        t.feature_order = order
        topos[pkg] = t
    p = str(tmp_path / ("t.npz" if fmt == "npz" else "t.raw"))
    topos[writer].save(p, format=fmt)
    got = _TOPOS[reader].load(p)
    src = topos[writer]
    for name in ("indptr", "indices", "eid", "edge_weight", "cum_weights", "edge_time",
                 "feature_order"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(src, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.indices.dtype == np.int32 and got.indptr.dtype == src.indptr.dtype
    assert got.max_degree == src.max_degree and got.version == src.version
    if fmt == "raw":
        q = str(tmp_path / "again.raw")
        topos[reader].save(q, format="raw")
        assert load_raw_dir(q)[1] == load_raw_dir(p)[1]
        with open(os.path.join(p, "manifest.json")) as a, \
                open(os.path.join(q, "manifest.json")) as b:
            assert json.load(a) == json.load(b)


# -- the legacy npz's integrity record ---------------------------------------------


def test_npz_save_embeds_crc_and_load_verifies(tmp_path):
    ei, _ = _graph(n=80)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "topo.npz")
    topo.save(p)
    with np.load(p) as z:
        assert "_integrity" in z.files  # the CRC record rides the archive
    t = CSRTopo.load(p)  # verifies silently
    np.testing.assert_array_equal(t.indices, topo.indices)


def test_npz_corrupt_bytes_rejected(tmp_path):
    """A byte flip inside a member fails the load with an error naming the
    artifact."""
    ei, _ = _graph(n=80)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "topo.npz")
    topo.save(p)
    with open(p, "r+b") as fh:
        fh.seek(os.path.getsize(p) // 2)
        fh.write(b"\xff\xfe\xfd\xfc")
    with pytest.raises(ValueError, match="corrupt"):
        CSRTopo.load(p)


def test_npz_truncated_file_rejected(tmp_path):
    ei, _ = _graph(n=80)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "topo.npz")
    topo.save(p)
    with open(p, "r+b") as fh:
        fh.truncate(os.path.getsize(p) // 2)
    with pytest.raises(ValueError, match=p):
        CSRTopo.load(p)


def test_npz_without_integrity_record_still_loads(tmp_path):
    """An archive with no ``_integrity`` member loads unverified."""
    ei, _ = _graph(n=60)
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "legacy.npz")
    np.savez(p, indptr=topo.indptr, indices=topo.indices)
    t = CSRTopo.load(p)
    np.testing.assert_array_equal(t.indices, topo.indices)


# -- MmapFeatureStore against the in-RAM Feature ----------------------------------------


def _ids(n, seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, 64).astype(np.int32)
    ids[5] = -1  # padding lanes
    ids[40] = -1
    ids[50] = ids[51]  # a repeated id
    return ids


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
@pytest.mark.parametrize("access", ["mmap", "pread"])
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_store_gathers_bitwise_equal_feature(tmp_path, access, dtype, kernel):
    """Every lookup of the disk-backed store is the in-RAM ``Feature``'s,
    bitwise, at f32 and int8, in both access modes and on both lookup
    paths (``"pallas"``: K2's plain version over the staged block; on the
    CPU ``"auto"`` is the stock lookup): hot rows, cold rows, padding
    lanes, repeated ids and an id past the table."""
    ei, feat = _graph()
    n = feat.shape[0]
    topo_a, topo_b = CSRTopo(edge_index=ei), CSRTopo(edge_index=ei)
    budget = (4 * n + 50 * feat.shape[1]) if dtype == "int8" \
        else 50 * feat.shape[1] * 4  # 50 hot rows either way
    feature = Feature(device_cache_size=budget, csr_topo=topo_a, dtype=dtype,
                      device="cpu").from_cpu_tensor(feat.copy())
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, feat.copy(), device_cache_size=budget, csr_topo=topo_b,
                           dtype=dtype)
    store = MmapFeatureStore(p, access=access, window_rows=16, cache_windows=8,
                             kernel=kernel, device="cpu")
    assert store.hot_rows == feature.hot_rows == 50
    np.testing.assert_array_equal(topo_a.feature_order, topo_b.feature_order)
    for seed in range(3):
        ids = _ids(n, seed)
        ids[7] = n + 5  # past the table: the last id's row
        a, b = feature[torch.from_numpy(ids)], store[torch.from_numpy(ids)]
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    store.close()


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_store_reads_jax_written_rows_bitwise(tmp_path, dtype):
    """A rows directory the JAX package's ``MmapFeatureStore.write``
    publishes opens in the port, and its lookups are bitwise the JAX
    store's (and the port's own write of the same table is the same
    manifest)."""
    ei, feat = _graph()
    n = feat.shape[0]
    budget = (4 * n + 50 * 16) if dtype == "int8" else 50 * 16 * 4
    p, q = str(tmp_path / "jax_rows"), str(tmp_path / "torch_rows")
    mj = ooc_j.MmapFeatureStore.write(p, feat.copy(), device_cache_size=budget,
                                      csr_topo=qj.CSRTopo(edge_index=ei), dtype=dtype)
    mt = MmapFeatureStore.write(q, feat.copy(), device_cache_size=budget,
                                csr_topo=CSRTopo(edge_index=ei), dtype=dtype)
    assert mj == mt
    sj = ooc_j.MmapFeatureStore(p, window_rows=16, cache_windows=8)
    st = MmapFeatureStore(p, window_rows=16, cache_windows=8, device="cpu")
    for seed in range(2):
        ids = _ids(n, seed)
        want = np.asarray(sj[jnp.asarray(ids)])
        got = st[torch.from_numpy(ids)].numpy()
        assert got.tobytes() == want.tobytes()
    assert st.stager.page_reads_total == sj.stager.page_reads_total
    assert st.stager.readahead_hits_total == sj.stager.readahead_hits_total
    sj.close()
    st.close()


def test_store_parity_survives_restage(tmp_path):
    """Promoting rows into the host cold cache (and dropping them again)
    never changes a lookup's bytes."""
    ei, feat = _graph()
    n = feat.shape[0]
    topo = CSRTopo(edge_index=ei)
    feature = Feature(device_cache_size=50 * 16 * 4, csr_topo=topo,
                      device="cpu").from_cpu_tensor(feat.copy())
    topo2 = CSRTopo(edge_index=ei)
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, feat.copy(), device_cache_size=50 * 16 * 4, csr_topo=topo2)
    store = MmapFeatureStore(p, window_rows=16, cache_windows=8, host_cache_rows=24,
                             device="cpu")
    ids = torch.from_numpy(_ids(n))
    ref = feature[ids]
    assert torch.equal(store[ids], ref)
    assert store.restage(np.arange(24)) == 24
    assert torch.equal(store[ids], ref)
    assert store.cold_cache_hits_total > 0  # the cache served
    assert store.restage([]) == 0  # everything back to the disk
    assert torch.equal(store[ids], ref)
    store.close()


def test_store_prefetch_overlaps_and_counts_hits(tmp_path):
    from quiver_tpu_torch.obs.registry import (
        OOC_PAGE_READS,
        OOC_READAHEAD_HITS,
        MetricsRegistry,
    )
    from quiver_tpu_torch.obs.timeline import StepTimeline

    ei, feat = _graph()
    topo = CSRTopo(edge_index=ei)
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, feat, device_cache_size=50 * 16 * 4, csr_topo=topo)
    reg, tl = MetricsRegistry(), StepTimeline()
    store = MmapFeatureStore(p, window_rows=16, cache_windows=8, metrics=reg, timeline=tl,
                             device="cpu")
    ids = torch.from_numpy(_ids(feat.shape[0]))
    assert store.prefetch(ids) > 0  # background reads dispatched
    store[ids]  # the same batch: every window staged or in flight
    assert store.stager.readahead_hits_total > 0
    assert int(np.asarray(reg.value(OOC_PAGE_READS))) == store.stager.page_reads_total
    assert int(np.asarray(reg.value(OOC_READAHEAD_HITS))) == \
        store.stager.readahead_hits_total
    assert "ooc.stage_wait" in tl.summary()
    with pytest.raises(NotImplementedError, match="A.14"):
        store.trace_lookup(64)
    store.close()


def test_store_write_refuses_bfloat16_and_foreign_dirs(tmp_path):
    _, feat = _graph(n=20)
    with pytest.raises(ValueError, match="bfloat16"):
        MmapFeatureStore.write(str(tmp_path / "bf"), feat, dtype="bfloat16")
    p = str(tmp_path / "topo")
    CSRTopo(edge_index=_graph(n=20)[0]).save(p, format="raw")
    with pytest.raises(ValueError, match="not a feature-rows raw dir"):
        MmapFeatureStore(p, device="cpu")
    with pytest.raises(ValueError, match="access"):
        MmapFeatureStore(p, access="aio", device="cpu")


# -- AsyncStager ---------------------------------------------------------------------


def _flaky_reader(fail_times):
    """A window reader that raises ``fail_times`` times per window, then
    serves the window's index pattern."""
    failures = {}

    def read(window):
        failures.setdefault(window, 0)
        if failures[window] < fail_times:
            failures[window] += 1
            raise OSError(f"injected read fault on window {window}")
        return np.full((4, 2), window, np.int32)

    return read


def test_stager_retries_transient_faults():
    from quiver_tpu_torch.obs.timeline import StepTimeline

    tl = StepTimeline()
    with AsyncStager(_flaky_reader(2), num_windows=8, window_rows=4, retries=3,
                     backoff=1e-4, timeline=tl) as st:
        out = st.fetch(np.array([0, 5, 9]))  # windows 0, 1, 2
        np.testing.assert_array_equal(out[:, 0], [0, 1, 2])
        assert st.read_retries_total == 6  # 2 faults x 3 windows
        assert tl.stats("ooc.retry_wait").count == 6


def test_stager_exhausted_retries_surface():
    with AsyncStager(_flaky_reader(5), num_windows=4, window_rows=4, retries=1,
                     backoff=0.0) as st:
        with pytest.raises(OSError, match="injected read fault"):
            st.fetch(np.array([0]))


def test_stager_backoff_jitter_deterministic():
    """The same seed gives the same jitter, and JAX's stager's delays:
    both draw from ``random.Random(retry_seed)``."""
    from quiver_tpu.obs.timeline import StepTimeline as StepTimelineJ

    from quiver_tpu_torch.obs.timeline import StepTimeline

    def waits(stager_cls, timeline_cls, seed):
        tl = timeline_cls()
        with stager_cls(_flaky_reader(3), num_windows=2, window_rows=4, retries=3,
                        backoff=1e-3, backoff_cap=2e-3, jitter=0.5, retry_seed=seed,
                        timeline=tl) as st:
            st.fetch(np.array([0]))
        stats = tl.stats("ooc.retry_wait")
        return stats.count, stats.max, stats.total

    assert waits(AsyncStager, StepTimeline, 5) == waits(AsyncStager, StepTimeline, 5)
    assert waits(AsyncStager, StepTimeline, 5) == waits(ooc_j.AsyncStager, StepTimelineJ, 5)
    count, mx, _ = waits(AsyncStager, StepTimeline, 5)
    assert count == 3
    assert mx <= 2e-3 * 1.5 + 1e-9  # cap x (1 + jitter)


def test_stager_lru_bounds_resident_windows():
    reads = []

    def read(window):
        reads.append(window)
        return np.zeros((4, 1), np.int8)

    with AsyncStager(read, num_windows=100, window_rows=4, cache_windows=3) as st:
        for w in range(6):
            st.fetch(np.array([w * 4]))
        assert len(st._cache) <= 3
        st.fetch(np.array([5 * 4]))  # still cached: no new read
        assert reads.count(5) == 1
        st.fetch(np.array([0]))  # evicted long ago: read again
        assert reads.count(0) == 2


# -- the data-parallel trainer over the store ---------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_data_parallel_epoch_bitwise_vs_in_ram(tmp_path, depth):
    """``DataParallelTrainer`` (2 workers) epochs over the disk-backed
    store give the in-RAM ``Feature``'s losses bitwise, serially and
    through the Prefetcher's worker thread."""
    from quiver_tpu_torch.models.sage import GraphSAGE
    from quiver_tpu_torch.parallel.trainer import DataParallelTrainer

    rng = np.random.default_rng(0)
    n, classes = 300, 4
    labels = rng.integers(0, classes, n)
    feat = (np.eye(classes, dtype=np.float32)[labels] * 2.0
            + rng.normal(scale=0.8, size=(n, classes)).astype(np.float32))
    ei = rng.integers(0, n, size=(2, 6 * n)).astype(np.int64)
    budget = 60 * classes * 4  # 20% hot: the cold tier carries real load

    def run(kind):
        topo = CSRTopo(edge_index=ei)
        if kind == "ram":
            feature = Feature(device_cache_size=budget, csr_topo=topo,
                              device="cpu").from_cpu_tensor(feat.copy())
        else:
            p = str(tmp_path / f"rows{depth}")
            MmapFeatureStore.write(p, feat.copy(), device_cache_size=budget, csr_topo=topo)
            feature = MmapFeatureStore(p, window_rows=32, cache_windows=8, device="cpu")
        sampler = GraphSageSampler(topo, [4, 3], seed_capacity=32, seed=5, device="cpu")
        mesh = qt.make_mesh(data=2, feature=1, devices=["cpu"] * 2)
        model = GraphSAGE(classes, 16, classes, num_layers=2)
        trainer = DataParallelTrainer(mesh, sampler, feature, model,
                                      torch.optim.Adam(model.parameters(), lr=5e-3),
                                      local_batch=32)
        trainer.init(torch.Generator().manual_seed(0))
        lab = torch.from_numpy(labels)
        losses = []
        for epoch in range(2):
            loss, _ = trainer.train_epoch(np.arange(n), lab,
                                          torch.Generator().manual_seed(1 + epoch),
                                          rng=np.random.default_rng(epoch), depth=depth)
            losses.append(loss)
        if kind == "disk":
            assert feature.stager.readahead_hits_total > 0
            feature.close()
        return losses, model.state_dict()

    ram_losses, ram_state = run("ram")
    disk_losses, disk_state = run("disk")
    assert ram_losses == disk_losses  # bitwise
    assert all(torch.equal(ram_state[k], disk_state[k]) for k in ram_state)


# -- the cache controller over the disk tier -------------------------------------------------


def test_controller_promotes_measured_hot_disk_rows(tmp_path):
    from quiver_tpu_torch.control.controller import CacheController
    from quiver_tpu_torch.control.freq import FreqSketch
    from quiver_tpu_torch.obs.export import read_jsonl
    from quiver_tpu_torch.obs.registry import CTRL_OOC_PROMOTIONS

    ei, feat = _graph()
    n = feat.shape[0]
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, feat, device_cache_size=40 * 16 * 4)
    store = MmapFeatureStore(p, window_rows=16, cache_windows=16, host_cache_rows=12,
                             device="cpu")
    ids = torch.from_numpy(_ids(n))
    before = store[ids]
    log = str(tmp_path / "decisions.jsonl")
    ctl = CacheController(sketch=FreqSketch(n), decision_log=log)
    ctl.attach(store)
    hot_disk = np.arange(100, 112)  # translated rows past hot_rows = 40
    for _ in range(4):
        ctl.observe_ids(hot_disk)
    ctl.end_epoch(feature=store)  # maybe_promote
    np.testing.assert_array_equal(store.staged_ids, hot_disk - store.hot_rows)
    assert ctl.stats()["ooc_promotions"] == 1
    recs = read_jsonl(log)
    assert [r.name for r in recs] == [CTRL_OOC_PROMOTIONS]
    lines = [json.loads(s) for s in open(log).read().splitlines()]
    assert lines[-1]["decision"] == "ooc_promote"
    assert lines[-1]["staged"] == 12
    assert torch.equal(store[ids], before)  # the promotion moved no bytes
    # a frozen controller observes and never restages
    store2 = MmapFeatureStore(p, window_rows=16, cache_windows=16, host_cache_rows=12,
                              device="cpu")
    fz = CacheController(sketch=FreqSketch(n), frozen=True).attach(store2)
    fz.observe_ids(hot_disk)
    fz.end_epoch(feature=store2)
    assert store2.staged_ids.size == 0
    store.close()
    store2.close()


def test_cost_model_disk_term_calibrates(tmp_path):
    from quiver_tpu_torch.control.cost import CostModel
    from quiver_tpu_torch.control.freq import FreqSketch, row_heat_histogram
    from quiver_tpu_torch.obs.timeline import StepTimeline

    ei, feat = _graph()
    n = feat.shape[0]
    p = str(tmp_path / "rows")
    MmapFeatureStore.write(p, feat, device_cache_size=40 * 16 * 4)
    tl = StepTimeline()
    store = MmapFeatureStore(p, window_rows=16, cache_windows=8, timeline=tl, device="cpu")
    cost = CostModel(local_len=64, num_shards=1)
    assert not cost.calibrate_disk(tl, store.stager)  # nothing measured
    store[torch.from_numpy(_ids(n))]
    assert cost.calibrate_disk(tl, store.stager)
    assert cost._t_window == tl.summary()["ooc.stage_wait"].total / \
        store.stager.page_reads_total
    sk = FreqSketch(n, num_bins=n)  # one row per bin: exact masses
    sk.observe_histogram(np.asarray(row_heat_histogram(torch.arange(n), None, n, n)))
    zero = cost.predict_disk(sk, n, 0)  # everything resident
    half = cost.predict_disk(sk, store.hot_rows, 0)
    assert zero["hit_disk"] == 0.0
    assert half["hit_disk"] == pytest.approx((n - store.hot_rows) / n)
    assert half["est_disk_s_per_obs"] >= 0.0
    store.close()


# -- the chaos drill's building block ----------------------------------------------------


def test_raw_fallback_to_legacy_npz(tmp_path):
    """A torn raw directory is quarantined and the loader falls back to
    the npz of the same topology."""
    ei, _ = _graph(n=120)
    topo = CSRTopo(edge_index=ei)
    raw = str(tmp_path / "topo.raw")
    npz = str(tmp_path / "topo.npz")
    topo.save(raw, format="raw")
    topo.save(npz)
    shutil.rmtree(raw)
    os.makedirs(raw)  # an empty directory: no COMMIT, corrupt
    try:
        loaded = CSRTopo.load(raw, mmap=True)
    except CorruptRawDir:
        quarantine_raw_dir(raw)
        loaded = CSRTopo.load(npz)
    np.testing.assert_array_equal(loaded.indices, topo.indices)
    assert not os.path.exists(raw)  # quarantined aside
