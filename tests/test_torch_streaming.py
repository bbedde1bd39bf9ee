"""Transactional streaming mutation in quiver_tpu_torch (``streaming/``)
against quiver_tpu's, on the CPU.

The twins of ``tests/test_streaming.py``'s tests, with its
parametrisation: each puts the same numpy inputs through both packages'
``StreamingGraph`` (or ``validate_delta``, ``merge_csr``) and holds the
port to JAX's verdicts, reasons, published arrays and counters. JAX's two
``slow`` differentials become port tests at their own small sizes (n = 384
and 256, local batch 16, a ``(2, 4)`` CPU mesh): the incremental path
against a rebuild from the final COO, and a crashed commit against no
commit. Then the cross-package cases: the port's row-local admission
accounting against JAX's whole-graph one on random batches, the recorder's
bundle on an aborted commit (``tests/test_tracing.py``), the stale-serve
and refresher drills (``tests/test_serving.py``) and the controller's
survival of a commit (``tests/test_controller.py``), each driven by the
port's ``StreamingGraph``.

Tolerance: bitwise everywhere. Verdicts, reasons (strings), stages,
counters, versions, CSR arrays and their dtypes, attribute columns,
sampled ids, gathered rows, and the differentials' losses and parameters
(the port against itself on one CPU device, the same ops on the same
inputs). The int8 store's rows stay within one quantisation step of the
new rows (JAX's own bar).
"""

import copy
import logging
import os
import types
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.streaming import merge_csr as merge_csr_j  # noqa: E402
from quiver_tpu.streaming import validate_delta as validate_delta_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch import (CSRTopo, CommitAborted, DeltaBatch, GraphSageSampler,  # noqa: E402
                              StreamingGraph, VersionMismatchError)
from quiver_tpu_torch.obs.registry import (DELTAS_COMMITTED, DELTAS_QUARANTINED,  # noqa: E402
                                           STREAMING_COMMITS)
from quiver_tpu_torch.streaming import (DeltaRejected, merge_csr, validate_delta,  # noqa: E402
                                        verify_merged_csr)
from quiver_tpu_torch.utils import trace  # noqa: E402


def _graph(n=200, e=2000, seed=0):
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, size=(2, e)).astype(np.int64)
    return CSRTopo(edge_index=coo), coo


def _first_live_edge(topo):
    src = int(np.repeat(np.arange(topo.node_count), topo.degree)[0])
    dst = int(np.asarray(topo.indices)[int(np.asarray(topo.indptr, dtype=np.int64)[src])])
    return src, dst


def _missing_pair(topo, coo):
    """A (src, dst) pair absent from the graph."""
    n = topo.node_count
    live = set((coo[0] * n + coo[1]).tolist())
    k = next(k for k in range(n * n) if k not in live)
    return k // n, k % n


def _counter(sg, name):
    return int(np.asarray(sg.metrics.value(name)))


def _batch_j(delta):
    """The JAX package's DeltaBatch of the same fields."""
    return qj.DeltaBatch(**{f: getattr(delta, f) for f in (
        "edge_inserts", "edge_deletes", "update_ids", "update_rows", "edge_weights",
        "edge_times", "tag")})


def _same_csr(tt, tj):
    """The two topologies hold the same CSR: arrays and dtypes, attributes,
    eid, version."""
    assert tt.version == tj.version
    for name in ("indptr", "indices", "eid", "edge_weight", "cum_weights", "edge_time"):
        a, b = getattr(tt, name), getattr(tj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            b = np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _ingest_both(sg_t, sg_j, delta):
    """Ingest ``delta`` on both graphs; both verdicts and reasons equal."""
    got, want = sg_t.ingest(delta), sg_j.ingest(_batch_j(delta))
    assert got == want
    if not got:
        assert sg_t.quarantined[-1].reason == sg_j.quarantined[-1].reason
        assert sg_t.quarantined[-1].stage == sg_j.quarantined[-1].stage
    return got


def _final_coo(coo, dels, ins, n):
    """The COO a rebuild of the committed graph starts from: the deleted
    occurrences (earliest in CSR slot order) removed, the inserts appended."""
    want = Counter((dels[0] * n + dels[1]).tolist())
    enc = coo[0] * n + coo[1]
    remove = np.zeros(coo.shape[1], bool)
    for pos in np.argsort(coo[0], kind="stable").tolist():
        k = int(enc[pos])
        if want.get(k, 0) > 0:
            want[k] -= 1
            remove[pos] = True
    return np.concatenate([coo[:, ~remove], ins], axis=1)


# -- admission -----------------------------------------------------------------------


def test_admission_rejects_and_quarantines():
    topo, coo = _graph()
    tj = qj.CSRTopo(edge_index=coo)
    n = topo.node_count
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(tj)
    ms, md = _missing_pair(topo, coo)
    bad = [
        (DeltaBatch(edge_inserts=np.array([[0], [n + 3]])), "outside"),
        (DeltaBatch(edge_inserts=np.array([[0, 1]])), "(2, E)"),
        (DeltaBatch(edge_inserts=np.array([[0.5], [1.5]])), "integer"),
        (DeltaBatch(edge_deletes=np.array([[ms], [md]])), "live edge"),
        (DeltaBatch(update_ids=np.array([0]), update_rows=np.ones((1, 4), np.float32)),
         "no feature store"),
        (DeltaBatch(edge_inserts=np.array([[2, 2], [3, 3]])), "duplicate"),
    ]
    for delta, needle in bad:
        assert _ingest_both(sg, sg_j, delta) is False
        assert needle in sg.quarantined[-1].reason
        assert sg.quarantined[-1].stage == "ingest"
    assert not sg.staged
    assert _counter(sg, DELTAS_QUARANTINED) == len(bad) == int(
        np.asarray(sg_j.metrics.value(DELTAS_QUARANTINED)))
    assert topo.version == 0
    # not a DeltaBatch at all
    assert sg.ingest({"edge_inserts": None}) is False
    assert sg.quarantined[-1].reason == "expected a DeltaBatch, got dict"


def test_admission_update_validation():
    topo, coo = _graph()
    store = types.SimpleNamespace(shape=(topo.node_count, 4),
                                  apply_row_updates=lambda ids, rows: None)
    sg = StreamingGraph(topo, feature=store)
    sg_j = qj.StreamingGraph(qj.CSRTopo(edge_index=coo), feature=store)
    nan_rows = np.ones((1, 4), np.float32)
    nan_rows[0, 2] = np.nan
    for delta, needle in [
        (DeltaBatch(update_ids=np.array([1]), update_rows=nan_rows), "non-finite"),
        (DeltaBatch(update_ids=np.array([1]), update_rows=np.ones((1, 3), np.float32)),
         "feature dim"),
        (DeltaBatch(update_ids=np.array([1])), "together"),
        (DeltaBatch(update_ids=np.array([1, 1]), update_rows=np.ones((2, 4), np.float32)),
         "duplicate update_ids"),
        (DeltaBatch(update_ids=np.array([1.0]), update_rows=np.ones((1, 4), np.float32)),
         "integers"),
        (DeltaBatch(update_ids=np.array([1]), update_rows=np.ones((1, 4), np.int32)),
         "float rows"),
        (DeltaBatch(update_ids=np.array([topo.node_count]),
                    update_rows=np.ones((1, 4), np.float32)), "outside"),
    ]:
        assert not _ingest_both(sg, sg_j, delta)
        assert needle in sg.quarantined[-1].reason


def test_duplicates_allow_policy():
    topo, coo = _graph()
    seen = {}
    store = types.SimpleNamespace(
        shape=(topo.node_count, 2),
        apply_row_updates=lambda ids, rows: seen.update(
            {"ids": ids.copy(), "rows": rows.copy()}),
        note_degree_update=lambda deg: None,
    )
    sg = StreamingGraph(topo, feature=store, duplicates="allow")
    # parallel edges admitted; duplicate update ids collapse last-wins
    rows = np.stack([np.full(2, 1.0, np.float32), np.full(2, 2.0, np.float32),
                     np.full(2, 3.0, np.float32)])
    assert sg.ingest(DeltaBatch(edge_inserts=np.array([[2, 2], [3, 3]]),
                                update_ids=np.array([7, 9, 7]), update_rows=rows))
    res = sg.commit()
    assert res.edges_inserted == 2 and res.rows_updated == 2
    order = np.argsort(seen["ids"])
    assert np.array_equal(seen["ids"][order], [7, 9])
    assert np.array_equal(seen["rows"][order][:, 0], [3.0, 2.0])
    # JAX's commit hands its store the same collapsed update
    seen_j = {}
    store_j = types.SimpleNamespace(
        shape=(topo.node_count, 2),
        apply_row_updates=lambda ids, rows: seen_j.update({"ids": ids.copy(),
                                                           "rows": rows.copy()}),
        note_degree_update=lambda deg: None)
    sg_j = qj.StreamingGraph(qj.CSRTopo(edge_index=coo), feature=store_j,
                             duplicates="allow")
    assert sg_j.ingest(qj.DeltaBatch(edge_inserts=np.array([[2, 2], [3, 3]]),
                                     update_ids=np.array([7, 9, 7]), update_rows=rows))
    assert sg_j.commit() is not None
    for k in ("ids", "rows"):
        np.testing.assert_array_equal(seen[k], seen_j[k])
    _same_csr(topo, sg_j.csr_topo)


def test_delete_existence_is_multiset_aware():
    topo, coo = _graph()
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(qj.CSRTopo(edge_index=coo))
    ms, md = _missing_pair(topo, coo)
    # deleting an edge staged-inserted earlier in the window is legal
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[ms], [md]])))
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_deletes=np.array([[ms], [md]])))
    # but a second delete of the same (now spent) pair is not
    assert not _ingest_both(sg, sg_j, DeltaBatch(edge_deletes=np.array([[ms], [md]])))
    assert "live edge" in sg.quarantined[-1].reason


# -- commit / rollback ---------------------------------------------------------------


def test_commit_matches_full_rebuild_bitwise():
    topo, coo = _graph(n=300, e=4000, seed=1)
    tj = qj.CSRTopo(edge_index=coo)
    n = topo.node_count
    rng = np.random.default_rng(7)
    ins = rng.integers(0, n, size=(2, 57)).astype(np.int64)
    dele = coo[:, rng.choice(coo.shape[1], size=23, replace=False)]
    sg = StreamingGraph(topo, duplicates="allow")
    sg_j = qj.StreamingGraph(tj, duplicates="allow")
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=ins, edge_deletes=dele))
    res, res_j = sg.commit(), sg_j.commit()
    assert res.version == 1
    assert res.edge_count == coo.shape[1] + 57 - 23
    assert res.__dict__ == res_j.__dict__
    oracle = CSRTopo(edge_index=_final_coo(coo, dele, ins, n))
    assert np.array_equal(topo.indptr.astype(np.int64), oracle.indptr.astype(np.int64))
    assert np.array_equal(topo.indices.astype(np.int64), oracle.indices.astype(np.int64))
    _same_csr(topo, tj)
    for name in (DELTAS_COMMITTED, STREAMING_COMMITS):
        assert _counter(sg, name) == 1 == int(np.asarray(sg_j.metrics.value(name)))


@pytest.mark.parametrize("stage", ["merge", "verify", "features"])
def test_commit_rollback_on_injected_failure(stage):
    topo, coo = _graph()
    tj = qj.CSRTopo(edge_index=coo)
    src, dst = _first_live_edge(topo)
    old_ip, old_ix = topo.indptr.copy(), topo.indices.copy()
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(tj)
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[1, 2], [3, 4]]),
                                             edge_deletes=np.array([[src], [dst]])))
    with pytest.raises(CommitAborted, match=stage) as got:
        sg.commit(inject_failure=stage)
    with pytest.raises(qj.CommitAborted) as want:
        sg_j.commit(inject_failure=stage)
    assert str(got.value) == str(want.value)
    # the pre-commit state is bitwise; the batch is quarantined whole
    assert topo.version == 0
    assert np.array_equal(old_ip, topo.indptr) and np.array_equal(old_ix, topo.indices)
    assert old_ip.dtype == topo.indptr.dtype and topo.eid is not None
    assert not sg.staged
    assert sg.quarantined[-1].stage == "commit"
    assert sg.quarantined[-1].reason == sg_j.quarantined[-1].reason
    assert _counter(sg, DELTAS_QUARANTINED) == 1
    with pytest.raises(ValueError, match="inject_failure"):
        sg.commit(inject_failure="publish")


def test_commit_empty_is_noop():
    topo, _ = _graph()
    sg = StreamingGraph(topo)
    assert sg.commit() is None
    assert topo.version == 0


def test_verify_catches_untouched_corruption():
    topo, _ = _graph(n=50, e=400, seed=3)
    indptr = np.asarray(topo.indptr, np.int64)
    indices = np.asarray(topo.indices, np.int64)
    ins = np.array([[0], [1]])
    new_ip, new_ix, touched = merge_csr(indptr, indices, ins, None)
    verify_merged_csr(indptr, indices, new_ip, new_ix, touched, 1, 0)
    # corrupt a neighbour of an untouched row: the checksum catches it
    victim = int(np.flatnonzero(~touched & (np.diff(new_ip) > 0))[0])
    bad = new_ix.copy()
    pos = int(new_ip[victim])
    bad[pos] = (bad[pos] + 1) % topo.node_count
    with pytest.raises(DeltaRejected, match="checksum"):
        verify_merged_csr(indptr, indices, new_ip, bad, touched, 1, 0)
    # and every other invariant names itself
    for args, needle in [
        ((new_ip[:-1], new_ix), "node count"),
        ((new_ip + 1, new_ix), "start at 0"),
        ((np.r_[new_ip[:-2], new_ip[-1], new_ip[-2]], new_ix), "monotone"),
        ((new_ip, new_ix[:-1]), "len(indices)"),
        ((np.r_[0, new_ip[1:] + 1], np.r_[new_ix, new_ix[:1]]), "arithmetic"),
        ((new_ip, np.where(np.arange(new_ix.size) == pos, 10 ** 6, new_ix)), "outside"),
    ]:
        with pytest.raises(DeltaRejected, match=needle.replace("(", r"\(").replace(")", r"\)")):
            verify_merged_csr(indptr, indices, *args, touched, 1, 0)


def _attr_graph(n=50, e=200, seed=0, pkg=qt):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    topo = pkg.CSRTopo(edge_index=ei)
    topo.set_edge_weight(rng.random(e) + 0.1)
    topo.set_edge_time(rng.random(e))
    return topo, ei


def test_attributed_admission_named_rejections():
    """Inserts into a weighted and timestamped topology must bring their
    attribute columns, or the whole batch is refused with a named reason."""
    topo, _ = _attr_graph()
    tj, _ = _attr_graph(pkg=qj)
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(tj)
    ins = np.array([[1], [2]])
    bad = [
        (DeltaBatch(edge_inserts=ins), "missing-edge-weights"),
        (DeltaBatch(edge_inserts=ins, edge_weights=np.array([1.0])), "missing-edge-times"),
        (DeltaBatch(edge_inserts=ins, edge_weights=np.array([-1.0]),
                    edge_times=np.array([0.5])), "bad-edge-weights"),
        (DeltaBatch(edge_inserts=ins, edge_weights=np.array([1.0]),
                    edge_times=np.array([np.nan])), "bad-edge-times"),
        (DeltaBatch(edge_inserts=ins, edge_weights=np.array([1.0, 2.0]),
                    edge_times=np.array([0.5, 0.5])), "bad-edge-weights"),
        (DeltaBatch(edge_inserts=ins, edge_weights=np.array([1 + 1j]),
                    edge_times=np.array([0.5])), "bad-edge-weights"),
    ]
    for delta, needle in bad:
        assert _ingest_both(sg, sg_j, delta) is False
        assert needle in sg.quarantined[-1].reason
        assert sg.quarantined[-1].stage == "ingest"
    assert not sg.staged
    assert _counter(sg, DELTAS_QUARANTINED) == len(bad)
    assert topo.version == 0


def test_attributed_commit_publishes_slot_aligned_attrs():
    """A good attributed batch commits: the inserted edges land with their
    weights and times slot-aligned, rows stay time-sorted, the prefix sums
    are derived again, and every array equals JAX's commit's."""
    from quiver_tpu_torch.core.topology import _row_prefix_weights

    topo, _ = _attr_graph()
    tj, _ = _attr_graph(pkg=qj)
    E = topo.edge_count
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(tj)
    row = 7
    dsrc, ddst = _first_live_edge(topo)
    assert _ingest_both(sg, sg_j, DeltaBatch(
        edge_inserts=np.array([[row, row, 3], [11, 12, 13]]),
        edge_weights=np.array([0.7, 0.9, 1.1]), edge_times=np.array([0.05, 0.95, 0.4])))
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_deletes=np.array([[dsrc], [ddst]])))
    assert sg.commit() is not None and sg_j.commit() is not None
    ip, ix = topo.indptr, topo.indices
    wt, tm = topo.edge_weight, topo.edge_time
    assert wt.shape == ix.shape == tm.shape
    assert int(ip[-1]) == E + 3 - 1
    for r in range(topo.node_count):
        assert (np.diff(tm[ip[r]:ip[r + 1]]) >= 0).all(), r
    seg = slice(ip[row], ip[row + 1])
    for d, dw, dt in [(11, 0.7, 0.05), (12, 0.9, 0.95)]:
        pos = np.flatnonzero((ix[seg] == d) & np.isclose(tm[seg], dt))
        assert pos.size == 1 and np.isclose(wt[seg][pos[0]], dw), d
    assert np.array_equal(topo.cum_weights,
                          _row_prefix_weights(wt.astype(np.float64), ip))
    assert topo.version == 1
    _same_csr(topo, tj)


def test_unattributed_topo_rejects_attr_deltas():
    topo, coo = _graph()
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(qj.CSRTopo(edge_index=coo))
    assert not _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[1], [2]]),
                                                 edge_weights=np.array([1.0])))
    assert "unexpected-edge-weights" in sg.quarantined[-1].reason
    assert not _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[1], [2]]),
                                                 edge_times=np.array([1.0])))
    assert "unexpected-edge-times" in sg.quarantined[-1].reason
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[1], [2]])))
    assert sg.commit() is not None and sg_j.commit() is not None
    _same_csr(topo, sg_j.csr_topo)


def test_weighted_only_topo_streaming_flow():
    """Weights only: times refused, weights required, and a deletes-only
    batch needs no attribute column at all."""
    topo, ei = _graph(n=50, e=200)
    topo.set_edge_weight(np.ones(200))
    tj = qj.CSRTopo(edge_index=ei)
    tj.set_edge_weight(np.ones(200))
    sg, sg_j = StreamingGraph(topo), qj.StreamingGraph(tj)
    assert not _ingest_both(sg, sg_j, DeltaBatch(
        edge_inserts=np.array([[1], [2]]), edge_weights=np.array([1.0]),
        edge_times=np.array([0.5])))
    assert "unexpected-edge-times" in sg.quarantined[-1].reason
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_inserts=np.array([[1], [2]]),
                                             edge_weights=np.array([2.5])))
    assert sg.commit() is not None and sg_j.commit() is not None
    assert topo.edge_weight.shape[0] == 201
    s, d = _first_live_edge(topo)
    assert _ingest_both(sg, sg_j, DeltaBatch(edge_deletes=np.array([[s], [d]])))
    assert sg.commit() is not None and sg_j.commit() is not None
    _same_csr(topo, tj)


def test_tensor_batches_are_taken():
    """CPU tensors in every field normalise to the numpy batch."""
    topo, coo = _graph()
    store = types.SimpleNamespace(shape=(topo.node_count, 2),
                                  apply_row_updates=lambda ids, rows: None)
    s, d = _first_live_edge(topo)
    arrays = {"edge_inserts": np.array([[1, 4], [2, 5]]), "edge_deletes": np.array([[s], [d]]),
              "update_ids": np.array([3]), "update_rows": np.ones((1, 2), np.float32)}
    got = validate_delta(DeltaBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                         topo.node_count, store.shape, live_pair_counts={s * 200 + d: 1})
    want = validate_delta(DeltaBatch(**arrays), topo.node_count, store.shape,
                          live_pair_counts={s * 200 + d: 1})
    for k in arrays:
        a, b = getattr(got, k), getattr(want, k)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(edge_deletes=torch.tensor([[s], [d]])))
    assert repr(sg.staged[0]) == "DeltaBatch(+0e, -1e, ~0rows)"


def test_feature_without_row_updates_is_refused():
    topo, _ = _graph()
    for sg_cls in (StreamingGraph, qj.StreamingGraph):
        with pytest.raises(ValueError, match="apply_row_updates"):
            sg_cls(topo, feature=types.SimpleNamespace(shape=(200, 2)))
        with pytest.raises(ValueError, match="duplicates"):
            sg_cls(topo, duplicates="last")


# -- cross-package: validate_delta, merge_csr, commits, admission accounting -----------


def _random_delta(rng, n, f, live, kind):
    """One random batch, well-formed or not (``kind`` picks the fault)."""
    m = int(rng.integers(1, 6))
    fields = {}
    if kind in ("ok", "dup", "range", "dele"):
        fields["edge_inserts"] = rng.integers(0, n, size=(2, m))
        if kind == "dup":
            fields["edge_inserts"][:, -1] = fields["edge_inserts"][:, 0]
            if m == 1:
                fields["edge_inserts"] = np.repeat(fields["edge_inserts"], 2, axis=1)
        if kind == "range":
            fields["edge_inserts"][1, -1] = n + int(rng.integers(0, 3))
    if kind in ("ok", "dele"):
        if live.shape[1]:
            pick = live[:, rng.integers(0, live.shape[1], int(rng.integers(1, 4)))]
            fields["edge_deletes"] = pick
        if kind == "dele":  # a pair with likely no live edge
            fields["edge_deletes"] = np.array([[int(rng.integers(0, n))],
                                               [int(rng.integers(0, n))]])
    if kind in ("ok", "rows", "nan"):
        u = int(rng.integers(1, 4))
        fields["update_ids"] = rng.choice(n, size=u, replace=False)
        fields["update_rows"] = rng.normal(size=(u, f)).astype(np.float32)
        if kind == "nan":
            fields["update_rows"][-1, 0] = np.inf
    return DeltaBatch(**fields, tag=kind)


@pytest.mark.parametrize("duplicates", ["error", "allow"])
def test_validate_delta_equals_jax(duplicates):
    """``validate_delta`` gives JAX's verdict, message and normalised batch
    on 120 random batches of every kind, against the live multiset."""
    rng = np.random.default_rng(11)
    n, f = 40, 3
    coo = rng.integers(0, n, size=(2, 300))
    live = {}
    for k in (coo[0] * n + coo[1]).tolist():
        live[k] = live.get(k, 0) + 1
    kinds = ["ok", "dup", "range", "dele", "rows", "nan"]
    verdicts = Counter()
    for i in range(120):
        delta = _random_delta(rng, n, f, coo, kinds[i % len(kinds)])
        results = []
        for fn, batch in ((validate_delta, delta), (validate_delta_j, _batch_j(delta))):
            try:
                results.append(fn(batch, n, (n, f), live_pair_counts=live,
                                  duplicates=duplicates))
            except ValueError as e:
                results.append(e)
        got, want = results
        assert type(got).__name__ == type(want).__name__
        if isinstance(got, Exception):
            assert str(got) == str(want)
            verdicts["rejected"] += 1
            continue
        verdicts["admitted"] += 1
        for name in ("edge_inserts", "edge_deletes", "update_ids", "update_rows"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert verdicts["rejected"] > 20 and verdicts["admitted"] > 20


@pytest.mark.parametrize("attrs", [None, ("edge_weight",), ("edge_weight", "edge_time")])
def test_merge_csr_equals_jax(attrs):
    """``merge_csr`` gives JAX's arrays, touched mask and attribute
    columns, on inserts and deletes that hit shared rows (parallel edges,
    a delete of a staged insert)."""
    rng = np.random.default_rng(13)
    n = 60
    topo, coo = _graph(n=n, e=500, seed=13)
    ins = rng.integers(0, n, size=(2, 40))
    ins[:, 5] = ins[:, 4]  # a parallel insert
    live = np.stack([np.repeat(np.arange(n), topo.degree), topo.indices])
    dele = np.concatenate([live[:, rng.choice(live.shape[1], 25, replace=False)],
                           ins[:, [4]]], axis=1)
    cols = None if attrs is None else {
        name: (rng.random(topo.edge_count).astype(np.float32),
               rng.random(ins.shape[1]).astype(np.float32)) for name in attrs}
    got = merge_csr(topo.indptr, topo.indices, ins, dele, cols)
    want = merge_csr_j(np.asarray(topo.indptr), np.asarray(topo.indices), ins, dele, cols)
    assert len(got) == len(want) == (3 if attrs is None else 4)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if attrs is not None:
        assert got[3].keys() == want[3].keys()
        for name in attrs:
            assert np.array_equal(got[3][name], want[3][name])
    assert got[2].sum() > 0 and not got[2].all()


@pytest.mark.parametrize("kind", ["plain", "weighted", "timed"])
def test_commits_equal_jax(kind):
    """Several windows of batches (admitted and refused) committed on both
    packages: every verdict, reason and result, the published CSR with its
    attributes and dtypes, and the three counters."""
    rng = np.random.default_rng(17)
    n = 80
    coo = rng.integers(0, n, size=(2, 700))
    topos = [pkg.CSRTopo(edge_index=coo) for pkg in (qt, qj)]
    if kind == "weighted":
        w = rng.random(700) + 0.05
        for t in topos:
            t.set_edge_weight(w)
    if kind == "timed":
        tms = rng.random(700)
        for t in topos:
            t.set_edge_time(tms)
    sg, sg_j = StreamingGraph(topos[0]), qj.StreamingGraph(topos[1])
    for window in range(3):
        for i in range(6):
            live = np.stack([np.repeat(np.arange(n), topos[0].degree), topos[0].indices])
            delta = _random_delta(rng, n, 1, live, ["ok", "dup", "dele"][i % 3])
            extra = {}
            m = 0 if delta.edge_inserts is None else delta.edge_inserts.shape[1]
            if kind == "weighted" and m:
                extra["edge_weights"] = rng.random(m)
            if kind == "timed" and m:
                extra["edge_times"] = rng.random(m)
            delta = DeltaBatch(edge_inserts=delta.edge_inserts,
                               edge_deletes=delta.edge_deletes, **extra)
            _ingest_both(sg, sg_j, delta)
        assert sg.staged_counts() == sg_j.staged_counts()
        res, res_j = sg.commit(), sg_j.commit()
        assert (res is None) == (res_j is None)
        if res is not None:
            assert res.__dict__ == res_j.__dict__
        _same_csr(topos[0], topos[1])
    for name in (DELTAS_QUARANTINED, DELTAS_COMMITTED, STREAMING_COMMITS):
        assert _counter(sg, name) == int(np.asarray(sg_j.metrics.value(name))), name
    assert topos[0].version >= 2


def test_row_local_accounting_equals_whole_graph():
    """The port's admission reads the live multiset only at the pairs a
    batch's deletes name, counted from their rows and the staged batches;
    JAX's builds it over every edge. On 200 random batches against staged
    state (inserts, deletes of live and of staged edges, pairs with no
    live edge, out-of-range and malformed deletes) both give the same
    verdicts and messages, and the restricted dict agrees with the whole
    one at every key it holds."""
    rng = np.random.default_rng(19)
    n = 50
    coo = rng.integers(0, n, size=(2, 400))
    sg, sg_j = StreamingGraph(CSRTopo(edge_index=coo), duplicates="allow"), \
        qj.StreamingGraph(qj.CSRTopo(edge_index=coo), duplicates="allow")
    staged_ins = np.zeros((2, 0), np.int64)
    admitted = rejected = 0
    for i in range(200):
        live = np.concatenate([coo, staged_ins], axis=1)
        r = i % 5
        fields = {}
        if r in (0, 1):
            fields["edge_deletes"] = live[:, rng.integers(0, live.shape[1], 3)]
        elif r == 2:
            fields["edge_deletes"] = rng.integers(0, n, size=(2, 2))
        elif r == 3:
            fields["edge_inserts"] = rng.integers(0, n, size=(2, 2))
            fields["edge_deletes"] = np.concatenate(
                [fields["edge_inserts"][:, :1], live[:, rng.integers(0, live.shape[1], 1)]],
                axis=1)
        else:
            fields["edge_deletes"] = (rng.integers(-1, n + 2, size=(2, 2)) if i % 2
                                      else np.array([[1, 2, 3]]))
        delta = DeltaBatch(**fields)
        if i % 3 == 0 and "edge_deletes" in fields and np.ndim(fields["edge_deletes"]) == 2 \
                and fields["edge_deletes"].shape[0] == 2:
            # a second delete of the same pair: accounting must be a multiset
            delta = DeltaBatch(edge_deletes=np.repeat(fields["edge_deletes"][:, :1], 2, axis=1))
        restricted = sg._live_pair_counts(delta)
        whole = sg_j._live_pair_counts()
        for k, v in restricted.items():
            assert whole.get(k, 0) == v, k
        ok = _ingest_both(sg, sg_j, delta)
        admitted += ok
        rejected += not ok
        if ok and delta.edge_inserts is not None:
            staged_ins = np.concatenate([staged_ins, delta.edge_inserts], axis=1)
        if i % 40 == 39:
            assert (sg.commit() is None) == (sg_j.commit() is None)
            _same_csr(sg.csr_topo, sg_j.csr_topo)
            staged_ins = np.zeros((2, 0), np.int64)
    assert admitted > 40 and rejected > 40


def test_log_lines_equal_jax():
    """The quarantine warning and the commit line, JAX's text."""
    topo, coo = _graph()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = trace.get_logger("streaming")
    logger.addHandler(handler)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        sg = StreamingGraph(topo)
        assert not sg.ingest(DeltaBatch(edge_inserts=np.array([[0], [999]])))
        assert sg.ingest(DeltaBatch(edge_inserts=np.array([[0], [1]])))
        sg.commit()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    msgs = [r.getMessage() for r in records]
    assert msgs[0].startswith("quarantined 1 delta batch(es) at ingest: edge_inserts "
                              "reference node ids outside [0, 200)")
    assert msgs[1] == ("committed v1: 1 batch(es), +1/-0 edges (E=2001), 0 row update(s); "
                       "stale consumers must refresh")
    assert records[0].levelno == logging.WARNING and records[1].levelno == logging.INFO


# -- versioned invalidation ------------------------------------------------------------


def test_sampler_stale_raise_and_refresh_parity():
    topo, coo = _graph(n=256, e=2500, seed=5)
    sampler = GraphSageSampler(topo, [3, 3], device="cpu", seed=3, seed_capacity=32)
    seeds = np.arange(16)
    sampler.sample(seeds)
    sg = StreamingGraph(topo)
    assert sg.ingest(DeltaBatch(edge_inserts=np.array([[1], [2]])))
    sg.commit()
    with pytest.raises(VersionMismatchError, match="refresh_topology"):
        sampler.sample(seeds)
    sampler.refresh_topology()
    out = sampler.sample(seeds)
    # parity with a fresh sampler over the rebuilt graph at the same call
    final = np.concatenate([coo, np.array([[1], [2]])], axis=1)
    fresh = GraphSageSampler(CSRTopo(edge_index=final), [3, 3], device="cpu", seed=3,
                             seed_capacity=32)
    fresh._call = sampler._call - 1
    ref = fresh.sample(seeds)
    assert torch.equal(out.n_id, ref.n_id)
    for a, b in zip(out.adjs, ref.adjs):
        assert torch.equal(a.edge_index, b.edge_index)


def test_topo_sharded_sampler_partitions_the_merged_csr():
    """After a commit and ``refresh_topology()`` a topology-sharded sampler
    holds the merged CSR's partitions, bitwise those of a sampler built on
    the rebuilt graph, and samples what that sampler samples."""
    topo, coo = _graph(n=240, e=2400, seed=21)
    n = topo.node_count
    mesh = qt.make_mesh(data=1, feature=4, devices=["cpu"] * 4)
    kw = {"seed": 3, "seed_capacity": 16, "topo_sharding": "mesh", "mesh": mesh}
    sampler = GraphSageSampler(topo, [3, 2], **kw)
    rng = np.random.default_rng(21)
    ins = rng.integers(0, n, size=(2, 30))
    dele = coo[:, rng.choice(coo.shape[1], 20, replace=False)]
    sg = StreamingGraph(topo, duplicates="allow")
    assert sg.ingest(DeltaBatch(edge_inserts=ins, edge_deletes=dele))
    sg.commit()
    with pytest.raises(VersionMismatchError):
        sampler.sample(np.arange(16), key=5)
    sampler.refresh_topology()
    rebuilt = GraphSageSampler(CSRTopo(edge_index=_final_coo(coo, dele, ins, n)), [3, 2], **kw)
    for a, b in ((sampler.topo.indptr, rebuilt.topo.indptr),
                 (sampler.topo.indices, rebuilt.topo.indices)):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    out, ref = sampler.sample(np.arange(16), key=5), rebuilt.sample(np.arange(16), key=5)
    assert torch.equal(out.n_id, ref.n_id)
    for a, b in zip(out.adjs, ref.adjs):
        assert torch.equal(a.edge_index, b.edge_index)


# -- feature tiers -----------------------------------------------------------------------


def _mesh(data, feature):
    return qt.make_mesh(data=data, feature=feature, devices=["cpu"] * (data * feature))


def _store(topo, feat, mesh, dtype=None, auto_split=False):
    f = feat.shape[1]
    return qt.ShardedFeature(mesh, device_cache_size=16 * f * 4, replicate_budget=8 * f * 4,
                             csr_topo=topo, dtype=dtype,
                             auto_split=auto_split).from_cpu_tensor(feat)


def _inverse(order, n):
    inv = np.empty(n, np.int64)
    inv[np.asarray(order)] = np.arange(n)
    return inv


def test_row_updates_serve_fresh_in_every_tier():
    topo, _ = _graph(n=256, e=3000, seed=6)
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(256, 16)).astype(np.float32)
    store = _store(topo, feat, _mesh(1, 8))
    assert store.rep_rows > 0 and store.hot_rows > 0 and store.cold is not None
    inv = _inverse(store.feature_order, 256)
    ids = np.array([int(inv[0]),                                # pinned in L0
                    int(inv[store.rep_rows]),                   # the first L1 row
                    int(inv[store.rep_rows + store.hot_rows])])  # the first cold row
    rows = rng.normal(size=(3, 16)).astype(np.float32) + 50.0
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(update_ids=ids, update_rows=rows))
    sg.commit()
    assert store.version == 1 and topo.version == 0
    assert np.array_equal(store.gather(ids).numpy(), rows)
    # no stale L0: the pinned row serves the new value from every replica
    for block in store.reps.values():
        assert np.array_equal(block[0].numpy(), rows[0])
    others = np.setdiff1d(np.arange(256), ids)[:32]
    assert np.array_equal(store.gather(others).numpy(), feat[others])


def test_row_updates_quantized_store_requantizes():
    topo, _ = _graph(n=256, e=3000, seed=8)
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(256, 8)).astype(np.float32)
    # int8 budgets clear the 4n-byte scales first
    store = qt.ShardedFeature(_mesh(1, 8), device_cache_size=4 * 256 + 16 * 8,
                              replicate_budget=8 * 8, csr_topo=topo,
                              dtype="int8").from_cpu_tensor(feat)
    assert store.rep_rows > 0 and store.hot_rows > 0
    ids = np.array([0, 100])
    rows = np.array([np.full(8, 3.0), np.full(8, -1.5)], np.float32)
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(update_ids=ids, update_rows=rows))
    sg.commit()
    got = store.gather(ids).numpy()
    assert np.allclose(got, rows, atol=np.abs(rows).max() / 127 + 1e-6)
    t = np.asarray(store.feature_order)[ids]
    assert np.allclose(store.scale.numpy()[t], np.abs(rows).max(axis=1) / 127.0)


def test_row_update_then_replan_keeps_fresh_values():
    topo, _ = _graph(n=256, e=3000, seed=9)
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(256, 16)).astype(np.float32)
    store = _store(topo, feat, _mesh(1, 8))
    inv = _inverse(store.feature_order, 256)
    pinned, cold_id = int(inv[0]), int(inv[store.rep_rows + store.hot_rows])
    rows = rng.normal(size=(2, 16)).astype(np.float32) + 9.0
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(update_ids=np.array([pinned, cold_id]), update_rows=rows))
    sg.commit()
    store.replan(_mesh(1, 4))
    assert np.array_equal(store.gather(np.array([pinned, cold_id])).numpy(), rows)
    for block in store.reps.values():
        assert np.array_equal(block[0].numpy(), rows[0])
    assert store.version == 1  # a replan is placement, not mutation


def test_row_update_rejects_bad_input_bit_identically():
    topo, _ = _graph(n=128, e=1500, seed=10)
    rng = np.random.default_rng(10)
    feat = rng.normal(size=(128, 8)).astype(np.float32)
    store = _store(topo, feat, _mesh(1, 8))
    before = store.gather(np.arange(128)).clone()
    bad_rows = np.ones((1, 8), np.float32)
    bad_rows[0, 0] = np.inf
    sg = StreamingGraph(topo, feature=store)
    for ids, rows, match in [
        (np.array([1]), bad_rows, "non-finite"),
        (np.array([200]), np.ones((1, 8), np.float32), r"in \[0, 128\)"),
        (np.array([1, 1]), np.ones((2, 8), np.float32), "duplicate"),
        (np.array([1]), np.ones((1, 5), np.float32), "feature dim"),
    ]:
        with pytest.raises(ValueError, match=match):
            store.apply_row_updates(ids, rows)
        # admission refuses the same rows before they reach the store
        assert not sg.ingest(DeltaBatch(update_ids=ids, update_rows=rows))
    assert store.version == 0 and sg.commit() is None
    assert torch.equal(store.gather(np.arange(128)), before)


def test_degree_update_feeds_split_tuner():
    """A commit's new degrees reach the store's split tuner: degrees that
    put every bit of heat outside L0 make it hand the replicated rows
    back, one more store version."""
    topo, coo = _graph(n=256, e=3000, seed=11)
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(256, 8)).astype(np.float32)
    store = _store(topo, feat, _mesh(1, 8), auto_split=True)
    rep0 = store.rep_rows
    assert rep0 > 0
    inv = _inverse(store.feature_order, 256)
    deg = np.zeros(256, np.int64)
    deg[inv[rep0: rep0 + store.hot_rows]] = 100
    store.note_degree_update(deg)
    assert store.rep_rows == rep0 // 2
    # through a commit: one topology bump, and the degree feed runs
    fed = []
    store.note_degree_update = fed.append
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(edge_inserts=np.array([[3], [4]])))
    sg.commit()
    assert topo.version == 1 and len(fed) == 1 and np.array_equal(fed[0], topo.degree)


def _trainer(topo, store, mesh, local_batch, optimizer="sgd"):
    model = qt.GraphSAGE(store.shape[1], 8, 4, num_layers=2)
    opt = (torch.optim.SGD(model.parameters(), lr=1e-2) if optimizer == "sgd"
           else torch.optim.Adam(model.parameters(), lr=1e-3))
    sampler = GraphSageSampler(topo, [3, 3], seed=3, seed_capacity=local_batch,
                               topo_sharding="mesh", mesh=mesh)
    tr = qt.DistributedTrainer(mesh, sampler, store, model, opt, local_batch=local_batch,
                               seed_sharding="all")
    tr.init(0)
    return tr


def test_trainer_stale_raise_and_refresh():
    topo, _ = _graph(n=128, e=1200, seed=12)
    rng = np.random.default_rng(12)
    feat = rng.normal(size=(128, 4)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 3, 128).astype(np.int64))
    mesh = _mesh(2, 4)
    store = _store(topo, feat, mesh)
    tr = _trainer(topo, store, mesh, 8)
    idx = rng.integers(0, 128, tr.global_batch)
    tr.step(idx, labels, 1)
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(edge_inserts=np.array([[1], [2]]), update_ids=np.array([5]),
                                update_rows=np.full((1, 4), 2.5, np.float32)))
    sg.commit()
    assert (topo.version, store.version) == (1, 1)
    with pytest.raises(VersionMismatchError, match="refresh"):
        tr.step(idx, labels, 2)
    with pytest.raises(VersionMismatchError, match="refresh"):
        tr.epoch_scan(tr.pack_epoch(idx, seed=0), labels, 2)
    tr.refresh()
    assert np.isfinite(float(tr.step(idx, labels, 2)))


def test_trainer_refresh_after_row_updates_only():
    """A commit of row updates alone moves the store's version, not the
    topology's: the trainer raises, ``refresh()`` binds both versions, and
    the sampler keeps its placement."""
    topo, _ = _graph(n=128, e=1200, seed=14)
    rng = np.random.default_rng(14)
    feat = rng.normal(size=(128, 4)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 3, 128).astype(np.int64))
    mesh = _mesh(2, 4)
    store = _store(topo, feat, mesh)
    tr = _trainer(topo, store, mesh, 8)
    placed = tr.sampler.topo
    sg = StreamingGraph(topo, feature=store)
    assert sg.ingest(DeltaBatch(update_ids=np.array([5, 9]),
                                update_rows=np.full((2, 4), 2.5, np.float32)))
    res = sg.commit()
    assert res.version == 0 and res.rows_updated == 2
    assert (topo.version, store.version) == (0, 1)
    idx = rng.integers(0, 128, tr.global_batch)
    with pytest.raises(VersionMismatchError, match="refresh"):
        tr.step(idx, labels, 2)
    tr.refresh()
    assert tr._bound_versions == (0, 1) and tr.sampler.topo is placed
    assert np.isfinite(float(tr.step(idx, labels, 2)))


# -- CSRTopo hardening ----------------------------------------------------------------


def test_save_is_atomic(tmp_path, monkeypatch):
    topo, _ = _graph(n=64, e=400, seed=13)
    path = str(tmp_path / "topo.npz")
    topo.save(path)
    good = open(path, "rb").read()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        topo.save(path)
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    assert os.listdir(tmp_path) == ["topo.npz"]
    back = CSRTopo.load(path)
    assert np.array_equal(back.indptr, topo.indptr)


def test_load_truncated_raises_clearly(tmp_path):
    topo, _ = _graph(n=64, e=400, seed=14)
    path = str(tmp_path / "topo.npz")
    topo.save(path)
    blob = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    with open(trunc, "wb") as fh:
        fh.write(blob[: len(blob) // 3])
    with pytest.raises(ValueError, match="truncated|corrupt|readable"):
        CSRTopo.load(trunc)
    junk = str(tmp_path / "junk.npz")
    with open(junk, "wb") as fh:
        fh.write(b"not a zip at all")
    with pytest.raises(ValueError, match="truncated|corrupt|readable"):
        CSRTopo.load(junk)
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, indptr=topo.indptr)
    with pytest.raises(ValueError, match="indices"):
        CSRTopo.load(partial)


def test_ctor_rejects_negative_indices():
    with pytest.raises(ValueError, match="negative|\\[0, 1\\)"):
        CSRTopo(indptr=np.array([0, 2]), indices=np.array([0, -1]))


# -- the differentials (JAX's slow lane, here at small sizes) ------------------------------


def _diff_trainer(topo, feat_arr, mesh, local_batch):
    f = feat_arr.shape[1]
    # csr_topo=None: identity row order, so the incremental and the rebuilt
    # stores share one placement; the differential compares graph content
    store = qt.ShardedFeature(mesh, device_cache_size=24 * f * 4,
                              replicate_budget=8 * f * 4).from_cpu_tensor(feat_arr)
    return _trainer(topo, store, mesh, local_batch), store


def _same_params(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_epoch_differential_incremental_vs_rebuild():
    """Deltas committed at the epoch boundary against a rebuild from the
    equivalent final graph: the same CSR, the same sampled batches, and
    the same epoch-1 losses and parameters, bitwise."""
    n, f, lb = 384, 8, 16
    rng = np.random.default_rng(42)
    coo = rng.integers(0, n, size=(2, 4000)).astype(np.int64)
    feat0 = rng.normal(size=(n, f)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int64))
    mesh = _mesh(2, 4)
    ins = rng.integers(0, n, size=(2, 64)).astype(np.int64)
    del_pos = rng.choice(coo.shape[1], size=40, replace=False)
    upd_ids = rng.choice(n, size=24, replace=False)
    upd_rows = rng.normal(size=(24, f)).astype(np.float32)

    # incremental: epoch 0 on G0, commit at the boundary, refresh, epoch 1
    topo_inc = CSRTopo(edge_index=coo)
    tr_inc, store_inc = _diff_trainer(topo_inc, feat0, mesh, lb)
    idx = rng.integers(0, n, 4 * tr_inc.global_batch)
    seed_mat = tr_inc.pack_epoch(idx, seed=0)
    tr_inc.epoch_scan(seed_mat, labels, 7)
    state = ({k: v.clone() for k, v in tr_inc.model.state_dict().items()},
             copy.deepcopy(tr_inc.optimizer.state_dict()))
    sg = StreamingGraph(topo_inc, feature=store_inc, duplicates="allow")
    delta = DeltaBatch(edge_inserts=ins, edge_deletes=coo[:, del_pos], update_ids=upd_ids,
                       update_rows=upd_rows)
    assert sg.ingest(delta)
    assert sg.commit().version == 1
    with pytest.raises(VersionMismatchError):
        tr_inc.epoch_scan(seed_mat, labels, 21)
    tr_inc.refresh()
    losses_inc = tr_inc.epoch_scan(seed_mat, labels, 21)

    # JAX's commit of the same delta publishes the same CSR
    sg_j = qj.StreamingGraph(qj.CSRTopo(edge_index=coo), duplicates="allow")
    assert sg_j.ingest(qj.DeltaBatch(edge_inserts=ins, edge_deletes=coo[:, del_pos]))
    sg_j.commit()
    _same_csr(topo_inc, sg_j.csr_topo)

    # rebuild: the final graph from scratch, given the same post-epoch-0
    # state, seed matrix and key
    feat_final = feat0.copy()
    feat_final[upd_ids] = upd_rows
    topo_reb = CSRTopo(edge_index=_final_coo(coo, coo[:, del_pos], ins, n))
    for name in ("indptr", "indices"):
        a, b = getattr(topo_inc, name), getattr(topo_reb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert topo_inc.eid is None and topo_reb.eid is not None
    assert topo_inc.max_degree == topo_reb.max_degree
    tr_reb, _ = _diff_trainer(topo_reb, feat_final, mesh, lb)
    tr_reb.model.load_state_dict(state[0])
    tr_reb.optimizer.load_state_dict(state[1])
    losses_reb = tr_reb.epoch_scan(seed_mat, labels, 21)

    s_inc, s_reb = tr_inc.sampler, tr_reb.sampler
    out_i = s_inc.sample(idx[: lb * s_inc.workers], key=33)
    out_r = s_reb.sample(idx[: lb * s_reb.workers], key=33)
    assert torch.equal(out_i.n_id, out_r.n_id)
    for a, b in zip(out_i.adjs, out_r.adjs):
        assert torch.equal(a.edge_index, b.edge_index)
    assert torch.equal(losses_inc.view(torch.int32), losses_reb.view(torch.int32))
    assert _same_params(tr_inc.model.state_dict(), tr_reb.model.state_dict())


def test_mid_commit_crash_training_continues_unperturbed():
    """A commit that dies before publish leaves the run exactly as if it
    were never tried: epoch 1 runs on the old version, bitwise, with no
    refresh."""
    n, f, lb = 256, 8, 16
    rng = np.random.default_rng(43)
    coo = rng.integers(0, n, size=(2, 3000)).astype(np.int64)
    feat0 = rng.normal(size=(n, f)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int64))
    mesh = _mesh(2, 4)

    def run(crash: bool):
        topo = CSRTopo(edge_index=coo)
        tr, store = _diff_trainer(topo, feat0, mesh, lb)
        idx = np.random.default_rng(5).integers(0, n, 3 * tr.global_batch)
        seed_mat = tr.pack_epoch(idx, seed=0)
        tr.epoch_scan(seed_mat, labels, 7)
        if crash:
            sg = StreamingGraph(topo, feature=store)
            assert sg.ingest(DeltaBatch(edge_inserts=np.array([[1, 2], [3, 4]]),
                                        update_ids=np.array([0]),
                                        update_rows=np.ones((1, f), np.float32)))
            with pytest.raises(CommitAborted):
                sg.commit(inject_failure="verify")
            assert topo.version == 0 and store.version == 0
        losses = tr.epoch_scan(seed_mat, labels, 21)
        return losses, tr.model.state_dict()

    losses_a, params_a = run(crash=False)
    losses_b, params_b = run(crash=True)
    assert torch.equal(losses_a.view(torch.int32), losses_b.view(torch.int32))
    assert _same_params(params_a, params_b)


# -- the recorder, serving and the controller through a commit ---------------------------


def test_commit_abort_dumps_bundle(tmp_path):
    """An aborted commit dumps a bundle naming the commit stage and its
    cause, as JAX's does; a quarantined batch dumps one naming ingest."""
    from quiver_tpu.obs.recorder import FlightRecorder as FlightRecorderJ

    from quiver_tpu_torch.obs.recorder import verify_bundle

    rng = np.random.default_rng(5)
    coo = rng.integers(0, 64, size=(2, 256)).astype(np.int64)
    delta = rng.integers(0, 64, size=(2, 8))
    bundles = []
    for pkg, rec_cls, path in ((qt, qt.FlightRecorder, tmp_path / "pt"),
                               (qj, FlightRecorderJ, tmp_path / "pj")):
        rec = rec_cls(path)
        sg = pkg.StreamingGraph(pkg.CSRTopo(edge_index=coo), recorder=rec)
        assert sg.ingest(pkg.DeltaBatch(edge_inserts=delta))
        with pytest.raises(pkg.CommitAborted):
            sg.commit(inject_failure="merge")
        assert not sg.ingest(pkg.DeltaBatch(edge_inserts=np.array([[0], [64]])))
        bundles.append(rec.bundles())
    got, want = bundles
    assert [b[1]["reason"] for b in got] == ["commit_abort", "quarantine"]
    assert [(b[1]["reason"], b[1]["stage"], b[1]["attrs"]) for b in got] == \
        [(b[1]["reason"], b[1]["stage"], b[1]["attrs"]) for b in want]
    assert got[0][1]["stage"] == "commit" and got[0][1]["attrs"]["cause"]
    for path, _ in got:
        verify_bundle(path)


class FakeClock:
    def __call__(self):
        return 0.0


def _server_stack(n=60, e=400, seed=4, **server_kw):
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, size=(2, e))
    topo = CSRTopo(edge_index=coo)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    torch.manual_seed(seed)
    model = qt.GraphSAGE(6, 8, 3)
    sampler = GraphSageSampler(topo, [3, 2], device="cpu", seed=seed)
    feat = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x)
    server = qt.InferenceServer(sampler, model, feat, device="cpu", max_batch=1,
                                clock=FakeClock(), seed=5, **server_kw)
    return topo, coo, x, model, server


def _new_edge(topo):
    n = topo.node_count
    src = np.repeat(np.arange(n), topo.degree)
    live = set((src * n + topo.indices.astype(np.int64)).tolist())
    k = next(k for k in range(n * n) if k not in live)
    return np.array([[k // n], [k % n]])


def test_stale_serve_drill():
    """Commit a DeltaBatch, every serve path raises, ``refresh()``, and the
    server serves the mutated graph (and still matches its oracle)."""
    topo, coo, _, _, server = _server_stack()
    server.warmup()
    before = server.serve([7])[0]
    np.testing.assert_array_equal(before.result, server.oracle(7, before.seq))
    edge = _new_edge(topo)
    sg = StreamingGraph(topo)
    assert sg.ingest(DeltaBatch(edge_inserts=edge))
    sg.commit()
    sg_j = qj.StreamingGraph(qj.CSRTopo(edge_index=coo))
    assert sg_j.ingest(qj.DeltaBatch(edge_inserts=edge))
    sg_j.commit()
    _same_csr(topo, sg_j.csr_topo)
    for stale in (lambda: server.pump(force=True), server.warmup, lambda: server.oracle(7, 0)):
        with pytest.raises(VersionMismatchError):
            stale()
    compiles = server.recompiles
    server.refresh()
    assert server.recompiles > compiles  # a mutation pays its captures at the boundary
    after = server.serve([7])[0]
    assert after.done
    np.testing.assert_array_equal(after.result, server.oracle(7, after.seq))


def test_embedding_refresher_version_drill():
    topo, _, x, model, _ = _server_stack(seed=6)
    r = qt.EmbeddingRefresher(model, topo, x, device="cpu")
    with pytest.raises(VersionMismatchError):
        r.lookup([0])
    v0 = r.refresh()
    assert r.version == v0 and r.refreshes == 1
    assert tuple(r.lookup([0, 5, 59]).shape) == (3, 3)
    src, dst = _first_live_edge(topo)
    sg = StreamingGraph(topo)
    assert sg.ingest(DeltaBatch(edge_deletes=np.array([[src], [dst]])))
    sg.commit()
    with pytest.raises(VersionMismatchError):
        r.lookup([0])
    v1 = r.refresh()
    assert v1 > v0 and r.refreshes == 2
    assert tuple(r.lookup([0, 5, 59]).shape) == (3, 3)


def test_streaming_degree_prior_feeds_controller():
    """A commit's ``note_degree_update`` lands in the attached controller's
    sketch as a prior: the same hitters as JAX's store over the same
    commit."""
    from quiver_tpu.control import CacheController as CacheControllerJ
    from quiver_tpu.feature.shard import ShardedFeature as ShardedFeatureJ
    from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j

    rng = np.random.default_rng(3)
    coo = rng.integers(0, 200, size=(2, 1200))
    feat = rng.normal(size=(200, 8)).astype(np.float32)
    kw = {"device_cache_size": "1M", "replicate_budget": 8 * 32}
    tt, tj = CSRTopo(edge_index=coo), qj.CSRTopo(edge_index=coo)
    store = qt.ShardedFeature(_mesh(2, 4), csr_topo=tt, **kw).from_cpu_tensor(feat)
    store_j = ShardedFeatureJ(make_mesh_j(data=2, feature=4), csr_topo=tj,
                              **kw).from_cpu_tensor(feat)
    ctl, ctl_j = qt.CacheController().attach(store), CacheControllerJ().attach(store_j)
    assert not ctl.sketch.state()["hitters"]
    edges = rng.integers(0, 200, size=(2, 40))
    for sg, batch in ((StreamingGraph(tt, feature=store), DeltaBatch),
                      (qj.StreamingGraph(tj, feature=store_j), qj.DeltaBatch)):
        assert sg.ingest(batch(edge_inserts=edges))
        sg.commit()
    assert ctl.sketch.state()["hitters"]
    assert ctl.sketch.state() == ctl_j.sketch.state()


def test_serve_fed_controller_survives_a_commit():
    """A serve-fed controller re-tiers the store at an epoch boundary; a
    streaming commit then makes the ladder stale, ``refresh()`` places it
    again, and the controller's host state (sketch mass, decision trail)
    is untouched; answers match the oracle throughout (JAX's slow drill,
    at its configuration)."""
    n, dim = 240, 8
    rng = np.random.default_rng(4)
    topo = CSRTopo(edge_index=np.stack([rng.integers(0, n, 1600),
                                        rng.integers(0, n, 1600)]))
    feat = np.random.default_rng(4).normal(size=(n, dim)).astype(np.float32)
    store = qt.ShardedFeature(_mesh(2, 4), device_cache_size="1M", csr_topo=topo,
                              replicate_budget=16 * dim * 4).from_cpu_tensor(feat)

    class HeldSplit(qt.SplitTuner):
        # boundary moves held, as JAX's drill holds them: the cold-skewed
        # trace would shrink L0 before the epoch-end repin
        def decide(self, *a, **k):
            return None

    ctl = qt.CacheController(repin_min_gain=0.005, split_tuner=HeldSplit())
    torch.manual_seed(1)
    server = qt.InferenceServer(GraphSageSampler(topo, [4, 3], device="cpu", seed=1),
                                qt.GraphSAGE(dim, 16, 5), store, device="cpu", max_batch=4,
                                clock=FakeClock(), seed=3, controller=ctl)
    assert store._controller is ctl
    server.warmup()
    cold = np.argsort(topo.degree.astype(np.int64), kind="stable")[:4]
    nodes = np.tile(cold, 24)
    for r in server.serve(nodes[:8]):
        np.testing.assert_array_equal(r.result, server.oracle(r.node, r.seq))
    server.serve(nodes[8:])
    assert ctl.sketch.observed > 0
    v0 = store.version
    ctl.end_epoch(store)
    assert ctl.stats()["repins"] == 1 and store.version == v0 + 1
    for r in server.serve(nodes[:8]):
        np.testing.assert_array_equal(r.result, server.oracle(r.node, r.seq))
    observed, decisions = ctl.sketch.observed, list(ctl.decisions)
    sg = StreamingGraph(topo)
    assert sg.ingest(DeltaBatch(edge_inserts=_new_edge(topo)))
    sg.commit()
    with pytest.raises(VersionMismatchError):
        server.pump(force=True)
    server.refresh()
    assert ctl.sketch.observed == observed and ctl.decisions == decisions
    for r in server.serve(nodes[:4]):
        np.testing.assert_array_equal(r.result, server.oracle(r.node, r.seq))
