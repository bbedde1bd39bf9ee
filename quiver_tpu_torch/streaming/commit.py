"""Atomic epoch-boundary commits of staged deltas.

The port of ``quiver_tpu/streaming/commit.py``. A commit runs in three
steps:

1. **Merge aside.** :func:`merge_csr` builds the post-mutation ``indptr``
   / ``indices`` as fresh arrays; the committed CSR is never touched. Per
   row, surviving old neighbours keep their slot order and inserts append
   in ingestion order: the layout a full ``CSRTopo(edge_index=final_coo)``
   rebuild gives (a stable sort by row), which makes the incremental path
   bitwise a rebuild. A delete removes the earliest matching occurrence
   (old slots first, then staged inserts in order).
2. **Verify.** :func:`verify_merged_csr` derives every invariant again
   from the output arrays: ``indptr`` starts at 0 and is monotone, ``E' =
   E + inserts - deletes``, every neighbour id is in range, the node count
   is unchanged, and the untouched rows' adjacency has the same CRC32 as
   before, so a merge bug cannot corrupt rows no delta named.
3. **Publish.** One ``CSRTopo._publish_mutation`` swaps the verified
   arrays in and bumps the version once; the collapsed row updates publish
   through ``ShardedFeature.apply_row_updates`` in the same transaction.
   Consumers placed from the old version (samplers, trainers, servers)
   raise :class:`~quiver_tpu_torch.core.topology.VersionMismatchError`
   until their ``refresh`` seams place the new one.

Any failure before publish aborts the whole transaction: the staged
batches are quarantined with the reason (``streaming.deltas_quarantined``),
the committed state is untouched, and :class:`CommitAborted` propagates.
``commit(inject_failure=)`` forces that path at a named stage. With a
store on a world mesh (one process per slot), or a topology whose shards
a ``ShardedTopology`` placed on one, every rank stages the same batches
and commits together: between the build-aside and the publish the ranks
count their failures over the world (one integer ``all_reduce``), and a
failure on any one rank, of whatever kind, aborts every rank, so all
publish or none does.

Admission reads the live-edge multiset only at the pairs a batch's
deletes name (:meth:`StreamingGraph._live_pair_counts`), counted from
those deletes' source rows and the staged batches, so an ``ingest`` costs
the batch and the rows it names, not the whole graph.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..core.topology import CSRTopo, VersionMismatchError
from ..obs.registry import (
    DELTAS_COMMITTED,
    DELTAS_QUARANTINED,
    STREAMING_COMMITS,
    MetricsRegistry,
)
from ..parallel import world
from ..parallel.mesh import current_world, is_world
from ..utils.trace import get_logger
from .delta import (DeltaBatch, DeltaRejected, _as_edge_array, encode_pairs,
                    validate_delta)

__all__ = [
    "CommitAborted",
    "CommitResult",
    "QuarantineRecord",
    "StreamingGraph",
    "merge_csr",
    "verify_merged_csr",
]


class CommitAborted(RuntimeError):
    """A commit failed before publish. The pre-commit state is intact
    bitwise (nothing was applied); the staged batches were quarantined
    with the failure reason."""


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One quarantined ingestion or commit failure: where it failed
    (``stage``: "ingest" or "commit"), why, and the offending batches."""

    stage: str
    reason: str
    deltas: tuple[DeltaBatch, ...]


@dataclasses.dataclass(frozen=True)
class CommitResult:
    """Summary of one published commit."""

    version: int
    batches: int
    edges_inserted: int
    edges_deleted: int
    rows_updated: int
    edge_count: int


def merge_csr(indptr: np.ndarray, indices: np.ndarray,
              inserts: np.ndarray | None, deletes: np.ndarray | None,
              attrs: dict | None = None):
    """Merge COO edge inserts / deletes into fresh CSR arrays.

    Returns ``(new_indptr, new_indices, touched)``, ``touched`` the
    boolean per-row mask of rows whose adjacency changed. The inputs are
    only read; untouched rows are copied in contiguous runs.

    ``attrs`` threads per-edge attribute columns through the merge:
    ``{name: (old_column, insert_column)}``, ``old_column`` ``(E,)`` in the
    committed slot order and ``insert_column`` one value per ``inserts``
    column (or None with no inserts). A kept slot keeps its attribute, an
    appended insert brings its own, a deleted slot's is dropped, so the
    columns stay aligned with ``new_indices`` slot for slot; the return
    then gains a fourth element, ``{name: new_column}``.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    n = int(indptr.shape[0] - 1)
    deg = np.diff(indptr)

    # per source row: (neighbour id, insert column); the column is the
    # provenance the attribute columns are gathered by
    ins_by_row: dict[int, list[tuple[int, int]]] = {}
    if inserts is not None and inserts.shape[1]:
        for i, (s, d) in enumerate(
                zip(inserts[0].tolist(), inserts[1].tolist())):
            ins_by_row.setdefault(int(s), []).append((int(d), i))
    del_by_row: dict[int, dict[int, int]] = {}
    if deletes is not None and deletes.shape[1]:
        for s, d in zip(deletes[0].tolist(), deletes[1].tolist()):
            cnt = del_by_row.setdefault(int(s), {})
            cnt[int(d)] = cnt.get(int(d), 0) + 1

    touched = np.zeros(n, dtype=bool)
    for r in ins_by_row:
        touched[r] = True
    for r in del_by_row:
        touched[r] = True

    new_deg = deg.copy()
    for r in ins_by_row:
        new_deg[r] += len(ins_by_row[r])
    for r, cnt in del_by_row.items():
        new_deg[r] -= sum(cnt.values())
    if (new_deg < 0).any():
        bad = int(np.argwhere(new_deg < 0)[0, 0])
        raise DeltaRejected(
            f"row {bad} would end with negative degree after deletes — "
            f"more deletes than live edges (admission should have caught "
            f"this; the staged set is inconsistent)"
        )
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_indptr[1:])
    new_indices = np.empty(int(new_indptr[-1]), dtype=np.int64)
    new_attrs = None
    if attrs is not None:
        new_attrs = {
            name: np.empty(int(new_indptr[-1]), dtype=old.dtype)
            for name, (old, _) in attrs.items()
        }

    # copy each untouched span between touched rows as one slice; rebuild
    # only the touched rows, in Python (O(touched))
    prev = 0
    for r in np.flatnonzero(touched).tolist():
        if r > prev:  # the untouched run [prev, r)
            new_indices[new_indptr[prev]:new_indptr[r]] = \
                indices[indptr[prev]:indptr[r]]
            if attrs is not None:
                for name, (old_col, _) in attrs.items():
                    new_attrs[name][new_indptr[prev]:new_indptr[r]] = \
                        old_col[indptr[prev]:indptr[r]]
        old = indices[indptr[r]:indptr[r + 1]].tolist()
        pending = dict(del_by_row.get(r, {}))
        kept = []
        src = []  # provenance: old slot >= 0, insert column i as -(i + 1)
        for j, v in enumerate(old):
            if pending.get(v, 0) > 0:
                pending[v] -= 1  # the earliest occurrence goes first
            else:
                kept.append(v)
                src.append(int(indptr[r]) + j)
        # inserts append in ingestion order
        for v, i in ins_by_row.get(r, ()):
            if pending.get(v, 0) > 0:
                pending[v] -= 1  # a delete staged after the insert it names
            else:
                kept.append(v)
                src.append(-(i + 1))
        new_indices[new_indptr[r]:new_indptr[r + 1]] = kept
        if attrs is not None and kept:
            src = np.asarray(src, dtype=np.int64)
            old_slot = src >= 0
            for name, (old_col, ins_col) in attrs.items():
                seg = np.empty(len(kept), dtype=old_col.dtype)
                seg[old_slot] = old_col[src[old_slot]]
                if (~old_slot).any():
                    seg[~old_slot] = ins_col[-src[~old_slot] - 1]
                new_attrs[name][new_indptr[r]:new_indptr[r + 1]] = seg
        prev = r + 1
    if prev < n:
        new_indices[new_indptr[prev]:] = indices[indptr[prev]:]
        if attrs is not None:
            for name, (old_col, _) in attrs.items():
                new_attrs[name][new_indptr[prev]:] = old_col[indptr[prev]:]
    if attrs is None:
        return new_indptr, new_indices, touched
    return new_indptr, new_indices, touched, new_attrs


def _untouched_crc(indptr: np.ndarray, indices: np.ndarray,
                   touched: np.ndarray) -> int:
    """CRC32 over the untouched rows' adjacency bytes (canonical int64),
    streamed span by span."""
    crc = 0
    n = int(indptr.shape[0] - 1)
    prev = 0
    for r in np.flatnonzero(touched).tolist():
        if r > prev:
            span = np.ascontiguousarray(
                indices[int(indptr[prev]):int(indptr[r])], dtype=np.int64
            )
            crc = zlib.crc32(span.tobytes(), crc)
        prev = r + 1
    if prev < n:
        span = np.ascontiguousarray(
            indices[int(indptr[prev]):], dtype=np.int64
        )
        crc = zlib.crc32(span.tobytes(), crc)
    return crc & 0xFFFFFFFF


def verify_merged_csr(old_indptr, old_indices, new_indptr, new_indices,
                      touched: np.ndarray, inserted: int,
                      deleted: int) -> None:
    """Derive every post-merge invariant again; raise
    :class:`DeltaRejected` naming the first violation. It reads only the
    output arrays, not :func:`merge_csr`'s internals, so a merge bug is
    caught here rather than published."""
    old_indptr = np.asarray(old_indptr, dtype=np.int64)
    new_indptr = np.asarray(new_indptr, dtype=np.int64)
    n = int(old_indptr.shape[0] - 1)
    if int(new_indptr.shape[0] - 1) != n:
        raise DeltaRejected(
            f"post-merge node count {int(new_indptr.shape[0] - 1)} != {n}: "
            f"the owner map of every sharded consumer would break"
        )
    if int(new_indptr[0]) != 0:
        raise DeltaRejected("post-merge indptr does not start at 0")
    if (np.diff(new_indptr) < 0).any():
        bad = int(np.argwhere(np.diff(new_indptr) < 0)[0, 0])
        raise DeltaRejected(
            f"post-merge indptr is not monotone at row {bad}"
        )
    if int(new_indptr[-1]) != new_indices.shape[0]:
        raise DeltaRejected(
            f"post-merge indptr[-1]={int(new_indptr[-1])} != "
            f"len(indices)={new_indices.shape[0]}"
        )
    expected = int(old_indptr[-1]) + int(inserted) - int(deleted)
    if int(new_indptr[-1]) != expected:
        raise DeltaRejected(
            f"edge-count arithmetic failed: {int(old_indptr[-1])} + "
            f"{inserted} - {deleted} = {expected}, merge produced "
            f"{int(new_indptr[-1])}"
        )
    if new_indices.size:
        lo, hi = int(new_indices.min()), int(new_indices.max())
        if lo < 0 or hi >= n:
            raise DeltaRejected(
                f"post-merge indices reference node ids outside "
                f"[0, {n}) (range [{lo}, {hi}])"
            )
    # untouched rows: the same degree and the same content as before
    un = ~np.asarray(touched, dtype=bool)
    if not np.array_equal(np.diff(old_indptr)[un], np.diff(new_indptr)[un]):
        bad = int(np.flatnonzero(
            un & (np.diff(old_indptr) != np.diff(new_indptr))
        )[0])
        raise DeltaRejected(
            f"untouched row {bad} changed degree — the merge leaked "
            f"outside the delta's footprint"
        )
    old_crc = _untouched_crc(old_indptr, old_indices, touched)
    new_crc = _untouched_crc(new_indptr, new_indices, touched)
    if old_crc != new_crc:
        raise DeltaRejected(
            f"untouched-range checksum mismatch (pre {old_crc:#x} vs "
            f"post {new_crc:#x}) — the merge corrupted rows the deltas "
            f"never named"
        )


_FAIL_STAGES = ("merge", "verify", "features")
# the build-aside failures that reject the staged batches (CommitAborted);
# any other error propagates as it is
_REJECTIONS = (DeltaRejected, ValueError, VersionMismatchError)


class StreamingGraph:
    """Transactional mutation of resident graph state.

    Owns the staging buffer, the admission boundary, the quarantine log
    and the atomic commit of staged deltas into a :class:`CSRTopo` and,
    when attached, a ``ShardedFeature``'s rows. The device-side consumers
    (samplers, trainers, servers) are not mutated here: they see the
    version bump through their own checks and place again through their
    ``refresh`` seams.

    Args:
      csr_topo: the committed host CSR. Its edge weights and times, if
        any, ride the merge slot for slot (inserts bring their own through
        ``DeltaBatch.edge_weights`` / ``edge_times``; a deleted slot's go
        with it). ``eid`` does not survive a mutation.
      feature: optional store whose rows the batches update (it needs
        ``apply_row_updates``; ``note_degree_update`` runs after a commit
        that changed the topology).
      duplicates: ``"error"`` (the default) refuses duplicate edge inserts
        and update ids in a batch; ``"allow"`` admits parallel edges and
        collapses duplicate update ids last-wins.
      recorder: an optional ``FlightRecorder``; an aborted commit or a
        quarantined batch dumps a bundle naming the stage.
    """

    def __init__(self, csr_topo: CSRTopo, feature=None,
                 duplicates: str = "error", recorder=None):
        if duplicates not in ("error", "allow"):
            raise ValueError(
                f"duplicates must be 'error' or 'allow', got {duplicates!r}"
            )
        self.csr_topo = csr_topo
        self.recorder = recorder
        # admission's schema mirrors the committed topology's attributes
        self.needs_weights = csr_topo.edge_weight is not None
        self.needs_times = csr_topo.edge_time is not None
        self.feature = feature
        if feature is not None and not hasattr(feature, "apply_row_updates"):
            raise ValueError(
                "feature must support transactional row updates "
                "(ShardedFeature.apply_row_updates); got "
                f"{type(feature).__name__}"
            )
        self.duplicates = duplicates
        self._staged: list[DeltaBatch] = []
        self.quarantined: list[QuarantineRecord] = []
        self._quarantined_total = 0
        self._committed_total = 0
        self._commits_total = 0
        self.metrics = MetricsRegistry()
        self.metrics.counter(
            DELTAS_QUARANTINED, unit="batches",
            doc="delta batches rejected at admission or by a failed "
                "commit (quarantined with a reason, never applied)",
        )
        self.metrics.counter(
            DELTAS_COMMITTED, unit="batches",
            doc="delta batches merged by a published commit",
        )
        self.metrics.counter(
            STREAMING_COMMITS, unit="commits",
            doc="published commits (= version bumps)",
        )

    # -- staging ------------------------------------------------------------

    @property
    def staged(self) -> tuple[DeltaBatch, ...]:
        """The admitted, not yet committed batches (a read-only view)."""
        return tuple(self._staged)

    def staged_counts(self) -> tuple[int, int, int]:
        """Total staged (edge inserts, edge deletes, row updates)."""
        ei = ed = u = 0
        for d in self._staged:
            a, b, c = d.counts()
            ei, ed, u = ei + a, ed + b, u + c
        return ei, ed, u

    def _live_pair_counts(self, delta: DeltaBatch) -> dict[int, int]:
        """The live-edge multiset (the committed CSR adjusted by the
        staged batches) at the encoded pairs ``delta``'s deletes name: all
        that :func:`validate_delta` reads of it. The committed edges are
        counted from those deletes' source rows only. Malformed or
        out-of-range deletes give ``{}``: admission refuses them before it
        reads the multiset."""
        if delta.edge_deletes is None:
            return {}
        n = self.csr_topo.node_count
        try:
            dele = _as_edge_array(delta.edge_deletes, "edge_deletes")
        except DeltaRejected:
            return {}
        if not dele.shape[1] or dele.min() < 0 or dele.max() >= n:
            return {}
        keys = np.unique(encode_pairs(dele[0], dele[1], n))
        rows = np.unique(dele[0])
        indptr = self.csr_topo.indptr
        lo = indptr[rows].astype(np.int64)
        deg = indptr[rows + 1].astype(np.int64) - lo
        # the slots of the named rows, row after row
        first = np.cumsum(deg) - deg
        slots = np.arange(int(deg.sum()), dtype=np.int64) + np.repeat(lo - first, deg)
        cand = [encode_pairs(np.repeat(rows, deg), self.csr_topo.indices[slots], n)]
        sign = [np.ones(cand[0].shape[0], np.int64)]
        for d in self._staged:
            for arr, s in ((d.edge_inserts, 1), (d.edge_deletes, -1)):
                if arr is not None and arr.shape[1]:
                    cand.append(encode_pairs(arr[0], arr[1], n))
                    sign.append(np.full(arr.shape[1], s, np.int64))
        cand, sign = np.concatenate(cand), np.concatenate(sign)
        named = np.isin(cand, keys)
        uniq, inv = np.unique(cand[named], return_inverse=True)
        counts = np.zeros(uniq.shape[0], np.int64)
        np.add.at(counts, inv, sign[named])
        return dict(zip(uniq.tolist(), counts.tolist()))

    def _quarantine(self, stage: str, reason: str,
                    deltas: tuple[DeltaBatch, ...]) -> None:
        self.quarantined.append(QuarantineRecord(stage, reason, deltas))
        self._quarantined_total += len(deltas)
        self.metrics.set(
            DELTAS_QUARANTINED, np.int32(self._quarantined_total)
        )
        get_logger("streaming").warning(
            "quarantined %d delta batch(es) at %s: %s",
            len(deltas), stage, reason,
        )
        if self.recorder is not None:
            self.recorder.trigger(
                "commit_abort" if stage == "commit" else "quarantine",
                stage=stage, cause=reason, batches=len(deltas),
            )

    def ingest(self, delta: DeltaBatch) -> bool:
        """Admission-check ``delta`` and stage it for the next commit.

        True when staged. On any failing check the batch is quarantined
        whole with the reason (``quarantined`` and
        ``streaming.deltas_quarantined``) and False returns; the
        duplicate and existence accounting includes the batches staged
        before it."""
        try:
            if not isinstance(delta, DeltaBatch):
                raise DeltaRejected(
                    f"expected a DeltaBatch, got {type(delta).__name__}"
                )
            fs = None
            if self.feature is not None:
                fs = self.feature.shape
            normalized = validate_delta(
                delta, self.csr_topo.node_count, fs,
                live_pair_counts=self._live_pair_counts(delta),
                duplicates=self.duplicates,
                needs_weights=self.needs_weights,
                needs_times=self.needs_times,
            )
        except DeltaRejected as e:
            self._quarantine("ingest", str(e), (delta,))
            return False
        self._staged.append(normalized)
        return True

    # -- commit -------------------------------------------------------------

    def _world(self):
        """The world mesh this commit votes over: the attached store's,
        else, with no store on a mesh, the one whose ranks hold the
        committed CSR's shards while that world is up (None: no world)."""
        mesh = getattr(self.feature, "mesh", None)
        if mesh is None:
            mesh = self.csr_topo._world_mesh
            if mesh is not current_world():
                return None
        return mesh if is_world(mesh) else None

    def _world_aborts(self, aborted: bool) -> int:
        """The ranks that abort this commit, summed over :meth:`_world`
        (one ``int_sum`` on the rank's device; every rank enters it); 0 or
        1 with no world."""
        mesh = self._world()
        if mesh is None:
            return int(aborted)
        axes = mesh.axis_names
        flag = torch.full((), int(aborted), dtype=torch.int32, device=mesh.device)
        return int(world.int_sum(flag, mesh.group(axes), axes, mark=False))

    def _collapse_updates(self):
        """Fold the staged row updates into one last-wins ``(ids, rows)``
        pair in first-touch order: what applying the batches one after
        another gives."""
        merged: dict[int, np.ndarray] = {}
        for d in self._staged:
            if d.update_ids is None:
                continue
            for i, node in enumerate(d.update_ids.tolist()):
                merged[int(node)] = d.update_rows[i]
        if not merged:
            return None, None
        ids = np.fromiter(merged.keys(), dtype=np.int64, count=len(merged))
        rows = np.stack([merged[int(i)] for i in ids])
        return ids, rows

    def commit(self, inject_failure: str | None = None) -> CommitResult | None:
        """Publish every staged batch at once; returns the
        :class:`CommitResult` (None when nothing is staged).

        The merged CSR and the collapsed row updates are built and
        verified aside, then published with one version bump each
        (topology, feature). Any failure before publish quarantines the
        whole staged set with the reason, leaves the committed state
        bitwise as it was and raises :class:`CommitAborted`. After a
        commit that changed the topology, the new degrees go to the
        attached store's ``note_degree_update``.

        ``inject_failure`` forces the abort at stage ``"merge"``,
        ``"verify"`` or ``"features"``: a crash at any point before
        publish, after which the old version is intact.

        With a store on a world mesh (one process per slot), or with no
        store on a mesh and the CSR's shards placed on a world, every rank
        commits the same staged batches at once. After the build-aside the
        ranks sum their failure flags over the world, whatever the error;
        a failure on any rank aborts every rank (each quarantines its
        batches; a rank whose error was no rejection raises it as it is,
        the others :class:`CommitAborted`), else every rank publishes: the
        topology, the row updates into its own parts of the store, the
        degree feed. Each rank's sampler re-places its own shard at its
        ``refresh``.
        """
        if inject_failure is not None and inject_failure not in _FAIL_STAGES:
            raise ValueError(
                f"inject_failure must be one of {_FAIL_STAGES}, "
                f"got {inject_failure!r}"
            )
        if not self._staged:
            return None
        staged = tuple(self._staged)
        topo = self.csr_topo
        failure = None
        try:
            ins_parts = [d.edge_inserts for d in staged
                         if d.edge_inserts is not None
                         and d.edge_inserts.shape[1]]
            del_parts = [d.edge_deletes for d in staged
                         if d.edge_deletes is not None
                         and d.edge_deletes.shape[1]]
            inserts = np.concatenate(ins_parts, axis=1) if ins_parts else None
            deletes = np.concatenate(del_parts, axis=1) if del_parts else None
            n_ins = 0 if inserts is None else int(inserts.shape[1])
            n_del = 0 if deletes is None else int(deletes.shape[1])
            old_indptr = np.asarray(topo.indptr, dtype=np.int64)
            old_indices = np.asarray(topo.indices)
            topo_changed = bool(n_ins or n_del)
            # the attribute columns ride the merge: one insert column per
            # staged batch, concatenated in the inserts' own order
            attrs = None
            if self.needs_weights or self.needs_times:
                attrs = {}
                for name, needed, old_col in (
                    ("edge_weight", self.needs_weights, topo.edge_weight),
                    ("edge_time", self.needs_times, topo.edge_time),
                ):
                    if not needed:
                        continue
                    parts = [
                        getattr(d, name + "s") for d in staged
                        if d.edge_inserts is not None
                        and d.edge_inserts.shape[1]
                    ]
                    attrs[name] = (
                        np.asarray(old_col),
                        np.concatenate(parts) if parts else None,
                    )
            if inject_failure == "merge":
                raise DeltaRejected(
                    "injected commit failure at stage 'merge' (chaos seam)"
                )
            new_attrs = {}
            if topo_changed:
                merged = merge_csr(
                    old_indptr, old_indices, inserts, deletes, attrs
                )
                if attrs is None:
                    new_indptr, new_indices, touched = merged
                else:
                    new_indptr, new_indices, touched, new_attrs = merged
            else:
                new_indptr, new_indices = old_indptr, old_indices
                touched = np.zeros(topo.node_count, dtype=bool)
            if inject_failure == "verify":
                raise DeltaRejected(
                    "injected commit failure at stage 'verify' (chaos seam)"
                )
            if topo_changed:
                verify_merged_csr(
                    old_indptr, old_indices, new_indptr, new_indices,
                    touched, n_ins, n_del,
                )
            upd_ids, upd_rows = self._collapse_updates()
            if inject_failure == "features":
                raise DeltaRejected(
                    "injected commit failure at stage 'features' "
                    "(chaos seam)"
                )
        except Exception as e:  # every rank votes whatever failed
            failure = e
        aborts = self._world_aborts(failure is not None)
        if failure is None and aborts:
            failure = DeltaRejected(
                f"{aborts} other rank(s) of the world aborted this commit")
        if failure is not None:
            rejected = isinstance(failure, _REJECTIONS)
            if rejected or self._world() is not None:
                # on a world every rank drops the batches, whatever failed
                self._staged.clear()
                self._quarantine("commit", str(failure), staged)
            if not rejected:
                raise failure
            raise CommitAborted(
                f"commit of {len(staged)} staged batch(es) aborted before "
                f"publish: {failure} (pre-commit state intact; batches "
                f"quarantined)"
            ) from failure
        # ---- publish: everything above is verified and aside ----
        if topo_changed:
            topo._publish_mutation(
                new_indptr, new_indices,
                edge_weight=new_attrs.get("edge_weight"),
                edge_time=new_attrs.get("edge_time"),
            )
        if upd_ids is not None:
            self.feature.apply_row_updates(upd_ids, upd_rows)
        self._staged.clear()
        self._committed_total += len(staged)
        self._commits_total += 1
        self.metrics.set(DELTAS_COMMITTED, np.int32(self._committed_total))
        self.metrics.set(STREAMING_COMMITS, np.int32(self._commits_total))
        if topo_changed and self.feature is not None:
            # the tiers follow the mutation: the new degrees feed the
            # store's split tuner
            self.feature.note_degree_update(topo.degree)
        result = CommitResult(
            version=topo.version,
            batches=len(staged),
            edges_inserted=n_ins,
            edges_deleted=n_del,
            rows_updated=0 if upd_ids is None else int(upd_ids.shape[0]),
            edge_count=topo.edge_count,
        )
        get_logger("streaming").info(
            "committed v%d: %d batch(es), +%d/-%d edges (E=%d), %d row "
            "update(s); stale consumers must refresh",
            result.version, result.batches, n_ins, n_del,
            result.edge_count, result.rows_updated,
        )
        return result
