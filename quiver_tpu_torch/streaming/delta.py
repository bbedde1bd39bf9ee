"""Delta batches and their admission validation.

The port of ``quiver_tpu/streaming/delta.py``. A :class:`DeltaBatch` is
the unit of streaming graph mutation: edge inserts, edge deletes and
feature row updates that arrived together and must land together.
:func:`validate_delta` is the ingestion boundary: every check runs before
a batch is staged, so a malformed batch is quarantined whole and nothing
downstream (the merge, the device placements) ever sees it. The checks,
in order, each with the JAX package's message word for word:

* **structure**: edge arrays are ``(2, E)`` integer COO; update ids are
  1-D integers with a matching ``(U, feature_dim)`` float row block;
* **range**: every endpoint and update id lies in ``[0, node_count)``
  (deltas never add nodes, so every sharded consumer's owner map
  ``v // rows_per_shard`` stays valid);
* **duplicates** within one batch: duplicate edge inserts and update ids
  are rejected under ``duplicates="error"`` (the default); under
  ``"allow"`` parallel edges are admitted and duplicate update ids
  collapse last-wins. An insert parallel to a live edge is always
  admitted (COO-built graphs are multigraphs);
* **edge attributes**: a weighted or timestamped topology needs one
  weight / time per inserted edge, and an unattributed one refuses them
  (``missing-`` / ``unexpected-`` / ``bad-edge-weights`` and
  ``-edge-times``), under ``CSRTopo.set_edge_weight`` / ``set_edge_time``'s
  rules (finite; weights non-negative);
* **update rows**: finite float rows; a NaN / Inf row is refused here,
  not cached and served;
* **delete existence**: every delete names a live edge of the committed
  CSR plus the already-staged batches (multiset accounting, so an insert
  staged earlier in a window can be deleted later in it).

The batch's arrays are numpy, as the port's ``CSRTopo`` keeps its host
CSR in numpy; CPU tensors are taken too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.topology import _as_numpy

__all__ = ["DeltaBatch", "DeltaRejected", "validate_delta", "encode_pairs"]


class DeltaRejected(ValueError):
    """A delta batch failed admission (or its commit failed verification)
    and was quarantined with this reason. The batch was never, and will
    never be, applied in whole or in part."""


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One atomic unit of streaming mutation.

    ``edge_inserts`` / ``edge_deletes`` are ``(2, E)`` COO arrays (``[0]``
    the source row, ``[1]`` the destination) over the existing node ids;
    ``update_ids`` / ``update_rows`` the feature rows to overwrite (node
    ids and their new ``(U, feature_dim)`` values). ``edge_weights`` /
    ``edge_times`` hold one attribute per inserted edge, aligned to the
    ``edge_inserts`` columns: required when the committed topology is
    weighted / timestamped, refused when it is not. Any field may be
    ``None``. ``tag`` labels the batch in quarantine records and logs.
    """

    edge_inserts: np.ndarray | None = None
    edge_deletes: np.ndarray | None = None
    update_ids: np.ndarray | None = None
    update_rows: np.ndarray | None = None
    edge_weights: np.ndarray | None = None
    edge_times: np.ndarray | None = None
    tag: str = ""

    def counts(self) -> tuple[int, int, int]:
        """(edge inserts, edge deletes, feature row updates)."""
        ei = 0 if self.edge_inserts is None else self.edge_inserts.shape[1]
        ed = 0 if self.edge_deletes is None else self.edge_deletes.shape[1]
        u = 0 if self.update_ids is None else self.update_ids.shape[0]
        return int(ei), int(ed), int(u)

    def __repr__(self):
        ei, ed, u = self.counts()
        tag = f" tag={self.tag!r}" if self.tag else ""
        return f"DeltaBatch(+{ei}e, -{ed}e, ~{u}rows{tag})"


def encode_pairs(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Encode (src, dst) endpoints as one int64 key each for multiset
    accounting: ``src * n + dst``, exact for ``n`` up to the int32 node id
    ceiling (``n**2 < 2**63``)."""
    return src.astype(np.int64) * np.int64(n) + dst.astype(np.int64)


def _as_edge_array(arr, what: str) -> np.ndarray:
    arr = _as_numpy(arr)
    if arr.ndim != 2 or arr.shape[0] != 2:
        raise DeltaRejected(
            f"{what} must be a (2, E) COO array, got shape {arr.shape}"
        )
    if not np.issubdtype(arr.dtype, np.integer):
        raise DeltaRejected(
            f"{what} must carry integer node ids, got dtype {arr.dtype}"
        )
    return arr.astype(np.int64, copy=False)


def _check_range(arr: np.ndarray, n: int, what: str) -> None:
    if arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= n:
        raise DeltaRejected(
            f"{what} reference node ids outside [0, {n}) "
            f"(range [{lo}, {hi}]); streaming deltas never add nodes"
        )


def _admit_edge_attr(vals, n_ins: int, needed: bool, name: str, *,
                     nonneg: bool) -> np.ndarray | None:
    """Check one per-inserted-edge attribute column against the committed
    topology's schema (``needed``): the float32 column, or None, or
    :class:`DeltaRejected` with a named reason (``missing-`` /
    ``unexpected-`` / ``bad-`` + ``name``)."""
    attr = name.replace("-", "_")  # the DeltaBatch field named in messages
    if needed and n_ins and vals is None:
        raise DeltaRejected(
            f"missing-{name}: the committed topology carries per-edge "
            f"{name.split('-')[1]}; every inserted edge must supply one "
            f"(DeltaBatch.{attr} aligned to the edge_inserts columns)"
        )
    if vals is None:
        return None
    if not needed:
        raise DeltaRejected(
            f"unexpected-{name}: the committed topology carries no "
            f"per-edge {name.split('-')[1]}; attach them to the CSR "
            f"before streaming attributed deltas"
        )
    vals = _as_numpy(vals).reshape(-1)
    if vals.shape[0] != n_ins:
        raise DeltaRejected(
            f"bad-{name}: need one entry per inserted edge ({n_ins}), "
            f"got {vals.shape[0]}"
        )
    if not np.issubdtype(vals.dtype, np.number) or np.issubdtype(
            vals.dtype, np.complexfloating):
        raise DeltaRejected(
            f"bad-{name}: must be real numbers, got dtype {vals.dtype}"
        )
    vals = vals.astype(np.float32)
    if vals.size and not np.isfinite(vals).all():
        raise DeltaRejected(f"bad-{name}: values must be finite")
    if nonneg and vals.size and vals.min() < 0:
        # CSRTopo.set_edge_weight's rule: a negative weight would break
        # the row's CDF search
        raise DeltaRejected(f"bad-{name}: values must be non-negative")
    return vals


def validate_delta(
    delta: DeltaBatch,
    node_count: int,
    feature_shape: tuple[int, int] | None,
    *,
    live_pair_counts: dict[int, int] | None = None,
    duplicates: str = "error",
    needs_weights: bool = False,
    needs_times: bool = False,
) -> DeltaBatch:
    """Admission-check ``delta``; return the normalised batch or raise
    :class:`DeltaRejected` naming the first failing check.

    ``feature_shape`` is the attached store's ``(n, feature_dim)`` (None:
    no store, so row updates are refused). ``live_pair_counts`` maps
    encoded pairs (:func:`encode_pairs`) to their live multiplicity (the
    committed CSR adjusted by the staged batches); only the keys this
    batch's deletes name are read, so a dict restricted to them gives the
    same verdict. None skips the existence check. ``duplicates``:
    ``"error"`` refuses duplicate edge inserts and update ids, ``"allow"``
    admits parallel edges and collapses duplicate update ids last-wins.
    ``needs_weights`` / ``needs_times`` mirror the committed topology's
    edge attributes.
    """
    if duplicates not in ("error", "allow"):
        raise ValueError(
            f"duplicates must be 'error' or 'allow', got {duplicates!r}"
        )
    n = int(node_count)
    ins = dele = ids = rows = None

    if delta.edge_inserts is not None:
        ins = _as_edge_array(delta.edge_inserts, "edge_inserts")
        _check_range(ins, n, "edge_inserts")
        if duplicates == "error" and ins.shape[1]:
            keys = encode_pairs(ins[0], ins[1], n)
            uniq, cnt = np.unique(keys, return_counts=True)
            if (cnt > 1).any():
                k = int(uniq[np.argmax(cnt)])
                raise DeltaRejected(
                    f"duplicate edge insert ({k // n}, {k % n}) in one "
                    f"batch (duplicates='error'; pass 'allow' for "
                    f"parallel edges)"
                )

    # the attributes mirror the committed topology exactly: a weighted or
    # timestamped CSR never gains attribute-less rows
    n_ins = 0 if ins is None else int(ins.shape[1])
    wts = _admit_edge_attr(
        delta.edge_weights, n_ins, needs_weights, "edge-weights",
        nonneg=True,
    )
    tms = _admit_edge_attr(
        delta.edge_times, n_ins, needs_times, "edge-times", nonneg=False,
    )

    if delta.edge_deletes is not None:
        dele = _as_edge_array(delta.edge_deletes, "edge_deletes")
        _check_range(dele, n, "edge_deletes")

    if (delta.update_ids is None) != (delta.update_rows is None):
        raise DeltaRejected(
            "update_ids and update_rows must be passed together"
        )
    if delta.update_ids is not None:
        if feature_shape is None:
            raise DeltaRejected(
                "delta carries feature row updates but no feature store "
                "is attached to the streaming graph"
            )
        ids = _as_numpy(delta.update_ids).reshape(-1)
        if not np.issubdtype(ids.dtype, np.integer):
            raise DeltaRejected(
                f"update_ids must be integers, got dtype {ids.dtype}"
            )
        ids = ids.astype(np.int64, copy=False)
        _check_range(ids, min(n, int(feature_shape[0])), "update_ids")
        rows = _as_numpy(delta.update_rows)
        f = int(feature_shape[1])
        if rows.ndim != 2 or rows.shape != (ids.shape[0], f):
            raise DeltaRejected(
                f"update_rows must be ({ids.shape[0]}, {f}) to match "
                f"update_ids and the store's feature dim, got {rows.shape}"
            )
        if not np.issubdtype(rows.dtype, np.floating):
            raise DeltaRejected(
                f"update_rows must be float rows, got dtype {rows.dtype}"
            )
        if rows.size and not np.isfinite(rows).all():
            bad = int(np.argwhere(~np.isfinite(rows).all(axis=1))[0, 0])
            raise DeltaRejected(
                f"update_rows contain non-finite values (first bad row: "
                f"update index {bad}, node {int(ids[bad])}); a poisoned "
                f"row is rejected at the boundary, not cached and served"
            )
        if ids.size and np.unique(ids).shape[0] != ids.shape[0]:
            if duplicates == "error":
                raise DeltaRejected(
                    "duplicate update_ids in one batch "
                    "(duplicates='error'; pass 'allow' for last-wins)"
                )
            # last-wins collapse: keep the last occurrence of each id
            _, last = np.unique(ids[::-1], return_index=True)
            keep = np.sort(ids.shape[0] - 1 - last)
            ids, rows = ids[keep], rows[keep]

    # delete existence against the committed-plus-staged multiset: every
    # delete names a live edge; over-deleting rejects the whole batch
    if dele is not None and dele.shape[1] and live_pair_counts is not None:
        keys = encode_pairs(dele[0], dele[1], n)
        avail = dict(live_pair_counts)
        if ins is not None and ins.shape[1]:
            for k in encode_pairs(ins[0], ins[1], n).tolist():
                avail[k] = avail.get(k, 0) + 1
        for k in keys.tolist():
            have = avail.get(k, 0)
            if have <= 0:
                raise DeltaRejected(
                    f"edge delete ({k // n}, {k % n}) does not match a "
                    f"live edge (committed + staged); deletes must name "
                    f"existing edges"
                )
            avail[k] = have - 1

    return DeltaBatch(
        edge_inserts=ins, edge_deletes=dele,
        update_ids=ids, update_rows=rows,
        edge_weights=wts, edge_times=tms, tag=delta.tag,
    )
