"""Graph topology containers.

``CSRTopo`` is the host-side CSR graph (the port of
``quiver_tpu.core.topology.CSRTopo``): built from COO ``edge_index`` or
from ``indptr``/``indices``, exposing ``degree``/``eid``/``feature_order``,
per-edge weights (``cum_weights``, the row-local prefix sums the weighted
hop searches) and per-edge timestamps (rows re-sorted by time for the
temporal hop). ``save``/``load`` persist it as one ``.npz`` with an
embedded CRC32 record or as a raw ``.npy`` directory
(:mod:`~quiver_tpu_torch.ooc.format`) that loads memory-mapped; files
cross-load with the JAX package's, bitwise. The COO -> CSR build is the
native host library's counting sort (``quiver_tpu_torch/native``) or a
numpy stable argsort plus bincount; both keep CSR slots within a row in
COO order, so ``eid`` maps them back.

``DeviceTopology`` is the sampling view: torch tensors in device memory
(``GPU`` mode) or with ``indices``/``eid``/``cum_weights`` in pinned host
memory, read over UVA by the select kernels (``UVA`` mode).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .config import SampleMode
from .memory import resolve_device, to_pinned_host

__all__ = ["CSRTopo", "DeviceTopology", "VersionMismatchError", "place_csr_arrays"]


class VersionMismatchError(RuntimeError):
    """A consumer holds a placement of graph state whose ``version`` no
    longer matches the committed host CSR. Raised instead of serving a
    stale read; call the consumer's ``refresh``/``refresh_topology``."""


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _index_dtype(max_value: int) -> np.dtype:
    return np.dtype(np.int32) if max_value <= np.iinfo(np.int32).max else np.dtype(np.int64)


def _build_csr(row, col, node_count: int, use_native: bool = False):
    """COO -> CSR; slots within a row keep COO order, so ``eid`` maps them
    back. ``use_native`` takes the native linear-time parallel build
    (``native.csr_from_coo``) when ``node_count`` fits int32 and the
    library is available, else a numpy stable argsort: the two give the
    same arrays (the native build's indices are int32, numpy's keep
    ``col``'s dtype; ``CSRTopo`` narrows both alike)."""
    if use_native and node_count <= np.iinfo(np.int32).max:
        from .. import native

        if native.available:
            # a failure inside the native build propagates; no fallback
            return native.csr_from_coo(row, col, node_count)
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=node_count)
    indptr = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, np.ascontiguousarray(col[order]), order


def _row_prefix_weights(w: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Row-local inclusive prefix sums of CSR-ordered edge weights.

    Computed in float64 (one global cumsum, rebased per row) and emitted
    float32. Rows whose total weight is <= 0 get the uniform prefix
    1..deg, so they sample uniformly instead of searching a flat CDF.
    """
    E = int(w.shape[0])
    deg = np.diff(indptr).astype(np.int64)
    starts = np.repeat(indptr[:-1].astype(np.int64), deg)  # row start per edge
    cw = np.cumsum(w, dtype=np.float64)
    base = np.where(starts > 0, cw[np.maximum(starts - 1, 0)], 0.0)
    prefix = cw - base
    ends = indptr[1:].astype(np.int64) - 1
    tot = np.where(deg > 0, prefix[np.maximum(ends, 0)], 0.0)
    bad = np.repeat(tot <= 0, deg)
    if bad.any():
        local = np.arange(E, dtype=np.int64) - starts
        prefix[bad] = (local[bad] + 1).astype(np.float64)
    return prefix.astype(np.float32)


def _time_sort_order(indptr: np.ndarray, times: np.ndarray) -> np.ndarray:
    """Permutation that stably sorts each CSR row's edges by timestamp;
    ties keep CSR slot order."""
    deg = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(deg.shape[0], dtype=np.int64), deg)
    # lexsort: last key (rows) is primary, stable on equal (row, time) pairs
    return np.lexsort((times, rows))


class CSRTopo:
    """CSR graph topology with degree and feature-order bookkeeping.

    Pass either ``edge_index`` (2, E) COO, or ``indptr`` + ``indices``.
    ``eid`` maps CSR edge slots back to COO edge positions (None when built
    from indptr/indices without one). ``indptr`` keeps the narrowest width
    that holds the edge count; ``indices`` the narrowest that holds the
    node ids. ``edge_weight``/``edge_time`` attach per-edge weights and
    timestamps (in COO order when built from ``edge_index``, else in CSR
    slot order); see :meth:`set_edge_weight` and :meth:`set_edge_time`.
    ``use_native`` builds the CSR from ``edge_index`` with the native host
    library when it is available (:func:`_build_csr`); the arrays and
    their dtypes are the numpy build's either way.
    """

    def __init__(self, edge_index=None, indptr=None, indices=None, eid=None,
                 edge_weight=None, edge_time=None, use_native: bool = True):
        if edge_index is not None:
            if indptr is not None or indices is not None:
                raise ValueError("pass either edge_index or indptr/indices, not both")
            edge_index = _as_numpy(edge_index)
            if edge_index.ndim != 2 or edge_index.shape[0] != 2:
                raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
            row, col = edge_index[0], edge_index[1]
            if edge_index.size and min(row.min(), col.min()) < 0:
                raise ValueError("edge_index must not contain negative node ids")
            node_count = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
            indptr, indices, eid = _build_csr(row, col, node_count, use_native)
        elif indptr is not None and indices is not None:
            indptr = _as_numpy(indptr).astype(np.int64, copy=False)
            indices = _as_numpy(indices)
            if eid is not None:
                eid = _as_numpy(eid)
            if indptr.ndim != 1 or indptr.shape[0] < 1 or indptr[0] != 0:
                raise ValueError("indptr must be 1-D and start at 0")
            if indices.ndim != 1:
                raise ValueError(f"indices must be 1-D, got shape {indices.shape}")
            if np.any(np.diff(indptr) < 0):
                raise ValueError("indptr must be non-decreasing")
            if int(indptr[-1]) != indices.shape[0]:
                raise ValueError(
                    f"indptr[-1]={int(indptr[-1])} != len(indices)={indices.shape[0]}"
                )
        else:
            raise ValueError("need edge_index or indptr+indices")

        node_count = int(indptr.shape[0] - 1)
        if indices.size:
            lo, hi = int(indices.min()), int(indices.max())
            if lo < 0 or hi >= node_count:
                raise ValueError(
                    f"indices must reference nodes in [0, {node_count}), "
                    f"got range [{lo}, {hi}]"
                )
        edge_count = int(indptr[-1])
        self._indptr = indptr.astype(_index_dtype(edge_count), copy=False)
        self._indices = indices.astype(_index_dtype(max(node_count - 1, 0)), copy=False)
        self._eid = None if eid is None else eid.astype(
            _index_dtype(max(edge_count - 1, 0)), copy=False)
        self._feature_order = None  # set by Feature's degree reorder
        self._edge_weight = None
        self._cum_weights = None
        self._edge_time = None
        self._max_degree = None
        # committed mutation version; device placements record the version
        # they were built from and raise VersionMismatchError once it moves
        self._version = 0
        # the WorldMesh a ShardedTopology placed this CSR's shards on (one
        # process per slot): a StreamingGraph commit votes over it
        self._world_mesh = None
        if edge_weight is not None:
            self.set_edge_weight(edge_weight, coo_order=edge_index is not None)
        if edge_time is not None:
            self.set_edge_time(edge_time, coo_order=edge_index is not None)

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr

    @property
    def indices(self) -> np.ndarray:
        return self._indices

    @property
    def eid(self) -> np.ndarray | None:
        return self._eid

    @property
    def feature_order(self) -> np.ndarray | None:
        """Old-node-id -> reordered-feature-row map, shared with Feature."""
        return self._feature_order

    @feature_order.setter
    def feature_order(self, order):
        order = _as_numpy(order)
        if order.shape != (self.node_count,):
            raise ValueError(
                f"feature_order must have shape ({self.node_count},), got {order.shape}"
            )
        self._feature_order = order

    # -- edge weights (weighted sampling) -----------------------------------

    def set_edge_weight(self, edge_weight, coo_order: bool = True) -> "CSRTopo":
        """Attach per-edge weights for weighted neighbour sampling.

        ``coo_order=True`` means the weights follow the COO edge order this
        topology was built from (translated through ``eid``); otherwise
        they are taken in CSR slot order. Weights must be finite and
        non-negative.
        """
        w = _as_numpy(edge_weight).astype(np.float64, copy=False).reshape(-1)
        if w.shape[0] != self.edge_count:
            raise ValueError(
                f"edge_weight must have {self.edge_count} entries, got {w.shape[0]}"
            )
        if w.size and not (np.isfinite(w).all() and w.min() >= 0):
            raise ValueError("edge weights must be finite and non-negative")
        if coo_order and self._eid is not None:
            w = w[self._eid]
        self._edge_weight = w.astype(np.float32)
        self._cum_weights = _row_prefix_weights(w, self._indptr)
        return self

    @property
    def edge_weight(self) -> np.ndarray | None:
        """Per-edge weights in CSR slot order (float32), or None."""
        return self._edge_weight

    @property
    def cum_weights(self) -> np.ndarray | None:
        """Row-local inclusive prefix sums of the edge weights (float32, CSR
        order); rows with non-positive total weight carry 1..deg."""
        return self._cum_weights

    # -- edge timestamps (temporal sampling) ---------------------------------

    def set_edge_time(self, edge_time, coo_order: bool = True) -> "CSRTopo":
        """Attach per-edge timestamps for time-windowed sampling.

        Each row's edges are stably re-sorted by time (``indices``, ``eid``
        and the weights follow; ``cum_weights`` is derived again), so the
        temporal hop can binary-search a ``[lo, hi]`` window to a slot
        range. The re-sort changes CSR slot order: attach timestamps before
        placing the topology. ``coo_order`` as in :meth:`set_edge_weight`.
        """
        t = _as_numpy(edge_time).astype(np.float64, copy=False).reshape(-1)
        if t.shape[0] != self.edge_count:
            raise ValueError(
                f"edge_time must have {self.edge_count} entries, got {t.shape[0]}"
            )
        if t.size and not np.isfinite(t).all():
            raise ValueError("edge times must be finite")
        if coo_order and self._eid is not None:
            t = t[self._eid]
        t = t.astype(np.float32)
        order = _time_sort_order(self._indptr, t)
        self._indices = self._indices[order]
        self._edge_time = t[order]
        if self._eid is not None:
            self._eid = self._eid[order]
        if self._edge_weight is not None:
            self._edge_weight = self._edge_weight[order]
            self._cum_weights = _row_prefix_weights(self._edge_weight,
                                                    self._indptr)
        return self

    @property
    def edge_time(self) -> np.ndarray | None:
        """Per-edge timestamps in CSR slot order (float32, each row sorted
        non-decreasing), or None."""
        return self._edge_time

    @property
    def version(self) -> int:
        """Committed mutation version (0 for a freshly built topology)."""
        return self._version

    def _publish_mutation(self, indptr: np.ndarray, indices: np.ndarray,
                          edge_weight: np.ndarray | None = None,
                          edge_time: np.ndarray | None = None) -> None:
        """The one mutation seam (a streaming commit's publish): swap in
        merged, already verified CSR arrays and bump the version. Every
        array is built aside before this runs, so no reader sees a half
        applied merge. ``eid`` is dropped (COO provenance does not survive
        a mutation); ``feature_order`` is kept (mutations add no nodes).
        A weighted or timestamped topology must be published with its
        merged weights or times; timestamped rows are re-sorted by time
        (ties in slot order), restoring the temporal hop's invariant.
        Every placement built before raises
        :class:`VersionMismatchError` until it is refreshed."""
        if (self._edge_weight is not None) != (edge_weight is not None):
            raise ValueError(
                "mutation publish must carry edge weights exactly when the "
                "topology is weighted"
            )
        if (self._edge_time is not None) != (edge_time is not None):
            raise ValueError(
                "mutation publish must carry edge times exactly when the "
                "topology is timestamped"
            )
        indptr, indices = _as_numpy(indptr), _as_numpy(indices)
        edge_count = int(indptr[-1])
        node_count = int(indptr.shape[0] - 1)
        indptr = indptr.astype(_index_dtype(edge_count), copy=False)
        indices = indices.astype(
            _index_dtype(max(node_count - 1, 0)), copy=False)
        if edge_time is not None:
            t = _as_numpy(edge_time).astype(np.float32, copy=False)
            # appended inserts land at row ends: re-sort each row by time
            # (the identity on untouched rows)
            order = _time_sort_order(indptr, t)
            indices = indices[order]
            t = t[order]
            if edge_weight is not None:
                edge_weight = _as_numpy(edge_weight)[order]
            self._edge_time = t
        if edge_weight is not None:
            self._edge_weight = _as_numpy(edge_weight).astype(np.float32,
                                                              copy=False)
            self._cum_weights = _row_prefix_weights(
                self._edge_weight.astype(np.float64), indptr)
        self._indptr = indptr
        self._indices = indices
        self._eid = None
        self._max_degree = None  # degrees changed; derived again on demand
        self._version += 1

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self._indptr)

    @property
    def max_degree(self) -> int:
        if self._max_degree is None:
            self._max_degree = int(self.degree.max(initial=0))
        return self._max_degree

    @property
    def node_count(self) -> int:
        return int(self._indptr.shape[0] - 1)

    @property
    def edge_count(self) -> int:
        return int(self._indptr[-1])

    def __repr__(self):
        return f"CSRTopo(nodes={self.node_count}, edges={self.edge_count})"

    # -- persistence --------------------------------------------------------

    def _persist_arrays(self) -> dict:
        """Every array worth round-tripping, keyed by canonical name.
        ``cum_weights`` rides along so a load never pays the O(E) prefix
        recompute; the raw format's mmap loads depend on that."""
        arrays = {"indptr": self._indptr, "indices": self._indices}
        for name in ("eid", "edge_weight", "cum_weights", "edge_time",
                     "feature_order"):
            v = getattr(self, f"_{name}")
            if v is not None:
                arrays[name] = v
        return arrays

    def save(self, path: str, format: str = "npz") -> None:
        """Persist the topology (CSR + eid + weights + feature_order).

        ``format="npz"`` (default) writes one ``.npz`` — the reference's
        users ``torch.save`` their CSR preprocessing artifacts
        (benchmarks/ogbn-papers100M/preprocess.py); this is the same
        round-trip in a file the JAX package reads too. A ``_integrity`` member
        (JSON, per-array CRC32 via the raw-manifest helper) rides inside
        the zip so :meth:`load` can catch silent byte corruption, not
        just zip-level truncation.

        ``format="raw"`` writes the mmap-native directory layout
        (:mod:`quiver_tpu_torch.ooc.format`): per-array uncompressed ``.npy``
        files + CRC32 manifest + COMMIT marker. This is the out-of-core
        path — :meth:`load` with ``mmap=True`` backs ``indptr``/
        ``indices``/edge attrs onto ``np.memmap`` so resident bytes stay
        O(touched pages). Derived state (``cum_weights``, ``max_degree``)
        is persisted so the load path never runs an O(E) or O(N) scan.

        Both formats publish atomically (same-filesystem temp + fsync +
        ``os.replace``): a crash mid-save can leave a stale temp behind
        but never a torn artifact at ``path``."""
        if format == "raw":
            from ..ooc.format import save_raw_dir  # lazy: ooc sits above core

            save_raw_dir(path, self._persist_arrays(), meta={
                "kind": "csr-topo",
                "node_count": self.node_count,
                "edge_count": self.edge_count,
                "max_degree": self.max_degree,
                "version": self._version,
            })
            return
        if format != "npz":
            raise ValueError(f'format must be "npz" or "raw", got {format!r}')
        from ..resilience.integrity import array_checksum  # lazy (cycle)
        import json

        arrays = self._persist_arrays()
        arrays.pop("cum_weights", None)  # npz loads re-derive (legacy shape)
        integrity = json.dumps(
            {name: array_checksum(v) for name, v in arrays.items()},
            sort_keys=True,
        )
        # JSON-as-uint8 smuggles the checksums through np.savez without
        # allow_pickle; readers that predate it just see an extra member
        arrays["_integrity"] = np.frombuffer(
            integrity.encode(), dtype=np.uint8
        )
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:  # exact filename, no np suffixing
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def _from_raw(cls, arrays: dict, meta: dict) -> "CSRTopo":
        """Assemble a topology from raw-format arrays WITHOUT running
        ``__init__`` — its O(N)/O(E) boundary scans and int64 coercion
        would page every byte of an mmap'd load in, defeating the
        out-of-core point. Safe because the arrays were validated on the
        way INTO :func:`~..ooc.format.save_raw_dir` (they came
        from a live CSRTopo) and the format's manifest pins their exact
        sizes; run ``ooc.verify_raw_dir`` for a full byte-level sweep."""
        topo = cls.__new__(cls)
        topo._indptr = arrays["indptr"]
        topo._indices = arrays["indices"]
        topo._eid = arrays.get("eid")
        topo._feature_order = arrays.get("feature_order")
        topo._edge_weight = arrays.get("edge_weight")
        topo._cum_weights = arrays.get("cum_weights")
        topo._edge_time = arrays.get("edge_time")
        topo._max_degree = (
            int(meta["max_degree"]) if "max_degree" in meta else None
        )
        topo._version = int(meta.get("version", 0))
        return topo

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "CSRTopo":
        """Rebuild a :meth:`save`'d topology (either format — a directory
        at ``path`` is the raw layout, a file is the legacy ``.npz``).

        ``mmap=True`` (raw format only) backs every array onto read-only
        ``np.memmap``: resident bytes stay O(touched pages) and no
        validation scan runs (see :meth:`_from_raw`) — the papers100M
        path, where the CSR alone outgrows host RAM. Eager raw loads
        (``mmap=False``) run the full CRC32 sweep instead.

        Legacy ``.npz``: weights re-derive their per-row prefix sums
        (stored CSR-ordered, so coo_order is False on the way back in);
        when the archive carries a ``_integrity`` member the per-array
        CRC32s are verified, so silent byte corruption fails as loudly
        as zip-level truncation. A truncated, corrupt, or foreign file
        raises a clear ``ValueError`` naming the artifact — np.load's
        raw zipfile errors (or a KeyError three stack frames later) left
        the operator guessing which file was bad."""
        import zipfile

        if os.path.isdir(path):
            from ..ooc.format import load_raw_dir  # lazy: ooc sits above core

            arrays, meta = load_raw_dir(path, mmap=mmap)
            if meta.get("kind") != "csr-topo":
                raise ValueError(
                    f"{path}: raw dir holds {meta.get('kind')!r}, not a "
                    f"csr-topo artifact"
                )
            return cls._from_raw(arrays, meta)
        if mmap:
            raise ValueError(
                f"{path}: mmap loading needs the raw directory format — "
                f'save with format="raw" (a legacy .npz is a zip that '
                f"must be decompressed into RAM)"
            )
        try:
            z = np.load(path)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"{path}: not a readable topology file — truncated, "
                f"corrupt, or not an .npz ({type(e).__name__}: {e})"
            ) from None
        with z:
            cls._verify_npz_integrity(path, z)
            missing = [k for k in ("indptr", "indices") if k not in z.files]
            if missing:
                raise ValueError(
                    f"{path}: topology file lacks required array(s) "
                    f"{missing} (has {sorted(z.files)}) — truncated save "
                    f"or not a CSRTopo artifact"
                )
            try:
                topo = cls(indptr=z["indptr"], indices=z["indices"],
                           eid=z["eid"] if "eid" in z.files else None)
            except (OSError, ValueError, EOFError,
                    zipfile.BadZipFile) as e:
                raise ValueError(
                    f"{path}: topology arrays failed to load/validate "
                    f"({e})"
                ) from None
            if "edge_weight" in z.files:
                topo.set_edge_weight(z["edge_weight"], coo_order=False)
            if "edge_time" in z.files:
                # stored post-sort, so the re-sort inside is the identity
                topo.set_edge_time(z["edge_time"], coo_order=False)
            if "feature_order" in z.files:
                topo.feature_order = z["feature_order"]
        return topo

    @staticmethod
    def _verify_npz_integrity(path: str, z) -> None:
        """Check the ``_integrity`` CRC32 record an npz :meth:`save`
        embeds (absent on pre-record archives — those load unverified,
        backward compatible). Raises ``ValueError`` naming the first
        corrupt array."""
        if "_integrity" not in z.files:
            return
        import json
        import zipfile

        from ..resilience.integrity import array_checksum  # lazy (cycle)

        try:
            expected = json.loads(bytes(z["_integrity"]).decode())
        except (ValueError, UnicodeDecodeError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"{path}: unreadable _integrity record ({e})"
            ) from None
        for name, crc in expected.items():
            if name not in z.files:
                raise ValueError(
                    f"{path}: _integrity covers array {name!r} but the "
                    f"archive lacks it — truncated or tampered save"
                )
            try:
                got = array_checksum(z[name])
            except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
                # the zip's own member CRC can fire first on corrupt bytes
                raise ValueError(
                    f"{path}: array {name!r} unreadable — corrupt bytes "
                    f"({type(e).__name__}: {e})"
                ) from None
            if got != int(crc):
                raise ValueError(
                    f"{path}: checksum mismatch on array {name!r} "
                    f"(stored {crc}, computed {got}) — corrupt bytes"
                )

    def to_device(self, mode: SampleMode | str = SampleMode.HBM, device=None,
                  with_eid: bool = False, with_weights: bool = False,
                  with_times: bool = False) -> "DeviceTopology":
        """Place the topology for sampling on ``device`` (CUDA by default).

        ``GPU``/``HBM`` mode puts every array in device memory. ``UVA``/
        ``HOST`` mode keeps the per-edge arrays (``indices``, ``eid``,
        ``cum_weights``) in pinned host memory and ``indptr`` on the
        device; on a CPU device the arrays simply stay in host memory.
        ``with_weights`` places ``cum_weights`` (needs
        :meth:`set_edge_weight`); ``with_times`` places ``edge_time``
        (needs :meth:`set_edge_time`; ``GPU`` mode only, since the window
        search reads timestamps in plain torch ops).
        """
        if with_weights and self._cum_weights is None:
            raise ValueError(
                "weighted sampling requires edge weights; call "
                "set_edge_weight() or pass edge_weight= to CSRTopo"
            )
        mode = SampleMode.parse(mode)
        if with_times:
            if self._edge_time is None:
                raise ValueError(
                    "temporal sampling requires edge timestamps; call "
                    "set_edge_time() or pass edge_time= to CSRTopo"
                )
            if mode is not SampleMode.HBM:
                raise ValueError(
                    "temporal sampling requires mode='GPU': the window "
                    "search reads timestamps in device memory"
                )
        return place_csr_arrays(
            self._indptr, self._indices, self._eid if with_eid else None,
            self._cum_weights if with_weights else None, self.max_degree,
            mode, device, edge_time=self._edge_time if with_times else None)


def _host_tensor(a) -> torch.Tensor:
    """A tensor over the numpy array ``a``, with no copy. A read-only
    array (a ``CSRTopo.load(mmap=True)`` memmap) is wrapped as it is: the
    placement's one copy to the device reads the file once, and nothing
    writes through the wrapper."""
    a = np.ascontiguousarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def place_csr_arrays(indptr, indices, eid, cum_weights, max_degree: int,
                     mode: SampleMode | str, device=None,
                     edge_time=None) -> "DeviceTopology":
    """The CSR placement that ``CSRTopo`` and the heterogeneous
    ``RelCSR`` share: numpy arrays in, a :class:`DeviceTopology` out.

    ``HBM`` mode puts every array on ``device`` (CUDA unless named);
    ``HOST`` mode keeps the per-edge arrays (``indices``, ``eid``,
    ``cum_weights``) in pinned host memory, read over UVA, and ``indptr``
    on the device. Pass ``eid``, ``cum_weights`` or ``edge_time`` as None
    to leave them out (``edge_time`` is placed on the device; the callers
    allow it in ``HBM`` mode only). The weighted and temporal searches'
    iteration bound derives from ``max_degree``.
    """
    mode = SampleMode.parse(mode)
    device = resolve_device(device)
    indptr = _host_tensor(indptr).to(device)
    per_edge = [indices, eid, cum_weights]
    host = False
    if mode is SampleMode.HOST:
        placed = [None if a is None else to_pinned_host(a, device)[0]
                  for a in per_edge]
        host = device.type == "cuda"
    else:
        placed = [None if a is None else _host_tensor(a).to(device) for a in per_edge]
    indices, eid, cum_weights = placed
    if edge_time is not None:
        edge_time = _host_tensor(edge_time).to(device)
    iters = (max(int(np.ceil(np.log2(max_degree + 1))), 1)
             if cum_weights is not None or edge_time is not None else 0)
    return DeviceTopology(indptr, indices, eid, cum_weights=cum_weights,
                          edge_time=edge_time, host_indices=host,
                          search_iters=iters, max_degree=int(max_degree))


class DeviceTopology:
    """CSR tensors placed for sampling.

    ``host_indices`` is True when ``indices``/``eid``/``cum_weights`` live
    in pinned host memory (UVA mode); the select kernels then read them
    over PCIe. ``indptr`` (and ``edge_time``) always live on the sampling
    device. ``search_iters`` bounds the weighted and temporal binary
    searches: ``ceil(log2(max_degree + 1))`` (at least 1) when weights or
    times are placed, else 0.
    """

    def __init__(self, indptr, indices, eid=None, cum_weights=None,
                 edge_time=None, host_indices: bool = False,
                 search_iters: int = 0, max_degree: int | None = None):
        self.indptr = indptr
        self.indices = indices
        self.eid = eid
        self.cum_weights = cum_weights
        self.edge_time = edge_time
        self.host_indices = host_indices
        self.search_iters = int(search_iters)
        self.max_degree = max_degree

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def node_count(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def edge_count(self) -> int:
        return self.indices.shape[0]
