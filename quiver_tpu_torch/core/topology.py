"""Graph topology containers.

``CSRTopo`` is the host-side CSR graph (the port of
``quiver_tpu.core.topology.CSRTopo``): built from COO ``edge_index`` or
from ``indptr``/``indices``, exposing ``degree``/``eid``/``feature_order``.
The COO -> CSR build is a numpy stable argsort plus bincount, so CSR slots
within a row follow COO order and ``eid`` maps them back.

``DeviceTopology`` is the sampling view: torch tensors in device memory
(``GPU`` mode) or with ``indices``/``eid`` in pinned host memory, read
over UVA by the select kernel (``UVA`` mode).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SampleMode
from .memory import resolve_device, to_pinned_host

__all__ = ["CSRTopo", "DeviceTopology", "VersionMismatchError"]


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


def _build_csr(row, col, node_count: int):
    """COO -> CSR by stable argsort: slots within a row keep COO order."""
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=node_count)
    indptr = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, np.ascontiguousarray(col[order]), order


class CSRTopo:
    """CSR graph topology with degree and feature-order bookkeeping.

    Pass either ``edge_index`` (2, E) COO, or ``indptr`` + ``indices``.
    ``eid`` maps CSR edge slots back to COO edge positions (None when built
    from indptr/indices without one). ``indptr`` keeps the narrowest width
    that holds the edge count; ``indices`` the narrowest that holds the
    node ids.
    """

    def __init__(self, edge_index=None, indptr=None, indices=None, eid=None):
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
            indptr, indices, eid = _build_csr(row, col, node_count)
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
        self._max_degree = None
        # committed mutation version; device placements record the version
        # they were built from and raise VersionMismatchError once it moves
        self._version = 0

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

    @property
    def version(self) -> int:
        """Committed mutation version (0 for a freshly built topology)."""
        return self._version

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

    def to_device(self, mode: SampleMode | str = SampleMode.HBM, device=None,
                  with_eid: bool = False) -> "DeviceTopology":
        """Place the topology for sampling on ``device`` (CUDA by default).

        ``GPU``/``HBM`` mode puts every array in device memory. ``UVA``/
        ``HOST`` mode keeps ``indices`` (and ``eid``) in pinned host memory
        and ``indptr`` on the device; on a CPU device the arrays simply
        stay in host memory.
        """
        device = resolve_device(device)
        mode = SampleMode.parse(mode)
        indptr = torch.from_numpy(np.ascontiguousarray(self._indptr)).to(device)
        eid = self._eid if with_eid else None
        host = False
        if mode is SampleMode.HOST:
            indices, host = to_pinned_host(self._indices, device)
            if eid is not None:
                eid = to_pinned_host(eid, device)[0]
        else:
            indices = torch.from_numpy(np.ascontiguousarray(self._indices)).to(device)
            if eid is not None:
                eid = torch.from_numpy(np.ascontiguousarray(eid)).to(device)
        return DeviceTopology(indptr, indices, eid, host_indices=host,
                              max_degree=self.max_degree)


class DeviceTopology:
    """CSR tensors placed for sampling.

    ``host_indices`` is True when ``indices``/``eid`` live in pinned host
    memory (UVA mode); the select kernel then reads them over PCIe.
    ``indptr`` always lives on the sampling device.
    """

    def __init__(self, indptr, indices, eid=None, host_indices: bool = False,
                 max_degree: int | None = None):
        self.indptr = indptr
        self.indices = indices
        self.eid = eid
        self.host_indices = host_indices
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
