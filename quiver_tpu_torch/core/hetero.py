"""Heterogeneous graph topology: typed nodes, typed relations.

The port of ``quiver_tpu/core/hetero.py``. A ``HeteroCSRTopo`` holds one
rectangular CSR per canonical relation ``(src_type, rel_name, dst_type)``,
stored as *incoming* adjacency (row = destination node, columns = its
source neighbours): sampling expands from seed (destination) nodes toward
the sources that message them, the direction PyG's NeighborSampler walks.

A relation is a rectangular graph whose rows live in the dst-type id space
and whose column values live in the src-type id space; it is built and
placed by the homogeneous machinery (``_build_csr``, ``place_csr_arrays``).
"""

from __future__ import annotations

import numpy as np

from .config import SampleMode
from .topology import (DeviceTopology, _as_numpy, _build_csr, _index_dtype,
                       _row_prefix_weights, place_csr_arrays)

__all__ = ["HeteroCSRTopo", "RelCSR"]


class RelCSR:
    """Rectangular CSR for one relation: rows = dst nodes, cols = src nodes.

    Column values index a *different* (src-type) id space, so the square
    graph's validation does not apply; ``src_node_count`` bounds them.
    """

    def __init__(self, indptr, indices, src_node_count: int, eid=None):
        self._indptr = indptr.astype(np.int64, copy=False)
        # the narrowest widths that hold the ids, as CSRTopo keeps them
        # (the select kernels read int32 indices and eids)
        self._indices = indices.astype(
            _index_dtype(max(int(src_node_count) - 1, 0)), copy=False)
        self._eid = None if eid is None else eid.astype(
            _index_dtype(max(indices.shape[0] - 1, 0)), copy=False)
        self._edge_weight = None
        self._cum_weights = None
        self.src_node_count = int(src_node_count)
        if indices.size and int(indices.max()) >= src_node_count:
            raise ValueError(
                f"relation references src node {int(indices.max())} but the "
                f"src type only has {src_node_count} nodes"
            )

    @classmethod
    def from_edge_index(cls, edge_index, num_dst: int, num_src: int,
                        use_native: bool = True) -> "RelCSR":
        """Build from a ``(2, E)`` ``[src_ids, dst_ids]`` COO (PyG's
        convention). ``use_native`` is accepted for the JAX package's
        signature and does nothing: the port makes every CSR with numpy's
        stable argsort, which gives the native ``csr_from_coo``'s arrays
        (its port is ROADMAP A.13)."""
        edge_index = _as_numpy(edge_index)
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
        src, dst = edge_index[0], edge_index[1]
        if edge_index.size:
            if src.min() < 0 or dst.min() < 0:
                raise ValueError("edge_index must not contain negative node ids")
            if int(dst.max()) >= num_dst:
                raise ValueError(
                    f"dst id {int(dst.max())} out of range for {num_dst} dst nodes"
                )
        # incoming CSR: row = dst, col = src
        indptr, indices, eid = _build_csr(dst, src, num_dst)
        return cls(indptr, indices, num_src, eid)

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr

    @property
    def indices(self) -> np.ndarray:
        return self._indices

    @property
    def node_count(self) -> int:
        """Destination-side node count (the CSR's row count)."""
        return int(self._indptr.shape[0] - 1)

    @property
    def edge_count(self) -> int:
        return int(self._indptr[-1])

    @property
    def degree(self) -> np.ndarray:
        """In-degree of each dst node under this relation."""
        return np.diff(self._indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degree.max(initial=0))

    @property
    def eid(self) -> np.ndarray | None:
        """CSR slot -> original COO edge position (None for direct builds)."""
        return self._eid

    def set_edge_weight(self, edge_weight, coo_order: bool = True) -> "RelCSR":
        """Attach per-edge weights, as ``CSRTopo.set_edge_weight``:
        ``coo_order=True`` takes them in the COO build order (translated
        through ``eid``), else in CSR slot order."""
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
        return self._edge_weight

    @property
    def cum_weights(self) -> np.ndarray | None:
        return self._cum_weights

    def to_device(self, mode: SampleMode | str = SampleMode.HBM,
                  with_eid: bool = False, with_weights: bool = False,
                  device=None) -> DeviceTopology:
        """Place the relation for sampling on ``device`` (CUDA unless
        named), through ``CSRTopo``'s placement: ``HOST`` mode keeps
        ``indices``, ``eid`` and ``cum_weights`` in pinned host memory."""
        if with_weights and self._cum_weights is None:
            raise ValueError(
                "weighted sampling requires edge weights; call "
                "set_edge_weight() on this relation first"
            )
        return place_csr_arrays(
            self._indptr, self._indices, self._eid if with_eid else None,
            self._cum_weights if with_weights else None, self.max_degree,
            mode, device)


class HeteroCSRTopo:
    """Typed multi-relation graph container.

    Args:
      num_nodes: ``{node_type: count}``.
      edge_index_dict: ``{(src_type, rel_name, dst_type): (2, E) [src,
        dst]}``.
      use_native: accepted and inert (see :meth:`RelCSR.from_edge_index`).
      edge_weight_dict: optional ``{edge_type: weights}`` in COO order.

    Types are normalised to strings. The per-relation CSRs are incoming
    (dst -> src neighbours): a sampler seeded with dst-type nodes draws
    the sources that message them.
    """

    def __init__(self, num_nodes: dict, edge_index_dict: dict,
                 use_native: bool = True, edge_weight_dict: dict | None = None):
        self.num_nodes = {str(t): int(n) for t, n in num_nodes.items()}
        self.relations: dict[tuple, RelCSR] = {}
        for etype, ei in edge_index_dict.items():
            if len(etype) != 3:
                raise ValueError(
                    f"edge type must be (src_type, rel, dst_type), got {etype!r}"
                )
            s, r, d = (str(t) for t in etype)
            if s not in self.num_nodes or d not in self.num_nodes:
                raise ValueError(f"unknown node type in relation {etype!r}")
            self.relations[(s, r, d)] = RelCSR.from_edge_index(
                ei, self.num_nodes[d], self.num_nodes[s], use_native
            )
        for etype, w in (edge_weight_dict or {}).items():
            self.set_edge_weight(etype, w)

    def set_edge_weight(self, edge_type, edge_weight,
                        coo_order: bool = True) -> "HeteroCSRTopo":
        """Attach per-edge weights to one relation (COO order by default)."""
        et = tuple(str(t) for t in edge_type)
        if et not in self.relations:
            raise ValueError(f"unknown relation {edge_type!r}")
        self.relations[et].set_edge_weight(edge_weight, coo_order)
        return self

    @property
    def weighted_edge_types(self) -> list:
        return [et for et, rel in self.relations.items()
                if rel.cum_weights is not None]

    @property
    def node_types(self) -> list:
        return list(self.num_nodes)

    @property
    def edge_types(self) -> list:
        return list(self.relations)

    def rels_into(self, dst_type: str) -> list:
        """Relations whose destination is ``dst_type`` (sampling fan-in)."""
        return [et for et in self.relations if et[2] == dst_type]

    def __repr__(self):
        return (
            f"HeteroCSRTopo(nodes={self.num_nodes}, "
            f"relations={[f'{s}-{r}->{d}' for s, r, d in self.relations]})"
        )

    def to_device(self, mode: SampleMode | str = SampleMode.HBM,
                  with_eid: bool = False, weighted_rels=(),
                  device=None) -> dict:
        """``{edge_type: DeviceTopology}`` on ``device`` (CUDA unless
        named); the relations in ``weighted_rels`` carry their
        ``cum_weights``."""
        weighted_rels = {tuple(et) for et in weighted_rels}
        unknown = weighted_rels - set(self.relations)
        if unknown:
            raise ValueError(f"unknown weighted relations: {unknown}")
        return {
            et: rel.to_device(mode, with_eid=with_eid,
                              with_weights=et in weighted_rels, device=device)
            for et, rel in self.relations.items()
        }
