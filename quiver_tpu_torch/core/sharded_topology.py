"""Mesh-sharded graph topology: the CSR itself partitioned over a mesh axis.

The port of ``quiver_tpu/core/sharded_topology.py``. A replicated
``DeviceTopology`` bounds the largest graph by one device's memory;
``ShardedTopology`` is a contiguous row-range partition of ``indptr`` /
``indices`` over the mesh's ``feature`` axis, with the owner-offset layout
of ``ShardedTensor`` (``feature/shard.py``): shard ``d`` owns rows ``[d *
rows_per_shard, (d + 1) * rows_per_shard)`` and ``owner(v) = v //
rows_per_shard``. The distributed sampler (``sampling/dist.py``) routes
each frontier vertex to the shard that owns its row.

Layout, as in the JAX package:

* shard ``d``'s ``indptr`` is rebased to local edge offsets,
  ``csr.indptr[d*rps : (d+1)*rps + 1] - csr.indptr[d*rps]``, with rows
  past ``node_count`` repeating the last offset (degree 0);
* its ``indices`` (and the optional ``cum_weights`` / ``edge_time``) are
  the CSR's segment, zero-padded to the widest shard (the pad is never
  addressed: local offsets stay below the shard's edge count). The
  prefix weights are row-local, so a shard's slice is bitwise the
  replicated array's segment.

Where the JAX package places an ``(F, ...)`` array with one block per
device, each shard here is a tensor of its own on member ``d``'s device
(``indptr[d]``, ``indices[d]``, ...). On a logical mesh of one card every
member is that card.

On a world mesh (``parallel/mesh.py`` ``WorldMesh``, one process per
slot) a rank holds only its own shard ``d``, its index in its group along
the axis (:attr:`ShardedTopology.member`): the lists hold that one tensor.
Every rank partitions the same host CSR: the geometry (``rows_per_shard``,
the padded edge width, the ``indptr`` dtype) comes from ``indptr`` alone,
so every rank agrees on it, and only the rank's own edge segment is
copied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import FEATURE_AXIS, axis_devices, is_world
from ..utils.trace import get_logger
from .topology import CSRTopo

__all__ = ["ShardedTopology", "held_bytes", "held_shards", "row_partition",
           "shard_position"]


def row_partition(indptr, num_shards: int, rows_per_shard: int, edge_attrs=(),
                  shards=None):
    """The row-range partition of one CSR (``indptr`` int64 with
    ``rows_per_shard * num_shards >= node_count``): ``(local indptrs
    (len(shards), rps + 1) in the JAX package's dtype rule, every shard's
    edge count, padded edge width, [each of edge_attrs as (len(shards),
    padded edges)])``. ``shards``: the shards to build (default all; a
    world rank builds its own). Every shard's ``indptr`` is rebased to its
    first edge; rows past the node count are empty; the edge arrays are
    zero-padded to the widest shard. ``indptr`` is int32 unless the widest
    shard passes int32. The geometry comes from ``indptr`` alone, so every
    subset of the shards is built to the same width and dtype."""
    n = int(indptr.shape[0] - 1)
    rps = rows_per_shard
    bounds = [(min(d * rps, n), min((d + 1) * rps, n)) for d in range(num_shards)]
    firsts = [int(indptr[lo]) for lo, _ in bounds]
    shard_edges = [int(indptr[hi]) - first for (_, hi), first in zip(bounds, firsts)]
    e_pad = max(max(shard_edges), 1)
    ip_dtype = np.int32 if e_pad <= np.iinfo(np.int32).max else np.int64
    shards = range(num_shards) if shards is None else list(shards)
    local = []
    for d in shards:
        (lo, hi), lo_e = bounds[d], firsts[d]
        li = np.full(rps + 1, shard_edges[d], dtype=np.int64)
        li[: hi - lo + 1] = indptr[lo: hi + 1] - lo_e
        local.append(li)
    attrs = []
    for attr in edge_attrs:
        # np slicing copies bytes verbatim: each shard's slice is bitwise
        # the replicated array's segment
        out = np.zeros((len(local), e_pad), dtype=attr.dtype)
        for i, d in enumerate(shards):
            out[i, : shard_edges[d]] = attr[firsts[d]: firsts[d] + shard_edges[d]]
        attrs.append(out)
    return np.stack(local).astype(ip_dtype), shard_edges, e_pad, attrs


def held_shards(mesh, axis: str):
    """``(member, the shards this process builds, their devices)``: on a
    world mesh the rank's index along ``axis`` and its own shard on its
    device; on a logical mesh ``(None, every shard, the members'
    devices)``."""
    if is_world(mesh):
        member = mesh.group(axis).index
        return member, [member], [mesh.device]
    devices = axis_devices(mesh, axis)
    return None, list(range(len(devices))), devices


def shard_position(shards, d: int) -> int:
    """The position of shard ``d`` in a partition's held lists (a
    ``ShardedTopology``'s or a ``ShardedRel``'s): ``d`` on a logical mesh,
    0 on a world mesh, whose rank holds its own shard (``member``) alone."""
    if shards.member is None:
        return d
    if d != shards.member:
        raise ValueError(f"this rank holds shard {shards.member}, not {d}")
    return 0


def held_bytes(*shard_lists) -> int:
    """The bytes of the shard tensors this process holds (None lists
    skipped)."""
    return sum(t.numel() * t.element_size() for ts in shard_lists if ts is not None
               for t in ts)


def place_shards(rows: np.ndarray, devices) -> list:
    """One tensor per shard row of ``rows``, on its member's device."""
    return [torch.from_numpy(np.ascontiguousarray(r)).to(dev)
            for r, dev in zip(rows, devices)]


class ShardedTopology:
    """Row-range partition of a :class:`CSRTopo` over a mesh axis.

    Args:
      mesh: the device mesh; the partition runs over ``mesh.shape[axis]``
        shards (one copy serves every group across the other axis).
      csr_topo: host CSR to partition; ``eid`` is not carried (``with_eid``
        sampling stays on the replicated sampler).
      axis: mesh axis to shard over (default ``"feature"``, the axis the
        sharded feature table lives on).
      with_weights: also place each shard's slice of the row-local prefix
        weights (``CSRTopo.cum_weights``) for weighted draws.
      with_times: also place each shard's slice of the CSR-ordered
        timestamps (``CSRTopo.edge_time``) for temporal windows.

    ``indptr``, ``indices``, ``cum_weights`` and ``edge_time`` are lists
    of ``num_shards`` tensors (the last two None unless placed); on a world
    mesh, of the one tensor of the rank's shard :attr:`member` (None on a
    logical mesh), and :attr:`held_bytes` is then about ``1 / F`` of the
    replicated CSR's bytes;
    ``search_iters`` bounds the weighted and temporal binary searches from
    the GLOBAL max degree, so every shard runs the same loop; ``version``
    is the host CSR's committed version; ``plan`` the partition's byte
    accounting, the JAX package's dict.
    """

    def __init__(self, mesh, csr_topo: CSRTopo, axis: str = FEATURE_AXIS,
                 with_weights: bool = False, with_times: bool = False):
        self.mesh = mesh
        self.axis = axis
        # kept for replan(): the same host CSR onto another mesh
        self.csr_topo = csr_topo
        self.with_weights = bool(with_weights)
        self.with_times = bool(with_times)
        if self.with_weights and csr_topo.cum_weights is None:
            raise ValueError(
                "with_weights=True requires edge weights; call "
                "csr_topo.set_edge_weight() or pass edge_weight= to CSRTopo"
            )
        if self.with_times and csr_topo.edge_time is None:
            raise ValueError(
                "with_times=True requires edge timestamps; call "
                "csr_topo.set_edge_time() or pass edge_time= to CSRTopo"
            )
        if is_world(mesh):
            csr_topo._world_mesh = mesh
        F = int(mesh.shape[axis])
        indptr = np.asarray(csr_topo.indptr, dtype=np.int64)
        indices = np.asarray(csr_topo.indices)
        n = int(indptr.shape[0] - 1)
        E = int(indptr[-1])
        rps = -(-n // F) if n else 1  # ceil; at least one row per shard
        attrs = [indices]
        if self.with_weights:
            attrs.append(np.asarray(csr_topo.cum_weights))
        if self.with_times:
            attrs.append(np.asarray(csr_topo.edge_time))
        self.member, held, self.member_devices = held_shards(mesh, axis)
        ip, shard_edges, e_pad, (ix, *extra) = row_partition(indptr, F, rps, attrs, held)
        self.indptr = place_shards(ip, self.member_devices)
        self.indices = place_shards(ix, self.member_devices)
        self.cum_weights = self.edge_time = None
        attr_bytes = 0
        if self.with_weights:
            cw = extra.pop(0)
            self.cum_weights = place_shards(cw, self.member_devices)
            attr_bytes += e_pad * cw.dtype.itemsize
        if self.with_times:
            et = extra.pop(0)
            self.edge_time = place_shards(et, self.member_devices)
            attr_bytes += e_pad * et.dtype.itemsize
        self.search_iters = (
            max(int(np.ceil(np.log2(csr_topo.max_degree + 1))), 1)
            if (self.with_weights or self.with_times) else 0
        )
        self.node_count = n
        self.edge_count = E
        self.max_degree = int(csr_topo.max_degree)
        self.num_shards = F
        self.rows_per_shard = rps
        self.version = int(getattr(csr_topo, "version", 0))
        per_chip = (rps + 1) * ip.dtype.itemsize + e_pad * ix.dtype.itemsize + attr_bytes
        replicated = (
            (n + 1) * csr_topo.indptr.dtype.itemsize
            + E * indices.dtype.itemsize
            + (E * 4 if self.with_weights else 0)
            + (E * 4 if self.with_times else 0)
        )
        self.plan = {
            "num_shards": F,
            "rows_per_shard": rps,
            "node_count": n,
            "edge_count": E,
            "shard_edges": shard_edges,
            "padded_edges": e_pad,
            "per_chip_bytes": per_chip,
            "replicated_bytes": replicated,
            "shrink_factor": replicated / max(per_chip, 1),
        }
        # the bytes of the shard tensors on this process's devices
        self.held_bytes = held_bytes(self.indptr, self.indices, self.cum_weights,
                                     self.edge_time)
        get_logger("topology").info(
            "sharded topology: %d rows x %d shards on mesh axis '%s' "
            "(%d rows/shard, widest shard %d/%d edges); %.2f MB/chip vs "
            "%.2f MB replicated (%.1fx shrink)",
            n, F, axis, rps, e_pad, E, per_chip / 2**20,
            replicated / 2**20, self.plan["shrink_factor"],
        )

    def replan(self, mesh, axis: str | None = None) -> "ShardedTopology":
        """A fresh partition of the same host CSR onto another mesh: new
        ``rows_per_shard``, owner map and ``plan``; the node and edge data
        are the same, so samples are too. On a world mesh the rank builds
        its own shard of the new mesh from the host CSR."""
        return ShardedTopology(
            mesh, self.csr_topo, axis=self.axis if axis is None else axis,
            with_weights=self.with_weights, with_times=self.with_times,
        )

    def owner_of(self, ids):
        """Owning shard of each (global) node id, as a tensor."""
        return torch.div(torch.as_tensor(ids), self.rows_per_shard,
                         rounding_mode="floor")

    def __repr__(self):
        return (
            f"ShardedTopology(nodes={self.node_count}, "
            f"edges={self.edge_count}, shards={self.num_shards}, "
            f"rows_per_shard={self.rows_per_shard}, "
            f"shrink={self.plan['shrink_factor']:.1f}x)"
        )
