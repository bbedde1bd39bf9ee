"""Mesh-sharded heterogeneous topology: every relation's CSR partitioned.

The port of ``quiver_tpu/core/hetero_sharded.py``, the typed sibling of
:class:`~.sharded_topology.ShardedTopology`. Each relation ``(src_type,
rel, dst_type)`` of a :class:`~.hetero.HeteroCSRTopo` is an incoming CSR
whose rows are the destination type's ids, so the partition is a
contiguous row-range split per node type: shard ``d`` owns dst rows ``[d
* rows_per_shard[t], (d + 1) * rows_per_shard[t])`` of every relation into
type ``t``. All relations into one type share those ranges, so one
owner-routing plan per (hop, destination type) serves them all
(``sampling/dist_hetero.py``).

Each relation's layout is the homogeneous one (``row_partition``): a
rebased ``indptr`` per shard, zero-padded ``indices`` and, on a weighted
relation, the prefix-weight slice (row-local, so bitwise the replicated
array's segment), one tensor per shard on its member's device. On a world
mesh a rank holds each relation's shard ``member`` alone, as
``ShardedTopology`` does.
"""

from __future__ import annotations

import numpy as np

from ..parallel.mesh import FEATURE_AXIS
from ..utils.trace import get_logger
from .hetero import HeteroCSRTopo
from .sharded_topology import held_bytes, held_shards, place_shards, row_partition

__all__ = ["HeteroShardedTopology", "ShardedRel"]


class ShardedRel:
    """One relation's row-range partition: per-shard rebased CSR tensors
    and the geometry the distributed hop needs."""

    edge_time = None  # relations carry no timestamps

    def __init__(self, indptr, indices, cum_weights, rows_per_shard: int,
                 padded_edges: int, search_iters: int, shard_edges, member=None):
        self.member = member  # a world rank's own shard (None: all held)
        self.indptr = indptr  # F tensors (rows_per_shard + 1,); a world rank's one
        self.indices = indices  # F tensors (padded_edges,)
        self.cum_weights = cum_weights  # F f32 tensors, or None
        self.rows_per_shard = rows_per_shard
        self.padded_edges = padded_edges
        self.search_iters = search_iters
        self.shard_edges = shard_edges  # per-shard true edge counts


class HeteroShardedTopology:
    """Per-relation row-range partition of a :class:`HeteroCSRTopo`.

    Args:
      mesh: the device mesh; partitions run over ``mesh.shape[axis]``
        shards.
      hetero_topo: host typed topology to partition (``eid`` is not
        carried).
      axis: mesh axis to shard over (default ``"feature"``).
      weighted_rels: edge types whose prefix weights ship with the shards
        (each must have weights attached, ``set_edge_weight``).
    """

    def __init__(self, mesh, hetero_topo: HeteroCSRTopo,
                 axis: str = FEATURE_AXIS, weighted_rels=()):
        self.mesh = mesh
        self.axis = axis
        self.hetero_topo = hetero_topo
        self.weighted_rels = frozenset(
            tuple(str(t) for t in et) for et in weighted_rels
        )
        unknown = self.weighted_rels - set(hetero_topo.relations)
        if unknown:
            raise ValueError(f"unknown weighted relations: {sorted(unknown)}")
        for et in sorted(self.weighted_rels):
            if hetero_topo.relations[et].cum_weights is None:
                raise ValueError(
                    f"weighted relation {et} needs edge weights attached: "
                    f"call hetero_topo.set_edge_weight() first"
                )
        F = int(mesh.shape[axis])
        self.num_shards = F
        self.num_nodes = dict(hetero_topo.num_nodes)
        # one row-range geometry per NODE type, shared by every relation
        # into it: what lets one route plan per (hop, dst type) serve all
        self.rows_per_shard = {
            t: (-(-n // F) if n else 1)
            for t, n in hetero_topo.num_nodes.items()
        }
        self.member, held, self.member_devices = held_shards(mesh, axis)
        self.rels: dict[tuple, ShardedRel] = {}
        per_chip = 0
        replicated = 0
        for et, rel in hetero_topo.relations.items():
            rps = self.rows_per_shard[et[2]]
            indptr = np.asarray(rel.indptr, dtype=np.int64)
            indices = np.asarray(rel.indices)
            E = int(indptr[-1])
            weighted = et in self.weighted_rels
            attrs = [indices] + ([np.asarray(rel.cum_weights)] if weighted else [])
            ip, shard_edges, e_pad, (ix, *cw) = row_partition(indptr, F, rps, attrs, held)
            iters = (
                max(int(np.ceil(np.log2(rel.max_degree + 1))), 1)
                if weighted else 0
            )
            self.rels[et] = ShardedRel(
                place_shards(ip, self.member_devices),
                place_shards(ix, self.member_devices),
                place_shards(cw[0], self.member_devices) if weighted else None,
                rps, e_pad, iters, shard_edges, self.member,
            )
            per_chip += (
                (rps + 1) * ip.dtype.itemsize + e_pad * ix.dtype.itemsize
                + (e_pad * 4 if weighted else 0)
            )
            replicated += (
                (rel.node_count + 1) * indptr.dtype.itemsize
                + E * indices.dtype.itemsize + (E * 4 if weighted else 0)
            )
        self.version = 0
        self.plan = {
            "num_shards": F,
            "rows_per_shard": dict(self.rows_per_shard),
            "relations": {
                et: {
                    "rows_per_shard": r.rows_per_shard,
                    "padded_edges": r.padded_edges,
                    "shard_edges": r.shard_edges,
                }
                for et, r in self.rels.items()
            },
            "per_chip_bytes": per_chip,
            "replicated_bytes": replicated,
            "shrink_factor": replicated / max(per_chip, 1),
        }
        # the bytes of every relation's shard tensors on this process's devices
        self.held_bytes = sum(held_bytes(r.indptr, r.indices, r.cum_weights)
                              for r in self.rels.values())
        get_logger("topology").info(
            "hetero sharded topology: %d relations x %d shards on mesh "
            "axis '%s'; %.2f MB/chip vs %.2f MB replicated (%.1fx shrink)",
            len(self.rels), F, axis, per_chip / 2**20, replicated / 2**20,
            self.plan["shrink_factor"],
        )

    def replan(self, mesh, axis: str | None = None) -> "HeteroShardedTopology":
        """Re-partition the same host topology onto another mesh: new
        geometry, the same samples."""
        return HeteroShardedTopology(
            mesh, self.hetero_topo, axis=self.axis if axis is None else axis,
            weighted_rels=self.weighted_rels,
        )

    def __repr__(self):
        return (
            f"HeteroShardedTopology(relations={len(self.rels)}, "
            f"shards={self.num_shards}, "
            f"shrink={self.plan['shrink_factor']:.1f}x)"
        )
