"""Neighbour and subgraph samplers: the port's sampling surface.

* :class:`GraphSageSampler`: k-hop sampler over one CSR topology
  (uniform, weighted or temporal draws);
* :class:`DistGraphSageSampler` (``GraphSageSampler(topo_sharding=
  "mesh")``) and :class:`DistHeteroSampler`: the same over a topology
  partitioned across a mesh axis, each hop routed to the owning shards;
* :class:`HeteroGraphSampler`: typed relations over a ``HeteroCSRTopo``,
  per-relation fanouts and per-type frontiers;
* the GraphSAINT samplers (:class:`SAINTNodeSampler` et al.) and
  :func:`saint_subgraph`;

and the output records (:class:`Adj`, :class:`SampleOutput`,
:class:`HeteroLayer`, :class:`HeteroSampleOutput`).
"""

from .dist import (
    DistGraphSageSampler,
    dist_multilayer_sample,
    dist_sample_layer,
    routed_sample_cap,
)
from .dist_hetero import DistHeteroSampler, dist_hetero_multilayer_sample
from .hetero import HeteroGraphSampler, HeteroLayer, HeteroSampleOutput
from .saint import (
    SAINTEdgeSampler,
    SAINTNodeSampler,
    SAINTRandomWalkSampler,
    saint_subgraph,
)
from .sampler import Adj, GraphSageSampler, SampleOutput

__all__ = [
    "Adj",
    "DistGraphSageSampler",
    "DistHeteroSampler",
    "GraphSageSampler",
    "HeteroGraphSampler",
    "HeteroLayer",
    "HeteroSampleOutput",
    "SAINTEdgeSampler",
    "SAINTNodeSampler",
    "SAINTRandomWalkSampler",
    "SampleOutput",
    "dist_hetero_multilayer_sample",
    "dist_multilayer_sample",
    "dist_sample_layer",
    "routed_sample_cap",
    "saint_subgraph",
]
