"""Neighbour and subgraph samplers: the port's sampling surface.

* :class:`GraphSageSampler`: k-hop sampler over one CSR topology
  (uniform, weighted or temporal draws);
* :class:`HeteroGraphSampler`: typed relations over a ``HeteroCSRTopo``,
  per-relation fanouts and per-type frontiers;
* the GraphSAINT samplers (:class:`SAINTNodeSampler` et al.) and
  :func:`saint_subgraph`;

and the output records (:class:`Adj`, :class:`SampleOutput`,
:class:`HeteroLayer`, :class:`HeteroSampleOutput`).
"""

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
    "GraphSageSampler",
    "HeteroGraphSampler",
    "HeteroLayer",
    "HeteroSampleOutput",
    "SAINTEdgeSampler",
    "SAINTNodeSampler",
    "SAINTRandomWalkSampler",
    "SampleOutput",
    "saint_subgraph",
]
