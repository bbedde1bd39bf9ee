"""The port's GNN models over the sampler's padded Adj blocks.

GraphSAGE, GCN, GIN, GAT and R-GCN (``models/layers.py`` holds the
aggregation primitives), their full-neighbour layer-wise inference
(``models/inference.py``), and ``models/convert.py``, which carries flax
parameters across."""

from .convert import (flax_gat_to_state_dict, flax_gcn_to_state_dict,
                      flax_gin_to_state_dict, flax_rgcn_to_state_dict,
                      flax_sage_to_state_dict)
from .gat import GAT, GATConv
from .gcn import GCN, GCNConv
from .gin import GIN, GINConv
from .inference import (full_neighbor_mean, gat_layerwise_inference,
                        gcn_layerwise_inference, gin_layerwise_inference,
                        rgcn_layerwise_inference, sage_layerwise_inference)
from .rgcn import RGCN, RGCNLayer, rgcn_schema
from .sage import GraphSAGE, SAGEConv

__all__ = [
    "GAT",
    "GATConv",
    "GCN",
    "GCNConv",
    "GIN",
    "GINConv",
    "GraphSAGE",
    "RGCN",
    "RGCNLayer",
    "SAGEConv",
    "flax_gat_to_state_dict",
    "flax_gcn_to_state_dict",
    "flax_gin_to_state_dict",
    "flax_rgcn_to_state_dict",
    "flax_sage_to_state_dict",
    "full_neighbor_mean",
    "gat_layerwise_inference",
    "gcn_layerwise_inference",
    "gin_layerwise_inference",
    "rgcn_layerwise_inference",
    "rgcn_schema",
    "sage_layerwise_inference",
]
