"""GraphSAGE (mean aggregation) in plain PyTorch: the full-graph
layer-wise pass.

Each layer is ``lin_l(mean of the neighbours) + lin_r(self)``, ``lin_l``
with a bias and ``lin_r`` without (PyG's ``SAGEConv``), ReLU between
layers, and a log-softmax head. The aggregation here is a scatter-add by
node in blocks of edges and a division by the degree; the program sums in
another order, so the two agree to rounding.
"""

from __future__ import annotations

import torch

__all__ = ["layerwise_pass"]


def layerwise_pass(params: dict, features, edges, num_nodes: int, num_layers: int,
                   block_edges: int = 1 << 24, matmul=None):
    """Log-probs of every node from all its edges: per layer, the mean of
    the neighbours' rows (``edges[0]`` the node, ``edges[1]`` its
    neighbour), summed in blocks of ``block_edges`` edges."""
    mm = matmul or (lambda a, w: a @ w.t())
    row = edges[0].to(torch.int64)
    deg = torch.bincount(row, minlength=num_nodes).to(torch.float32).clamp(min=1.0)
    h = features
    with torch.no_grad():
        for i in range(num_layers):
            agg = torch.zeros(num_nodes, h.shape[1], dtype=h.dtype, device=h.device)
            for e0 in range(0, edges.shape[1], block_edges):
                r = row[e0:e0 + block_edges]
                c = edges[1, e0:e0 + block_edges].to(torch.int64)
                agg.index_add_(0, r, h[c])
            agg = agg / deg[:, None]
            h = (mm(agg, params[f"convs.{i}.lin_l.weight"]) + params[f"convs.{i}.lin_l.bias"]
                 + mm(h, params[f"convs.{i}.lin_r.weight"]))
            if i != num_layers - 1:
                h = torch.relu(h)
        return torch.log_softmax(h, dim=-1)
