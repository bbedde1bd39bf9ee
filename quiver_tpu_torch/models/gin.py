"""Graph Isomorphism Network over padded Adj blocks.

The port of ``quiver_tpu/models/gin.py``: PyG's ``GINConv``,

    h_i' = MLP( (1 + eps) · x_i  +  Σ_{j ∈ N(i)} x_j ),

with SUM aggregation (no normalisation: that is GIN's point) and a
2-layer MLP (Linear, ReLU, Linear). ``eps`` is 0 and fixed by default;
``train_eps=True`` makes it a learnable scalar. The self term is
``x[:num_dst]`` (the seeds-first frontier); the neighbour sum is the dense
reduction when :func:`~.layers.dense_gate` passes, else a segment sum. On
a block that covers the whole graph this is full-graph GIN, which
:func:`~.inference.gin_layerwise_inference` computes layer by layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_gate, fanout_sum_aggregate, segment_sum
from .sage import _compute_dtype, apply_linear, stacked_forward

__all__ = ["GINConv", "GIN"]


class GINConv(nn.Module):
    """One GIN layer: ``lin1`` (to ``mlp_hidden``, default
    ``out_channels``), ReLU, ``lin2``; ``eps`` a 0-d parameter when
    ``train_eps``, else the constant ``eps_init``."""

    def __init__(self, in_channels: int, out_channels: int,
                 mlp_hidden: int | None = None, train_eps: bool = False,
                 eps_init: float = 0.0, dtype=None):
        super().__init__()
        width = mlp_hidden or out_channels
        self.lin1 = nn.Linear(in_channels, width)
        self.lin2 = nn.Linear(width, out_channels)
        self.train_eps = bool(train_eps)
        self.eps_init = float(eps_init)
        self.eps = (nn.Parameter(torch.tensor(self.eps_init))
                    if self.train_eps else self.eps_init)
        self.dtype = _compute_dtype(dtype)

    def init_extra(self, generator: torch.Generator) -> None:
        """The parameter ``init_model`` does not draw: a learnable ``eps``
        starts at ``eps_init``."""
        if self.train_eps:
            with torch.no_grad():
                self.eps.fill_(self.eps_init)

    def combine(self, z):
        """``MLP(z)``, with ``z = (1 + eps) x + Σ neighbours`` (layer-wise
        inference builds ``z`` itself)."""
        return apply_linear(self.lin2, F.relu(apply_linear(self.lin1, z, self.dtype)),
                            self.dtype)

    def forward(self, x, edge_index, num_dst: int, fanout: int | None = None):
        src, dst = edge_index[0], edge_index[1]
        valid = (src >= 0) & (dst >= 0)
        msgs = torch.where(valid[:, None],
                           x.index_select(0, src.clamp(min=0).to(torch.int64)),
                           0.0)
        if dense_gate(dst, valid, num_dst, fanout):
            agg = fanout_sum_aggregate(msgs, valid, num_dst, fanout)
        else:
            agg = segment_sum(msgs, torch.where(valid, dst, num_dst),
                              num_dst)[:num_dst]
        return self.combine(agg + (1.0 + self.eps) * x[:num_dst])


class GIN(nn.Module):
    """Multi-layer GIN consuming sampler output (adjs deepest-first); every
    layer's MLP is ``hidden`` wide. ReLU and dropout between layers, a
    float32 log-softmax head."""

    def __init__(self, in_channels: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 train_eps: bool = False, dtype=None):
        super().__init__()
        self.hidden, self.num_classes = hidden, num_classes
        self.num_layers = num_layers
        self.dropout = dropout
        self.train_eps = bool(train_eps)
        self.dtype = _compute_dtype(dtype)
        widths = [in_channels] + [hidden] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            GINConv(widths[i], widths[i + 1], mlp_hidden=hidden,
                    train_eps=train_eps, dtype=self.dtype)
            for i in range(num_layers)
        )

    def forward(self, x, adjs: Sequence, generator: torch.Generator | None = None):
        """Log-probs of the seed rows; in training mode with ``dropout >
        0``, ``generator`` draws the dropout masks."""
        return stacked_forward(self, x, adjs, generator)
