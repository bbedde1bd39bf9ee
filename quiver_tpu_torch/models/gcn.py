"""Graph Convolutional Network over padded Adj blocks.

The port of ``quiver_tpu/models/gcn.py``: Kipf and Welling's GCN with the
mini-batch adaptation of DGL's ``GraphConv(norm='both')`` on blocks.
Self-loops are added per destination and the aggregate is normalised by
the in-block degrees of the self-loop-augmented block,

    h_i' = b + W · Σ_{j ∈ N(i) ∪ {i}}  h_j / sqrt(d_j · d_i).

Destination ``i`` has source-local id ``i`` (the sampler's seeds-first
frontier), so the self loop is ``x[:num_dst]``. Source degrees have no
regular layout and come from :func:`~.layers.occurrence_counts`; the
destinations' from the dense layout when :func:`~.layers.dense_gate`
passes, else from a segment sum. On a block that covers the whole graph
this is full-graph GCN, which :func:`~.inference.gcn_layerwise_inference`
computes layer by layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (dense_gate, fanout_sum_aggregate, occurrence_counts,
                     segment_sum)
from .sage import _compute_dtype, apply_linear, stacked_forward

__all__ = ["GCNConv", "GCN"]


class GCNConv(nn.Module):
    """One GCN layer: ``lin`` (no bias) and a separate zero-initialised
    ``bias``, PyG's GCNConv parameters."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.dtype = _compute_dtype(dtype)

    def init_extra(self, generator: torch.Generator) -> None:
        """The parameters ``init_model`` does not draw: the bias, zero."""
        with torch.no_grad():
            self.bias.zero_()

    def combine(self, agg):
        """``W · (normalised aggregate) + b`` (layer-wise inference
        computes the normalised aggregate itself)."""
        return apply_linear(self.lin, agg, self.dtype) + self.bias

    def forward(self, x, edge_index, num_dst: int, fanout: int | None = None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        valid = (src >= 0) & (dst >= 0)
        one = valid.to(x.dtype)
        dense = dense_gate(dst, valid, num_dst, fanout)

        # degrees of the self-loop-augmented block: every destination
        # gets +1 for its loop, and a source that is also a destination
        # carries that same loop on its source side
        deg_src = occurrence_counts(src, valid, n, dtype=x.dtype)
        deg_src[:num_dst] += 1.0
        if dense:
            deg_dst = one.reshape(num_dst, fanout).sum(dim=1) + 1.0
        else:
            dst_safe = torch.where(valid, dst, num_dst)
            deg_dst = segment_sum(one, dst_safe, num_dst)[:num_dst] + 1.0
        inv_s_src = torch.rsqrt(deg_src.clamp(min=1.0))
        inv_s_dst = torch.rsqrt(deg_dst)  # >= 1 by the self loop

        h = x * inv_s_src[:, None]  # scaled once per node, not per edge
        msgs = torch.where(valid[:, None],
                           h.index_select(0, src.clamp(min=0).to(torch.int64)),
                           0.0)
        if dense:
            agg = fanout_sum_aggregate(msgs, valid, num_dst, fanout)
        else:
            agg = segment_sum(msgs, dst_safe, num_dst)[:num_dst]
        agg = (agg + h[:num_dst]) * inv_s_dst[:, None]  # + the self loop
        return self.combine(agg)


class GCN(nn.Module):
    """Multi-layer GCN consuming sampler output (adjs deepest-first): ReLU
    and dropout between layers, a float32 log-softmax head. Unlike the
    flax model, a torch module needs ``in_channels`` up front."""

    def __init__(self, in_channels: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5, dtype=None):
        super().__init__()
        self.hidden, self.num_classes = hidden, num_classes
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = _compute_dtype(dtype)
        widths = [in_channels] + [hidden] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            GCNConv(widths[i], widths[i + 1], dtype=self.dtype)
            for i in range(num_layers)
        )

    def forward(self, x, adjs: Sequence, generator: torch.Generator | None = None):
        """Log-probs of the seed rows; in training mode with ``dropout >
        0``, ``generator`` draws the dropout masks."""
        return stacked_forward(self, x, adjs, generator)
