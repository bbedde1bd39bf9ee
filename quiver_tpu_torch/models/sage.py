"""GraphSAGE over padded Adj blocks.

The port of ``quiver_tpu/models/sage.py``: per-layer
``W_l · mean(neighbours) + W_r · x_self`` (PyG's SAGEConv(mean)), ReLU and
dropout between layers, a log-softmax head computed in float32. Layers are
consumed deepest-first with ``x_target = x[..., :size[1], :]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import gather_src, segment_mean_aggregate

__all__ = ["GraphSAGE", "SAGEConv"]


def _compute_dtype(dtype) -> torch.dtype | None:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float32": torch.float32}[str(dtype)]


class SAGEConv(nn.Module):
    """One mean-aggregation SAGE layer; ``lin_l`` has a bias, ``lin_r``
    none. ``dtype="bfloat16"`` runs the products and the aggregation in
    bf16 while the parameters stay float32."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.lin_l = nn.Linear(in_channels, out_channels, bias=True)
        self.lin_r = nn.Linear(in_channels, out_channels, bias=False)
        self.dtype = _compute_dtype(dtype)

    def _linear(self, lin: nn.Linear, x):
        if self.dtype is None:
            return lin(x)
        bias = None if lin.bias is None else lin.bias.to(self.dtype)
        return F.linear(x, lin.weight.to(self.dtype), bias)

    def combine(self, agg, x_self):
        return self._linear(self.lin_l, agg) + self._linear(self.lin_r, x_self)

    def forward(self, x, edge_index, num_dst: int, fanout: int | None = None):
        src, dst = edge_index[..., 0, :], edge_index[..., 1, :]
        msgs, valid = gather_src(x, src)
        agg = segment_mean_aggregate(msgs, dst.clamp(min=0), valid, num_dst,
                                     fanout=fanout)
        return self.combine(agg, x[..., :num_dst, :])


class GraphSAGE(nn.Module):
    """Multi-layer GraphSAGE consuming sampler output (adjs deepest-first).

    Unlike the flax model, which infers its input width at init, a torch
    module needs ``in_channels`` up front.
    """

    def __init__(self, in_channels: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5, dtype=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = _compute_dtype(dtype)
        widths = [in_channels] + [hidden] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            SAGEConv(widths[i], widths[i + 1], dtype=self.dtype)
            for i in range(num_layers)
        )

    def forward(self, x, adjs: Sequence):
        if len(adjs) != self.num_layers:
            raise ValueError(
                f"model has {self.num_layers} layers but got {len(adjs)} adjs; "
                "sampler sizes and num_layers must match"
            )
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj.edge_index, adj.size[1], adj.fanout)
            if i != self.num_layers - 1:
                x = F.dropout(F.relu(x), self.dropout, self.training)
        # log-softmax in f32: bf16 has too little mantissa for a stable NLL
        return torch.log_softmax(x.to(torch.float32), dim=-1)
