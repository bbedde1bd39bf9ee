"""Graph Attention Network over padded Adj blocks.

The port of ``quiver_tpu/models/gat.py``: PyG's GATConv (v1, Velickovic
et al.), multi-head additive attention with a softmax over each
destination's edges (-1 sentinel lanes excluded),

    e_ij  = LeakyReLU(a_l · (W h_j) + a_r · (W h_i))
    alpha = softmax_i(e_ij)   (over j in N(i), per head)
    h_i'  = concat_heads( Σ_j alpha_ij W h_j )   [or the mean over heads
            with ``concat=False``, PyG's output layer]

The node-level halves ``a_l · W h`` and ``a_r · W h`` are computed once
per node (``project``); the per-edge logits are their sum. The softmax is
:func:`~.layers.fanout_softmax` on the regular layout and
:func:`~.layers.segment_softmax` otherwise; both give invalid lanes weight
0, so the ``(E, H, F)`` messages are built once, by one ``index_select``
and one multiply, and summed with no further mask.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_gate, fanout_softmax, segment_softmax, segment_sum
from .sage import _compute_dtype, apply_linear, stacked_forward

__all__ = ["GATConv", "GAT"]


class GATConv(nn.Module):
    """Multi-head graph attention over a padded edge block.

    Args:
      in_channels: input width.
      features: per-head output width F.
      heads: number of attention heads H.
      concat: concatenate heads (output H*F) or average them (output F).
      negative_slope: LeakyReLU slope of the attention logits.
    """

    def __init__(self, in_channels: int, features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dtype=None):
        super().__init__()
        self.features, self.heads = features, heads
        self.concat = bool(concat)
        self.negative_slope = float(negative_slope)
        self.dtype = _compute_dtype(dtype)
        self.lin = nn.Linear(in_channels, heads * features, bias=False)
        self.att_l = nn.Parameter(torch.empty(heads, features))
        self.att_r = nn.Parameter(torch.empty(heads, features))
        self.bias = nn.Parameter(torch.zeros(heads * features if concat else features))
        self.init_extra(None)

    def init_extra(self, generator: torch.Generator | None) -> None:
        """The parameters ``init_model`` does not draw: ``att_l`` and
        ``att_r`` from flax's ``glorot_uniform`` on ``(H, F)`` (uniform in
        ``+-sqrt(6 / (H + F))``), the bias zero."""
        with torch.no_grad():
            nn.init.xavier_uniform_(self.att_l, generator=generator)
            nn.init.xavier_uniform_(self.att_r, generator=generator)
            self.bias.zero_()

    def project(self, x):
        """``(W h)`` per head ``(N, H, F)`` and the node halves of the
        logits, ``a_l · W h`` and ``a_r · W h``, each ``(N, H)``."""
        h_all = apply_linear(self.lin, x, self.dtype).reshape(
            x.shape[0], self.heads, self.features)
        return h_all, (h_all * self.att_l).sum(-1), (h_all * self.att_r).sum(-1)

    def finish(self, out):
        """``(num_dst, H, F)`` aggregated messages -> the layer's output
        (heads concatenated or averaged, plus the bias)."""
        if self.concat:
            return out.reshape(out.shape[0], self.heads * self.features) + self.bias
        return out.mean(dim=1) + self.bias

    def forward(self, x, edge_index, num_dst: int, fanout: int | None = None):
        src, dst = edge_index[0], edge_index[1]
        valid = (src >= 0) & (dst >= 0)
        src_safe = src.clamp(min=0).to(torch.int64)
        dense = dense_gate(dst, valid, num_dst, fanout)

        h_all, alpha_src, alpha_dst = self.project(x)
        dst_safe = dst.clamp(0, num_dst - 1).to(torch.int64)
        # index_select, not advanced indexing: its backward is an
        # index_add, where indexing's sorts the lanes and serialises a
        # hub's duplicates (0.27 s a step at bench_epoch's widths)
        logits = (alpha_src.index_select(0, src_safe)
                  + alpha_dst.index_select(0, dst_safe))
        logits = F.leaky_relu(logits, self.negative_slope)  # (E, H)
        # the softmax runs in the logits' dtype (float32 through the att
        # parameters), the messages in the compute dtype
        if dense:
            alpha = fanout_softmax(logits, valid, num_dst, fanout)
        else:
            seg = torch.where(valid, dst, num_dst)  # overflow segment
            alpha = segment_softmax(logits, seg, valid, num_dst)
        msgs = h_all.index_select(0, src_safe) * alpha.to(h_all.dtype)[:, :, None]
        if dense:  # (E, H, F) -> (num_dst, H, F)
            out = msgs.reshape(num_dst, fanout, self.heads, self.features).sum(dim=1)
        else:
            out = segment_sum(msgs, seg, num_dst)[:num_dst]
        return self.finish(out)


class GAT(nn.Module):
    """Multi-layer GAT consuming sampler output (adjs deepest-first), the
    PyG mini-batch recipe: hidden layers concatenate ``heads`` heads and
    apply ELU (then dropout); the output layer has one head, not
    concatenated. A float32 log-softmax head."""

    def __init__(self, in_channels: int, hidden: int, num_classes: int,
                 num_layers: int = 2, heads: int = 4, dropout: float = 0.5,
                 dtype=None):
        super().__init__()
        self.hidden, self.num_classes = hidden, num_classes
        self.num_layers, self.heads = num_layers, heads
        self.dropout = dropout
        self.dtype = _compute_dtype(dtype)
        convs, width = [], in_channels
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(GATConv(width, num_classes if last else hidden,
                                 heads=1 if last else heads, concat=not last,
                                 dtype=self.dtype))
            width = hidden * heads
        self.convs = nn.ModuleList(convs)

    def forward(self, x, adjs: Sequence, generator: torch.Generator | None = None):
        """Log-probs of the seed rows; in training mode with ``dropout >
        0``, ``generator`` draws the dropout masks."""
        return stacked_forward(self, x, adjs, generator, act=F.elu)
