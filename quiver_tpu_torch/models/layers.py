"""Message-passing primitives over padded Adj blocks.

The port of ``quiver_tpu/models/layers.py`` (``gather_src``,
``fanout_sum_aggregate``, ``segment_mean_aggregate``). Edges arrive as a
padded ``edge_index`` with -1 sentinels (source = frontier-local id,
target = seed-local id). Node features are ``(..., N, F)`` and edge
messages ``(..., E, F)``: any leading dimensions are independent graphs
(the serving ladder's lanes).

Two aggregation paths, identical results: the dense path for the regular
sampler layout (lane ``s*fanout + k`` targets seed ``s``), a masked
reshape and sum; and the segment path for irregular Adjs, a scatter-add
with an overflow bucket for invalid lanes.
"""

from __future__ import annotations

import torch

__all__ = ["fanout_sum_aggregate", "gather_src", "segment_mean_aggregate"]


def gather_src(x, src):
    """Per-edge source features; invalid lanes (src == -1) give zeros."""
    valid = src >= 0
    idx = src.clamp(min=0).to(torch.int64)[..., None]
    h = torch.take_along_dim(x, idx, dim=-2)
    return torch.where(valid[..., None], h, torch.zeros((), dtype=x.dtype,
                                                        device=x.device)), valid


def fanout_sum_aggregate(messages, valid, num_dst: int, fanout: int):
    """Masked dense sum over the regular layout: ``(..., num_dst*fanout,
    F)`` -> ``(..., num_dst, F)``."""
    m = torch.where(valid[..., None], messages,
                    torch.zeros((), dtype=messages.dtype, device=messages.device))
    return m.reshape(*m.shape[:-2], num_dst, fanout, m.shape[-1]).sum(dim=-2)


def segment_mean_aggregate(messages, dst, valid, num_dst: int,
                           fanout: int | None = None):
    """Mean-aggregate edge messages into target nodes.

    With ``fanout`` (regular layout, ``E == num_dst * fanout``) the mean is
    a dense masked reduction; otherwise invalid lanes go to an overflow
    segment ``num_dst`` that is cut off.
    """
    E = messages.shape[-2]
    if fanout is not None and E == num_dst * fanout:
        total = fanout_sum_aggregate(messages, valid, num_dst, fanout)
        cnt = valid.reshape(*valid.shape[:-1], num_dst, fanout).sum(dim=-1)
        return total / cnt.to(messages.dtype).clamp(min=1.0)[..., None]
    lead, F = messages.shape[:-2], messages.shape[-1]
    seg = torch.where(valid, dst, num_dst).to(torch.int64)
    total = torch.zeros(*lead, num_dst + 1, F, dtype=messages.dtype,
                        device=messages.device)
    total.scatter_add_(-2, seg[..., None].expand_as(messages), messages)
    cnt = torch.zeros(*lead, num_dst + 1, dtype=messages.dtype,
                      device=messages.device)
    cnt.scatter_add_(-1, seg, valid.to(messages.dtype))
    return total[..., :num_dst, :] / cnt[..., :num_dst].clamp(min=1.0)[..., None]
