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
with an overflow bucket for invalid lanes. ``QUIVER_CHECK=1`` asserts the
regular layout that the dense path trusts.
"""

from __future__ import annotations

import os

import torch

from ..utils.trace import info_once

__all__ = ["fanout_sum_aggregate", "gather_src", "segment_mean_aggregate"]


_check_cache: bool | None = None


def _check_enabled() -> bool:
    """``QUIVER_CHECK=1`` turns on the layout assertion of the dense path.

    Read ONCE per process, at the first aggregation: set it before the
    first model call. Tests reset ``_check_cache`` to re-read it."""
    global _check_cache
    if _check_cache is None:
        _check_cache = os.environ.get("QUIVER_CHECK", "0") not in (
            "", "0", "false", "False"
        )
    return _check_cache


def _check_regular_layout(dst, valid, num_dst: int, fanout: int) -> None:
    """Assert the regular-layout claim the dense path trusts: lane
    ``s*fanout + k`` targets seed ``s`` on every valid lane. It reads back
    one count per aggregation (a host sync on the card), so it runs only
    under ``QUIVER_CHECK``, and not while the stream is capturing a CUDA
    graph."""
    expected = torch.arange(num_dst, dtype=dst.dtype,
                            device=dst.device).repeat_interleave(fanout)
    bad = int(((dst != expected) & valid).sum())
    if bad > 0:
        raise AssertionError(
            f"QUIVER_CHECK: {bad} valid edge lanes violate the regular "
            "layout dst == repeat(arange(num_dst), fanout) that the dense "
            "aggregation path trusts; this Adj's fanout claim is wrong and "
            "the dense path would mis-aggregate"
        )


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
        # the check reads a count back, which a stream under CUDA-graph
        # capture cannot do: a captured program checks in its eager pass
        if _check_enabled() and not (
                dst.is_cuda and torch.cuda.is_current_stream_capturing()):
            _check_regular_layout(dst, valid, num_dst, fanout)
        total = fanout_sum_aggregate(messages, valid, num_dst, fanout)
        cnt = valid.reshape(*valid.shape[:-1], num_dst, fanout).sum(dim=-1)
        return total / cnt.to(messages.dtype).clamp(min=1.0)[..., None]
    if fanout is not None:
        # the gate failed on shape: fanout promised the dense layout but
        # E != num_dst * fanout, so this aggregation takes the scatter path
        info_once(
            f"dense-gate-fallback-{E}-{num_dst}-{fanout}",
            "Adj.fanout=%d set but E=%d != num_dst*fanout=%d; falling back "
            "to the segment-scatter aggregation path",
            fanout, E, num_dst * fanout,
        )
    lead, F = messages.shape[:-2], messages.shape[-1]
    seg = torch.where(valid, dst, num_dst).to(torch.int64)
    total = torch.zeros(*lead, num_dst + 1, F, dtype=messages.dtype,
                        device=messages.device)
    total.scatter_add_(-2, seg[..., None].expand_as(messages), messages)
    cnt = torch.zeros(*lead, num_dst + 1, dtype=messages.dtype,
                      device=messages.device)
    cnt.scatter_add_(-1, seg, valid.to(messages.dtype))
    return total[..., :num_dst, :] / cnt[..., :num_dst].clamp(min=1.0)[..., None]
