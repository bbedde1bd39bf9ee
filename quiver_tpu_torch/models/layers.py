"""Message-passing primitives over padded Adj blocks.

The port of ``quiver_tpu/models/layers.py``: ``gather_src``,
``fanout_sum_aggregate``, ``segment_mean_aggregate``, the two softmaxes
over each destination's edges (``fanout_softmax``, ``segment_softmax``,
GAT's) and the occurrence counts (``occurrence_counts``,
``zero_scatter_counts``, GCN's source degrees). Edges arrive as a
padded ``edge_index`` with -1 sentinels (source = frontier-local id,
target = seed-local id). Node features are ``(..., N, F)`` and edge
messages ``(..., E, F)``: any leading dimensions are independent graphs
(the serving ladder's lanes).

Two aggregation paths, identical results: the dense path for the regular
sampler layout (lane ``s*fanout + k`` targets seed ``s``), a masked
reshape and sum; and the segment path for irregular Adjs, a scatter-add
with an overflow bucket for invalid lanes. :func:`dense_gate` picks the
path for every conv family: ``QUIVER_CHECK=1`` asserts the regular layout
that the dense path trusts, and a fanout that does not match the edge
count is logged once before the segment path runs. The softmaxes and
counts take 1-D edge lanes (no leading lane dimensions).
"""

from __future__ import annotations

import os

import torch

from ..utils.trace import info_once

__all__ = [
    "dense_gate",
    "fanout_softmax",
    "fanout_sum_aggregate",
    "gather_src",
    "occurrence_counts",
    "resolve_counts_strategy",
    "segment_mean_aggregate",
    "segment_softmax",
    "segment_sum",
    "zero_scatter_counts",
]

_COUNTS_STRATEGIES = ("scan", "scatter")
_counts_strategy: str | None = None
_check_cache: bool | None = None


def resolve_counts_strategy() -> str:
    """The ``QUIVER_COUNTS`` histogram strategy (``scan`` or ``scatter``),
    read ONCE per process at the first count: set it before the first
    model call. The default on a card and on the CPU is ``scatter``, the
    JAX package's default off the TPU; both strategies give the same
    counts. Tests reset ``_counts_strategy`` to re-read it."""
    global _counts_strategy
    if _counts_strategy is None:
        v = os.environ.get("QUIVER_COUNTS", "").strip().lower()
        if v and v not in _COUNTS_STRATEGIES:
            raise ValueError(
                f"QUIVER_COUNTS={v!r} is not one of {_COUNTS_STRATEGIES}")
        _counts_strategy = v or "scatter"
    return _counts_strategy


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


def zero_scatter_counts(ids, valid, n: int, dtype=torch.float32):
    """Occurrence count of each value in ``[0, n)`` among ``ids[valid]``
    with no scatter: sort (invalid lanes to the sentinel ``n``), then the
    bucket edges by one binary search."""
    sv = torch.sort(torch.where(valid, ids, n)).values
    edges = torch.searchsorted(
        sv, torch.arange(n + 1, dtype=sv.dtype, device=sv.device))
    return (edges[1:] - edges[:-1]).to(dtype)


def occurrence_counts(ids, valid, n: int, dtype=torch.float32):
    """Histogram of ``ids[valid]`` over ``[0, n)``, by the strategy
    :func:`resolve_counts_strategy` picks: the sort of
    :func:`zero_scatter_counts`, or one scatter-add of ones with an
    overflow bucket for invalid lanes (exact: the counts are integers)."""
    if resolve_counts_strategy() == "scan":
        return zero_scatter_counts(ids, valid, n, dtype)
    idx = torch.where(valid, ids, n).to(torch.int64)
    out = torch.zeros(n + 1, dtype=dtype, device=ids.device)
    return out.scatter_add_(0, idx, valid.to(dtype))[:n]


def dense_gate(dst, valid, num_dst: int, fanout: int | None) -> bool:
    """Whether an aggregation over these edge lanes takes the dense path:
    ``fanout`` is set and the lane count is ``num_dst * fanout``. Under
    ``QUIVER_CHECK`` the dense path's layout is asserted first (not while
    the stream is capturing a CUDA graph: the check reads a count back, so
    a captured program checks in its eager pass); a ``fanout`` that fails
    the gate on shape is logged once, and the segment path runs."""
    E = dst.shape[-1]
    if fanout is not None and E == num_dst * fanout:
        if _check_enabled() and not (
                dst.is_cuda and torch.cuda.is_current_stream_capturing()):
            _check_regular_layout(dst, valid, num_dst, fanout)
        return True
    if fanout is not None:
        info_once(
            f"dense-gate-fallback-{E}-{num_dst}-{fanout}",
            "Adj.fanout=%d set but E=%d != num_dst*fanout=%d; falling back "
            "to the segment-scatter aggregation path",
            fanout, E, num_dst * fanout,
        )
    return False


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
    if dense_gate(dst, valid, num_dst, fanout):
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


def segment_sum(messages, seg, num_seg: int):
    """``(E, ...)`` messages summed into ``num_seg + 1`` segments by
    ``seg`` (the last one the overflow bucket of invalid lanes)."""
    out = torch.zeros((num_seg + 1,) + tuple(messages.shape[1:]),
                      dtype=messages.dtype, device=messages.device)
    return out.index_add_(0, seg.to(torch.int64), messages)


def fanout_softmax(logits, valid, num_dst: int, fanout: int):
    """Dense counterpart of :func:`segment_softmax` for the regular
    layout: per-edge softmax weights over each target's ``fanout`` lanes,
    no scatters. ``logits`` ``(E, ...)`` -> weights ``(E, ...)``; invalid
    lanes (and all-invalid rows) get 0."""
    shape = logits.shape
    validb = valid.reshape(valid.shape + (1,) * (logits.dim() - 1))
    neg = torch.finfo(logits.dtype).min
    g = torch.where(validb, logits, neg).reshape((num_dst, fanout) + shape[1:])
    gmax = g.amax(dim=1, keepdim=True)  # finite even for all-invalid rows
    expv = torch.where(g > neg, torch.exp(g - gmax), 0.0)
    denom = expv.sum(dim=1, keepdim=True).clamp(min=torch.finfo(logits.dtype).tiny)
    return (expv / denom).reshape(shape)


def segment_softmax(logits, seg, valid, num_seg: int):
    """Numerically stable softmax over edges grouped by target segment.

    ``logits`` is ``(E,)`` or ``(E, ...)`` (trailing dims, such as
    attention heads, are softmaxed independently); ``seg`` the target of
    each lane. Invalid lanes go to the overflow segment ``num_seg`` and
    get weight 0."""
    validb = valid.reshape(valid.shape + (1,) * (logits.dim() - 1))
    seg_safe = torch.where(valid, seg, num_seg).to(torch.int64)
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(validb, logits, neg)
    idx = seg_safe.reshape(validb.shape).expand_as(masked)
    seg_max = torch.full((num_seg + 1,) + tuple(logits.shape[1:]), -torch.inf,
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, masked, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = torch.where(validb, logits - seg_max[seg_safe], neg)
    expv = torch.where(validb, torch.exp(shifted), 0.0)
    denom = segment_sum(expv, seg_safe, num_seg)
    return expv / denom[seg_safe].clamp(min=torch.finfo(logits.dtype).tiny)
