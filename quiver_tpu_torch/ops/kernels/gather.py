"""Row gather (kernel K2, ``gather.cu``): the single-table gather, the
tiered feature lookup and its int8 dequantising sibling.

The port of ``quiver_tpu/ops/pallas/gather.py``, whose TPU kernel
``_gather_kernel`` issues one DMA per row, and of the XLA ops of
``quiver_tpu/feature/feature.py`` ``tiered_lookup`` and
``wrap_dequant_gathers`` around it. On Hopper a warp copies up to four
rows (as many as their width allows) with coalesced words, loads before
stores; the same kernel reads a device table (the hot feature tier) and a
pinned host table over UVA (the cold tier). :func:`tiered_gather`
translates the ids, picks the tier and merges both tiers in its one
launch. :func:`tiered_gather_dequant` does the same over int8 codes and
writes float32 rows, each code times its row's scale, in a kernel of its
own: each warp of a persistent grid keeps a ring of stages in shared
memory filled by 16 B asynchronous copies of whole aligned granules (code
tables at any byte address), several stages ahead of the one it converts
to wide float stores.

An id past the table reads its last row, as the JAX package's XLA gathers
clamp; a negative id gives a zero row.

:func:`gather_rows`, :func:`tiered_gather` and
:func:`tiered_gather_dequant` launch the kernel for CUDA ids and raise if
they cannot; :func:`gather_rows_plain` and :func:`tiered_gather_plain`
are the same functions in plain PyTorch, used for CPU tensors and as the
references the kernel is checked against. The three are
``kernel_entry``s (``obs/marks.py``): under the program audit's recorder
one call is one opaque kernel node.
"""

from __future__ import annotations

import torch

from ...obs.marks import kernel_entry
from .build import address, launch

__all__ = ["gather_rows", "gather_rows_plain", "tiered_gather",
           "tiered_gather_dequant", "tiered_gather_plain"]

_ALL_HOT = 2**63 - 1  # hot_rows of a single table: every row is "hot"


def gather_rows_plain(table, ids, out=None):
    """``out[j] = table[min(ids[j], N - 1)]``; a negative id gives a zero
    row, or keeps ``out[j]`` when ``out`` is given. Plain PyTorch."""
    valid = ids >= 0
    n = table.shape[0]
    if n:
        pos = ids.clamp(0, n - 1).to(device=table.device, dtype=torch.int64)
        rows = table[pos].to(ids.device)
    else:
        rows = torch.zeros((ids.shape[0],) + tuple(table.shape[1:]),
                           dtype=table.dtype, device=ids.device)
    base = torch.zeros_like(rows) if out is None else out
    return torch.where(valid[:, None], rows, base)


def _check_ids(ids, name: str) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"{name} must be contiguous 1-D int32")


def _check_table(table, name: str, F=None, dtype=None) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (N, F) tensor")
    if F is not None and (table.shape[1] != F or table.dtype != dtype):
        raise ValueError(f"{name} must hold ({F},) {dtype} rows")


@kernel_entry
def gather_rows(table, ids, out=None):
    """Gather rows of a ``(N, F)`` table (kernel K2, one table).

    Args:
      table: ``(N, F)`` contiguous table of any element type, on the device
        or in pinned host memory (read over UVA).
      ids: ``(B,)`` int32 row ids; an id of ``N`` or more reads row
        ``N - 1``, a negative id marks a lane the caller masks out.
      out: optional ``(B, F)`` output to fill; lanes with a negative id
        keep their contents. Without it such lanes are zero rows.

    CPU ``ids`` take :func:`gather_rows_plain`; CUDA ``ids`` launch the
    kernel.
    """
    if not ids.is_cuda:
        return gather_rows_plain(table, ids, out)
    index = ids.get_device()
    _check_ids(ids, "ids")
    _check_table(table, "table")
    B, F = ids.shape[0], table.shape[1]
    keep = out is not None
    if out is None:
        out = torch.empty(B, F, dtype=table.dtype, device=ids.device)
    elif (out.shape != (B, F) or out.dtype != table.dtype
          or out.get_device() != index or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous ({B}, {F}) {table.dtype} "
                         f"on cuda:{index}")
    launch("gather", index, address(table, index), 0, ids.data_ptr(), 0, 0,
           _ALL_HOT, table.shape[0], out.data_ptr(), B,
           F * table.element_size(), int(keep))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def tiered_gather_plain(n_id, feature_order, hot_rows: int, hot, cold,
                        scale=None):
    """:func:`tiered_gather` (or, with ``scale``,
    :func:`tiered_gather_dequant`) in plain PyTorch: clamp and translate,
    then one gather per tier, the cold one filling only its own lanes of
    the hot one's output; with ``scale``, the codes times ``scale`` of
    their translated row, and zero rows on ``-1`` lanes."""
    n = (0 if hot is None else hot.shape[0]) + (0 if cold is None else cold.shape[0])
    valid = n_id >= 0
    ids = torch.where(valid, n_id, 0).clamp(max=max(n - 1, 0)).to(torch.int64)
    if feature_order is not None:
        ids = feature_order[ids].to(torch.int64)
    ids = torch.where(valid, ids, -1)
    if hot is None:
        out = gather_rows_plain(cold, ids.to(torch.int32))
    elif cold is None:
        out = gather_rows_plain(hot, ids.to(torch.int32))
    else:
        out = gather_rows_plain(hot, torch.where(ids < hot_rows, ids, -1).to(torch.int32))
        cold_ids = torch.where(ids >= hot_rows, ids - hot_rows, -1)
        out = gather_rows_plain(cold, cold_ids.to(torch.int32), out=out)
    if scale is None:
        return out
    rows = out.to(torch.float32) * scale[ids.clamp(min=0)][:, None]
    return torch.where(valid[:, None], rows, 0.0)


def _tiered_args(n_id, feature_order, hot_rows, hot, cold):
    """Checks of a tiered entry's arguments; returns the launch device's
    index, the first table, the order's address (0 for none) and the
    table's row count."""
    index = n_id.get_device()
    _check_ids(n_id, "n_id")
    first = hot if hot is not None else cold
    if first is None:
        raise ValueError("a tiered gather needs a hot or a cold table")
    _check_table(first, "hot" if hot is not None else "cold")
    if cold is not None:
        _check_table(cold, "cold", first.shape[1], first.dtype)
    if hot_rows != (0 if hot is None else hot.shape[0]):
        raise ValueError(f"hot_rows={hot_rows} does not match the hot table")
    order = 0
    if feature_order is not None:
        _check_ids(feature_order, "feature_order")
        order = address(feature_order, index)
    n_rows = hot_rows + (0 if cold is None else cold.shape[0])
    return index, first, order, n_rows


@kernel_entry
def tiered_gather(n_id, feature_order, hot_rows: int, hot, cold):
    """Rows for padded node ids from a hot and a cold tier (kernel K2, one
    launch).

    Args:
      n_id: ``(B,)`` int32 node ids, ``-1`` on invalid lanes (zero rows);
        an id of ``N`` or more reads the row of id ``N - 1``.
      feature_order: optional ``(N,)`` int32 node id -> table row (the
        degree reorder), on the ids' device; None takes the id itself.
      hot_rows: rows ``[0, hot_rows)`` are in ``hot``, the rest in ``cold``.
      hot: ``(hot_rows, F)`` contiguous rows on the device, or None when
        ``hot_rows`` is 0.
      cold: ``(N - hot_rows, F)`` contiguous rows of the same dtype in
        pinned host memory (read over UVA) or on the device, or None when
        ``hot`` holds every row.

    CPU ``n_id`` take :func:`tiered_gather_plain`; CUDA ``n_id`` launch the
    kernel.
    """
    if not n_id.is_cuda:
        return tiered_gather_plain(n_id, feature_order, hot_rows, hot, cold)
    index, first, order, n_rows = _tiered_args(n_id, feature_order, hot_rows,
                                               hot, cold)
    B, F = n_id.shape[0], first.shape[1]
    out = torch.empty(B, F, dtype=first.dtype, device=n_id.device)
    launch("gather", index, 0 if hot is None else address(hot, index),
           0 if cold is None else address(cold, index), n_id.data_ptr(), order,
           0, hot_rows, n_rows, out.data_ptr(), B, F * first.element_size(), 0)
    tiered_gather.launches += 1
    return out


tiered_gather.launches = 0


@kernel_entry
def tiered_gather_dequant(n_id, feature_order, hot_rows: int, hot, cold,
                          scale):
    """Float32 rows for padded node ids from int8 codes in a hot and a cold
    tier (kernel K2, one launch): ``out[j] = q[t] * scale[t]``, ``t`` the
    clamped, translated row, as :func:`tiered_gather` picks it; zero rows
    on ``-1`` lanes.

    Args: as :func:`tiered_gather`, with ``hot`` and ``cold`` int8 code
    tables and ``scale`` the ``(N,)`` float32 per-row scales in the
    translated row space, on the ids' device.

    CPU ``n_id`` take :func:`tiered_gather_plain` with ``scale``; CUDA
    ``n_id`` launch the kernel.
    """
    if not n_id.is_cuda:
        return tiered_gather_plain(n_id, feature_order, hot_rows, hot, cold,
                                   scale)
    index, first, order, n_rows = _tiered_args(n_id, feature_order, hot_rows,
                                               hot, cold)
    if first.dtype != torch.int8:
        raise ValueError(f"tiered_gather_dequant reads int8 codes, got {first.dtype}")
    if (scale.dtype != torch.float32 or scale.shape != (n_rows,)
            or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous ({n_rows},) float32 tensor")
    B, F = n_id.shape[0], first.shape[1]
    out = torch.empty(B, F, dtype=torch.float32, device=n_id.device)
    launch("gather_dequant", index, 0 if hot is None else address(hot, index),
           0 if cold is None else address(cold, index), n_id.data_ptr(), order,
           address(scale, index), hot_rows, n_rows, out.data_ptr(), B, F, 0)
    tiered_gather_dequant.launches += 1
    return out


tiered_gather_dequant.launches = 0
