"""Segment mean over CSR rows (``segment.cu``): the layer-wise inference's
neighbour mean, ``out[r]`` the mean of ``table[indices[e]]`` over row
``r``'s edges ``[indptr[r], indptr[r + 1])``, zeros for a row with none.

Replaces no Pallas kernel: the JAX package leaves this sum to an XLA
scatter or a cumsum-difference scan. On Hopper one launch walks every row:
each source row is read once into registers, summed in CSR order from 0.0
in float32 and divided by the degree, and each output row is written once,
with no message buffer, no sort and no search (the source holds its byte
bound and its design). The same launch reads ``indices`` on the device or
in pinned host memory over UVA.

:func:`segment_mean` launches the kernel for a CUDA table and raises if it
cannot; :func:`segment_mean_plain` is the same function in plain PyTorch,
the chunked accumulate the layer-wise passes ran before the kernel, used
for CPU tensors and as the reference the kernel is checked against. A
float32 table's rows are the plain version's bit for bit, the CPU's at
every width and the card's at more than 32 floats a row (each sums a
row's edges in CSR order, one float add after another; at fewer, ATen's
accumulate sums a chunk's run of a row apart); a bfloat16 or float16
table's are the CPU's plain version over the table in float32, rounded
once. ``segment_mean`` is a ``kernel_entry`` (``obs/marks.py``).
"""

from __future__ import annotations

import torch

from ...obs.marks import kernel_entry
from .build import address, launch

__all__ = ["segment_mean", "segment_mean_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_mean_plain(indptr, indices, table, chunk: int = 1 << 21):
    """:func:`segment_mean` in plain PyTorch: walk the edges in chunks of
    ``chunk``, find each edge's row by a binary search of ``indptr``, add
    the chunk's source rows into an ``(n_rows, F)`` buffer, in edge order
    (``index_put_(accumulate=True)`` on the card, which sorts the rows
    stably and adds each row's edges one after another; ``index_add_`` on
    the CPU, one index after another), then divide by the degree.
    ``indptr`` is on the table's device; the ids may be there or in host
    memory."""
    n_rows, E, dev = indptr.shape[0] - 1, indices.shape[0], table.device
    acc = torch.zeros(n_rows, table.shape[1], dtype=table.dtype, device=dev)
    for e0 in range(0, E, chunk):
        epos = torch.arange(e0, min(e0 + chunk, E), device=dev)
        dst = torch.searchsorted(indptr, epos, right=True) - 1
        src = indices[e0:e0 + epos.shape[0]].to(device=dev, dtype=torch.int64)
        if acc.is_cuda:
            acc.index_put_((dst,), table[src], accumulate=True)
        else:
            acc.index_add_(0, dst, table[src])
    deg = (indptr[1:] - indptr[:-1]).clamp(min=1).to(table.dtype)
    return acc / deg[:, None]


@kernel_entry
def segment_mean(indptr, indices, table, chunk: int = 1 << 21):
    """Mean of each CSR row's source rows: ``(n_rows, F)``, the table's
    dtype, ``n_rows = indptr.shape[0] - 1``.

    Args:
      indptr: ``(n_rows + 1,)`` contiguous int64 edge offsets, on the
        table's device.
      indices: ``(E,)`` contiguous int32 source rows of ``table``, on the
        table's device or in pinned host memory (read over UVA).
      table: ``(N, F)`` contiguous float32, bfloat16 or float16 rows.
      chunk: edges per accumulate of :func:`segment_mean_plain`, which
        CPU tables take; the kernel has no chunks and ignores it.

    A CUDA table launches the kernel, once; anything it does not take
    raises ``ValueError``.
    """
    if not table.is_cuda:
        return segment_mean_plain(indptr, indices, table, chunk)
    index = table.get_device()
    if table.dtype not in _DTYPES:
        raise ValueError(f"segment_mean reads float32, bfloat16 or float16 rows, "
                         f"got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (N, F) tensor")
    if (indptr.dtype != torch.int64 or indptr.dim() != 1 or not indptr.is_contiguous()
            or indptr.get_device() != index):
        raise ValueError(f"indptr must be contiguous 1-D int64 on cuda:{index}")
    if indices.dtype != torch.int32 or indices.dim() != 1 or not indices.is_contiguous():
        raise ValueError("indices must be contiguous 1-D int32")
    n_rows, F = indptr.shape[0] - 1, table.shape[1]
    out = torch.empty(n_rows, F, dtype=table.dtype, device=table.device)
    ids = address(indices, index) if indices.numel() else 0
    launch("segment_mean", index, indptr.data_ptr(), ids,
           table.data_ptr(), out.data_ptr(), n_rows, F * table.element_size(),
           _DTYPES[table.dtype])
    segment_mean.launches += 1
    return out


segment_mean.launches = 0
