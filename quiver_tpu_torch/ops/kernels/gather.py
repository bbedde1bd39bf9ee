"""Row gather (kernel K2, ``gather.cu``).

The port of ``quiver_tpu/ops/pallas/gather.py``, whose TPU kernel
``_gather_kernel`` issues one DMA per row. On Hopper one warp copies one
row with coalesced words; the same kernel reads a device table (the hot
feature tier) or a pinned host table over UVA (the cold tier).

:func:`gather_rows` launches the kernel for CUDA ids and raises if it
cannot; :func:`gather_rows_plain` is the same function in plain PyTorch,
used for CPU tensors and as the reference the kernel is checked against.
"""

from __future__ import annotations

import torch

from .build import check, device_pointer, load, stream_ptr

__all__ = ["gather_rows", "gather_rows_plain"]


def gather_rows_plain(table, ids, out=None):
    """``out[j] = table[ids[j]]``; a negative id gives a zero row, or keeps
    ``out[j]`` when ``out`` is given. Plain PyTorch."""
    valid = ids >= 0
    if table.shape[0]:
        rows = table.to(ids.device)[ids.clamp(min=0).to(torch.int64)]
    else:
        rows = torch.zeros((ids.shape[0],) + tuple(table.shape[1:]),
                           dtype=table.dtype, device=ids.device)
    base = torch.zeros_like(rows) if out is None else out
    return torch.where(valid[:, None], rows, base)


def gather_rows(table, ids, out=None):
    """Gather rows of a ``(N, F)`` table (kernel K2).

    Args:
      table: ``(N, F)`` contiguous table of any element type, on the device
        or in pinned host memory (read over UVA).
      ids: ``(B,)`` int32 row ids in ``[0, N)``, or negative for a lane the
        caller masks out.
      out: optional ``(B, F)`` output to fill; lanes with a negative id
        keep their contents. Without it such lanes are zero rows.

    CPU ``ids`` take :func:`gather_rows_plain`; CUDA ``ids`` launch the
    kernel.
    """
    if not ids.is_cuda:
        return gather_rows_plain(table, ids, out)
    dev = ids.device
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows table must be a contiguous (N, F) tensor")
    if table.is_cuda and table.device != dev:
        raise ValueError(f"table on {table.device}, ids on {dev}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be contiguous 1-D int32")
    B, F = ids.shape[0], table.shape[1]
    keep = out is not None
    if out is None:
        out = torch.empty((B, F), dtype=table.dtype, device=dev)
    elif (out.shape != (B, F) or out.dtype != table.dtype or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous ({B}, {F}) {table.dtype} on {dev}")
    lib = load("gather")
    with torch.cuda.device(dev):
        err = lib.quiver_gather_rows(
            device_pointer(lib, table), ids.data_ptr(), out.data_ptr(), B,
            F * table.element_size(), int(keep), stream_ptr(dev),
        )
    check(err, "gather kernel launch")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
