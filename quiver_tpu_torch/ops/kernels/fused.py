"""Per-hop neighbour select (kernel K1, ``select.cu``).

The port of ``quiver_tpu/ops/pallas/fused.py``. There the TPU kernel
``_select_kernel`` DMAs a 2048-slot window of each CSR row into VMEM and
picks the drawn slots with a one-hot masked sum; rows longer than the
window are sampled from a random window (hub-row attenuation). On Hopper a
thread loads each drawn slot directly, so the hop takes the exact draw of
``ops.sample.sample_layer`` with ``start = indptr[seed]`` and no window:
every row is sampled exactly.

:func:`select` launches the kernel for CUDA tensors and raises if it
cannot; :func:`select_plain` is the same function in plain PyTorch, used
for CPU tensors and as the reference the kernel is checked against.
"""

from __future__ import annotations

import torch

from .build import check, device_pointer, load, stream_ptr

__all__ = ["fused_sample_layer", "fused_select_hop", "select", "select_plain"]


def select_plain(tables, start, offs, count=None):
    """``out[t][r, c] = tables[t][start[r] + offs[r, c]]``, and ``-1`` on
    lanes ``c >= count[r]`` when ``count`` is given. Plain PyTorch."""
    pos = start.to(torch.int64)[:, None] + offs.to(torch.int64)
    mask = None
    if count is not None:
        k = offs.shape[1]
        mask = torch.arange(k, device=offs.device)[None, :] < count[:, None]
        pos = torch.where(mask, pos, 0)
    outs = []
    for tab in tables:
        if tab.numel() == 0:
            # an empty table has no slot to read; every lane must be masked
            outs.append(torch.full(offs.shape, -1, dtype=torch.int32,
                                   device=offs.device))
            continue
        out = tab.to(offs.device)[pos].to(torch.int32)
        if mask is not None:
            out = torch.where(mask, out, -1)
        outs.append(out)
    return tuple(outs)


def select(tables, start, offs, count=None):
    """Neighbour select over one or two int32 tables (kernel K1).

    Args:
      tables: ``(indices,)`` or ``(indices, eid)``, int32 ``(E,)`` each, on
        the device or in pinned host memory (read over UVA).
      start: ``(S,)`` int64 row starts (``indptr[seed]``).
      offs: ``(S, k)`` int32 row-local slot offsets.
      count: optional ``(S,)`` int32 valid lanes per row; lanes past it
        are ``-1`` and read nothing. Without it every lane must be valid.

    Returns a tuple of ``(S, k)`` int32 tensors, one per table. CPU
    ``offs`` take :func:`select_plain`; CUDA ``offs`` launch the kernel.
    """
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"select takes one or two tables, got {len(tables)}")
    if not offs.is_cuda:
        return select_plain(tables, start, offs, count)
    S, k = offs.shape
    dev = offs.device
    for tab in tables:
        if tab.dtype != torch.int32 or tab.dim() != 1 or not tab.is_contiguous():
            raise ValueError("select tables must be contiguous 1-D int32")
        if tab.is_cuda and tab.device != dev:
            raise ValueError(f"table on {tab.device}, offsets on {dev}")
    if start.dtype != torch.int64 or start.shape != (S,) or start.device != dev:
        raise ValueError(f"start must be ({S},) int64 on {dev}")
    if offs.dtype != torch.int32 or not offs.is_contiguous():
        raise ValueError("offs must be contiguous int32")
    if count is not None and (count.dtype != torch.int32
                              or count.shape != (S,) or count.device != dev):
        raise ValueError(f"count must be ({S},) int32 on {dev}")
    start = start.contiguous()
    lib = load("select")
    outs = [torch.empty((S, k), dtype=torch.int32, device=dev)
            for _ in tables]
    tabs = [device_pointer(lib, t) for t in tables]
    with torch.cuda.device(dev):
        err = lib.quiver_select(
            tabs[0], tabs[1] if len(tabs) == 2 else None, start.data_ptr(),
            offs.data_ptr(), None if count is None else count.contiguous().data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr() if len(outs) == 2 else None,
            S, k, stream_ptr(dev),
        )
    check(err, "select kernel launch")
    select.launches += 1
    return tuple(outs)


select.launches = 0


def fused_select_hop(indices, start, offs, *, eid=None):
    """Raw gather-select ``out[r, c] = indices[start[r] + offs[r, c]]``
    (plus an aligned ``eid`` lane when given), the contract of
    ``quiver_tpu.ops.pallas.fused.fused_select_hop`` without its window.
    Returns a tuple of ``(S, k)`` int32 tensors, one per table."""
    tables = (indices,) if eid is None else (indices, eid)
    return select(tables, start.to(torch.int64), offs.to(torch.int32))


def fused_sample_layer(topo, seeds, num_seeds, k: int, generator=None, *,
                       with_eid: bool = False, offs=None):
    """The uniform fused hop: on Hopper it is ``ops.sample.sample_layer``
    itself (exact draw, K1 select, no window)."""
    from ..sample import sample_layer

    return sample_layer(topo, seeds, num_seeds, k, generator,
                        with_eid=with_eid, offs=offs)
