"""Per-hop neighbour select (kernel K1, ``select.cu``) and weighted select
(kernel K3, ``wselect.cu``).

The port of ``quiver_tpu/ops/pallas/fused.py``. There the TPU kernels
``_select_kernel`` and ``_wselect_kernel`` DMA a 2048-slot window of each
CSR row into VMEM and pick (or inverse-CDF search) the drawn slots with
one-hot masked sums; rows longer than the window are sampled from a random
window (uniform) or refused (weighted). On Hopper a thread loads each drawn
slot, or each probe of its search, directly, so a hop takes the exact draw
of ``ops.sample.sample_layer`` with ``start = indptr[seed]`` and no window:
every row is sampled exactly.

:func:`select` and :func:`wselect` launch their kernels for CUDA tensors
and raise if they cannot; :func:`select_plain` and :func:`wselect_plain`
are the same functions in plain PyTorch, used for CPU tensors and as the
references the kernels are checked against.
"""

from __future__ import annotations

import torch

from .build import check, device_pointer, load, stream_ptr

__all__ = [
    "fused_sample_layer",
    "fused_select_hop",
    "fused_weighted_hop",
    "select",
    "select_plain",
    "wselect",
    "wselect_plain",
]


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


def wselect_plain(indices, cum_weights, start, deg, u, iters: int, *,
                  eid=None, scale_u: bool = True):
    """Weighted select in plain PyTorch: per lane ``(r, c)`` of ``u``, the
    row-local offset ``row_off`` of the inverse-CDF draw over row
    ``[start[r], start[r] + deg[r])`` (``u`` scaled by the row total when
    ``scale_u``; rows with ``deg <= k`` take ``c``), and
    ``nbr = indices[start + row_off]`` (plus the ``eid`` lane). Lanes
    ``c >= min(deg, k)`` are ``-1`` in every output."""
    from ..sample import weighted_offsets

    S, k = u.shape
    dev = u.device
    if cum_weights.numel() == 0:  # no edges: every lane is masked
        return tuple(torch.full((S, k), -1, dtype=torch.int32, device=dev)
                     for _ in range(2 if eid is None else 3))
    s = start.to(device=dev, dtype=torch.int64)
    d = deg.to(dev)
    off, mask = weighted_offsets(cum_weights.to(dev), s, d, k, iters, u,
                                 scale_u=scale_u)
    off = torch.where(mask, off, -1)
    pos = torch.where(mask, s[:, None] + off, 0)
    outs = [torch.where(mask, indices.to(dev)[pos], -1).to(torch.int32), off]
    if eid is not None:
        outs.append(torch.where(mask, eid.to(dev)[pos], -1).to(torch.int32))
    return tuple(outs)


def wselect(indices, cum_weights, start, deg, u, iters: int, *, eid=None,
            scale_u: bool = True):
    """Weighted neighbour select (kernel K3).

    Args:
      indices: ``(E,)`` int32 CSR neighbours, on the device or in pinned
        host memory (read over UVA); ``cum_weights`` ``(E,)`` float32
        row-local inclusive prefix weights and ``eid`` ``(E,)`` int32
        (optional) alike.
      start: ``(S,)`` int64 row starts (``indptr[seed]``).
      deg: ``(S,)`` int32 row lengths, 0 on invalid seeds.
      u: ``(S, k)`` float32 contiguous draws: uniforms in ``[0, 1)``
        scaled in-kernel by the row total when ``scale_u``, else already
        scaled.
      iters: bisection rounds, ``>= ceil(log2(max_degree + 1))``.

    Returns ``(nbr, row_off[, eid])``, each ``(S, k)`` int32, ``-1`` on
    lanes ``c >= min(deg, k)``. CPU ``u`` takes :func:`wselect_plain`;
    CUDA ``u`` launches the kernel.
    """
    if not u.is_cuda:
        return wselect_plain(indices, cum_weights, start, deg, u, iters,
                             eid=eid, scale_u=scale_u)
    S, k = u.shape
    dev = u.device
    E = indices.shape[0]
    for name, tab, dtype in (("indices", indices, torch.int32),
                             ("cum_weights", cum_weights, torch.float32),
                             ("eid", eid, torch.int32)):
        if tab is None:
            continue
        if (tab.dtype != dtype or tab.dim() != 1 or tab.shape[0] != E
                or not tab.is_contiguous()):
            raise ValueError(f"{name} must be contiguous ({E},) {dtype}")
        if tab.is_cuda and tab.device != dev:
            raise ValueError(f"{name} on {tab.device}, draws on {dev}")
    if start.dtype != torch.int64 or start.shape != (S,) or start.device != dev:
        raise ValueError(f"start must be ({S},) int64 on {dev}")
    if deg.dtype != torch.int32 or deg.shape != (S,) or deg.device != dev:
        raise ValueError(f"deg must be ({S},) int32 on {dev}")
    if u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError("u must be contiguous float32")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    start, deg = start.contiguous(), deg.contiguous()
    lib = load("wselect")
    outs = [torch.empty((S, k), dtype=torch.int32, device=dev)
            for _ in range(2 if eid is None else 3)]
    with torch.cuda.device(dev):
        err = lib.quiver_wselect(
            device_pointer(lib, indices), device_pointer(lib, cum_weights),
            None if eid is None else device_pointer(lib, eid),
            start.data_ptr(), deg.data_ptr(), u.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if eid is not None else None,
            S, k, int(iters), int(bool(scale_u)), stream_ptr(dev),
        )
    check(err, "wselect kernel launch")
    wselect.launches += 1
    return tuple(outs)


wselect.launches = 0


def fused_select_hop(indices, start, offs, *, eid=None):
    """Raw gather-select ``out[r, c] = indices[start[r] + offs[r, c]]``
    (plus an aligned ``eid`` lane when given), the contract of
    ``quiver_tpu.ops.pallas.fused.fused_select_hop`` without its window.
    Returns a tuple of ``(S, k)`` int32 tensors, one per table."""
    tables = (indices,) if eid is None else (indices, eid)
    return select(tables, start.to(torch.int64), offs.to(torch.int32))


def fused_weighted_hop(indices, cum_weights, start, deg, u, iters: int, *,
                       eid=None, scale_u: bool = True):
    """Raw weighted select, the contract of
    ``quiver_tpu.ops.pallas.fused.fused_weighted_hop`` without its window:
    the row is ``[start, start + deg)`` itself. Returns
    ``(nbr, row_off[, eids])``, each ``(S, k)`` int32 (see :func:`wselect`)."""
    return wselect(indices, cum_weights, start.to(torch.int64),
                   deg.to(torch.int32), u.to(torch.float32).contiguous(),
                   iters, eid=eid, scale_u=scale_u)


def fused_sample_layer(topo, seeds, num_seeds, k: int, generator=None, *,
                       weighted: bool = False, time_window=None,
                       with_eid: bool = False, offs=None, u=None):
    """The fused hop, every variant: on Hopper it is
    ``ops.sample.sample_layer`` itself (exact draw, no window; K1 selects
    uniform and temporal hops, K3 runs weighted ones)."""
    from ..sample import sample_layer

    return sample_layer(topo, seeds, num_seeds, k, generator,
                        with_eid=with_eid, offs=offs, weighted=weighted,
                        time_window=time_window, u=u)
