"""Per-hop neighbour select (kernel K1, ``select.cu``) and weighted select
(kernel K3, ``wselect.cu``).

The port of ``quiver_tpu/ops/pallas/fused.py``. There the TPU kernels
``_select_kernel`` and ``_wselect_kernel`` DMA a 2048-slot window of each
CSR row into VMEM and pick (or inverse-CDF search) the drawn slots with
one-hot masked sums; rows longer than the window are sampled from a random
window (uniform) or refused (weighted). On Hopper a thread loads each drawn
slot directly, and a weighted search bisects the row's prefix weights in
device memory, so a hop takes the exact draw of ``ops.sample.sample_layer`` with
``start = indptr[seed]`` and no window: every row is sampled exactly.

K1 has two entries. :func:`uniform_hop` is the whole uniform hop in one
launch: degrees, stratified offsets, rotation, count, select and eid lane
from the raw draws of ``ops.sample.draw_bits``. :func:`select` is the
select alone (the Pallas contract), for offsets drawn elsewhere (the
``offs=`` and ``draw_fn`` seams, which carry JAX's draws) and for the
temporal hop, whose row start and degree come from the window search.

K3 has two entries alike. :func:`weighted_hop` is the whole weighted hop
in one launch from the ``u01`` draws of ``ops.sample.draw_u01``: degrees,
counts, the scaled inverse-CDF search, select and eid lane. :func:`wselect`
is the search and select alone (the Pallas contract), for draws that are
a callable of the degrees (the ``u=`` and ``draw_fn`` seams) and for
draws scaled elsewhere (``scale_u=False``).

Each of the four launches its kernel for CUDA tensors and raises if it
cannot; its ``*_plain`` twin is the same function in plain PyTorch, used
for CPU tensors and as the reference the kernel is checked against. Each
is a ``kernel_entry`` (``obs/marks.py``): under the program audit's
recorder one call is one opaque kernel node, on either device.
"""

from __future__ import annotations

import torch

from ...obs.marks import kernel_entry
from .build import address, launch

__all__ = [
    "fused_sample_layer",
    "fused_select_hop",
    "fused_weighted_hop",
    "select",
    "select_plain",
    "uniform_hop",
    "uniform_hop_plain",
    "weighted_hop",
    "weighted_hop_plain",
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


def _check_table(tab, name: str, dtype, index: int) -> int:
    """``tab``'s address for a kernel on ``index``, after the memory checks."""
    if tab.dtype != dtype or tab.dim() != 1 or not tab.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    return address(tab, index)


def _check_rows(t, name: str, dtype, S: int, index: int):
    """``t`` as a contiguous ``(S,)`` tensor of ``dtype`` on ``index``."""
    if t.dtype != dtype or t.shape != (S,) or t.get_device() != index:
        raise ValueError(f"{name} must be ({S},) {dtype} on cuda:{index}")
    return t.contiguous()


@kernel_entry
def select(tables, start, offs, count=None):
    """Neighbour select over one or two int32 tables (kernel K1).

    Args:
      tables: ``(indices,)`` or ``(indices, eid)``, int32 ``(E,)`` each, on
        the device or in pinned host memory (read over UVA).
      start: ``(S,)`` int64 row starts (``indptr[seed]``).
      offs: ``(S, k)`` int32 contiguous row-local slot offsets.
      count: optional ``(S,)`` int32 valid lanes per row; lanes past it
        are ``-1`` and read nothing. Without it every lane must be valid.

    Returns a tuple of ``(S, k)`` int32 tensors, one per table. CPU
    ``offs`` take :func:`select_plain`; CUDA ``offs`` launch the kernel.
    """
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"select takes one or two tables, got {len(tables)}")
    if not offs.is_cuda:
        return select_plain(tables, start, offs, count)
    index = offs.get_device()
    if offs.dtype != torch.int32 or offs.dim() != 2 or not offs.is_contiguous():
        raise ValueError("offs must be contiguous (S, k) int32")
    S, k = offs.shape
    start = _check_rows(start, "start", torch.int64, S, index)
    if count is not None:
        count = _check_rows(count, "count", torch.int32, S, index)
    two = len(tables) == 2
    tab0 = _check_table(tables[0], "select table", torch.int32, index)
    tab1 = _check_table(tables[1], "select table", torch.int32, index) if two else 0
    # one allocation per output: cheaper on the host than views of one
    out0 = torch.empty_like(offs)
    out1 = torch.empty_like(offs) if two else None
    launch("select", index, tab0, tab1, start.data_ptr(), offs.data_ptr(),
           0 if count is None else count.data_ptr(), out0.data_ptr(),
           out1.data_ptr() if two else 0, S, k)
    select.launches += 1
    return (out0, out1) if two else (out0,)


select.launches = 0


def uniform_hop_plain(indptr, indices, seeds, num_seeds, jitter, rot, *,
                      eid=None, with_eid: bool = False):
    """:func:`uniform_hop` in plain PyTorch: ``seed_degrees``, then
    ``stratified_offsets`` and ``rotate_offsets`` on the raw draws, then
    :func:`select_plain`."""
    from ..sample import rotate_offsets, seed_degrees, stratified_offsets

    k = jitter.shape[-1]
    _valid, base, deg = seed_degrees(indptr, seeds, num_seeds)
    off, _ = stratified_offsets(deg, k, jitter)
    off = rotate_offsets(off, deg, k, rot)
    counts = deg.clamp(max=k)  # deg is 0 on invalid seeds
    start = base.to(torch.int64)
    tables = (indices,) if eid is None or not with_eid else (indices, eid)
    outs = select_plain(tables, start.reshape(-1), off.reshape(-1, k),
                        counts.reshape(-1))
    nbr = outs[0].reshape(off.shape)
    if not with_eid:
        return nbr, counts
    if eid is not None:
        return nbr, counts, outs[1].reshape(off.shape)
    # CSR slots, in indptr's width
    epos = start[..., None] + off.to(torch.int64)
    return nbr, counts, torch.where(nbr >= 0, epos, -1).to(base.dtype)


@kernel_entry
def uniform_hop(indptr, indices, seeds, num_seeds, jitter, rot, *, eid=None,
                with_eid: bool = False):
    """The uniform hop in one launch (kernel K1, ``quiver_uniform_hop``).

    Args:
      indptr: ``(N + 1,)`` CSR row pointers, int32 or int64.
      indices: ``(E,)`` int32 CSR neighbours, on the device or in pinned
        host memory (read over UVA); ``eid`` ``(E,)`` int32 (optional)
        alike.
      seeds: ``(..., S)`` int32 node ids, -1 padded.
      num_seeds: valid seeds, an int or a tensor of one count for all or
        one per leading index.
      jitter: ``(..., S, k)`` int64 raw draws, reduced modulo each
        stratum's span (``ops.sample.draw_bits``).
      rot: ``(..., S, 1)`` int64 raw draws, reduced modulo the degree.
      with_eid: also return the eid lane: ``eid``'s values, or the CSR
        slots in indptr's width when ``eid`` is None.

    Returns ``(neighbors (..., S, k) int32, counts (..., S) int32[,
    eids])``, -1 on invalid lanes: exactly ``ops.sample.sample_layer``'s
    uniform hop on these draws. CPU ``seeds`` take
    :func:`uniform_hop_plain`; CUDA ``seeds`` launch the kernel.
    """
    if not seeds.is_cuda:
        return uniform_hop_plain(indptr, indices, seeds, num_seeds, jitter,
                                 rot, eid=eid, with_eid=with_eid)
    index = seeds.get_device()
    shape = seeds.shape
    k = jitter.shape[-1]
    if not 1 <= k <= 46340:  # the kernel's 32-bit strata need k^2 < 2^31
        raise ValueError(f"uniform_hop needs 1 <= k <= 46340, got {k}")
    if seeds.dtype != torch.int32:
        raise ValueError("seeds must be int32")
    seeds = seeds.contiguous()  # a frontier is a strided view of its buffer
    if (jitter.dtype != torch.int64 or jitter.shape != shape + (k,)
            or jitter.get_device() != index or not jitter.is_contiguous()):
        raise ValueError(f"jitter must be contiguous {tuple(shape) + (k,)} "
                         f"int64 on cuda:{index}")
    if (rot.dtype != torch.int64 or rot.shape != shape + (1,)
            or rot.get_device() != index or not rot.is_contiguous()):
        raise ValueError(f"rot must be contiguous {tuple(shape) + (1,)} "
                         f"int64 on cuda:{index}")
    head, tail, outputs, _num = _hop_args(indptr, indices, eid, with_eid, seeds,
                                          num_seeds, jitter, index)
    launch("uniform_hop", index, *head, jitter.data_ptr(), rot.data_ptr(),
           *tail, k)
    uniform_hop.launches += 1
    return outputs


uniform_hop.launches = 0


def _hop_args(indptr, indices, eid, with_eid, seeds, num_seeds, draws, index):
    """The checked arguments and outputs a fused hop entry shares: ``(head,
    tail, outputs, num)`` with ``head`` = (indptr, indptr64, seeds, num,
    num_scalar, num_stride), the struct's fields before the draws, ``tail``
    = (indices, eid, nbr, counts, eids, eid_lane, rows, S) after them,
    ``outputs`` = ``(nbr, counts[, eids])``, each lane output allocated
    like ``draws``, and ``num`` the per-lead count tensor the launch reads
    (or None), which the caller holds until it has launched."""
    shape = seeds.shape
    if indptr.dtype not in (torch.int32, torch.int64):
        raise ValueError("indptr must be int32 or int64")
    indptr_ptr = _check_table(indptr, "indptr", indptr.dtype, index)
    tab = _check_table(indices, "indices", torch.int32, index)
    eid_ptr = 0
    if with_eid and eid is not None:
        eid_ptr = _check_table(eid, "eid", torch.int32, index)
    rows = seeds.numel()
    num, num_scalar, num_stride, num_t = 0, 0, 0, None
    if isinstance(num_seeds, torch.Tensor):
        lead_n = rows // shape[-1] if shape[-1] else 0
        if num_seeds.numel() not in (1, lead_n):
            raise ValueError(f"num_seeds must hold 1 or {lead_n} counts")
        num_t = num_seeds.to(device=seeds.device, dtype=torch.int32).contiguous()
        num, num_stride = num_t.data_ptr(), int(num_seeds.numel() != 1)
    else:
        # graftlint: disable=host-op-on-tracer -- num_seeds is a host int on this branch, a device tensor takes the one above
        num_scalar = int(num_seeds)
    # one allocation per output: cheaper on the host than views of one
    nbr = torch.empty_like(draws, dtype=torch.int32)
    counts = torch.empty_like(seeds)
    eids, eid_lane = None, 0
    if with_eid:  # the eid table's int32, or CSR slots in indptr's width
        eid_lane = 1 if eid is not None else 2
        eids = torch.empty_like(draws, dtype=torch.int32 if eid is not None
                                else indptr.dtype)
    head = (indptr_ptr, int(indptr.dtype == torch.int64), seeds.data_ptr(),
            num, num_scalar, num_stride)
    tail = (tab, eid_ptr, nbr.data_ptr(), counts.data_ptr(),
            0 if eids is None else eids.data_ptr(), eid_lane, rows, shape[-1])
    return head, tail, (nbr, counts) if eids is None else (nbr, counts, eids), num_t


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


@kernel_entry
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
    lanes ``c >= min(deg, k)``. CPU ``u`` takes
    :func:`wselect_plain`; CUDA ``u`` launches the kernel.
    """
    if not u.is_cuda:
        return wselect_plain(indices, cum_weights, start, deg, u, iters,
                             eid=eid, scale_u=scale_u)
    index = u.get_device()
    if u.dtype != torch.float32 or u.dim() != 2 or not u.is_contiguous():
        raise ValueError("u must be contiguous (S, k) float32")
    S, k = u.shape
    E = indices.shape[0]
    tabs = [0 if tab is None else _check_table(tab, name, dtype, index)
            for name, tab, dtype in (("indices", indices, torch.int32),
                                     ("cum_weights", cum_weights, torch.float32),
                                     ("eid", eid, torch.int32))]
    if cum_weights.shape[0] != E or (eid is not None and eid.shape[0] != E):
        raise ValueError(f"indices, cum_weights and eid must hold {E} edges")
    start = _check_rows(start, "start", torch.int64, S, index)
    deg = _check_rows(deg, "deg", torch.int32, S, index)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    outs = tuple(torch.empty_like(u, dtype=torch.int32)
                 for _ in range(2 if eid is None else 3))
    launch("wselect", index, *tabs, start.data_ptr(), deg.data_ptr(),
           u.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
           outs[2].data_ptr() if eid is not None else 0, S, k, iters,
           int(bool(scale_u)))
    wselect.launches += 1
    return outs


wselect.launches = 0


def weighted_hop_plain(indptr, indices, cum_weights, seeds, num_seeds, u01,
                       iters: int, *, eid=None, with_eid: bool = False):
    """:func:`weighted_hop` in plain PyTorch: ``seed_degrees``, then
    :func:`wselect_plain` (``weighted_offsets`` and the select) on the rows'
    starts and degrees."""
    from ..sample import seed_degrees

    k = u01.shape[-1]
    _valid, base, deg = seed_degrees(indptr, seeds, num_seeds)
    counts = deg.clamp(max=k)  # deg is 0 on invalid seeds
    start = base.to(torch.int64)
    outs = wselect_plain(indices, cum_weights, start.reshape(-1), deg.reshape(-1),
                         u01.reshape(-1, k), iters,
                         eid=eid if with_eid else None)
    nbr = outs[0].reshape(u01.shape)
    if not with_eid:
        return nbr, counts
    if eid is not None:
        return nbr, counts, outs[2].reshape(u01.shape)
    # CSR slots, in indptr's width
    epos = start[..., None] + outs[1].reshape(u01.shape).to(torch.int64)
    return nbr, counts, torch.where(nbr >= 0, epos, -1).to(base.dtype)


@kernel_entry
def weighted_hop(indptr, indices, cum_weights, seeds, num_seeds, u01,
                 iters: int, *, eid=None, with_eid: bool = False):
    """The weighted hop in one launch (kernel K3, ``quiver_weighted_hop``).

    Args:
      indptr: ``(N + 1,)`` CSR row pointers, int32 or int64.
      indices: ``(E,)`` int32 CSR neighbours, on the device or in pinned
        host memory (read over UVA); ``cum_weights`` ``(E,)`` float32
        row-local inclusive prefix weights and ``eid`` ``(E,)`` int32
        (optional) alike.
      seeds: ``(..., S)`` int32 node ids, -1 padded.
      num_seeds: valid seeds, an int or a tensor of one count for all or
        one per leading index.
      u01: ``(..., S, k)`` float32 uniforms in ``[0, 1)``, scaled by each
        row's total weight (``ops.sample.draw_u01``).
      iters: bisection rounds, ``>= ceil(log2(max_degree + 1))``.
      with_eid: also return the eid lane: ``eid``'s values, or the CSR
        slots in indptr's width when ``eid`` is None.

    Returns ``(neighbors (..., S, k) int32, counts (..., S) int32[,
    eids])``, -1 on invalid lanes: exactly ``ops.sample.sample_layer``'s
    weighted hop on these draws. CPU ``seeds`` take
    :func:`weighted_hop_plain`; CUDA ``seeds`` launch the kernel.
    """
    if not seeds.is_cuda:
        return weighted_hop_plain(indptr, indices, cum_weights, seeds, num_seeds,
                                  u01, iters, eid=eid, with_eid=with_eid)
    index = seeds.get_device()
    k = u01.shape[-1]
    if k < 1:
        raise ValueError(f"weighted_hop needs k >= 1, got {k}")
    if seeds.dtype != torch.int32:
        raise ValueError("seeds must be int32")
    seeds = seeds.contiguous()  # a frontier is a strided view of its buffer
    if (u01.dtype != torch.float32 or u01.shape != seeds.shape + (k,)
            or u01.get_device() != index or not u01.is_contiguous()):
        raise ValueError(f"u01 must be contiguous {tuple(seeds.shape) + (k,)} "
                         f"float32 on cuda:{index}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    cw = _check_table(cum_weights, "cum_weights", torch.float32, index)
    if cum_weights.shape[0] != indices.shape[0]:
        raise ValueError("indices and cum_weights must hold the same edges")
    head, tail, outputs, _num = _hop_args(indptr, indices, eid, with_eid, seeds,
                                          num_seeds, u01, index)
    launch("weighted_hop", index, *head, u01.data_ptr(), cw, *tail, k, iters)
    weighted_hop.launches += 1
    return outputs


weighted_hop.launches = 0


def fused_select_hop(indices, start, offs, *, eid=None):
    """Raw gather-select ``out[r, c] = indices[start[r] + offs[r, c]]``
    (plus an aligned ``eid`` lane when given), the contract of
    ``quiver_tpu.ops.pallas.fused.fused_select_hop`` without its window.
    Returns a tuple of ``(S, k)`` int32 tensors, one per table."""
    tables = (indices,) if eid is None else (indices, eid)
    return select(tables, start.to(torch.int64), offs.to(torch.int32).contiguous())


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
    ``ops.sample.sample_layer`` itself (exact draw, no window; K1 runs
    uniform and temporal hops, K3 weighted ones, each in one launch from a
    generator's or a tensor's draws)."""
    from ..sample import sample_layer

    return sample_layer(topo, seeds, num_seeds, k, generator,
                        with_eid=with_eid, offs=offs, weighted=weighted,
                        time_window=time_window, u=u)
