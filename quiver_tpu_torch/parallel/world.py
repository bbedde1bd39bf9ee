"""Collectives over a world mesh: one process per mesh slot.

The JAX package's collectives (``psum``, ``all_to_all``, ``all_gather``
over a mesh axis) are XLA's. On a logical mesh the port runs them as
tensor operations over the members one process holds; on a
:class:`~.mesh.WorldMesh` each member is a process, and these functions
run them over the rank's ``torch.distributed`` group for the named axes
(``WorldMesh.group``), ``gloo`` on the CPU and ``nccl`` on a card, with
every tensor on the rank's device.

* :func:`ordered_sum`: every float sum. An ``all_gather``, then a left
  fold in member order: the bits are the logical mesh's loop, which adds
  the members' values one after another. ``all_reduce`` would sum in the
  backend's order. The fold holds the group's W operands at once (W
  copies of a flat gradient in the trainer's update), which the widths
  the port trains at afford.
* :func:`int_sum`: an integer sum, one ``all_reduce`` (exact in any
  order).
* :func:`all_to_all`: equal splits over the group
  (``all_to_all_single``).
* :func:`all_gather`: the members' tensors stacked in member order.
* :func:`barrier` and :func:`root_int`: the host-side agreement a
  checkpoint needs: every rank waits until all arrive, and every rank
  takes rank 0's integer (the step it restores, the save sequence).

Each marks itself (``obs.marks.collective``) with the primitive, the mesh
axes and the per-member operand the logical form marks, so the program
audit (``tools/audit``) records the same collectives for one rank's step
as for one member of the logical step. :data:`CALLS` counts the
collectives run, by primitive and device type (``chip_smoke.py`` reads it
to show that no hop went through the host).
"""

from __future__ import annotations

import collections

import torch

from ..obs.marks import collective

__all__ = ["CALLS", "all_gather", "all_to_all", "barrier", "int_sum", "ordered_sum",
           "reset_calls", "root_int"]

# (primitive, device type) -> collectives run in this process
CALLS: collections.Counter = collections.Counter()


def reset_calls() -> None:
    """Zero :data:`CALLS`."""
    CALLS.clear()


def _gather(x, group) -> list:
    """The members' ``x`` in member order."""
    CALLS["all_gather", x.device.type] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in group.ranks]
    torch.distributed.all_gather(parts, x, group=group.group)
    return parts


def all_gather(x, group, axes, mark: bool = True):
    """``(W, ...)``: every member's ``x`` stacked in member order (JAX's
    ``all_gather`` over ``axes``). ``mark=False`` leaves it unmarked, where
    the logical form's counterpart is no marked collective (the trainers'
    loss mean)."""
    out = torch.stack(_gather(x, group))
    if mark:
        collective("all_gather", axes, out)
    return out


def ordered_sum(x, group, axes, shape=None, mark: bool = True):
    """The members' ``x`` summed in member order (JAX's ``psum`` over
    ``axes`` on float values), bitwise the logical mesh's left fold.
    ``shape``: the per-member operand's shape for the mark, when the
    logical form's differs from ``x``'s; ``mark=False`` as in
    :func:`all_gather` (the trainers' gradient sums, which the logical
    form accumulates in its backward)."""
    out = None
    for part in _gather(x, group):
        out = part if out is None else out + part
    if mark:
        collective("psum", axes, out, shape=shape)
    return out


def int_sum(x, group, axes, mark: bool = True):
    """The members' integer ``x`` summed (JAX's ``psum`` over ``axes``):
    one ``all_reduce``, exact in any order. ``mark=False`` as in
    :func:`all_gather` (a streaming commit's abort vote, which the logical
    form does not need)."""
    CALLS["all_reduce", x.device.type] += 1
    out = x.clone()
    torch.distributed.all_reduce(out, group=group.group)
    if mark:
        collective("psum", axes, out)
    return out


def all_to_all(x, group, axes):
    """JAX's ``all_to_all`` over ``axes`` with equal splits: ``x`` is this
    member's ``(W, ...)`` send buckets, row ``j`` for member ``j``; returns
    the ``(W, ...)`` received ones, row ``i`` from member ``i``."""
    CALLS["all_to_all", x.device.type] += 1
    collective("all_to_all", axes, x, member=True)
    x = x.contiguous()
    out = torch.empty_like(x)
    torch.distributed.all_to_all_single(out, x, group=group.group)
    return out


def barrier(mesh) -> None:
    """Wait until every rank of ``mesh``'s world arrives (``barrier`` over
    the world group, on the rank's card under ``nccl``). Unmarked: the
    logical form has no counterpart."""
    dev = mesh.device
    CALLS["barrier", dev.type] += 1
    if dev.type == "cuda":
        torch.distributed.barrier(device_ids=[dev.index])
    else:
        torch.distributed.barrier()


def root_int(value, mesh) -> int:
    """Rank 0's ``value`` (an int; anything on the other ranks), on every
    rank of ``mesh``'s world: one ``broadcast`` of an int64 on the rank's
    device, read on the host. Unmarked, as :func:`barrier`."""
    dev = mesh.device
    CALLS["broadcast", dev.type] += 1
    t = torch.full((1,), int(value) if mesh.rank == 0 else 0, dtype=torch.int64,
                   device=dev)
    torch.distributed.broadcast(t, src=0)
    return int(t.item())
