"""Program marks: where a step launches a hand-written kernel and where it
runs a mesh collective, for the program audit (``tools/audit``).

The JAX package's audit reads both off the lowered IR: a kernel is a
``pallas_call`` equation, a collective an ``all_to_all``, ``psum`` or
``all_gather`` primitive. The port runs eagerly, its kernels are ctypes
calls that PyTorch's dispatcher never sees, and its collectives are tensor
operations over the members of a logical mesh held by one process, or
``torch.distributed`` calls on a world mesh (``parallel/world.py``). So
the code says where each one is: every kernel wrapper is a
:func:`kernel_entry`, and every exchange over a mesh axis calls
:func:`collective` with the tensor it moves.

Both do nothing unless a recorder (``tools.audit.ir.record``) is active on
the calling thread. Then the recorder notes the kernel as one opaque node,
its operands and results (the ops of its plain version on the CPU are not
the program's), and the collective with its mesh axes, per-member shape
and dtype. A mark reads no tensor's values, makes no tensor and changes
no result.
"""

from __future__ import annotations

import functools
import threading

__all__ = ["active", "collective", "kernel_entry", "set_recorder"]

_LOCAL = threading.local()


def active():
    """The recorder active on this thread, or None."""
    return getattr(_LOCAL, "recorder", None)


def set_recorder(recorder):
    """Make ``recorder`` (or None) this thread's; returns the previous one."""
    previous = getattr(_LOCAL, "recorder", None)
    _LOCAL.recorder = recorder
    return previous


def kernel_entry(fn):
    """Mark ``fn`` as a kernel wrapper: under a recorder one call is one
    kernel node named ``fn.__name__``; otherwise the call is ``fn``'s."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        recorder = getattr(_LOCAL, "recorder", None)
        if recorder is None:
            return fn(*args, **kwargs)
        return recorder.kernel(fn.__name__, fn, args, kwargs)

    return entry


def collective(prim: str, axes: tuple, value, shape=None, member: bool = False) -> None:
    """Note a collective over mesh ``axes``: ``prim`` is ``"all_to_all"``
    (``value`` the ``(F_src, F_dst, ...)`` send buckets of every member),
    ``"all_gather"`` (``value`` the gathered ``(F, ...)`` result) or
    ``"psum"`` (``value`` the summed result; ``shape`` the per-member
    operand's shape when it differs from ``value``'s).

    ``member=True``: ``value`` is one member's own operand, as a process of
    a world mesh holds it (its ``(F_dst, ...)`` send buckets, or a psum's
    operand): the per-member shape is ``value``'s (or ``shape``), so a
    rank's mark records what one member of the logical form records."""
    recorder = getattr(_LOCAL, "recorder", None)
    if recorder is not None:
        recorder.collective(prim, tuple(axes), value, shape, member)
