"""The non-finite step guard: skip an optimizer update that a NaN or Inf
loss or gradient would poison.

The port of ``quiver_tpu/resilience/guard.py``. One NaN batch poisons the
parameters for the rest of an epoch; the guard counts the non-finite
values of a step's loss and gradients before the optimizer sees them, and
skips the update when there is any. A skipped step's parameters and
optimizer state (Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``) stay
bit-unchanged; its (NaN) loss still lands in the trajectory, so the skip
is visible to the caller.

The JAX package decides inside its compiled step (a ``lax.cond`` on a
mesh-psum'd verdict). Here the verdict is a device tensor and
:func:`guarded_update` reads it on the host, one synchronisation per step,
paid only while the guard is on. On a world mesh (one process per slot)
the count is summed over the named axes' process group first, so that
every rank takes the same branch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nonfinite_count", "guard_verdict", "guarded_update"]


def _leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def nonfinite_count(tree) -> torch.Tensor:
    """int32 scalar: the number of non-finite elements across the float
    leaves of ``tree`` (tensors, numpy arrays or Python numbers, in nested
    dicts, lists and tuples). Integer and boolean leaves cannot hold a
    non-finite value and count zero. The count lies on the device of the
    first tensor leaf (the CPU when there is none) and is not read back."""
    leaves = list(_leaves(tree))
    dev = next((v.device for v in leaves if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.asarray(leaf))
        if leaf.is_floating_point() or leaf.is_complex():
            total = total + (~torch.isfinite(leaf)).sum(dtype=torch.int32).to(dev)
    return total


def guard_verdict(loss, grads, axes=None, mesh=None):
    """The step's verdict, taken before the gradients are averaged (the
    average spreads one worker's NaN to every worker; counting first
    attributes the fault to the worker that produced it).

    Returns ``(ok, local_bad)``: ``local_bad`` is the int32 count of
    non-finite values in ``(loss, grads)`` and ``ok`` the device bool that
    the count summed over ``axes`` is 0. The sum runs over this rank's
    process group for ``axes`` on a world mesh (``mesh``, default the
    process's newest, ``parallel.mesh.current_world``), an integer sum, so
    every rank takes the same branch; with one process (no world mesh, or
    no ``axes``) it is the identity."""
    local_bad = nonfinite_count((loss, grads))
    if axes is not None:
        from ..parallel import mesh as mesh_mod, world

        mesh = mesh if mesh is not None else mesh_mod.current_world()
        if mesh_mod.is_world(mesh):
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            total = world.int_sum(local_bad, mesh.group(axes), axes)
            return total == 0, local_bad
    return local_bad == 0, local_bad


def guarded_update(optimizer: torch.optim.Optimizer, params, ok) -> bool:
    """One ``optimizer.step()`` when ``ok`` holds; otherwise none, and the
    parameters and the optimizer's whole state pass through bit-unchanged
    (Adam's ``step`` count too: the step is never called). On a skipped
    step the gradients of ``params`` (tensors, or a module) are dropped,
    so the poison does not reach the next step's accumulation.

    ``ok`` may be a device tensor: it is read on the host, one
    synchronisation per guarded step. Returns whether the update ran."""
    applied = bool(ok)
    if applied:
        optimizer.step()
    else:
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        for p in params:
            p.grad = None
    return applied
