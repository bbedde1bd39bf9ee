"""Device resolution and pinned host placement."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_pinned_host"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no device and no CUDA card this raises; it never carries
    on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_pinned_host(x, device=None, mesh=None) -> tuple[torch.Tensor, bool]:
    """Place ``x`` in pinned host memory when its device is a CUDA device.

    The device is ``device``; else, with ``mesh``, a CUDA device among the
    slots this process runs (the first such, so a mesh of a card and the
    host pins, since the card reads the rows over UVA; a world mesh's rank
    device: pinned memory is one copy per host, which every slot of the
    process reads), or the mesh's first device when none is a card; else
    :func:`resolve_device` ``(None)``, the card, raising without one. The
    JAX package's ``to_pinned_host(x, mesh=None)`` calls take the same
    arguments.

    Returns ``(tensor, is_host)``. Pinned host memory is mapped into the
    card's address space (UVA), so the kernels read it over PCIe with no
    staging copy: the reference's zero-copy design. On a CPU device the
    tensor stays in ordinary memory and ``is_host`` is False.
    """
    if device is None and mesh is not None:
        slots = mesh.devices.ravel().tolist()
        device = next((d for d in slots if torch.device(d).type == "cuda"), slots[0])
    device = resolve_device(device)
    t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else torch.as_tensor(x)
    if device.type == "cuda":
        return t.contiguous().pin_memory(), True
    return t.contiguous(), False
