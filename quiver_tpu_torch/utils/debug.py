"""Debug introspection helpers.

The port of ``quiver_tpu/utils/debug.py``: ``show_tensor_info`` prints a
tensor's dtype, shape and placement (the reference's debug binding,
torch-quiver srcs/cpp/src/quiver/cpu/tensor.cpp:25-96); for a host tensor
it also says whether the memory is pinned, the placement the cold feature
tier and UVA topologies read over PCIe.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["show_tensor_info", "tensor_info"]


def tensor_info(x) -> str:
    """One-line description of a tensor's dtype, shape and placement."""
    if isinstance(x, torch.Tensor):
        placement = str(x.device)
        if x.device.type == "cpu" and x.is_pinned():
            placement += ", pinned"
        return f"torch.Tensor dtype={x.dtype} shape={tuple(x.shape)} [{placement}]"
    x = np.asarray(x)
    return f"numpy dtype={x.dtype} shape={x.shape} [host]"


def show_tensor_info(x) -> str:
    """Print and return :func:`tensor_info` (reference tensor.cpp:74-95)."""
    s = tensor_info(x)
    print(s)
    return s
