"""Parameter conversion from the JAX package's flax models.

Each function turns a flax parameter tree (``{"conv{i}": ...}`` with array
leaves: numpy or anything ``np.asarray`` takes) into the port model's
``state_dict()``. A flax Dense ``kernel`` is ``(in, out)`` and
``nn.Linear.weight`` ``(out, in)``, so kernels are transposed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_gat_to_state_dict", "flax_gcn_to_state_dict",
           "flax_gin_to_state_dict", "flax_rgcn_to_state_dict",
           "flax_sage_to_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _convs(params):
    """``(i, conv{i} subtree)`` in layer order; raises on an empty tree."""
    i = 0
    while f"conv{i}" in params:
        yield i, params[f"conv{i}"]
        i += 1
    if i == 0:
        raise ValueError("no conv0 in the parameter tree")


def flax_sage_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``GraphSAGE.state_dict()`` for a flax GraphSAGE parameter tree.

    ``params`` is ``{"conv{i}": {"lin_l": {"kernel", "bias"},
    "lin_r": {"kernel"}}}`` with array leaves (numpy or anything
    ``np.asarray`` takes). A flax ``kernel`` is ``(in, out)``;
    ``nn.Linear.weight`` is ``(out, in)``, so kernels are transposed.
    """
    state = {}
    for i, conv in _convs(params):
        pre = f"convs.{i}"
        state[f"{pre}.lin_l.weight"] = _t(conv["lin_l"]["kernel"]).T.contiguous()
        state[f"{pre}.lin_l.bias"] = _t(conv["lin_l"]["bias"])
        state[f"{pre}.lin_r.weight"] = _t(conv["lin_r"]["kernel"]).T.contiguous()
    return state


def flax_gcn_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``GCN.state_dict()`` for a flax GCN tree: ``{"conv{i}":
    {"lin": {"kernel"}, "bias"}}``."""
    state = {}
    for i, conv in _convs(params):
        state[f"convs.{i}.lin.weight"] = _t(conv["lin"]["kernel"]).T.contiguous()
        state[f"convs.{i}.bias"] = _t(conv["bias"])
    return state


def flax_gin_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``GIN.state_dict()`` for a flax GIN tree: ``{"conv{i}":
    {"lin1": {"kernel", "bias"}, "lin2": {...}[, "eps"]}}``; ``eps`` is a
    parameter only of a ``train_eps`` model (a 0-d tensor here)."""
    state = {}
    for i, conv in _convs(params):
        for lin in ("lin1", "lin2"):
            state[f"convs.{i}.{lin}.weight"] = _t(conv[lin]["kernel"]).T.contiguous()
            state[f"convs.{i}.{lin}.bias"] = _t(conv[lin]["bias"])
        if "eps" in conv:
            state[f"convs.{i}.eps"] = _t(conv["eps"]).reshape(())
    return state


def flax_gat_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``GAT.state_dict()`` for a flax GAT tree: ``{"conv{i}":
    {"lin": {"kernel"}, "att_l", "att_r", "bias"}}``; ``att_l`` and
    ``att_r`` are ``(H, F)`` in both."""
    state = {}
    for i, conv in _convs(params):
        state[f"convs.{i}.lin.weight"] = _t(conv["lin"]["kernel"]).T.contiguous()
        for name in ("att_l", "att_r", "bias"):
            state[f"convs.{i}.{name}"] = _t(conv[name])
    return state


def flax_rgcn_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``RGCN.state_dict()`` for a flax R-GCN tree: ``{"conv{i}":
    {"self_{t}": {"kernel", "bias"}, "rel_{s}__{r}__{d}": {"kernel"}}}``,
    or with bases ``"bases_{in_dim}"`` ``(B, in, out)`` and
    ``"coef_{s}__{r}__{d}"`` ``(B,)`` in place of the ``rel_`` kernels;
    names carry across unchanged."""
    state = {}
    for i, conv in _convs(params):
        for name, leaf in conv.items():
            pre = f"conv{i}.{name}"
            if name.startswith(("self_", "rel_")):
                state[f"{pre}.weight"] = _t(leaf["kernel"]).T.contiguous()
                if "bias" in leaf:
                    state[f"{pre}.bias"] = _t(leaf["bias"])
            else:  # bases_{in_dim}, coef_{relation}
                state[pre] = _t(leaf)
    return state
