"""Parameter conversion from the JAX package's flax GraphSAGE."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_sage_to_state_dict"]


def flax_sage_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``GraphSAGE.state_dict()`` for a flax GraphSAGE parameter tree.

    ``params`` is ``{"conv{i}": {"lin_l": {"kernel", "bias"},
    "lin_r": {"kernel"}}}`` with array leaves (numpy or anything
    ``np.asarray`` takes). A flax ``kernel`` is ``(in, out)``;
    ``nn.Linear.weight`` is ``(out, in)``, so kernels are transposed.
    """
    state = {}
    i = 0
    while f"conv{i}" in params:
        conv = params[f"conv{i}"]
        pre = f"convs.{i}"

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        state[f"{pre}.lin_l.weight"] = t(conv["lin_l"]["kernel"]).T.contiguous()
        state[f"{pre}.lin_l.bias"] = t(conv["lin_l"]["bias"])
        state[f"{pre}.lin_r.weight"] = t(conv["lin_r"]["kernel"]).T.contiguous()
        i += 1
    if i == 0:
        raise ValueError("no conv0 in the parameter tree")
    return state
