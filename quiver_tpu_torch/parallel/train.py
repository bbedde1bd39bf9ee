"""Training-step factories.

The port of ``quiver_tpu/parallel/train.py``: flax's parameter
initialisation, the deepest-first empty ``Adj`` records of the sampler's
static shapes, the masked NLL over the seed rows, and the train and eval
steps. Gradients come from torch autograd (the JAX package's from XLA
autodiff of plain ops; no kernel of either package has a backward), the
update from ``torch.optim.Adam``, whose update is optax ``adam``'s
(``m̂ / (sqrt(v̂) + eps)`` with b1 0.9, b2 0.999, eps 1e-8).

Label convention: only the first ``batch_size`` rows of ``n_id`` are
labelled seeds; padding rows get zero loss weight.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..core.memory import resolve_device
from ..sampling.sampler import Adj, _round_up

__all__ = ["cross_entropy_on_seeds", "empty_adjs", "init_model",
           "make_eval_step", "make_train_step"]

# the std of a standard normal truncated at +-2, which flax's
# variance_scaling divides out so the truncated draw keeps its variance
_TRUNC_STD = 0.87962566103423978


def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every ``nn.Linear`` of ``model`` as flax's ``nn.Dense``
    does, drawing from ``generator``: the weight from ``lecun_normal`` (a
    normal of std ``sqrt(1/fan_in) / 0.8796`` truncated at two of those
    stds), the bias zero. Returns ``model``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def empty_adjs(sizes, batch: int, node_count: int | None = None, device=None):
    """Deepest-first all-invalid Adj records with the sampler's static
    shapes. Caps follow the sampler's worst-case growth: ``prev * (fanout
    + 1)`` clamped at ``node_count`` (never below ``prev``), rounded up to
    8. ``device`` as every entry point's (CUDA unless named)."""
    device = resolve_device(device)
    adjs, prev = [], int(batch)
    for k in sizes:
        k = int(k)
        cap = prev * (k + 1)
        if node_count is not None:
            cap = max(min(cap, int(node_count)), prev)
        cap = _round_up(cap, 8)
        ei = torch.full((2, prev * k), -1, dtype=torch.int32, device=device)
        adjs.append(Adj(ei, None, (cap, prev), fanout=k))
        prev = cap
    return adjs[::-1]


def cross_entropy_on_seeds(logits, labels, label_mask):
    """Mean NLL over the valid seed rows (``logits`` are log-probs; a
    label of -1 is read as class 0 and must be masked out)."""
    lab = labels.clamp(min=0).to(torch.int64)
    ll = torch.gather(logits, 1, lab[:, None])[:, 0]
    w = label_mask.to(logits.dtype)
    return -(ll * w).sum() / w.sum().clamp(min=1.0)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """``step(x, adjs, labels, label_mask, generator) -> loss``: the
    forward in training mode (dropout drawn from ``generator``), the
    masked NLL, its backward and one ``optimizer`` step, which updates
    ``model``'s parameters in place. The gradients stay in ``.grad`` until
    the next step. Returns the loss, detached (no host sync)."""

    def train_step(x, adjs, labels, label_mask, generator=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_on_seeds(model(x, adjs, generator), labels,
                                      label_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """``(x, adjs, labels, label_mask) -> (num_correct, num_valid)``: the
    forward in eval mode, argmax against the labels on the masked rows."""

    def eval_step(x, adjs, labels, label_mask):
        model.eval()
        with torch.no_grad():
            pred = model(x, adjs).argmax(dim=-1)
        correct = ((pred == labels) & label_mask).sum()
        return correct, label_mask.sum()

    return eval_step
