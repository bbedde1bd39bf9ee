"""Relational GCN (R-GCN) over padded hetero layers.

The port of ``quiver_tpu/models/rgcn.py``: Schlichtkrull et al.'s layer
over the typed padded Adjs of ``sampling/hetero.py``,

    h'_v = act( W_self^{type(v)} h_v + sum_rel mean_{u in N_rel(v)} W_rel h_u )

with optional basis decomposition (``num_bases > 0``): ``W_rel = sum_b
a_{rel,b} B_b``, one basis set per distinct source width per layer. Each
layer consumes one ``HeteroLayer`` (deepest first) and shrinks every
type's frontier to its dst capacity.

Flax creates a layer's parameters at its first call, for the types and
relations the sample in hand activates; a torch module creates them up
front, so ``RGCN`` takes that schema at construction:
:func:`rgcn_schema` reads it from a sample's layers and the feature
widths. Parameter names follow flax's tree one to one:
``conv{i}.self_{t}`` (weight, bias), ``conv{i}.rel_{s}__{r}__{d}``
(weight), or with bases ``conv{i}.bases_{in_dim}`` and
``conv{i}.coef_{s}__{r}__{d}`` (``models/convert.py`` carries them across).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .layers import gather_src, segment_mean_aggregate
from .sage import _compute_dtype, apply_linear, dropout

__all__ = ["RGCN", "RGCNLayer", "rgcn_schema"]

# the std of a standard normal truncated at +-2 (flax's lecun_normal
# divides it out, as parallel/train.py's init_model does)
_TRUNC_STD = 0.87962566103423978


def _rel_name(et) -> str:
    s, r, d = et
    return f"{s}__{r}__{d}"


def rgcn_schema(layers: Sequence, in_dims: dict) -> dict:
    """What each R-GCN layer computes, read from a sample's layers
    (deepest first, ``HeteroSampleOutput.adjs``) and the input feature
    width of each node type that has features (``in_dims``):
    ``{"in_dims": {type: width}, "layers": [{"self": [types], "rels":
    [edge types]}, ...]}``. A layer has a self transform for each of its
    dst types that carries features into it, and one weight per relation,
    in ``sorted(..., key=str)`` order, as the flax model creates them."""
    types = set(in_dims)
    out = []
    for layer in layers:
        selfs = [t for t in layer.dst_caps if t in types]
        out.append({"self": selfs, "rels": sorted(layer.adjs, key=str)})
        types = set(selfs)
    return {"in_dims": {str(t): int(w) for t, w in in_dims.items()},
            "layers": out}


class RGCNLayer(nn.Module):
    """One R-GCN layer: a self transform per dst type (with bias), a
    transform per relation (no bias) or its basis combination, and the
    mean of each relation's messages. ``dtype="bfloat16"`` computes the
    products and the aggregation in bf16 (the basis combination stays
    float32 and is cast); the parameters stay float32."""

    def __init__(self, self_dims: dict, rel_dims: dict, features: int,
                 num_bases: int = 0, dtype=None):
        super().__init__()
        self.num_bases = int(num_bases)
        self.dtype = _compute_dtype(dtype)
        self.rel_types = list(rel_dims)
        self.in_dims = {**self_dims, **{et[0]: w for et, w in rel_dims.items()}}
        for t, w in self_dims.items():
            self.add_module(f"self_{t}", nn.Linear(w, features, bias=True))
        for et, w in rel_dims.items():
            if self.num_bases > 0:
                if not hasattr(self, f"bases_{w}"):
                    self.register_parameter(f"bases_{w}", nn.Parameter(
                        torch.empty(self.num_bases, w, features)))
                self.register_parameter(f"coef_{_rel_name(et)}", nn.Parameter(
                    torch.empty(self.num_bases)))
            else:
                self.add_module(f"rel_{_rel_name(et)}",
                                nn.Linear(w, features, bias=False))

    def init_extra(self, generator: torch.Generator) -> None:
        """The basis parameters as flax initialises them: bases from
        ``lecun_normal`` (fan-in ``num_bases * in_dim``), coefficients
        from a normal of std ``1 / num_bases``."""
        for name, p in self.named_parameters(recurse=False):
            if name.startswith("bases_"):
                std = math.sqrt(1.0 / (p.shape[0] * p.shape[1])) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name.startswith("coef_"):
                nn.init.normal_(p, 0.0, 1.0 / max(self.num_bases, 1),
                                generator=generator)

    def self_linear(self, t: str) -> nn.Linear | None:
        """The self transform of type ``t``, or None if it has none."""
        return getattr(self, f"self_{t}", None)

    def relation_weight(self, et) -> torch.Tensor | None:
        """Relation ``et``'s ``(in, out)`` float32 weight (its basis
        combination with bases), or None if this layer has none."""
        if et not in self.rel_types:
            return None
        if self.num_bases > 0:
            bases = getattr(self, f"bases_{self.in_dims[et[0]]}")
            return torch.einsum("b,bif->if", getattr(self, f"coef_{_rel_name(et)}"),
                                bases)
        return getattr(self, f"rel_{_rel_name(et)}").weight.T

    def forward(self, x_dict: dict, layer) -> dict:
        """``x_dict``: ``{type: (src_cap_t, F)}``; ``layer``: a HeteroLayer."""
        if self.dtype is not None:
            x_dict = {t: v.to(self.dtype) for t, v in x_dict.items()}
        out = {}
        for t, cap in layer.dst_caps.items():
            if t in x_dict:
                lin = self.self_linear(t)
                if lin is None:
                    raise ValueError(
                        f"this R-GCN layer has no self transform for {t!r}; "
                        "build the model from a schema of the same sampler")
                out[t] = apply_linear(lin, x_dict[t][:cap], self.dtype)
        for et in sorted(layer.adjs, key=str):
            s_t, _, d_t = et
            adj = layer.adjs[et]
            if et not in self.rel_types:
                raise ValueError(
                    f"this R-GCN layer has no weight for relation {et}; "
                    "build the model from a schema of the same sampler")
            if self.num_bases > 0:
                w = self.relation_weight(et)
                if self.dtype is not None:
                    w = w.to(self.dtype)
                h = x_dict[s_t] @ w
            else:
                h = apply_linear(getattr(self, f"rel_{_rel_name(et)}"), x_dict[s_t],
                                 self.dtype)
            src, dst = adj.edge_index[0], adj.edge_index[1]
            msgs, valid = gather_src(h, src)
            agg = segment_mean_aggregate(msgs, dst.clamp(min=0), valid,
                                         layer.dst_caps[d_t], fanout=adj.fanout)
            out[d_t] = out[d_t] + agg
        return out


class RGCN(nn.Module):
    """Multi-layer R-GCN over ``HeteroGraphSampler`` output.

    ``schema`` is :func:`rgcn_schema`'s; the other arguments are the flax
    model's. The forward returns float32 log-probabilities of the first
    ``dst_cap`` rows of ``target_type`` after the last layer (the seed
    rows). In training mode with ``dropout > 0`` a ``generator`` draws the
    dropout masks of every type.
    """

    def __init__(self, schema: dict, hidden: int, num_classes: int,
                 target_type: str, num_layers: int = 2, num_bases: int = 0,
                 dropout: float = 0.5, dtype=None):
        super().__init__()
        if len(schema["layers"]) != num_layers:
            raise ValueError(
                f"schema has {len(schema['layers'])} layers, the model "
                f"{num_layers}")
        self.num_layers = num_layers
        self.num_classes = num_classes
        self.target_type = target_type
        self.num_bases = num_bases
        self.dropout = dropout
        self.dtype = _compute_dtype(dtype)
        width = dict(schema["in_dims"])
        for i, spec in enumerate(schema["layers"]):
            feats = num_classes if i == num_layers - 1 else hidden
            self.add_module(f"conv{i}", RGCNLayer(
                {t: width[t] for t in spec["self"]},
                {tuple(et): width[et[0]] for et in spec["rels"]},
                feats, num_bases=num_bases, dtype=self.dtype))
            width = {t: feats for t in spec["self"]}

    @property
    def convs(self) -> list:
        return [getattr(self, f"conv{i}") for i in range(self.num_layers)]

    def forward(self, x_dict: dict, layers: Sequence,
                generator: torch.Generator | None = None):
        if len(layers) != self.num_layers:
            raise ValueError(
                f"model has {self.num_layers} layers but got {len(layers)} "
                "hetero layers; sampler sizes and num_layers must match"
            )
        drop = self.training and self.dropout > 0
        if drop and generator is None:
            raise ValueError("training-mode dropout needs a generator")
        for i, (conv, layer) in enumerate(zip(self.convs, layers)):
            x_dict = conv(x_dict, layer)
            if i != self.num_layers - 1:
                x_dict = {t: torch.relu(v) for t, v in x_dict.items()}
                if drop:
                    x_dict = {t: dropout(v, self.dropout, generator)
                              for t, v in x_dict.items()}
        # log-softmax in f32: bf16 has too little mantissa for a stable NLL
        return torch.log_softmax(x_dict[self.target_type].to(torch.float32), dim=-1)
