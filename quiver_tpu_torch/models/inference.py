"""Full-neighbour layer-wise GraphSAGE inference over the whole graph.

The port of the SAGE part of ``quiver_tpu/models/inference.py``: the
reference's ``model.inference`` evaluation walks one layer at a time over
every node with all of its edges (torch-quiver
examples/pyg/reddit_quiver.py:68-92). Mean aggregation over every node is
``D^-1 A X``, computed as chunked whole-graph segment sums: walk the CSR
edge array in fixed-size chunks, gather the source rows, accumulate them
into an ``(N, F)`` buffer, divide by the degree, then apply the trained
layer's weights.

One aggregation strategy: a sorted accumulate per chunk. The JAX package
also has a cumsum-difference ("scan") strategy because XLA serialises
scatters on the TPU; the tests hold this one against both. The chunk's
destinations are sorted (CSR order), and the accumulate is
``index_put_(accumulate=True)``, which on the card sums each row's
messages in edge order after a stable sort rather than with atomics, so a
result is the same from run to run and from HBM and HOST placements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import SampleMode
from ..core.memory import resolve_device, to_pinned_host
from ..ops.sample import staged_gather

__all__ = ["full_neighbor_mean", "sage_layerwise_inference"]


def _place(topo, mode, device):
    """``(indptr, indices, host)`` on ``device``: HBM puts both on the
    device; HOST keeps the edge array in pinned host memory (``host`` is
    True on a CUDA device), read over UVA by kernel K2."""
    mode = SampleMode.parse(mode)
    indptr = torch.from_numpy(topo.indptr).to(device, torch.int64)
    if mode is SampleMode.HOST:
        indices, host = to_pinned_host(topo.indices, device)
        return indptr, indices, host
    return indptr, torch.from_numpy(topo.indices).to(device), False


def _neighbor_mean_dev(indptr, indices, x_all, chunk: int, host: bool = False):
    """:func:`full_neighbor_mean` on placed CSR tensors (``indptr`` int64).

    The output has ``indptr``'s row count; zero-degree rows are zeros."""
    n_out, f = indptr.shape[0] - 1, x_all.shape[1]
    E = indices.shape[0]
    dev = x_all.device
    acc = torch.zeros(n_out, f, dtype=x_all.dtype, device=dev)
    for e0 in range(0, E, chunk):
        epos = torch.arange(e0, min(e0 + chunk, E), device=dev)
        if host:
            src = staged_gather(indices, epos)
        else:
            src = indices[e0:e0 + epos.shape[0]]
        dst = torch.searchsorted(indptr, epos, right=True) - 1
        acc.index_put_((dst,), x_all[src.to(torch.int64)], accumulate=True)
    deg = (indptr[1:] - indptr[:-1]).clamp(min=1).to(x_all.dtype)
    return acc / deg[:, None]


def full_neighbor_mean(topo, x_all, chunk: int = 1 << 21,
                       mode: str | SampleMode = SampleMode.HBM, device=None):
    """Mean of all neighbours' features for every node: ``(N, F) -> (N,
    F)``, over a host :class:`~..core.topology.CSRTopo`.

    ``mode="HBM"`` places the edge array on the device; ``mode="HOST"``
    keeps it pinned on the host and reads each chunk's ids over UVA
    (graphs beyond device memory stay evaluable). ``device`` as every
    entry point's (CUDA unless named)."""
    device = resolve_device(device)
    indptr, indices, host = _place(topo, mode, device)
    return _neighbor_mean_dev(indptr, indices, torch.as_tensor(x_all).to(device),
                              chunk, host)


def sage_layerwise_inference(model, topo, x_all, chunk: int = 1 << 21,
                             mode: str | SampleMode = SampleMode.HBM,
                             device=None):
    """Layer-wise full-neighbour GraphSAGE inference: ``(N, num_classes)``
    float32 log-probs for every node, using all edges at every layer.

    ``model`` is the trained :class:`~.sage.GraphSAGE` (on ``device``);
    each layer is ``lin_l(mean of neighbours) + lin_r(x)`` in float32 (as
    the JAX package's fresh ``SAGEConv`` computes it), ReLU between
    layers, no dropout. ``chunk`` edges per accumulate; ``mode`` as
    :func:`full_neighbor_mean`.
    """
    device = resolve_device(device)
    # place the (possibly multi-GB) CSR arrays once, not once per layer
    indptr, indices, host = _place(topo, mode, device)
    x = torch.as_tensor(x_all).to(device)
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            agg = _neighbor_mean_dev(indptr, indices, x, chunk, host)
            lin_l, lin_r = conv.lin_l, conv.lin_r
            x = (F.linear(agg.float(), lin_l.weight, lin_l.bias)
                 + F.linear(x.float(), lin_r.weight))
            if i != len(model.convs) - 1:
                x = torch.relu(x)
        return torch.log_softmax(x, dim=-1)
