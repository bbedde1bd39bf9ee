"""Full-neighbour layer-wise inference over the whole graph.

The port of ``quiver_tpu/models/inference.py`` (GraphSAGE, GCN, GIN, GAT,
and R-GCN over a typed graph): the reference's ``model.inference``
evaluation walks one layer at a time over every node with all of its
edges (torch-quiver examples/pyg/reddit_quiver.py:68-92). Mean aggregation
over every node is ``D^-1 A X``, a whole-graph segment mean over the CSR
rows, then the trained layer's weights. GCN and GIN reuse it (a sum is
the mean times the degree); GAT runs two chunked passes per layer, the
per-destination logit max and then the softmax's numerator and
denominator together.

One aggregation strategy: each row's edges summed in CSR order. On the
card the mean is one launch per layer of the hand-written kernel
``ops.kernels.segment.segment_mean``: each source row is read once into
registers, added in edge order from zero, divided by the degree, and each
output row written once; it reads the edge array on the card (HBM) or in
pinned host memory over UVA (HOST), with no chunks. On the CPU it is
:func:`~..ops.kernels.segment.segment_mean_plain`: the edge array walked
in chunks of ``chunk`` edges, each chunk's source rows gathered and added
with ``index_add_``, one index after another (the CPU's ``index_put_``
adds large float chunks with parallel atomics). Both add a row's edges
one after another in CSR order, so a result is the same from run to run
and from HBM and HOST placements, and the card's float32 rows are the
CPU's bit for bit, and the chunked, sorted ``index_put_(accumulate=True)``
accumulate's that the card ran before the kernel (at more than 32 floats
a row; at fewer ATen sums a chunk's run of a row apart). ``chunk`` sizes
the CPU's chunks and GAT's passes, which keep the sorted accumulate per
chunk.

The JAX package also has a cumsum-difference ("scan") strategy, because
XLA serialises scatters on the TPU, picked by
``QUIVER_INFER_AGG=scatter|scan``. ``full_neighbor_mean`` and the SAGE,
GCN, GIN and R-GCN passes read that variable once per call, before
anything is placed, so a value outside those two raises ``ValueError``
as it does in the JAX package; both names run the segment mean above. A
scan would round differently from it without being the JAX scan's bits
either (the tests hold the mean against both JAX strategies), and on an
H100 it ran at 0.52-0.72x the chunked accumulate's nodes per second at
every shape measured (``PERF.md``). GAT's passes do not
read the variable, in either package.

Every pass records its spans through :func:`~..obs.tracing.span` (free
when tracing is off): ``infer.pass`` (``layers``) over ``infer.place``
(the copies of the CSR and the features to the card; ``h2d_bytes``, what
they carried from the host), and per conv an ``infer.layer`` over its
``infer.aggregate`` (the segment mean) and ``infer.combine`` (the linear
maps, their sum and the activation) spans. The place, aggregate and
combine spans time the card's stream too (``device_ms``); none
synchronises.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from ..core.config import SampleMode, resolve_platform_strategy
from ..core.memory import resolve_device, to_pinned_host
from ..obs import tracing
from ..ops.kernels.segment import segment_mean
from ..ops.sample import staged_gather

__all__ = ["full_neighbor_mean", "gat_layerwise_inference",
           "gcn_layerwise_inference", "gin_layerwise_inference",
           "rgcn_layerwise_inference", "sage_layerwise_inference"]


def _host_csr(topo, mode, device):
    """``(indptr, indices, host)`` on the host, ready to cross to
    ``device``: ``indptr`` widened to int64 there; HOST keeps the edge
    array in pinned host memory (``host`` is True on a CUDA device), read
    over UVA by the card's kernels, where HBM copies it to the device
    too."""
    mode = SampleMode.parse(mode)
    indptr = torch.from_numpy(topo.indptr).to(torch.int64)
    if mode is SampleMode.HOST:
        return (indptr, *to_pinned_host(topo.indices, device))
    return indptr, torch.from_numpy(topo.indices), False


def _to_device(t: torch.Tensor, device, span) -> torch.Tensor:
    """``t`` on ``device``; ``span``'s ``h2d_bytes`` gains the bytes that
    crossed from the host to a card."""
    out = t.to(device)
    if t.device.type == "cpu" and out.is_cuda:
        span.set("h2d_bytes", span.attrs.get("h2d_bytes", 0) + t.nbytes)
    return out


def _csr_to_device(csr, device, span):
    """A :func:`_host_csr` triple on ``device``; HOST mode's pinned edge
    array stays where it is."""
    indptr, indices, host = csr
    return (_to_device(indptr, device, span),
            indices if host else _to_device(indices, device, span), host)


def _place(topo, x_all, mode, device):
    """``(indptr, indices, host, x)``: the CSR and the features on
    ``device``. Their copies alone fill the ``infer.place`` span, so its
    device time is theirs: the host's preparation goes first."""
    csr, x = _host_csr(topo, mode, device), torch.as_tensor(x_all)
    with tracing.span("infer.place", device=device, h2d_bytes=0) as sp:
        indptr, indices, host = _csr_to_device(csr, device, sp)
        x = _to_device(x, device, sp)
    return indptr, indices, host, x


def _edge_chunks(indptr, indices, chunk: int, host: bool):
    """``(src, dst)`` int64 ids of each chunk of ``chunk`` edges in CSR
    order; ``dst`` comes from a binary search of the edge positions in
    ``indptr``, so it is sorted within the chunk."""
    E = indices.shape[0]
    dev = indptr.device
    for e0 in range(0, E, chunk):
        epos = torch.arange(e0, min(e0 + chunk, E), device=dev)
        if host:
            src = staged_gather(indices, epos, host)
        else:
            src = indices[e0:e0 + epos.shape[0]]
        dst = torch.searchsorted(indptr, epos, right=True) - 1
        yield src.to(torch.int64), dst


def _accumulate(acc, dst, values) -> None:
    """``acc[dst] += values`` with repeated ``dst``, in the same order on
    every run (see the module docstring)."""
    if acc.is_cuda:
        acc.index_put_((dst,), values, accumulate=True)
    else:
        acc.index_add_(0, dst, values)


def _read_infer_agg() -> str:
    """``QUIVER_INFER_AGG``, read on every entry call as the JAX package
    reads it; a value outside ``scan`` and ``scatter`` raises. Either
    name runs the accumulate (module docstring)."""
    return resolve_platform_strategy("QUIVER_INFER_AGG", ("scan", "scatter"),
                                     "scatter", "scatter")


def _neighbor_mean_dev(indptr, indices, x_all, chunk: int, host: bool = False):
    """:func:`full_neighbor_mean` on placed CSR tensors (``indptr`` int64),
    in one ``infer.aggregate`` span: one ``segment_mean`` launch on the
    card, which reads ``indices`` where it lies (so ``host``, HOST mode's
    flag, changes nothing and ``chunk`` is unused); ``chunk``-edge chunks
    on the CPU (module docstring).

    The output has ``indptr``'s row count; zero-degree rows are zeros."""
    with tracing.span("infer.aggregate", device=x_all.device):
        return segment_mean(indptr, indices, x_all, chunk)


def _float32_convs(model) -> list:
    """``model``'s layers computing in float32 (as the JAX package's fresh
    layers compute layer-wise inference), whatever their compute dtype:
    shallow copies sharing the parameters, so the model itself, which
    another thread may be running, is left as it is."""
    convs = [copy.copy(conv) for conv in model.convs]
    for conv in convs:
        conv.dtype = None
    return convs


def full_neighbor_mean(topo, x_all, chunk: int = 1 << 21,
                       mode: str | SampleMode = SampleMode.HBM, device=None):
    """Mean of all neighbours' features for every node: ``(N, F) -> (N,
    F)``, over a host :class:`~..core.topology.CSRTopo`.

    ``mode="HBM"`` places the edge array on the device; ``mode="HOST"``
    keeps it pinned on the host, where the card's kernel reads the ids over
    UVA (graphs beyond device memory stay evaluable). ``chunk``: edges per
    accumulate on the CPU; the card's mean has no chunks. ``device`` as
    every entry point's (CUDA unless named). ``QUIVER_INFER_AGG`` is read
    and checked (module docstring)."""
    _read_infer_agg()
    device = resolve_device(device)
    indptr, indices, host, x = _place(topo, x_all, mode, device)
    return _neighbor_mean_dev(indptr, indices, x, chunk, host)


def sage_layerwise_inference(model, topo, x_all, chunk: int = 1 << 21,
                             mode: str | SampleMode = SampleMode.HBM,
                             device=None):
    """Layer-wise full-neighbour GraphSAGE inference: ``(N, num_classes)``
    float32 log-probs for every node, using all edges at every layer.

    ``model`` is the trained :class:`~.sage.GraphSAGE` (on ``device``);
    each layer is ``lin_l(mean of neighbours) + lin_r(x)`` in float32 (as
    the JAX package's fresh ``SAGEConv`` computes it), ReLU between
    layers, no dropout. ``chunk``, ``mode`` and ``QUIVER_INFER_AGG`` as
    :func:`full_neighbor_mean` (one ``segment_mean`` launch a layer on the
    card). The other families' passes compute in float32 too.
    """
    _read_infer_agg()
    device = resolve_device(device)
    with tracing.span("infer.pass", new_trace=True, layers=len(model.convs)), torch.no_grad():
        # place the (possibly multi-GB) CSR arrays once, not once per layer
        indptr, indices, host, x = _place(topo, x_all, mode, device)
        for i, conv in enumerate(model.convs):
            with tracing.span("infer.layer"):
                agg = _neighbor_mean_dev(indptr, indices, x, chunk, host)
                with tracing.span("infer.combine", device=device):
                    lin_l, lin_r = conv.lin_l, conv.lin_r
                    x = (F.linear(agg.float(), lin_l.weight, lin_l.bias)
                         + F.linear(x.float(), lin_r.weight))
                    if i != len(model.convs) - 1:
                        x = torch.relu(x)
        return torch.log_softmax(x, dim=-1)


def gcn_layerwise_inference(model, topo, x_all, chunk: int = 1 << 21,
                            mode: str | SampleMode = SampleMode.HBM,
                            device=None):
    """Layer-wise full-neighbour GCN inference: ``D^-1/2 (A + I) D^-1/2
    X`` per layer with global degrees, what ``GCNConv`` computes on a
    block that covers the whole graph (on the usual symmetric topology,
    whose CSR row degree is both sides' degree). The neighbour sum is the
    segment mean times the degree, over features pre-scaled by
    ``rsqrt(deg + 1)``; ReLU between layers. ``(N, num_classes)`` float32
    log-probs; ``chunk``, ``mode`` and ``device`` as
    :func:`sage_layerwise_inference`."""
    _read_infer_agg()
    device = resolve_device(device)
    convs = _float32_convs(model)
    with tracing.span("infer.pass", new_trace=True, layers=len(convs)), torch.no_grad():
        indptr, indices, host, x = _place(topo, x_all, mode, device)
        deg = (indptr[1:] - indptr[:-1]).to(x.dtype)
        inv_s = torch.rsqrt(deg + 1.0)  # self-loop-augmented degrees
        for i, conv in enumerate(convs):
            with tracing.span("infer.layer"):
                h = x * inv_s[:, None]
                agg = _neighbor_mean_dev(indptr, indices, h, chunk, host)
                with tracing.span("infer.combine", device=device):
                    x = conv.combine((agg * deg[:, None] + h) * inv_s[:, None])
                    if i != len(convs) - 1:
                        x = torch.relu(x)
        return torch.log_softmax(x.float(), dim=-1)


def gin_layerwise_inference(model, topo, x_all, chunk: int = 1 << 21,
                            mode: str | SampleMode = SampleMode.HBM,
                            device=None):
    """Layer-wise full-neighbour GIN inference: ``MLP((1 + eps) x + A x)``
    per layer, what ``GINConv`` computes on a block that covers the whole
    graph (the neighbour sum is the segment mean times the degree); ReLU
    between layers. Arguments and result as
    :func:`sage_layerwise_inference`."""
    _read_infer_agg()
    device = resolve_device(device)
    convs = _float32_convs(model)
    with tracing.span("infer.pass", new_trace=True, layers=len(convs)), torch.no_grad():
        indptr, indices, host, x = _place(topo, x_all, mode, device)
        deg = (indptr[1:] - indptr[:-1]).to(x.dtype)
        for i, conv in enumerate(convs):
            with tracing.span("infer.layer"):
                agg = _neighbor_mean_dev(indptr, indices, x, chunk, host)
                with tracing.span("infer.combine", device=device):
                    x = conv.combine(agg * deg[:, None] + (1.0 + conv.eps) * x)
                    if i != len(convs) - 1:
                        x = torch.relu(x)
        return torch.log_softmax(x.float(), dim=-1)


def gat_layerwise_inference(model, topo, x_all, chunk: int = 1 << 20,
                            mode: str | SampleMode = SampleMode.HBM,
                            device=None):
    """Layer-wise full-neighbour GAT inference: attention over all edges.

    Per layer, two chunked edge passes give an exact whole-graph segment
    softmax: (1) each destination's largest logit (a ``scatter_reduce``
    max), (2) the shifted exponentials' sum and the weighted messages'
    sum together (one sorted accumulate each per chunk); then the layer's
    ``finish`` (heads concatenated or averaged, plus the bias), ELU
    between layers. A node with no in-edges gets its bias only, as the
    sampled model gives it. The default ``chunk`` is half the other
    families' (a chunk's messages are ``(chunk, H, F)``). Arguments and
    result as :func:`sage_layerwise_inference`; ``QUIVER_INFER_AGG`` is
    not read, as in the JAX package. A layer's spans are an
    ``infer.combine`` for the projection, one ``infer.aggregate`` over
    both edge passes and the normalisation, and an ``infer.combine`` for
    ``finish``."""
    device = resolve_device(device)
    convs = _float32_convs(model)
    with tracing.span("infer.pass", new_trace=True, layers=len(convs)), torch.no_grad():
        indptr, indices, host, x = _place(topo, x_all, mode, device)
        n = indptr.shape[0] - 1
        for i, conv in enumerate(convs):
            with tracing.span("infer.layer"):
                with tracing.span("infer.combine", device=device):
                    h_all, a_s, a_d = conv.project(x)
                with tracing.span("infer.aggregate", device=device):
                    out = _gat_attend(indptr, indices, h_all, a_s, a_d,
                                      conv.negative_slope, n, chunk, host)
                with tracing.span("infer.combine", device=device):
                    x = conv.finish(out)
                    if i != len(convs) - 1:
                        x = F.elu(x)
        return torch.log_softmax(x.float(), dim=-1)


def _gat_attend(indptr, indices, h_all, a_s, a_d, slope, n: int, chunk: int,
                host: bool):
    """One GAT layer's attention-weighted neighbour mean over every edge:
    the segment max pass, then the numerator and denominator pass."""
    H, device = h_all.shape[1], h_all.device
    seg_max = torch.full((n, H), -torch.inf, dtype=h_all.dtype, device=device)
    for src, dst in _edge_chunks(indptr, indices, chunk, host):
        logit = F.leaky_relu(a_s[src] + a_d[dst], slope)
        seg_max.scatter_reduce_(0, dst[:, None].expand_as(logit), logit, "amax")
    # destinations with no in-edges: a finite shift (their sums stay 0)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    num = torch.zeros_like(h_all)
    denom = torch.zeros((n, H), dtype=h_all.dtype, device=device)
    for src, dst in _edge_chunks(indptr, indices, chunk, host):
        w = torch.exp(F.leaky_relu(a_s[src] + a_d[dst], slope) - seg_max[dst])
        _accumulate(num, dst, w[:, :, None] * h_all[src])
        _accumulate(denom, dst, w)
    return num / denom.clamp(min=torch.finfo(h_all.dtype).tiny)[:, :, None]


def rgcn_layerwise_inference(model, topo, x_dict, chunk: int = 1 << 20,
                             mode: str | SampleMode = SampleMode.HBM,
                             device=None):
    """Layer-wise full-neighbour R-GCN inference over a typed graph.

    Per layer: each node type's self transform, plus, per relation in
    ``sorted(..., key=str)`` order, the whole-relation segment mean of the
    relation-projected source rows, walked over the relation's own CSR
    (rows are its destination nodes), all in float32. What each layer
    computes is read from the model's modules, as the JAX package reads
    it from the parameter tree: a type with no ``self_{t}`` transform in a
    layer is skipped there, and so is a relation with no weight. A
    layer's spans are one ``infer.aggregate`` per relation, between
    ``infer.combine`` spans for the self transforms, each relation's
    projection and the sums with their activation.

    Args:
      model: the trained :class:`~.rgcn.RGCN` (on ``device``).
      topo: the :class:`~..core.hetero.HeteroCSRTopo`.
      x_dict: ``{node_type: (N_t, F_t)}`` full feature tables.
      chunk, mode, device: as :func:`sage_layerwise_inference`.

    Returns ``(N_target, num_classes)`` float32 log-probs for every node of
    ``model.target_type``.
    """
    _read_infer_agg()
    device = resolve_device(device)
    with tracing.span("infer.pass", new_trace=True, layers=model.num_layers), \
            torch.no_grad():
        x_dict = {t: torch.as_tensor(v) for t, v in x_dict.items()}
        csrs = {et: _host_csr(rel, mode, device) for et, rel in topo.relations.items()}
        with tracing.span("infer.place", device=device, h2d_bytes=0) as sp:
            x_dict = {t: _to_device(v, device, sp) for t, v in x_dict.items()}
            placed = {et: _csr_to_device(csr, device, sp) for et, csr in csrs.items()}
        for i, conv in enumerate(model.convs):
            with tracing.span("infer.layer"):
                with tracing.span("infer.combine", device=device):
                    out = {}
                    for t, x in x_dict.items():
                        lin = conv.self_linear(t)
                        if lin is not None:
                            out[t] = F.linear(x.float(), lin.weight, lin.bias)
                for et in sorted(topo.relations, key=str):
                    s_t, _, d_t = et
                    if d_t not in out or s_t not in x_dict:
                        continue
                    w = conv.relation_weight(et)
                    if w is None:
                        continue
                    indptr, indices, host = placed[et]
                    with tracing.span("infer.combine", device=device):
                        h = x_dict[s_t].float() @ w
                    agg = _neighbor_mean_dev(indptr, indices, h, chunk, host)
                    with tracing.span("infer.combine", device=device):
                        out[d_t] = out[d_t] + agg
                if i != model.num_layers - 1:
                    with tracing.span("infer.combine", device=device):
                        out = {t: torch.relu(v) for t, v in out.items()}
                x_dict = out
        return torch.log_softmax(x_dict[model.target_type], dim=-1)
