"""Fixed-fanout neighbour sampling with padded shapes: uniform, weighted
and time-windowed hops.

The port of ``quiver_tpu/ops/sample.py``. Outputs are padded ``(S, k)``
blocks with ``-1`` sentinels, and every function takes optional leading
batch dimensions (the serving ladder samples all lanes of a batch in one
pass).

The draw is the same scheme as the JAX package: **stratified offsets plus
a uniform rotation**. ``[0, deg)`` is split into k integer strata, one
jittered point is drawn per stratum, and the set is rotated by
``r ~ U[0, deg)`` modulo deg, so the k offsets are distinct and every
neighbour is included with probability exactly ``k/deg``. Rows with
``deg <= k`` take all neighbours in CSR order.

Torch's Philox cannot reproduce JAX's threefry bits, so the random part
is a separate input: :func:`draw_bits` draws raw 62-bit integers from an
explicit ``torch.Generator`` and the offset functions reduce them modulo
each row's span (the bias is below span / 2^62). A uniform hop from those
bits (a generator, or the ``bits=`` seam) runs in one launch of kernel K1's
fused entry (``kernels.fused.uniform_hop``): degrees, offsets, rotation,
counts and select together. :func:`sample_layer` also takes the offsets
themselves (``offs``), which is how the tests feed it JAX's draws and hold
it bitwise against the JAX package; those, and temporal hops, run the
offset functions here and K1's select entry.

A **weighted** hop draws k independent slots per row (with replacement)
from the row's categorical distribution: each lane scales a uniform
``u01`` in ``[0, 1)`` by the row's total weight and binary-searches the
row-local inclusive prefix ``cum_weights`` (inverse CDF); rows with
``deg <= k`` take all neighbours in CSR order. Its draw is that f32
``u01`` block (:func:`draw_u01`), the same block JAX's ``weighted_offsets``
and its Pallas kernel consume. From a generator, a ``u01`` tensor or the
``bits=`` seam it runs in one launch of kernel K3's fused entry
(``kernels.fused.weighted_hop``); a ``u`` that is a callable of the
degrees (how the tests feed JAX's draws) runs :func:`seed_degrees` here
and K3's search-and-select entry.

A **temporal** hop samples uniformly among a row's edges whose timestamp
lies in ``[lo, hi]``: two binary searches over the time-sorted row give
the window's first slot and length, and the uniform draw runs over that
length (kernel K1 selects).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.fused import select, uniform_hop, weighted_hop, wselect
from .kernels.gather import gather_rows

__all__ = [
    "cdf_search",
    "draw_bits",
    "draw_u01",
    "hop_draws",
    "rotate_offsets",
    "sample_layer",
    "seed_degrees",
    "seeded_generator",
    "staged_gather",
    "stratified_offsets",
    "temporal_window_counts",
    "uniform_offsets",
    "weighted_offsets",
]

_BITS = 2**62


def seeded_generator(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by the integer tuple
    ``key`` (e.g. ``(seed, seq, layer)``), mixed through numpy's
    SeedSequence so that nearby keys give unrelated streams."""
    words = [int(k) & 0xFFFFFFFFFFFFFFFF for k in key]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) & 0x7FFFFFFFFFFFFFFF)
    return g


def draw_bits(shape, k: int, generator: torch.Generator):
    """Raw draws for :func:`uniform_offsets` over rows of ``shape``:
    ``(jitter (*shape, k), rotation (*shape, 1))`` int64 in ``[0, 2^62)``."""
    shape = tuple(shape)
    dev = generator.device
    jitter = torch.randint(0, _BITS, shape + (k,), generator=generator,
                           device=dev, dtype=torch.int64)
    rot = torch.randint(0, _BITS, shape + (1,), generator=generator,
                        device=dev, dtype=torch.int64)
    return jitter, rot


def stratified_offsets(deg, k: int, jitter):
    """k distinct offsets per row, one jittered pick per integer stratum.

    Stratum i covers ``[floor(deg*i/k), floor(deg*(i+1)/k))``; ``jitter``
    holds raw non-negative draws reduced modulo each stratum's span. Rows
    with ``deg <= k`` get ``0..deg-1``. Returns ``(offsets (..., k) int32,
    sel_mask (..., k))`` with lane i valid iff ``i < min(deg, k)``.
    """
    i = torch.arange(k, device=deg.device, dtype=torch.int64)
    degc = deg.to(torch.int64)[..., None]
    q, r = degc // k, degc % k
    lo = i * q + (i * r) // k
    hi = (i + 1) * q + ((i + 1) * r) // k
    span = (hi - lo).clamp(min=1)
    take_all = torch.minimum(i, (degc - 1).clamp(min=0))
    off = torch.where(degc <= k, take_all, lo + jitter % span)
    sel_mask = i < degc.clamp(max=k)
    return off.to(torch.int32), sel_mask


def rotate_offsets(offs, length, k: int, rot):
    """Rotate per-row offsets by ``rot mod length`` (``rot`` raw
    non-negative draws, ``(..., 1)``); take-all rows (``length <= k``)
    keep CSR order."""
    lenc = length.to(torch.int64)[..., None]
    shifted = offs.to(torch.int64) + rot % lenc.clamp(min=1)
    rotated = torch.where(shifted >= lenc, shifted - lenc, shifted)
    return torch.where(lenc <= k, offs.to(torch.int64), rotated).to(torch.int32)


def uniform_offsets(deg, k: int, generator: torch.Generator):
    """The port's own uniform draw: ``(..., k)`` int32 row-local offsets."""
    jitter, rot = draw_bits(deg.shape, k, generator)
    off, _ = stratified_offsets(deg, k, jitter)
    return rotate_offsets(off, deg, k, rot)


def draw_u01(shape, k: int, generator: torch.Generator):
    """The port's own weighted draw: ``(*shape, k)`` float32 in ``[0, 1)``."""
    return torch.rand(tuple(shape) + (k,), generator=generator,
                      device=generator.device, dtype=torch.float32)


def hop_draws(shape, k: int, generator: torch.Generator, *,
              weighted: bool = False):
    """The raw draws a fused hop over rows of ``shape`` consumes:
    :func:`draw_u01` for a weighted hop, else :func:`draw_bits`."""
    if weighted:
        return draw_u01(shape, k, generator)
    return draw_bits(shape, k, generator)


def cdf_search(cum_weights, u, base, deg, iters: int):
    """Per-lane inverse-CDF binary search: for each lane ``(..., s, j)`` the
    smallest slot ``m`` of row ``[base_s, base_s + deg_s)`` with
    ``cum_weights[m] >= u[..., s, j]``, as a row-local int32 offset.

    ``iters >= ceil(log2(max_degree + 1))`` guarantees convergence; every
    probe stays inside the row. Empty rows probe slot 0 and return 0, so
    ``cum_weights`` must not be empty.
    """
    degc = deg.to(torch.int64)[..., None]
    basec = base.to(torch.int64)[..., None]
    nonempty = degc > 0
    lo = basec.expand(u.shape)
    hi = lo + (degc - 1) * nonempty
    for _ in range(iters):
        mid = (lo + hi) // 2
        go_right = cum_weights[mid * nonempty] < u
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return (lo - basec).to(torch.int32)


def weighted_offsets(cum_weights, base, deg, k: int, iters: int, u01, *,
                     scale_u: bool = True):
    """k weight-proportional draws per row from the ``(..., S, k)`` f32
    block ``u01``: ``u = u01 * total`` (one f32 multiply; ``scale_u=False``
    takes ``u01`` as already scaled), then :func:`cdf_search`. Rows with
    ``deg <= k`` take ``0..deg-1``.

    Returns ``(offsets (..., S, k) int32 row-local, sel_mask)``: the plain
    form of the XLA oracle, and the arithmetic of K3's plain version.
    """
    degc = deg.to(torch.int64)[..., None]
    i = torch.arange(k, device=deg.device)
    sel_mask = i < degc.clamp(max=k)
    if cum_weights.numel() == 0:  # no edges: every row is empty
        return torch.zeros(u01.shape, dtype=torch.int32,
                           device=deg.device), sel_mask
    if scale_u:  # by the row total, the last prefix entry (1 on empty rows)
        end = torch.where(degc > 0, base.to(torch.int64)[..., None] + degc - 1, 0)
        u01 = u01 * torch.where(degc > 0, cum_weights[end], 1.0)
    off = cdf_search(cum_weights, u01, base, deg, iters).to(torch.int64)
    off = torch.where(degc <= k, torch.minimum(i, (degc - 1).clamp(min=0)), off)
    return off.to(torch.int32), sel_mask


def temporal_window_counts(edge_time, base, deg, lo_t, hi_t, iters: int):
    """Per-row slot range of the edges whose timestamp lies in
    ``[lo_t, hi_t]``, over rows sorted by time (``CSRTopo.set_edge_time``).

    Two binary searches over each row's ``deg + 1`` split points:
    ``first`` counts edges with ``t < lo_t`` and ``deg_t`` those with
    ``lo_t <= t <= hi_t``, so the window is row-local slots
    ``[first, first + deg_t)``. The bounds compare in float32, as the
    timestamps are stored. Returns ``(first, deg_t)``, both int32 shaped
    like ``deg``.
    """
    degc = deg.to(torch.int64)
    if edge_time.numel() == 0:
        zero = torch.zeros_like(deg, dtype=torch.int32)
        return zero, zero
    basec = base.to(torch.int64)
    probe_cap = (degc - 1).clamp(min=0)
    lo_t, hi_t = float(np.float32(lo_t)), float(np.float32(hi_t))

    def count(below):
        lo = torch.zeros_like(degc)
        hi = degc
        for _ in range(iters):
            active = lo < hi
            mid = (lo + hi) // 2
            # inactive and empty rows probe slot 0 and are masked out
            pos = torch.where(active, basec + torch.minimum(mid, probe_cap), 0)
            go = below(edge_time[pos]) & active
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go | ~active, hi, mid)
        return lo

    first = count(lambda t: t < lo_t)
    below_hi = count(lambda t: t <= hi_t)
    return first.to(torch.int32), (below_hi - first).to(torch.int32)


def seed_degrees(indptr, seeds, num_seeds):
    """``(valid, base, deg)`` of padded seeds ``(..., S)``: a seed is valid
    when its lane is below ``num_seeds`` (scalar or ``(...,)``) and it is
    not -1; ``base = indptr[seed]`` keeps indptr's width and ``deg`` is
    int32, 0 on invalid seeds."""
    S = seeds.shape[-1]
    num = torch.as_tensor(num_seeds, device=seeds.device)
    lane = torch.arange(S, device=seeds.device)
    valid = (lane < num[..., None]) & (seeds >= 0)
    s = torch.where(valid, seeds, 0).to(torch.int64)
    base = indptr[s]
    deg = (indptr[s + 1] - base).to(torch.int32)
    return valid, base, torch.where(valid, deg, 0)


def _raw_draws(bits, shape, k: int, generator, device, weighted: bool):
    """A hop's raw draws over rows of ``shape``, on ``device``: the ``bits``
    seam (the draws, or a callable of the shape), else :func:`hop_draws`
    from ``generator``. A weighted hop's are its ``(*shape, k)`` f32
    ``u01``; a uniform hop's the int64 ``(jitter, rot)`` pair."""
    if bits is None:
        if generator is None:
            raise ValueError("sample_layer needs a generator or u, or bits"
                             if weighted else
                             "sample_layer needs a generator, bits or offs")
        draws = hop_draws(shape, k, generator, weighted=weighted)
    else:
        draws = bits(tuple(shape)) if callable(bits) else bits
    if weighted:
        return draws.to(device=device, dtype=torch.float32).reshape(
            tuple(shape) + (k,)).contiguous()
    jitter, rot = draws
    return (jitter.to(device=device, dtype=torch.int64).contiguous(),
            rot.to(device=device, dtype=torch.int64).contiguous())


def sample_layer(topo, seeds, num_seeds, k: int, generator=None, *,
                 with_eid: bool = False, offs=None, weighted: bool = False,
                 time_window=None, u=None, bits=None, fused: bool = True):
    """Sample up to ``k`` neighbours for each valid seed.

    Args:
      topo: DeviceTopology.
      seeds: ``(..., S)`` int32 node ids, -1 padded; valid entries occupy
        a prefix of each row.
      num_seeds: count of valid seeds, scalar or one per leading index.
      k: fanout, ``1 <= k <= 46340``.
      generator: the ``torch.Generator`` of the port's own draw.
      with_eid: also return per-sample edge ids (COO positions when the
        topology carries ``eid``, CSR slots otherwise).
      offs: the uniform draw's injection seam. A ``(..., S, k)`` int32
        tensor of row-local offsets, or a callable ``deg -> offs`` that
        receives the ``(..., S)`` int32 degrees (0 on invalid seeds;
        in-window degrees on a temporal hop); replaces the generator draw.
      weighted: draw in proportion to the edge weights (needs a topology
        placed ``with_weights=True``).
      time_window: ``(lo, hi)``: draw uniformly among the edges with
        ``lo <= t <= hi`` (needs ``with_times=True``); excludes
        ``weighted``.
      u: the weighted draw's injection seam. A ``(..., S, k)`` float32
        block of uniforms in ``[0, 1)``, or a callable ``deg -> u``
        (needs ``weighted``).
      bits: the raw-draw seam of the fused hops: the draws of
        :func:`hop_draws` (a uniform hop's ``(jitter (..., S, k), rot
        (..., S, 1))`` int64 pair, a weighted hop's ``(..., S, k)`` f32
        ``u01``), or a callable of the hop's row shape ``(..., S)`` that
        returns them; replaces the generator's draw. At most one of
        ``offs``, ``u`` and ``bits`` is given.
      fused: run a hop from a generator, raw bits or a ``u`` tensor in one
        launch of its fused entry (the sampler's ``kernel="pallas"``);
        False runs the composed path on the same draws instead (the
        offsets or ``u`` here, then K1's select or K3's search-and-select:
        the sampler's ``kernel="xla"``), with bitwise the same result.

    Returns ``(neighbors (..., S, k) int32, counts (..., S) int32[, eids])``
    with -1 on invalid lanes. For CUDA tensors a hop from a generator, raw
    bits or a ``u`` tensor runs in one launch of a fused entry (K1's
    :func:`uniform_hop`, K3's :func:`weighted_hop`); given ``offs``, or a
    ``u`` callable, or on a temporal hop, the degrees (and offsets) are
    computed here and K1's select entry or K3's search-and-select runs.
    """
    if k < 1:
        raise ValueError(f"fanout k must be >= 1, got {k}")
    if k > 46340:
        # the int32 stratum arithmetic of the JAX package needs k^2 < 2^31
        raise ValueError(f"fanout k must be <= 46340, got {k}")
    if weighted and time_window is not None:
        raise ValueError(
            "time_window cannot be combined with weighted=True; pick one "
            "biased draw per sampler"
        )
    if weighted and topo.cum_weights is None:
        raise ValueError(
            "weighted sampling needs topo.cum_weights; build the "
            "DeviceTopology with to_device(with_weights=True)"
        )
    if time_window is not None and topo.edge_time is None:
        raise ValueError(
            "temporal sampling needs topo.edge_time; build the "
            "DeviceTopology with to_device(with_times=True)"
        )
    if sum(x is not None for x in (offs, u, bits)) > 1:
        raise ValueError("the draw seams exclude each other: give at most "
                         "one of offs, u and bits")
    if u is not None and not weighted:
        raise ValueError("u is the weighted draw's seam; it needs weighted=True")
    if offs is not None and weighted:
        raise ValueError("offs is the uniform draw's seam; it excludes "
                         "weighted=True")
    if weighted and not callable(u):  # a u tensor is the draws themselves
        u01 = _raw_draws(bits if u is None else u, seeds.shape, k, generator,
                         seeds.device, True)
        if fused:
            return weighted_hop(topo.indptr, topo.indices, topo.cum_weights,
                                seeds, num_seeds, u01, topo.search_iters,
                                eid=topo.eid, with_eid=with_eid)
        u = lambda _deg: u01  # noqa: E731 — the composed path below
    if fused and not weighted and time_window is None and offs is None:
        jitter, rot = _raw_draws(bits, seeds.shape, k, generator, seeds.device,
                                 False)
        return uniform_hop(topo.indptr, topo.indices, seeds, num_seeds,
                           jitter, rot, eid=topo.eid, with_eid=with_eid)
    valid, base, deg = seed_degrees(topo.indptr, seeds, num_seeds)
    lead = deg.shape
    start = base.to(torch.int64)
    if time_window is not None:
        first, deg = temporal_window_counts(
            topo.edge_time, base, deg, time_window[0], time_window[1],
            topo.search_iters)
        deg = torch.where(valid, deg, 0)
        # the window's slots start at `first`: rebase the row start
        start = start + first.to(torch.int64)
    counts = deg.clamp(max=k)  # deg is 0 on invalid seeds
    eid_tab = topo.eid if with_eid else None
    if weighted:  # a callable u of the degrees
        u = u(deg).to(device=deg.device, dtype=torch.float32).reshape(-1, k)
        outs = wselect(topo.indices, topo.cum_weights, start.reshape(-1),
                       deg.reshape(-1).contiguous(), u.contiguous(),
                       topo.search_iters, eid=eid_tab)
        row_off = outs[1]
        eid_out = outs[2] if eid_tab is not None else None
    else:
        if offs is None:  # the draw runs over deg (a temporal hop's window)
            jitter, rot = _raw_draws(bits, lead, k, generator, deg.device, False)
            off, _ = stratified_offsets(deg, k, jitter)
            offs = rotate_offsets(off, deg, k, rot)
        elif callable(offs):
            offs = offs(deg)
        row_off = offs.to(device=deg.device, dtype=torch.int32).reshape(-1, k)
        tables = (topo.indices,) if eid_tab is None else (topo.indices, eid_tab)
        outs = select(tables, start.reshape(-1), row_off.contiguous(),
                      counts.reshape(-1).contiguous())
        eid_out = outs[1] if eid_tab is not None else None
    nbr = outs[0].reshape(*lead, k)
    if not with_eid:
        return nbr, counts
    if eid_out is not None:
        eids = eid_out.reshape(*lead, k)
    else:  # CSR slots, in indptr's width
        epos = start[..., None] + row_off.reshape(*lead, k).to(torch.int64)
        eids = torch.where(nbr >= 0, epos, -1).to(base.dtype)
    return nbr, counts, eids


def staged_gather(table, idx):
    """``table[idx]`` for a 1-D table. A pinned host table is read directly
    over UVA by kernel K2 when ``idx`` is on the card (the reference's
    zero-copy read, which the TPU had to stage through host compute)."""
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    return gather_rows(table.reshape(-1, 1), flat).reshape(idx.shape)
