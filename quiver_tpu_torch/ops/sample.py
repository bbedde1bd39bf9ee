"""Fixed-fanout uniform neighbour sampling with padded shapes.

The port of ``quiver_tpu/ops/sample.py`` (uniform draws). Outputs are
padded ``(S, k)`` blocks with ``-1`` sentinels, and every function takes
optional leading batch dimensions (the serving ladder samples all lanes
of a batch in one pass).

The draw is the same scheme as the JAX package: **stratified offsets plus
a uniform rotation**. ``[0, deg)`` is split into k integer strata, one
jittered point is drawn per stratum, and the set is rotated by
``r ~ U[0, deg)`` modulo deg, so the k offsets are distinct and every
neighbour is included with probability exactly ``k/deg``. Rows with
``deg <= k`` take all neighbours in CSR order.

Torch's Philox cannot reproduce JAX's threefry bits, so the random part
is a separate input: :func:`draw_bits` draws raw 62-bit integers from an
explicit ``torch.Generator`` and the offset functions reduce them modulo
each row's span (the bias is below span / 2^62). :func:`sample_layer`
also takes the offsets themselves (``offs``), which is how the tests feed
it JAX's draws and hold it bitwise against the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.fused import select
from .kernels.gather import gather_rows

__all__ = [
    "draw_bits",
    "rotate_offsets",
    "sample_layer",
    "seed_degrees",
    "seeded_generator",
    "staged_gather",
    "stratified_offsets",
    "uniform_offsets",
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
    sel_mask = i < torch.minimum(degc, torch.tensor(k, device=deg.device))
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


def seed_degrees(topo, seeds, num_seeds):
    """``(valid, base, deg)`` of padded seeds ``(..., S)``: a seed is valid
    when its lane is below ``num_seeds`` (scalar or ``(...,)``) and it is
    not -1; ``base = indptr[seed]`` keeps indptr's width and ``deg`` is
    int32, 0 on invalid seeds."""
    S = seeds.shape[-1]
    num = torch.as_tensor(num_seeds, device=seeds.device)
    lane = torch.arange(S, device=seeds.device)
    valid = (lane < num[..., None]) & (seeds >= 0)
    s = torch.where(valid, seeds, 0).to(torch.int64)
    base = topo.indptr[s]
    deg = (topo.indptr[s + 1] - base).to(torch.int32)
    return valid, base, torch.where(valid, deg, 0)


def sample_layer(topo, seeds, num_seeds, k: int, generator=None, *,
                 with_eid: bool = False, offs=None):
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
      offs: the draw-injection seam. A ``(..., S, k)`` int32 tensor of
        row-local offsets, or a callable ``deg -> offs`` that receives the
        ``(..., S)`` int32 degrees (0 on invalid seeds); replaces the
        generator draw.

    Returns ``(neighbors (..., S, k) int32, counts (..., S) int32[, eids])``
    with -1 on invalid lanes. The select runs on kernel K1 for CUDA
    tensors.
    """
    if k < 1:
        raise ValueError(f"fanout k must be >= 1, got {k}")
    if k > 46340:
        # the int32 stratum arithmetic of the JAX package needs k^2 < 2^31
        raise ValueError(f"fanout k must be <= 46340, got {k}")
    valid, base, deg = seed_degrees(topo, seeds, num_seeds)
    if offs is None:
        if generator is None:
            raise ValueError("sample_layer needs a generator or offs")
        offs = uniform_offsets(deg, k, generator)
    elif callable(offs):
        offs = offs(deg)
    lead = deg.shape
    offs = offs.to(device=deg.device, dtype=torch.int32).reshape(-1, k)
    counts = torch.where(valid, deg.clamp(max=k), 0)
    tables = (topo.indices,)
    if with_eid and topo.eid is not None:
        tables += (topo.eid,)
    outs = select(tables, base.reshape(-1).to(torch.int64), offs.contiguous(),
                  counts.reshape(-1).contiguous())
    nbr = outs[0].reshape(*lead, k)
    if not with_eid:
        return nbr, counts
    if topo.eid is not None:
        eids = outs[1].reshape(*lead, k)
    else:
        mask = nbr >= 0
        epos = base[..., None] + offs.reshape(*lead, k).to(base.dtype)
        eids = torch.where(mask, epos, -1)
    return nbr, counts, eids


def staged_gather(table, idx):
    """``table[idx]`` for a 1-D table. A pinned host table is read directly
    over UVA by kernel K2 when ``idx`` is on the card (the reference's
    zero-copy read, which the TPU had to stage through host compute)."""
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    return gather_rows(table.reshape(-1, 1), flat).reshape(idx.shape)
