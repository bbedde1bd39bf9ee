"""Per-bucket micro-batch programs for online point queries.

The port of ``quiver_tpu/serving/ladder.py``. For each power-of-two bucket
size ``B`` the ladder runs two fixed-shape steps:

* **sample**: the ``B`` lanes are sampled together, one K1 launch per hop
  for all lanes, but every lane is its own single-seed sample with its own
  frontier caps (planned for ONE seed) and its own draws, from generators
  seeded by ``(seed, seq, layer)``. Lanes share no state, so a request's
  neighbourhood is a function of ``(node, seq)`` alone, whatever the
  bucket, the padding or the co-batched requests: the ladder's ids and
  edges equal the direct single-query oracle bitwise.
* **forward**: the model over the ``(B, cap, F)`` block of gathered rows,
  all lanes in one batched pass.

The feature gather sits between the two steps, in the server. PyTorch runs
eagerly, so there is nothing to compile: ``warmup`` runs every bucket once
to build the kernels and initialise the libraries before traffic arrives.
"""

from __future__ import annotations

import torch

from ..ops.sample import (draw_bits, rotate_offsets, seeded_generator,
                          stratified_offsets)
from ..sampling.sampler import Adj, GraphSageSampler, multilayer_sample

__all__ = ["ServeLadder"]


class ServeLadder:
    """Per-bucket (sample, forward) steps over one sampler and model.

    Args:
      sampler: the :class:`GraphSageSampler` whose placed topology and
        fanouts the ladder serves.
      model: the module; ``model(x, adjs)`` returns per-node log-probs.
      feature_dim: row width of the feature store.
      row_dtype: dtype of the gathered rows.
      lane_caps: per-layer frontier caps for ONE seed; defaults to the
        sampler's worst-case single-seed plan.
      seed: base seed of the lanes' generators.
      draw_fn: optional ``draw_fn(seq, layer, deg) -> offs`` replacing a
        lane's generator draws (the parity tests feed it JAX's).
    """

    def __init__(self, sampler: GraphSageSampler, model, feature_dim: int,
                 row_dtype=torch.float32, lane_caps=None, seed: int = 0,
                 draw_fn=None):
        self.sampler = sampler
        self.model = model
        self.feature_dim = int(feature_dim)
        self.row_dtype = row_dtype
        caps = tuple(lane_caps) if lane_caps is not None else (
            sampler._worst_caps(1))
        if len(caps) != len(sampler.sizes):
            raise ValueError(
                f"lane_caps needs one entry per layer ({len(sampler.sizes)}), "
                f"got {caps}"
            )
        self.lane_caps = tuple(int(c) for c in caps)
        self.sizes = tuple(sampler.sizes)
        self.seed = int(seed)
        self.draw_fn = draw_fn
        self.device = sampler.device
        # static Adj metadata per layer, sample order: layer l maps a
        # frontier of width lane_caps[l] onto widths[l] targets
        widths = (1,) + self.lane_caps[:-1]
        self._adj_meta = tuple(
            (self.lane_caps[l], widths[l], self.sizes[l])
            for l in range(len(self.sizes))
        )
        self._warm: set[int] = set()

    # -- per-lane draws --------------------------------------------------------

    def _lane_bits(self, seq: int, layer: int, rows: int):
        """One lane's raw draws for ``rows`` rows, from the generator
        seeded by ``(seed, seq, layer)``."""
        g = seeded_generator(self.device, self.seed, seq, layer)
        return draw_bits((rows,), self.sizes[layer], g)

    def _lane_offsets(self, seq: int, layer: int, deg):
        """One lane's ``(S, k)`` offsets from its ``(S,)`` degrees."""
        k = self.sizes[layer]
        if self.draw_fn is not None:
            return torch.as_tensor(self.draw_fn(seq, layer, deg),
                                   dtype=torch.int32, device=self.device)
        jitter, rot = self._lane_bits(seq, layer, deg.shape[0])
        off, _ = stratified_offsets(deg, k, jitter)
        return rotate_offsets(off, deg, k, rot)

    def _draw(self, seqs):
        """``draw(layer, deg)`` over ``(B, S)`` degrees. Each live lane
        draws from its own generator and the offsets of all lanes are then
        computed in one pass; padding lanes (``seq`` None, every degree 0)
        take zero draws, which the select never reads."""
        def draw(layer, deg):
            k = self.sizes[layer]
            rows = deg.shape[-1]
            if self.draw_fn is not None:
                zero = torch.zeros((rows, k), dtype=torch.int32,
                                   device=self.device)
                return torch.stack([
                    zero if seq is None else self._lane_offsets(seq, layer, d)
                    for seq, d in zip(seqs, deg)])
            zeros = (torch.zeros((rows, k), dtype=torch.int64, device=self.device),
                     torch.zeros((rows, 1), dtype=torch.int64, device=self.device))
            bits = [zeros if seq is None else self._lane_bits(seq, layer, rows)
                    for seq in seqs]
            jitter = torch.stack([j for j, _ in bits])
            rot = torch.stack([r for _, r in bits])
            off, _ = stratified_offsets(deg, k, jitter)
            return rotate_offsets(off, deg, k, rot)
        return draw

    # -- steps -----------------------------------------------------------------

    def _sample(self, seeds, seqs):
        """``seeds`` ``(B,)`` int32 (-1 on padding lanes), ``seqs`` B ints
        (None on padding lanes) -> (n_id ``(B, cap_last)``, edge_index per
        layer deepest-first ``(B, 2, E_l)``, overflow ``(B,)``)."""
        n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
            self.sampler.topo, seeds[:, None], 1, self.sizes,
            self.lane_caps, self._draw(list(seqs)),
        )
        return n_id, tuple(a.edge_index for a in adjs), overflow

    def _forward(self, x, edge_indices):
        """``x`` ``(..., cap_last, F)`` + deepest-first edge_index arrays ->
        ``(..., num_classes)`` log-probs of the seed lane."""
        adjs = [
            Adj(ei, None, (cap, dst), fanout=k)
            for ei, (cap, dst, k) in zip(edge_indices,
                                         reversed(self._adj_meta))
        ]
        with torch.inference_mode():
            return self.model(x, adjs)[..., 0, :]

    def sample_exec(self, bucket: int):
        """The bucket's sample step: ``(seeds, seqs) -> (n_id,
        edge_indices, overflow)``; see :meth:`_sample`."""
        def run(seeds, seqs):
            if seeds.shape != (bucket,) or len(seqs) != bucket:
                raise ValueError(f"bucket {bucket} got seeds {tuple(seeds.shape)}")
            return self._sample(seeds, seqs)
        return run

    def forward_exec(self, bucket: int):
        """The bucket's forward step: ``(x (B, cap, F), edge_indices) ->
        (B, num_classes)``."""
        def run(x, edge_indices):
            if x.shape[0] != bucket:
                raise ValueError(f"bucket {bucket} got x {tuple(x.shape)}")
            return self._forward(x, edge_indices)
        return run

    def warmup(self, buckets) -> int:
        """Run every bucket's two steps once on padding lanes (building the
        kernels and initialising the libraries on first use); returns the
        number of buckets newly warmed."""
        before = len(self._warm)
        for b in buckets:
            b = int(b)
            seeds = torch.full((b,), -1, dtype=torch.int32, device=self.device)
            _n, eis, _o = self.sample_exec(b)(seeds, [None] * b)
            x = torch.zeros((b, self.lane_caps[-1], self.feature_dim),
                            dtype=self.row_dtype, device=self.device)
            self.forward_exec(b)(x, eis)
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self._warm) - before

    # -- parity oracle ---------------------------------------------------------

    def oracle_sample(self, node: int, seq: int):
        """Direct (ladder-free) single-query sample with the same draws:
        ``(n_id (cap_last,), edge_indices (2, E_l) deepest-first,
        overflow)``."""
        seeds = torch.tensor([int(node)], dtype=torch.int32, device=self.device)
        n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
            self.sampler.topo, seeds, 1, self.sizes, self.lane_caps,
            lambda layer, deg: self._lane_offsets(int(seq), layer, deg),
        )
        return n_id, tuple(a.edge_index for a in adjs), overflow

    def oracle_forward(self, x, edge_indices):
        """One lane's forward at the oracle's shapes: ``x (cap_last, F)``
        -> ``(num_classes,)``."""
        return self._forward(x, edge_indices)
