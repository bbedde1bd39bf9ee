"""Per-bucket micro-batch programs for online point queries.

The port of ``quiver_tpu/serving/ladder.py``. For each power-of-two bucket
size ``B`` the ladder runs two fixed-shape steps:

* **sample**: the ``B`` lanes are sampled together, one launch per hop
  for all lanes (a fused entry on the lanes' stacked raw draws: K1's
  uniform hop, or K3's weighted hop on a weighted sampler; K1's select
  entry or K3's search-and-select under a ``draw_fn`` or the sampler's
  ``kernel="xla"``), but every lane is
  its own single-seed sample with its own frontier caps (planned for ONE
  seed) and its own draws, from generators seeded by ``(seed, seq,
  layer)``. Lanes share no state, so a request's neighbourhood is a
  function of ``(node, seq)`` alone, whatever the bucket, the padding or
  the co-batched requests: the ladder's ids and edges equal the direct
  single-query oracle (which draws from the lane's degrees and runs the
  composed path: K1's select entry, or K3's search-and-select) bitwise.
* **forward**: the model run once per lane, at the oracle's shapes, over
  that lane's ``(cap, F)`` rows of the gathered block (the JAX ladder's
  ``lax.scan`` over lanes). A batched pass would let the matrix products
  sum in another order than one lane; per lane, the ladder's log-probs
  equal the oracle's bitwise too.

The feature gather sits between the two steps, in the server. PyTorch runs
eagerly, so there is nothing to compile: ``warmup`` runs every bucket once
to build the kernels and initialise the libraries before traffic arrives.
"""

from __future__ import annotations

import torch

from ..ops.sample import (hop_draws, rotate_offsets, seeded_generator,
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
      draw_fn: optional ``draw_fn(seq, layer, deg)`` replacing a lane's
        generator draws (the parity tests feed it JAX's): it returns the
        lane's ``(S, k)`` int32 offsets, or its float32 ``u01`` block on a
        weighted sampler.
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
        self.weighted = bool(sampler.weighted)
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
        seeded by ``(seed, seq, layer)``: ``u01`` on a weighted sampler,
        else the uniform draw's ``(jitter, rotation)``."""
        g = seeded_generator(self.device, self.seed, seq, layer)
        return hop_draws((rows,), self.sizes[layer], g, weighted=self.weighted)

    def _lane_draw(self, seq: int, layer: int, deg):
        """One lane's ``(S, k)`` draws from its ``(S,)`` degrees: offsets,
        or ``u01`` on a weighted sampler."""
        k = self.sizes[layer]
        if self.draw_fn is not None:
            dtype = torch.float32 if self.weighted else torch.int32
            return torch.as_tensor(self.draw_fn(seq, layer, deg),
                                   dtype=dtype, device=self.device)
        bits = self._lane_bits(seq, layer, deg.shape[0])
        if self.weighted:
            return bits
        off, _ = stratified_offsets(deg, k, bits[0])
        return rotate_offsets(off, deg, k, bits[1])

    def _bits(self, seqs):
        """``bits(layer, shape)`` over ``(B, S)`` rows: each live lane's
        raw draws from its own generator (``u01`` on a weighted sampler,
        else ``(jitter, rot)``); padding lanes (``seq`` None, every seed
        -1) take zeros, which the hop never reads."""
        def bits(layer, shape):
            rows, k = shape[-1], self.sizes[layer]
            zeros = None
            if None in seqs:
                zeros = (torch.zeros((rows, k), device=self.device)
                         if self.weighted else
                         (torch.zeros((rows, k), dtype=torch.int64, device=self.device),
                          torch.zeros((rows, 1), dtype=torch.int64, device=self.device)))
            lanes = [zeros if seq is None else self._lane_bits(seq, layer, rows)
                     for seq in seqs]
            if self.weighted:
                return torch.stack(lanes)
            return (torch.stack([j for j, _ in lanes]),
                    torch.stack([r for _, r in lanes]))
        return bits

    def _draw(self, seqs):
        """``draw(layer, deg)`` over ``(B, S)`` degrees, under a
        ``draw_fn``: each live lane's draws; padding lanes (every degree 0)
        take zero draws, which the select never reads."""
        def draw(layer, deg):
            dtype = torch.float32 if self.weighted else torch.int32
            zero = torch.zeros((deg.shape[-1], self.sizes[layer]), dtype=dtype,
                               device=self.device)
            return torch.stack([
                zero if seq is None else self._lane_draw(seq, layer, d)
                for seq, d in zip(seqs, deg)])
        return draw

    # -- steps -----------------------------------------------------------------

    def _sample(self, seeds, seqs):
        """``seeds`` ``(B,)`` int32 (-1 on padding lanes), ``seqs`` B ints
        (None on padding lanes) -> (n_id ``(B, cap_last)``, edge_index per
        layer deepest-first ``(B, 2, E_l)``, overflow ``(B,)``)."""
        seqs = list(seqs)
        seam = ({"draw": self._draw(seqs)} if self.draw_fn is not None
                else {"bits": self._bits(seqs)})
        n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
            self.sampler.topo, seeds[:, None], 1, self.sizes,
            self.lane_caps, weighted=self.weighted,
            fused=self.sampler.kernel == "pallas", **seam,
        )
        return n_id, tuple(a.edge_index for a in adjs), overflow

    def _lane_forward(self, x, edge_indices):
        """One lane's forward: ``x`` ``(cap_last, F)`` + deepest-first
        ``(2, E_l)`` edge_index arrays -> ``(num_classes,)`` log-probs of
        the seed. The bucket's forward and the oracle both run this, so
        they run the same products at the same shapes."""
        adjs = [
            Adj(ei, None, (cap, dst), fanout=k)
            for ei, (cap, dst, k) in zip(edge_indices,
                                         reversed(self._adj_meta))
        ]
        return self.model(x, adjs)[0]

    def _forward(self, x, edge_indices):
        """``x`` ``(B, cap_last, F)`` + deepest-first ``(B, 2, E_l)``
        edge_index arrays -> ``(B, num_classes)``: one lane at a time."""
        with torch.inference_mode():
            return torch.stack([
                self._lane_forward(x[j], [ei[j] for ei in edge_indices])
                for j in range(x.shape[0])])

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
            lambda layer, deg: self._lane_draw(int(seq), layer, deg),
            weighted=self.weighted,
        )
        return n_id, tuple(a.edge_index for a in adjs), overflow

    def oracle_forward(self, x, edge_indices):
        """One lane's forward: ``x (cap_last, F)`` -> ``(num_classes,)``."""
        with torch.inference_mode():
            return self._lane_forward(x, edge_indices)
