"""Per-bucket serving programs for online point queries.

The port of ``quiver_tpu/serving/ladder.py``. For each power-of-two bucket
size ``B`` the ladder builds exactly two fixed-shape programs and replays
them:

* **sample**: the ``B`` lanes are sampled together, one launch per hop
  for all lanes (a fused entry on the lanes' stacked raw draws: K1's
  uniform hop, or K3's weighted hop on a weighted sampler; K1's select
  entry or K3's search-and-select on the sampler's ``kernel="xla"``), but
  every lane is its own single-seed sample with its own frontier caps
  (planned for ONE seed) and its own draws, from generators seeded by
  ``(seed, seq, layer)``. Lanes share no state, so a request's
  neighbourhood is a function of ``(node, seq)`` alone, whatever the
  bucket, the padding or the co-batched requests: the ladder's ids and
  edges equal the direct single-query oracle bitwise.
* **forward**: the model run once per lane, at the oracle's shapes, over
  that lane's ``(cap, F)`` rows of the gathered block (the JAX ladder's
  ``lax.scan`` over lanes), so the ladder's log-probs equal the oracle's
  bitwise too.

On a CUDA device a program is a ``torch.cuda.CUDAGraph``, captured after
one eager pass on the ladder's side stream, over static input and output
tensors that the program owns; a replay launches every kernel of the step
with no Python in between. The lanes' draws stay outside the graph: they
are drawn on the card from the per-lane generators as before and copied
into the sample program's static draw buffers, so a replay's draws are
bitwise the eager step's. On the CPU a program is the same eager step
bound to the same static buffers, built, counted, cached and replayed with
the same logic. A ``draw_fn`` ladder (the parity seam, whose draws depend
on the degrees) keeps its sample step eager and still captures its
forward. A failed capture or replay raises; nothing serves eagerly in its
place.

The feature gather sits between the two programs, in the server, eager.

Every build consults the attached :class:`~.aot.AOTExecutableCache`
first; a miss captures (counted in ``compiles``, the JAX ladder's name),
then publishes. A captured program bakes the addresses of what it reads
(the placed topology, the parameters, its static buffers) and holds
references to all of them; the cache key adds those addresses to the
fingerprint, so two servers over different placements never share a
program.
"""

from __future__ import annotations

import collections
import functools
import gc
import time

import torch

from ..ops.kernels import launch_counts
from ..ops.sample import (hop_draws, rotate_offsets, seeded_generator,
                          stratified_offsets)
from ..sampling.sampler import Adj, GraphSageSampler, multilayer_sample

__all__ = ["REPLAYED_LAUNCHES", "ServeLadder"]

#: kernel wrapper name -> launches made by program replays in this process
#: (each replay adds the launches its capture recorded); the wrappers' own
#: ``launches`` count the Python calls, which a replay does not make.
REPLAYED_LAUNCHES: collections.Counter = collections.Counter()

_TOPO_FIELDS = ("indptr", "indices", "eid", "cum_weights", "edge_time")


def _copy_into(dst, src) -> None:
    """Copy a nest of tensors into a nest of the same shapes."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _Program:
    """One bucket's step bound to static input buffers.

    ``step()`` reads the buffers in ``inputs`` and returns the outputs.
    With ``static=True`` the step is captured as a CUDA graph on a CUDA
    device (after one eager pass on ``stream``, into the memory ``pool``),
    or on the CPU run eagerly with its results copied into the outputs of
    the first run; a replay returns the same output tensors every time.
    With ``static=False`` every replay runs the step eagerly and returns
    fresh outputs. ``keep`` holds the tensors whose addresses the step
    bakes. ``launches`` records the kernel launches a capture made, which
    every replay makes again.
    """

    def __init__(self, step, inputs, *, device, static: bool = True,
                 keep=(), stream=None, pool=None):
        self.step = step
        self.inputs = inputs
        self.keep = tuple(keep)
        self.static = static
        self.graph = None
        self.launches: dict[str, int] = {}
        self.replays = 0
        t0 = time.perf_counter()
        if static and device.type == "cuda":
            self.outputs = self._capture(device, stream, pool)
        elif static:
            self.outputs = step()
        else:
            self.outputs = None
        self.build_s = time.perf_counter() - t0

    def _capture(self, device, stream, pool):
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        # the eager pass builds the kernels, initialises cuBLAS on this
        # stream, looks up pinned tables' UVA addresses and runs the
        # QUIVER_CHECK readbacks: none of that may happen under capture
        with torch.cuda.stream(stream):
            self.step()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # a garbage collection during capture can free a pinned host block,
        # whose allocator then queries CUDA events, which invalidates the
        # capture: collect first and keep the collector off until it ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = self.step()
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.graph = graph
        return outputs

    def replay(self):
        if self.graph is not None:
            self.graph.replay()
        elif self.static:
            with torch.inference_mode():  # a forward's outputs are inference tensors
                _copy_into(self.outputs, self.step())
        else:
            return self.step()
        self.replays += 1
        REPLAYED_LAUNCHES.update(self.launches)
        return self.outputs


class ServeLadder:
    """Per-bucket (sample, forward) programs over one sampler and model.

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
        weighted sampler. Its sample step stays eager.
      on_compile: called once per program build (capture); the server
        feeds ``serve.recompiles`` from it.
      aot_cache: optional :class:`~.aot.AOTExecutableCache`: every build
        consults it first (a hit takes the process's captured program,
        with no capture and no ``on_compile``), and every capture is
        published to it.
      on_cache_load: called once per program taken from the cache; the
        server feeds ``serve.aot_loads`` from it.
    """

    def __init__(self, sampler: GraphSageSampler, model, feature_dim: int,
                 row_dtype=torch.float32, lane_caps=None, seed: int = 0,
                 draw_fn=None, on_compile=None, aot_cache=None,
                 on_cache_load=None):
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
        self._on_compile = on_compile
        self.aot_cache = aot_cache
        self._on_cache_load = on_cache_load
        # static Adj metadata per layer, sample order: layer l maps a
        # frontier of width lane_caps[l] onto widths[l] targets
        widths = (1,) + self.lane_caps[:-1]
        self._adj_meta = tuple(
            (self.lane_caps[l], widths[l], self.sizes[l])
            for l in range(len(self.sizes))
        )
        self.compiles = 0
        self.cache_loads = 0
        self._sample_exec: dict[int, _Program] = {}
        self._forward_exec: dict[int, _Program] = {}

    @functools.cached_property
    def _capture_ctx(self):
        """``(stream, pool)``: every program of this ladder is captured on
        one side stream into one memory pool, in build order."""
        if self.device.type != "cuda":
            return None, None
        return (torch.cuda.Stream(self.device),
                torch.cuda.graph_pool_handle())

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

    def _rows(self, layer: int) -> int:
        """Rows a lane's hop draws over at ``layer``: 1 seed, then the
        previous layer's frontier cap."""
        return 1 if layer == 0 else self.lane_caps[layer - 1]

    def _draw_buffers(self, bucket: int):
        """The sample program's static draw buffers per layer: ``u01``
        ``(B, rows, k)`` f32, or ``(jitter (B, rows, k), rot (B, rows, 1))``
        int64."""
        bufs = []
        for layer, k in enumerate(self.sizes):
            shape = (bucket, self._rows(layer))
            if self.weighted:
                bufs.append(torch.zeros(shape + (k,), dtype=torch.float32,
                                        device=self.device))
            else:
                bufs.append(tuple(torch.zeros(shape + (w,), dtype=torch.int64,
                                              device=self.device)
                                  for w in (k, 1)))
        return bufs

    def _bits(self, seqs):
        """``bits(layer, shape, out=None)`` over ``(B, S)`` rows: each live
        lane's raw draws from its own generator (``u01`` on a weighted
        sampler, else ``(jitter, rot)``), stacked (into ``out`` when
        given); padding lanes (``seq`` None) take zeros, which the hop
        never reads."""
        def bits(layer, shape, out=None):
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
                return torch.stack(lanes, out=out)
            return (torch.stack([j for j, _ in lanes], out=None if out is None else out[0]),
                    torch.stack([r for _, r in lanes], out=None if out is None else out[1]))
        return bits

    def _fill_draws(self, bufs, seqs) -> None:
        """Draw every lane's bits into the sample program's static
        buffers (see :meth:`_bits`)."""
        bits = self._bits(seqs)
        for layer, buf in enumerate(bufs):
            bits(layer, (len(seqs), self._rows(layer)), out=buf)

    # -- per-lane forward ------------------------------------------------------

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

    # -- program fingerprints ----------------------------------------------------

    def _topo_tensors(self):
        topo = self.sampler.topo
        return [(name, getattr(topo, name)) for name in _TOPO_FIELDS
                if getattr(topo, name) is not None]

    def _params(self):
        return list(self.model.named_parameters()) + list(
            self.model.named_buffers())

    def fingerprint_components(self, kind: str, bucket: int) -> dict:
        """Everything the ``(kind, bucket)`` program closed over, as a
        JSON-able dict (see :func:`~.aot.program_fingerprint`): the JAX
        ladder's keys, with torch's, CUDA's and the card's versions and
        name in place of jax, platform and device kind. The CSR's
        committed ``version`` and the placed topology's shapes are both in
        the key, so a mutation always forks the fingerprint; the sampler's
        dedup strategy is keyed by name (JAX's key, a bool, ties the
        strategies together)."""
        s = self.sampler
        cuda = self.device.type == "cuda"
        comp = {
            "target": f"serve.{kind}",
            "bucket": int(bucket),
            "sizes": list(self.sizes),
            "lane_caps": list(self.lane_caps),
            "kernel": s.kernel,
            "dedup": s.dedup,
            "weighted": bool(s.weighted),
            "draws": "draw_fn" if self.draw_fn is not None else "generator",
            "csr_version": int(s.csr_topo.version),
            "topo_avals": [[name, list(map(int, t.shape)), str(t.dtype)]
                           for name, t in self._topo_tensors()],
            "search_iters": int(s.topo.search_iters),
            "host_indices": bool(s.topo.host_indices),
            "torch": torch.__version__,
            "cuda": torch.version.cuda if cuda else None,
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "n_devices": torch.cuda.device_count() if cuda else 1,
        }
        if kind == "forward":
            comp["model"] = f"{type(self.model).__name__}:{self.model!r}"
            comp["params"] = [[name, list(map(int, p.shape)), str(p.dtype)]
                              for name, p in self._params()]
            comp["feature_dim"] = self.feature_dim
            comp["row_dtype"] = str(self.row_dtype)
        return comp

    def fingerprint(self, kind: str, bucket: int) -> str:
        from .aot import program_fingerprint

        return program_fingerprint(self.fingerprint_components(kind, bucket))

    def _addresses(self, kind: str) -> tuple:
        """The addresses a ``kind`` program bakes, the rest of its cache
        key: the placed topology's tensors (and the ``draw_fn``, whose
        draws an eager sample step calls), or the parameters."""
        if kind == "sample":
            key = [t.data_ptr() for _, t in self._topo_tensors()]
            if self.draw_fn is not None:
                key.append(("draw_fn", id(self.draw_fn)))
        else:
            key = [p.data_ptr() for _, p in self._params()]
        return (str(self.device), *key)

    # -- program builds (cache first when a cache is attached) ------------------

    def _build(self, kind: str, bucket: int):
        fp = addresses = None
        if self.aot_cache is not None:
            fp = self.fingerprint(kind, bucket)
            addresses = self._addresses(kind)
            program = self.aot_cache.load(fp, addresses)
            if program is not None:
                self.cache_loads += 1
                if self._on_cache_load is not None:
                    self._on_cache_load()
                return program
        build = self._new_sample if kind == "sample" else self._new_forward
        program = build(bucket)
        self.compiles += 1
        if self._on_compile is not None:
            self._on_compile()
        if self.aot_cache is not None:
            self.aot_cache.store(fp, program,
                                 self.fingerprint_components(kind, bucket),
                                 addresses)
        return program

    def _new_sample(self, bucket: int) -> _Program:
        topo = self.sampler.topo
        fused = self.sampler.kernel == "pallas"  # resolved before any capture
        dedup = self.sampler.dedup
        seeds = torch.full((bucket,), -1, dtype=torch.int32, device=self.device)
        inputs = {"seeds": seeds, "seqs": [None] * bucket}
        if self.draw_fn is not None:
            # graftlint: eager -- a static=False program runs eagerly on every replay, never under capture
            def step():
                n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
                    topo, seeds[:, None], 1, self.sizes, self.lane_caps,
                    weighted=self.weighted, fused=fused, dedup=dedup,
                    draw=self._draw(inputs["seqs"]))
                return n_id, tuple(a.edge_index for a in adjs), overflow
            return _Program(step, inputs, device=self.device, static=False,
                            keep=(topo,))
        # one valid seed per lane as a device tensor: a Python count would
        # be copied to the card inside the step, which capture forbids
        nvalid = torch.ones(bucket, dtype=torch.int32, device=self.device)
        draws = inputs["draws"] = self._draw_buffers(bucket)

        def step():
            # the map strategy's (bucket, node_count) scratch is allocated
            # here, inside the capture, so it lives in the capture's pool
            n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
                topo, seeds[:, None], nvalid, self.sizes, self.lane_caps,
                weighted=self.weighted, fused=fused, dedup=dedup,
                bits=lambda layer, _shape: draws[layer])
            return n_id, tuple(a.edge_index for a in adjs), overflow
        stream, pool = self._capture_ctx
        return _Program(step, inputs, device=self.device, keep=(topo,),
                        stream=stream, pool=pool)

    def _new_forward(self, bucket: int) -> _Program:
        x = torch.zeros((bucket, self.lane_caps[-1], self.feature_dim),
                        dtype=self.row_dtype, device=self.device)
        eis = tuple(torch.full((bucket, 2, dst * k), -1, dtype=torch.int32,
                               device=self.device)
                    for (_cap, dst, k) in reversed(self._adj_meta))
        stream, pool = self._capture_ctx
        return _Program(lambda: self._forward(x, eis), {"x": x, "eis": eis},
                        device=self.device,
                        keep=tuple(p for _, p in self._params()),
                        stream=stream, pool=pool)

    # -- replay ------------------------------------------------------------------

    def sample_program(self, bucket: int) -> _Program:
        program = self._sample_exec.get(bucket)
        if program is None:
            program = self._sample_exec[bucket] = self._build("sample", bucket)
        return program

    def forward_program(self, bucket: int) -> _Program:
        program = self._forward_exec.get(bucket)
        if program is None:
            program = self._forward_exec[bucket] = self._build("forward", bucket)
        return program

    def sample_exec(self, bucket: int):
        """The bucket's sample program as ``run(seeds, seqs) -> (n_id (B,
        cap_last), edge_index per layer deepest-first (B, 2, E_l), overflow
        (B,))``: ``seeds`` ``(B,)`` int32 (-1 on padding lanes, any
        device), ``seqs`` B ints (None on padding lanes). A static
        program's outputs are its own tensors, valid until its next run."""
        program = self.sample_program(bucket)

        def run(seeds, seqs):
            seqs = list(seqs)
            if tuple(seeds.shape) != (bucket,) or len(seqs) != bucket:
                raise ValueError(f"bucket {bucket} got seeds {tuple(seeds.shape)}")
            program.inputs["seeds"].copy_(torch.as_tensor(seeds))
            program.inputs["seqs"] = seqs
            if "draws" in program.inputs:
                self._fill_draws(program.inputs["draws"], seqs)
            return program.replay()
        return run

    def forward_exec(self, bucket: int):
        """The bucket's forward program as ``run(x (B, cap, F),
        edge_indices) -> (B, num_classes)``; inputs that are not the
        program's own buffers are copied into them. The output is the
        program's own tensor, valid until its next run."""
        program = self.forward_program(bucket)

        def run(x, edge_indices):
            if x.shape[0] != bucket:
                raise ValueError(f"bucket {bucket} got x {tuple(x.shape)}")
            for dst, src in zip((program.inputs["x"], *program.inputs["eis"]),
                                (x, *edge_indices)):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
            return program.replay()
        return run

    def warmup(self, buckets) -> int:
        """Build every bucket's two programs up front; returns the number
        of captures made (builds the cache did not serve). After this,
        steady-state serving replays programs only (``serve.recompiles``
        stays flat)."""
        before = self.compiles
        for b in buckets:
            self.sample_program(int(b))
            self.forward_program(int(b))
        return self.compiles - before

    def warm_from_cache(self, buckets) -> dict:
        """Build every bucket's program pair, taking each from the attached
        cache where it can and capturing (then publishing) only the rest;
        returns ``{"loaded": n, "compiled": m}``. A replica joining a
        process whose first replica captured reports ``compiled == 0``."""
        before_c, before_l = self.compiles, self.cache_loads
        self.warmup(buckets)
        return {"loaded": self.cache_loads - before_l,
                "compiled": self.compiles - before_c}

    def programs(self) -> list[_Program]:
        """This ladder's programs, in build order by bucket."""
        return [p for b in sorted(set(self._sample_exec) | set(self._forward_exec))
                for p in (self._sample_exec.get(b), self._forward_exec.get(b))
                if p is not None]

    # -- parity oracle ---------------------------------------------------------

    def oracle_sample(self, node: int, seq: int):
        """Direct (ladder-free) single-query sample with the same draws:
        ``(n_id (cap_last,), edge_indices (2, E_l) deepest-first,
        overflow)``."""
        seeds = torch.tensor([int(node)], dtype=torch.int32, device=self.device)
        n_id, _n, adjs, overflow, _ec, _fc = multilayer_sample(
            self.sampler.topo, seeds, 1, self.sizes, self.lane_caps,
            lambda layer, deg: self._lane_draw(int(seq), layer, deg),
            weighted=self.weighted, dedup=self.sampler.dedup,
        )
        return n_id, tuple(a.edge_index for a in adjs), overflow

    def oracle_forward(self, x, edge_indices):
        """One lane's forward: ``x (cap_last, F)`` -> ``(num_classes,)``."""
        with torch.inference_mode():
            return self._lane_forward(x, edge_indices)
