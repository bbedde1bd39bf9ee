"""Multi-layer graph sampler with the PyG-compatible output contract.

The port of ``quiver_tpu/sampling/sampler.py``: a fanout list ``sizes``,
per-layer sample + reindex, ``Adj(edge_index, e_id, size)`` records
returned deepest layer first, and ``n_id[:batch_size] == seeds``. Shapes
are padded exactly as in the JAX package: seeds to ``seed_capacity``,
every frontier to its cap, ``-1`` sentinels on invalid lanes.

Draws follow the JAX package's per-layer key discipline: each layer draws
from its own ``torch.Generator``, seeded by ``(seed, call, layer)``; a
hop's draw is its raw bits (a uniform hop's) or its ``u01`` block (a
weighted hop's), so the hop runs in one launch of a fused entry (K1's or
K3's). A ``draw_fn(layer, deg)`` seam replaces those draws (the tests
feed it JAX's): it returns a uniform hop's int32 offsets (then K1's select
entry runs), or a weighted hop's float32 ``u01`` block (then K3's
search-and-select entry runs).

``kernel=`` picks the hop's path, as in the JAX package: ``"pallas"`` is
the fused hop (one launch of K1's ``uniform_hop`` or K3's
``weighted_hop``), ``"xla"`` the composed path on the same draws (the
offsets or ``u`` in torch ops, then K1's ``select`` or K3's ``wselect``:
the counterpart of JAX's XLA ``sample_layer``, bitwise the fused hop), and
``"auto"`` the measured election on the card (``SAMPLE_ELECTION``), xla on
the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.config import SampleMode, validate_dedup
from ..core.memory import resolve_device
from ..core.topology import CSRTopo, DeviceTopology, VersionMismatchError
from ..ops.election import KernelElection, validate_kernel_arg
from ..ops.reindex import reindex_layer
from ..ops.sample import hop_draws, sample_layer, seeded_generator
from ..utils.trace import get_logger

__all__ = ["Adj", "GraphSageSampler", "SAMPLE_ELECTION", "SampleOutput",
           "multilayer_sample", "resolve_sample_kernel"]


class Adj:
    """PyG-shaped adjacency record.

    ``edge_index`` is ``(..., 2, E_cap)`` with [0] = source (frontier-local
    neighbour id) and [1] = target (seed-local id); invalid edges have
    source == -1. ``size`` = (num_source_nodes_cap, num_target_nodes_cap).
    ``fanout``, when set, asserts the regular layout: lane ``s*fanout + k``
    targets seed ``s``, which lets the model aggregate densely.
    """

    def __init__(self, edge_index, e_id, size: tuple[int, int],
                 fanout: int | None = None):
        self.edge_index = edge_index
        self.e_id = e_id
        self.size = tuple(size)
        self.fanout = fanout

    def __iter__(self):
        return iter((self.edge_index, self.e_id, self.size))

    def __repr__(self):
        return f"Adj(edge_index={tuple(self.edge_index.shape)}, size={self.size})"

    def to(self, device):
        return Adj(self.edge_index.to(device),
                   None if self.e_id is None else self.e_id.to(device),
                   self.size, self.fanout)


class SampleOutput(NamedTuple):
    n_id: torch.Tensor  # (frontier_cap,) node ids, seeds first, -1 padded
    batch_size: int
    adjs: list  # deepest layer first
    n_count: torch.Tensor  # valid entries in n_id
    overflow: torch.Tensor  # uniques dropped by frontier caps (0 = exact)
    edge_counts: tuple = ()  # per-layer valid edges, deepest first
    frontier_counts: tuple = ()  # per-layer unclipped unique counts, deepest first


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def multilayer_sample(topo, seeds, num_seeds, sizes, caps, draw=None,
                      with_eid: bool = False, weighted: bool = False,
                      time_window=None, bits=None, fused: bool = True):
    """The multi-layer sample + reindex loop.

    ``seeds`` is ``(..., S)``, ``num_seeds`` a scalar or ``(...)``; every
    leading index is an independent sample (the serving ladder's lanes).
    Each hop draws through one of two seams. ``draw(layer, deg)`` gives
    its ``(..., S_l, k)`` draws from its ``(..., S_l)`` degrees: int32
    offsets, or float32 ``u01`` when ``weighted``. ``bits(layer, shape)``
    gives its raw draws over rows of ``shape`` (``sample_layer``'s
    ``bits=`` seam: a uniform hop's ``(jitter, rot)``, a weighted hop's
    ``u01``), which a fused entry consumes. ``time_window`` makes every
    hop temporal (``deg`` is then the in-window degree). ``fused=False``
    runs a ``bits`` hop through the composed path (``sample_layer``'s
    ``fused``).

    Returns (n_id, n_count, adjs deepest-first, overflow, per-layer edge
    counts, per-layer unclipped frontier counts).
    """
    if (draw is None) == (bits is None):
        raise ValueError("multilayer_sample takes one of draw and bits")
    adjs, edge_counts, frontier_counts = [], [], []
    cur, cur_n = seeds, num_seeds
    total_overflow = torch.zeros(cur.shape[:-1], dtype=torch.int32,
                                 device=seeds.device)
    for l, k in enumerate(sizes):
        if bits is not None:
            seam = {"bits": lambda shape, l=l: bits(l, shape)}
        else:
            seam = {"u" if weighted else "offs": lambda deg, l=l: draw(l, deg)}
        out = sample_layer(topo, cur, cur_n, k, with_eid=with_eid,
                           weighted=weighted, time_window=time_window,
                           fused=fused, **seam)
        nbr = out[0]
        frontier, n_frontier, col, overflow = reindex_layer(
            cur, cur_n, nbr, caps[l])
        S = cur.shape[-1]
        row = torch.arange(S, dtype=torch.int32, device=seeds.device)[:, None]
        row = torch.where(col >= 0, row, -1)
        lead = col.shape[:-2]
        edge_index = torch.stack(
            [col.reshape(*lead, S * k), row.reshape(*lead, S * k)], dim=-2)
        eids = None
        if with_eid:
            # neighbours dropped by frontier-cap overflow must not leak
            # their edge ids
            eids = torch.where(col >= 0, out[2], -1).reshape(*lead, S * k)
        adjs.append(Adj(edge_index, eids, (caps[l], S), fanout=k))
        edge_counts.append((col >= 0).sum(dim=(-2, -1)).to(torch.int32))
        frontier_counts.append(n_frontier + overflow)
        cur, cur_n = frontier, n_frontier
        total_overflow = total_overflow + overflow
    return (cur, torch.as_tensor(cur_n, device=seeds.device), adjs[::-1],
            total_overflow, tuple(edge_counts[::-1]),
            tuple(frontier_counts[::-1]))


# -- kernel=auto election (ops/election.py) ------------------------------------

_PALLAS_SAMPLE_OK: bool | None = None


def _pallas_sample_usable(device) -> bool:
    """One-time bitwise smoke of the fused hops on ``device``: on the JAX
    package's 64-node graph (512 random edges, 16 seeds, k = 4), the fused
    uniform and weighted hops must return the composed path's neighbours,
    counts and edge ids on shared draws."""
    global _PALLAS_SAMPLE_OK
    if _PALLAS_SAMPLE_OK is None:
        rng = np.random.default_rng(0)
        ei = rng.integers(0, 64, size=(2, 512))
        seeds_np = rng.integers(0, 64, 16).astype(np.int32)
        topo = CSRTopo(edge_index=ei,
                       edge_weight=rng.random(512).astype(np.float32))
        dev = topo.to_device(SampleMode.HBM, device, with_eid=True,
                             with_weights=True)
        seeds = torch.from_numpy(seeds_np).to(device)
        ok = True
        for weighted in (False, True):
            g = seeded_generator(device, 0, int(weighted))
            draws = hop_draws((16,), 4, g, weighted=weighted)
            fused, composed = (
                sample_layer(dev, seeds, 16, 4, with_eid=True,
                             weighted=weighted, bits=draws, fused=f)
                for f in (True, False))
            ok &= all(torch.equal(a, b) for a, b in zip(fused, composed))
        _PALLAS_SAMPLE_OK = bool(ok)
    return _PALLAS_SAMPLE_OK


def _measure_sample_eps(kernel: str, device, nodes: int = 4096,
                        edges: int = 1 << 18, batch: int = 1024, k: int = 8,
                        reps: int = 8) -> float:
    """Sampled edges/s of one hop path on ``device``: ``reps`` distinct
    batches of ``batch`` seeds over a random ``nodes``-node,
    ``edges``-edge graph, each hop drawing from a generator, timed between
    CUDA events after a warm-up; the middle of 3 runs."""
    rng = np.random.default_rng(0)
    topo = CSRTopo(edge_index=rng.integers(0, nodes, size=(2, edges)))
    dev = topo.to_device(SampleMode.HBM, device)
    seeds_mat = torch.from_numpy(
        rng.integers(0, nodes, (reps, batch)).astype(np.int32)).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(1)
    fused = kernel == "pallas"

    def run():
        for seeds in seeds_mat:
            sample_layer(dev, seeds, batch, k, g, fused=fused)

    run()  # warm-up (builds the kernels on first use)
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return reps * batch * k / sorted(times)[1]


# edges/s election between the fused hop and the composed path. The rev
# bumps when either path's implementation changes. The callables defer the
# module-global lookup so tests can monkeypatch them.
SAMPLE_ELECTION = KernelElection(
    "sample", env_var="QUIVER_SAMPLE_KERNEL", rev=1,
    smoke=lambda device: _pallas_sample_usable(device),  # noqa: PLW0108
    measure=lambda kernel, device: _measure_sample_eps(kernel, device),
    unit="edges/s", log_child="sampler",
)


def resolve_sample_kernel(kernel: str, device) -> str:
    """Resolve the sampler's hop path on ``device``: explicit requests
    pass through; ``"auto"`` is ``"xla"`` off the card, and on a CUDA
    device the measured election between the fused hop and the composed
    path (a bitwise smoke, an edges/s measurement, the shared disk cache,
    ``QUIVER_SAMPLE_KERNEL=pallas|xla`` to force). A failed smoke raises."""
    return SAMPLE_ELECTION.resolve_request(kernel, device)


class GraphSageSampler:
    """K-hop neighbour sampler over a placed CSR topology.

    Args:
      csr_topo: host CSRTopo.
      sizes: fanouts per layer, seeds outward; -1 = full neighbourhood
        (capped at the graph's max degree).
      device: sampling device; CUDA unless the caller passes another
        (``"cpu"`` runs the kernels' plain versions).
      mode: ``"GPU"``/``"HBM"`` (topology in device memory) or
        ``"UVA"``/``"HOST"`` (``indices``, ``eid`` and ``cum_weights`` in
        pinned host memory, read over UVA by the select kernels).
      seed_capacity: padded batch size; defaults to the batch rounded up to
        a multiple of 128.
      frontier_caps: per-layer unique-node capacity; defaults to the
        worst-case growth clamped at node_count. ``"auto"`` sizes the caps
        from the first call's unclipped unique counts times
        ``auto_margin`` (rounded up to 128, clamped to the worst case,
        never shrinking) and regrows them when a later call overflows,
        rerunning that call with the same draws. An auto sampler pays one
        host sync per call to read the counts. Each hop draws over (at
        least) its worst-case rows and uses the prefix it needs, so a row's
        draws do not depend on the caps: an auto sampler's samples equal a
        worst-case sampler's with the same seed.
      seed: base seed; call ``c``'s layer ``l`` draws from a generator
        seeded by ``(seed, c, l)``.
      weighted: draw neighbours in proportion to the edge weights
        (needs ``csr_topo.set_edge_weight``); every hop runs kernel K3
        (one launch of its fused entry).
      time_window: ``(lo, hi)``: every hop draws only from edges with
        ``lo <= t <= hi`` (needs ``csr_topo.set_edge_time`` and GPU mode);
        excludes ``weighted``.
      auto_margin: headroom factor of ``"auto"`` caps (>= 1).
      kernel: ``"pallas"`` (the fused hops), ``"xla"`` (the composed
        path on the same draws) or ``"auto"`` (the measured election on the
        card, ``"xla"`` on the CPU; see :func:`resolve_sample_kernel`),
        resolved at the first ``sample``.
      with_eid: populate ``Adj.e_id`` with per-edge ids.
      dedup: ``"sort"``, ``"map"``, ``"scan"`` or ``"auto"``, validated:
        the JAX package's three reindex strategies give identical results,
        and every one runs the port's one reindex, which gives them too.
      device_topo: a placed :class:`~..core.topology.DeviceTopology` to
        reuse instead of placing a fresh copy, so that samplers (and the
        serving replicas over them) share one device-resident graph. It
        must lie on ``device`` and carry what this sampler reads: ``eid``
        when ``with_eid``, ``cum_weights`` when ``weighted``,
        ``edge_time`` with a ``time_window``; otherwise this raises.
      topo_sharding: ``"replicated"``; ``"mesh"`` (a topology partitioned
        across cards, ROADMAP A.11) raises.
      compiled_cache_size: accepted for API parity and inert: the JAX
        package bounds its cache of compiled programs with it; the port
        compiles nothing.

    ``reruns`` counts the calls that an auto sampler ran again under
    regrown caps.
    """

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int], device=None,
                 mode: str | SampleMode = SampleMode.HBM,
                 seed_capacity: int | None = None,
                 frontier_caps: Sequence[int] | str | None = None,
                 seed: int = 0, weighted: bool = False, time_window=None,
                 auto_margin: float = 1.25, kernel: str = "auto",
                 with_eid: bool = False, dedup: str = "auto",
                 device_topo=None, topo_sharding: str = "replicated",
                 compiled_cache_size: int = 8):
        if topo_sharding == "mesh":
            raise NotImplementedError(
                "topo_sharding='mesh' (a topology partitioned across cards) "
                "is not ported (ROADMAP A.11)")
        if topo_sharding != "replicated":
            raise ValueError(
                f"topo_sharding must be 'replicated' or 'mesh', "
                f"got {topo_sharding!r}")
        if compiled_cache_size < 1:
            raise ValueError(
                f"compiled_cache_size must be >= 1, got {compiled_cache_size}")
        self.compiled_cache_size = int(compiled_cache_size)
        self.device = resolve_device(device)
        self._kernel = validate_kernel_arg(str(kernel))
        self.dedup = validate_dedup(str(dedup))
        self.csr_topo = csr_topo
        self.mode = SampleMode.parse(mode)
        max_deg = csr_topo.max_degree
        self.sizes = tuple(int(k) if k != -1 else max_deg for k in sizes)
        if any(k < 1 for k in self.sizes):
            raise ValueError(f"fanouts must be >= 1 or -1, got {sizes}")
        self.with_eid = bool(with_eid)
        self.weighted = bool(weighted)
        if time_window is not None:
            lo_t, hi_t = time_window
            time_window = (float(lo_t), float(hi_t))
            if self.weighted:
                raise ValueError(
                    "time_window cannot be combined with weighted=True; "
                    "pick one biased draw per sampler"
                )
        self.time_window = time_window
        if self.weighted and csr_topo.cum_weights is None:
            raise ValueError(
                "weighted=True requires edge weights; call "
                "csr_topo.set_edge_weight() or pass edge_weight= to CSRTopo"
            )
        if self.time_window is not None and csr_topo.edge_time is None:
            raise ValueError(
                "time_window requires edge timestamps; call "
                "csr_topo.set_edge_time() or pass edge_time= to CSRTopo"
            )
        self._auto_caps = isinstance(frontier_caps, str) and frontier_caps == "auto"
        self._auto_margin = float(auto_margin)
        if self._auto_margin < 1.0:
            raise ValueError(f"auto_margin must be >= 1.0, got {auto_margin}")
        if self._auto_caps:
            frontier_caps = None  # the first call plans from the worst case
        elif frontier_caps is not None:
            frontier_caps = tuple(int(c) for c in frontier_caps)
            if len(frontier_caps) != len(self.sizes):
                raise ValueError(
                    f"frontier_caps needs one entry per layer "
                    f"({len(self.sizes)}), got {len(frontier_caps)}"
                )
            if any(c < 1 for c in frontier_caps):
                raise ValueError(f"frontier_caps must be positive, got {frontier_caps}")
        self._frontier_caps = frontier_caps
        self._seed_capacity = seed_capacity
        self.seed = int(seed)
        self._call = 0
        self.reruns = 0
        self.topo = self._init_topo(device_topo)
        self._topo_version = int(csr_topo.version)

    @property
    def kernel(self) -> str:
        """The resolved hop path (``"pallas"`` or ``"xla"``); ``_kernel``
        holds the constructor's request."""
        resolved = getattr(self, "_kernel_resolved", None)
        if resolved is None:
            resolved = resolve_sample_kernel(self._kernel, self.device)
            self._kernel_resolved = resolved
        return resolved

    def _init_topo(self, device_topo=None):
        """Place the topology, or adopt ``device_topo`` after checking that
        it lies on this sampler's device and carries what it reads."""
        if device_topo is None:
            return self.csr_topo.to_device(
                self.mode, self.device, with_eid=self.with_eid,
                with_weights=self.weighted,
                with_times=self.time_window is not None)
        if not isinstance(device_topo, DeviceTopology):
            raise TypeError(
                f"device_topo must be a DeviceTopology, got "
                f"{type(device_topo).__name__}")
        if device_topo.device != self.device:
            raise ValueError(
                f"device_topo lives on {device_topo.device}, the sampler on "
                f"{self.device}")
        for need, attr, flag in ((self.with_eid, "eid", "with_eid"),
                                 (self.weighted, "cum_weights", "with_weights"),
                                 (self.time_window is not None, "edge_time",
                                  "with_times")):
            if need and getattr(device_topo, attr) is None:
                raise ValueError(
                    f"device_topo lacks {attr}, which this sampler reads; "
                    f"place it with to_device({flag}=True)")
        return device_topo

    # -- streaming-mutation versioning --------------------------------------

    def check_topo_version(self) -> None:
        """Raise :class:`VersionMismatchError` when the host CSR has
        committed a version this sampler's placement was not built from."""
        current = int(self.csr_topo.version)
        if current != self._topo_version:
            raise VersionMismatchError(
                f"sampler topology placement is at version "
                f"{self._topo_version} but the host CSR has committed "
                f"version {current}; call refresh_topology() to re-place "
                f"the device topology before sampling"
            )

    def refresh_topology(self) -> "GraphSageSampler":
        """Re-place the topology from the host CSR and adopt its version.

        A no-op when the placement is already at the committed version:
        serving replicas share one sampler and each refreshes it, and the
        programs a first replica captured after its refresh read the
        placement that a second re-place would free."""
        if self._topo_version == int(self.csr_topo.version):
            return self
        self.topo = self._init_topo()
        self._topo_version = int(self.csr_topo.version)
        return self

    # -- static-shape planning ---------------------------------------------

    def _worst_caps(self, seed_cap: int) -> tuple[int, ...]:
        caps = []
        cur = seed_cap
        n = self.csr_topo.node_count
        for k in self.sizes:
            # clamp growth at node_count but never below the previous cap:
            # forced seed lanes keep duplicate seeds as distinct slots
            cur = max(min(cur * (k + 1), n), cur)
            cur = _round_up(cur, 8)
            caps.append(cur)
        return tuple(caps)

    def _caps_for(self, seed_cap: int) -> tuple[int, ...]:
        if self._frontier_caps is not None:
            return self._frontier_caps
        return self._worst_caps(seed_cap)

    def _plan_auto(self, seed_cap: int, observed: Sequence[int]) -> None:
        """Set the caps to margin x the observed unclipped unique counts
        (seeds outward), rounded up to 128, at least the previous layer's
        cap, never below the caps already planned, at most the worst case."""
        worst = self._worst_caps(seed_cap)
        old = self._frontier_caps or (0,) * len(worst)
        caps, prev = [], seed_cap
        for w, o, c in zip(worst, observed, old):
            cap = _round_up(int(self._auto_margin * o), 128)
            cap = max(cap, prev, c, 128)
            cap = min(cap, w)
            caps.append(cap)
            prev = cap
        self._frontier_caps = tuple(caps)

    # -- public API ----------------------------------------------------------

    def sample(self, input_nodes, draw_fn=None) -> SampleOutput:
        """Sample k-hop neighbourhoods of ``input_nodes``.

        ``draw_fn(layer, deg)`` replaces the generator draws: it
        receives layer ``l``'s ``(S_l,)`` int32 degrees (0 on invalid
        seeds; in-window degrees on a temporal sampler) and returns
        ``(S_l, sizes[l])`` int32 row-local offsets, or, on a weighted
        sampler, ``(S_l, sizes[l])`` float32 uniforms ``u01`` in ``[0, 1)``.
        """
        self.check_topo_version()
        seeds = np.asarray(input_nodes)
        batch = int(seeds.shape[0])
        n = self.csr_topo.node_count
        if batch and (seeds.min() < 0 or seeds.max() >= n):
            raise ValueError(
                f"seed ids must be in [0, {n}); got range "
                f"[{seeds.min()}, {seeds.max()}]"
            )
        cap = self._seed_capacity or max(_round_up(batch, 128), 128)
        if batch > cap:
            raise ValueError(f"batch {batch} exceeds seed_capacity {cap}")
        padded = np.full(cap, -1, dtype=np.int32)
        padded[:batch] = seeds
        self._call += 1
        call = self._call
        # each hop draws over (at least) its worst-case rows and takes the
        # prefix it needs, so a row's draws do not depend on the caps: an
        # auto sampler's rerun repeats them
        rows = (cap,) + tuple(map(max, self._worst_caps(cap), self._caps_for(cap)))

        def draw(l, deg):
            return torch.as_tensor(draw_fn(l, deg), device=self.device)

        def bits(l, shape):
            draws = hop_draws((rows[l],), self.sizes[l], seeded_generator(
                self.device, self.seed, call, l), weighted=self.weighted)
            if self.weighted:
                return draws[:shape[0]]
            return tuple(d[:shape[0]] for d in draws)

        seam = {"draw": draw} if draw_fn is not None else {"bits": bits}
        dev_seeds = torch.from_numpy(padded).to(self.device)
        fused = self.kernel == "pallas"

        def run():
            return multilayer_sample(
                self.topo, dev_seeds, batch, self.sizes, self._caps_for(cap),
                with_eid=self.with_eid, weighted=self.weighted,
                time_window=self.time_window, fused=fused, **seam)

        n_id, n_count, adjs, overflow, edge_counts, frontier_counts = run()
        if self._auto_caps:
            first_plan = self._frontier_caps is None
            # regrowth converges in <= len(sizes) rounds (each round's caps
            # cover that round's counts); the bound guards the saturated
            # case, where duplicate seeds overflow even the worst case and
            # the clipped result and its overflow stand
            for _ in range(len(self.sizes) + 2):
                # one host sync: the overflow and the unclipped counts
                ovf, *counts = torch.stack(
                    [overflow, *frontier_counts]).tolist()
                if not first_plan and ovf == 0:
                    break
                before = self._frontier_caps
                self._plan_auto(cap, counts[::-1])
                if self._frontier_caps != before:
                    get_logger().info(
                        "auto caps %s: %s -> %s (recompile)",
                        "planned" if before is None else "regrown",
                        before, self._frontier_caps,
                    )
                if first_plan and ovf == 0:
                    break  # the worst-case run stands; later calls fit
                if not first_plan and self._frontier_caps == before:
                    break  # saturated at the worst case
                n_id, n_count, adjs, overflow, edge_counts, frontier_counts = run()
                self.reruns += 1
                first_plan = False
        return SampleOutput(n_id, batch, adjs, n_count, overflow,
                            edge_counts, frontier_counts)

    # -- reference API shims (one process owns the sampler) -----------------

    def share_ipc(self):
        """The rebuild recipe (reference sage_sampler.py:114-120); there is
        nothing to share between processes here."""
        return (self.csr_topo, self.sizes, self.mode)

    @classmethod
    def lazy_from_ipc_handle(cls, handle, device=None):
        csr_topo, sizes, mode = handle
        return cls(csr_topo, sizes, device=device, mode=mode)
