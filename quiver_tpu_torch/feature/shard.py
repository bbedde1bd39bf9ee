"""Mesh-sharded feature storage: the reference's clique-partitioned cache.

The port of ``quiver_tpu/feature/shard.py`` (``ShardedTensor``,
``ShardedFeature``), the reference's ``p2p_clique_replicate`` tier: the hot
rows are partitioned over the members of the mesh's ``feature`` axis, and
a lookup fetches each row from the shard that owns it.

The JAX package gathers inside ``shard_map``: with one id set per feature
group, every shard serves the ids it owns and a ``psum`` over the axis
merges the rows; with one id set per member (the routed flavour), requests
travel to their owners and rows back over two ``all_to_all`` hops
(:class:`~..parallel.routing.BucketRoute`). Here one process holds every
member of the group: shard ``f`` is its own tensor on member ``f``'s
device, the ``psum`` is a sum of the shards' answers in member order, and
the routed exchange moves the requests and rows between the shards' tensors.
On a logical mesh of one card (``make_mesh(devices=["cuda:0"] * 4, data=2,
feature=2)``) every shard sits on that card. Each shard serves its lanes
with one launch of kernel K2's single-table entry (``gather_rows``), the
counterpart of the JAX package's ``_hot_gather_fn``.

``ShardedFeature`` puts the degree-ordered rows in three tiers: an L0 block
of the top-degree rows, stored once per distinct device and read with no
routing (``replicate_budget`` bytes per device); the L1 rows as a
``ShardedTensor`` (``device_cache_size`` bytes per device); and the cold
rest in pinned host memory, which K2 reads over UVA. A lookup is
:func:`~.feature.tiered_lookup`: one ``gather_rows`` launch for the L0
lanes, one per shard for the L1 lanes, one for the cold lanes, and L0 and
cold lanes enter the L1 gather as ``-1``, so they take no bucket capacity.

With ``dtype="int8"`` every tier holds per-row absmax codes and the
``(N,)`` float32 scales live on the device. The JAX package gathers the
codes of a tier, sums them over the shards (psum or the routed fallback)
and then multiplies by the scales; here each tier's one launch is K2's
dequantising entry (``tiered_gather_dequant``) over that tier's table and
the contiguous slice of the scales that starts at the tier's offset, so a
shard dequantises its own rows and the shards' float32 answers are summed.
The rows stay bitwise JAX's: exactly one shard owns a lane and every other
shard answers ``+0.0`` (a negative id reads a zero code and a zero scale),
a code times a scale of 0 or more is never ``-0.0``, ``x + (+0.0) == x``
for every such ``x``, and the kernel rounds each product once
(``__fmul_rn``), as ``codes.astype(float32) * scale`` does.

``repin`` and ``apply_row_updates`` are transactions: every new host array
is built and checked aside, then published with one ``version`` bump and
the tiers placed again. The split tuner (``auto_split=True``, or an
attached :class:`~..control.CacheController`) moves the L0/L1 boundary
between batches from the measured tier hits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..control.freq import _host
from ..core.config import CachePolicy, parse_size_bytes
from ..core.memory import to_pinned_host
from ..core.topology import CSRTopo
from ..obs.registry import ROUTED_OVERFLOW, TIER_HITS, MetricsRegistry
from ..ops.kernels.gather import (gather_rows, gather_rows_plain, tiered_gather_dequant,
                                  tiered_gather_plain)
from ..parallel.mesh import DATA_AXIS, FEATURE_AXIS, Mesh, axis_devices
from ..parallel.routing import BucketRoute
from ..utils.reorder import reorder_by_degree
from ..utils.trace import get_logger, info_once
from .feature import (KernelChoice, _numpy_rows, _parse_storage_dtype,
                      quantize_rows_int8, tiered_lookup, validate_gather_kernel)

__all__ = ["ShardedTensor", "ShardedFeature"]


def _host_table(tensor) -> torch.Tensor:
    """A contiguous CPU tensor of a numpy array or a tensor."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(tensor))


def _row_gather(table, kernel: str, scale=None):
    """(ids of any shape) -> rows of ``table`` through one K2 launch
    (``kernel="pallas"``) or its plain version (``"xla"``); a negative id
    gives a zero row. Without ``scale`` the single-table entry
    (``gather_rows``); with ``scale``, the ``(rows,)`` float32 scales of
    int8 codes, the dequantising entry over this one table
    (``tiered_gather_dequant``, no order, every row "hot"), which returns
    float32 rows."""
    if scale is None:
        fn = gather_rows if kernel == "pallas" else gather_rows_plain
    else:
        deq = tiered_gather_dequant if kernel == "pallas" else tiered_gather_plain
        n = table.shape[0]

        def fn(tab, flat):
            return deq(flat, None, n, tab, None, scale)

    def rows(ids):
        flat = ids.reshape(-1).to(torch.int32).contiguous()
        return fn(table, flat).reshape(tuple(ids.shape) + tuple(table.shape[1:]))

    return rows


class ShardedTensor(KernelChoice):
    """A 2-D table row-sharded over a mesh axis.

    Rows are padded to a multiple of the axis size; shard ``d`` owns rows
    ``[d * rows_per_shard, (d + 1) * rows_per_shard)`` (the reference's
    contiguous offsets, ``tensor_offset_device``) and sits on member
    ``d``'s device, ``shards[d]``.
    """

    def __init__(self, mesh: Mesh, axis: str = FEATURE_AXIS, kernel: str = "auto",
                 routed_alpha: float = 2.0):
        if axis not in (DATA_AXIS, FEATURE_AXIS):
            raise ValueError(f"axis must be {DATA_AXIS!r} or {FEATURE_AXIS!r}, got {axis!r}")
        self.mesh = mesh
        self.axis = axis
        self.num_shards = mesh.shape[axis]
        self.member_devices = axis_devices(mesh, axis)
        self.device = self.member_devices[0]
        self._kernel = validate_gather_kernel(kernel)
        # capped-bucket routed gather: capacity ceil(routed_alpha * L / F) per
        # destination; 2 leaves headroom over a uniform owner spread (the
        # degree order concentrates hot rows on shard 0); grown by
        # _maybe_grow_routed_alpha after an overflowing eager batch
        if routed_alpha <= 0:
            raise ValueError(f"routed_alpha must be > 0, got {routed_alpha}")
        self.routed_alpha = float(routed_alpha)
        self.metrics = MetricsRegistry()
        self.metrics.counter(
            ROUTED_OVERFLOW, unit="lanes",
            doc="fallback-served lanes of the last capped routed gather",
        )
        self.shards: list[torch.Tensor] = []
        # int8 codes only: each shard's (rows_per_shard,) float32 scales
        self.scales: list[torch.Tensor] | None = None
        self.rows_per_shard = 0
        self.num_rows = 0

    @property
    def last_routed_overflow(self):
        """Fallback-served lanes of the last eager routed gather (device
        int32 scalar; None before any). A view of the registry metric
        ``feature.routed_overflow``."""
        return self.metrics.value(ROUTED_OVERFLOW)

    @last_routed_overflow.setter
    def last_routed_overflow(self, value):
        self.metrics.set(ROUTED_OVERFLOW, value)

    def from_cpu_tensor(self, tensor, scale=None) -> "ShardedTensor":
        """Place the rows; ``scale`` (the ``(N,)`` float32 scales of int8
        rows, or None) makes every shard's gather dequantise."""
        table = _host_table(tensor)
        n, f = table.shape
        rps = -(-n // self.num_shards)  # ceil
        padded = rps * self.num_shards
        if padded != n:
            table = torch.cat([table, table.new_zeros((padded - n, f))])
        self.shards = [table[d * rps:(d + 1) * rps].to(dev).contiguous()
                       for d, dev in enumerate(self.member_devices)]
        self.rows_per_shard = rps
        self.num_rows = n
        self.set_scale(scale)
        return self

    def set_scale(self, scale) -> None:
        """Give each shard its slice of ``scale`` (``(N,)`` float32, the
        scales of the table's int8 rows; None: the rows are not codes),
        padded with zeros as the rows are."""
        if scale is None:
            self.scales = None
            return
        rps = self.rows_per_shard
        scale = torch.as_tensor(scale, dtype=torch.float32).reshape(-1)
        pad = rps * self.num_shards - scale.shape[0]
        if pad:
            scale = torch.cat([scale, scale.new_zeros(pad)])
        self.scales = [scale[d * rps:(d + 1) * rps].to(dev).contiguous()
                       for d, dev in enumerate(self.member_devices)]

    @property
    def shape(self):
        return (self.num_rows, self.shards[0].shape[1])

    def local_gather(self, member: int, ids):
        """Shard ``member``'s rows for the ids it owns, zero rows for every
        other id (and for ids below 0): one K2 launch on the shard, which
        dequantises int8 rows (``+0.0`` on the lanes it does not own). The
        psum flavour sums these over the members."""
        rps = self.rows_per_shard
        mine = (ids >= 0) & (torch.div(ids, rps, rounding_mode="floor") == member)
        local = torch.where(mine, ids - member * rps, -1)
        shard = self.shards[member]
        scale = None if self.scales is None else self.scales[member]
        return _row_gather(shard, self.kernel, scale)(local.to(shard.device)).to(ids.device)

    def psum_gather(self, ids):
        """Rows of ``ids`` (any shape; every member requests the same ids):
        each shard's :meth:`local_gather`, summed in member order."""
        out = None
        for d in range(self.num_shards):
            part = self.local_gather(d, ids)
            out = part if out is None else out + part
        return out

    def routed_cap(self, length: int, alpha: float | None = None) -> int:
        """Bucket capacity for a per-member request length ``L``: ``ceil(alpha
        * L / F)``, clamped to ``[1, L]``; ``L`` is the uncapped mode."""
        a = self.routed_alpha if alpha is None else float(alpha)
        if a <= 0:
            raise ValueError(f"alpha must be > 0, got {a}")
        cap = math.ceil(a * length / max(self.num_shards, 1))
        return max(1, min(int(cap), int(length)))

    def _maybe_grow_routed_alpha(self) -> None:
        """Between eager capped gathers: if the previous one overflowed its
        buckets, double ``routed_alpha`` (up to F: full-length buckets)
        before this one plans its cap. Reads the previous batch's count on
        the host."""
        ov = self.last_routed_overflow
        if ov is None:
            return
        self.last_routed_overflow = None
        count = int(ov)
        if count <= 0:
            return
        old = self.routed_alpha
        self.routed_alpha = min(old * 2.0, float(self.num_shards))
        if self.routed_alpha != old:
            get_logger("feature").info(
                "routed gather: %d lanes overflowed their buckets "
                "(fallback-served); growing alpha %.2f -> %.2f",
                count, old, self.routed_alpha,
            )

    def routed_gather(self, ids, cap: int | None = None, with_overflow: bool = False):
        """One feature group's routed gather: ``ids`` is ``(F, L)``, one
        request vector per member (any negative value marks an invalid
        lane, whose row is zero); each request travels to its owner and
        the row back (:class:`~..parallel.routing.BucketRoute`, one K2
        launch per shard). ``cap`` caps the buckets (``None``: uncapped);
        overflowed lanes are served by the fallback, exactly. Returns the
        ``(F, L, row)`` rows, and with ``with_overflow`` also the group's
        fallback-served lane count (int32 scalar, 0 when uncapped)."""
        L = ids.shape[1]
        if cap is not None:
            cap = int(cap)
            if cap < 1:
                raise ValueError(f"cap must be >= 1, got {cap}")
            if cap >= L:
                cap = None  # full-length buckets ARE the uncapped path
        valid = ids >= 0
        safe = torch.where(valid, ids, 0).to(torch.int64)
        route = BucketRoute(safe, valid, torch.div(safe, self.rows_per_shard,
                                                   rounding_mode="floor"),
                            num_shards=self.num_shards, cap=cap)
        rows = route.exchange(self.local_gather)
        return (rows, route.overflow) if with_overflow else rows

    def delete(self) -> None:
        """Free the shards now (the reference's ``shard_tensor.delete``).
        The object is unusable after."""
        self.shards = []
        self.scales = None
        self.last_routed_overflow = None

    def gather(self, ids, routed: bool = False, routed_cap="auto"):
        """Standalone sharded gather of a global id vector.

        ``routed=False``: every shard serves the ids it owns and the rows
        are summed (the psum flavour). ``routed=True``: the ids are split
        over every mesh slot, as the JAX package shards them over every
        axis, and each feature group routes its members' slices to the
        owners. Both return the same rows bitwise.

        ``routed_cap``: ``"auto"`` caps buckets at ``ceil(routed_alpha * L
        / F)`` and grows ``routed_alpha`` after an overflowing call (the
        overflowed lanes themselves are served exactly); ``None`` is the
        uncapped mode; an int an explicit capacity. After a routed call
        ``last_routed_overflow`` holds the fallback-served lanes of every
        group (device int32 scalar).
        """
        ids = torch.as_tensor(ids, device=self.device).reshape(-1)
        if not routed:
            return self.psum_gather(ids)
        groups = self.mesh.devices.size // self.num_shards
        mult = groups * self.num_shards
        n = ids.shape[0]
        pad = (-n) % mult
        if pad:
            # -1, the invalid-lane sentinel: zero rows, sliced off below
            ids = torch.cat([ids, ids.new_full((pad,), -1)])
        local_len = ids.shape[0] // mult
        if routed_cap == "auto":
            self._maybe_grow_routed_alpha()
            cap = self.routed_cap(local_len)
        elif routed_cap is None:
            cap = None
        else:
            cap = min(int(routed_cap), local_len)
        if cap is not None and cap >= local_len:
            cap = None
        # slot g * F + f of the mesh's slots holds chunk g * F + f of the ids
        # (JAX's P(("data", "feature")) sharding): group g's members
        rows, ov = [], None
        for g in range(groups):
            chunk = ids[g * self.num_shards * local_len:(g + 1) * self.num_shards * local_len]
            r, o = self.routed_gather(chunk.reshape(self.num_shards, local_len), cap,
                                      with_overflow=True)
            rows.append(r.reshape(-1, r.shape[-1]))
            ov = o if ov is None else ov + o
        self.last_routed_overflow = ov
        out = torch.cat(rows)
        return out[:n] if pad else out

    def __getitem__(self, ids):
        """Standalone sharded gather (psum flavour); see :meth:`gather`."""
        return self.gather(ids)


class ShardedFeature(KernelChoice):
    """Feature store with three tiers over the mesh.

    * **L0** (``replicate_budget`` bytes per device): the top rows by
      degree, a full copy on every distinct device of the mesh, read with
      no routing (the reference's ``device_replicate``, kept for the rows
      hot enough to earn the copies).
    * **L1** (``device_cache_size`` bytes per device): the next rows, a
      :class:`ShardedTensor` over the ``feature`` axis (the reference's
      ``p2p_clique_replicate``), read by the psum or the routed flavour.
    * **cold**: the rest, in pinned host memory, read by K2 over UVA.

    Both budgets are per device, as the reference's ``device_cache_size``:
    the L1 holds ``budget x feature-axis size`` rows in all.
    ``last_tier_hits`` holds the last eager lookup's int32 ``[replicated,
    sharded, cold]`` hit counts; ``last_routed_overflow`` the L1's
    fallback-served lanes.

    Storage is the input's float dtype, another float dtype
    (``"bfloat16"``), or ``"int8"``: per-row absmax codes in every tier,
    the ``(N,)`` float32 ``scale`` on the device (its 4 B per row charged to
    the budgets first, the sharded budget first), and float32 rows out of
    every lookup. ``auto_split=True`` (or an attached
    :class:`~..control.CacheController`) moves the L0/L1 boundary between
    batches from the measured tier hits; ``repin`` re-tiers to a measured
    hot set; ``apply_row_updates`` patches rows in every tier; each of the
    last two bumps ``version`` once; ``replan`` re-places the tiers onto
    another mesh shape with every row's bytes kept.
    """

    def __init__(
        self,
        mesh: Mesh,
        device_cache_size: int | str = 0,
        csr_topo: CSRTopo | None = None,
        axis: str = FEATURE_AXIS,
        hot_shuffle_seed: int = 0,
        kernel: str = "auto",
        dtype=None,
        routed_alpha: float = 2.0,
        replicate_budget: int | str = 0,
        auto_split: bool = False,
    ):
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.devices.flat[0]
        self._kernel = validate_gather_kernel(kernel)
        if routed_alpha <= 0:
            raise ValueError(f"routed_alpha must be > 0, got {routed_alpha}")
        self.routed_alpha = float(routed_alpha)
        self.storage_dtype = _parse_storage_dtype(dtype)
        self.cache_policy = CachePolicy.MESH_SHARD
        self.cache_budget = parse_size_bytes(device_cache_size)
        self.replicate_budget = parse_size_bytes(replicate_budget)
        self.auto_split = bool(auto_split)
        self.csr_topo = csr_topo
        self.hot_shuffle_seed = hot_shuffle_seed
        self.reps: dict[torch.device, torch.Tensor] = {}  # L0, per distinct device
        self.hot: ShardedTensor | None = None
        self.cold = None
        self._cold_is_host = False
        self.feature_order = None
        self.scale = None  # (N,) float32 dequant scales (int8 storage only)
        # int8 only: the scales of each tier's rows, on the tier's devices
        self._rep_scales: dict[torch.device, torch.Tensor] = {}
        self._cold_scale = None
        self.rep_rows = 0
        self.hot_rows = 0
        self.shape = None
        self.dtype = None
        self.metrics = MetricsRegistry()
        self.metrics.gauge(
            TIER_HITS, shape=(3,), unit="hits",
            doc="per-tier feature hits [replicated, sharded, cold] of the "
                "last gather",
        )
        # host copy of the device region (rows [0, rep_rows + hot_rows) in
        # storage dtype), kept when the L0/L1 boundary may move after
        # placement (auto_split or a nonzero replicate budget): resplit
        # rebuilds both device tiers from it without touching the cold tier
        self._region_host = None
        self._rep_ceiling_rows = 0  # auto_split never grows L0 past this
        # bumped once per published repin or row update; a trainer bound
        # to an older version raises until it refreshes
        self.version = 0
        # the attached CacheController (None: standalone); auto_split=True
        # makes a default one at the first tuner call. The split decision
        # is the controller's; this class measures and actuates
        self._controller = None
        self._resplit_from_tuner = False

    @property
    def rep(self):
        """The L0 block on the mesh's first device (None without one)."""
        return self.reps.get(self.device)

    @property
    def _quantized(self) -> bool:
        return self.storage_dtype == torch.int8

    def _plan_split(self, n: int, f: int, itemsize: int, quantized: bool,
                    num_shards: int) -> tuple[int, int]:
        """(rep_rows, hot_rows) from the two per-device byte budgets."""
        if quantized:
            # the (N,) f32 scales live on the device for every tier: charge
            # their 4N bytes first, the sharded budget first, any shortfall
            # out of the replicate budget, then spend the rest on 1 B codes
            scale_bytes = 4 * n
            combined = self.cache_budget + self.replicate_budget
            if 0 < combined < scale_bytes:
                # not even the scales fit: a cold-only store (exact)
                info_once(
                    "sharded-int8-budget-below-scale",
                    "ShardedFeature(int8): combined cache budget %d B is "
                    "smaller than the replicated dequant-scale array "
                    "(4 B x %d rows = %d B); degrading to a cold-only "
                    "store (exact, host-served). Grow device_cache_size "
                    "past 4*n bytes to enable device tiers.",
                    combined, n, scale_bytes, child="feature",
                )
                return 0, 0
            c_budget = self.cache_budget - scale_bytes
            r_budget = self.replicate_budget
            if c_budget < 0:
                r_budget = max(r_budget + c_budget, 0)
                c_budget = 0
            rep_rows = min(n, r_budget // f)
            hot_rows = min(n - rep_rows, (c_budget // f) * num_shards)
            return rep_rows, hot_rows
        row_bytes = f * itemsize
        rep_rows = min(n, self.replicate_budget // row_bytes)
        hot_rows = min(n - rep_rows, (self.cache_budget // row_bytes) * num_shards)
        return rep_rows, hot_rows

    def _place_region(self, region: torch.Tensor, rep_rows: int) -> None:
        """(Re)build the L0 and L1 tiers from the device region's rows;
        the first ``rep_rows`` are the L0 block."""
        total = region.shape[0]
        rep_rows = max(0, min(int(rep_rows), total))
        devices = dict.fromkeys(self.mesh.devices.ravel().tolist())
        self.reps = ({dev: region[:rep_rows].to(dev).contiguous() for dev in devices}
                     if rep_rows > 0 else {})
        if self.hot is not None:
            self.hot.delete()
        self.hot = (ShardedTensor(self.mesh, self.axis, kernel=self._kernel,
                                  routed_alpha=self.routed_alpha)
                    .from_cpu_tensor(region[rep_rows:]) if total > rep_rows else None)
        self.rep_rows = rep_rows
        self.hot_rows = total - rep_rows
        self._slice_scales()

    def _place_cold(self, rows) -> None:
        """Pin the cold rows on the host (UVA on a card)."""
        self.cold, self._cold_is_host = to_pinned_host(rows, self.device)
        self._slice_scales()

    def _slice_scales(self) -> None:
        """Give each tier the contiguous slice of ``scale`` that starts at
        its offset in the translated rows, on its devices: L0 at 0, shard
        ``d`` at ``rep_rows + d * rows_per_shard`` (zero-padded as its
        rows are), the cold rows at ``rep_rows + hot_rows``."""
        if self.scale is None:
            return
        end = self.rep_rows + self.hot_rows
        self._rep_scales = {dev: self.scale[:self.rep_rows].to(dev).contiguous()
                            for dev in self.reps}
        if self.hot is not None:
            self.hot.set_scale(self.scale[self.rep_rows:end])
        self._cold_scale = (None if self.cold is None
                            else self.scale[end:].contiguous())

    def from_cpu_tensor(self, tensor) -> "ShardedFeature":
        quantized = self._quantized
        if quantized:
            table = _numpy_rows(tensor)  # quantised on the host, as JAX's
            itemsize = table.dtype.itemsize
        else:
            table = _host_table(tensor)
            table = table.to(self.storage_dtype or table.dtype)
            itemsize = table.element_size()
        n, f = table.shape
        num_shards = self.mesh.shape[self.axis]
        rep_rows, hot_rows = self._plan_split(n, f, itemsize, quantized, num_shards)
        device_rows = rep_rows + hot_rows
        # the degree order whenever a tier boundary cuts [0, n): the L0
        # prefix holds the top-degree rows in order, the L1 span is shuffled
        if self.csr_topo is not None and 0 < device_rows and (
                device_rows < n or 0 < rep_rows < n):
            _, order = reorder_by_degree(
                np.empty((n, 0), np.float32), self.csr_topo.degree,
                device_rows / n, seed=self.hot_shuffle_seed, pin_top=rep_rows)
            perm = np.empty(n, dtype=np.int64)
            perm[order] = np.arange(n)
            table = table[perm] if quantized else table[torch.from_numpy(perm)]
            self.csr_topo.feature_order = order
            self.feature_order = torch.from_numpy(order).to(self.device)
        if quantized:
            codes, scale = quantize_rows_int8(table)  # after the reorder
            table = torch.from_numpy(codes)
            self.scale = torch.from_numpy(scale).to(self.device)
        self.shape = (n, f)
        self.dtype = table.dtype
        self._rep_ceiling_rows = rep_rows
        if device_rows > 0:
            region = table[:device_rows]
            if self.auto_split or self.replicate_budget > 0:
                self._region_host = region.clone()
            self._place_region(region, rep_rows)
        if device_rows < n:
            self._place_cold(table[device_rows:])
        # placement report (the reference's LOG>>> print)
        get_logger("feature").info(
            "feature tiers: %d/%d rows replicated (L0, %.1f MB/device), "
            "%d sharded over %d devices on mesh axis '%s' (%.1f MB/device); "
            "cold tier: %s",
            rep_rows, n, rep_rows * f * table.element_size() / 2**20,
            hot_rows, num_shards, self.axis,
            hot_rows * f * table.element_size() / num_shards / 2**20,
            "pinned host" if self._cold_is_host
            else ("none" if device_rows == n else "host"),
        )
        return self

    @property
    def last_tier_hits(self):
        """Per-tier hits ``[replicated, sharded, cold]`` of the last eager
        lookup (a view of the registry metric ``feature.tier_hits``)."""
        return self.metrics.value(TIER_HITS)

    @last_tier_hits.setter
    def last_tier_hits(self, value):
        self.metrics.set(TIER_HITS, value)

    @property
    def last_routed_overflow(self):
        """Fallback-served lanes of the L1's last routed gather (None
        before any)."""
        return None if self.hot is None else self.hot.last_routed_overflow

    @property
    def cache_ratio(self) -> float:
        """Fraction of the rows on the devices (L0 and L1)."""
        if not self.shape:
            return 0.0
        return (self.rep_rows + self.hot_rows) / self.shape[0]

    @property
    def replicated_ratio(self) -> float:
        return self.rep_rows / self.shape[0] if self.shape else 0.0

    def resplit(self, rep_rows: int) -> None:
        """Move the L0/L1 boundary to ``rep_rows`` (between batches). The
        translated rows stay where they are, so lookups return the same
        rows bitwise; only the path serving each row changes. Needs the
        host copy of the device region (``replicate_budget > 0`` or
        ``auto_split=True``)."""
        if self._region_host is None:
            if max(0, int(rep_rows)) == self.rep_rows:
                return  # a no-op split (a trainer passing budget 0)
            raise ValueError(
                "resplit needs the retained host region: construct "
                "ShardedFeature with replicate_budget > 0 or auto_split=True"
            )
        total = self._region_host.shape[0]
        rep_rows = max(0, min(int(rep_rows), total))
        if rep_rows == self.rep_rows:
            return
        self._place_region(self._region_host, rep_rows)
        # hits of the old boundary describe nothing now
        self.last_tier_hits = None
        if self._controller is not None and not self._resplit_from_tuner:
            # a manual move voids the tuner's direction history (its own
            # moves keep it: that history is the reversal dead-band)
            self._controller.split_tuner.reset()

    def resplit_budget(self, replicate_budget: int | str) -> None:
        """:meth:`resplit` with the boundary in bytes per device (as
        ``device_cache_size`` is given). Raises the L0 ceiling the
        ``auto_split`` tuner honours."""
        budget = parse_size_bytes(replicate_budget)
        row_bytes = self.shape[1] * torch.empty((), dtype=self.dtype).element_size()
        rows = budget // max(row_bytes, 1)
        self._rep_ceiling_rows = max(self._rep_ceiling_rows, rows)
        self.resplit(rows)

    def replan(self, mesh: Mesh) -> "ShardedFeature":
        """Re-place the three tiers onto another mesh shape (an elastic
        resume: a run checkpointed at F = 8 continuing at F = 4).

        The translated row space is kept as it is: ``feature_order``, the
        int8 ``scale`` and every row's bytes. Only the tier boundaries are
        planned again for the new feature-axis size (the same per-device
        budgets buy fewer sharded rows on a smaller mesh, and the spill
        goes to the cold tier), and the tiers (with their int8 scale
        slices) are placed again. Lookups therefore return the same rows
        bitwise, possibly over another tier. ``last_tier_hits`` is reset;
        a trainer re-binds through its own ``resume(mesh=)``."""
        if self.shape is None:
            raise ValueError("replan() before from_cpu_tensor()")
        n, f = self.shape
        num_shards = int(mesh.shape[self.axis])
        # the whole translated row space on the host: the device region
        # (the retained copy, or read back) and the cold rows
        region = self._device_region()
        full = torch.cat([region, self.cold.cpu()]) if self.cold is not None else region
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        rep_rows, hot_rows = self._plan_split(n, f, itemsize, self._quantized, num_shards)
        device_rows = rep_rows + hot_rows
        old_shards = self.mesh.shape[self.axis]
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        if self.feature_order is not None:
            self.feature_order = self.feature_order.to(self.device)
        if self.scale is not None:
            self.scale = self.scale.to(self.device)
        self.cold = None
        self._cold_is_host = False
        self._rep_ceiling_rows = rep_rows
        self._place_region(full[:device_rows], rep_rows)
        if device_rows < n:
            self._place_cold(full[device_rows:])
        self._region_host = (full[:device_rows].clone()
                             if self.auto_split or self.replicate_budget > 0 else None)
        # hits of the old mesh's tiers describe nothing now
        self.last_tier_hits = None
        get_logger("feature").info(
            "feature replan: %d -> %d shards on mesh axis '%s'; tiers now "
            "%d replicated / %d sharded / %d cold rows (same translated "
            "order — gathers stay bit-identical)",
            old_shards, num_shards, self.axis, rep_rows, self.hot_rows, n - device_rows,
        )
        return self

    def _device_region(self) -> torch.Tensor:
        """The device region's rows on the host: the retained copy, or
        the L0 block and the L1 shards read back."""
        if self._region_host is not None:
            return self._region_host
        parts = []
        if self.rep is not None:
            parts.append(self.rep.cpu())
        if self.hot is not None:
            parts.append(torch.cat([t.cpu() for t in self.hot.shards])[:self.hot_rows])
        if not parts:
            return torch.empty((0, self.shape[1]), dtype=self.dtype)
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def repin(self, rows) -> None:
        """Re-tier the store so ``rows`` (node ids, hottest first) hold the
        front of the translated rows: a measured hot set becomes the L0
        prefix, spilling into L1 when longer than ``rep_rows``.

        Tier sizes stay; rows move with their bytes and scales, and
        ``feature_order`` (and ``csr_topo.feature_order``) is composed with
        the move, so every lookup returns the same rows bitwise. Duplicate
        ids keep their first occurrence; ids past the device rows are
        ignored. Bumps ``version``: a trainer must ``refresh()``
        (:class:`~..control.CacheController` does it for its trainer)."""
        if self.shape is None:
            raise ValueError("repin() before from_cpu_tensor()")
        n, _f = self.shape
        device_rows = self.rep_rows + self.hot_rows
        if device_rows == 0:
            return  # a cold-only store: no device tier to pin into
        ids = _host(rows).reshape(-1).astype(np.int64)
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= n:
            raise ValueError(
                f"repin ids must be in [0, {n}); got range "
                f"[{ids.min()}, {ids.max()}]"
            )
        _, first = np.unique(ids, return_index=True)
        ids = ids[np.sort(first)][:device_rows]
        if self.feature_order is not None:
            old_order = _host(self.feature_order).astype(np.int64)
            t = old_order[ids]
        else:
            old_order = None
            t = ids
        # the move of the translated rows: the pinned set first, in order,
        # every other row keeping its relative order
        mask = np.ones(n, bool)
        mask[t] = False
        perm = np.concatenate([t, np.nonzero(mask)[0]])
        region = self._device_region()
        full = torch.cat([region, self.cold.cpu()]) if self.cold is not None else region
        new_full = full[torch.from_numpy(perm)]
        new_pos = np.empty(n, np.int64)
        new_pos[perm] = np.arange(n, dtype=np.int64)
        # node id -> old translated row -> new translated row
        new_order = new_pos if old_order is None else new_pos[old_order]
        new_scale = None if self.scale is None else self.scale.cpu()[torch.from_numpy(perm)]
        order_dtype = (_host(self.feature_order).dtype if old_order is not None
                       else np.int32 if n <= np.iinfo(np.int32).max else np.int64)
        new_order = new_order.astype(order_dtype, copy=False)
        # publish: the host state and one version bump, then the tiers
        self.version += 1
        self.feature_order = torch.from_numpy(new_order).to(self.device)
        if self.csr_topo is not None:
            self.csr_topo.feature_order = new_order
        if new_scale is not None:
            self.scale = new_scale.to(self.device)
        self._place_region(new_full[:device_rows], self.rep_rows)
        if self.cold is not None:
            self._place_cold(new_full[device_rows:])
        if self._region_host is not None:
            self._region_host = new_full[:device_rows].clone()
        # hits of the old order describe nothing now
        self.last_tier_hits = None
        get_logger("feature").info(
            "repin v%d: %d measured-hot rows pinned to the front of the "
            "device region (%d replicated / %d sharded rows; same bytes, "
            "recomposed order — gathers stay bit-identical)",
            self.version, ids.shape[0], self.rep_rows, self.hot_rows,
        )

    def apply_row_updates(self, ids, rows) -> None:
        """Update feature rows in every tier, all or nothing.

        ``ids`` are node ids (translated through ``feature_order``, as
        lookups are); ``rows`` the matching ``(U, feature_dim)`` float
        rows. Every new host array (the device region, the cold rows, the
        int8 scales) is built and checked aside, then published with one
        ``version`` bump and the tiers placed from it, so an updated L0
        row reads the new value on every device and its L1 copy agrees. A
        rejected update (a shape mismatch, ids out of range, duplicate
        ids, non-finite rows) raises ``ValueError`` and leaves the store
        bitwise as it was. int8 stores quantise the new rows and patch
        their scales in the same transaction."""
        if self.shape is None:
            raise ValueError("apply_row_updates() before from_cpu_tensor()")
        n, f = self.shape
        ids = _host(ids).reshape(-1).astype(np.int64)
        rows = _host(rows)
        if rows.ndim != 2 or rows.shape != (ids.shape[0], f):
            raise ValueError(
                f"rows must be ({ids.shape[0]}, {f}) to match ids/the "
                f"store's feature dim, got {rows.shape}"
            )
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= n:
            raise ValueError(
                f"update ids must be in [0, {n}); got range "
                f"[{ids.min()}, {ids.max()}]"
            )
        if np.unique(ids).shape[0] != ids.shape[0]:
            raise ValueError(
                "duplicate ids in one row-update transaction are ambiguous "
                "(which value wins?); collapse duplicates upstream — the "
                "streaming layer's duplicate policy does this at admission"
            )
        if np.issubdtype(rows.dtype, np.floating) and not np.isfinite(rows).all():
            raise ValueError(
                "row updates contain non-finite values; a poisoned row "
                "must be rejected at the boundary, not cached"
            )
        quantized = self._quantized
        # build every new array aside (nothing of the store changes yet)
        if self.feature_order is not None:
            t = _host(self.feature_order).astype(np.int64)[ids]
        else:
            t = ids
        if quantized:
            codes, row_scale = quantize_rows_int8(rows.astype(np.float32, copy=False))
            new_rows = torch.from_numpy(codes)
            new_scale = self.scale.cpu().numpy().copy()
            new_scale[t] = row_scale
        else:
            new_rows = torch.from_numpy(np.ascontiguousarray(rows)).to(self.dtype)
            new_scale = None
        device_rows = self.rep_rows + self.hot_rows
        in_region = t < device_rows
        new_region = None
        if device_rows > 0 and bool(in_region.any()):
            new_region = self._device_region().clone()
            new_region[torch.from_numpy(t[in_region])] = new_rows[torch.from_numpy(in_region)]
        new_cold = None
        if bool((~in_region).any()):
            new_cold = self.cold.cpu().clone()
            new_cold[torch.from_numpy(t[~in_region] - device_rows)] = \
                new_rows[torch.from_numpy(~in_region)]
        # publish: the host state and one version bump, then the tiers
        self.version += 1
        if new_scale is not None:
            self.scale = torch.from_numpy(new_scale).to(self.device)
        if new_region is not None:
            if self._region_host is not None:
                self._region_host = new_region
            self._place_region(new_region, self.rep_rows)
        if new_cold is not None:
            self._place_cold(new_cold)
        # hits of the old rows describe nothing now
        self.last_tier_hits = None
        get_logger("feature").info(
            "feature row update v%d: %d rows (%d device-region, %d cold)%s",
            self.version, ids.shape[0], int(in_region.sum()),
            int((~in_region).sum()),
            " + requantized scales" if quantized else "",
        )

    def note_degree_update(self, degree) -> None:
        """Hand post-mutation degrees to the split tuner, so the tiers
        follow a committed topology mutation.

        With a :class:`~..control.CacheController` attached, the degrees
        also seed its sketch as a low-weight prior. With ``auto_split=True``
        they become a synthetic per-tier hit mass (degree as heat, the
        initial placement's proxy) and the tuner moves the boundary at
        most once; without it, nothing more happens."""
        if self.shape is None:
            return
        if self._controller is not None:
            prior = _host(degree).reshape(-1)
            if prior.shape[0] == self.shape[0]:
                self._controller.observe_prior(prior)
        if not self.auto_split or self._region_host is None:
            return
        n, _ = self.shape
        degree = _host(degree).reshape(-1)
        if degree.shape[0] != n:
            raise ValueError(
                f"degree must have {n} entries, got {degree.shape[0]}"
            )
        if self.feature_order is not None:
            # scatter the degrees into translated row order
            deg_t = np.zeros(n, dtype=np.int64)
            deg_t[_host(self.feature_order).astype(np.int64)] = degree
        else:
            deg_t = degree.astype(np.int64)
        device_rows = self.rep_rows + self.hot_rows
        self.last_tier_hits = np.array(
            [deg_t[: self.rep_rows].sum(),
             deg_t[self.rep_rows: device_rows].sum(),
             deg_t[device_rows:].sum()],
        )
        self._maybe_auto_split()

    def _maybe_auto_split(self) -> None:
        """Between batches: hand the last measured tier hits to the
        attached controller's split tuner and move the L0/L1 boundary as
        it decides (``auto_split=True`` makes a default controller at the
        first call). The tuner halves ``rep_rows`` when L0 does not earn
        its copies, doubles it (up to the ceiling) when the hit mass sits
        just past the boundary, and waits for a reversal to repeat before
        it turns. Reads the previous batch's hits on the host."""
        hits = self.last_tier_hits
        if hits is None or self._region_host is None:
            return
        ctl = self._controller
        if ctl is None:
            if not self.auto_split:
                return
            from ..control import CacheController  # lazy: no import cycle

            ctl = CacheController.for_store(self)
        self.last_tier_hits = None
        h0, h1, _hc = (int(v) for v in _host(hits).reshape(-1))
        total = self._region_host.shape[0]
        ceiling = min(self._rep_ceiling_rows, total)
        new = ctl.decide_split(h0, h1, self.rep_rows, ceiling)
        if new is None or new == self.rep_rows:
            return
        get_logger("feature").info(
            "auto-split: L0 %d vs sharded %d hits; moving "
            "replicated/sharded boundary %d -> %d rows",
            h0, h1, self.rep_rows, new,
        )
        self._resplit_from_tuner = True
        try:
            self.resplit(new)
        finally:
            self._resplit_from_tuner = False

    def delete(self) -> None:
        """Free every tier now (the reference's ``shard_tensor.delete``)."""
        if self.hot is not None:
            self.hot.delete()
        self.reps = {}
        self.hot = self.cold = self.feature_order = self.scale = None
        self._rep_scales, self._cold_scale = {}, None
        self.rep_rows = self.hot_rows = 0
        self.last_tier_hits = None
        self._region_host = None

    def _tier_gathers(self, device):
        """The lookup's ``(rep, cold)`` gathers on ``device``: one K2
        launch each (``gather_rows``, or ``tiered_gather_dequant`` over
        int8 codes; the plain version for ``kernel="xla"``), the cold one
        reading the pinned rows over UVA."""
        rep = self.reps.get(device)
        rep_g = None if rep is None else _row_gather(rep, self.kernel,
                                                     self._rep_scales.get(device))
        cold_g = None if self.cold is None else _row_gather(self.cold, self.kernel,
                                                            self._cold_scale)
        return rep_g, cold_g

    def lookup(self, n_id, routed: bool = False, cap: int | None = None):
        """One feature group's lookup, as the fused trainer's step runs it.

        ``routed=False``: ``n_id`` is the group's shared id vector (the
        psum flavour). ``routed=True``: ``n_id`` is ``(F, L)``, one vector
        per member, and the L1 lanes are routed with bucket capacity
        ``cap`` (``None``: uncapped). Returns ``(rows, hits, overflow)``:
        the rows, the int32 per-tier hits (``(3,)``, or ``(F, 3)`` per
        member) and the group's fallback-served lanes (int32 scalar), all
        on ``n_id``'s device with no host read. K2 launches: one for the
        L0 lanes (with an L0), one per shard (with an L1), one for the cold
        lanes (with a cold tier)."""
        ov = [torch.zeros((), dtype=torch.int32, device=n_id.device)]
        if self.hot is None:
            hot_g = None
        elif routed:
            def hot_g(ids):
                rows, ov[0] = self.hot.routed_gather(ids, cap, with_overflow=True)
                return rows
        else:
            hot_g = self.hot.psum_gather
        rep_g, cold_g = self._tier_gathers(n_id.device)
        rows, hits = tiered_lookup(
            n_id, self.feature_order, self.hot_rows, hot_g, cold_g,
            rep_rows=self.rep_rows, rep_gather=rep_g, hot_miss_id=-1, with_hits=True)
        return rows, hits, ov[0]

    def gather(self, n_id, routed: bool = False, routed_cap="auto"):
        """Standalone three-tier lookup of a global id vector; the L1
        lanes through :meth:`ShardedTensor.gather` (``routed`` and
        ``routed_cap`` as there). With ``auto_split=True`` or a controller
        attached, the split tuner reads the previous call's hits first.
        After the call ``last_tier_hits`` holds its per-tier hits and
        ``last_routed_overflow`` the routed overflow."""
        if self.auto_split or self._controller is not None:
            self._maybe_auto_split()
        n_id = torch.as_tensor(n_id, device=self.device).reshape(-1)
        hot_g = None if self.hot is None else (
            lambda ids: self.hot.gather(ids, routed=routed, routed_cap=routed_cap))
        rep_g, cold_g = self._tier_gathers(n_id.device)
        out, hits = tiered_lookup(
            n_id, self.feature_order, self.hot_rows, hot_g, cold_g,
            rep_rows=self.rep_rows, rep_gather=rep_g, hot_miss_id=-1, with_hits=True)
        self.last_tier_hits = hits
        return out

    def __getitem__(self, n_id):
        """Rows of node ids (psum flavour); ``-1`` lanes give zero rows."""
        return self.gather(n_id)
