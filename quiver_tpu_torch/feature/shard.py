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
feature=2)``) every shard sits on that card; on a mesh of distinct devices
(``["cuda:0", "cpu"]``) each shard sits on its member's, the requests move
to it and its rows back to the requester's device. Each shard serves its
lanes with one launch of kernel K2's single-table entry (``gather_rows``)
on a card, its plain version on the host, the counterpart of the JAX
package's ``_hot_gather_fn``.

A lookup runs on the device its caller names (``lookup(..., device=)``: a
worker's slot, or a routed feature group's first member): the L0 block,
the translation order and the int8 scales are read from that device's
copies (the L0 block is placed on every distinct device; the order and
the scales are copied to a device at its first lookup and kept, keyed by
the device as the mesh lists it), the cold rows (pinned when the mesh
holds a card) from the host.

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
and then multiplies by the scales. Here the L0 and cold tiers each run
K2's dequantising entry (``tiered_gather_dequant``) over their table and
the contiguous slice of the scales that starts at their offset. The L1
shards, as JAX's, serve codes (``gather_rows``): both flavours sum them
(the psum) or exchange them (the routed flavour, whose ``all_to_all``
carries int8), and the requesters dequantise the summed or received
block in one launch. The rows stay bitwise JAX's: exactly one shard owns
a lane and every other shard answers zero codes, so the sum is the
owner's codes (a negative id reads a zero code and a zero scale), and the
kernel rounds each product once (``__fmul_rn``), as
``codes.astype(float32) * scale`` does.

``repin`` and ``apply_row_updates`` are transactions: every new host array
is built and checked aside, then published with one ``version`` bump and
the tiers placed again. The split tuner (``auto_split=True``, or an
attached :class:`~..control.CacheController`) moves the L0/L1 boundary
between batches from the measured tier hits.

On a world mesh (``parallel/mesh.py`` ``WorldMesh``, one process per
slot) each rank builds its own parts from the same ``from_cpu_tensor``
input: its own L1 shard (the one of its slot's feature coordinate), the L0
block on its device and the cold rows in its own pinned memory. The psum
is its ``local_gather`` followed by the ordered sum over its feature group
(int8: over the codes, then one ``tiered_gather_dequant``), the routed
flavour a world ``BucketRoute`` over the group, and the answers are bitwise
the logical mesh's. ``replan`` onto another world shape gathers the device
region over the old feature group (``world.all_gather``) and places the
rank's new parts. ``repin`` and ``apply_row_updates`` build the new order,
scales and rows on every rank from the same inputs (the device region is
the retained host copy, or gathered over the feature group, so every rank
of the group enters them together), and each rank places its own parts.
The split tuner reads tier hits that are the same on every rank: a
trainer's are summed over the world, and a standalone ``gather`` on a
world mesh takes the same global id vector on every rank (the psum form's
contract), whose hits each rank counts whole. Every rank then moves the
same boundary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..control.freq import _host
from ..core.config import CachePolicy, parse_size_bytes
from ..core.memory import to_pinned_host
from ..core.topology import CSRTopo
from ..obs.marks import collective
from ..obs.registry import ROUTED_OVERFLOW, TIER_HITS, MetricsRegistry
from ..ops.kernels.gather import (gather_rows, gather_rows_plain, tiered_gather_dequant,
                                  tiered_gather_plain)
from ..parallel import world
from ..parallel.mesh import (DATA_AXIS, FEATURE_AXIS, Mesh, axis_devices, is_world,
                             mesh_devices)
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
    ``d``'s device, ``shards[d]``. On a world mesh the rank holds only its
    own member's shard (``shards[0]``, member :attr:`member` of its group).
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
        # the world form: this rank's group over the axis and its place there
        self.group = mesh.group(axis) if is_world(mesh) else None
        self.member = None if self.group is None else self.group.index
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
        # int8 codes only: every row's float32 scale (padded as the rows
        # are), on the first member's device, which dequantises the codes,
        # and its copies on the other requesters' devices
        self.scale: torch.Tensor | None = None
        self._scales: dict = {}
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
        rows, or None) makes every gather dequantise the codes it sums or
        receives."""
        table = _host_table(tensor)
        n, f = table.shape
        rps = -(-n // self.num_shards)  # ceil
        padded = rps * self.num_shards
        if padded != n:
            table = torch.cat([table, table.new_zeros((padded - n, f))])
        held = (enumerate(self.member_devices) if self.group is None
                else [(self.member, self.device)])
        self.shards = [table[d * rps:(d + 1) * rps].to(dev).contiguous()
                       for d, dev in held]
        self.rows_per_shard = rps
        self.num_rows = n
        self.set_scale(scale)
        return self

    def set_scale(self, scale) -> None:
        """Take ``scale`` (``(N,)`` float32, the scales of the table's int8
        rows; None: the rows are not codes), padded with zeros as the rows
        are."""
        self._scales = {}
        if scale is None:
            self.scale = None
            return
        scale = torch.as_tensor(scale, dtype=torch.float32).reshape(-1)
        pad = self.rows_per_shard * self.num_shards - scale.shape[0]
        if pad:
            scale = torch.cat([scale, scale.new_zeros(pad)])
        self.scale = scale.to(self.device)

    def _scale_on(self, device):
        """The scales on ``device`` (copied there at its first request)."""
        if device == self.device:
            return self.scale
        if device not in self._scales:
            self._scales[device] = self.scale.to(device)
        return self._scales[device]

    @property
    def shape(self):
        return (self.num_rows, self.shards[0].shape[1])

    def local_gather(self, member: int, ids):
        """Shard ``member``'s stored rows (int8 codes for an int8 table) for
        the ids it owns, zero rows for every other id (and for ids below
        0): one K2 ``gather_rows`` launch on the shard."""
        rps = self.rows_per_shard
        mine = (ids >= 0) & (torch.div(ids, rps, rounding_mode="floor") == member)
        local = torch.where(mine, ids - member * rps, -1)
        if self.group is not None and member != self.member:
            raise ValueError(f"rank holds shard {self.member}, not {member}")
        world = self.group is not None
        shard = self.shards[0 if world else member]
        kernel = self.kernel_on(self.device if world else self.member_devices[member])
        return _row_gather(shard, kernel)(local.to(shard.device)).to(ids.device)

    def psum_gather(self, ids, device=None):
        """Rows of ``ids`` (any shape; every member requests the same ids):
        each shard's :meth:`local_gather`, summed in member order on the
        ids' device, then dequantised there (an int8 table) with the
        scales of ``device``, the mesh's name for it (default the first
        member's). On a world mesh: this rank's :meth:`local_gather`, then
        the ordered sum over its group."""
        if self.group is not None:
            out = world.ordered_sum(self.local_gather(self.member, ids), self.group,
                                    (self.axis,))
            return self._dequantise(ids, out)
        out = None
        for d in range(self.num_shards):
            part = self.local_gather(d, ids)
            out = part if out is None else out + part
        collective("psum", (self.axis,), out)
        return self._dequantise(ids, out, device)

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

    def routed_gather(self, ids, cap: int | None = None, with_overflow: bool = False,
                      device=None):
        """One feature group's routed gather: ``ids`` is ``(F, L)``, one
        request vector per member (any negative value marks an invalid
        lane, whose row is zero); each request travels to its owner and
        the row back (:class:`~..parallel.routing.BucketRoute`, one K2
        launch per shard). ``cap`` caps the buckets (``None``: uncapped);
        overflowed lanes are served by the fallback, exactly. Returns the
        ``(F, L, row)`` rows, and with ``with_overflow`` also the group's
        fallback-served lane count (int32 scalar, 0 when uncapped).

        An int8 table's codes ride the exchange (a quarter of the float
        rows' bytes, as in the JAX package), and the requesters dequantise
        the received block.

        The plan, the exchange's merge and the dequantisation run on the
        ids' device (``device`` names it, default the first member's);
        each owner serves on its shard's device.

        On a world mesh ``ids`` is this member's ``(L,)`` request vector
        and the rows come back ``(L, row)``; the overflow is the group's."""
        L = ids.shape[-1]
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
                            num_shards=self.num_shards, cap=cap, group=self.group)
        rows = self._dequantise(ids, route.exchange(self.local_gather), device)
        return (rows, route.overflow) if with_overflow else rows

    def _dequantise(self, ids, codes, device=None):
        """The int8 ``codes`` summed or received for ``ids`` (any shape) ->
        float32 rows: one K2 ``tiered_gather_dequant`` over the block, lane
        ``j`` reading block row ``j`` times its id's scale (the scales of
        ``device``, where the block lies; default the first member's); zero
        rows on invalid lanes. Rows that are not codes pass through."""
        if self.scale is None:
            return codes
        device = self.device if device is None else device
        flat = codes.reshape(-1, codes.shape[-1]).contiguous()
        valid = (ids >= 0).reshape(-1)
        lanes = flat.shape[0]
        lane = torch.where(valid, torch.arange(lanes, device=flat.device), -1)
        scale = torch.where(valid, self._scale_on(device)[ids.reshape(-1).clamp(min=0)],
                            0.0)
        deq = (tiered_gather_dequant if self.kernel_on(device) == "pallas"
               else tiered_gather_plain)
        rows = deq(lane.to(torch.int32), None, lanes, flat, None, scale)
        return rows.reshape(tuple(ids.shape) + (codes.shape[-1],))

    def delete(self) -> None:
        """Free the shards now (the reference's ``shard_tensor.delete``).
        The object is unusable after."""
        self.shards = []
        self.scale = None
        self._scales = {}
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
        if self.group is not None:
            return self._world_routed(ids, local_len, cap, n, pad)
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

    def _world_routed(self, ids, local_len: int, cap, n: int, pad: int):
        """:meth:`gather`'s routed flavour on a world mesh: this rank routes
        its chunk of the ids (the logical form's group ``g``, member ``f``
        chunk ``g * F + f``), then every rank's rows are gathered over the
        whole world in chunk order, and the groups' overflow summed."""
        mesh, F = self.mesh, self.num_shards
        other = DATA_AXIS if self.axis == FEATURE_AXIS else FEATURE_AXIS
        g = mesh.group(other).index
        chunk = ids[(g * F + self.member) * local_len:(g * F + self.member + 1) * local_len]
        rows, ov = self.routed_gather(chunk, cap, with_overflow=True)
        everyone = world.all_gather(rows, mesh.group(mesh.axis_names), mesh.axis_names)
        if self.axis != FEATURE_AXIS:
            # rank d * F' + f holds chunk f * D + d
            D, Fo = mesh.shape[DATA_AXIS], mesh.shape[FEATURE_AXIS]
            order = [d * Fo + f for f in range(Fo) for d in range(D)]
            everyone = everyone[order]
        self.last_routed_overflow = world.int_sum(ov, mesh.group(other), (other,))
        out = everyone.reshape(-1, rows.shape[-1])
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
        # (name, device) -> (the lead's tensor, its copy on device): the
        # order and the cold scales where a lookup runs off the lead
        self._copies: dict = {}
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

    def _on(self, name: str, device):
        """Attribute ``name`` (a tensor on the lead device, or None) on
        ``device``: itself there, else a copy made at the first request
        and kept until the attribute is replaced."""
        t = getattr(self, name)
        if t is None or device == self.device:
            return t
        hit = self._copies.get((name, device))
        if hit is None or hit[0] is not t:
            hit = self._copies[(name, device)] = (t, t.to(device))
        return hit[1]

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
        self._copies = {}
        self.reps = ({dev: region[:rep_rows].to(dev).contiguous()
                      for dev in mesh_devices(self.mesh)} if rep_rows > 0 else {})
        if self.hot is not None:
            self.hot.delete()
        self.hot = (ShardedTensor(self.mesh, self.axis, kernel=self._kernel,
                                  routed_alpha=self.routed_alpha)
                    .from_cpu_tensor(region[rep_rows:]) if total > rep_rows else None)
        self.rep_rows = rep_rows
        self.hot_rows = total - rep_rows
        self._slice_scales()

    def _place_cold(self, rows) -> None:
        """Pin the cold rows on the host (UVA on a card) when a slot of the
        mesh is a card."""
        self.cold, self._cold_is_host = to_pinned_host(rows, mesh=self.mesh)
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
        # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
        if self._region_host is None:
            if max(0, int(rep_rows)) == self.rep_rows:
                return  # a no-op split (a trainer passing budget 0)
            raise ValueError(
                "resplit needs the retained host region: construct "
                "ShardedFeature with replicate_budget > 0 or auto_split=True"
            )
        # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
        total = self._region_host.shape[0]
        rep_rows = max(0, min(int(rep_rows), total))
        if rep_rows == self.rep_rows:
            return
        # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
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
        a trainer re-binds through its own ``resume(mesh=)``.

        On a world mesh every rank calls it with a world mesh over the same
        processes: the device region comes from the retained host copy, or
        the L0 block and the L1 shards gathered over the old feature group
        (``world.all_gather``, the bytes verbatim), and the rank places its
        new L0, L1 and cold parts. The gather holds the whole device region
        on each rank for a moment (its host copy as well), which the
        widths the port trains at afford."""
        if is_world(self.mesh) != is_world(mesh):
            raise ValueError(
                f"replan moves a store within one form (world or logical), got "
                f"{self.mesh!r} -> {mesh!r}")
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
        # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
        if self.scale is not None:
            # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
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
        the L0 block and the L1 shards read back (on a world mesh, gathered
        over the feature group in member order)."""
        if self._region_host is not None:
            return self._region_host
        parts = []
        if self.rep is not None:
            parts.append(self.rep.cpu())
        if self.hot is not None:
            hot = self.hot
            if hot.group is None:
                shards = torch.cat([sh.cpu() for sh in hot.shards])
            else:
                # a world rank holds its own shard: the others' over its group
                shards = world.all_gather(hot.shards[0], hot.group, (hot.axis,),
                                          mark=False).flatten(0, 1)
            parts.append(shards[:self.hot_rows].cpu())
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
        (:class:`~..control.CacheController` does it for its trainer).
        On a world mesh every rank calls it with the same ``rows``."""
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
        their scales in the same transaction. On a world mesh every rank
        calls it with the same ``ids`` and ``rows``."""
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
        # graftlint: disable=stale-version-read -- the store's own state: ShardedFeature publishes its versions, it is no versioned consumer (its 'lookup' guard is a homonym)
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
        self._rep_scales, self._cold_scale, self._copies = {}, None, {}
        self.rep_rows = self.hot_rows = 0
        self.last_tier_hits = None
        self._region_host = None

    def _tier_gathers(self, device):
        """The lookup's ``(rep, cold)`` gathers on ``device`` (the mesh's
        name for it): one K2 launch each on a card (``gather_rows``, or
        ``tiered_gather_dequant`` over int8 codes; the plain version for
        ``kernel="xla"`` and on the host), the cold one reading the pinned
        rows over UVA."""
        rep = self.reps.get(device)
        kernel = self.kernel_on(device)
        rep_g = None if rep is None else _row_gather(rep, kernel,
                                                     self._rep_scales.get(device))
        cold_g = None if self.cold is None else _row_gather(
            self.cold, kernel, self._on("_cold_scale", device))
        return rep_g, cold_g

    def lookup(self, n_id, routed: bool = False, cap: int | None = None, device=None):
        """One feature group's lookup, as the fused trainer's step runs it.

        ``routed=False``: ``n_id`` is the group's shared id vector (the
        psum flavour). ``routed=True``: ``n_id`` is ``(F, L)``, one vector
        per member, and the L1 lanes are routed with bucket capacity
        ``cap`` (``None``: uncapped). Returns ``(rows, hits, overflow)``:
        the rows, the int32 per-tier hits (``(3,)``, or ``(F, 3)`` per
        member) and the group's fallback-served lanes (int32 scalar), all
        on ``n_id``'s device with no host read. ``device`` is the mesh's
        name for that device (default the lead's), whose copies of the L0
        block, the order and the scales the lookup reads. K2 launches: one for the
        L0 lanes (with an L0), one per shard (with an L1; int8: one more, the
        dequantisation of the summed or received codes), one for the cold
        lanes (with a cold tier)."""
        device = self.device if device is None else device
        ov = [torch.zeros((), dtype=torch.int32, device=n_id.device)]
        if self.hot is None:
            hot_g = None
        elif routed:
            def hot_g(ids):
                rows, ov[0] = self.hot.routed_gather(ids, cap, with_overflow=True,
                                                     device=device)
                return rows
        else:
            def hot_g(ids):
                return self.hot.psum_gather(ids, device)
        rep_g, cold_g = self._tier_gathers(device)
        rows, hits = tiered_lookup(
            n_id, self._on("feature_order", device), self.hot_rows, hot_g, cold_g,
            rep_rows=self.rep_rows, rep_gather=rep_g, hot_miss_id=-1, with_hits=True)
        return rows, hits, ov[0]

    def gather(self, n_id, routed: bool = False, routed_cap="auto"):
        """Standalone three-tier lookup of a global id vector; the L1
        lanes through :meth:`ShardedTensor.gather` (``routed`` and
        ``routed_cap`` as there). With ``auto_split=True`` or a controller
        attached, the split tuner reads the previous call's hits first.
        After the call ``last_tier_hits`` holds its per-tier hits and
        ``last_routed_overflow`` the routed overflow. On a world mesh every
        rank passes the same global ``n_id`` (the psum form's contract), so
        every rank counts the same hits and the tuner moves the same
        boundary."""
        if self.auto_split or self._controller is not None:
            self._maybe_auto_split()
        n_id = torch.as_tensor(n_id, device=self.device).reshape(-1)
        hot_g = None if self.hot is None else (
            lambda ids: self.hot.gather(ids, routed=routed, routed_cap=routed_cap))
        rep_g, cold_g = self._tier_gathers(self.device)
        out, hits = tiered_lookup(
            n_id, self.feature_order, self.hot_rows, hot_g, cold_g,
            rep_rows=self.rep_rows, rep_gather=rep_g, hot_miss_id=-1, with_hits=True)
        self.last_tier_hits = hits
        return out

    def __getitem__(self, n_id):
        """Rows of node ids (psum flavour); ``-1`` lanes give zero rows."""
        return self.gather(n_id)
