"""Tiered feature store: a device-memory hot tier and a pinned host cold tier.

The port of ``quiver_tpu/feature/feature.py`` (``Feature``,
``tiered_lookup``, ``quantize_rows_int8`` and ``HeteroFeature``): a byte
budget splits the table into hot rows, kept in device memory, and cold
rows, kept in pinned host memory. With a ``csr_topo`` the rows are first
reordered by descending degree, so the hot tier holds the high-degree
nodes, and ``feature_order`` translates node ids on lookup. A lookup is
one launch of kernel K2's tiered entry (``tiered_gather``): it translates
the ids, picks the tier and reads each row once, the hot tier from device
memory and the cold tier straight from pinned host memory over UVA (the
reference's zero-copy design; the TPU had to stage it).

Storage is the input's float dtype, another float dtype (``"bfloat16"``
halves the bytes per row), or ``"int8"``: per-row absmax codes with an
``(N,)`` float32 scale array kept on the device for both tiers, which
``tiered_gather_dequant`` reads in the same one launch to return float32
rows. An id past the table reads the row of its last id, as the JAX
package's gathers clamp; ``-1`` lanes return zero rows.

``kernel=`` picks the lookup's path: ``"pallas"`` is kernel K2's one
launch, ``"xla"`` the same lookup in stock torch ops (:func:`stock_lookup`,
rows bitwise K2's, with the cold rows staged on the host), and ``"auto"``
is K2 on the card once its smoke passes (``GATHER_ELECTION``, the shared
``ops.election`` contract) and ``"xla"`` on the CPU. Unlike the JAX
package's, the card's ``auto`` measures nothing: the stock lookup runs no
port kernel and moves the cold rows' work to the host, so it is taken only
on request. The reference's IPC methods are no-op shims, as in the JAX
package.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.config import CachePolicy, parse_size_bytes
from ..core.memory import resolve_device, to_pinned_host
from ..core.topology import CSRTopo
from ..ops.election import KernelElection, validate_kernel_arg
from ..ops.kernels.gather import gather_rows, tiered_gather, tiered_gather_dequant
from ..utils.reorder import reorder_by_degree
from ..utils.trace import get_logger, info_once, trace_scope

__all__ = ["Feature", "GATHER_ELECTION", "HeteroFeature", "KernelChoice",
           "quantize_rows_int8", "resolve_gather_kernel", "stock_lookup",
           "tiered_lookup", "validate_gather_kernel"]


def _parse_storage_dtype(dtype):
    """None (keep the input's dtype), a float dtype, ``"bf16"`` /
    ``"bfloat16"``, or ``"int8"`` (per-row absmax quantisation, scales
    kept alongside). Other integer dtypes raise: a plain cast would
    truncate float features silently."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = str(dtype)
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name == "f32":
        return torch.float32
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt == np.dtype(np.int8):
        return torch.int8
    if dt is None or dt.kind != "f":
        raise ValueError(
            f"storage dtype must be a float dtype, 'bfloat16', or 'int8' "
            f"(quantized); got {dtype!r}"
        )
    return getattr(torch, dt.name)


def quantize_rows_int8(tensor: np.ndarray):
    """Per-row symmetric absmax int8 quantisation (numpy; bitwise the JAX
    package's).

    Returns ``(q (N, F) int8, scale (N,) float32)`` with
    ``row ~= q * scale[:, None]``; all-zero rows get scale 0 and
    dequantise to exact zeros. The worst error per element is scale / 2.
    """
    absmax = np.abs(tensor).max(axis=1).astype(np.float32)
    scale = absmax / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(
        np.round(tensor / safe[:, None]), -127, 127
    ).astype(np.int8)
    return q, scale


def tiered_lookup(n_id, feature_order, hot_rows: int, hot, cold, scale=None):
    """Rows for padded node ids from a hot and a cold tier.

    ``hot`` holds translated rows ``[0, hot_rows)`` and ``cold`` the rest
    (either may be None); ``feature_order`` (int32, or None) translates
    node ids to rows; ``scale`` (the ``(N,)`` float32 scales of int8 codes,
    or None) dequantises. ``-1`` lanes return zero rows; an id past the
    table reads the row of the last id. One K2 launch on the card
    (:func:`~..ops.kernels.gather.tiered_gather`, or
    :func:`~..ops.kernels.gather.tiered_gather_dequant` with ``scale``).
    """
    n_id = n_id.to(torch.int32).contiguous()
    if scale is None:
        return tiered_gather(n_id, feature_order, hot_rows, hot, cold)
    return tiered_gather_dequant(n_id, feature_order, hot_rows, hot, cold, scale)


def stock_lookup(n_id, feature_order, hot_rows: int, hot, cold, scale=None,
                 buf=None):
    """:func:`tiered_lookup` in stock torch ops (the ``kernel="xla"``
    path), rows bitwise K2's: clamp and translate on the ids' device, a
    host ``index_select`` of the cold rows (into the pinned buffer ``buf``
    when one is given), one ``non_blocking`` copy to the device, the hot
    rows' ``index_select``, the merge, and for int8 codes the multiply by
    their scales; zero rows on ``-1`` lanes."""
    n_id = n_id.to(torch.int32)
    dev = n_id.device
    n = hot_rows + (0 if cold is None else cold.shape[0])
    valid = n_id >= 0
    t = n_id.clamp(0, max(n - 1, 0)).to(torch.int64)
    if feature_order is not None:
        t = feature_order[t].to(torch.int64)
    if cold is None:
        rows = torch.index_select(hot, 0, t)
    else:
        sel = torch.nonzero(valid & (t >= hot_rows)).squeeze(1)
        cold_rows = (t[sel] - hot_rows).to(cold.device)  # waits on a card
        if hot is None:
            rows = torch.zeros((n_id.shape[0], cold.shape[1]),
                               dtype=cold.dtype, device=dev)
        else:
            rows = torch.index_select(hot, 0, t.clamp(max=hot_rows - 1))
        staged = None if buf is None else buf[:cold_rows.shape[0]]
        staged = torch.index_select(cold, 0, cold_rows, out=staged)
        rows[sel] = staged.to(dev, non_blocking=True)
    if scale is not None:
        rows = rows.to(torch.float32) * scale[t][:, None]
    return torch.where(valid[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=dev))


# -- kernel=auto election (ops/election.py) -----------------------------------


def validate_gather_kernel(kernel: str) -> str:
    """Argument check only; touches no device."""
    return validate_kernel_arg(kernel)


def resolve_gather_kernel(kernel: str, device) -> str:
    """Resolve the lookup's path on ``device``: explicit requests pass
    through; ``"auto"`` is ``"xla"`` off the card, and K2 (``"pallas"``)
    on a CUDA device after its bitwise smoke (``GATHER_ELECTION``; a
    failed smoke raises, ``QUIVER_GATHER_KERNEL=pallas|xla`` forces)."""
    return GATHER_ELECTION.resolve_request(kernel, device)


_PALLAS_GATHER_OK: bool | None = None


def _pallas_gather_usable(device) -> bool:
    """One-time smoke of K2 on ``device``: four rows of a 32 x 128 f32
    table, bitwise ``table[ids]``."""
    global _PALLAS_GATHER_OK
    if _PALLAS_GATHER_OK is None:
        table = torch.arange(32 * 128, dtype=torch.float32,
                             device=device).reshape(32, 128)
        ids = torch.tensor([3, 0, 31, 7], dtype=torch.int32, device=device)
        _PALLAS_GATHER_OK = bool(torch.equal(gather_rows(table, ids),
                                             table[ids.to(torch.int64)]))
    return _PALLAS_GATHER_OK


# The gather election has no measurement: on the card auto is K2 once its
# smoke passes. The rev bumps when K2 changes. The smoke callable defers
# the module-global lookup so tests can monkeypatch _pallas_gather_usable.
GATHER_ELECTION = KernelElection(
    "gather", env_var="QUIVER_GATHER_KERNEL", rev=1,
    smoke=lambda device: _pallas_gather_usable(device),  # noqa: PLW0108
    measure=None, log_child="feature",
)


class KernelChoice:
    """The lazy lookup-path choice of a store: ``_kernel`` holds the
    constructor's request verbatim, ``kernel`` resolves it on first use
    (never in a constructor) for the store's ``device``."""

    _kernel: str
    device: torch.device

    @property
    def kernel(self) -> str:
        resolved = getattr(self, "_kernel_resolved", None)
        if resolved is None:
            resolved = resolve_gather_kernel(self._kernel, self.device)
            self._kernel_resolved = resolved
        return resolved


def _numpy_rows(tensor) -> np.ndarray:
    """A host numpy view of a table given as an array or a tensor (bf16
    tensors widen to float32, which numpy can hold)."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tensor)


class Feature(KernelChoice):
    """Tiered node-feature table; the JAX package's constructor, with the
    port's ``device`` last.

    Args:
      rank, device_list: accepted for API parity and inert (the reference
        pins one CUDA device per process rank; here ``device`` places);
        a non-default value is logged once.
      device_cache_size: hot-tier byte budget ("0.9M", "3GB", int bytes).
        For int8 storage the ``(N,)`` float32 scales (4 B per row, on the
        device for both tiers) are charged first and the rest buys rows of
        F bytes.
      cache_policy: ``"device_replicate"``.
      csr_topo: enables the degree reorder; sets ``csr_topo.feature_order``.
      hot_shuffle_seed: shuffle seed of the hot prefix.
      kernel: ``"pallas"`` (K2's one launch), ``"xla"`` (the same lookup
        in stock torch ops, :func:`stock_lookup`) or ``"auto"`` (K2 on the
        card after its smoke, ``"xla"`` on the CPU; see
        :func:`resolve_gather_kernel`), resolved at the first lookup.
      dtype: storage dtype: None keeps the input's, a float dtype or
        ``"bfloat16"`` casts, ``"int8"`` quantises each row (lookups
        return float32).
      replicate_budget: the L0 budget of the JAX package's sharded store;
        a single-device store's hot tier is already replicated, so it is
        added to ``device_cache_size`` (logged once).
      device: the device of the hot tier and of lookups; CUDA unless the
        caller passes another.
    """

    def __init__(self, rank: int = 0, device_list=None,
                 device_cache_size: int | str = 0,
                 cache_policy: str | CachePolicy = CachePolicy.DEVICE_REPLICATE,
                 csr_topo: CSRTopo | None = None, hot_shuffle_seed: int = 0,
                 kernel: str = "auto", dtype=None,
                 replicate_budget: int | str = 0, device=None):
        self.rank = rank
        self.device_list = device_list or [0]
        if rank != 0 or (device_list is not None and list(device_list) != [0]):
            info_once(
                "feature-inert-parity-args",
                "Feature(rank=%r, device_list=%r) accepted for reference "
                "API parity but INERT: the device argument places the "
                "store; nothing reads these arguments",
                rank, device_list, child="feature",
            )
        self.cache_budget = parse_size_bytes(device_cache_size)
        self.replicate_budget = parse_size_bytes(replicate_budget)
        if self.replicate_budget:
            info_once(
                "feature-replicate-budget-folded",
                "Feature(device_replicate) already replicates its hot tier "
                "per device; replicate_budget=%d B folded into "
                "device_cache_size (one zero-comm tier)",
                self.replicate_budget, child="feature",
            )
            self.cache_budget += self.replicate_budget
        self.cache_policy = CachePolicy.parse(cache_policy)
        self.csr_topo = csr_topo
        self.hot_shuffle_seed = hot_shuffle_seed
        self.storage_dtype = _parse_storage_dtype(dtype)
        self.device = resolve_device(device)
        self._kernel = validate_gather_kernel(kernel)
        # per thread: the "xla" path's pinned buffer of cold rows
        self._staging = threading.local()
        self.hot = None
        self.cold = None
        self.feature_order = None
        self.scale = None  # (N,) float32 dequant scales (int8 storage only)
        self.hot_rows = 0
        self.shape = None
        self.dtype = None

    def from_cpu_tensor(self, tensor) -> "Feature":
        """Split, (optionally) reorder and quantise, and place the table."""
        quantized = self.storage_dtype == torch.int8
        if quantized:
            table = _numpy_rows(tensor)
            n, f = table.shape
            row_bytes = f
            # the (N,) f32 scales live on the device for both tiers: charge
            # their N * 4 bytes first, then spend the rest on 1 B codes
            hot_rows = min(n, max(self.cache_budget - 4 * n, 0) // row_bytes)
        else:
            table = torch.as_tensor(tensor).detach().cpu()
            table = table.to(self.storage_dtype or table.dtype).contiguous()
            n, f = table.shape
            row_bytes = f * table.element_size()
            hot_rows = min(n, self.cache_budget // row_bytes)
        if self.csr_topo is not None and hot_rows < n:
            # only the permutation is needed: reorder an empty (n, 0) view
            _, order = reorder_by_degree(
                np.empty((n, 0), np.float32), self.csr_topo.degree,
                hot_rows / n, seed=self.hot_shuffle_seed,
            )
            perm = np.empty(n, dtype=np.int64)
            perm[order] = np.arange(n)
            table = table[perm] if quantized else table[torch.from_numpy(perm)]
            self.csr_topo.feature_order = order
            # int32 once here, the width K2 reads it in
            self.feature_order = torch.from_numpy(order).to(self.device,
                                                            torch.int32)
        if quantized:
            codes, scale = quantize_rows_int8(table)  # after the reorder
            table = torch.from_numpy(codes)
            self.scale = torch.from_numpy(scale).to(self.device)
        self.shape = (n, f)
        self.dtype = table.dtype
        self.hot_rows = int(hot_rows)
        if hot_rows > 0:
            self.hot = table[:hot_rows].to(self.device).contiguous()
        cold_is_host = False
        if hot_rows < n:
            self.cold, cold_is_host = to_pinned_host(table[hot_rows:], self.device)
        # placement report (the reference's LOG>>> cache-% print)
        get_logger("feature").info(
            "%.2f%% of feature (%d/%d rows, %.1f MB) cached on %s "
            "(device_replicate); cold tier: %s",
            100.0 * hot_rows / max(n, 1), hot_rows, n,
            hot_rows * row_bytes / 2**20, self.device,
            "pinned host" if cold_is_host else ("none" if hot_rows == n else "host"),
        )
        return self

    @classmethod
    def from_numpy(cls, tensor, **kwargs) -> "Feature":
        return cls(**kwargs).from_cpu_tensor(tensor)

    def __getitem__(self, n_id):
        """Rows for (possibly padded, -1 sentinel) node ids; invalid lanes
        return zero rows, int8 stores return float32."""
        n_id = torch.as_tensor(n_id, device=self.device).reshape(-1)
        with trace_scope("feature_gather"):
            if self.kernel == "pallas":
                return tiered_lookup(n_id, self.feature_order, self.hot_rows,
                                     self.hot, self.cold, self.scale)
            buf = self._staging_rows(n_id.shape[0])
            rows = stock_lookup(n_id, self.feature_order, self.hot_rows,
                                self.hot, self.cold, self.scale, buf)
            if buf is not None:
                self._staging.copied = torch.cuda.Event()
                self._staging.copied.record(torch.cuda.current_stream(self.device))
            return rows

    def _staging_rows(self, rows: int):
        """This thread's pinned host buffer of at least ``rows`` cold rows
        for the ``"xla"`` path's copy, when the cold tier is pinned host
        memory read from a card; else None. A buffer is written on the
        host only after its last copy to the card (on whatever stream
        made it) has landed. Each thread has its own: two threads reading
        one store (a ``Prefetcher``'s worker and an evaluation on the main
        thread) would otherwise overwrite a buffer still being copied."""
        if (self.cold is None or self.device.type != "cuda"
                or self.cold.device.type != "cpu"):
            return None
        local = self._staging
        buf = getattr(local, "buf", None)
        if buf is None or buf.shape[0] < rows:
            local.buf = buf = torch.empty((rows, self.cold.shape[1]),
                                          dtype=self.cold.dtype, pin_memory=True)
            local.copied = None
        elif local.copied is not None:
            local.copied.synchronize()
        return buf

    def size(self, dim: int) -> int:
        return self.shape[dim]

    @property
    def cache_ratio(self) -> float:
        return self.hot_rows / self.shape[0] if self.shape else 0.0

    def delete(self) -> None:
        """Free the device and host buffers now (the reference's
        ``shard_tensor.delete``). The store is unusable after."""
        self.hot = self.cold = self.feature_order = self.scale = None
        self._staging = threading.local()
        self.hot_rows = 0

    # -- reference API shims (one process owns the store; IPC is a no-op) --

    def share_ipc(self):
        return self

    @classmethod
    def new_from_ipc_handle(cls, rank, handle):
        return handle

    @classmethod
    def lazy_from_ipc_handle(cls, handle):
        return handle


class HeteroFeature:
    """Per-node-type feature tables for heterogeneous graphs.

    A thin dict of :class:`Feature`: ``__getitem__`` takes a ``{type:
    n_id}`` dict and returns ``{type: rows}``; each type's table keeps its
    own tiering (budget, reorder, dtype).
    """

    def __init__(self, features: dict):
        self.features = dict(features)

    @classmethod
    def from_cpu_tensors(cls, tensors: dict, **feature_kwargs) -> "HeteroFeature":
        return cls({
            t: Feature(**feature_kwargs).from_cpu_tensor(arr)
            for t, arr in tensors.items()
        })

    def __getitem__(self, n_id_dict: dict) -> dict:
        return {t: self.features[t][ids] for t, ids in n_id_dict.items()}

    def size(self, node_type: str, dim: int) -> int:
        return self.features[node_type].size(dim)
