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

The JAX package elects its hot-tier gather kernel by measurement
(``kernel="auto"``); the port has one kernel per lookup, so ``kernel`` is
validated and ``"xla"``, the stock gather, is not ported on the card yet.
The reference's IPC methods are no-op shims, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import CachePolicy, parse_size_bytes, validate_kernel_arg
from ..core.memory import resolve_device, to_pinned_host
from ..core.topology import CSRTopo
from ..ops.kernels.gather import tiered_gather, tiered_gather_dequant
from ..utils.reorder import reorder_by_degree
from ..utils.trace import get_logger, info_once, trace_scope

__all__ = ["Feature", "HeteroFeature", "quantize_rows_int8", "tiered_lookup"]


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


def _numpy_rows(tensor) -> np.ndarray:
    """A host numpy view of a table given as an array or a tensor (bf16
    tensors widen to float32, which numpy can hold)."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tensor)


class Feature:
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
      kernel: ``"auto"`` or ``"pallas"`` (the hand-written K2) or ``"xla"``
        (raises on the card, see
        :func:`~..core.config.validate_kernel_arg`).
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
        self.kernel = validate_kernel_arg(kernel, self.device)
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
        n_id = torch.as_tensor(n_id, device=self.device)
        with trace_scope("feature_gather"):
            return tiered_lookup(n_id.reshape(-1), self.feature_order,
                                 self.hot_rows, self.hot, self.cold, self.scale)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    @property
    def cache_ratio(self) -> float:
        return self.hot_rows / self.shape[0] if self.shape else 0.0

    def delete(self) -> None:
        """Free the device and host buffers now (the reference's
        ``shard_tensor.delete``). The store is unusable after."""
        self.hot = self.cold = self.feature_order = self.scale = None
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
