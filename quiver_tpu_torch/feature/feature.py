"""Tiered feature store: a device-memory hot tier and a pinned host cold tier.

The port of ``quiver_tpu/feature/feature.py`` (``Feature`` and
``tiered_lookup``): a byte budget splits the table into hot rows, kept in
device memory, and cold rows, kept in pinned host memory. With a
``csr_topo`` the rows are first reordered by descending degree, so the hot
tier holds the high-degree nodes, and ``feature_order`` translates node
ids on lookup. A lookup is one launch of kernel K2's tiered entry
(``tiered_gather``): it translates the ids, picks the tier and reads each
row once, the hot tier from device memory and the cold tier straight from
pinned host memory over UVA (the reference's zero-copy design; the TPU had
to stage it).

Storage is float32 or bfloat16. Per-row int8 quantisation is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import CachePolicy, parse_size_bytes
from ..core.memory import resolve_device, to_pinned_host
from ..core.topology import CSRTopo
from ..ops.kernels.gather import tiered_gather
from ..utils.reorder import reorder_by_degree

__all__ = ["Feature", "tiered_lookup"]

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _parse_storage_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name in ("int8", "torch.int8"):
        raise NotImplementedError(
            "int8 (quantised) feature storage is not ported yet; use "
            "float32 or bfloat16"
        )
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"storage dtype must be float32 or bfloat16, got {dtype!r}"
        ) from None


def tiered_lookup(n_id, feature_order, hot_rows: int, hot, cold):
    """Rows for padded node ids from a hot and a cold tier.

    ``hot`` holds translated rows ``[0, hot_rows)`` and ``cold`` the rest
    (either may be None); ``feature_order`` (int32, or None) translates
    node ids to rows. ``-1`` lanes return zero rows. One K2 launch on the
    card (:func:`~..ops.kernels.gather.tiered_gather`).
    """
    return tiered_gather(n_id.to(torch.int32).contiguous(), feature_order,
                         hot_rows, hot, cold)


class Feature:
    """Tiered node-feature table.

    Args:
      device_cache_size: hot-tier byte budget ("0.9M", "3GB", int bytes).
      cache_policy: ``"device_replicate"``.
      csr_topo: enables the degree reorder; sets ``csr_topo.feature_order``.
      hot_shuffle_seed: shuffle seed of the hot prefix.
      dtype: storage dtype (None keeps the input's; "bfloat16" halves the
        bytes per row).
      device: the device of the hot tier and of lookups; CUDA unless the
        caller passes another.
    """

    def __init__(self, device_cache_size: int | str = 0,
                 cache_policy: str | CachePolicy = CachePolicy.DEVICE_REPLICATE,
                 csr_topo: CSRTopo | None = None, hot_shuffle_seed: int = 0,
                 dtype=None, device=None):
        self.device = resolve_device(device)
        self.cache_budget = parse_size_bytes(device_cache_size)
        self.cache_policy = CachePolicy.parse(cache_policy)
        self.csr_topo = csr_topo
        self.hot_shuffle_seed = hot_shuffle_seed
        self.storage_dtype = _parse_storage_dtype(dtype)
        self.hot = None
        self.cold = None
        self.feature_order = None
        self.hot_rows = 0
        self.shape = None
        self.dtype = None

    def from_cpu_tensor(self, tensor) -> "Feature":
        """Split, (optionally) reorder, and place the feature table."""
        table = torch.as_tensor(tensor).detach().cpu()
        dtype = self.storage_dtype or table.dtype
        table = table.to(dtype).contiguous()
        n, f = table.shape
        hot_rows = min(n, self.cache_budget // (f * table.element_size()))
        if self.csr_topo is not None and hot_rows < n:
            # only the permutation is needed: reorder an empty (n, 0) view
            _, order = reorder_by_degree(
                np.empty((n, 0), np.float32), self.csr_topo.degree,
                hot_rows / n, seed=self.hot_shuffle_seed,
            )
            perm = torch.empty(n, dtype=torch.int64)
            perm[torch.from_numpy(order).to(torch.int64)] = torch.arange(n)
            table = table[perm]
            self.csr_topo.feature_order = order
            # int32 once here, the width K2 reads it in
            self.feature_order = torch.from_numpy(order).to(self.device,
                                                            torch.int32)
        self.shape = (n, f)
        self.dtype = dtype
        self.hot_rows = int(hot_rows)
        if hot_rows > 0:
            self.hot = table[:hot_rows].to(self.device).contiguous()
        if hot_rows < n:
            self.cold, _ = to_pinned_host(table[hot_rows:], self.device)
        return self

    def __getitem__(self, n_id):
        """Rows for (possibly padded, -1 sentinel) node ids; invalid lanes
        return zero rows."""
        n_id = torch.as_tensor(n_id, device=self.device)
        return tiered_lookup(n_id.reshape(-1), self.feature_order,
                             self.hot_rows, self.hot, self.cold)

    def size(self, dim: int) -> int:
        return self.shape[dim]
