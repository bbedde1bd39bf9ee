"""MmapFeatureStore: feature rows on disk, lookups bitwise the in-RAM store.

The port of ``quiver_tpu/ooc/store.py``. The in-RAM
:class:`~..feature.feature.Feature` ends at host memory: its cold tier is a
pinned host table holding every row past the budget. This store pushes
that tail one tier down. The whole row table, after the degree reorder and
the int8 quantisation, lives on disk in the raw format
(:mod:`~.format`), and a lookup touches only the pages it needs:

* **hot tier**: translated rows ``[0, hot_rows)``, read into device memory
  once at open (the same bytes as ``Feature``'s hot tier);
* **host cold cache**: an optional set of promoted disk rows held in host
  memory (``host_cache_rows``; the cache controller restages it to the
  measured-hottest rows through :meth:`restage`);
* **disk tier**: every row, read in windows through an
  :class:`~.stager.AsyncStager`.

:meth:`write` makes ``Feature.from_cpu_tensor``'s decisions (the same
budget arithmetic, the same ``reorder_by_degree`` seed, quantisation after
the reorder), so both stores hold the same bytes. A lookup reads the ids
on the host, assembles the cold lanes' rows there (cache hits and staged
windows, lane-aligned, as the JAX package does), copies the block into a
pinned staging buffer reused from call to call, and merges it with the hot
rows in ONE launch of kernel K2 (``tiered_gather``, or
``tiered_gather_dequant`` for int8), which reads the staged rows over UVA.
The launch's ids make the staged block its cold table: a hot lane reads
its translated row ``t``, the cold lane ``j`` reads row ``hot_rows + j``
(row ``j`` of the block), a ``-1`` lane gives zeros. For int8 the scale
vector the kernel indexes by that row is the hot rows' scales followed by
each staged lane's own scale, so every lane is ``q[t] * scale[t]``, as the
in-RAM store's launch computes it: the rows are bitwise ``Feature``'s
(tests/test_torch_ooc.py). ``kernel="xla"`` runs the same merge in stock
torch ops (``stock_lookup``), as ``Feature`` does; on the CPU, where
``auto`` resolves to it, both are bitwise K2's plain version.

Lookups are eager (the host stages the bytes), which is the unfused
``DataParallelTrainer``/``Prefetcher`` path, the reference's papers100M
architecture.

``access="mmap"`` (default) maps the row table (``np.memmap``): resident
bytes O(touched pages), virtual bytes O(file). ``access="pread"`` maps
nothing and reads windows with ``os.pread``, so even the virtual address
space stays O(``cache_windows`` x window bytes). ``benchmarks/ooc_drill.py``
bounds that space; on a card the CUDA runtime's own reservation makes an
address-space limit unusable, so the resident growth is bounded instead.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..core.config import parse_size_bytes
from ..core.memory import resolve_device
from ..feature.feature import (
    KernelChoice,
    _numpy_rows,
    _parse_storage_dtype,
    quantize_rows_int8,
    stock_lookup,
    tiered_lookup,
    validate_gather_kernel,
)
from ..utils.reorder import reorder_by_degree
from ..utils.trace import get_logger, trace_scope
from .format import load_raw_dir, npy_data_offset, save_raw_dir
from .stager import AsyncStager

__all__ = ["MmapFeatureStore"]

_ACCESS_MODES = ("mmap", "pread")
_ROWS_KIND = "quiver-ooc-feature-rows"


class MmapFeatureStore(KernelChoice):
    """Open a :meth:`write`-prepared raw feature directory for lookups.

    Args:
      path: raw-format directory written by :meth:`write` (by either
        package).
      kernel: the lookup's path, as ``Feature``'s: ``"pallas"`` (K2's one
        launch), ``"xla"`` (stock torch ops) or ``"auto"``.
      access: ``"mmap"`` (``np.memmap`` window slices) or ``"pread"``
        (positioned reads, no file mapping).
      window_rows: rows per disk read (the readahead granularity).
      cache_windows: the stager's LRU capacity in windows.
      host_cache_rows: row budget of the promoted host cold cache (0: no
        cap; the cache controller fills it through :meth:`restage`).
      retries, backoff, backoff_cap, jitter, retry_seed: the stager's
        retry knobs (the Prefetcher's contract).
      metrics, timeline: a ``MetricsRegistry`` and a ``StepTimeline`` for
        the ``ooc.*`` counters and stages.
      device: the device of the hot tier and of lookups; CUDA unless the
        caller passes another.
    """

    def __init__(self, path: str, kernel: str = "auto",
                 access: str = "mmap", window_rows: int = 1024,
                 cache_windows: int = 32, host_cache_rows: int = 0,
                 retries: int = 0, backoff: float = 0.05,
                 backoff_cap: float = 2.0, jitter: float = 0.5,
                 retry_seed: int = 0, metrics=None, timeline=None, device=None):
        if access not in _ACCESS_MODES:
            raise ValueError(
                f"access must be one of {_ACCESS_MODES}, got {access!r}"
            )
        self.path = str(path)
        self._kernel = validate_gather_kernel(kernel)
        self.device = resolve_device(device)
        self.access = access
        self.metrics = metrics
        self.timeline = timeline
        # structural checks only: the manifest CRCs were computed at write
        # time and a full sweep would page the whole table in; run
        # ooc.verify_raw_dir(path) when the bytes are suspect
        arrays, meta = load_raw_dir(self.path, mmap=True, verify=False)
        if meta.get("kind") != _ROWS_KIND:
            raise ValueError(
                f"{path}: not a feature-rows raw dir "
                f"(kind={meta.get('kind')!r}); write one with "
                f"MmapFeatureStore.write()"
            )
        rows = arrays["rows"]
        n, f = rows.shape
        self.shape = (n, f)
        self._row_dtype = rows.dtype
        self.dtype = torch.from_numpy(np.empty(0, rows.dtype)).dtype
        self.hot_rows = int(meta["hot_rows"])
        self.cache_budget = int(meta.get("cache_budget", 0))
        # scale and feature_order are O(N) metadata, resident as Feature's
        # are (the O(graph) rows are what stays on disk)
        self.scale = None
        if "scale" in arrays:
            self.scale = torch.from_numpy(np.array(arrays["scale"], np.float32)).to(
                self.device)
        self.feature_order = self._order_np = None
        if "feature_order" in arrays:
            self._order_np = np.array(arrays["feature_order"])
            self.feature_order = torch.from_numpy(self._order_np).to(self.device,
                                                                      torch.int32)
        self.hot = None
        if self.hot_rows > 0:
            self.hot = torch.from_numpy(np.array(rows[:self.hot_rows])).to(
                self.device).contiguous()
        self._cold_rows = n - self.hot_rows
        self._rows_mm = None
        self._fd = -1
        self._data_offset = 0
        rows_path = os.path.join(self.path, "rows.npy")
        if access == "mmap":
            self._rows_mm = rows
        else:
            _, _, self._data_offset = npy_data_offset(rows_path)
            self._fd = os.open(rows_path, os.O_RDONLY)
        # the promoted host cold cache: sorted cold-local row ids and their
        # rows, restaged by the controller between batches
        self.host_cache_rows = int(host_cache_rows)
        self._cache_ids = np.empty(0, np.int64)
        self._cache_block = None
        self.cold_cache_hits_total = 0
        # per thread (a Prefetcher's worker and the main thread may both
        # look up): the pinned staging buffers and the event of the last
        # launch that read them
        self._staging = threading.local()
        self.stager = None
        if self._cold_rows > 0:
            num_windows = -(-self._cold_rows // int(window_rows))
            self.stager = AsyncStager(
                self._read_window, num_windows=num_windows,
                window_rows=int(window_rows),
                cache_windows=int(cache_windows), retries=retries,
                backoff=backoff, backoff_cap=backoff_cap, jitter=jitter,
                retry_seed=retry_seed, metrics=metrics, timeline=timeline,
            )
        get_logger("ooc").info(
            "opened %s: %d rows x %d (%s, %s), hot=%d on %s, "
            "cold=%d on disk (window=%d rows, cache=%d windows), host "
            "cache budget=%d rows",
            path, n, f, self._row_dtype, access, self.hot_rows, self.device,
            self._cold_rows, int(window_rows), int(cache_windows),
            self.host_cache_rows,
        )

    # -- write side ----------------------------------------------------------

    @classmethod
    def write(cls, path: str, tensor, device_cache_size: int | str = 0,
              csr_topo=None, dtype=None, hot_shuffle_seed: int = 0) -> dict:
        """Prepare a raw feature directory from an in-memory table.

        Makes ``Feature.from_cpu_tensor``'s placement decisions (the same
        budget arithmetic, int8 charging the ``(N,)`` scales first; the
        same degree reorder at the same hot ratio and seed; quantisation
        after the reorder), then publishes the table (and ``scale`` /
        ``feature_order``) atomically in the raw format. A ``Feature``
        built from the same inputs and a store opened on this directory
        hold the same bytes in every tier. Sets ``csr_topo.feature_order``
        as ``Feature`` does. Storage is a numpy float dtype or ``"int8"``
        (a ``.npy`` file holds no bfloat16). Returns the manifest."""
        tensor = _numpy_rows(tensor)
        storage = _parse_storage_dtype(dtype)
        quantized = storage == torch.int8
        if storage == torch.bfloat16:
            raise ValueError(
                "MmapFeatureStore stores float rows in a numpy dtype or as "
                "'int8'; a .npy file holds no bfloat16"
            )
        if storage is not None and not quantized:
            np_dtype = torch.empty((), dtype=storage).numpy().dtype
            if tensor.dtype != np_dtype:
                tensor = tensor.astype(np_dtype)
        n, f = tensor.shape
        cache_budget = parse_size_bytes(device_cache_size)
        if quantized:
            hot_rows = min(n, max(cache_budget - 4 * n, 0) // f)
        else:
            hot_rows = min(n, cache_budget // (f * tensor.dtype.itemsize))
        order = None
        if csr_topo is not None and hot_rows < n:
            tensor, order = reorder_by_degree(
                tensor, csr_topo.degree, hot_rows / n, seed=hot_shuffle_seed
            )
            csr_topo.feature_order = order
        scale = None
        if quantized:
            tensor, scale = quantize_rows_int8(tensor)  # after the reorder
        arrays = {"rows": tensor}
        if scale is not None:
            arrays["scale"] = scale
        if order is not None:
            arrays["feature_order"] = order
        meta = {
            "kind": _ROWS_KIND,
            "shape": [int(n), int(f)],
            "storage_dtype": str(tensor.dtype),
            "hot_rows": int(hot_rows),
            "cache_budget": int(cache_budget),
            "hot_shuffle_seed": int(hot_shuffle_seed),
            "quantized": bool(quantized),
        }
        return save_raw_dir(path, arrays, meta)

    # -- disk access (the stager's worker thread) -----------------------------

    def _read_window(self, window: int) -> np.ndarray:
        """One window of cold-tier rows (cold-local row space), read on the
        host; runs on the stager's worker thread."""
        w = self.stager.window_rows
        lo = window * w
        hi = min(lo + w, self._cold_rows)
        if self.access == "mmap":
            return np.array(self._rows_mm[self.hot_rows + lo:self.hot_rows + hi])
        _n, f = self.shape
        row_bytes = f * self._row_dtype.itemsize
        offset = self._data_offset + (self.hot_rows + lo) * row_bytes
        nbytes = (hi - lo) * row_bytes
        buf = b""
        while len(buf) < nbytes:  # pread may return short on some file systems
            chunk = os.pread(self._fd, nbytes - len(buf), offset + len(buf))
            if not chunk:
                raise OSError(
                    f"{self.path}: short read at offset {offset} "
                    f"({len(buf)}/{nbytes} B)"
                )
            buf += chunk
        return np.frombuffer(buf, self._row_dtype).reshape(hi - lo, f)

    def _gather_cold(self, cold_local: np.ndarray) -> np.ndarray:
        """The lane-aligned cold block: host cache hits and staged disk
        reads."""
        out = None
        pending = np.ones(cold_local.shape, bool)
        if self._cache_ids.size:
            pos = np.searchsorted(self._cache_ids, cold_local)
            pos_c = np.minimum(pos, self._cache_ids.size - 1)
            hit = self._cache_ids[pos_c] == cold_local
            if hit.any():
                out = np.empty(cold_local.shape + self.shape[1:2], self._row_dtype)
                out[hit] = self._cache_block[pos_c[hit]]
                pending &= ~hit
                self.cold_cache_hits_total += int(hit.sum())
        if pending.any():
            block = self.stager.fetch(cold_local[pending])
            if out is None:
                out = np.empty(cold_local.shape + block.shape[1:], block.dtype)
            out[pending] = block
        return out

    # -- lookup --------------------------------------------------------------

    def _translate(self, ids: np.ndarray) -> np.ndarray:
        """Translated rows of host ids, the lookup's one translation: an
        id past the table reads the last id (as every K2 entry clamps),
        then ``feature_order``; ``-1`` lanes stay ``-1``."""
        t = np.minimum(np.where(ids >= 0, ids, 0), self.shape[0] - 1).astype(np.int64)
        if self._order_np is not None:
            t = self._order_np[t].astype(np.int64)
        return np.where(ids >= 0, t, -1)

    def _cold_local(self, t: np.ndarray) -> np.ndarray | None:
        """The JAX package's cold-tier routing of translated rows ``t``:
        each lane's cold-local row, row 0 on the lanes of another tier and
        on ``-1`` lanes (the cold-lane trick), so the assembled block is
        lane for lane what the in-RAM lookup reads."""
        if self._cold_rows <= 0:
            return None
        return np.where(t >= self.hot_rows, t - self.hot_rows, 0)

    def _buffers(self, lanes: int):
        """This thread's staging buffers for ``lanes`` lanes, pinned on a
        card: ``(cold rows, translated rows)``. Waits for the last launch
        that read them."""
        local = self._staging
        if getattr(local, "read", None) is not None:
            local.read.synchronize()
            local.read = None
        cap = getattr(local, "cap", 0)
        if cap < lanes:
            cap = max(lanes, 2 * cap)
            pin = self.device.type == "cuda"
            local.rows = torch.empty((cap, self.shape[1]), dtype=self.dtype, pin_memory=pin)
            local.t = torch.empty((cap,), dtype=torch.int32, pin_memory=pin)
            local.cap = cap
        return local.rows[:lanes], local.t[:lanes]

    def __getitem__(self, n_id):
        """Rows for (possibly padded, ``-1`` sentinel) node ids: ``-1``
        lanes give zero rows, int8 stores return float32; bitwise the
        in-RAM ``Feature``'s lookup. The host translates the ids once and
        stages the cold lanes' rows, then :meth:`merge` runs one K2 launch
        on the card."""
        ids = torch.as_tensor(n_id).reshape(-1).cpu().numpy()  # the host stages: one read
        lanes = ids.shape[0]
        t = self._translate(ids)
        cold_local = self._cold_local(t)
        block = None
        if cold_local is not None and lanes:
            with trace_scope("ooc_stage"):
                block = self._gather_cold(cold_local)
        with trace_scope("feature_gather"):
            rows_buf, t_buf = self._buffers(lanes)
            t_buf.numpy()[:] = t
            staged = None
            if block is not None:
                rows_buf.numpy()[:] = block
                staged = rows_buf
            out = self.merge(t_buf.to(self.device, non_blocking=True), staged)
            if self.device.type == "cuda":
                self._staging.read = torch.cuda.Event()
                self._staging.read.record(torch.cuda.current_stream(self.device))
            return out

    def merge(self, t, block=None):
        """The device half of :meth:`__getitem__`: the tier merge of one
        staged batch. ``t`` is the ``(B,)`` int32 translated rows on the
        store's device (:meth:`_translate`: ``-1`` on the lanes that read
        nothing); ``block`` the host-staged lane-aligned cold rows (row
        ``j`` for lane ``j``, what the stager assembles; in pinned memory
        on a card), or None for a store with no cold tier. One K2 launch
        (``kernel="pallas"``) over :meth:`_launch_args`, or the stock
        merge."""
        ids, staged, scale = self._launch_args(t, block)
        lookup = tiered_lookup if self.kernel == "pallas" else stock_lookup
        return lookup(ids, None, self.hot_rows, self.hot, staged, scale)

    def _launch_args(self, t, block):
        """``(ids, cold table, scale)`` of :meth:`merge`'s launch. The ids
        make the block its cold table: a hot lane reads its translated row,
        cold lane ``j`` row ``hot_rows + j``, a ``-1`` lane zeros; for int8
        the scales are the hot rows' followed by each cold lane's own, so
        every lane is ``q[t] * scale[t]``."""
        lane = torch.arange(t.shape[0], device=t.device, dtype=t.dtype)
        ids = torch.where(t >= 0, torch.where(t < self.hot_rows, t, self.hot_rows + lane), -1)
        staged = block if self._cold_rows > 0 else None
        scale = None
        if self.scale is not None:
            scale = self.scale[:self.hot_rows]
            if staged is not None:
                cold = torch.where(t >= self.hot_rows, t, self.hot_rows).to(torch.int64)
                scale = torch.cat([scale, self.scale[cold]])
        return ids, staged, scale

    def trace_lookup(self, batch: int):
        """The recorded program (``tools.audit.ir.Program``) of the tier
        merge one staged batch runs: :meth:`merge` on the ``(batch,)``
        translated rows of ids that span both tiers and a ``(batch, F)``
        staged block as operands (the JAX package's traced program has two
        arguments of the same shapes and dtypes), the hot
        rows, order and scales as state. No disk I/O: the example block is
        zeros, in pinned memory on a card. The program's ``fn`` is
        :meth:`merge`, to run again on a real staged block. This is the
        audit's ``mmap_tiered_gather`` target."""
        from ..tools.audit.ir import record

        batch = int(batch)
        n, f = self.shape
        t = self._translate(np.arange(batch) * 7 % n).astype(np.int32)
        operands = [torch.from_numpy(t).to(self.device)]
        if self._cold_rows > 0:
            operands.append(torch.zeros((batch, f), dtype=self.dtype,
                                        pin_memory=self.device.type == "cuda"))
        return record(self.merge, *operands, name="mmap_tiered_gather",
                      device=self.device.type)

    def prefetch(self, n_id) -> int:
        """Dispatch background disk reads for a FUTURE batch's cold rows
        (bounded; returns the reads issued). The overlap seam: call with
        batch t+1's ids while batch t trains."""
        ids = torch.as_tensor(n_id).reshape(-1).cpu().numpy()
        cold_local = self._cold_local(self._translate(ids))
        if cold_local is None or not ids.size:
            return 0
        return self.stager.prefetch(cold_local)

    # -- the promoted host cold cache (the cache controller's seam) ----------

    def restage(self, cold_local_ids) -> int:
        """Replace the host cold cache with ``cold_local_ids`` (cold-tier
        row space), reading newly promoted rows through the stager. Capped
        at ``host_cache_rows``; rows not in the new set drop back to the
        disk (their bytes never changed, so forgetting the copy is the
        demotion). Returns the resident row count."""
        ids = np.unique(np.asarray(cold_local_ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self._cold_rows)]
        if self.host_cache_rows > 0:
            ids = ids[:self.host_cache_rows]
        if ids.size == 0:
            self._cache_ids = np.empty(0, np.int64)
            self._cache_block = None
            return 0
        self._cache_block = self.stager.fetch(ids)
        self._cache_ids = ids
        return int(ids.size)

    @property
    def staged_ids(self) -> np.ndarray:
        """The host cache's members (cold-local row ids, sorted)."""
        return self._cache_ids

    # -- Feature's surface -----------------------------------------------------

    def size(self, dim: int) -> int:
        return self.shape[dim]

    @property
    def cache_ratio(self) -> float:
        return self.hot_rows / self.shape[0] if self.shape else 0.0

    def close(self) -> None:
        if self.stager is not None:
            self.stager.close()
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "MmapFeatureStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
