"""The out-of-core graph store: the disk tier below the feature ladder.

The port of ``quiver_tpu/ooc/``. The reference's UVA hierarchy ends at
host memory: a papers100M-class run assumes the whole CSR and every cold
feature row fit the host. This package adds a fourth storage tier below
the hot / cold ladder, the disk, without changing a lookup's bytes:

* :mod:`~.format`: the mmap-native on-disk layout, one uncompressed
  ``.npy`` per array with a CRC32 manifest and a COMMIT marker, published
  atomically (``resilience/integrity``'s discipline). ``CSRTopo.save(path,
  format="raw")`` and ``CSRTopo.load(path, mmap=True)`` ride it. A
  directory either package writes loads in the other, bitwise.
* :class:`~.store.MmapFeatureStore`: a disk-backed feature store whose
  lookups are bitwise the in-RAM ``Feature``'s: the staged cold rows and
  the device hot rows merge in one launch of kernel K2.
* :class:`~.stager.AsyncStager`: bounded background window reads with
  seeded retry and backoff, measured by ``ooc.stage_wait``,
  ``ooc.page_reads`` and ``ooc.readahead_hits``.

The cache controller closes the loop one tier further down: its sketch's
measured heat decides which disk rows earn promotion into the host cold
cache (``CacheController.maybe_promote``).
"""

from .format import (
    RAW_FORMAT,
    CorruptRawDir,
    load_raw_dir,
    quarantine_raw_dir,
    save_raw_dir,
    verify_raw_dir,
)
from .stager import AsyncStager
from .store import MmapFeatureStore

__all__ = [
    "AsyncStager",
    "CorruptRawDir",
    "MmapFeatureStore",
    "RAW_FORMAT",
    "load_raw_dir",
    "quarantine_raw_dir",
    "save_raw_dir",
    "verify_raw_dir",
]
