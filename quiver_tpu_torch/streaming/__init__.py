"""Transactional streaming graph mutation.

The port of ``quiver_tpu/streaming/``. Graphs mutate under traffic; the
resident state (the host CSR, its sharded placements, the three-tier
feature store, the trainers' and servers' placements) must follow without
a full rebuild and without ever exposing a half-applied update:

* :class:`DeltaBatch` and :func:`validate_delta` (``delta.py``): the
  ingestion boundary; a malformed batch is quarantined whole with a reason
  (``streaming.deltas_quarantined``), never partly applied.
* :class:`StreamingGraph` (``commit.py``): staging, commits at epoch
  boundaries (merge aside, verify, publish with one version bump), and a
  bitwise rollback on any failure before publish.
* Versioned invalidation: ``CSRTopo`` and ``ShardedFeature`` carry the
  committed versions, and their consumers raise
  :class:`VersionMismatchError` instead of serving stale reads until their
  ``refresh`` seams place the new state.
"""

from ..core.topology import VersionMismatchError
from .commit import (
    CommitAborted,
    CommitResult,
    QuarantineRecord,
    StreamingGraph,
    merge_csr,
    verify_merged_csr,
)
from .delta import DeltaBatch, DeltaRejected, validate_delta

__all__ = [
    "CommitAborted",
    "CommitResult",
    "DeltaBatch",
    "DeltaRejected",
    "QuarantineRecord",
    "StreamingGraph",
    "VersionMismatchError",
    "merge_csr",
    "validate_delta",
    "verify_merged_csr",
]
