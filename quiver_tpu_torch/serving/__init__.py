"""Online inference over resident graph state.

The port of ``quiver_tpu/serving``: :class:`ServeLadder` (per-bucket
sample and forward programs, captured as CUDA graphs on the card and
replayed), :class:`DeadlineBatcher` (deadline-aware coalescing with
bounded-queue backpressure and SLO classes), :class:`EmbeddingRefresher`
(full-graph layer-wise tables kept fresh across topology mutations),
:class:`InferenceServer` composing them, :class:`AOTExecutableCache` (the
programs' cache: manifests on disk over the process's captured programs)
and :class:`ServingFleet` (N replicas over one store, controller and
cache, least-depth routing with failover).
"""

from .aot import AOTExecutableCache, program_fingerprint
from .coalesce import (
    PRIORITIES,
    DeadlineBatcher,
    ServeQueueFull,
    ServeRequest,
    ladder_buckets,
)
from .fleet import ServingFleet
from .ladder import ServeLadder
from .refresh import EmbeddingRefresher
from .server import InferenceServer

__all__ = [
    "AOTExecutableCache",
    "DeadlineBatcher",
    "EmbeddingRefresher",
    "InferenceServer",
    "PRIORITIES",
    "ServeLadder",
    "ServeQueueFull",
    "ServeRequest",
    "ServingFleet",
    "ladder_buckets",
    "program_fingerprint",
]
