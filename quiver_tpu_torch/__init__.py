"""quiver_tpu_torch: the PyTorch/CUDA port of quiver_tpu.

A second package beside the JAX one, laid out module for module like it
(``quiver_tpu_torch/ops/sample.py`` answers to ``quiver_tpu/ops/sample.py``).
Plain tensor code is PyTorch; each Pallas kernel of the JAX package is a
kernel written by hand for Hopper under ``ops/kernels/``. Entry points run
on CUDA unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run instead.
"""

from .control import AlphaTuner, CacheController, CostModel, FreqSketch, SplitTuner
from .core.config import CachePolicy, SampleMode, parse_size_bytes
from .core.hetero import HeteroCSRTopo, RelCSR
from .core.hetero_sharded import HeteroShardedTopology
from .core.sharded_topology import ShardedTopology
from .core.topology import CSRTopo, DeviceTopology, VersionMismatchError
from .datasets import GraphDataset, load_dataset, planted_partition
from .feature.feature import Feature, HeteroFeature
from .feature.shard import ShardedFeature, ShardedTensor
from .models.gat import GAT
from .models.gcn import GCN
from .models.gin import GIN
from .models.rgcn import RGCN
from .models.sage import GraphSAGE
from .obs import (
    FlightRecorder,
    MetricSnapshot,
    MetricsRegistry,
    StepTimeline,
    TelemetryEndpoint,
    Tracer,
    profile_epoch,
)
from .ooc import (
    RAW_FORMAT,
    AsyncStager,
    CorruptRawDir,
    MmapFeatureStore,
    load_raw_dir,
    quarantine_raw_dir,
    save_raw_dir,
    verify_raw_dir,
)
from .parallel.mesh import MeshTopo, can_device_access_peer, init_p2p, make_mesh
from .parallel.pipeline import Batch, Prefetcher
from .parallel.trainer import DataParallelTrainer, DistributedTrainer
from .resilience import (
    CircuitBreaker,
    CorruptCheckpoint,
    DegradedFeature,
    FaultPlan,
    Preemption,
    TransientFault,
)
from .sampling.dist import DistGraphSageSampler
from .sampling.dist_hetero import DistHeteroSampler
from .sampling.hetero import HeteroGraphSampler, HeteroLayer, HeteroSampleOutput
from .sampling.saint import (
    SAINTEdgeSampler,
    SAINTNodeSampler,
    SAINTRandomWalkSampler,
    saint_subgraph,
)
from .sampling.sampler import Adj, GraphSageSampler, SampleOutput
from .serving import (
    AOTExecutableCache,
    DeadlineBatcher,
    EmbeddingRefresher,
    InferenceServer,
    ServeQueueFull,
    ServeRequest,
    ServingFleet,
    program_fingerprint,
)
from .streaming import CommitAborted, DeltaBatch, DeltaRejected, StreamingGraph
from .utils.debug import show_tensor_info, tensor_info
from .utils.reorder import reorder_by_degree
from .utils.trace import Timer, enable_trace, get_logger, trace_scope

# the reference's name for the clique view of the devices
p2pCliqueTopo = MeshTopo

__all__ = [
    "AOTExecutableCache",
    "Adj",
    "AlphaTuner",
    "AsyncStager",
    "Batch",
    "CSRTopo",
    "CacheController",
    "CachePolicy",
    "Checkpointer",
    "CircuitBreaker",
    "CommitAborted",
    "CorruptCheckpoint",
    "CorruptRawDir",
    "CostModel",
    "DataParallelTrainer",
    "DeadlineBatcher",
    "DegradedFeature",
    "DeltaBatch",
    "DeltaRejected",
    "DeviceTopology",
    "DistGraphSageSampler",
    "DistHeteroSampler",
    "DistributedTrainer",
    "EmbeddingRefresher",
    "FaultPlan",
    "Feature",
    "FlightRecorder",
    "FreqSketch",
    "GAT",
    "GCN",
    "GIN",
    "GraphDataset",
    "GraphSAGE",
    "GraphSageSampler",
    "HeteroCSRTopo",
    "HeteroFeature",
    "HeteroGraphSampler",
    "HeteroLayer",
    "HeteroSampleOutput",
    "HeteroShardedTopology",
    "InferenceServer",
    "MeshTopo",
    "MetricSnapshot",
    "MetricsRegistry",
    "MmapFeatureStore",
    "Preemption",
    "Prefetcher",
    "RAW_FORMAT",
    "RGCN",
    "RelCSR",
    "SAINTEdgeSampler",
    "SAINTNodeSampler",
    "SAINTRandomWalkSampler",
    "SampleMode",
    "SampleOutput",
    "ServeQueueFull",
    "ServeRequest",
    "ServingFleet",
    "ShardedFeature",
    "ShardedTensor",
    "ShardedTopology",
    "SplitTuner",
    "StepTimeline",
    "StreamingGraph",
    "TelemetryEndpoint",
    "Timer",
    "Tracer",
    "TransientFault",
    "VersionMismatchError",
    "can_device_access_peer",
    "enable_trace",
    "get_logger",
    "init_p2p",
    "load_dataset",
    "load_raw_dir",
    "make_mesh",
    "p2pCliqueTopo",
    "parse_size_bytes",
    "planted_partition",
    "profile_epoch",
    "program_fingerprint",
    "quarantine_raw_dir",
    "reorder_by_degree",
    "saint_subgraph",
    "save_raw_dir",
    "show_tensor_info",
    "tensor_info",
    "trace_scope",
    "verify_raw_dir",
]


def __getattr__(name):
    # Checkpointer resolves lazily, as the JAX package's does
    if name == "Checkpointer":
        from .utils.checkpoint import Checkpointer

        return Checkpointer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
