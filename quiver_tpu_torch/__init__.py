"""quiver_tpu_torch: the PyTorch/CUDA port of quiver_tpu.

A second package beside the JAX one, laid out module for module like it
(``quiver_tpu_torch/ops/sample.py`` answers to ``quiver_tpu/ops/sample.py``).
Plain tensor code is PyTorch; each Pallas kernel of the JAX package is a
kernel written by hand for Hopper under ``ops/kernels/``. Entry points run
on CUDA unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run instead.
"""

from .core.config import CachePolicy, SampleMode, parse_size_bytes
from .core.topology import CSRTopo, DeviceTopology, VersionMismatchError
from .feature.feature import Feature
from .models.sage import GraphSAGE
from .sampling.sampler import Adj, GraphSageSampler, SampleOutput
from .serving.coalesce import DeadlineBatcher, ServeQueueFull, ServeRequest
from .serving.server import InferenceServer

__all__ = [
    "Adj",
    "CSRTopo",
    "CachePolicy",
    "DeadlineBatcher",
    "DeviceTopology",
    "Feature",
    "GraphSAGE",
    "GraphSageSampler",
    "InferenceServer",
    "SampleMode",
    "SampleOutput",
    "ServeQueueFull",
    "ServeRequest",
    "VersionMismatchError",
    "parse_size_bytes",
]
