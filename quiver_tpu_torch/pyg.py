"""PyG-style import path: ``from quiver_tpu_torch.pyg import
GraphSageSampler``, as the JAX package's ``quiver_tpu.pyg`` and the
reference's ``quiver.pyg`` subpackage (pyg/sage_sampler.py)."""

from .sampling.sampler import Adj, GraphSageSampler

__all__ = ["Adj", "GraphSageSampler"]
