"""quiver_tpu_torch.parallel: the mesh, the input pipeline, the train steps
and the trainers.

The JAX package's export table. Everything but the mesh resolves lazily,
as in the JAX package.
"""

from .mesh import MeshTopo, can_device_access_peer, init_p2p, make_mesh

__all__ = [
    "MeshTopo",
    "make_mesh",
    "init_p2p",
    "can_device_access_peer",
    "Batch",
    "Prefetcher",
    "init_model",
    "make_train_step",
    "make_eval_step",
    "DistributedTrainer",
    "DataParallelTrainer",
]

_LAZY = {
    "Batch": "pipeline",
    "Prefetcher": "pipeline",
    "init_model": "train",
    "make_train_step": "train",
    "make_eval_step": "train",
    "DistributedTrainer": "trainer",
    "DataParallelTrainer": "trainer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
