"""quiver_tpu_torch.utils: checkpoints, debugging, graph generation,
reordering and tracing.

The JAX package's export table, resolved lazily as there, but for
``honor_forced_platform`` (a JAX platform switch, not ported by design)
and ``start_trace`` / ``stop_trace`` (a profile of a block is
``obs.profile_epoch``).
"""

__all__ = [
    "Checkpointer",
    "show_tensor_info",
    "tensor_info",
    "generate_pareto_graph",
    "reorder_by_degree",
    "Timer",
    "trace_scope",
    "enable_trace",
    "disable_trace",
    "trace_enabled",
    "get_logger",
]

_LAZY = {
    "Checkpointer": "checkpoint",
    "show_tensor_info": "debug",
    "tensor_info": "debug",
    "generate_pareto_graph": "graphgen",
    "reorder_by_degree": "reorder",
    "Timer": "trace",
    "trace_scope": "trace",
    "enable_trace": "trace",
    "disable_trace": "trace",
    "trace_enabled": "trace",
    "get_logger": "trace",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
