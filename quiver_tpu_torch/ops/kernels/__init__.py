"""The hand-written CUDA kernels, their wrappers and plain versions."""


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by wrapper name (each wrapper
    adds one where it launches its kernel for CUDA tensors)."""
    from .fused import select, uniform_hop, weighted_hop, wselect
    from .gather import gather_rows, tiered_gather, tiered_gather_dequant

    return {f.__name__: f.launches for f in (
        select, uniform_hop, gather_rows, tiered_gather,
        tiered_gather_dequant, wselect, weighted_hop)}
