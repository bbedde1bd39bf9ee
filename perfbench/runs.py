"""What every loop (``perfbench/loops/<loop>.py``) shares: the ``Run`` it
hands back to the harness, and the device helpers around a window."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Run", "load_weights", "peak", "peak_reset", "program_csr", "sync"]


class Run(NamedTuple):
    t_start: float  # perf_counter at the window's start: set-up ends here
    values: dict  # end-to-end metric name -> value over the window (not setup_s)
    units: int  # steps, passes or requests completed in the window
    memory_peak_bytes: int
    records: dict  # what the per-layer readers read; "trace" the reduced trace or None
    check: dict  # what the loop's judge reads


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def program_csr(edges):
    """The program's host CSR over the benchmark's ``(2, E)`` edges (its
    native counting sort)."""
    from quiver_tpu_torch.core.topology import CSRTopo

    return CSRTopo(edge_index=edges.cpu().numpy())


def load_weights(model, weights: dict) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
