"""Profiler bracketing for a block of work (an epoch, a serving window).

The port of ``quiver_tpu/obs/profile.py``, over ``torch.profiler``.
``profile_epoch(log_dir)`` records the enclosed block's CPU activity, and
the card's when a CUDA device is available, brackets it under ``name``, and
force-enables ``trace_scope`` for its duration, so every
``StepTimeline.stage(...)`` and ``trace_scope(...)`` inside it lands as a
named slice on the host track, with the same stage names the host-side
report uses. The trace is written as Chrome trace-event JSON under
``log_dir``. The prior trace-enable state is restored on exit (a profiled
block must not leave tracing on).
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..utils import trace as _trace
from ..utils.trace import trace_scope

__all__ = ["profile_epoch"]


@contextlib.contextmanager
def profile_epoch(log_dir: str, name: str = "epoch"):
    """Profile the enclosed block; yields the ``torch.profiler.profile``.

    >>> with profile_epoch("/tmp/prof", "serve") as prof:
    ...     server.serve(nodes)

    writes ``log_dir/<name>.trace.json`` (open it in Perfetto) with the
    block under ``name`` and every inner stage annotated; the yielded
    profile's ``key_averages()`` gives time by kernel. CUDA activity is
    recorded when a CUDA device is available.
    """
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prev = _trace._enabled
    _trace.enable_trace()
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            with trace_scope(name):
                yield prof
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.trace.json"))
    finally:
        _trace._enabled = prev
