"""Tracing, timing and structured logging.

The port of ``quiver_tpu/utils/trace.py``:

- :func:`trace_scope` annotates a region on the profiler's timeline (a
  ``torch.profiler.record_function``) when tracing is enabled, through the
  ``QUIVER_ENABLE_TRACE`` environment variable or :func:`enable_trace`,
  and is a ``nullcontext`` otherwise, so a disabled scope costs one branch.
- :class:`Timer` is a wall-clock timer that logs its duration.
- :func:`get_logger` is the package logger under the ``quiver_tpu_torch``
  name; ``QUIVER_LOG_LEVEL`` opts into a ready-made stderr handler.
- :func:`info_once` / :func:`warn_once` log a message once per process per
  key.
- :func:`start_trace` / :func:`stop_trace` collect a ``torch.profiler``
  profile of the host and the card and write it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import torch

__all__ = [
    "enable_trace",
    "disable_trace",
    "trace_enabled",
    "trace_scope",
    "Timer",
    "get_logger",
    "info_once",
    "reset_once",
    "warn_once",
    "start_trace",
    "stop_trace",
]

_TRACE_ENV = "QUIVER_ENABLE_TRACE"
_enabled: bool | None = None  # None: consult the environment variable


def trace_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get(_TRACE_ENV, "0") not in ("", "0", "false", "False")


def enable_trace() -> None:
    """Turn trace scopes on for this process (overrides the env var)."""
    global _enabled
    _enabled = True


def disable_trace() -> None:
    global _enabled
    _enabled = False


def trace_scope(name: str):
    """A ``torch.profiler.record_function(name)`` when tracing is enabled,
    else a no-op ``nullcontext``."""
    if not trace_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Timer:
    """Wall-clock timer of a ``with`` block.

    >>> with Timer("sample") as t:
    ...     out = sampler.sample(seeds)

    logs ``[sample] 12.3 ms`` at exit (unless ``quiet``) and leaves the
    duration in ``t.seconds``. ``sync`` says what to wait for before the
    clock stops, as the JAX package's ``sync=`` array or pytree does:
    ``None`` or ``False`` nothing; ``True`` the current CUDA device (when
    there is one); a tensor, or a nested list, tuple or dict of tensors,
    each CUDA device its tensors sit on (CPU tensors are already done).
    ``registry=`` feeds the duration to an aggregator with an
    ``observe(name, seconds)`` method; ``metric=`` overrides the name fed
    to it.
    """

    def __init__(self, name: str, sync=None, quiet: bool = False,
                 registry=None, metric: str | None = None):
        self.name = name
        self.seconds = 0.0
        self._sync = sync
        self._quiet = quiet
        self._registry = registry
        self._metric = metric or name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is True:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        elif self._sync is not None and self._sync is not False:
            for dev in _cuda_devices(self._sync):
                torch.cuda.synchronize(dev)
        self.seconds = time.perf_counter() - self._t0
        if not self._quiet:
            get_logger().info("[%s] %.1f ms", self.name, self.seconds * 1e3)
        if self._registry is not None:
            self._registry.observe(self._metric, self.seconds)
        return False


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor or a nested list,
    tuple or dict of them; other leaves have nothing to wait for."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree))
    return set()


def get_logger(child: str | None = None) -> logging.Logger:
    """The package logger.

    Library-friendly by default: a NullHandler with propagation left on,
    so applications route and format its records through their own
    logging setup. ``QUIVER_LOG_LEVEL`` (e.g. INFO) opts into a stderr
    handler at that level for scripts; an invalid level is reported once
    and ignored.
    """
    logger = logging.getLogger("quiver_tpu_torch")
    if not logger.handlers:
        level = os.environ.get("QUIVER_LOG_LEVEL")
        if level:
            try:
                logger.setLevel(level)
            except ValueError:
                print(
                    f"quiver_tpu_torch: ignoring invalid QUIVER_LOG_LEVEL="
                    f"{level!r} (use DEBUG/INFO/WARNING/ERROR/CRITICAL "
                    "or an int); logging stays at the library default",
                    file=sys.stderr,
                )
                logger.addHandler(logging.NullHandler())
            else:
                h = logging.StreamHandler()
                h.setFormatter(logging.Formatter(
                    "%(asctime)s %(name)s %(levelname)s %(message)s"))
                logger.addHandler(h)
                logger.propagate = False
        else:
            logger.addHandler(logging.NullHandler())
    return logger.getChild(child) if child else logger


_ONCE_KEYS: set[str] = set()


def info_once(key: str, msg: str, *args, child: str | None = None) -> None:
    """Log ``msg`` at INFO level once per process per ``key`` (e.g. an
    argument accepted for API parity that does nothing)."""
    if key in _ONCE_KEYS:
        return
    _ONCE_KEYS.add(key)
    get_logger(child).info(msg, *args)


def warn_once(key: str, msg: str, *args, child: str | None = None) -> None:
    """Log ``msg`` at WARNING level once per process per ``key``."""
    if key in _ONCE_KEYS:
        return
    _ONCE_KEYS.add(key)
    get_logger(child).warning(msg, *args)


def reset_once() -> None:
    """Forget which keys :func:`info_once` / :func:`warn_once` have logged
    (for test fixtures, so log assertions do not depend on test order)."""
    _ONCE_KEYS.clear()


_PROFILE: list = []  # the running profile and its output path, if any


def start_trace(log_dir: str) -> None:
    """Enable trace scopes and start a ``torch.profiler`` profile of the
    host and, when there is one, the CUDA device; :func:`stop_trace`
    writes it to ``log_dir/trace.json`` (Chrome trace format, opened by
    Perfetto or ``chrome://tracing``)."""
    if _PROFILE:
        raise RuntimeError("a trace is already running; call stop_trace() first")
    enable_trace()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILE.extend([prof, os.path.join(log_dir, "trace.json")])


def stop_trace() -> str:
    """Stop the profile :func:`start_trace` began and write it; returns
    the trace file's path."""
    if not _PROFILE:
        raise RuntimeError("no trace is running; call start_trace() first")
    prof, path = _PROFILE
    _PROFILE.clear()
    prof.__exit__(None, None, None)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return path
