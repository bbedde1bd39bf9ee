"""Typed runtime configuration: byte sizes, cache policy, sample mode.

The port's copy of ``quiver_tpu/core/config.py``, and the check of the
sampler's ``dedup=`` argument (the ``kernel=`` check lives with the
elections, ``ops/election.py``). The enums accept the reference's
spellings (``gpu``/``uva``, ``device_replicate``) so configurations carry
over unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import re

import torch

__all__ = ["parse_size_bytes", "resolve_platform_strategy", "CachePolicy",
           "SampleMode", "SamplerConfig", "validate_dedup"]

# the JAX package's reindex strategies; the port's one reindex is bitwise
# all three, so each (and "auto") runs it
_DEDUP_STRATEGIES = ("sort", "map", "scan", "auto")


def resolve_platform_strategy(env_var: str, choices, tpu_default: str,
                              other_default: str, device=None) -> str:
    """An environment override, else the platform's default strategy.

    ``env_var``, when set, forces one of ``choices`` (case-insensitive; a
    value outside them raises). Otherwise the default is the device's:
    ``tpu_default`` on a CUDA device (the argument keeps the JAX package's
    name and position: the accelerator's default) and ``other_default``
    elsewhere. ``device`` is a tensor, a device or its name; None means
    the current CUDA device when there is a card, else the CPU.
    """
    v = os.environ.get(env_var, "").strip().lower()
    if v:
        if v not in choices:
            raise ValueError(f"{env_var}={v!r} is not one of {tuple(choices)}")
        return v
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    return tpu_default if on_card else other_default


_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]*)\s*$")

_UNITS = {
    "": 1,
    "B": 1,
    "K": 2**10,
    "KB": 2**10,
    "M": 2**20,
    "MB": 2**20,
    "G": 2**30,
    "GB": 2**30,
    "T": 2**40,
    "TB": 2**40,
}


def parse_size_bytes(size: int | float | str) -> int:
    """Parse a human byte size like ``"0.9M"``, ``"3GB"`` or ``200``.

    K/KB/M/MB/G/GB/T/TB, case insensitive, with an optional fraction;
    plain numbers are bytes.
    """
    if isinstance(size, bool):
        raise TypeError("size must be a number or string, not bool")
    if isinstance(size, (int, float)):
        if size < 0:
            raise ValueError(f"size must be non-negative, got {size}")
        return int(size)
    m = _SIZE_RE.match(size)
    if not m:
        raise ValueError(f"cannot parse byte size {size!r}")
    value, unit = m.group(1), m.group(2).upper()
    if unit not in _UNITS:
        raise ValueError(f"unknown size unit {unit!r} in {size!r}")
    return int(float(value) * _UNITS[unit])


class CachePolicy(enum.Enum):
    """Hot-tier placement policy of the feature cache.

    ``DEVICE_REPLICATE`` keeps the hot rows in the device's memory
    (reference ``device_replicate``). Sharding the hot tier across cards
    is not ported yet.
    """

    DEVICE_REPLICATE = "device_replicate"

    @classmethod
    def parse(cls, value: "CachePolicy | str") -> "CachePolicy":
        if isinstance(value, cls):
            return value
        if value == "device_replicate":
            return cls.DEVICE_REPLICATE
        raise ValueError(
            f"unknown cache policy {value!r}; expected 'device_replicate'"
        )


class SampleMode(enum.Enum):
    """Where the graph topology lives during sampling.

    ``HBM`` keeps indptr/indices in device memory (reference ``GPU`` mode).
    ``HOST`` keeps the large ``indices`` array in pinned host memory, which
    the select kernel reads over UVA without a staging copy (reference
    ``UVA`` mode).
    """

    HBM = "hbm"
    HOST = "host"

    @classmethod
    def parse(cls, value: "SampleMode | str") -> "SampleMode":
        if isinstance(value, cls):
            return value
        aliases = {
            "gpu": cls.HBM,  # reference spelling
            "hbm": cls.HBM,
            "uva": cls.HOST,  # reference spelling
            "host": cls.HOST,
            "zero_copy": cls.HOST,
        }
        try:
            return aliases[value.lower()]
        except KeyError:
            raise ValueError(
                f"unknown sample mode {value!r}; expected one of {sorted(aliases)}"
            ) from None


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static-shape configuration of the multi-layer sampler: the fanouts
    ``sizes``, the padded batch ``seed_capacity``, one unique-node cap per
    layer ``frontier_caps`` and the topology's ``mode``."""

    sizes: tuple[int, ...]
    seed_capacity: int
    frontier_caps: tuple[int, ...]
    mode: SampleMode = SampleMode.HBM

    def __post_init__(self):
        if len(self.frontier_caps) != len(self.sizes):
            raise ValueError("frontier_caps must have one entry per layer")
        if self.seed_capacity <= 0:
            raise ValueError("seed_capacity must be positive")


def validate_dedup(dedup: str) -> str:
    """Check a sampler's ``dedup=`` request: ``sort``, ``map``, ``scan``
    or ``auto``; unknown names raise."""
    if dedup not in _DEDUP_STRATEGIES:
        raise ValueError(f"dedup must be one of {_DEDUP_STRATEGIES}, got {dedup!r}")
    return dedup
