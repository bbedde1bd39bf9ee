"""Typed runtime configuration: byte sizes, cache policy, sample mode.

The port's copy of ``quiver_tpu/core/config.py`` (the parts the serving
path reads), and the check of the sampler's ``dedup=`` argument (the
``kernel=`` check lives with the elections, ``ops/election.py``). The
enums accept the reference's spellings (``gpu``/``uva``,
``device_replicate``) so configurations carry over unchanged.
"""

from __future__ import annotations

import enum
import re

__all__ = ["parse_size_bytes", "CachePolicy", "SampleMode", "validate_dedup"]

# the JAX package's reindex strategies; the port's one reindex is bitwise
# all three, so each (and "auto") runs it
_DEDUP_STRATEGIES = ("sort", "map", "scan", "auto")

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


def validate_dedup(dedup: str) -> str:
    """Check a sampler's ``dedup=`` request: ``sort``, ``map``, ``scan``
    or ``auto``; unknown names raise."""
    if dedup not in _DEDUP_STRATEGIES:
        raise ValueError(f"dedup must be one of {_DEDUP_STRATEGIES}, got {dedup!r}")
    return dedup
