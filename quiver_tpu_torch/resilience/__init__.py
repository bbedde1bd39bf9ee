"""Resilience: checkpoint integrity and degraded-mode feature serving.

The port of ``quiver_tpu/resilience/`` so far: ``integrity.py`` (the
checksummed manifest and atomic-publish vocabulary, shared with the
flight recorder) and the serving half of ``elastic.py``
(:class:`CircuitBreaker`, :class:`DegradedFeature`). The step guard, the
fault plans and elastic resume come with the trainers (ROADMAP A.10/A.11).
"""

from .elastic import CircuitBreaker, DegradedFeature
from .integrity import CorruptCheckpoint

__all__ = ["CircuitBreaker", "CorruptCheckpoint", "DegradedFeature"]
