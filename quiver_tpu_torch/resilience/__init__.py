"""Resilience: checkpoint integrity, degraded-mode feature serving and
fault injection.

The port of ``quiver_tpu/resilience/`` so far: ``integrity.py`` (the
checksummed manifest and atomic-publish vocabulary, shared with the
flight recorder), the serving half of ``elastic.py``
(:class:`CircuitBreaker`, :class:`DegradedFeature`) and ``faults.py``
(:class:`FaultPlan` and its wrappers). The step guard and elastic resume
come with the trainers (ROADMAP A.10b/A.11).
"""

from .elastic import CircuitBreaker, DegradedFeature
from .faults import FaultPlan, FaultyFeature, FaultySampler, Preemption, TransientFault
from .integrity import CorruptCheckpoint

__all__ = ["CircuitBreaker", "CorruptCheckpoint", "DegradedFeature", "FaultPlan",
           "FaultyFeature", "FaultySampler", "Preemption", "TransientFault"]
