"""Resilience: checkpoint integrity, degraded-mode feature serving, fault
injection and the non-finite step guard.

The port of ``quiver_tpu/resilience/`` so far: ``integrity.py`` (the
checksummed manifest and atomic-publish vocabulary, shared with the
flight recorder), ``elastic.py`` without the cross-card reduction
(:class:`CircuitBreaker`, :class:`DegradedFeature`,
:func:`validate_resume_meta`), ``faults.py`` (:class:`FaultPlan` and its
wrappers) and ``guard.py`` (the non-finite step guard). The elastic
resume across mesh shapes comes with the elastic half (ROADMAP A.11d).
"""

from .elastic import CircuitBreaker, DegradedFeature, validate_resume_meta
from .faults import FaultPlan, FaultyFeature, FaultySampler, Preemption, TransientFault
from .guard import guard_verdict, guarded_update, nonfinite_count
from .integrity import CorruptCheckpoint

__all__ = ["CircuitBreaker", "CorruptCheckpoint", "DegradedFeature", "FaultPlan",
           "FaultyFeature", "FaultySampler", "Preemption", "TransientFault",
           "guard_verdict", "guarded_update", "nonfinite_count",
           "validate_resume_meta"]
