"""Resilience: checkpoint integrity, degraded-mode feature serving, fault
injection and the non-finite step guard.

The port of ``quiver_tpu/resilience/`` so far: ``integrity.py`` (the
checksummed manifest and atomic-publish vocabulary, shared with the
flight recorder), ``elastic.py`` (:func:`worker_ordered_mean`, the
elastic trainer's fixed-order reduction that makes a resume across mesh
shapes bitwise; :class:`CircuitBreaker`, :class:`DegradedFeature`,
:func:`validate_resume_meta`), ``faults.py`` (:class:`FaultPlan` and its
wrappers) and ``guard.py`` (the non-finite step guard).
"""

from .elastic import (
    CircuitBreaker,
    DegradedFeature,
    validate_resume_meta,
    worker_ordered_mean,
)
from .faults import FaultPlan, FaultyFeature, FaultySampler, Preemption, TransientFault
from .guard import guard_verdict, guarded_update, nonfinite_count
from .integrity import CorruptCheckpoint

__all__ = ["CircuitBreaker", "CorruptCheckpoint", "DegradedFeature", "FaultPlan",
           "FaultyFeature", "FaultySampler", "Preemption", "TransientFault",
           "guard_verdict", "guarded_update", "nonfinite_count",
           "validate_resume_meta", "worker_ordered_mean"]
