"""Deterministic fault injection: the chaos substrate.

The port of ``quiver_tpu/resilience/faults.py``. A :class:`FaultPlan`
describes, ahead of time and reproducibly, every fault a drill injects:

* **NaN feature rows** (``nan_feature_steps``): a trainer poisons the
  first ``nan_rows`` rows of the gathered feature block at the planned
  step indices, the shape of a corrupt batch reaching the loss.
* **Transient host faults** (``sampler_faults`` / ``feature_faults``):
  :meth:`FaultPlan.wrap_sampler` / :meth:`FaultPlan.wrap_feature` return
  wrappers that raise :class:`TransientFault` a planned number of times at
  planned batch indices, then succeed: the retrying
  :class:`~..parallel.pipeline.Prefetcher`'s test diet. A failed call
  never reaches the wrapped object, so the sampler's call order (and so
  the delivered batch stream) stays bitwise a fault-free run's.
* **Simulated preemption** (``preempt_at_step``): a trainer raises
  :class:`Preemption` once the planned step has run but before its work
  is checkpointed.

Plans are frozen; wrappers own all mutable retry state. Step indices
count train steps, batch indices the dispatches of the wrapped object.
:meth:`FaultPlan.chaos` derives a randomized but seeded plan, from the
same numpy draws as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "FaultPlan",
    "FaultySampler",
    "FaultyFeature",
    "Preemption",
    "TransientFault",
]


class TransientFault(RuntimeError):
    """Injected transient host-side failure (sampler or feature lookup)."""


class Preemption(RuntimeError):
    """Simulated preemption: the run dies at a planned step, after the
    step's work but before any checkpoint for it is written."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault schedule (see the module docstring).

    Args:
      nan_feature_steps: step indices whose gathered features get NaN rows.
      nan_rows: how many leading feature rows to poison per planned step.
      sampler_faults: ``{batch_index: consecutive_failures}`` for
        :meth:`wrap_sampler`: the batch fails that many times, then
        succeeds.
      feature_faults: the same, for :meth:`wrap_feature` row lookups.
      preempt_at_step: step index at which a trainer raises
        :class:`Preemption` (once per trainer), or None.
      seed: recorded provenance of :meth:`chaos`-derived plans.
    """

    nan_feature_steps: tuple[int, ...] = ()
    nan_rows: int = 4
    sampler_faults: Mapping[int, int] = dataclasses.field(default_factory=dict)
    feature_faults: Mapping[int, int] = dataclasses.field(default_factory=dict)
    preempt_at_step: int | None = None
    seed: int = 0

    def __post_init__(self):
        if self.nan_rows < 1:
            raise ValueError(f"nan_rows must be >= 1, got {self.nan_rows}")
        for name in ("sampler_faults", "feature_faults"):
            for idx, n in getattr(self, name).items():
                if idx < 0 or n < 1:
                    raise ValueError(
                        f"{name}[{idx}] = {n}: batch indices must be >= 0 "
                        "and failure counts >= 1"
                    )

    @classmethod
    def chaos(cls, seed: int, steps: int, nan_p: float = 0.0,
              transient_p: float = 0.0, max_transient: int = 2,
              nan_rows: int = 4,
              preempt_at_step: int | None = None) -> "FaultPlan":
        """A randomized plan from ``seed``: same seed, same plan (and the
        JAX package's plan). ``nan_p``/``transient_p`` are per-step
        probabilities; transient faults draw 1..``max_transient``
        consecutive failures."""
        rng = np.random.default_rng(seed)
        nan_steps = tuple(
            int(s) for s in np.nonzero(rng.random(steps) < nan_p)[0]
        )
        sampler_faults = {
            int(i): int(rng.integers(1, max_transient + 1))
            for i in np.nonzero(rng.random(steps) < transient_p)[0]
        }
        return cls(
            nan_feature_steps=nan_steps, nan_rows=nan_rows,
            sampler_faults=sampler_faults,
            preempt_at_step=preempt_at_step, seed=seed,
        )

    # -- step-indexed queries (trainer side) --------------------------------

    def injects_nan(self) -> bool:
        return bool(self.nan_feature_steps)

    def nan_at(self, step: int) -> bool:
        return step in self.nan_feature_steps

    def nan_mask(self, steps: int) -> np.ndarray:
        """bool ``(steps,)``: True where the gathered features get
        poisoned."""
        mask = np.zeros(steps, dtype=bool)
        for s in self.nan_feature_steps:
            if 0 <= s < steps:
                mask[s] = True
        return mask

    def preempts_in(self, lo: int, hi: int) -> bool:
        """True when the planned preemption step falls in ``[lo, hi)``."""
        return (self.preempt_at_step is not None
                and lo <= self.preempt_at_step < hi)

    # -- host-side wrappers (the Prefetcher's side) --------------------------

    def wrap_sampler(self, sampler) -> "FaultySampler":
        return FaultySampler(sampler, self.sampler_faults)

    def wrap_feature(self, feature) -> "FaultyFeature":
        return FaultyFeature(
            feature, self.feature_faults,
            nan_steps=self.nan_feature_steps, nan_rows=self.nan_rows,
        )


class _FaultBudget:
    """Mutable per-wrapper countdown of planned consecutive failures."""

    def __init__(self, faults: Mapping[int, int]):
        self._left = dict(faults)

    def check(self, idx: int, what: str) -> None:
        left = self._left.get(idx, 0)
        if left > 0:
            self._left[idx] = left - 1
            raise TransientFault(
                f"injected transient {what} failure at batch {idx} "
                f"({left - 1} more planned)"
            )


class FaultySampler:
    """Sampler wrapper: planned BATCHES raise :class:`TransientFault` the
    planned number of times, then succeed. A failed call never reaches the
    wrapped sampler, so its call order is kept and the recovered stream
    is bitwise a fault-free one.

    Batch identity is the ``seeds`` object: a retry re-enters with the
    SAME array (the Prefetcher's contract), a new batch arrives with a new
    one, so the batch index stays right even when a batch that keeps
    failing is dropped under ``skip_policy="skip"``."""

    def __init__(self, sampler, faults: Mapping[int, int]):
        self.sampler = sampler
        self._budget = _FaultBudget(faults)
        self._idx = 0
        self._last_seeds = None

    def sample(self, seeds):
        if self._last_seeds is not None and seeds is not self._last_seeds:
            self._idx += 1
        self._last_seeds = seeds
        self._budget.check(self._idx, "sampler")
        return self.sampler.sample(seeds)

    def __getattr__(self, name):
        return getattr(self.sampler, name)


class FaultyFeature:
    """Feature-store wrapper: planned LOOKUPS raise :class:`TransientFault`;
    ``{lookup_index: n}`` fails lookups ``index .. index+n-1`` (counted by
    attempt: a retried feature fault re-enters the whole dispatch and
    draws the sample again). Planned NaN steps poison the first
    ``nan_rows`` rows of the matching SUCCESSFUL lookup, in a clone of the
    rows on their own device."""

    def __init__(self, feature, faults: Mapping[int, int],
                 nan_steps: tuple[int, ...] = (), nan_rows: int = 4):
        self.feature = feature
        self._fail_idx: set[int] = set()
        for i, n in faults.items():
            self._fail_idx.update(range(i, i + n))
        self._nan_steps = set(nan_steps)
        self._nan_rows = int(nan_rows)
        self._calls = 0
        self._ok = 0

    def __getitem__(self, ids):
        idx = self._calls
        self._calls += 1
        if idx in self._fail_idx:
            raise TransientFault(
                f"injected transient feature failure at lookup {idx}"
            )
        rows = self.feature[ids]
        if self._ok in self._nan_steps:
            rows = torch.as_tensor(rows).clone()
            rows[: self._nan_rows] = float("nan")
        self._ok += 1
        return rows

    def __getattr__(self, name):
        return getattr(self.feature, name)
