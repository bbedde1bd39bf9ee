"""The cache controller: telemetry-driven placement and routing.

The port of ``quiver_tpu/control/controller.py``. It closes the loop from
telemetry to the knobs a store exposes, between batches or epochs (never
inside a captured program):

* **L0 membership**: re-tier the replicated tier to the measured hottest
  rows (``repin`` of a sharded store);
* **L0/L1 boundary**: move ``rep_rows`` toward the measured hit mass
  (:class:`SplitTuner`, with a reversal dead-band);
* **routed_alpha**: grow on overflow and shrink on sustained slack
  (:class:`AlphaTuner`).

Every decision is emitted as an audited JSONL record through the obs
exporters (each line a snapshot of the matching ``ctrl.*`` counter with
the decision's inputs and outputs merged in) and counted on the
controller's own registry (``ctrl.decisions``, ``ctrl.repins``,
``ctrl.split_moves``, ``ctrl.alpha_changes``, ``ctrl.ooc_promotions``).

``frozen=True`` keeps the controller observing but returns no decisions
(the differential tests' parity mode).

All controller state is on the host (the sketch, the tuners' hysteresis
counters, the decision counters), so it survives a server's ``refresh``
and a topology mutation. On one card the store is a plain ``Feature``:
the controller observes it, and :meth:`CacheController.maybe_repin`
(which needs a store with ``rep_rows > 0``) and
:meth:`CacheController.maybe_promote` (which needs ``restage``) act
once such stores are ported.
"""

from __future__ import annotations

import numpy as np

from ..obs.export import write_jsonl
from ..obs.registry import (
    CTRL_ALPHA_CHANGES,
    CTRL_DECISIONS,
    CTRL_OOC_PROMOTIONS,
    CTRL_REPINS,
    CTRL_SPLIT_MOVES,
    MetricsRegistry,
)
from ..utils.trace import get_logger
from .cost import CostModel, predicted_hit_rates
from .freq import FreqSketch, _host

__all__ = ["AlphaTuner", "CacheController", "SplitTuner"]


class AlphaTuner:
    """Two-sided ``routed_alpha`` tuner with a convergence floor.

    Grow: any fallback-served overflow doubles alpha (capped at F —
    full-length buckets), exactly the legacy one-sided rule. Shrink:
    ``shrink_after`` CONSECUTIVE clean batches halve it — overflow lanes
    are exact-but-slower, so slack is the only safe shrink signal.

    No-oscillation: when a shrink is punished (the very next signal is
    overflow), the regrown alpha becomes a FLOOR — the tuner never
    shrinks below a value the workload has already proven too small, so
    a constant workload converges instead of cycling shrink/regrow
    (pinned by tests/test_controller.py).
    """

    def __init__(self, shrink_after: int = 4, floor: float = 0.25):
        self.shrink_after = int(shrink_after)
        self.floor = float(floor)
        self._clean = 0
        self._shrunk_from: float | None = None

    def decide(self, overflow: int, alpha: float,
               ceiling: float) -> float | None:
        """New alpha, or None to keep. ``overflow`` is the previous
        batch's fallback-served lane total; ``ceiling`` the feature-axis
        size F (alpha >= F means full-length buckets)."""
        if overflow > 0:
            self._clean = 0
            if self._shrunk_from is not None:
                # a shrink was immediately punished: regrow AND pin the
                # floor there — this workload needs at least that alpha
                self.floor = max(self.floor, self._shrunk_from)
                self._shrunk_from = None
            if alpha >= ceiling:
                return None
            return min(alpha * 2.0, ceiling)
        self._clean += 1
        self._shrunk_from = None
        if self._clean >= self.shrink_after and alpha / 2.0 >= self.floor:
            self._clean = 0
            self._shrunk_from = alpha
            return alpha / 2.0
        return None


class SplitTuner:
    """L0/L1 boundary tuner: the store's measured-hit-mass rules plus a
    reversal dead-band.

    Signals (h0/h1 = replicated/sharded hits, dev = h0 + h1) are the
    proven ``_maybe_auto_split`` rules: shrink (halve ``rep_rows``) when
    ``h0 * 8 < dev`` (L0 not earning its F× HBM), grow (double, up to
    the budget ceiling) when ``h1 > h0`` (hit mass just beyond the
    boundary). The band between them is the existing dead band.

    New here: a REVERSAL dead-band — changing direction (grow after
    shrink or vice versa) requires the reversed signal on two
    consecutive invocations, while same-direction moves stay immediate.
    At the budget ceiling the legacy grow rule could alternate
    grow/shrink every batch on a workload sitting near the h1 == h0
    edge; one noisy batch can no longer turn the boundary around.
    """

    def __init__(self, confirm: int = 2):
        self.confirm = int(confirm)
        self._last_dir = 0   # -1 shrink, +1 grow, 0 none yet
        self._pending = 0    # consecutive sightings of a reversal signal

    def reset(self) -> None:
        """Forget direction history (a manual resplit moved the boundary
        out from under the tuner)."""
        self._last_dir = 0
        self._pending = 0

    def decide(self, h0: int, h1: int, rep_rows: int,
               ceiling: int) -> int | None:
        """New ``rep_rows``, or None to keep."""
        dev = h0 + h1
        if dev <= 0:
            return None
        if h0 * 8 < dev and rep_rows > 0:
            direction, new = -1, rep_rows // 2
        elif h1 > h0 and 0 < rep_rows < ceiling:
            direction, new = +1, min(rep_rows * 2, ceiling)
        else:
            self._pending = 0
            return None
        if self._last_dir and direction != self._last_dir:
            self._pending += 1
            if self._pending < self.confirm:
                return None
        self._pending = 0
        self._last_dir = direction
        return new if new != rep_rows else None


class CacheController:
    """Between-batch/epoch control plane over one feature store.

    Args:
      sketch: a :class:`~.freq.FreqSketch` (built
        lazily from the store's row count when omitted).
      cost: a :class:`~.cost.CostModel` (optional —
        decisions degrade to the raw telemetry rules without it; when
        present its predictions ride every audit record).
      frozen: observe but never decide (the parity/differential mode).
      decision_log: path (or writable file object) for the audited JSONL
        decision records; None = audit to counters/log only.
      heat_bins: width of the in-program row-heat histogram a trainer
        registers for this controller; 0 disables the traced feed (the
        sketch then only sees host-visible id streams).
      alpha_tuner / split_tuner: override the tuners.
      repin_min_gain: hysteresis for :meth:`maybe_repin` — re-tier only
        when the measured-hot set's predicted L0 hit share beats the
        current occupancy by at least this fraction (a repin republishes
        every tier, so marginal wins are not worth the retrace).
    """

    def __init__(self, sketch: FreqSketch | None = None,
                 cost: CostModel | None = None, *, frozen: bool = False,
                 decision_log=None, heat_bins: int = 256,
                 alpha_tuner: AlphaTuner | None = None,
                 split_tuner: SplitTuner | None = None,
                 repin_min_gain: float = 0.02, tracer=None,
                 recorder=None):
        self.sketch = sketch
        self.cost = cost
        self.frozen = bool(frozen)
        self.decision_log = decision_log
        # tracer/recorder seams: every audited decision lands as a
        # zero-duration span (subsystem "control") and a flight-recorder
        # ring note, so a postmortem bundle shows the placement decisions
        # leading up to the fault
        self.tracer = tracer
        self.recorder = recorder
        self.heat_bins = int(heat_bins)
        self.alpha_tuner = alpha_tuner if alpha_tuner is not None \
            else AlphaTuner()
        self.split_tuner = split_tuner if split_tuner is not None \
            else SplitTuner()
        self.repin_min_gain = float(repin_min_gain)
        self.metrics = MetricsRegistry()
        self.metrics.counter(
            CTRL_DECISIONS, unit="decisions",
            doc="control-plane decisions emitted (repins + boundary "
                "moves + alpha changes)",
        )
        self.metrics.counter(
            CTRL_REPINS, unit="repins",
            doc="L0 re-tiers to a measured-hottest row set",
        )
        self.metrics.counter(
            CTRL_SPLIT_MOVES, unit="moves",
            doc="L0/L1 boundary moves decided from measured hit mass",
        )
        self.metrics.counter(
            CTRL_ALPHA_CHANGES, unit="changes",
            doc="routed_alpha changes (grow on overflow OR shrink on "
                "sustained slack)",
        )
        self.metrics.counter(
            CTRL_OOC_PROMOTIONS, unit="restages",
            doc="disk-tier host-cache restages to a measured-hottest "
                "row set (out-of-core stores)",
        )
        self._counts = {CTRL_DECISIONS: 0, CTRL_REPINS: 0,
                        CTRL_SPLIT_MOVES: 0, CTRL_ALPHA_CHANGES: 0,
                        CTRL_OOC_PROMOTIONS: 0}
        self.decisions: list[dict] = []  # in-memory audit trail

    # -- construction helpers ------------------------------------------------

    @classmethod
    def for_store(cls, feature, **kwargs) -> "CacheController":
        """A controller sized to ``feature`` and attached to it — what
        the ``auto_split``/``auto_alpha`` compat shims build."""
        ctl = cls(**kwargs)
        ctl.attach(feature)
        return ctl

    def attach(self, feature) -> "CacheController":
        """Bind to a feature store: size the sketch to its row count and
        register as its split-decision delegate."""
        if self.sketch is None and getattr(feature, "shape", None):
            self.sketch = FreqSketch(
                feature.shape[0],
                num_bins=self.heat_bins if self.heat_bins > 0 else 256,
            )
        feature._controller = self
        return self

    @property
    def wants_heat(self) -> bool:
        """Whether a trainer should compile the in-program row-heat
        histogram feed for this controller."""
        return self.heat_bins > 0

    def _ensure_sketch(self, num_rows: int) -> FreqSketch:
        if self.sketch is None:
            self.sketch = FreqSketch(
                num_rows, num_bins=self.heat_bins if self.heat_bins > 0
                else 256,
            )
        return self.sketch

    # -- observation (always on, frozen or not) ------------------------------

    def observe_histogram(self, hist) -> None:
        """Fold an in-program heat histogram in (``feature.row_heat``
        from a step's recorded metrics pytree)."""
        if self.sketch is not None and hist is not None:
            self.sketch.observe_histogram(hist)

    def observe_serve(self, ids) -> None:
        """Fold a serve batch's gathered node ids in — the seam that
        lets the store re-tier under SERVING traffic."""
        if self.sketch is not None:
            self.sketch.observe_ids(ids)

    def observe_ids(self, ids, weight: float = 1.0) -> None:
        if self.sketch is not None:
            self.sketch.observe_ids(ids, weight)

    def observe_prior(self, weights) -> None:
        """Fold a per-node prior in (the streaming path's post-mutation
        degrees arrive here via ``note_degree_update``)."""
        w = _host(weights).reshape(-1)
        if w.size:
            self._ensure_sketch(w.size).observe_prior(w)

    # -- decisions ------------------------------------------------------------

    def decide_alpha(self, overflow: int, alpha: float,
                     ceiling: float) -> float | None:
        """Alpha decision from the previous batch's overflow total;
        audited when it changes anything."""
        if self.frozen:
            return None
        new = self.alpha_tuner.decide(int(overflow), float(alpha),
                                      float(ceiling))
        if new is None or new == alpha:
            return None
        self._audit(
            CTRL_ALPHA_CHANGES, "alpha",
            {"from": float(alpha), "to": float(new),
             "overflow": int(overflow),
             "direction": "grow" if new > alpha else "shrink",
             "floor": self.alpha_tuner.floor},
        )
        return new

    def decide_split(self, h0: int, h1: int, rep_rows: int,
                     ceiling: int) -> int | None:
        """L0/L1 boundary decision from measured tier hits; audited when
        it moves the boundary."""
        if self.frozen:
            return None
        new = self.split_tuner.decide(int(h0), int(h1), int(rep_rows),
                                      int(ceiling))
        if new is None:
            return None
        record = {"from": int(rep_rows), "to": int(new),
                  "h0": int(h0), "h1": int(h1)}
        if self.cost is not None and self.sketch is not None:
            record["predicted"] = self.cost.predict(
                self.sketch, new, rep_rows - new if new < rep_rows
                else 0, None,
            )
        self._audit(CTRL_SPLIT_MOVES, "split", record)
        return new

    def maybe_repin(self, feature, trainer=None) -> bool:
        """Re-tier L0 to the sketch's measured-hottest rows when the
        predicted hit-share gain clears the hysteresis band.

        Compares the heavy hitters' mass currently landing in L0 (their
        translated rows < ``rep_rows``) against the mass the top
        ``rep_rows`` hitters would land after a repin; repins — and
        refreshes ``trainer`` (a repin bumps the store version) — only
        when the gain exceeds ``repin_min_gain`` of the observed mass.
        Returns True when a repin was applied.
        """
        if self.frozen or self.sketch is None:
            return False
        rep_rows = int(getattr(feature, "rep_rows", 0))
        if rep_rows <= 0:
            return False
        hitters = self.sketch.state()["hitters"]
        if not hitters:
            return False
        total = sum(hitters.values())
        if total <= 0:
            return False
        order = feature.feature_order
        order = None if order is None else _host(order)
        ids = np.fromiter(hitters.keys(), np.int64, len(hitters))
        mass = np.fromiter(hitters.values(), np.float64, len(hitters))
        t = ids if order is None else order[ids].astype(np.int64)
        current = float(mass[t < rep_rows].sum())
        top = np.argsort(-mass, kind="stable")[:rep_rows]
        target = float(mass[top].sum())
        gain = (target - current) / total
        if gain < self.repin_min_gain:
            return False
        rows = ids[top]
        feature.repin(rows)
        self.split_tuner.reset()  # the boundary's contents moved
        if trainer is not None:
            trainer.refresh()
        self._audit(
            CTRL_REPINS, "repin",
            {"rep_rows": rep_rows, "pinned": int(rows.size),
             "hit_share_before": current / total,
             "hit_share_after": target / total, "gain": gain},
        )
        return True

    def maybe_promote(self, store) -> bool:
        """Restage an out-of-core store's host cold cache to the
        sketch's measured-hottest DISK rows.

        The disk-tier analogue of :meth:`maybe_repin`, one level down:
        heavy hitters whose translated rows fall past ``hot_rows`` live
        on disk; the top ``host_cache_rows`` of them by measured mass
        earn promotion into host RAM (``restage`` of an out-of-core
        store, the JAX package's ``MmapFeatureStore``), and rows that lost their heat spill
        back to disk-only by dropping out of the set (their bytes were
        never mutated — forgetting the copy IS the demotion). Same
        ``repin_min_gain`` hysteresis: the cache only moves when the
        promoted set's predicted hit mass beats the currently staged
        set's by the threshold, so noise cannot thrash the disk. Audited
        under ``ctrl.ooc_promotions``. Returns True when a restage was
        applied.
        """
        if self.frozen or self.sketch is None:
            return False
        budget = int(getattr(store, "host_cache_rows", 0))
        if budget <= 0 or not hasattr(store, "restage"):
            return False
        hitters = self.sketch.state()["hitters"]
        if not hitters:
            return False
        total = sum(hitters.values())
        if total <= 0:
            return False
        hot_rows = int(getattr(store, "hot_rows", 0))
        order = store.feature_order
        order = None if order is None else _host(order)
        ids = np.fromiter(hitters.keys(), np.int64, len(hitters))
        mass = np.fromiter(hitters.values(), np.float64, len(hitters))
        t = ids if order is None else order[ids].astype(np.int64)
        disk = t >= hot_rows  # hitters whose rows live past the HBM tier
        if not disk.any():
            return False
        cold_local = t[disk] - hot_rows
        cold_mass = mass[disk]
        top = np.argsort(-cold_mass, kind="stable")[:budget]
        target = float(cold_mass[top].sum())
        staged = store.staged_ids
        current = (
            float(cold_mass[np.isin(cold_local, staged)].sum())
            if staged.size else 0.0
        )
        gain = (target - current) / total
        if staged.size and gain < self.repin_min_gain:
            return False
        resident = store.restage(cold_local[top])
        record = {
            "budget": budget, "staged": resident,
            "hit_share_before": current / total,
            "hit_share_after": target / total, "gain": gain,
        }
        if self.cost is not None:
            record["predicted"] = self.cost.predict_disk(
                self.sketch, hot_rows, resident
            )
        self._audit(CTRL_OOC_PROMOTIONS, "ooc_promote", record)
        return True

    def end_epoch(self, feature=None, trainer=None) -> None:
        """Epoch-boundary hook: consider a re-tier on the epoch's
        accumulated heat — an L0 repin for in-RAM stores, a disk-to-host
        promotion for out-of-core ones — then EMA-decay the sketch
        toward the current traffic mix."""
        if feature is not None:
            if hasattr(feature, "restage"):
                self.maybe_promote(feature)
            else:
                self.maybe_repin(feature, trainer)
        if self.sketch is not None:
            self.sketch.decay()

    # -- audit ----------------------------------------------------------------

    def _audit(self, counter: str, decision: str, record: dict) -> None:
        for name in (counter, CTRL_DECISIONS):
            self._counts[name] += 1
            self.metrics.set(name, np.int32(self._counts[name]))
        entry = {"decision": decision, **record}
        self.decisions.append(entry)
        get_logger("ctrl").info("decision %s: %s", decision, record)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event(
                f"ctrl.{decision}", subsystem="control", **record
            )
        if self.recorder is not None:
            self.recorder.note(f"ctrl.{decision}", **record)
        if self.decision_log is not None:
            snap = self.metrics.snapshot(counter)
            write_jsonl([snap], self.decision_log, extra=entry)

    def stats(self) -> dict:
        """Host-side decision counters + sketch summary."""
        out = {name.split(".", 1)[1]: c for name, c in self._counts.items()}
        if self.sketch is not None:
            out["observed"] = self.sketch.observed
            out["heat_mass"] = self.sketch.total_mass
        return out
