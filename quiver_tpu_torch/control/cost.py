"""Analytic cost model of the cache controller: predicted comm and hit-rate
surfaces.

The port of ``quiver_tpu/control/cost.py``, copied as it is (numpy only).

The controller's decisions (L0 split, ``routed_alpha``) trade HBM bytes
against interconnect lanes. This module predicts both sides of that
trade from the measured heat histogram, using the SAME lanes-per-hop
formulas ``bench_feature``/``bench_sampler`` emit (so a predicted number
and a scoreboard number are directly comparable), calibrated against
measured :class:`~..obs.timeline.StepTimeline` stage times:

* comm: a capped routed gather moves ``F * cap`` lanes per all_to_all
  hop with ``cap = ceil(alpha_eff * L / F)`` and
  ``alpha_eff = alpha * (1 - h0)`` — the measured L0 hit rate tightens
  the cap because L0 lanes enter the routed gather as -1 and occupy no
  bucket capacity (feature/shard.py comm model);
* hit rates: the positional heat histogram is monotone in the translated
  row index, so the mass below a candidate boundary IS the predicted
  tier hit mass (:func:`predicted_hit_rates`).

The model is deliberately analytic (closed-form, auditable — every
decision record carries its inputs) rather than learned; it only has to
RANK candidate configurations, and the ranking inputs are exact.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["CostModel", "predicted_hit_rates", "routed_lanes_per_hop"]


def routed_lanes_per_hop(local_len: int, num_shards: int,
                         alpha: float | None, h0: float = 0.0) -> dict:
    """Interconnect lanes one capped routed gather moves per all_to_all
    hop — the exact model ``bench_feature`` emits (lanes_per_hop =
    ``F * cap``, uncapped = ``F * L``, effective = ``alpha * L * (1-h0)``).

    ``alpha=None`` means the uncapped full-length buckets. ``h0`` is the
    measured (or predicted) L0 hit rate; L0 lanes are -1 in the routed
    gather and occupy no bucket capacity, so the planned cap tightens by
    ``(1 - h0)``.
    """
    L = int(local_len)
    F = max(int(num_shards), 1)
    uncapped = F * L
    if alpha is None:
        return {
            "cap": L, "lanes_per_hop": uncapped,
            "lanes_per_hop_uncapped": uncapped,
            "effective_lanes_per_hop": float(uncapped),
        }
    alpha_eff = max(float(alpha) * (1.0 - float(h0)), 1e-6)
    cap = max(1, min(int(math.ceil(alpha_eff * L / F)), L))
    return {
        "cap": cap,
        "lanes_per_hop": F * cap,
        "lanes_per_hop_uncapped": uncapped,
        "effective_lanes_per_hop": float(alpha) * L * (1.0 - float(h0)),
    }


def predicted_hit_rates(sketch, rep_rows: int, hot_rows: int) -> dict:
    """Per-tier hit-rate prediction at a CANDIDATE (rep_rows, hot_rows)
    boundary from the sketch's positional heat histogram.

    Because the histogram bins are monotone in the translated row index,
    the mass below ``rep_rows`` is the L0 hit mass that boundary WOULD
    have captured — no replay needed. Returns ``{hit_rep, hit_sharded,
    hit_cold}`` fractions (all zero before any observation).
    """
    total = sketch.total_mass
    if total <= 0:
        return {"hit_rep": 0.0, "hit_sharded": 0.0, "hit_cold": 0.0}
    m0 = sketch.bin_mass_below(rep_rows)
    m01 = sketch.bin_mass_below(rep_rows + hot_rows)
    return {
        "hit_rep": m0 / total,
        "hit_sharded": (m01 - m0) / total,
        "hit_cold": (total - m01) / total,
    }


class CostModel:
    """Predicted step cost as a function of (L0 split, routed_alpha).

    Decomposes a step into a comm-proportional part and a fixed part:
    ``t(split, alpha) ~= t_fixed + t_lane * lanes(split, alpha)``.
    :meth:`calibrate` anchors the two coefficients to a measured
    StepTimeline stage mean at the CURRENT configuration (the controller
    re-calibrates whenever it changes something, so the anchor tracks
    the store); :meth:`predict` evaluates candidates against the anchor.

    Args:
      local_len: per-device gather request length L (static lane width).
      num_shards: feature-axis size F.
      comm_fraction: share of the anchored stage time attributed to the
        routed gather's collectives at calibration time. The default is
        deliberately conservative (overlap and fusion hide comm; see
        the pipelined-epoch overlap_efficiency gauge) — the model only
        ranks candidates, and ranking is monotone in this knob.
    """

    def __init__(self, local_len: int, num_shards: int,
                 comm_fraction: float = 0.3):
        self.local_len = int(local_len)
        self.num_shards = max(int(num_shards), 1)
        self.comm_fraction = float(np.clip(comm_fraction, 0.0, 1.0))
        self._t_fixed = 0.0
        self._t_lane = 0.0
        self.calibrated = False
        self._t_window = 0.0    # exposed seconds per disk window read
        self._window_rows = 1
        self.disk_calibrated = False
        self._hbm_peaks = {}    # target name -> static per-device peak bytes
        self.hbm_calibrated = False

    def calibrate(self, timeline, stage: str = "step",
                  alpha: float | None = None, h0: float = 0.0) -> bool:
        """Anchor the coefficients to ``timeline``'s measured mean for
        ``stage`` at the current (alpha, h0) operating point. Returns
        False (model unchanged) when the stage has no samples yet."""
        stats = timeline.summary().get(stage)
        if stats is None or getattr(stats, "count", 0) == 0:
            return False
        mean_s = float(stats.mean)
        lanes = routed_lanes_per_hop(
            self.local_len, self.num_shards, alpha, h0
        )["lanes_per_hop"]
        self._t_lane = self.comm_fraction * mean_s / max(lanes, 1)
        self._t_fixed = mean_s - self._t_lane * lanes
        self.calibrated = True
        return True

    def predict(self, sketch, rep_rows: int, hot_rows: int,
                alpha: float | None) -> dict:
        """Predicted hit rates, lanes/hop, and (when calibrated) step
        seconds for a candidate ``(rep_rows, hot_rows, alpha)``."""
        hits = predicted_hit_rates(sketch, rep_rows, hot_rows)
        lanes = routed_lanes_per_hop(
            self.local_len, self.num_shards, alpha, hits["hit_rep"]
        )
        out = {**hits, **lanes, "rep_rows": int(rep_rows),
               "hot_rows": int(hot_rows),
               "alpha": None if alpha is None else float(alpha)}
        if self.calibrated:
            out["est_step_s"] = (
                self._t_fixed + self._t_lane * lanes["lanes_per_hop"]
            )
        return out

    # -- disk tier (quiver-ooc) ----------------------------------------------

    def calibrate_disk(self, timeline, stager,
                       stage: str = "ooc.stage_wait") -> bool:
        """Anchor the disk-read coefficient: EXPOSED seconds per window
        read, from the measured ``ooc.stage_wait`` stage total over the
        stager's issued window reads. Exposed (not raw read) time is the
        right unit — reads the :class:`~quiver_tpu.ooc.stager
        .AsyncStager` hid under compute cost the step nothing, and the
        controller is ranking promotions by step-time saved. Returns
        False (model unchanged) until a wait has been observed."""
        stats = timeline.summary().get(stage)
        reads = int(getattr(stager, "page_reads_total", 0))
        if stats is None or getattr(stats, "count", 0) == 0 or reads == 0:
            return False
        self._t_window = float(stats.total) / reads
        self._window_rows = max(int(getattr(stager, "window_rows", 1)), 1)
        self.disk_calibrated = True
        return True

    def predict_disk(self, sketch, hot_rows: int,
                     resident_rows: int = 0) -> dict:
        """Predicted per-step disk exposure for a candidate host-cache
        size. The sketch's heat mass ABOVE ``hot_rows + resident_rows``
        (translated row space: rows neither in HBM nor promoted to the
        host cache) is the miss mass that must come off disk; when
        :meth:`calibrate_disk` has run, that converts to estimated
        exposed seconds per observed step via the measured
        window-read cost."""
        total = sketch.total_mass
        resident = int(hot_rows) + int(resident_rows)
        if total <= 0:
            return {"miss_mass": 0.0, "hit_disk": 0.0,
                    "resident_rows": resident}
        below = sketch.bin_mass_below(resident)
        miss = max(total - below, 0.0)
        out = {
            "miss_mass": miss,
            "hit_disk": miss / total,
            "resident_rows": resident,
        }
        if self.disk_calibrated:
            # miss rows -> window reads (each window amortizes
            # window_rows rows in the best — staged-layout — case)
            out["est_disk_s_per_obs"] = (
                self._t_window * miss / total / self._window_rows
            )
        return out

    # -- peak memory (the program audit) ---------------------------------------

    def calibrate_hbm(self, peaks: dict) -> bool:
        """Anchor the per-target peak-memory surface from the program
        audit's estimates (``{target_name: peak_bytes}``, e.g. the
        ``peak_bytes`` column of :func:`~..tools.audit.mem.peak_table`).
        Unlike the timing coefficients these are not timed: each is the
        alloc/free walk of a recorded run of the target on small inputs,
        so a candidate the controller is ranking can be rejected for not
        fitting before it runs at scale. Returns False (model unchanged)
        on an empty mapping."""
        clean = {str(k): int(v) for k, v in dict(peaks).items()
                 if int(v) >= 0}
        if not clean:
            return False
        self._hbm_peaks.update(clean)
        self.hbm_calibrated = True
        return True

    def predict_hbm(self, target: str, budget_bytes: int | None = None
                    ) -> dict:
        """Predicted per-device peak bytes for ``target`` against an
        optional budget. ``known`` is False for a target the model has
        not been calibrated with (``fits`` stays None rather than
        guessing); with a budget, ``headroom_bytes`` < 0 means the
        static walk already proves the candidate cannot fit."""
        peak = self._hbm_peaks.get(str(target))
        out = {
            "target": str(target),
            "known": peak is not None,
            "peak_bytes": peak,
            "budget_bytes": None if budget_bytes is None
            else int(budget_bytes),
            "headroom_bytes": None,
            "fits": None,
        }
        if peak is not None and budget_bytes is not None:
            out["headroom_bytes"] = int(budget_bytes) - peak
            out["fits"] = peak <= int(budget_bytes)
        return out
