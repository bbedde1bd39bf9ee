"""The cache controller: telemetry-driven cache and routing control.

The port of ``quiver_tpu/control``: :mod:`.freq` measures (a positional
heat histogram and an exact top-K heavy-hitter set, EMA-decayed between
epochs), :mod:`.cost` predicts (tier hit rates and routed lanes per hop
at a candidate split and ``routed_alpha``), and :class:`CacheController`
decides between batches or epochs, auditing every decision. Pass
``InferenceServer(controller=...)`` (or ``ServingFleet(controller=...)``)
to feed it serving traffic.
"""

from .controller import AlphaTuner, CacheController, SplitTuner
from .cost import CostModel, predicted_hit_rates, routed_lanes_per_hop
from .freq import FreqSketch, heat_num_bins, row_heat_histogram

__all__ = [
    "AlphaTuner",
    "CacheController",
    "CostModel",
    "FreqSketch",
    "SplitTuner",
    "heat_num_bins",
    "predicted_hit_rates",
    "routed_lanes_per_hop",
    "row_heat_histogram",
]
