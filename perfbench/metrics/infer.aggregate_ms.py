"""``infer.aggregate_ms``: milliseconds on the card's stream of a pass's
``infer.aggregate`` spans (``_neighbor_mean_dev``, one per layer: the
chunk loop's searchsorted, gather and sorted accumulate, and the degree
divide), summed over the pass and timed by the program's CUDA events; the
mean over the traced window's passes."""

import os

from perfbench import harness

_PLACE = harness.load_module(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "metrics", "infer.place_ms")


def read(rec):
    return _PLACE.span_ms(rec, "infer.aggregate")
