"""``infer.combine_ms``: milliseconds on the card's stream of a pass's
``infer.combine`` spans (one per layer: the two linear maps, their sum and
the activation), summed over the pass and timed by the program's CUDA
events; the mean over the traced window's passes."""

import os

from perfbench import harness

_PLACE = harness.load_module(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "metrics", "infer.place_ms")


def read(rec):
    return _PLACE.span_ms(rec, "infer.combine")
