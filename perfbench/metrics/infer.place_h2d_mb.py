"""``infer.place_h2d_mb``: megabytes (1e6 B) that crossed from the host to
the card in a pass's ``infer.place`` span, the program's ``h2d_bytes``
count (every host tensor placed on the card, at the size it crosses); the
mean over the traced window's passes. Read where the spans were timed on a
card, as the three times are."""

import os

from perfbench import harness

_PLACE = harness.load_module(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "metrics", "infer.place_ms")


def read(rec):
    done = _PLACE.passes(rec)
    if not done:
        return None
    places = [s for spans in done for s in spans if s.name == "infer.place"]
    if any(s.device_ms is None for s in places):
        return None
    return sum(s.attrs["h2d_bytes"] for s in places) / 1e6 / len(places)
