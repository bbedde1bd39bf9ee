"""The counting rules of the per-layer metrics against hand counts: the
layer-wise pass's FLOPs and the idle share of a traced window; and every
reader finds nothing to read without a trace."""

from __future__ import annotations

import json
import os

import pytest

from perfbench import harness
from perfbench.trace import Trace
from perfbench.tests import tiny


def _metric(name):
    return harness.load_module(tiny.ROOT, "metrics", name)


def _trace(window_s, busy_s, calls=None):
    return Trace(window_s=window_s, busy_s=busy_s, calls=calls or {}, device_ops=[],
                 idle_gaps=[], device_events=1, attributed_s=busy_s, summed_s=busy_s)


def test_layerwise_flops_hand_count():
    rule = _metric("infer.mfu")
    assert rule.layerwise_flops(10, 50, [3, 4, 2]) == (
        50 * 3 + 10 * 3 + 4 * 10 * 3 * 4 + 2 * 10 * 4
        + 50 * 4 + 10 * 4 + 4 * 10 * 4 * 2 + 2 * 10 * 2)


def test_mfu_over_the_traced_window():
    rec = {"trace": _trace(2.0, 1.5), "peaks": {"f32_flops_per_s": 1e6}, "passes": 3,
           "num_nodes": 10, "num_edges": 50, "widths": [3, 4, 2]}
    want = 100.0 * 3 * _metric("infer.mfu").layerwise_flops(10, 50, [3, 4, 2]) / (2.0 * 1e6)
    assert _metric("infer.mfu").read(rec) == pytest.approx(want)


def test_idle_share_and_pass_time():
    rec = {"trace": _trace(4.0, 3.0, {"bench.pass": {1: 1.25, 2: 1.75}})}
    assert _metric("device.idle_share.infer").read(rec) == pytest.approx(25.0)
    assert _metric("infer.pass_device_ms").read(rec) == pytest.approx(1500.0)
    assert _metric("device.idle_share.infer").read({"trace": _trace(4.0, 0.0)}) is None


def test_readers_find_nothing_without_a_trace():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        names = [m["name"] for m in json.load(fh)["per_layer"]]
    for name in names:
        assert _metric(name).read({"trace": None}) is None, name
