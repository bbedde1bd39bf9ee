"""The readers of the program's own spans (``infer.place_ms``,
``infer.aggregate_ms``, ``infer.combine_ms``, ``infer.place_h2d_mb``)
against hand means over handmade passes, with the cases in which they find
nothing to read; and, marked ``cuda``, a traced run of
``sage-products.infer`` on a card that reports all four:
``python -m pytest --noconftest perfbench/tests/test_perfbench_spans.py -q -m cuda``."""

from __future__ import annotations

import time

import pytest
import torch

import quiver_tpu_torch.obs as obs
from perfbench import harness
from perfbench.tests import tiny
from quiver_tpu_torch.obs.tracing import Tracer

READERS = ("infer.place_ms", "infer.aggregate_ms", "infer.combine_ms", "infer.place_h2d_mb")
TRACED = object()  # stands for a traced window: the readers only ask whether there is one


def _metric(name):
    return harness.load_module(tiny.ROOT, "metrics", name)


def _pass(tr, place, h2d, aggregates, combines, layers=None):
    """One handmade pass recorded as the program records it (children
    first, the pass last, all in the pass's own trace)."""
    t = tr.trace()
    top = tr._make("infer.pass", t, None, None, {"layers": layers or len(aggregates)})

    def rec(name, ms, parent, **attrs):
        s = tr.record(name, 0.0, 0.0, trace=t, parent=parent, **attrs)
        s._device_ms = ms
        return s

    rec("infer.place", place, top, h2d_bytes=h2d)
    for a, c in zip(aggregates, combines):
        layer = tr._make("infer.layer", t, top, None, {})
        rec("infer.aggregate", a, layer)
        rec("infer.combine", c, layer)
        tr._record(layer)
    tr._record(top)


@pytest.fixture
def tracer(monkeypatch):
    tr = Tracer()
    monkeypatch.setattr(obs, "default_tracer", lambda: tr)
    return tr


def test_readers_give_the_mean_of_the_windows_complete_passes(tracer):
    _pass(tracer, 1000.0, 9_000_000, [5.0, 5.0], [5.0, 5.0])  # before the window
    _pass(tracer, 80.0, 504_669_240, [900.0, 800.0], [10.0, 20.0])
    _pass(tracer, 90.0, 504_669_240, [700.0], [30.0], layers=2)  # a layer evicted
    _pass(tracer, 100.0, 504_669_242, [1000.0, 900.0], [11.0, 25.0])
    rec = {"trace": TRACED, "passes": 2}
    assert _metric("infer.place_ms").read(rec) == pytest.approx(90.0)
    assert _metric("infer.aggregate_ms").read(rec) == pytest.approx((1700.0 + 1900.0) / 2)
    assert _metric("infer.combine_ms").read(rec) == pytest.approx((30.0 + 36.0) / 2)
    assert _metric("infer.place_h2d_mb").read(rec) == pytest.approx(504.669241)
    # without the window's pass count: every complete pass retained
    assert _metric("infer.place_ms").read({"trace": TRACED}) == pytest.approx(1180.0 / 3)


def test_readers_find_nothing_without_a_trace_spans_or_device_time(tracer):
    for name in READERS:
        assert _metric(name).read({"trace": TRACED, "passes": 3}) is None, name
    _pass(tracer, 80.0, 4, [900.0], [10.0])
    for name in READERS:
        assert _metric(name).read({"trace": None, "passes": 1}) is None, name
        assert _metric(name).read({"trace": TRACED, "passes": 1}) is not None, name
    tracer.clear()
    _pass(tracer, None, 4, [None], [None])  # spans timed on no card
    for name in READERS:
        assert _metric(name).read({"trace": TRACED, "passes": 1}) is None, name


def test_readers_of_a_program_without_a_default_tracer(monkeypatch):
    monkeypatch.delattr(obs, "default_tracer")
    for name in READERS:
        assert _metric(name).read({"trace": TRACED, "passes": 1}) is None, name


@pytest.mark.cuda
def test_traced_run_of_the_cell_reports_the_span_metrics():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    cell = harness.load_cell(tiny.ROOT, tiny.REAL_CELL)
    obs.default_tracer().clear()
    result, compared = harness.run_cell(cell, 2**31 + 11, 3.0, True, device,
                                        time.perf_counter())
    assert result["correct"], compared
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # the program's spans leave the device mirror of the loop's own span whole
    assert set(READERS) | {"infer.pass_device_ms"} <= set(got), got
    n, e = cell.cfg["num_nodes"], cell.cfg["num_edges"]
    # indptr crosses widened to int64 on the host, the edges as int32; the
    # features are made on the card
    assert got["infer.place_h2d_mb"] == pytest.approx((8 * (n + 1) + 4 * e) / 1e6)
    parts = got["infer.place_ms"] + got["infer.aggregate_ms"] + got["infer.combine_ms"]
    assert parts == pytest.approx(got["infer.pass_device_ms"], rel=0.03)
