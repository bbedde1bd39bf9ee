"""The port's metrics layer (quiver_tpu_torch/obs: registry, timeline,
export, profile) against the JAX package's, on the same seeded inputs.

Tolerance: bitwise everywhere. P² estimates and stage aggregates are the
same Python float arithmetic on the same observations, so the port's
values equal JAX's exactly, small-n exactness included; the exporters are
pure Python and numpy, so their text is byte-equal, and each package
parses the other's output.
"""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quiver_tpu.obs import export as export_j  # noqa: E402
from quiver_tpu.obs import registry as registry_j  # noqa: E402
from quiver_tpu.obs import timeline as timeline_j  # noqa: E402

from quiver_tpu_torch.obs import export as export_t  # noqa: E402
from quiver_tpu_torch.obs import profile_epoch  # noqa: E402
from quiver_tpu_torch.obs import registry as registry_t  # noqa: E402
from quiver_tpu_torch.obs import timeline as timeline_t  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402


# -- registry and tape ------------------------------------------------------------


def test_registry_register_and_record():
    reg = registry_t.MetricsRegistry()
    reg.counter("a.count", doc="a counter")
    reg.gauge("b.vec", shape=(3,), doc="a gauge")
    reg.record({"a.count": torch.tensor(4, dtype=torch.int32),
                "b.vec": torch.arange(3, dtype=torch.int32)})
    assert int(reg.value("a.count")) == 4
    snap = reg.snapshot("b.vec")
    assert snap.kind == "gauge" and snap.steps is None
    assert snap.numpy.tolist() == [0, 1, 2] and snap.numpy.dtype == np.int32
    reg.record({"b.vec": torch.ones((5, 3), dtype=torch.int32)})  # a stack of steps
    assert reg.snapshot("b.vec").steps == 5 and reg.snapshot("b.vec").shape == (5, 3)
    reg.set("a.count", None)
    assert reg.value("a.count") is None
    assert [s.name for s in reg.snapshots()] == ["b.vec"]


def test_registry_spec_conflicts_and_unknown():
    reg = registry_t.MetricsRegistry()
    reg.counter("x")
    reg.counter("x")  # idempotent
    with pytest.raises(ValueError, match="different spec"):
        reg.gauge("x")
    with pytest.raises(KeyError, match="not registered"):
        reg.spec("nope")
    with pytest.raises(ValueError, match="kind"):
        registry_t.MetricSpec("y", "histogram")
    with pytest.raises(ValueError, match="ndim"):
        reg.set("x", np.zeros((2, 2), np.int32))


def test_tape_accumulates_and_reads_back_once():
    """Counters accumulate on the values' device, gauges overwrite, unfed
    metrics zero-fill from their spec; finalize returns host arrays of the
    spec's dtype, and ``psum`` is validated and the identity on one card."""
    reg = registry_t.MetricsRegistry()
    reg.counter(registry_t.SAMPLE_OVERFLOW, shape=(2,))
    reg.counter(registry_t.ROUTED_OVERFLOW)
    reg.gauge("loss", dtype=torch.float32)
    reg.gauge("unfed", shape=(3,))
    tape = reg.tape()
    tape.add(registry_t.SAMPLE_OVERFLOW, torch.tensor([1, 2]), psum="data")
    tape.add(registry_t.SAMPLE_OVERFLOW, torch.tensor([3, 4]), psum="data")
    tape.add(registry_t.ROUTED_OVERFLOW, torch.tensor(5), psum=("data", "feature"))
    tape.set("loss", torch.tensor(0.5))
    tape.set("loss", torch.tensor(0.25))
    with pytest.raises(ValueError, match="conflicting psum"):
        tape.add(registry_t.SAMPLE_OVERFLOW, torch.tensor([0, 0]), psum="feature")
    with pytest.raises(ValueError, match="psum"):
        tape.add(registry_t.ROUTED_OVERFLOW, torch.tensor(1), psum=())
    with pytest.raises(ValueError, match="use set"):
        tape.add("loss", torch.tensor(1.0))
    with pytest.raises(ValueError, match="use add"):
        tape.set(registry_t.ROUTED_OVERFLOW, torch.tensor(1))
    out = tape.finalize()
    assert list(out) == [registry_t.SAMPLE_OVERFLOW, registry_t.ROUTED_OVERFLOW,
                         "loss", "unfed"]
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert out[registry_t.SAMPLE_OVERFLOW].tolist() == [4, 6]
    assert out[registry_t.SAMPLE_OVERFLOW].dtype == np.int32
    assert int(out[registry_t.ROUTED_OVERFLOW]) == 5
    assert out["loss"].dtype == np.float32 and float(out["loss"]) == 0.25
    assert out["unfed"].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="would drop"):
        tape.finalize(names=["loss"])
    assert list(tape.finalize(names=[registry_t.SAMPLE_OVERFLOW,
                                     registry_t.ROUTED_OVERFLOW, "loss"])) == [
        registry_t.SAMPLE_OVERFLOW, registry_t.ROUTED_OVERFLOW, "loss"]
    reg.record(out)
    assert reg.snapshot("loss").numpy.dtype == np.float32


def test_tape_disabled_is_noop():
    reg = registry_t.MetricsRegistry(enabled=False)
    reg.counter("c")
    tape = reg.tape()
    tape.add("c", torch.tensor(1))
    assert tape.finalize() == {}
    reg.record({"c": np.int32(1)})
    assert reg.snapshots() == []


def test_metric_names_match_jax():
    names = [n for n in registry_j.__all__ if n.isupper()]
    assert names == [n for n in registry_t.__all__ if n.isupper()]
    for n in names:
        assert getattr(registry_t, n) == getattr(registry_j, n)


# -- P² and the timeline ---------------------------------------------------------


def test_p2_quantile_equals_jax_on_one_stream():
    """Every prefix length 1-12 (the exact small-n buffer and the marker
    start) and the end of a 3,000-sample seeded stream."""
    xs = np.random.default_rng(3).lognormal(0.0, 1.0, 3000)
    for q in (0.5, 0.95, 0.99, 0.01):
        pj, pt = timeline_j.P2Quantile(q), timeline_t.P2Quantile(q)
        assert pt.value is None and pj.value is None
        for i, x in enumerate(xs):
            pj.update(float(x))
            pt.update(float(x))
            if i < 12 or i == len(xs) - 1:
                assert pt.value == pj.value, (q, i)
        assert pt.count == pj.count == 3000


def test_p2_quantile_small_samples_exact():
    for q, stream, want in ((0.5, (3.0, 1.0, 2.0), 2.0), (0.99, (1.0, 2.0), 2.0),
                            (0.5, (1.0, 2.0), 1.0), (0.95, (40.0, 10.0, 30.0, 20.0), 40.0)):
        est = timeline_t.P2Quantile(q)
        for x in stream:
            est.update(x)
        assert est.value == want
    with pytest.raises(ValueError, match="quantile"):
        timeline_t.P2Quantile(1.0)


def test_stage_stats_as_dict_equals_jax():
    xs = np.random.default_rng(11).exponential(0.004, 257)
    tj, tt = timeline_j.StepTimeline(), timeline_t.StepTimeline()
    for i, x in enumerate(xs):
        for tl in (tj, tt):
            tl.observe("sample" if i % 3 else "gather", float(x))
    assert tt.stats("empty") is None
    for name in ("sample", "gather"):
        assert tt.stats(name).as_dict() == tj.stats(name).as_dict()
    assert tt.report() == tj.report()
    assert tt.overlap_efficiency(("sample", "gather"), "sample") == \
        tj.overlap_efficiency(("sample", "gather"), "sample")
    empty = timeline_t.StageStats("x").as_dict()
    assert empty == timeline_j.StageStats("x").as_dict()


def test_timeline_stage_syncs_and_timer_feeds_it():
    tl = timeline_t.StepTimeline()
    with tl.stage("gather", sync=torch.ones(8)):
        pass
    with tl.stage("pad", sync=[torch.device("cpu"), "cpu"]):
        pass
    with trace.Timer("sample", quiet=True, registry=tl):
        pass
    with trace.Timer("sample", quiet=True, registry=tl, metric="renamed"):
        pass
    assert [tl.stats(n).count for n in ("gather", "pad", "sample", "renamed")] == [1] * 4
    with pytest.raises(RuntimeError):
        with tl.stage("failing"):
            raise RuntimeError("boom")
    assert tl.stats("failing").count == 1  # a failing stage still lands
    tl.clear()
    assert tl.report() == "(no stages timed)"


# -- exporters --------------------------------------------------------------------


def _snapshots(mod):
    return [
        mod.MetricSnapshot("feature.routed_overflow", "counter",
                           np.int32(7), None, "lanes", "fallback lanes"),
        mod.MetricSnapshot("feature.tier_hits", "gauge",
                           np.arange(12, dtype=np.int32).reshape(4, 3), 4,
                           "hits", "per-tier hits"),
        mod.MetricSnapshot("loss.gauge", "gauge",
                           np.asarray([0.5, 0.25], np.float32), 2),
        # hostile names: backslash, quote, newline; an idx spoof; a
        # sanitisation collision
        mod.MetricSnapshot('evil\\name."quoted"\nline', "counter",
                           np.int32(3), None, "", 'doc with "quotes"\nand line'),
        mod.MetricSnapshot('spoof",idx="9,9', "gauge",
                           np.asarray([1.0, 2.0], np.float32), None),
        mod.MetricSnapshot("a.b", "counter", np.int32(1), None),
        mod.MetricSnapshot("a_b", "counter", np.int64(2), None),
    ]


def _same(a, b):
    assert (a.name, a.kind, a.steps, a.unit, a.doc) == (b.name, b.kind, b.steps,
                                                       b.unit, b.doc)
    assert a.numpy.dtype == b.numpy.dtype
    np.testing.assert_array_equal(a.numpy, b.numpy)


def test_prometheus_byte_equal_and_cross_parsed():
    sj, st = _snapshots(registry_j), _snapshots(registry_t)
    text_j, text_t = export_j.to_prometheus(sj), export_t.to_prometheus(st)
    assert text_t == text_j
    assert "quiver_a_b_2" in text_t
    for back in (export_t.from_prometheus(text_j), export_j.from_prometheus(text_t)):
        assert len(back) == len(st)
        for a, b in zip(st, back):
            _same(a, b)


def test_jsonl_byte_equal_and_cross_parsed(tmp_path):
    bj, bt = io.StringIO(), io.StringIO()
    assert export_j.write_jsonl(_snapshots(registry_j), bj, extra={"job": "t"}) == \
        export_t.write_jsonl(_snapshots(registry_t), bt, extra={"job": "t"}) == 7
    assert bt.getvalue() == bj.getvalue()
    for back in (export_t.read_jsonl(bj.getvalue()), export_j.read_jsonl(bt.getvalue())):
        for a, b in zip(_snapshots(registry_t), back):
            _same(a, b)
    path = tmp_path / "metrics.jsonl"
    export_t.write_jsonl(_snapshots(registry_t), str(path))
    export_t.write_jsonl(_snapshots(registry_t)[:1], str(path))  # append
    assert len(export_j.read_jsonl(str(path))) == 8


def test_registry_exports_equal_jax():
    """A port registry recording torch tensors exports the bytes a JAX
    registry recording the same values as jnp arrays does, including a
    stack of steps."""
    rj, rt = registry_j.MetricsRegistry(), registry_t.MetricsRegistry()
    vals = {"sample.hop_overflow": np.asarray([[1, 2], [3, 4], [5, 6]], np.int32),
            "serve.requests": np.int32(40)}
    for reg, conv in ((rj, jnp.asarray), (rt, torch.from_numpy)):
        reg.counter("sample.hop_overflow", shape=(2,), doc="per hop")
        reg.counter("serve.requests", unit="requests")
        reg.record({k: conv(np.asarray(v)) for k, v in vals.items()})
    assert rt.snapshot("sample.hop_overflow").steps == 3
    assert export_t.to_prometheus(rt.snapshots()) == export_j.to_prometheus(rj.snapshots())
    bj, bt = io.StringIO(), io.StringIO()
    export_j.write_jsonl(rj.snapshots(), bj)
    export_t.write_jsonl(rt.snapshots(), bt)
    assert bt.getvalue() == bj.getvalue()


# -- profile_epoch ----------------------------------------------------------------


def test_profile_epoch_brackets_writes_and_restores(tmp_path):
    prev = trace._enabled
    trace.disable_trace()
    try:
        with profile_epoch(str(tmp_path / "prof"), "serve") as prof:
            assert trace.trace_enabled()  # stage scopes annotate the profile
            tl = timeline_t.StepTimeline()
            with tl.stage("gather"):
                torch.arange(64).sum()
        assert not trace.trace_enabled()  # the prior state is restored
        path = tmp_path / "prof" / "serve.trace.json"
        names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
        assert {"serve", "gather"} <= names
        assert any(e.key == "serve" for e in prof.key_averages())
        # restored on a raise too
        trace.enable_trace()
        with pytest.raises(ValueError):
            with profile_epoch(str(tmp_path / "prof2")):
                trace.disable_trace()
                raise ValueError("boom")
        assert trace.trace_enabled()
        assert not os.path.exists(tmp_path / "prof2" / "epoch.trace.json")
    finally:
        trace._enabled = prev
