"""The port's tracer, flight recorder and telemetry endpoint
(quiver_tpu_torch/obs/{tracing,recorder,endpoint}.py) against the JAX
package's.

Tolerance: exact. Under one injected clock both tracers record the same
spans and export the same Chrome trace-event JSON; each package's
``verify_bundle`` accepts the other's postmortem bundles and rejects the
same corruptions.
"""

import itertools
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.obs import recorder as recorder_j  # noqa: E402
from quiver_tpu.obs import registry as registry_j  # noqa: E402
from quiver_tpu.obs import tracing as tracing_j  # noqa: E402

from quiver_tpu_torch.obs import recorder as recorder_t  # noqa: E402
from quiver_tpu_torch.obs import registry as registry_t  # noqa: E402
from quiver_tpu_torch.obs import tracing as tracing_t  # noqa: E402
from quiver_tpu_torch.obs.endpoint import TelemetryEndpoint  # noqa: E402


def test_tracer_ids_nesting_and_ring():
    reg = registry_t.MetricsRegistry()
    tr = tracing_t.Tracer(max_spans=4, metrics=reg)
    assert tr.trace() == "t1" and tr.trace() == "t2"
    assert tr.trace("train.epoch.3") == "train.epoch.3"
    with tr.span("outer", trace="t1", subsystem="test", k=1) as outer:
        outer.set("extra", 2)
        with tr.span("inner", trace="t1", parent=outer):
            pass
    inner_s, outer_s = tr.spans()  # inner exits (records) first
    assert inner_s.name == "inner" and outer_s.name == "outer"
    assert inner_s.parent_id == outer_s.span_id and outer_s.parent_id == ""
    assert outer_s.attrs == {"k": 1, "extra": 2, "subsystem": "test"}
    assert outer_s.dur >= inner_s.dur >= 0.0
    assert tr.subsystems() == {"test"}
    for i in range(10):  # bounded ring: the oldest are evicted
        tr.event(f"e{i}", trace="t2")
    assert [s.name for s in tr.spans()] == ["e6", "e7", "e8", "e9"]
    assert tr.spans_total == 12 and int(reg.value(registry_t.TRACE_SPANS)) == 12
    with pytest.raises(ValueError, match="max_spans"):
        tracing_t.Tracer(max_spans=0)


def test_tracer_span_records_on_raise():
    tr = tracing_t.Tracer()
    with pytest.raises(ValueError):
        with tr.span("failing", subsystem="test"):
            raise ValueError("boom")
    (s,) = tr.spans()
    assert s.name == "failing" and s.attrs["error"] == "ValueError"


def test_tracer_disabled_is_structurally_noop():
    tr = tracing_t.Tracer(enabled=False)
    assert tr.trace() == "" and tr.trace("x") == ""
    scope = tr.span("a", subsystem="serve")
    assert scope is tracing_t._NULL_SCOPE  # one shared singleton
    with scope as s:
        assert s is tracing_t._NULL_SPAN
        s.set("k", 1)
        assert s.as_dict() == {}
    assert tr.record("b", 0.0, 1.0) is None and tr.event("c") is None
    assert tr.observe("d", 0.5) is None
    assert tr.spans() == [] and tr.spans_total == 0


def _drive(mod):
    """The same span stream through a tracer of ``mod``."""
    tr = mod.Tracer(max_spans=64)
    tid = tr.trace()
    with tr.span("serve.request", trace=tid, subsystem="serve",
                 node=np.int64(7), w=np.float32(0.5)) as root:
        with tr.span("serve.sample", trace=tid, parent=root, bucket=4):
            pass
        root.set("vec", np.arange(3))
    tr.record("serve.gather", 0.25, 0.125, trace=tid, parent=root.span_id,
              subsystem="serve")
    tr.observe("serve.queue_wait", 0.5, trace=tid, subsystem="serve")
    tr.event("serve.enqueue", trace=tr.trace(), subsystem="serve", seq=3)
    return tr


def test_chrome_export_equals_jax_under_injected_clock(monkeypatch, tmp_path):
    def run(mod):
        ticks = itertools.count()
        monkeypatch.setattr(time, "perf_counter", lambda: 0.001 * next(ticks))
        return _drive(mod)

    tj, tt = run(tracing_j), run(tracing_t)

    def fields(tr):
        return [(s.name, s.trace_id, s.span_id, s.parent_id, s.t0, s.dur, s.tid)
                for s in tr.spans()]

    assert fields(tt) == fields(tj)
    assert tt.to_chrome() == tj.to_chrome()
    pj, pt = tmp_path / "j.json", tmp_path / "t.json"
    assert tt.write_chrome(pt) == tj.write_chrome(pj) == 5
    assert pt.read_bytes() == pj.read_bytes()
    for ev in json.loads(pt.read_text())["traceEvents"]:
        assert ev["ph"] == "X" and {"name", "cat", "ts", "dur", "pid", "tid",
                                    "args"} <= ev.keys()


def _recorder(mod, reg_mod, trace_mod, directory):
    reg = reg_mod.MetricsRegistry()
    reg.counter("serve.requests")
    reg.set("serve.requests", np.int32(9))
    tr = trace_mod.Tracer()
    tr.event("serve.enqueue", trace=tr.trace(), subsystem="serve")
    rec = mod.FlightRecorder(directory, tracer=tr, metrics=reg)
    rec.note("serve.shed", replica=0, shed_total=np.int64(3))
    return rec


def test_bundles_cross_verified(tmp_path):
    """Each package's verify_bundle accepts the other's bundle, with the
    same manifest fields and the same payload files."""
    rt = _recorder(recorder_t, registry_t, tracing_t, tmp_path / "t")
    rj = _recorder(recorder_j, registry_j, tracing_j, tmp_path / "j")
    pt = rt.trigger("breaker_open", stage="gather", fallback="zeros")
    pj = rj.trigger("breaker_open", stage="gather", fallback="zeros")
    mt, mj = recorder_j.verify_bundle(pt), recorder_t.verify_bundle(pj)
    assert recorder_t.verify_bundle(pt) == mt and recorder_j.verify_bundle(pj) == mj
    for key in ("format", "seq", "reason", "stage", "attrs", "spans", "events"):
        assert mt[key] == mj[key], key
    assert set(mt["files"]) == set(mj["files"])
    for fname in ("metrics.json",):
        assert (tmp_path / "t").joinpath(pt.rsplit("/", 1)[1], fname).read_bytes() == \
            (tmp_path / "j").joinpath(pj.rsplit("/", 1)[1], fname).read_bytes()
    assert rt.bundles_total == 1 and rt.events_total == 1
    assert int(rt.metrics.value(registry_t.RECORDER_BUNDLES)) == 1
    assert [p for p, _m in recorder_j.list_bundles(rt.directory)] == [pt]


def test_recorder_survives_kill_mid_dump(tmp_path):
    rec = recorder_t.FlightRecorder(tmp_path / "pm", tracer=tracing_t.Tracer())
    good = rec.trigger("nonfinite_guard", stage="train")
    with pytest.raises(RuntimeError, match="injected recorder crash"):
        rec.trigger("crash_drill", stage="train", inject_failure="crash")
    assert [p for p, _m in rec.bundles()] == [good]
    torn = rec.trigger("torn_drill", stage="train", inject_failure="torn")
    for verify in (recorder_t.verify_bundle, recorder_j.verify_bundle):
        with pytest.raises((recorder_t.TornBundle, recorder_j.TornBundle),
                           match="no COMMIT marker"):
            verify(torn)
    assert [p for p, _m in rec.bundles()] == [good]  # quarantined away
    quarantined = [p.name for p in (tmp_path / "pm").iterdir()
                   if p.name.startswith("quarantine-")]
    assert len(quarantined) == 1 and "torn_drill" in quarantined[0]
    recorder_j.verify_bundle(good)  # the earlier bundle is intact
    again = recorder_t.FlightRecorder(tmp_path / "pm").trigger("manual")
    assert recorder_t.verify_bundle(again)["seq"] > recorder_t.verify_bundle(good)["seq"]
    with pytest.raises(ValueError, match="inject_failure"):
        rec.trigger("x", inject_failure="nope")


def test_recorder_detects_payload_corruption_and_prunes(tmp_path):
    rec = recorder_t.FlightRecorder(tmp_path / "pm", keep=2)
    path = rec.trigger("manual")
    with open(f"{path}/events.json", "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0xFF]))
    for verify in (recorder_t.verify_bundle, recorder_j.verify_bundle):
        with pytest.raises(Exception, match="checksum mismatch"):
            verify(path)
    assert recorder_t.list_bundles(rec.directory, quarantine=False) == []
    paths = [rec.dump(stage="x") for _ in range(3)]
    assert [p for p, _m in rec.bundles()] == paths[1:]  # keep=2


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_endpoint_routes():
    reg = registry_t.MetricsRegistry()
    reg.counter("demo.count", doc="a demo counter")
    reg.set("demo.count", torch.tensor(3, dtype=torch.int32))
    tr = tracing_t.Tracer()
    tr.event("serve.enqueue", trace=tr.trace(), subsystem="serve")
    with TelemetryEndpoint(metrics=reg, tracer=tr, health=lambda: {"depth": 0}) as ep:
        assert ep.running and ep.port > 0 and ep.start() is ep
        code, ctype, body = _get(f"{ep.url}/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert 'quiver_demo_count{name="demo.count"} 3' in body.decode()
        code, ctype, body = _get(f"{ep.url}/traces?x=1")
        assert code == 200 and ctype == "application/json"
        assert len(json.loads(body)["traceEvents"]) == 1
        code, _ctype, body = _get(f"{ep.url}/healthz")
        assert code == 200 and json.loads(body) == {"status": "ok", "depth": 0}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{ep.url}/nope")
        assert ei.value.code == 404
    assert not ep.running
    ep.stop()  # idempotent
    bare = TelemetryEndpoint()
    assert bare.metrics_text() == "" and bare.traces_json()["traceEvents"] == []
