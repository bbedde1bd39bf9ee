"""The layer-wise pass's spans (``models/inference.py`` through
``obs/tracing.py``): recorded only while the trace switch is on, a
profiler records or a live span encloses the call; the same answers with
them on and off; the tree ``infer.pass`` -> ``infer.place``, one
``infer.layer`` per conv -> ``infer.aggregate``, ``infer.combine``; their
counts; each span a range of its name on the profiler's timeline;
parents taken from the thread, explicit ids kept; and the refresher's
``serve.refresh`` above its pass.

No JAX here: the test marked ``cuda`` runs on a card with
``python -m pytest --noconftest tests/test_torch_infer_spans.py -q -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.core.hetero import HeteroCSRTopo  # noqa: E402
from quiver_tpu_torch.models import GAT, GCN, GIN, RGCN, GraphSAGE  # noqa: E402
from quiver_tpu_torch.models import inference as inf  # noqa: E402
from quiver_tpu_torch.obs import tracing  # noqa: E402
from quiver_tpu_torch.utils import trace  # noqa: E402

N, F_IN, HID, CLS, CHUNK = 90, 6, 8, 3, 97
FAMILIES = ("sage", "gcn", "gin", "gat", "rgcn")
WRITES, CITES = ("author", "writes", "paper"), ("paper", "cites", "paper")
ALL_THREADS = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


@pytest.fixture
def switch_off(monkeypatch):
    """The trace switch unset (and restored after the test)."""
    monkeypatch.setattr(trace, "_enabled", None)
    monkeypatch.delenv("QUIVER_ENABLE_TRACE", raising=False)


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N, size=(2, 7 * N))
    return qt.CSRTopo(edge_index=np.concatenate([ei, ei[::-1]], axis=1))


def _hetero(seed=0):
    rng = np.random.default_rng(seed)
    num_nodes = {"paper": 40, "author": 25}
    edges = {CITES: np.stack([rng.integers(0, 40, 300), rng.integers(0, 40, 300)]),
             WRITES: np.stack([rng.integers(0, 25, 200), rng.integers(0, 40, 200)])}
    return HeteroCSRTopo(num_nodes, edges), num_nodes


def _case(family, seed=0):
    """(entry, model, topology, features, layers, relations)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    if family == "rgcn":
        topo, num_nodes = _hetero(seed)
        schema = {"in_dims": {"paper": F_IN, "author": F_IN},
                  "layers": [{"self": ["paper", "author"], "rels": [WRITES, CITES]},
                             {"self": ["paper"], "rels": [WRITES, CITES]}]}
        model = RGCN(schema, HID, CLS, "paper", num_layers=2, num_bases=0, dropout=0.0)
        x = {t: rng.normal(size=(n, F_IN)).astype(np.float32) for t, n in num_nodes.items()}
        return inf.rgcn_layerwise_inference, model.eval(), topo, x, 2, len(topo.relations)
    topo = _graph(seed)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    make = {"sage": (GraphSAGE, inf.sage_layerwise_inference),
            "gcn": (GCN, inf.gcn_layerwise_inference),
            "gin": (GIN, inf.gin_layerwise_inference),
            "gat": (GAT, inf.gat_layerwise_inference)}
    cls, entry = make[family]
    kw = {"heads": 2} if family == "gat" else {}
    model = cls(F_IN, HID, CLS, num_layers=3, dropout=0.0, **kw)
    for p in model.parameters():  # non-zero biases, so every term shows
        torch.nn.init.normal_(p, std=0.3)
    return entry, model.eval(), topo, x, 3, 1


def _run(entry, model, topo, x, device="cpu"):
    return entry(model, topo, x, chunk=CHUNK, device=device)


def _tree(spans):
    """``{span: [children, in the order they started]}`` by ids."""
    kids = {s.span_id: [] for s in spans}
    for s in spans:
        if s.parent_id in kids:
            kids[s.parent_id].append(s)
    for k in kids.values():
        k.sort(key=lambda s: s.t0)
    return kids


def test_nothing_recorded_with_the_switch_off_and_no_profiler(switch_off):
    tr = tracing.default_tracer()
    before = tr.spans_total
    for family in FAMILIES:
        _run(*_case(family)[:4])
    assert tr.spans_total == before
    assert tracing.span("infer.pass") is tracing._NULL_SCOPE


@pytest.mark.parametrize("family", FAMILIES)
def test_answers_bitwise_with_tracing_on_and_off(family, switch_off):
    entry, model, topo, x, _, _ = _case(family)
    tr = tracing.default_tracer()
    off = _run(entry, model, topo, x)
    before = tr.spans_total
    # a profile of every thread, as the benchmark's traced window takes
    with profile(activities=[ProfilerActivity.CPU], experimental_config=ALL_THREADS):
        profiled = _run(entry, model, topo, x)
    assert tr.spans_total > before
    trace.enable_trace()
    before = tr.spans_total
    on = _run(entry, model, topo, x)
    assert tr.spans_total > before
    assert torch.equal(on, off) and torch.equal(profiled, off)


@pytest.mark.parametrize("family", FAMILIES)
def test_span_tree_and_counts_under_the_profiler(family, switch_off):
    entry, model, topo, x, layers, rels = _case(family)
    tr = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]), tr.span("outer", trace="t0") as outer:
        _run(entry, model, topo, x)
    spans = tr.spans()
    kids = _tree(spans)
    (top,) = kids[outer.span_id]
    assert top.name == "infer.pass" and top.trace_id != outer.trace_id
    assert top.attrs == {"layers": layers}
    assert all(s.trace_id == top.trace_id for s in spans if s is not outer)
    place, *convs = kids[top.span_id]
    assert place.name == "infer.place" and kids[place.span_id] == []
    assert place.attrs == {"h2d_bytes": 0}  # a CPU pass copies nothing to a card
    assert [c.name for c in convs] == ["infer.layer"] * layers
    for i, conv in enumerate(convs):
        names = [s.name for s in kids[conv.span_id]]
        if family == "gat":  # the projection, both edge passes, the finish
            assert names == ["infer.combine", "infer.aggregate", "infer.combine"]
        elif family == "rgcn":  # the self maps, then per relation its map and mean
            want = ["infer.combine"] + ["infer.combine", "infer.aggregate",
                                        "infer.combine"] * rels
            assert names == want + ["infer.combine"] * (i != layers - 1)
        else:
            assert names == ["infer.aggregate", "infer.combine"]
    # only the pass carries a count beside the placement's
    assert all(s.attrs == {} for s in spans if s.name not in ("infer.pass", "infer.place"))
    assert all(s.device_ms is None for s in spans)  # no card, no device time
    assert tr.traces("infer.pass") == [[s for s in spans if s is not outer]]


def test_spans_on_the_profiler_timeline(switch_off):
    entry, model, topo, x, _, _ = _case("sage")
    tr = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            _run(entry, model, topo, x)
    ranges = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == "outer" or e.name().startswith("infer."):
            # an operator range, so a caller's user annotation keeps the
            # device mirror of the work beneath it
            assert not e.is_user_annotation()
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    spans = sorted(tr.spans(), key=lambda s: s.t0)
    assert {s.name for s in spans} == {"outer", "infer.pass", "infer.place", "infer.layer",
                                       "infer.aggregate", "infer.combine"}
    # one range per span, in the order the spans opened, each as long as
    # its span within the profiler's own cost
    assert [n for _, _, n in sorted(ranges)] == [s.name for s in spans]
    for (a, b, _), s in zip(sorted(ranges), spans):
        assert abs((b - a) / 1e9 - s.dur) < 1e-3 + 0.05 * s.dur, s.name


def test_live_span_parents_implicitly_and_explicit_ids_stay(switch_off):
    tr = tracing.Tracer()
    with tr.span("outer", trace="job") as outer:
        with tracing.span("inner", probe=1):
            with tr.span("explicit", trace="other", parent="s77"):
                pass
            with tr.span("given", trace="t9"):
                pass
        with tracing.span("fresh", new_trace=True):
            pass
    with tracing.span("after") as after:  # nothing live: the switch is off
        assert after is tracing._NULL_SPAN
    got = {s.name: (s.trace_id, s.parent_id) for s in tr.spans()}
    assert got == {"outer": ("job", ""), "inner": ("job", outer.span_id),
                   "explicit": ("other", "s77"), "given": ("t9", ""),
                   "fresh": ("t1", outer.span_id)}
    assert [s.span_id for s in tr.spans()] == ["s3", "s4", "s2", "s5", "s1"]


def test_refresher_records_its_pass_beneath_serve_refresh(switch_off):
    entry, model, topo, x, layers, _ = _case("sage")
    tr = tracing.Tracer()
    before = tracing.default_tracer().spans_total
    with qt.EmbeddingRefresher(model, topo, x, chunk=CHUNK, tracer=tr, device="cpu") as r:
        assert r.refresh() == topo.version
    assert tracing.default_tracer().spans_total == before
    spans = tr.spans()
    (refresh,) = [s for s in spans if s.name == "serve.refresh"]
    assert refresh.attrs == {"subsystem": "serve", "version": topo.version}
    (top,) = [s for s in spans if s.name == "infer.pass"]
    assert top.parent_id == refresh.span_id and spans[-1] is refresh
    assert len(tr.traces("infer.pass")[0]) == 2 + 3 * layers


@pytest.mark.cuda
def test_pass_spans_timed_on_the_card(switch_off):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    entry, model, topo, x, layers, _ = _case("sage")
    model = model.cuda()
    off = _run(entry, model, topo, x, "cuda")
    trace.enable_trace()
    tr = tracing.default_tracer()
    tr.clear()
    on = _run(entry, model, topo, x, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(on, off)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _run(entry, model, topo, x, "cuda")
    end.record()
    torch.cuda.synchronize()
    first, second = tr.traces("infer.pass")
    assert len(first) == len(second) == 2 + 3 * layers
    timed = [s for s in second if s.name not in ("infer.pass", "infer.layer")]
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in timed)
    assert all(s.device_ms is None for s in second if s not in timed)
    (place,) = [s for s in second if s.name == "infer.place"]
    # indptr crosses widened to int64 on the host, the edges as int32, the
    # features as float32
    assert place.attrs["h2d_bytes"] == 8 * (N + 1) + 4 * topo.edge_count + 4 * N * F_IN
    assert sum(s.device_ms for s in timed) <= start.elapsed_time(end) * 1.0001
