"""graftaudit of quiver_tpu_torch (``tools/audit``) against quiver_tpu's,
on the CPU.

The port records each target by running it once under a dispatch-mode
recorder; the JAX package traces and lowers it. Held here:
- every rule catches its positive fixture (a torch program mirroring
  ``tests/audit_fixtures/``) and leaves its negative clean;
- the registry audits clean on the CPU, with each kernel node a
  suppressed vmem-budget finding (attributes are read on the card);
- against JAX's built programs (``tests/conftest.py``'s 8 host devices):
  the routed ``all_to_all`` shapes and lanes at ``routed_alpha`` 1.0 and
  2.0, the metrics-strip count, the rule/family/target names and docs;
- the contract of JAX's ``test_cli_json_and_sarif`` (which fails on this
  image: JAX's ``routed_gather`` no longer traces), held by the port's CLI;
- the fault the audit found: int8 codes now ride the routed exchange,
  the rows bitwise as before.
Every comparison is exact (names, shapes, integer counts, bitwise rows).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.tools.audit import audit_targets as jax_targets  # noqa: E402
from quiver_tpu.tools.audit import ir as jax_ir  # noqa: E402
from quiver_tpu.tools.audit import rules as jax_rules  # noqa: E402

from quiver_tpu_torch.obs import marks  # noqa: E402
from quiver_tpu_torch.parallel.mesh import DATA_AXIS, FEATURE_AXIS  # noqa: E402
from quiver_tpu_torch.tools.audit import audit_targets as at  # noqa: E402
from quiver_tpu_torch.tools.audit import ir, rules  # noqa: E402
from quiver_tpu_torch.tools.audit.audit_targets import Case, Target, build_from  # noqa: E402
from quiver_tpu_torch.tools.audit.cli import main  # noqa: E402
from quiver_tpu_torch.tools.audit.runner import run_audit, select_targets  # noqa: E402

SRC = ("tests/test_torch_audit.py",)


@pytest.fixture(scope="module")
def registry():
    """Every registry target recorded once on the CPU (shared by the tests
    of this module)."""
    result = run_audit(device="cpu")
    yield result
    at.clear_cache()


# -- fixtures: one positive and one negative per rule --------------------------


def _t(name, fn, inputs=(), meta=None, second=None, donated=()):
    return Target(name, name, lambda dev: Case(fn, tuple(inputs), second=second,
                                               donated=tuple(donated)),
                  SRC, meta=dict(meta or {}))


def _a2a(shape, dtype=torch.float32):
    """A marked all_to_all of ``(F, ...)`` per member, F = 2."""
    def run(x):
        marks.collective("all_to_all", (FEATURE_AXIS,),
                         torch.zeros((2,) + shape, dtype=dtype))
        return x * 2
    return run


def _parity():
    def run(x, gate):
        # the bug the rule exists for: a collective only some inputs reach
        if gate:
            marks.collective("psum", (FEATURE_AXIS,), x.sum())
        return x * 2

    x = torch.ones(4)
    return [(_t("parity_pos", run, (x, True), second=(x, False)), True),
            (_t("parity_neg", run, (x, True), second=(x * 3, True)), False)]


def _metrics():
    def step(psums):
        def run(x):
            marks.collective("all_to_all", (FEATURE_AXIS,), x.reshape(2, 2))
            for _ in range(psums):
                marks.collective("psum", (DATA_AXIS,), x.sum())
            return x * 2
        return run

    x = torch.ones(4)
    meta = {"metrics_pair": "metrics_fix_on", "expected_metric_reductions": 1}
    return [(_t("metrics_fix_on", step(1), (x,)), False),
            (_t("metrics_fix_off_leaky", step(2), (x,), meta), True),
            (_t("metrics_fix_off_clean", step(0), (x,), meta), False)]


def _donation():
    acc = torch.zeros(8)
    stale = torch.zeros(8)

    def writes_input(x):
        return x.add_(1.0)

    def honest(upd):
        return acc.add_(upd)

    def rebinds(upd):
        nonlocal stale
        stale = stale + upd  # a new storage: the claimed one is never written
        return stale

    x = torch.ones(8)
    return [(_t("donation_writes_input", writes_input, (x.clone(),)), True),
            (_t("donation_unclaimed", lambda u: u * 2.0, (x,), {"donated_leaves": 1},
                donated=(torch.zeros(8),)), True),
            (_t("donation_rebinds", rebinds, (x,), donated=(stale,)), True),
            (_t("donation_honest", honest, (x,), donated=(acc,)), False)]


def _dtype():
    def f64_leak(x):
        return (x.double() + 1.0).float()

    meta = {"int8_path": True}
    x = torch.ones(4)
    return [(_t("dtype_f64_leak", f64_leak, (x,)), True),
            (_t("dtype_int8_upcast", _a2a((2, 4)), (x,), meta), True),
            (_t("dtype_int8_wire", _a2a((2, 4), torch.int8), (x,), meta), False)]


def _constants():
    table = np.arange(8192, dtype=np.float32).reshape(1024, 8)  # 32 KiB

    def folded(ids):
        return torch.from_numpy(table)[ids]  # the host table, every run

    def operand(tab, ids):
        return tab[ids]

    ids = torch.arange(4)
    meta = {"const_bytes_limit": 16 * 1024}
    return [(_t("const_folded", folded, (ids,), meta), True),
            (_t("const_operand", operand, (torch.from_numpy(table), ids), meta), False)]


def _comm(rule_meta_cap):
    from quiver_tpu_torch.control.cost import routed_lanes_per_hop

    local, alpha, feat = 16, 1.0, 4
    cap = int(routed_lanes_per_hop(local, 2, alpha)["cap"])
    meta = {"comm": {"feature_shards": 2, "local_len": local, "alpha": alpha,
                     "feature_dim": feat}}

    def program(c):
        def run(x):
            marks.collective("all_to_all", (FEATURE_AXIS,),
                             torch.zeros((2, 2, c), dtype=torch.int32))
            marks.collective("all_to_all", (FEATURE_AXIS,), torch.zeros((2, 2, c, feat)))
            return x * 2
        return run

    x = torch.ones(4)
    name = "comm" if rule_meta_cap == 2 else "padding"
    return [(_t(f"{name}_over", program(rule_meta_cap * cap), (x,), meta), True),
            (_t(f"{name}_exact", program(cap), (x,), meta), False)]


def _hbm():
    def run(x):
        return torch.tanh(x @ x.T).sum(1)  # a (64, 64) f32 intermediate

    x = torch.ones(64, 32)
    return [(_t("hbm_overrun", run, (x,), {"hbm_budget": 1024}), True),
            (_t("hbm_unpriced", run, (x,), {}), True),
            (_t("hbm_within", run, (x,), {"hbm_budget": 1 << 20}), False)]


def _replication():
    def gathered(x):
        # every member holds the whole (64, 32) table: 8192 bytes
        marks.collective("all_gather", (FEATURE_AXIS,), x.reshape(2, 32, 32))
        return x.sum(0)

    x = torch.ones(64, 32)
    return [(_t("replication_gather", gathered, (x,)), True),
            (_t("replication_routed", _a2a((16, 32)), (x,)), False)]


def _vmem():
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    def run(t, i):
        return gather_rows(t, i)

    def attrs(shared, regs=32, block=256):
        return {"gather": [{"kernel": "gather_kernel<uint4>", "entry": "gather",
                            "block": block, "regs": regs, "shared_static": shared,
                            "shared_dynamic": 0, "local": 0, "max_threads": 1024}]}

    args = (torch.ones(16, 4), torch.arange(8, dtype=torch.int32))
    return [(_t("vmem_shared_over", run, args, {"kernel_attrs": attrs(300_000)}), True),
            (_t("vmem_regs_over", run, args,
                {"kernel_attrs": attrs(0, regs=128, block=1024)}), True),
            (_t("vmem_within", run, args, {"kernel_attrs": attrs(4096)}), False)]


FIXTURES = {
    "collective-parity": _parity,
    "metrics-strip": _metrics,
    "donation-audit": _donation,
    "dtype-discipline": _dtype,
    "constant-bloat": _constants,
    "comm-budget": lambda: _comm(2),
    "peak-hbm-budget": _hbm,
    "no-silent-replication": _replication,
    "vmem-budget": _vmem,
    "padding-waste": lambda: _comm(8),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_catches_its_positive_fixture(rule):
    cases = FIXTURES[rule]()
    built = {t.name: build_from(t, "cpu") for t, _ in cases}
    for t, fire in cases:
        found = rules.RULES[rule](t, built[t.name], built.__getitem__)
        if fire:
            assert found and all(f.rule == rule and not f.suppressed for f in found), t.name
        else:
            assert not found, (t.name, [f.message for f in found])


def test_vmem_budget_on_the_cpu_is_suppressed_not_checked():
    """Without attributes a CPU recording's kernel nodes are each a
    suppressed finding naming why: the check never looks passed."""
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    t = _t("vmem_cpu", lambda tab, i: gather_rows(tab, i),
           (torch.ones(16, 4), torch.arange(8, dtype=torch.int32)))
    found = rules.RULES["vmem-budget"](t, build_from(t, "cpu"), None)
    assert len(found) == 1 and found[0].suppressed
    assert rules.ATTRS_ON_CARD in found[0].message


# -- the registry ----------------------------------------------------------------


def test_repo_audits_clean(registry):
    """Every registered program upholds every rule on the CPU: 0 findings;
    the only suppressions are the kernel nodes' attribute findings."""
    assert registry.exit_code == 0 and registry.findings == []
    assert registry.targets == list(at.REGISTRY)
    assert registry.suppressed
    assert {f.rule for f in registry.suppressed} == {"vmem-budget"}
    assert all(rules.ATTRS_ON_CARD in f.message for f in registry.suppressed)


def test_registry_names_equal_jax(capsys):
    assert list(at.REGISTRY) == list(jax_targets.REGISTRY)
    assert main(["--list-targets"]) == 0
    listed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()
              if not line.startswith(" ")]
    assert listed == list(jax_targets.REGISTRY)


def test_rules_families_and_docs_equal_jax(capsys):
    assert list(rules.RULES) == list(jax_rules.RULES)
    assert rules.FAMILIES == jax_rules.FAMILIES
    assert rules.META_RULES == jax_rules.META_RULES
    for rule in list(rules.RULES) + ["audit-error", "nope"]:
        assert rules.family_of(rule) == jax_rules.family_of(rule)
    assert rules.rule_docs().keys() == jax_rules.rule_docs().keys()
    assert all(rules.rule_docs().values())
    assert main(["--list-rules"]) == 0
    heads = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[")]
    assert heads == [f"[{fam}]" for fam in jax_rules.FAMILIES]


def _a2a_shapes(collectives):
    return [(tuple(c.shape), c.lanes) for c in collectives if c.prim == "all_to_all"]


@pytest.mark.parametrize("name", ["epoch_body_alpha1", "epoch_body_alpha2"])
def test_comm_budget_shapes_and_lanes_equal_jax(name):
    """The routed exchange's all_to_all shapes and lanes equal JAX's built
    epoch body's, and both equal the analytic model."""
    from quiver_tpu_torch.control.cost import routed_lanes_per_hop

    port = at.build(name, "cpu")
    jax_built = jax_targets.build(name)
    got = _a2a_shapes(ir.collectives_of(port.program))
    want = _a2a_shapes(jax_ir.collectives_of(jax_built.jaxpr))
    assert got == want and len(got) == 2
    comm = port.meta["comm"]
    model = routed_lanes_per_hop(comm["local_len"], comm["feature_shards"], comm["alpha"])
    assert all(lanes == model["lanes_per_hop"] for _, lanes in got)
    assert not rules.RULES["comm-budget"](at.REGISTRY[name], port, None)


def _reductions(cols):
    return [c.signature() for c in cols if c.prim in ("psum", "psum2")]


def stripped(on, off):
    """The reductions of ``on`` that ``off`` lacks, as a multiset."""
    extra = list(_reductions(on))
    for sig in _reductions(off):
        extra.remove(sig)
    return sorted((prim, axes, shape) for prim, axes, shape, _ in extra)


def test_metrics_strip_count_equals_jax():
    """metrics_on carries exactly JAX's declared extra reductions over
    metrics_off (the routed overflow's sum over "data", the tier hits' over
    ("data", "feature")), and so do JAX's own built programs."""
    port = stripped(ir.collectives_of(at.build("metrics_on", "cpu").program),
                    ir.collectives_of(at.build("metrics_off", "cpu").program))
    jax = stripped(jax_ir.collectives_of(jax_targets.build("metrics_on").jaxpr),
                   jax_ir.collectives_of(jax_targets.build("metrics_off").jaxpr))
    assert len(port) == at._EXPECTED_METRIC_REDUCTIONS == jax_targets._EXPECTED_METRIC_REDUCTIONS
    assert [(a, s) for _, a, s in port] == [(a, s) for _, a, s in jax]
    off = at.build("metrics_off", "cpu")
    assert not rules.RULES["metrics-strip"](at.REGISTRY["metrics_off"], off,
                                            lambda n: at.build(n, "cpu"))


def test_guarded_metrics_strip_count_equals_jax():
    """With the non-finite guard on, metrics_off keeps the guard's verdict
    sum (it decides every step, as JAX's ``guard_verdict`` psum) and
    metrics_on adds the guard's metric sum: 3 stripped reductions, the
    same signatures as JAX's guarded pair, and the int32 reductions of the
    guarded metrics_off equal JAX's."""
    def target(name, on):
        return Target(name, name, lambda dev: at._step_case(*at._tiny_trainer(
            dev, collect_metrics=on, nonfinite_guard=True)), SRC,
            meta={} if on else {"metrics_pair": "guarded_on",
                                "expected_metric_reductions": 3})

    t_on, t_off = target("guarded_on", True), target("guarded_off", False)
    on, off = build_from(t_on, "cpu"), build_from(t_off, "cpu")
    port = stripped(ir.collectives_of(on.program), ir.collectives_of(off.program))

    def jax_cols(collect):
        built = jax_targets._trace_step(*jax_targets._tiny_trainer(
            collect_metrics=collect, nonfinite_guard=True))
        return jax_ir.collectives_of(built.jaxpr)

    jax_on, jax_off = jax_cols(True), jax_cols(False)
    jax = stripped(jax_on, jax_off)
    assert len(port) == len(jax) == 3
    assert [(a, s) for _, a, s in port] == [(a, s) for _, a, s in jax]
    int32 = lambda cols: sorted(sig[1:3] for sig in _reductions(cols)  # noqa: E731
                                if sig[3] == "int32")
    assert int32(ir.collectives_of(off.program)) == int32(jax_off) == [
        ((DATA_AXIS, FEATURE_AXIS), ())]
    assert not rules.RULES["metrics-strip"](t_off, off, {"guarded_on": on}.__getitem__)


def test_donating_epoch_writes_exactly_its_claim():
    """epoch_donating claims every parameter (SGD keeps no state) and
    writes each in place with its storage kept; no target writes an input."""
    built = at.build("epoch_donating", "cpu")
    trainer, _ = at._tiny_trainer(torch.device("cpu"), donate_epoch_state=True)
    assert built.meta["donated_leaves"] == len(trainer._params()) == len(built.program.claimed)
    written = {k for n in built.program.nodes for k in n.writes}
    assert set(built.program.claimed) <= written
    assert all(a == b for a, b in built.program.claimed.values())
    for name in at.REGISTRY:
        p = at.build(name, "cpu").program
        ws = {k for n in p.nodes for k in n.writes}
        assert not any(v.storage in ws for v in p.inputs), name


def test_fixture_parity_routed_gather_overflows_on_its_second_set():
    """routed_gather's two input sets: the first fits the buckets, the
    second overflows them; one collective schedule either way."""
    built = at.build("routed_gather", "cpu")
    first, second = built.program.result, built.second.result
    assert int(first[1]) == 0 and int(second[1]) > 0
    assert [c.signature() for c in ir.collectives_of(built.program)] == \
        [c.signature() for c in ir.collectives_of(built.second)]


def test_int8_routed_exchange_carries_codes_bitwise():
    """The fault the audit found (dtype-discipline on tiered_lookup_int8):
    the routed exchange of an int8 table moved float32 rows, dequantised
    by the owners. Now the codes ride it and the requesters dequantise,
    and the rows stay bitwise the psum flavour's, capped or not."""
    from quiver_tpu_torch.feature.feature import quantize_rows_int8
    from quiver_tpu_torch.feature.shard import ShardedTensor
    from quiver_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    codes, scale = quantize_rows_int8(x)
    st = ShardedTensor(make_mesh(devices=["cpu"] * 2, data=1, feature=2),
                       kernel="pallas").from_cpu_tensor(codes, scale=scale)
    ids = torch.from_numpy(rng.integers(-1, 64, (2, 24)).astype(np.int32))
    for cap in (None, 3):
        program = ir.record(lambda i: st.routed_gather(i, cap=cap), ids)
        a2a = [c for c in ir.collectives_of(program) if c.prim == "all_to_all"]
        assert [c.dtype for c in a2a] == ["int64", "int8"]
        assert torch.equal(program.result, st.psum_gather(ids))
        assert [n.name for n in program.kernels] == ["gather_rows", "gather_rows",
                                                     "tiered_gather_dequant"]


# -- selection, waivers, CLI ------------------------------------------------------


def test_changed_scoping_and_target_selection():
    assert select_targets(changed=set()) == []
    hit = select_targets(changed={"quiver_tpu_torch/serving/ladder.py"})
    assert set(hit) == {"serve_forward", "serve_sample", "serve_fleet_forward"}
    assert "mmap_tiered_gather" in select_targets(changed={"quiver_tpu_torch/ooc/store.py"})
    assert "pallas_fused_interp" in select_targets(
        changed={"quiver_tpu_torch/ops/election.py"})
    for edit in ("quiver_tpu_torch/tools/audit/rules.py", "quiver_tpu_torch/tools/sarif.py"):
        assert select_targets(changed={edit}) == list(at.REGISTRY)
    with pytest.raises(ValueError):
        select_targets(names=["nope"])


def test_waivers_suppress_with_reason(monkeypatch):
    t = _t("waived_f64", lambda x: (x.double() + 1.0).float(), (torch.ones(4),),
           {"hbm_budget": 1 << 20})
    t = Target(t.name, t.doc, t.builder, t.sources, t.meta,
               waivers={"dtype-discipline": "a fixture that leaks f64 on purpose"})
    monkeypatch.setitem(at.REGISTRY, t.name, t)
    result = run_audit(targets=[t.name], device="cpu")
    assert result.exit_code == 0 and result.findings == []
    assert {f.rule for f in result.suppressed} == {"dtype-discipline"}
    assert (t.name, "dtype-discipline", t.waivers["dtype-discipline"]) in result.waivers
    at._BUILT.pop((t.name, "cpu"), None)


def test_cli_json_and_sarif(tmp_path, capsys, registry):
    """JAX's test_cli_json_and_sarif's contract: one target audited clean,
    the JSON payload in JAX's shape, the SARIF driver and rule ids."""
    sarif = tmp_path / "audit.sarif"
    rc = main(["--targets", "routed_gather", "--json", "--sarif", str(sarif),
               "--device", "cpu"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert list(payload) == ["version", "targets_audited", "findings", "suppressed",
                             "counts", "waivers"]
    assert payload["targets_audited"] == ["routed_gather"]
    assert payload["findings"] == [] and payload["counts"] == {}
    run = json.loads(sarif.read_text())["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftaudit"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == (set(rules.RULES)
                                                                  | {"audit-error"})


def test_cli_usage_errors_and_device(monkeypatch, capsys):
    assert main(["--select", "no-such-rule", "--device", "cpu"]) == 2
    assert main(["--targets", "no-such-target", "--device", "cpu"]) == 2
    assert main(["--mem-table", "--mem-xla"]) == 2
    assert "--mem-cuda" in capsys.readouterr().err
    # the card is the default: without one (and without --device cpu) it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--targets", "routed_gather"])


def test_audit_error_on_a_target_that_fails(monkeypatch):
    def broken(dev):
        raise RuntimeError("fixture gone")

    t = Target("broken", "fails", broken, SRC)
    monkeypatch.setitem(at.REGISTRY, "broken", t)
    result = run_audit(targets=["broken"], device="cpu")
    assert [f.rule for f in result.findings] == ["audit-error"]
    assert "fixture gone" in result.findings[0].message
