"""graftlint of quiver_tpu_torch (``quiver_tpu_torch/tools/lint``,
``tools/sarif.py``) against quiver_tpu's.

- The rules that know nothing of either framework (``export-doc-drift``,
  the staleness, transaction and concurrency families) run over the JAX
  package's fixtures in ``tests/lint_fixtures/`` (parsed, never imported
  or edited) in both packages: the findings are identical as ``(rule,
  path, line, col, message)``.
- The rules re-grounded in torch (the ``trace`` family and
  ``axis-name-consistency``) each have torch positives that fire and
  negatives that stay clean, written to ``tmp_path``. One positive is PR
  12's failure: an ``.item()`` reached from a ``torch.cuda.graph`` body.
- Suppressions, the CLI's exit codes, SARIF, the families, and the gate:
  ``python -m quiver_tpu_torch.tools.lint quiver_tpu_torch/ chip_smoke.py
  examples/*_torch.py`` exits 0.
"""

import glob
import json
import os
import textwrap

import pytest

from quiver_tpu.tools import lint as lint_j
from quiver_tpu.tools.lint.report import build_sarif as sarif_j

from quiver_tpu_torch.tools import lint as lint_t
from quiver_tpu_torch.tools.lint.report import build_sarif as sarif_t
from quiver_tpu_torch.tools.sarif import merge_sarif

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "lint_fixtures")
REPO = os.path.dirname(HERE)

AGNOSTIC = ("export-doc-drift", "stale-version-read", "non-atomic-publish",
            "commit-marker-order", "replace-without-fsync", "executor-lifecycle",
            "lock-held-across-call", "metric-name-constant")
REGROUNDED = ("env-at-trace", "cond-branch-parity", "host-op-on-tracer",
              "per-call-logging-in-jit", "axis-name-consistency")


def _rows(result):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in result.findings]


def _write(tmp_path, src: str, name: str = "m.py") -> str:
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def _hits(path, rule):
    return [f for f in lint_t.lint_paths([path]).findings if f.rule == rule]


# -- the framework-agnostic rules: JAX's findings on JAX's fixtures ----------


@pytest.mark.parametrize("fixture", sorted(os.listdir(FIXTURES)))
@pytest.mark.parametrize("rule", AGNOSTIC)
def test_agnostic_rule_findings_equal_jax(rule, fixture):
    path = os.path.join(FIXTURES, fixture)
    want = lint_j.lint_paths([path], select=[rule])
    got = lint_t.lint_paths([path], select=[rule])
    assert _rows(got) == _rows(want)
    assert [f.rule for f in got.suppressed] == [f.rule for f in want.suppressed]


def test_agnostic_positives_fire_on_the_fixture_tree():
    want = lint_j.lint_paths([FIXTURES], select=list(AGNOSTIC))
    got = lint_t.lint_paths([FIXTURES], select=list(AGNOSTIC))
    assert _rows(got) == _rows(want)
    assert {f.rule for f in got.findings} == {
        "stale-version-read", "non-atomic-publish", "commit-marker-order",
        "replace-without-fsync", "executor-lifecycle", "lock-held-across-call",
        "metric-name-constant"}


@pytest.mark.parametrize("documented", [["alpha", "beta"], ["alpha", "beta", "gamma"]])
def test_export_doc_drift_equals_jax(tmp_path, documented):
    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("alpha = beta = gamma = None\n"
                                     "__all__ = ['alpha', 'beta', 'gamma']\n")
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "API.md").write_text(
        "\n".join(f"| `{n}` | doc |" for n in documented) + "\n")
    init = str(pkg / "__init__.py")
    got = lint_t.lint_paths([init], select=["export-doc-drift"])
    assert _rows(got) == _rows(lint_j.lint_paths([init], select=["export-doc-drift"]))
    assert len(got.findings) == 3 - len(documented)


# -- the re-grounded rules: torch positives and negatives ---------------------

# (rule, source, findings expected): each positive fires, each negative
# stays clean
CASES = {
    # PR 12's failure: a host read reached from a CUDA-graph capture
    "host_op_pr12_graph_item": ("host-op-on-tracer", """
        import torch

        def step(x):
            loss = (x * 2).sum()
            return loss.item()

        def capture(g, static_x):
            with torch.cuda.graph(g):
                out = step(static_x)
            return out
        """, 1),
    "host_op_region_direct": ("host-op-on-tracer", """
        import torch

        def capture(g, model, x):
            with torch.cuda.graph(g):
                y = model(x)
                n = int(y.sum())
                rows = y[y > 0]
                idx = torch.nonzero(y)
                torch.cuda.synchronize()
            return n, rows, idx
        """, 4),
    "host_op_graphed_callable": ("host-op-on-tracer", """
        import numpy as np
        import torch

        def body(x, counts):
            a = x.tolist()
            b = np.asarray(x)
            c = torch.repeat_interleave(x, counts)
            d = x.cpu()
            e = torch.unique(x)
            return a, b, c, d, e

        fn = torch.cuda.make_graphed_callables(body, (torch.zeros(4), torch.ones(4)))
        """, 5),
    "host_op_self_step_narrowed": ("host-op-on-tracer", """
        import torch

        class _Program:
            def __init__(self, step):
                self.step = step

            def capture(self, g):
                with torch.cuda.graph(g):
                    return self.step()

        class Trainer:
            def step(self, x):
                return x.sum().item()  # eager: never captured

        def build(x):
            def step():
                return x.sum().item()
            return _Program(step)
        """, 1),
    "host_op_neg": ("host-op-on-tracer", """
        import numpy as np
        import torch

        def eager(x):
            return x.sum().item(), x.tolist(), x[x > 0]

        def body(x, counts):
            rows = int(x.shape[0]) + x.numel() + len(x)
            y = torch.repeat_interleave(x, counts, output_size=8)
            if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
                z = int(x.sum())
            else:
                z = 0
            return rows, y, z

        fn = torch.cuda.make_graphed_callables(body, (torch.zeros(4), torch.ones(4)))
        """, 0),
    "env_at_trace_compile_pos": ("env-at-trace", """
        import os
        import torch

        def counts_strategy():
            return os.environ.get("QUIVER_COUNTS", "scatter")

        @torch.compile
        def aggregate(x):
            if counts_strategy() == "scan":
                return x.cumsum(0)
            return x.sum(0)
        """, 1),
    "env_at_trace_neg": ("env-at-trace", """
        import os
        import torch

        _STRATEGY = None

        def counts_strategy():
            global _STRATEGY
            if _STRATEGY is None:
                _STRATEGY = os.environ.get("QUIVER_COUNTS", "scatter")
            return _STRATEGY

        @torch.compile
        def aggregate(x):
            return x.cumsum(0) if counts_strategy() == "scan" else x.sum(0)
        """, 0),
    "logging_pos": ("per-call-logging-in-jit", """
        import logging
        import torch

        logger = logging.getLogger("q")

        def per_row(x):
            logger.info("row %s", x.shape)
            return x * 2

        def capture(g, x):
            batched = torch.func.vmap(per_row)
            with torch.cuda.graph(g):
                print("captured")
                return batched(x)
        """, 2),
    "logging_neg": ("per-call-logging-in-jit", """
        import logging
        import torch

        logger = logging.getLogger("q")
        _SEEN = set()

        def info_once(key, msg):
            if key not in _SEEN:
                _SEEN.add(key)
                logger.info(msg)

        def per_row(x):
            info_once("rows", "first trace")
            return x * 2

        def run(x):
            logger.info("eager: %s", x.shape)
            return torch.func.vmap(per_row)(x)
        """, 0),
    "cond_parity_pos": ("cond-branch-parity", """
        import torch

        def routed(pred, ids, table):
            def _fallback(ids):
                return table[ids], ids.sum()

            def _clean(ids):
                return torch.zeros(ids.shape[0], table.shape[1])

            return torch.cond(pred, _fallback, _clean, (ids,))
        """, 1),
    "cond_parity_neg": ("cond-branch-parity", """
        import torch

        def routed(pred, ids, table):
            def _fallback(ids):
                return table[ids], ids.sum()

            def _clean(ids):
                return torch.zeros(ids.shape[0], table.shape[1]), ids.sum() * 0

            return torch.cond(pred, _fallback, _clean, (ids,))
        """, 0),
    "axis_name_pos": ("axis-name-consistency", """
        DATA_AXIS = "data"
        FEATURE_AXIS = "feature"

        def report(tape, mesh, feats, ShardedFeature, BucketRoute, ids):
            tape.add("feature.lookups", 1, psum=("data",))
            store = ShardedFeature(mesh, axis="features")
            route = BucketRoute(ids, "feature")
            return mesh.shape["data"], store, route
        """, 4),
    "axis_name_neg": ("axis-name-consistency", """
        DATA_AXIS = "data"
        FEATURE_AXIS = "feature"

        def report(tape, mesh, ShardedFeature, arr, table):
            tape.add("feature.lookups", 1, psum=(DATA_AXIS,))
            store = ShardedFeature(mesh, axis=FEATURE_AXIS)
            return mesh.shape[DATA_AXIS], store, arr.sum(axis=0), table["data"]
        """, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_regrounded_rule_fixture(tmp_path, case):
    rule, src, want = CASES[case]
    hits = _hits(_write(tmp_path, src), rule)
    assert len(hits) == want, [(f.line, f.message) for f in hits]
    if case == "host_op_pr12_graph_item":
        (f,) = hits
        assert ".item()" in f.message
        assert "capture.<cuda.graph@9> -> step" in f.message
    if case == "host_op_self_step_narrowed":
        # the closure the constructor stored, not the homonymous method
        assert "build.step" in hits[0].message and hits[0].line == 18


def test_regrounded_rules_cover_the_torch_families():
    assert set(REGROUNDED) | set(AGNOSTIC) == set(lint_t.RULES)
    for rule in REGROUNDED:
        assert any(r == rule and n > 0 for r, _s, n in CASES.values()), rule
        assert any(r == rule and n == 0 for r, _s, n in CASES.values()), rule


def test_capture_guard_and_eager_pin_stop_the_walk(tmp_path):
    """A call under a false ``is_current_stream_capturing()`` and an eager
    pin are barriers: nothing behind them is captured."""
    src = """
        import torch

        def check_layout(dst):
            return int(dst.sum())

        # graftlint: eager -- runs eagerly by contract
        def tuner(x):
            return x.max().item()

        def gate(dst):
            if not (dst.is_cuda and torch.cuda.is_current_stream_capturing()):
                check_layout(dst)
            if torch.cuda.is_current_stream_capturing():
                pass
            else:
                check_layout(dst)
            tuner(dst)
            return dst

        def capture(g, dst):
            with torch.cuda.graph(g):
                return gate(dst)
        """
    res = lint_t.lint_paths([_write(tmp_path, src)])
    assert res.findings == []
    # without the guard the read is found
    res = lint_t.lint_paths([_write(tmp_path, src.replace(
        "if not (dst.is_cuda and torch.cuda.is_current_stream_capturing()):", "if True:"))])
    assert [f.rule for f in res.findings] == ["host-op-on-tracer"]


# -- suppressions ---------------------------------------------------------------

SUPPRESSION_CASES = {
    "reasoned": ("# graftlint: disable=host-op-on-tracer -- fixture: read by design",
                 [], ["host-op-on-tracer"]),
    "reasonless": ("# graftlint: disable=host-op-on-tracer",
                   ["bad-suppression", "host-op-on-tracer"], []),
    "unknown_rule": ("# graftlint: disable=not-a-rule -- whatever",
                     ["bad-suppression", "host-op-on-tracer"], []),
    "malformed": ("# graftlint: disabel=host-op-on-tracer -- typo",
                  ["bad-suppression", "host-op-on-tracer"], []),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppression_semantics(tmp_path, case):
    comment, active, suppressed = SUPPRESSION_CASES[case]
    src = f"""
        import torch

        def step(x):
            {comment}
            return x.sum().item()

        fn = torch.compile(step)
        """
    res = lint_t.lint_paths([_write(tmp_path, src)])
    assert sorted(f.rule for f in res.findings) == active
    assert [f.rule for f in res.suppressed] == suppressed
    assert res.exit_code == (1 if active else 0)
    if case == "reasoned":
        assert [a.reason for a in res.annotations] == ["fixture: read by design"]


@pytest.mark.parametrize("reason", ["", " -- eager-only tuner"])
def test_eager_pin_requires_a_reason(tmp_path, reason):
    src = f"""
        import os
        import torch

        # graftlint: eager{reason}
        def tuner(store):
            return os.environ.get("K")

        @torch.compile
        def step(x, store):
            tuner(store)
            return x
        """
    rules = sorted(f.rule for f in lint_t.lint_paths([_write(tmp_path, src)]).findings)
    assert rules == ([] if reason else ["bad-suppression", "env-at-trace"])


def test_parse_error_is_a_finding(tmp_path):
    res = lint_t.lint_paths([_write(tmp_path, "def f(:\n", "broken.py")])
    assert [f.rule for f in res.findings] == ["parse-error"] and res.exit_code == 1


# -- the CLI, SARIF, the families ---------------------------------------------------


@pytest.mark.parametrize("argv,code", [
    (["{clean}"], 0),
    (["{clean}", "--json"], 0),
    (["{pos}"], 1),
    (["{pos}", "--json"], 1),
    (["{pos}", "--select", "env-at-trace"], 0),
    (["{pos}", "--select", "trace"], 1),
    (["{pos}", "--ignore", "host-op-on-tracer"], 0),
    (["{pos}", "--ignore", "trace"], 0),
    (["{missing}"], 2),
    (["{clean}", "--select", "bogus-rule"], 2),
    (["{clean}", "--ignore", "bogus-family"], 2),
    (["--list-rules"], 0),
])
def test_cli_exit_codes(tmp_path, capsys, argv, code):
    paths = {"clean": _write(tmp_path, "x = 1\n", "clean.py"),
             "pos": _write(tmp_path, CASES["host_op_pr12_graph_item"][1], "pos.py"),
             "missing": str(tmp_path / "missing_dir")}
    assert lint_t.main([a.format(**paths) for a in argv]) == code
    out = capsys.readouterr().out
    if "--json" in argv:
        doc = json.loads(out)
        assert doc["version"] == 2
        assert doc["counts"] == ({"host-op-on-tracer": 1} if code else {})
    if "--list-rules" in argv:
        for fam, rules in lint_t.FAMILIES.items():
            assert f"[{fam}]" in out and all(r in out for r in rules)


def test_families_are_jax_and_cover_the_registry():
    assert lint_t.FAMILIES == lint_j.FAMILIES
    assert sorted(lint_t.RULES) == sorted(lint_j.RULES)
    flat = [r for rules in lint_t.FAMILIES.values() for r in rules]
    assert sorted(flat) == sorted(lint_t.RULES) and len(flat) == len(set(flat))
    assert lint_t.family_of("bad-suppression") == "meta"


def test_sarif_rule_ids_and_results(tmp_path, capsys):
    fx = os.path.join(FIXTURES, "txn_checkpoint_pos.py")
    out = tmp_path / "lint.sarif"
    assert lint_t.main([fx, "--sarif", str(out), "--select", "transaction"]) == 1
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    (run,) = doc["runs"]
    assert run["tool"]["driver"]["name"] == "graftlint"
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    want = sarif_j(lint_j.lint_paths([fx], select=["transaction"]))
    assert ids == [r["id"] for r in want["runs"][0]["tool"]["driver"]["rules"]]
    assert run["results"] == want["runs"][0]["results"]
    assert {r["ruleId"] for r in run["results"]} <= set(lint_t.FAMILIES["transaction"])
    # suppressed results carry their justification
    src = _write(tmp_path, """
        import torch

        def step(x):
            # graftlint: disable=host-op-on-tracer -- fixture
            return x.sum().item()

        fn = torch.compile(step)
        """)
    doc = sarif_t(lint_t.lint_paths([src]))
    (res,) = doc["runs"][0]["results"]
    assert res["suppressions"][0]["kind"] == "inSource"
    assert len(merge_sarif([doc, doc])["runs"]) == 2


def test_debt_report(tmp_path, capsys):
    src = _write(tmp_path, """
        import torch

        def step(x):
            # graftlint: disable=host-op-on-tracer -- fixture debt
            return x.sum().item()

        fn = torch.compile(step)
        """)
    assert lint_t.main([src, "--json", "--debt"]) == 0
    debt = json.loads(capsys.readouterr().out)["debt"]
    assert debt["total"] == 1 and debt["by_rule"] == {"host-op-on-tracer": 1}
    assert debt["annotations"][0]["reason"] == "fixture debt"


# -- the gate: the port lints clean -------------------------------------------------


def test_port_lints_clean(capsys):
    """``python -m quiver_tpu_torch.tools.lint quiver_tpu_torch/ chip_smoke.py
    examples/*_torch.py`` exits 0, every suppression reasoned (a reasonless
    one is a bad-suppression finding and fails this), and the CUDA-graph
    capture of the serving ladder is an entry the walk follows."""
    paths = [os.path.join(REPO, "quiver_tpu_torch"), os.path.join(REPO, "chip_smoke.py"),
             *sorted(glob.glob(os.path.join(REPO, "examples", "*_torch.py")))]
    res = lint_t.lint_paths(paths)
    assert res.findings == [], [f"{f.path}:{f.line}: {f.rule}: {f.message}"
                                for f in res.findings]
    assert res.suppressed and all(a.reason for a in res.annotations)
    assert lint_t.main(paths) == 0
    capsys.readouterr()


def test_port_tools_import_neither_jax_nor_the_jax_package():
    import ast

    for path in glob.glob(os.path.join(REPO, "quiver_tpu_torch", "tools", "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "flax", "optax", "quiver_tpu"), path


@pytest.mark.parametrize("name,code", [("clean.py", 0), ("pos.py", 1)])
def test_module_entry_point_exit_codes(tmp_path, name, code):
    """``python -m quiver_tpu_torch.tools.lint`` exits with the CLI's code
    (importing the package's ``__main__`` runs nothing)."""
    import subprocess
    import sys

    src = "x = 1\n" if code == 0 else CASES["host_op_pr12_graph_item"][1]
    path = _write(tmp_path, src, name)
    res = subprocess.run([sys.executable, "-m", "quiver_tpu_torch.tools.lint", path],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == code, res.stdout + res.stderr
