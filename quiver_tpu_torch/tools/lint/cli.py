"""graftlint CLI.

    python -m quiver_tpu_torch.tools.lint quiver_tpu_torch/ chip_smoke.py examples/*_torch.py

Exit codes (stable, for CI):
  0 — clean (suppressed findings are fine)
  1 — findings (including parse errors and bad suppressions)
  2 — usage error (unknown rule/family, missing path, bad --changed base)

``--select``/``--ignore`` accept rule names AND family names (trace,
consistency, staleness, transaction, concurrency). ``--changed BASE``
restricts *reporting* to files in ``git diff --name-only BASE`` — the
analysis still runs over the full path set so cross-file facts (axis
constants, the call graph, guard propagation) stay sound. ``--sarif
PATH`` writes a SARIF 2.1.0 document for CI annotation ("-" = stdout);
``--debt`` prints the reasoned-suppression report (with --json, embeds it
in the JSON document).
"""

from __future__ import annotations

import argparse
import json
import sys

from .rules import FAMILIES, family_of, rule_docs
from .runner import changed_files, lint_paths

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.tools.lint",
        description="graftlint — capture-safety, axis-consistency and "
                    "dataflow (staleness/transaction/concurrency) static "
                    "analysis for quiver_tpu_torch",
    )
    p.add_argument("paths", nargs="*", default=["."],
                   help="files or directories to lint (default: .)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--select", default=None,
                   help="comma-separated rules/families to run "
                        "(default: all)")
    p.add_argument("--ignore", default=None,
                   help="comma-separated rules/families to skip")
    p.add_argument("--changed", default=None, metavar="BASE",
                   help="report findings only for files changed vs the "
                        "given git base (analysis stays whole-tree)")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="write a SARIF 2.1.0 report to PATH ('-' for "
                        "stdout) for CI annotation")
    p.add_argument("--debt", action="store_true",
                   help="print the reasoned-suppression debt report "
                        "(rule, file, reason, commit age)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry (grouped by family) "
                        "and exit")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        docs = rule_docs()
        for fam, rules in FAMILIES.items():
            print(f"[{fam}]")
            for name in rules:
                doc = docs.get(name, "")
                first = doc.splitlines()[0] if doc else ""
                print(f"  {name}: {first}")
        return 0
    split = (lambda s: [r.strip() for r in s.split(",") if r.strip()])
    try:
        only = None
        if args.changed is not None:
            only = changed_files(args.changed)
        result = lint_paths(
            args.paths,
            select=split(args.select) if args.select else None,
            ignore=split(args.ignore) if args.ignore else None,
            only=only,
        )
    except (FileNotFoundError, ValueError) as e:
        print(f"graftlint: error: {e}", file=sys.stderr)
        return 2
    if args.sarif:
        from .report import build_sarif

        doc = json.dumps(build_sarif(result), indent=1)
        if args.sarif == "-":
            print(doc)
        else:
            with open(args.sarif, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")
    debt = None
    if args.debt:
        from .report import build_debt

        debt = build_debt(result)
    if args.as_json:
        payload = result.to_dict()
        if debt is not None:
            payload["debt"] = debt
        print(json.dumps(payload, indent=1))
        return result.exit_code
    for f in result.findings:
        print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule}: "
              f"[{family_of(f.rule)}] {f.message}")
    if debt is not None:
        from .report import format_debt

        print(format_debt(debt))
    changed_note = ""
    if only is not None:
        changed_note = f" [--changed: {len(only)} candidate file(s)]"
    print(
        f"graftlint: {len(result.findings)} finding(s) "
        f"({len(result.suppressed)} suppressed) in "
        f"{len(result.files)} file(s){changed_note}"
    )
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
