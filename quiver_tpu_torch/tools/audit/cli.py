"""graftaudit CLI for the port.

    python -m quiver_tpu_torch.tools.audit [--device cpu] [--json] \\
        [--sarif PATH] [--select rules] [--ignore rules] [--targets names] \\
        [--changed BASE] [--list-rules] [--list-targets] \\
        [--mem-table [--mem-cuda]]

Exit codes (stable, for CI; the lint's contract):
  0 -- clean (waived and suppressed findings are fine)
  1 -- findings (including targets that fail to record)
  2 -- usage error (unknown rule/family/target, bad --changed base,
       ``--mem-xla``)

The auditor records each target by running it once on small inputs (see
``ir.py``). It runs on the card unless ``--device cpu`` is given; with no
card and no ``--device`` it raises, as every entry point of the port does.
``--mem-cuda`` (the JAX package's ``--mem-xla``) joins the card's measured
growth (``mem.cuda_memory_stats``) to the memory table.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.tools.audit",
        description="graftaudit: the program auditor over recorded torch "
                    "programs: collective parity, metric stripping, donation "
                    "(writes in place), dtype discipline, host-built "
                    "constants, the comm budget and the memory family "
                    "(peak, replication, kernel resources, padding)",
    )
    p.add_argument("--device", default=None,
                   help="where to record the programs: cuda (the default; "
                        "raises without a card) or cpu")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--select", default=None,
                   help="comma-separated rules/families to run (default: all)")
    p.add_argument("--ignore", default=None,
                   help="comma-separated rules/families to skip")
    p.add_argument("--targets", default=None,
                   help="comma-separated registry targets to audit (default: all)")
    p.add_argument("--changed", default=None, metavar="BASE",
                   help="audit only targets whose declared sources changed "
                        "vs the given git base")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="write a SARIF 2.1.0 report to PATH ('-' for stdout)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry (grouped by family) and exit")
    p.add_argument("--list-targets", action="store_true",
                   help="print the audited program registry and exit")
    p.add_argument("--mem-table", action="store_true",
                   help="print the per-target memory table (estimate, args, "
                        "out, growth, budget, headroom) and exit")
    p.add_argument("--mem-cuda", action="store_true",
                   help="with --mem-table: run each target once more on the "
                        "card and join its measured growth of "
                        "max_memory_allocated as a column")
    p.add_argument("--mem-xla", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from .rules import FAMILIES, family_of, rule_docs

    if args.mem_xla:
        print("graftaudit: error: --mem-xla is the JAX package's; the port "
              "measures on the card with --mem-cuda", file=sys.stderr)
        return 2
    if args.list_rules:
        docs = rule_docs()
        for fam, rules in FAMILIES.items():
            print(f"[{fam}]")
            for name in rules:
                first = docs[name].splitlines()[0] if docs.get(name) else ""
                print(f"  {name}: {first}")
        return 0
    from .audit_targets import REGISTRY
    from .runner import changed_files, run_audit

    if args.list_targets:
        for name, t in REGISTRY.items():
            print(f"{name}: {t.doc}")
            print(f"    sources: {', '.join(t.sources)}")
            for rule, reason in sorted(t.waivers.items()):
                print(f"    waiver[{rule}]: {reason}")
        return 0
    split = (lambda s: [r.strip() for r in s.split(",") if r.strip()])
    if args.mem_table:
        from .mem import format_peak_table, peak_table

        names = split(args.targets) if args.targets else None
        try:
            rows = peak_table(names, device=args.device, with_cuda=args.mem_cuda)
        except KeyError as e:
            print(f"graftaudit: error: unknown target {e}", file=sys.stderr)
            return 2
        print(format_peak_table(rows))
        over = [r for r in rows if r["hbm_budget"] is None or r["headroom_bytes"] < 0]
        return 1 if over else 0
    try:
        changed = None
        if args.changed is not None:
            changed = changed_files(args.changed)
        result = run_audit(
            select=split(args.select) if args.select else None,
            ignore=split(args.ignore) if args.ignore else None,
            targets=split(args.targets) if args.targets else None,
            changed=changed, device=args.device)
    except ValueError as e:
        print(f"graftaudit: error: {e}", file=sys.stderr)
        return 2
    if args.sarif:
        from ..sarif import build_sarif_doc

        doc = json.dumps(build_sarif_doc("graftaudit", rule_docs(), family_of,
                                         result.findings, result.suppressed), indent=1)
        if args.sarif == "-":
            print(doc)
        else:
            with open(args.sarif, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")
    if args.as_json:
        print(json.dumps(result.to_dict(), indent=1))
        return result.exit_code
    for f in result.findings:
        print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule}: [{family_of(f.rule)}] {f.message}")
    changed_note = "" if changed is None else f" [--changed: {len(changed)} changed file(s)]"
    print(f"graftaudit: {len(result.findings)} finding(s) ({len(result.suppressed)} "
          f"suppressed) across {len(result.targets)} program(s){changed_note}")
    return result.exit_code
