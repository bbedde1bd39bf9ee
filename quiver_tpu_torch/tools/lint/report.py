"""Machine-readable graftlint outputs: SARIF for CI annotation, and the
``--debt`` suppression report.

SARIF (Static Analysis Results Interchange Format, 2.1.0) is the shape CI
platforms ingest for inline PR annotation. The document builder lives in
``tools/sarif.py`` — one schema for every analyzer of the repo, so CI
merges their runs into a single ``analysis.sarif`` artifact; this module
binds it to graftlint's rule registry.

The debt report makes reasoned-suppression count visible per PR: every
``# graftlint: disable=... -- why`` and ``# graftlint: eager -- why`` in
the analyzed set, with the annotation's commit age from ``git blame``
(best-effort — "?" off a git checkout) so stale pins are findable.
"""

from __future__ import annotations

import time

from ..sarif import build_sarif_doc
from .rules import family_of, rule_docs
from .runner import LintResult

__all__ = ["build_sarif", "build_debt", "format_debt"]


def build_sarif(result: LintResult) -> dict:
    """SARIF 2.1.0 document for a lint run (active + suppressed)."""
    return build_sarif_doc("graftlint", rule_docs(), family_of,
                           result.findings, result.suppressed)


def _blame_age_days(path: str, line: int) -> float | None:
    """Days since the annotation's line was last touched, via git blame
    (None when git/the repo cannot answer)."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "blame", "-L", f"{line},{line}", "--porcelain",
             "--", path],
            capture_output=True, text=True, timeout=15,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    for out_line in proc.stdout.splitlines():
        if out_line.startswith("committer-time "):
            try:
                then = int(out_line.split()[1])
            except (IndexError, ValueError):
                return None
            return max(time.time() - then, 0.0) / 86400.0
    return None


def build_debt(result: LintResult, blame: bool = True) -> dict:
    """The suppression-debt report: one record per reasoned annotation
    (rule(s), file, line, reason, commit age in days)."""
    records = []
    for a in result.annotations:
        rec = a.to_dict()
        rec["age_days"] = (_blame_age_days(a.path, a.line)
                           if blame else None)
        records.append(rec)
    return {
        "annotations": records,
        "total": len(records),
        "by_rule": _count_by_rule(result),
    }


def _count_by_rule(result: LintResult) -> dict:
    out: dict[str, int] = {}
    for a in result.annotations:
        for r in a.rules:
            out[r] = out.get(r, 0) + 1
    return dict(sorted(out.items()))


def format_debt(debt: dict) -> str:
    """Human-readable debt table (the --debt text output)."""
    lines = [f"graftlint debt: {debt['total']} reasoned annotation(s)"]
    for rule, n in debt["by_rule"].items():
        lines.append(f"  {rule}: {n}")
    for rec in debt["annotations"]:
        age = rec.get("age_days")
        age_s = f"{age:6.0f}d" if age is not None else "     ?"
        lines.append(
            f"  {age_s}  {rec['path']}:{rec['line']}  "
            f"[{','.join(rec['rules'])}]  {rec['reason']}")
    return "\n".join(lines)
