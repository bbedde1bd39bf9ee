"""graftlint runner: file collection, suppressions, rule orchestration.

Suppression syntax (reason REQUIRED — a suppression that does not say why
is itself a finding, and cannot be suppressed):

    x = os.environ.get("K")  # graftlint: disable=env-at-trace -- initial default only
    # graftlint: disable=axis-name-consistency -- fixture exercises drift
    psum(x, "data")

A comment alone on its line covers the next line; a trailing comment
covers its own line. Multiple rules: ``disable=rule-a,rule-b -- reason``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

from .analysis import SourceFile, analyze
from .rules import FAMILIES, Finding, META_RULES, RULES

__all__ = ["LintResult", "changed_files", "collect_files", "lint_paths"]

# anchored at the comment START: a directive is the comment's whole job —
# prose that merely QUOTES the syntax mid-comment (the lint tool's own
# sources do) is not an annotation and must not land in the --debt report
_SUPPRESS_RE = re.compile(
    r"^#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+?)"
    r"(?:\s*--\s*(.*?))?\s*$"
)
# function-level trace barrier: on (or directly above) a def line, declares
# the function eager-only by contract; reason mandatory like suppressions
_EAGER_RE = re.compile(r"^#\s*graftlint:\s*eager(?:\s*--\s*(.*?))?\s*$")


@dataclasses.dataclass
class Suppression:
    line: int  # line the comment sits on
    target_line: int  # line whose findings it covers
    rules: tuple[str, ...]
    reason: str


@dataclasses.dataclass
class Annotation:
    """One graftlint source annotation (suppression or eager pin) — the
    unit of the ``--debt`` report: every one is reasoned by construction
    (reasonless annotations are bad-suppression findings instead)."""

    kind: str  # "disable" | "eager"
    path: str
    line: int
    rules: tuple[str, ...]  # ("eager",) for pins
    reason: str

    def to_dict(self):
        return {"kind": self.kind, "path": self.path, "line": self.line,
                "rules": list(self.rules), "reason": self.reason}


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]  # active (unsuppressed), sorted
    suppressed: list[Finding]
    files: list[str]
    # every reasoned annotation in the analyzed set (suppression debt)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self):
        return {
            "version": 2,
            "files_analyzed": len(self.files),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "counts": _counts(self.findings),
            "annotations": [a.to_dict() for a in self.annotations],
        }


def _counts(findings):
    out: dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


def collect_files(paths) -> list[str]:
    """Expand files/directories into a sorted .py file list (skips hidden
    dirs and __pycache__)."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d != "__pycache__"
                )
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.append(os.path.join(root, n))
        else:
            raise FileNotFoundError(p)
    seen = set()
    uniq = []
    for p in out:
        key = os.path.abspath(p)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    return uniq


def _display_path(path: str) -> str:
    rel = os.path.relpath(path)
    return rel if not rel.startswith("..") else os.path.abspath(path)


def _parse_suppressions(path: str, text: str):
    """(suppressions, eager-pin lines, bad-suppression findings)."""
    sups: list[Suppression] = []
    eager: dict[int, str] = {}
    bad: list[Finding] = []
    known = set(RULES) | set(META_RULES)
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        comments = [(t.start[0], t.start[1], t.string)
                    for t in tokens if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sups, eager, bad
    lines = text.splitlines()
    for lineno, col, comment in comments:
        em = _EAGER_RE.search(comment)
        if em:
            reason = (em.group(1) or "").strip()
            if not reason:
                bad.append(Finding(
                    "bad-suppression", path, lineno, col,
                    "eager pin without a reason; every graftlint "
                    "annotation must say WHY: "
                    "'# graftlint: eager -- <reason>'"))
                continue
            own_line = lines[lineno - 1] if lineno <= len(lines) else ""
            standalone = own_line[:col].strip() == ""
            eager[lineno + 1 if standalone else lineno] = reason
            continue
        m = _SUPPRESS_RE.search(comment)
        if not m:
            # only comments that START with the marker are directives;
            # prose that merely mentions/quotes graftlint syntax is fine
            if re.match(r"^#\s*graftlint\s*:", comment):
                bad.append(Finding(
                    "bad-suppression", path, lineno, col,
                    "malformed graftlint comment; expected '# graftlint: "
                    "disable=<rule>[,<rule>] -- <reason>' or "
                    "'# graftlint: eager -- <reason>'"))
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        unknown = [r for r in rules if r not in known]
        if unknown:
            bad.append(Finding(
                "bad-suppression", path, lineno, col,
                f"unknown rule(s) {unknown} in suppression; known rules: "
                f"{sorted(RULES)}"))
            continue
        if not reason:
            bad.append(Finding(
                "bad-suppression", path, lineno, col,
                "suppression without a reason; every graftlint suppression "
                "must say WHY: '# graftlint: disable=<rule> -- <reason>'"))
            continue
        own_line = lines[lineno - 1] if lineno <= len(lines) else ""
        standalone = own_line[:col].strip() == ""
        target = lineno + 1 if standalone else lineno
        sups.append(Suppression(lineno, target, rules, reason))
    return sups, eager, bad


def _expand_rule_tokens(tokens) -> set[str]:
    """Resolve a select/ignore token list: family names expand to their
    member rules; unknown tokens raise."""
    out: set[str] = set()
    unknown = []
    for tok in tokens:
        if tok in FAMILIES:
            out.update(FAMILIES[tok])
        elif tok in RULES:
            out.add(tok)
        else:
            unknown.append(tok)
    if unknown:
        raise ValueError(
            f"unknown rule(s)/famil(ies): {sorted(unknown)} "
            f"(rules: {sorted(RULES)}; families: {sorted(FAMILIES)})")
    return out


def changed_files(base: str, cwd: str | None = None) -> set[str]:
    """Absolute paths of .py files changed vs ``base`` per ``git diff
    --name-only`` (committed + staged + worktree changes). Raises
    ValueError when git cannot answer (not a repo, unknown base)."""
    import subprocess

    cwd = cwd or os.getcwd()
    try:
        proc = subprocess.run(
            ["git", "diff", "--name-only", base, "--"],
            cwd=cwd, capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise ValueError(f"--changed: cannot run git: {e}") from e
    if proc.returncode != 0:
        raise ValueError(
            f"--changed: git diff --name-only {base} failed: "
            f"{proc.stderr.strip()}")
    root = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        cwd=cwd, capture_output=True, text=True, timeout=30,
    ).stdout.strip() or cwd
    return {
        os.path.abspath(os.path.join(root, line.strip()))
        for line in proc.stdout.splitlines()
        if line.strip().endswith(".py")
    }


def lint_paths(paths, select=None, ignore=None, only=None) -> LintResult:
    """Run graftlint over files/directories. ``select``/``ignore`` are
    iterables of rule names OR family names (select wins; both default to
    all rules). ``only`` (a set of absolute file paths — the --changed
    mode) restricts which files findings are REPORTED for; the analysis
    itself always runs over the full file set so cross-file facts (axis
    constants, the call graph, guard propagation) stay sound."""
    file_paths = collect_files(paths)
    sources: list[SourceFile] = []
    findings: list[Finding] = []
    suppressions: dict[str, list[Suppression]] = {}
    annotations: list[Annotation] = []
    for path in file_paths:
        display = _display_path(path)
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            tree = ast.parse(text, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            findings.append(Finding(
                "parse-error", display,
                getattr(e, "lineno", 1) or 1, 0,
                f"cannot analyze: {type(e).__name__}: {e}"))
            continue
        sups, eager, bad = _parse_suppressions(display, text)
        sources.append(SourceFile(path=display, text=text, tree=tree,
                                  eager_lines=eager))
        suppressions[display] = sups
        findings.extend(bad)
        for s in sups:
            annotations.append(Annotation(
                "disable", display, s.line, s.rules, s.reason))
        for line, reason in sorted(eager.items()):
            annotations.append(Annotation(
                "eager", display, line, ("eager",), reason))

    project = analyze(sources)
    active_rules = dict(RULES)
    if select:
        wanted = _expand_rule_tokens(select)
        active_rules = {k: v for k, v in RULES.items() if k in wanted}
    if ignore:
        dropped = _expand_rule_tokens(ignore)
        active_rules = {k: v for k, v in active_rules.items()
                        if k not in dropped}
    for check in active_rules.values():
        findings.extend(check(project))

    active: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        hit = None
        if f.rule not in META_RULES:  # meta findings cannot be suppressed
            for s in suppressions.get(f.path, []):
                if f.line == s.target_line and f.rule in s.rules:
                    hit = s
                    break
        if hit is not None:
            f.suppressed = True
            suppressed.append(f)
        else:
            active.append(f)
    if only is not None:
        keep = {os.path.abspath(p) for p in only}

        def kept(f: Finding) -> bool:
            return os.path.abspath(f.path) in keep

        active = [f for f in active if kept(f)]
        suppressed = [f for f in suppressed if kept(f)]
        annotations = [a for a in annotations
                       if os.path.abspath(a.path) in keep]
    active.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    annotations.sort(key=lambda a: (a.path, a.line))
    return LintResult(findings=active, suppressed=suppressed,
                      files=[s.path for s in sources],
                      annotations=annotations)
