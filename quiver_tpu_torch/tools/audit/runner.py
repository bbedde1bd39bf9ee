"""Audit runner: target selection, rule orchestration, waivers.

The port of ``quiver_tpu/tools/audit/runner.py``, with JAX's result
shape and exit codes. Waivers live on :class:`~.audit_targets.Target`
declarations: a finding on a recorded program has no source line to hang
an inline comment on, so the registry entry that stakes the invariant is
where a reasoned exemption is written down. A rule may also return a
finding already suppressed (``vmem-budget`` on the CPU, where no kernel
attributes exist), which lands among the suppressed findings too.
"""

from __future__ import annotations

import dataclasses
import subprocess

from ..lint.rules import Finding
from .audit_targets import REGISTRY, build
from .rules import FAMILIES, META_RULES, RULES

__all__ = ["AuditResult", "changed_files", "run_audit", "select_targets"]

# an edit here re-audits every target: the auditor itself changed
_AUDITOR = ("quiver_tpu_torch/tools/audit/", "quiver_tpu_torch/tools/sarif.py")


@dataclasses.dataclass
class AuditResult:
    findings: list  # active, sorted
    suppressed: list  # waived or suppressed by their rule, sorted
    targets: list  # target names audited
    waivers: list  # (target, rule, reason) for every waiver consulted

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self):
        return {
            "version": 1,
            "targets_audited": self.targets,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "counts": _counts(self.findings),
            "waivers": [{"target": t, "rule": r, "reason": why}
                        for t, r, why in self.waivers],
        }


def _counts(findings):
    out: dict = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


def changed_files(base: str) -> set:
    """Repo-relative paths changed against a git base (the lint's
    ``--changed``)."""
    try:
        txt = subprocess.run(["git", "diff", "--name-only", base],
                             capture_output=True, text=True, check=True).stdout
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise ValueError(f"cannot diff against base {base!r}: {e}")
    return {line.strip() for line in txt.splitlines() if line.strip()}


def select_targets(names=None, changed=None) -> list:
    """The target set: explicit names, else ``--changed`` scoping (the
    targets whose declared sources meet the diff; an edit under
    ``quiver_tpu_torch/tools/audit/`` or to ``tools/sarif.py`` re-runs every
    target), else all."""
    if names:
        unknown = [n for n in names if n not in REGISTRY]
        if unknown:
            raise ValueError(f"unknown target(s): {', '.join(unknown)} "
                             f"(see --list-targets)")
        return list(names)
    if changed is not None:
        if any(p.startswith(_AUDITOR[0]) or p == _AUDITOR[1] for p in changed):
            return list(REGISTRY)
        return [name for name, t in REGISTRY.items() if changed.intersection(t.sources)]
    return list(REGISTRY)


def _expand(names, what) -> set:
    out: set = set()
    for n in names:
        if n in FAMILIES:
            out.update(FAMILIES[n])
        elif n in RULES or n in META_RULES:
            out.add(n)
        else:
            raise ValueError(f"unknown {what} rule/family: {n!r}")
    return out


def run_audit(select=None, ignore=None, targets=None, changed=None,
              device=None) -> AuditResult:
    """Record every selected target once on ``device`` (the card unless
    the caller names another; raises without one) and run every selected
    rule over each recording; registry waivers demote matching findings to
    suppressed. A target that fails to record is itself a finding
    (``audit-error``): the invariant's program no longer runs."""
    from ...core.memory import resolve_device

    device = resolve_device(device)  # raises without a card unless asked for another
    active = set(RULES)
    if select is not None:
        active = _expand(select, "--select")
    if ignore is not None:
        active -= _expand(ignore, "--ignore")
    names = select_targets(targets, changed)

    findings: list = []
    suppressed: list = []
    waivers: list = []
    for name in names:
        t = REGISTRY[name]
        for rule, reason in sorted(t.waivers.items()):
            waivers.append((name, rule, reason))
        try:
            built = build(name, device)
        except Exception as e:  # noqa: BLE001 -- any build failure is the finding
            if "audit-error" in active or select is None:
                findings.append(Finding(
                    rule="audit-error", path=t.sources[0], line=1, col=0,
                    message=f"[{name}] target failed to record: {type(e).__name__}: {e}"))
            continue
        for rule in sorted(active & set(RULES)):
            for f in RULES[rule](t, built, lambda other: build(other, device)):
                if rule in t.waivers:
                    f.suppressed = True
                (suppressed if f.suppressed else findings).append(f)
    findings.sort(key=lambda f: f.sort_key())
    suppressed.sort(key=lambda f: f.sort_key())
    return AuditResult(findings=findings, suppressed=suppressed, targets=names,
                       waivers=waivers)
