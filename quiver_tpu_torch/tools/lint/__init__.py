"""graftlint — capture-safety and consistency static analysis for the
PyTorch/CUDA port.

AST-only (the analyzed code is never imported). The rules, their names and
families, the suppression syntax, the CLI and the SARIF output are the JAX
package's graftlint's; the ``trace`` family and ``axis-name-consistency``
are grounded in torch:

* ``env-at-trace`` — ``os.environ`` reads reachable from code that runs
  under CUDA-graph capture or a torch trace: the value is pinned at
  capture while looking like a live switch.
* ``axis-name-consistency`` — axis names in ``psum=``, ``axis=``,
  ``mesh.shape[...]`` and ``BucketRoute`` must use the shared
  ``parallel/mesh.py`` constants; unknown literals are flagged as drift.
* ``cond-branch-parity`` — ``torch.cond`` branches returning mismatched
  tuple structure.
* ``host-op-on-tracer`` — host reads under capture: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``int()`` of a tensor, data-dependent shapes,
  boolean masks, ``torch.cuda.synchronize()`` (PR 12's captured trainer
  step failed on the card for one).
* ``per-call-logging-in-jit`` — logging in captured code, which runs at
  capture and never on replay.
* ``export-doc-drift`` — ``__all__`` exports missing from ``docs/API.md``.

Entry points are ``with torch.cuda.graph(...)`` bodies and the callables
given to ``make_graphed_callables``, ``torch.compile``, ``torch.func``
and ``torch.cond`` (``tools/lint/analysis.py``). The dataflow engine —
per-function CFGs with dominators (``tools/lint/cfg.py``), guard facts
propagated across the call graph — carries three families that know
nothing of either framework, with the JAX package's logic:

* **staleness** — ``stale-version-read``: public methods of a
  version-guarded class reading re-captured state without a dominating
  ``VersionMismatchError`` guard.
* **transaction** — ``non-atomic-publish`` / ``commit-marker-order`` /
  ``replace-without-fsync``: the temp-dir + fsync + ``os.replace`` +
  COMMIT-last save discipline.
* **concurrency** — ``executor-lifecycle`` / ``lock-held-across-call`` /
  ``metric-name-constant``: executors need a reachable shutdown path,
  non-reentrant locks must not be held across re-entering calls, and
  registry metric names must use the ``obs/registry.py`` constants.

CLI: ``python -m quiver_tpu_torch.tools.lint [paths]`` (``--json``,
``--list-rules``, ``--select``/``--ignore`` accepting rules or families,
``--changed BASE`` for O(diff) reporting, ``--sarif PATH`` for CI
annotation, ``--debt`` for the reasoned-suppression report; exit 0 clean
/ 1 findings / 2 usage). Inline suppression: ``# graftlint:
disable=<rule> -- <reason>`` — the reason is mandatory.
"""

from .rules import FAMILIES, Finding, RULES, family_of, rule_docs
from .runner import LintResult, changed_files, collect_files, lint_paths
from .report import build_debt, build_sarif
from .cfg import CFG, build_cfg
from .cli import main

__all__ = [
    "CFG",
    "FAMILIES",
    "Finding",
    "LintResult",
    "RULES",
    "build_cfg",
    "build_debt",
    "build_sarif",
    "changed_files",
    "collect_files",
    "family_of",
    "lint_paths",
    "main",
    "rule_docs",
]
