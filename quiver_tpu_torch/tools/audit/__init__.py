"""graftaudit for the port: static checks over recorded torch programs.

The port of ``quiver_tpu/tools/audit/``. graftlint (``tools/lint``) reads
source; graftaudit reads what a program actually runs and holds. It
records the registry of canonical programs (``audit_targets.py``: the
routed gather, the int8 tiered lookup, the distributed sample, the epoch
and step bodies, the serving ladder and fleet, the kernels of the
election paths, the out-of-core merge) by running each once on small
inputs under a dispatch-mode recorder (``ir.py``), then checks the
recordings against the repo's disciplines, JAX's rules under JAX's names:

* ``collective-parity``: two input sets (one overflowing the routed
  buckets) record one collective schedule;
* ``metrics-strip``: ``collect_metrics=False`` strips exactly the declared
  metric reductions and moves nothing else;
* ``donation-audit``: programs write in place exactly what they claim;
* ``dtype-discipline``: no float64; int8 codes ride the routed
  ``all_to_all``;
* ``constant-bloat``: no large tensor built from host data on every run;
* ``comm-budget``: the routed ``all_to_all`` lanes equal
  ``control/cost.routed_lanes_per_hop`` exactly;

and the memory family (``mem.py``): ``peak-hbm-budget`` (the recorded
alloc/free walk against ``meta["hbm_budget"]``), ``no-silent-replication``,
``vmem-budget`` (each launched kernel's registers, shared memory and block
size from ``cudaFuncGetAttributes``, on the card) and ``padding-waste``.

CLI: ``python -m quiver_tpu_torch.tools.audit`` (``--device cpu``,
``--json``, ``--sarif PATH``, ``--select``/``--ignore``, ``--targets``,
``--changed BASE``, ``--list-rules``, ``--list-targets``, ``--mem-table``
[``--mem-cuda``]; exit 0 clean / 1 findings / 2 usage).

Importing this package records nothing and touches no device.
"""

from .audit_targets import REGISTRY, Built, Target, build, build_from
from .cli import main
from .mem import estimate_peak, peak_table
from .rules import FAMILIES, RULES, family_of, rule_docs
from .runner import AuditResult, changed_files, run_audit, select_targets

__all__ = [
    "AuditResult",
    "Built",
    "FAMILIES",
    "REGISTRY",
    "RULES",
    "Target",
    "build",
    "build_from",
    "changed_files",
    "estimate_peak",
    "family_of",
    "main",
    "peak_table",
    "rule_docs",
    "run_audit",
    "select_targets",
]
