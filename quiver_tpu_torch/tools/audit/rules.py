"""Audit rules: invariants checked on recorded programs.

The port of ``quiver_tpu/tools/audit/rules.py``: JAX's ten rules under
JAX's names and families. Each rule is a function ``(target, built,
builds) -> [Finding]`` over one :class:`~.audit_targets.Built` (``builds``
resolves a paired target, e.g. the metrics on/off differential). Findings
take the lint's :class:`Finding` shape, so both tools share the SARIF
plumbing; the path is the target's primary source file and the message
names the target.

What each rule asks of the port, where the port differs from the JAX
package:

* parity (collective-parity): the port has no ``lax.cond`` (the routed
  fallback always runs, ``parallel/routing.py``), so a target is recorded
  twice, on two input sets (one overflows its buckets where the target's
  sizes allow it), and both runs must carry one ordered collective list.
* metrics (metrics-strip): as in JAX, over the marked collectives.
* donation (donation-audit): donation is writing in place. A target that
  claims it writes every claimed tensor in place with its storage kept; a
  target writes none of its inputs.
* dtype (dtype-discipline): no float64/complex128 op; on ``int8_path``
  the routed ``all_to_all`` carries int8.
* constants (constant-bloat): no tensor above the limit built from host
  data on every run (a factory from a host array; a host upload when the
  program runs on a card).
* comm (comm-budget), padding (padding-waste): as in JAX, over the
  marked ``all_to_all`` nodes.
* hbm (peak-hbm-budget): the recorded estimate (:mod:`.mem`) fits
  ``meta["hbm_budget"]``; an unpriced target is itself a finding.
* replication (no-silent-replication): as in JAX, over ``all_gather``.
* vmem (vmem-budget): each launched kernel's shared memory, registers
  times block size and block size against Hopper's limits, from its
  ``cudaFuncGetAttributes``. On the CPU no attributes exist: every kernel
  node there is a suppressed finding ("attributes are read on the card"),
  so a CPU run never looks checked when it is not.

``--select mem`` takes the four memory rules at once.
"""

from __future__ import annotations

from collections import Counter

from ..lint.rules import Finding
from . import ir, mem

__all__ = ["FAMILIES", "META_RULES", "RULES", "family_of", "rule_docs"]

# a tensor built from host data above this rides every run as a host
# upload; targets can tighten/loosen via meta["const_bytes_limit"]
CONST_BYTES_LIMIT = 1 << 20

# the reason of the vmem-budget findings a CPU run suppresses
ATTRS_ON_CARD = "attributes are read on the card"


def _finding(rule, target, message, suppressed: bool = False) -> Finding:
    return Finding(rule=rule, path=target.sources[0], line=1, col=0,
                   message=f"[{target.name}] {message}", suppressed=suppressed)


def check_collective_parity(target, built, builds) -> list:
    """Both recordings of a target (its inputs, and its second input set,
    whose buckets overflow where the sizes allow) carry the same ordered
    collective signatures (prim/axes/shape/dtype): the schedule of a mesh
    exchange never depends on the data, so no member can enter a
    collective its peers skip."""
    if built.second is None:
        return []
    first = [c.signature() for c in ir.collectives_of(built.program)]
    second = [c.signature() for c in ir.collectives_of(built.second)]
    if first == second:
        return []
    at = next((i for i, (a, b) in enumerate(zip(first, second)) if a != b),
              min(len(first), len(second)))
    show = lambda s: "end" if at >= len(s) else str(s[at])  # noqa: E731
    return [_finding(
        "collective-parity", target,
        f"the two input sets record different collective schedules "
        f"({len(first)} against {len(second)} collectives; first difference "
        f"at #{at}: {show(first)} against {show(second)})")]


def check_metrics_strip(target, built, builds) -> list:
    """The ``collect_metrics=False`` program equals its metrics-on pair
    minus EXACTLY the declared metric reductions: identical
    all_to_all/all_gather schedules (telemetry never reshapes data
    movement), reductions(off) a sub-multiset of reductions(on), and the
    difference count == ``meta["expected_metric_reductions"]``."""
    pair = built.meta.get("metrics_pair")
    if pair is None:
        return []
    on = builds(pair)
    out = []

    def _split(cols):
        red = Counter(c.signature() for c in cols if c.prim in ir.REDUCTIONS)
        moves = Counter(c.signature() for c in cols if c.prim not in ir.REDUCTIONS)
        return red, moves

    off_red, off_moves = _split(ir.collectives_of(built.program))
    on_red, on_moves = _split(ir.collectives_of(on.program))
    if off_moves != on_moves:
        out.append(_finding(
            "metrics-strip", target,
            f"data-movement collectives differ from pair '{pair}': "
            f"off-only={dict(off_moves - on_moves)} "
            f"on-only={dict(on_moves - off_moves)}"))
    extra_off = off_red - on_red
    if extra_off:
        out.append(_finding(
            "metrics-strip", target,
            f"reductions present with collect_metrics=False but absent in "
            f"'{pair}': {dict(extra_off)}: a metric sum survived the strip"))
    expected = int(built.meta.get("expected_metric_reductions", 0))
    stripped = sum((on_red - off_red).values())
    if stripped != expected:
        out.append(_finding(
            "metrics-strip", target,
            f"metrics-on program carries {stripped} extra reduction(s) over "
            f"the stripped baseline, registry declares {expected}: "
            f"{dict(on_red - off_red)}"))
    return out


def check_donation_audit(target, built, builds) -> list:
    """Programs write in place exactly what they claim (the port's
    donation). A target claiming donation (``meta["donated_leaves"]``)
    claims that many tensors, and each is written in place with its
    storage kept (the same address before and after); no target writes one
    of its inputs, the tensors its caller hands it."""
    p = built.program
    out = []
    written = {k for n in p.nodes for k in n.writes}
    claimed = int(built.meta.get("donated_leaves", 0))
    if len(p.claimed) != claimed:
        out.append(_finding(
            "donation-audit", target,
            f"{len(p.claimed)} tensor(s) handed over as written in place, "
            f"registry claims {claimed}"))
    for key, (before, after) in sorted(p.claimed.items()):
        if key not in written:
            out.append(_finding(
                "donation-audit", target,
                f"claimed tensor (storage {key}) is never written in place"))
        elif before != after:
            out.append(_finding(
                "donation-audit", target,
                f"claimed tensor (storage {key}) moved from {before:#x} to "
                f"{after:#x}: rebound, not written in place"))
    for i, v in enumerate(p.inputs):
        if v.storage in written:
            out.append(_finding(
                "donation-audit", target,
                f"input #{i} {v} is written in place, which the target "
                "does not claim"))
    return out


def check_dtype_discipline(target, built, builds) -> list:
    """No float64/complex128 value anywhere in a recorded program (the
    port keeps f32; a wide float is a silent upcast or a numpy float64
    leaking in), and on ``int8_path`` targets the routed all_to_all
    carries int8 codes: dequantising before the exchange moves 4x the
    bytes."""
    out = []
    for node, value, path in ir.f64_eqns(built.program):
        out.append(_finding(
            "dtype-discipline", target,
            f"{node.name} at {'/'.join(path)} produces {value.dtype}"))
    if built.meta.get("int8_path"):
        a2a = [c for c in ir.collectives_of(built.program) if c.prim == "all_to_all"]
        if not any(c.dtype == "int8" for c in a2a):
            out.append(_finding(
                "dtype-discipline", target,
                "int8 tier path routes no int8 all_to_all: codes were "
                f"dequantised before routing (saw {sorted({c.dtype for c in a2a})})"))
    return out


def check_constant_bloat(target, built, builds) -> list:
    """Tensors built from host data on every run above the size limit: a
    factory from a host array, or (on a card) a host upload. Such a tensor
    should be placed once and passed in as state."""
    limit = int(built.meta.get("const_bytes_limit", CONST_BYTES_LIMIT))
    out = []
    for value, path in ir.iter_consts(built.program):
        if value.nbytes > limit:
            out.append(_finding(
                "constant-bloat", target,
                f"host-built tensor {value} ({value.nbytes} bytes > {limit}) "
                f"at {'/'.join(path)}"))
    return out


def check_comm_budget(target, built, builds) -> list:
    """The routed all_to_all lanes reconcile with
    ``control/cost.routed_lanes_per_hop`` EXACTLY: the ids hop is
    ``int(F, cap)``, the payload hop ``(F, cap, feature_dim)``, and ``F *
    cap == lanes_per_hop`` for the declared ``(local_len, F, alpha)``."""
    comm = built.meta.get("comm")
    if comm is None:
        return []
    from ...control.cost import routed_lanes_per_hop

    F = int(comm["feature_shards"])
    model = routed_lanes_per_hop(int(comm["local_len"]), F, float(comm["alpha"]))
    cap, lanes = int(model["cap"]), int(model["lanes_per_hop"])
    a2a = [c for c in ir.collectives_of(built.program) if c.prim == "all_to_all"]
    out = []
    if not a2a:
        out.append(_finding(
            "comm-budget", target,
            "no all_to_all recorded in a program declaring a comm budget: "
            "the routed gather fell off the exchange path"))
    for c in a2a:
        ok_ids = (len(c.shape) == 2 and c.dtype.startswith("int")
                  and tuple(c.shape) == (F, cap))
        ok_payload = (len(c.shape) == 3
                      and tuple(c.shape) == (F, cap, int(comm["feature_dim"])))
        if not (ok_ids or ok_payload):
            out.append(_finding(
                "comm-budget", target,
                f"{c} does not match the comm model (expect ids int[{F}, {cap}] "
                f"or payload [{F}, {cap}, {comm['feature_dim']}] for alpha="
                f"{comm['alpha']}, local_len={comm['local_len']})"))
        elif c.lanes != lanes:
            out.append(_finding(
                "comm-budget", target,
                f"{c} moves {c.lanes} lanes/hop, model says {lanes}"))
    return out


def check_peak_hbm_budget(target, built, builds) -> list:
    """Every target's recorded peak (inputs and state held, plus the
    largest growth of the alloc/free walk; :func:`~.mem.estimate_peak`)
    fits its declared ``meta["hbm_budget"]``; a target declaring NO budget
    is itself a finding, so new programs enter the registry priced."""
    est = mem.estimate_peak(built.program)
    budget = built.meta.get("hbm_budget")
    if budget is None:
        return [_finding(
            "peak-hbm-budget", target,
            f"no meta['hbm_budget'] declared (estimated peak is "
            f"{est.peak_bytes} bytes): every registry program must enter priced")]
    if est.peak_bytes > int(budget):
        return [_finding(
            "peak-hbm-budget", target,
            f"estimated peak {est.peak_bytes} bytes exceeds the declared "
            f"hbm_budget of {int(budget)} (args={est.arg_bytes}, state="
            f"{est.state_bytes}, growth={est.growth_bytes})")]
    return []


def check_no_silent_replication(target, built, builds) -> list:
    """No ``all_gather`` over ``feature`` whose result reaches
    ``meta["replication_bytes_limit"]`` (default
    :data:`~.mem.REPLICATION_BYTES_LIMIT`): the op that makes a sharded
    operand cost F times per member. The finding names the op that made
    the gathered tensor, so the fix starts at the source."""
    limit = int(built.meta.get("replication_bytes_limit", mem.REPLICATION_BYTES_LIMIT))
    out = []
    for rep in mem.feature_replications(built.program, limit=limit):
        out.append(_finding(
            "no-silent-replication", target,
            f"{rep['prim']} over '{rep['axis']}' at {'/'.join(rep['path'])} "
            f"replicates {rep['dtype']}{list(rep['shape'])} ({rep['bytes']} "
            f"bytes >= {limit}) onto every member: gathered tensor made by "
            f"{rep['producer']}"))
    return out


def check_vmem_budget(target, built, builds) -> list:
    """Every launched kernel fits a Hopper SM: its static plus dynamic
    shared memory at most ``meta["vmem_budget"]`` (default 232,448 B a
    block), its registers times its block size at most 65,536, and its
    block size at most its max threads per block (``cudaFuncGetAttributes``
    of every instantiation its entry may launch). Spills are reported in
    the table, not here. A CPU recording has no attributes: each kernel
    node is a suppressed finding saying so."""
    budget = int(built.meta.get("vmem_budget", mem.DEFAULT_VMEM_BUDGET))
    attrs = built.meta.get("kernel_attrs")
    if attrs is None:
        if built.program.device != "cuda":
            return [_finding("vmem-budget", target, f"{n.name}: {ATTRS_ON_CARD}",
                             suppressed=True) for n in built.program.kernels]
        attrs = mem.kernel_attrs()
    out = []
    for u in mem.vmem_usages(built.program, attrs):
        over = []
        if u.shared_bytes > budget:
            over.append(f"shared {u.shared_bytes} B > {budget}")
        if u.regs * u.block > mem.REGISTERS_PER_SM:
            over.append(f"{u.regs} regs x {u.block} threads > {mem.REGISTERS_PER_SM}")
        if u.block > u.max_threads:
            over.append(f"block {u.block} > max threads {u.max_threads}")
        if over:
            out.append(_finding("vmem-budget", target, f"{u}: {'; '.join(over)}"))
    return out


def check_padding_waste(target, built, builds) -> list:
    """Padded all_to_all lanes are bought with real memory and wire
    bytes: on targets declaring a comm model, each routed hop's waste
    fraction (1 - payload/lanes, payload = ``local_len * (1 - h0)``) stays
    under ``meta["padding_waste_limit"]`` (default
    :data:`~.mem.PADDING_WASTE_LIMIT`; alpha=2 sits at 0.5)."""
    limit = float(built.meta.get("padding_waste_limit", mem.PADDING_WASTE_LIMIT))
    out = []
    for w in mem.padding_waste(built):
        if w["waste"] > limit:
            out.append(_finding(
                "padding-waste", target,
                f"{w['collective']} ships {w['lanes']} lanes for "
                f"{w['payload_lanes']:g} payload lanes: waste {w['waste']:.3f} > "
                f"{limit:g} (cap {w['cap']} is over-provisioned for the route)"))
    return out


RULES = {
    "collective-parity": check_collective_parity,
    "metrics-strip": check_metrics_strip,
    "donation-audit": check_donation_audit,
    "dtype-discipline": check_dtype_discipline,
    "constant-bloat": check_constant_bloat,
    "comm-budget": check_comm_budget,
    "peak-hbm-budget": check_peak_hbm_budget,
    "no-silent-replication": check_no_silent_replication,
    "vmem-budget": check_vmem_budget,
    "padding-waste": check_padding_waste,
}

FAMILIES = {
    "parity": ("collective-parity",),
    "metrics": ("metrics-strip",),
    "donation": ("donation-audit",),
    "dtype": ("dtype-discipline",),
    "constants": ("constant-bloat",),
    "comm": ("comm-budget",),
    "hbm": ("peak-hbm-budget",),
    "replication": ("no-silent-replication",),
    "vmem": ("vmem-budget",),
    "padding": ("padding-waste",),
    # umbrella: the whole memory family behind one --select handle.
    # Keep LAST so family_of resolves each rule to its specific family.
    "mem": ("peak-hbm-budget", "no-silent-replication", "vmem-budget",
            "padding-waste"),
}

META_RULES = ("audit-error",)


def family_of(rule: str) -> str:
    for fam, rules in FAMILIES.items():
        if rule in rules:
            return fam
    return "meta"


def rule_docs() -> dict:
    docs = {name: (fn.__doc__ or "").strip() for name, fn in RULES.items()}
    docs["audit-error"] = ("a registered target failed to record: the "
                           "program the invariant lives on no longer runs")
    return docs
