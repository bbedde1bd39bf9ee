"""graftlint rules for the PyTorch/CUDA port.

Every rule is a function ``(project) -> list[Finding]`` registered in
``RULES``. Rule names are the stable identifiers used by inline
suppressions (``# graftlint: disable=<rule> -- <reason>``) and ``--select``
/ ``--ignore``; they and their families are the JAX package's. The
``trace`` family and ``axis-name-consistency`` ask torch's question (does
this code run under CUDA-graph capture or a torch trace, and do axis
literals match ``parallel/mesh.py``'s); ``export-doc-drift`` and the
staleness, transaction and concurrency families know nothing of either
framework and keep the JAX package's logic and messages.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import os
import re

from .analysis import (
    Project,
    FuncInfo,
    STATIC_ATTRS,
    STATIC_METHODS,
    _METRIC_NAME_RE,
    capture_guarded,
    is_env_read,
    iter_owned,
    terminal_name,
)
from .cfg import cfg_of, propagate_guard_establishers

__all__ = ["Finding", "FAMILIES", "RULES", "family_of", "rule_docs"]


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed}


def _finding(rule, info_or_path, node, message) -> Finding:
    path = (info_or_path if isinstance(info_or_path, str)
            else info_or_path.path)
    return Finding(rule=rule, path=path,
                   line=getattr(node, "lineno", 1),
                   col=getattr(node, "col_offset", 0), message=message)


def _chain(info: FuncInfo) -> str:
    hops = " -> ".join(info.trace_chain + (info.qualname,))
    return f"{hops} [{info.trace_reason}]"


def _captured(project: Project):
    """Every captured function or capture region, with the nodes it owns
    that run while capturing (those under a false
    ``is_current_stream_capturing()`` excluded)."""
    for f in project.funcs:
        if not f.traced or f.is_module:
            continue
        parents = project.parents_of(f)
        yield f, [n for n in iter_owned(f.node)
                  if not (isinstance(n, (ast.Call, ast.Subscript))
                          and capture_guarded(parents, n))]


# -- rule 1: env-at-trace -----------------------------------------------------

def check_env_at_trace(project: Project) -> list[Finding]:
    """``os.environ`` reads reachable from code that runs under CUDA-graph
    capture or a torch trace (``torch.cuda.graph`` bodies,
    ``make_graphed_callables``, ``torch.compile``, ``torch.func``): the
    read runs once, at capture, and every replay keeps its value while the
    code looks like a live switch (the QUIVER_COUNTS bug). Route the read
    through a module-cached resolve-once helper instead
    (``models/layers.resolve_counts_strategy``) and document the
    env-before-first-use contract."""
    out = []
    for f, nodes in _captured(project):
        for node in nodes:
            how = is_env_read(node)
            if how:
                out.append(_finding(
                    "env-at-trace", f, node,
                    f"{how} read inside captured code ({_chain(f)}); the "
                    "value is pinned at capture while looking live — "
                    "resolve it ONCE per process via a module-cached "
                    "helper (cf. models/layers.resolve_counts_strategy) "
                    "and document env-before-first-use",
                ))
    return out


# -- rule 2: axis-name-consistency -------------------------------------------

# collective -> index of the positional axis argument
_COLLECTIVES = {
    "psum": 1, "pmean": 1, "pmax": 1, "pmin": 1, "all_gather": 1,
    "all_to_all": 1, "psum_scatter": 1, "axis_index": 0, "axis_size": 0,
}
# keywords that name mesh axes: the metrics tape's ``psum=``, the sharded
# stores' and topologies' ``axis=``, a collective's ``axis_name=``
_AXIS_KEYWORDS = ("psum", "axis", "axis_name")
# constructors whose first string arguments are axis names
_AXIS_CALLS = {"BucketRoute"}


def _axis_literals(arg: ast.AST):
    """String constants in an axis-argument expression (handles tuples)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        yield arg
    elif isinstance(arg, (ast.Tuple, ast.List)):
        for e in arg.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                yield e


def check_axis_name_consistency(project: Project) -> list[Finding]:
    """Axis names in ``psum=`` (the metrics tape), ``axis=`` /
    ``axis_name=`` keywords (``ShardedFeature``, the sharded topologies,
    ``BucketRoute``), collective calls and ``mesh.shape[...]`` must come
    from the shared ``*_AXIS`` constants (``parallel/mesh.py`` declares
    ``DATA_AXIS``/``FEATURE_AXIS``); a string literal in axis position is
    drift waiting to happen, and a literal matching NO declared axis is
    drift that already happened."""
    declared = project.declared_axes
    by_value = {v: k for k, v in declared.items()}
    if not declared:
        return []  # nothing declared in the analyzed set — nothing to check

    def msg_for(lit: str) -> str:
        if lit in by_value:
            return (f"hardcoded axis name {lit!r}; use the shared constant "
                    f"{by_value[lit]} (quiver_tpu_torch.parallel.mesh) so "
                    "axis renames cannot drift")
        known = ", ".join(sorted(f"{v!r} ({k})" for k, v in declared.items()))
        return (f"axis name {lit!r} matches no declared mesh axis "
                f"(declared: {known}) — string drift in a reduction or a "
                "route is a silent wrong-group result")

    out = []
    for src in project.files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                t = terminal_name(node.func)
                axis_args = [kw.value for kw in node.keywords
                             if kw.arg in _AXIS_KEYWORDS]
                if t in _COLLECTIVES:
                    pos = _COLLECTIVES[t]
                    if pos < len(node.args):
                        axis_args.append(node.args[pos])
                elif t in _AXIS_CALLS:
                    axis_args.extend(a for a in node.args
                                     if isinstance(a, (ast.Constant, ast.Tuple)))
                for arg in axis_args:
                    for lit in _axis_literals(arg):
                        out.append(_finding("axis-name-consistency", src.path,
                                            lit, msg_for(lit.value)))
            elif isinstance(node, ast.Subscript):
                # mesh.shape["data"] — flag only literals that ARE declared
                # axes (unknown strings here are ordinary dict keys)
                if (isinstance(node.value, ast.Attribute)
                        and node.value.attr == "shape"
                        and isinstance(node.slice, ast.Constant)
                        and isinstance(node.slice.value, str)
                        and node.slice.value in by_value):
                    out.append(_finding("axis-name-consistency", src.path,
                                        node.slice,
                                        msg_for(node.slice.value)))
    return out


# -- rule 3: cond-branch-parity ----------------------------------------------

def _return_arities(expr: ast.AST, scope: FuncInfo | None,
                    project: Project) -> set:
    """Possible return shapes of a cond branch: int = tuple arity,
    "scalar" = a single non-tuple value. Empty set = not statically
    analyzable (stay silent)."""
    def expr_arity(e):
        if isinstance(e, ast.Tuple):
            return len(e.elts)
        if e is None:
            return 0
        return "scalar"

    if isinstance(expr, ast.Lambda):
        return {expr_arity(expr.body)}
    target = None
    if isinstance(expr, ast.Name) and scope is not None:
        s = scope
        while s is not None:
            if expr.id in s.local_funcs:
                cands = s.local_funcs[expr.id]
                target = cands[0] if len(cands) == 1 else None
                break
            if expr.id in s.local_names and not s.is_module:
                break
            s = s.parent
        if target is None:
            cands = project.index.get(expr.id, [])
            target = cands[0] if len(cands) == 1 else None
    if target is None or isinstance(target.node, ast.Lambda):
        return set()
    arities = set()
    for node in iter_owned(target.node):
        if isinstance(node, ast.Return):
            arities.add(expr_arity(node.value))
    return arities


def check_cond_branch_parity(project: Project) -> list[Finding]:
    """``torch.cond`` branches returning mismatched tuple arity: both
    branches of a ``torch.cond(pred, true_fn, false_fn, operands)`` must
    return the same structure, or the cond fails when it is traced or
    compiled, far from the edit that broke one branch's return."""
    out = []
    for src in project.files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            if terminal_name(node.func) != "cond" or len(node.args) < 3:
                continue
            scope = project.owner_of(node)
            a_true = _return_arities(node.args[1], scope, project)
            a_false = _return_arities(node.args[2], scope, project)
            if a_true and a_false and not (a_true & a_false):
                def show(s):
                    return "/".join(str(x) for x in sorted(s, key=str))
                out.append(_finding(
                    "cond-branch-parity", src.path, node,
                    f"torch.cond branches return mismatched structures "
                    f"(true branch: {show(a_true)} value(s), false branch: "
                    f"{show(a_false)}); both branches must return the same "
                    "structure or the cond fails when traced",
                ))
    return out


# -- rule 4: host-op-on-tracer -----------------------------------------------

# tensor methods that copy a device value to the host (a synchronise)
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# calls whose output shape depends on device values: they read a count back
_DATA_DEPENDENT = {"nonzero", "masked_select", "unique"}
_NP_HOST = {"np", "numpy"}


class _TaintWalk(ast.NodeVisitor):
    """Minimal forward taint pass over one captured function's owned
    nodes: its positional parameters carry device tensors, and so does
    every name assigned from them (in a capture region, every name it
    assigns)."""

    def __init__(self, func: FuncInfo, nodes):
        self.func = func
        self.nodes = nodes
        self.tainted: set[str] = set(func.taint_params) | _free_locals(func, nodes)
        if func.is_region:
            for n in nodes:
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        self.tainted.update(x.id for x in ast.walk(t)
                                            if isinstance(x, ast.Name))
        self.masks: set[str] = set()
        self.findings: list[Finding] = []

    def _tainted(self, expr) -> bool:
        if expr is None:
            return False
        # static metadata never carries a device value
        clean = _strip_static(expr)
        for node in ast.walk(clean) if clean is not None else ():
            if isinstance(node, ast.Name) and node.id in self.tainted:
                return True
        return False

    def run(self):
        # iter_owned yields in traversal (not source) order, and loops can
        # carry taint backwards — iterate the assignment scan to a
        # fixpoint before checking call sites
        nodes = sorted(self.nodes, key=lambda n: (getattr(n, "lineno", 0),
                                                  getattr(n, "col_offset", 0)))
        assigns = [n for n in nodes if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                if self._tainted(node.value):
                    for t in node.targets:
                        for n in ast.walk(t):
                            if (isinstance(n, ast.Name)
                                    and n.id not in self.tainted):
                                self.tainted.add(n.id)
                                changed = True
        for node in assigns:
            if _is_mask_expr(node.value, self.masks) and self._tainted(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.masks.add(t.id)
        for node in nodes:
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)):
                self._check_subscript(node)
        return self.findings

    def _flag(self, node, what: str, why: str):
        f = self.func
        self.findings.append(_finding(
            "host-op-on-tracer", f, node,
            f"{what} on a device value in captured code of {f.qualname} "
            f"({_chain(f)}); {why}",
        ))

    def _check_call(self, node: ast.Call):
        t = terminal_name(node.func)
        is_attr = isinstance(node.func, ast.Attribute)
        recv = node.func.value if is_attr else None
        sync = ("it reads the value back to the host, which breaks CUDA-"
                "graph capture and stalls the stream — keep it a tensor or "
                "move the read outside the captured code")
        if t in ("int", "float", "bool", "complex") and not is_attr and node.args:
            if self._tainted(node.args[0]):
                self._flag(node, f"{t}()", sync)
        elif t in _HOST_METHODS and is_attr and not node.args:
            if self._tainted(recv):
                self._flag(node, f".{t}()", sync)
        elif (t in ("asarray", "array") and is_attr
              and terminal_name(recv) in _NP_HOST and node.args):
            if self._tainted(node.args[0]):
                self._flag(node, f"np.{t}()", sync)
        elif t in _DATA_DEPENDENT:
            operand = (node.args[0] if not is_attr or terminal_name(recv) == "torch"
                       else recv) if (node.args or is_attr) else None
            if self._tainted(operand):
                self._flag(node, f"{t}()", "its output shape depends on device "
                           "values, so it reads a count back to the host — use "
                           "a fixed-size form (a padded mask, a sort)")
        elif t == "repeat_interleave":
            if any(kw.arg == "output_size" for kw in node.keywords):
                return
            if is_attr and terminal_name(recv) != "torch":
                repeats = node.args[0] if node.args else None
            else:
                repeats = node.args[1] if len(node.args) > 1 else (
                    node.args[0] if node.args else None)
            if repeats is not None and self._tainted(repeats):
                self._flag(node, "repeat_interleave() with tensor repeats and no "
                           "output_size", "the output length is summed on the "
                           "host — pass output_size=")
        elif t == "synchronize" and is_attr and terminal_name(recv) == "cuda":
            self._flag(node, "torch.cuda.synchronize()", "a synchronise is illegal "
                       "under capture and meaningless on replay")

    def _check_subscript(self, node: ast.Subscript):
        sl = node.slice
        if self._tainted(node.value) and _is_mask_expr(sl, self.masks):
            self._flag(node, "boolean-mask indexing", "its output shape depends "
                       "on the mask, so the count is read back to the host — use "
                       "torch.where over the full shape")


def _free_locals(func: FuncInfo, nodes) -> set[str]:
    """The names a nested function or region reads from an enclosing
    function's locals (``self`` and ``cls`` aside): a captured closure's
    free variables carry the tensors it was built over."""
    enclosing: set[str] = set()
    scope = func.parent
    while scope is not None and not scope.is_module:
        enclosing |= scope.local_names - set(scope.local_funcs)
        scope = scope.parent
    own = set(func.local_names)
    return {n.id for n in nodes
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and n.id in enclosing and n.id not in own
            and n.id not in ("self", "cls")}


def _is_mask_expr(expr, masks: set[str]) -> bool:
    """A boolean-tensor expression: a comparison, ``~x``, ``a & b`` /
    ``a | b`` of such, ``isfinite``/``isnan``/``logical_*`` calls, or a
    name assigned from one."""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return True
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask_expr(expr.left, masks) or _is_mask_expr(expr.right, masks)
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        return t in ("isfinite", "isnan", "isinf") or (t or "").startswith("logical_")
    if isinstance(expr, ast.Name):
        return expr.id in masks
    return False


def _strip_static(expr: ast.AST):
    """Return the expr for taint walking, or None when the whole expr is a
    static-metadata access. Names under ``.shape``-like attributes, in
    ``.size()``-like calls and inside ``len(...)`` carry no device value."""

    class _T(ast.NodeTransformer):
        def visit_Attribute(self, node):
            if node.attr in STATIC_ATTRS:
                return ast.copy_location(ast.Constant(value=None), node)
            return self.generic_visit(node)

        def visit_Call(self, node):
            t = terminal_name(node.func)
            if t == "len" or (isinstance(node.func, ast.Attribute)
                              and t in STATIC_METHODS):
                return ast.copy_location(ast.Constant(value=None), node)
            return self.generic_visit(node)

    return _T().visit(copy.deepcopy(expr))


def check_host_op_on_tracer(project: Project) -> list[Finding]:
    """Host reads of device values in code that runs under CUDA-graph
    capture or a torch trace: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``int()``/``float()``/``bool()`` or ``np.asarray`` of a
    tensor, ``torch.nonzero``/``masked_select``/``unique`` (data-dependent
    shapes), ``repeat_interleave`` of tensor repeats without
    ``output_size``, boolean-mask indexing, ``torch.cuda.synchronize()``.
    Each synchronises with the card, which capture forbids (PR 12's
    captured trainer step failed on the card for one). Values flow from a
    captured function's positional parameters; static metadata
    (``x.shape[0]``, ``x.numel()``, ``len(x)``) is exempt, and so is code
    under a false ``torch.cuda.is_current_stream_capturing()``."""
    out = []
    for f, nodes in _captured(project):
        out.extend(_TaintWalk(f, nodes).run())
    return out


# -- rule 5: per-call-logging-in-jit -----------------------------------------

_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}


def _is_logger_receiver(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        return terminal_name(expr.func) in ("get_logger", "getLogger",
                                            "getChild")
    t = terminal_name(expr)
    if t is None:
        return False
    tl = t.lower()
    return tl in ("warnings",) or "log" in tl


def check_per_call_logging_in_jit(project: Project) -> list[Finding]:
    """Logging in code that runs under CUDA-graph capture or a torch
    trace runs once, at capture, and never on a replay: it looks like
    per-batch telemetry and silently is not (and under ``torch.compile``
    it breaks the graph). Use the one-shot ``info_once`` idiom for
    capture-time signals, and log outside the captured program."""
    out = []
    for f, nodes in _captured(project):
        if f.name and f.name.endswith("once"):
            continue  # the one-shot idiom's own implementation
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            t = terminal_name(node.func)
            if isinstance(node.func, ast.Name) and t == "print":
                out.append(_finding(
                    "per-call-logging-in-jit", f, node,
                    f"print() inside captured code ({_chain(f)}) runs at "
                    "capture, never on replay; print outside the captured "
                    "program, or use info_once for one-shot signals",
                ))
            elif (isinstance(node.func, ast.Attribute)
                  and t in _LOG_METHODS
                  and _is_logger_receiver(node.func.value)):
                out.append(_finding(
                    "per-call-logging-in-jit", f, node,
                    f"logger .{t}() inside captured code ({_chain(f)}) fires "
                    "once at capture and never on replay — use the one-shot "
                    "info_once idiom (utils/trace.py) or log outside the "
                    "captured program",
                ))
    return out


# -- rule 6: export-doc-drift -------------------------------------------------

def _module_all(tree: ast.Module) -> list[tuple[str, ast.AST]]:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        return [
                            (e.value, e) for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                        ]
    return []


def check_export_doc_drift(project: Project) -> list[Finding]:
    """Names in a top-level package ``__init__.py.__all__`` missing from
    ``docs/API.md`` — the generated index (``scripts/gen_api_md.py``) went
    stale. Applies to any analyzed ``__init__.py`` whose grandparent
    directory carries ``docs/API.md`` (i.e. the package root)."""
    out = []
    for src in project.files:
        if os.path.basename(src.path) != "__init__.py":
            continue
        pkg_dir = os.path.dirname(os.path.abspath(src.path))
        api_md = os.path.join(os.path.dirname(pkg_dir), "docs", "API.md")
        if not os.path.isfile(api_md):
            continue
        exports = _module_all(src.tree)
        if not exports:
            continue
        try:
            with open(api_md, encoding="utf-8") as fh:
                documented = set(re.findall(r"`([^`\n]+)`", fh.read()))
        except OSError:
            continue
        rel_md = os.path.relpath(api_md)
        for name, node in exports:
            if name not in documented:
                out.append(_finding(
                    "export-doc-drift", src.path, node,
                    f"__all__ export {name!r} is missing from {rel_md}; "
                    "regenerate it (JAX_PLATFORMS=cpu python "
                    "scripts/gen_api_md.py)",
                ))
    return out


# ===== graftlint v2 — dataflow rule families ================================
#
# The rules below run on the CFG/dominator engine (tools/lint/cfg.py):
# they do not ask "is there a guard somewhere" but "does the guard
# DOMINATE the operation" — every path from entry must pass through it.
# Each family is distilled from a discipline a shipped PR established by
# hand: staleness from PR 8's version-guarded reads, transaction from
# PR 7's atomic checkpoint store (and CSRTopo.save), concurrency from the
# executor/lock/metric-constant lifecycles of PRs 2-8.


def _real_funcs(funcs) -> list[FuncInfo]:
    """Functions, lambdas and modules without the capture regions: a
    region's statements belong to the function that holds it too."""
    return [f for f in funcs if not f.is_region]


def _direct_methods(project: Project) -> dict[tuple[str, str],
                                              list[FuncInfo]]:
    """(path, class name) -> methods defined directly in the class body
    (nested closures inside a method carry class_name too but have a
    non-module parent)."""
    out: dict[tuple[str, str], list[FuncInfo]] = {}
    for f in project.funcs:
        if (f.class_name and f.name and not f.is_module
                and f.parent is not None and f.parent.is_module):
            out.setdefault((f.path, f.class_name), []).append(f)
    return out


def _self_attr_assigns(m: FuncInfo) -> set[str]:
    """Names of ``self.<attr>`` targets assigned anywhere in a method."""
    out: set[str] = set()
    for node in iter_owned(m.node):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for tt in elts:
                if (isinstance(tt, ast.Attribute)
                        and isinstance(tt.value, ast.Name)
                        and tt.value.id == "self"):
                    out.add(tt.attr)
    return out


def _self_method_calls(m: FuncInfo) -> set[str]:
    """Names called as ``self.<name>(...)`` in a method."""
    out: set[str] = set()
    for node in iter_owned(m.node):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            out.add(node.func.attr)
    return out


# -- rule 7: stale-version-read (family: staleness) ---------------------------

def check_stale_version_read(project: Project) -> list[Finding]:
    """Public methods of a version-guarded class reading version-bound
    state without a *dominating* version check. PR 8 made every mutable
    placement (sampler device topology, trainer captured operands) carry
    the version it was built from and raise ``VersionMismatchError``
    instead of silently serving pre-commit data — but only on the entry
    points that remember to call the guard. This rule machine-checks the
    discipline: in any class that owns a version guard (a method raising
    ``VersionMismatchError``, directly or via a callee) and a rebind seam
    (a method re-assigning a ``*version*`` attribute — ``refresh()``,
    ``replan()``), every public method reading the state those seams
    re-capture must be dominated by a guard or rebind call (guard facts
    propagate interprocedurally: a callee that guards on every exit
    counts). A guard in one branch, or after the read, does not."""
    seeds: set[str] = set()
    for f in project.funcs:
        if f.is_module or not f.name:
            continue
        for node in iter_owned(f.node):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                t = (terminal_name(exc.func) if isinstance(exc, ast.Call)
                     else terminal_name(exc))
                if t == "VersionMismatchError":
                    seeds.add(f.name)
    if not seeds:
        return []
    guard_names = propagate_guard_establishers(project, seeds)
    out = []
    for (_path, cls), methods in sorted(_direct_methods(project).items()):
        if not any(m.name in guard_names for m in methods):
            continue
        rebind: set[str] = set()
        rebind_sets: list[set[str]] = []
        for m in methods:
            if m.name == "__init__":
                continue
            attrs = _self_attr_assigns(m)
            if any("version" in a.lower() for a in attrs):
                rebind.add(m.name)
                rebind_sets.append({a for a in attrs
                                    if "version" not in a.lower()})
        # the version-bound state is what EVERY rebind seam re-captures:
        # refresh() and _replan() both rebuild the captured operands and
        # programs, but only _replan touches elastic-mesh state like
        # self.mesh — the intersection separates the two
        stale_attrs = (set.intersection(*rebind_sets)
                       if rebind_sets else set())
        if not stale_attrs:
            continue
        ok_calls = guard_names | rebind
        guards_shown = sorted(
            m.name for m in methods if m.name in seeds) or sorted(
            m.name for m in methods if m.name in guard_names)
        for m in methods:
            if (m.name.startswith("_") or m.name in rebind
                    or m.name in seeds):
                continue
            cfg = None
            for node in iter_owned(m.node):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in stale_attrs
                        and isinstance(node.ctx, ast.Load)):
                    continue
                if cfg is None:
                    cfg = cfg_of(project, m)
                if cfg.calls_dominating(node) & ok_calls:
                    continue
                out.append(_finding(
                    "stale-version-read", m, node,
                    f"{cls}.{m.name} reads version-bound state "
                    f"self.{node.attr} (re-captured by "
                    f"{'/'.join(sorted(rebind))}) without a dominating "
                    f"version check; after a streaming commit this read "
                    f"silently serves the pre-commit placement — call "
                    f"{'/'.join(guards_shown)} on every path before the "
                    "read (cf. GraphSageSampler.sample, "
                    "DistributedTrainer.step)",
                ))
    return out


# -- rules 8-10: transaction family ------------------------------------------

_TXN_PATH_RE = re.compile(r"checkpoint|topology|streaming|integrity")
_TMPISH = ("tmp", "temp")
_NP_RECEIVERS = {"np", "numpy", "jnp"}
_NP_WRITERS = {"save", "savez", "savez_compressed"}


def _is_os_replace(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace"
            and terminal_name(node.func.value) == "os")


def _module_calls_replace(src) -> bool:
    return any(isinstance(n, ast.Call) and _is_os_replace(n)
               for n in ast.walk(src.tree))


def _txn_scoped(src) -> bool:
    """Transactional modules: save-path modules by name, plus any module
    that performs an atomic ``os.replace`` publish itself (doing it
    somewhere obliges every write in the module to be honest about it)."""
    path = src.path.replace(os.sep, "/")
    return bool(_TXN_PATH_RE.search(path)) or _module_calls_replace(src)


def _func_env(f: FuncInfo) -> dict[str, ast.AST]:
    """name -> RHS expression for simple local bindings (assignments and
    ``with open(...) as fh`` items)."""
    env: dict[str, ast.AST] = {}
    for node in iter_owned(f.node):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            env.setdefault(node.targets[0].id, node.value)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.optional_vars, ast.Name):
                    env.setdefault(item.optional_vars.id,
                                   item.context_expr)
    return env


def _tempish(s: str) -> bool:
    low = s.lower()
    return any(t in low for t in _TMPISH)


def _temp_derived(expr, env, params, _seen=None):
    """Classify a write-target path expression: True (derives from a
    temp-dir/temp-name source), ``"param:<name>"`` (a bare parameter —
    the enclosing function is a write *helper*; its call sites carry the
    obligation), or False (a published/unknown path)."""
    if expr is None:
        return False
    if _seen is None:
        _seen = set()
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and _tempish(expr.value)
    if isinstance(expr, ast.Name):
        if _tempish(expr.id):
            return True
        if expr.id in _seen:
            return False
        _seen.add(expr.id)
        bound = env.get(expr.id)
        if bound is not None:
            r = _temp_derived(bound, env, params, _seen)
            if r:
                return r
        if expr.id in params:
            return f"param:{expr.id}"
        return False
    if isinstance(expr, ast.JoinedStr):
        return any(
            _temp_derived(
                v.value if isinstance(v, ast.FormattedValue) else v,
                env, params, _seen) is True
            for v in expr.values)
    if isinstance(expr, ast.BinOp):
        return (_temp_derived(expr.left, env, params, _seen) is True
                or _temp_derived(expr.right, env, params, _seen) is True)
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        if t in ("mkdtemp", "mkstemp", "NamedTemporaryFile",
                 "TemporaryDirectory", "gettempdir", "mktemp"):
            return True
        if t in ("join", "joinpath", "fspath", "abspath", "str"):
            return any(_temp_derived(a, env, params, _seen) is True
                       for a in expr.args)
        if t == "open" and expr.args:
            return _temp_derived(expr.args[0], env, params, _seen)
        return False
    if isinstance(expr, ast.Attribute):
        # fh.name on a NamedTemporaryFile, tmp_path / ... — unknown
        return _temp_derived(expr.value, env, params, _seen) is True
    return False


def _open_write_target(call: ast.Call):
    """The path argument of an ``open(...)`` that writes (mode contains
    w/x); append-mode streams (JSONL ledgers) are a different idiom and
    exempt."""
    if terminal_name(call.func) != "open" or not call.args:
        return None
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and ("w" in mode or "x" in mode):
        return call.args[0]
    return None


def _write_helper_map(project: Project) -> dict[str, int]:
    """Functions whose open-for-write target is a bare parameter
    (``Checkpointer._write_file``): name -> parameter position. Their
    call sites are the write events to audit."""
    helpers: dict[str, int] = {}
    for f in project.funcs:
        if not f.name or f.is_module:
            continue
        env = _func_env(f)
        params = set(f.params)
        for node in iter_owned(f.node):
            if not isinstance(node, ast.Call):
                continue
            tgt = _open_write_target(node)
            if tgt is None:
                continue
            r = _temp_derived(tgt, env, params)
            if isinstance(r, str):
                pname = r.split(":", 1)[1]
                pos = [p for p in f.params if p not in ("self", "cls")]
                if pname in pos:
                    helpers[f.name] = pos.index(pname)
    return helpers


def _write_events(f: FuncInfo, env, helpers):
    """Yield (call node, target path expr) for every byte-writing call in
    one function: open-for-write, ``np.save*``, and calls to known write
    helpers."""
    for node in iter_owned(f.node):
        if not isinstance(node, ast.Call):
            continue
        tgt = _open_write_target(node)
        if tgt is not None:
            yield node, tgt
            continue
        t = terminal_name(node.func)
        if (t in _NP_WRITERS and isinstance(node.func, ast.Attribute)
                and terminal_name(node.func.value) in _NP_RECEIVERS
                and node.args):
            tgt = node.args[0]
            bound = env.get(tgt.id) if isinstance(tgt, ast.Name) else None
            if (isinstance(bound, ast.Call)
                    and terminal_name(bound.func) == "open"
                    and bound.args):
                tgt = bound.args[0]  # handle from `with open(p) as fh`
            yield node, tgt
            continue
        if (t in helpers and isinstance(node.func, (ast.Name,
                                                    ast.Attribute))):
            pos = helpers[t]
            if pos < len(node.args):
                yield node, node.args[pos]


def check_non_atomic_publish(project: Project) -> list[Finding]:
    """Bare writes to published paths in transactional modules. The
    checkpoint/topology save discipline (PR 7, ``utils/checkpoint.py``,
    ``CSRTopo.save``) is: write into a temp name, fsync, publish with ONE
    ``os.replace`` (COMMIT marker last) — a crash mid-save must leave an
    invisible temp, never a torn file a reader can load. In modules on
    that save path (path matches checkpoint/topology/streaming/integrity,
    or the module performs ``os.replace`` itself), ``open(final_path,
    "w")`` / ``np.savez(final_path)`` whose target does not derive from a
    temp source is a finding; write *helpers* taking the path as a
    parameter are audited at their call sites. Append-mode streams (JSONL
    ledgers) are exempt — appending is a different idiom."""
    helpers = _write_helper_map(project)
    out = []
    for src in project.files:
        if not _txn_scoped(src):
            continue
        for f in _real_funcs(src.funcs):
            env = _func_env(f)
            params = set(f.params)
            for call, tgt in _write_events(f, env, helpers):
                r = _temp_derived(tgt, env, params)
                if r is True or isinstance(r, str):
                    continue  # temp-derived, or this IS a write helper
                out.append(_finding(
                    "non-atomic-publish", f, call,
                    "write to a published path in a transactional module "
                    "without the atomic-publish pattern; a crash mid-"
                    "write leaves a torn file the next reader trusts — "
                    "write into a temp name, fsync, then publish with "
                    "one os.replace (cf. utils/checkpoint.py, "
                    "CSRTopo.save)",
                ))
    return out


def check_commit_marker_order(project: Project) -> list[Finding]:
    """COMMIT markers written before the payload. The marker's entire
    meaning (``utils/checkpoint.py``, ``resilience/integrity.py``) is
    "every byte before me is durable" — ``_write_sync`` writes arrays,
    treedef and manifest first and the marker LAST. A function that
    writes a COMMIT-named file before other writes re-introduces the
    torn-checkpoint window the marker exists to close."""
    helpers = _write_helper_map(project)

    def mentions_commit(expr) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                if "COMMIT" in n.value:
                    return True
            elif isinstance(n, (ast.Name, ast.Attribute)):
                t = terminal_name(n)
                if t and "COMMIT" in t:
                    return True
        return False

    out = []
    for src in project.files:
        if not _txn_scoped(src):
            continue
        for f in _real_funcs(src.funcs):
            env = _func_env(f)
            events = list(_write_events(f, env, helpers))
            if len(events) < 2:
                continue
            for call, tgt in events:
                if not mentions_commit(tgt):
                    continue
                later = [c for c, t2 in events
                         if c.lineno > call.lineno
                         and not mentions_commit(t2)]
                if later:
                    out.append(_finding(
                        "commit-marker-order", f, call,
                        f"COMMIT marker written before {len(later)} later "
                        "write(s); the marker asserts every byte before "
                        "it is durable, so it must be the LAST write "
                        "before the os.replace publish "
                        "(cf. Checkpointer._write_sync)",
                    ))
    return out


def check_replace_without_fsync(project: Project) -> list[Finding]:
    """``os.replace`` publishes without an fsync of the payload. The
    rename is atomic in the namespace, not in the page cache: publishing
    bytes that were never flushed can surface a zero-length or torn file
    at the FINAL name after a crash — exactly the torn state the temp-
    then-rename dance exists to prevent. Any function (tree-wide) that
    both writes bytes and calls ``os.replace`` must fsync, directly or
    via a callee (``_write_file`` fsyncs for ``_write_sync``). Pure
    renames (quarantine moves) write nothing and are exempt."""
    helpers = _write_helper_map(project)
    # functions that fsync DIRECTLY; one level of callee credit (the
    # ``_write_sync -> _write_file`` shape) — a transitive closure over
    # terminal names would let common names like ``save`` launder the
    # credit across the whole tree
    fsyncers: set[str] = set()
    call_names = {}
    for f in project.funcs:
        if not f.name or f.is_module:
            continue
        names = {name for _k, name, _n in f.calls}
        call_names[id(f)] = names
        if "fsync" in names:
            fsyncers.add(f.name)
    out = []
    for src in project.files:
        for f in _real_funcs(src.funcs):
            replaces = [n for n in iter_owned(f.node)
                        if isinstance(n, ast.Call) and _is_os_replace(n)]
            if not replaces:
                continue
            env = _func_env(f)
            if not any(True for _ in _write_events(f, env, helpers)):
                continue  # pure rename (quarantine move), no payload
            names = call_names.get(id(f), set())
            if "fsync" in names or names & fsyncers:
                continue
            out.append(_finding(
                "replace-without-fsync", f, replaces[0],
                f"{f.qualname} writes bytes and publishes them with "
                "os.replace but never fsyncs; after a crash the FINAL "
                "name can hold a zero-length or torn file — fsync the "
                "payload (and ideally the directory) before the rename "
                "(cf. CSRTopo.save)",
            ))
    return out


# -- rules 11-13: concurrency/lifecycle family -------------------------------

_EXECUTOR_NAMES = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_CLOSER_NAMES = {"close", "shutdown", "stop", "join", "terminate",
                 "__exit__", "__del__"}


def check_executor_lifecycle(project: Project) -> list[Finding]:
    """Executors without a shutdown path. A ``ThreadPoolExecutor`` owned
    by an object (``Checkpointer._pool``) must have ``shutdown()``
    reachable from a lifecycle method (``close``/``__exit__``/...):
    otherwise worker threads outlive the object and an in-flight task can
    fire against torn-down state — the exact close-races-async-save bug
    PR 6 fixed. A function-local executor must be shut down in the same
    function (``with`` block, or an explicit ``shutdown()`` — the
    Prefetcher's ``finally: pool.shutdown(wait=False)``), unless
    ownership is transferred (returned / stored on self)."""
    out = []
    # class-owned executors
    for (_path, cls), methods in sorted(_direct_methods(project).items()):
        owned: dict[str, tuple[FuncInfo, ast.AST]] = {}
        shutdown_sites: dict[str, set[str]] = {}
        self_calls: dict[str, set[str]] = {}
        for m in methods:
            self_calls[m.name] = _self_method_calls(m)
            for node in iter_owned(m.node):
                if isinstance(node, ast.Assign):
                    v = node.value
                    if (isinstance(v, ast.Call)
                            and terminal_name(v.func) in _EXECUTOR_NAMES):
                        for t in node.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                owned.setdefault(t.attr, (m, v))
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr == "shutdown"):
                    recv = node.func.value
                    if (isinstance(recv, ast.Attribute)
                            and isinstance(recv.value, ast.Name)
                            and recv.value.id == "self"):
                        shutdown_sites.setdefault(recv.attr,
                                                  set()).add(m.name)
        if owned:
            method_names = {m.name for m in methods}
            reach = set(method_names & _CLOSER_NAMES)
            work = list(reach)
            while work:
                cur = work.pop()
                for nxt in self_calls.get(cur, ()):
                    if nxt in method_names and nxt not in reach:
                        reach.add(nxt)
                        work.append(nxt)
            for attr, (m, v) in sorted(owned.items()):
                if not (shutdown_sites.get(attr, set()) & reach):
                    out.append(_finding(
                        "executor-lifecycle", m, v,
                        f"{cls}.{attr} owns a "
                        f"{terminal_name(v.func)} with no shutdown() "
                        "reachable from a lifecycle method "
                        f"({sorted(_CLOSER_NAMES)[:3]}...); worker "
                        "threads outlive the object and queued tasks can "
                        "fire against torn-down state — add a close() "
                        f"that calls self.{attr}.shutdown() "
                        "(cf. Checkpointer.close)",
                    ))
    # function-local executors
    for f in _real_funcs(project.funcs):
        if f.is_module:
            continue
        locals_exec: dict[str, ast.AST] = {}
        shut: set[str] = set()
        transferred: set[str] = set()
        with_used: set[str] = set()
        for node in iter_owned(f.node):
            if isinstance(node, ast.Assign):
                v = node.value
                if (isinstance(v, ast.Call)
                        and terminal_name(v.func) in _EXECUTOR_NAMES):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            locals_exec.setdefault(t.id, v)
                        elif isinstance(t, ast.Attribute):
                            pass  # self-attr case handled above
                elif isinstance(v, ast.Name):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute):
                            transferred.add(v.id)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Name):
                        with_used.add(ce.id)
            elif isinstance(node, ast.Return) and node.value is not None:
                # ownership transfer = returning the executor ITSELF (or
                # a tuple holding it), not any expression that mentions it
                v = node.value
                vals = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
                for n in vals:
                    if isinstance(n, ast.Name):
                        transferred.add(n.id)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "shutdown"
                  and isinstance(node.func.value, ast.Name)):
                shut.add(node.func.value.id)
        for name, v in sorted(locals_exec.items()):
            if name in shut or name in with_used or name in transferred:
                continue
            out.append(_finding(
                "executor-lifecycle", f, v,
                f"local {terminal_name(v.func)} {name!r} in "
                f"{f.qualname} is never shut down; its worker threads "
                "outlive the call — use a with block or "
                f"try/finally: {name}.shutdown() "
                "(cf. Prefetcher.run)",
            ))
    return out


def check_lock_held_across_call(project: Project) -> list[Finding]:
    """Holding a non-reentrant lock across a call that can re-acquire it.
    ``with self._lock:`` around a call to a method that itself takes
    ``self._lock`` deadlocks the owner thread (``threading.Lock`` is not
    reentrant) — the classic lifecycle bug of close() paths that lock and
    then call a locked helper. Acquisition propagates through same-class
    ``self.`` calls, so an indirect re-entry two calls deep is still
    caught. RLock-backed attributes are exempt (reentrancy is their
    point)."""
    out = []
    for (_path, cls), methods in sorted(_direct_methods(project).items()):
        locks: dict[str, str] = {}
        for m in methods:
            for node in iter_owned(m.node):
                if isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Call):
                    t = terminal_name(node.value.func)
                    if t in ("Lock", "RLock"):
                        for tt in node.targets:
                            if (isinstance(tt, ast.Attribute)
                                    and isinstance(tt.value, ast.Name)
                                    and tt.value.id == "self"):
                                locks[tt.attr] = t
        nonreentrant = {a for a, k in locks.items() if k == "Lock"}
        if not nonreentrant:
            continue

        def acquired_attrs(node) -> set[str]:
            got: set[str] = set()
            if isinstance(node, (ast.With, ast.AsyncWith)):
                exprs = [i.context_expr for i in node.items]
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "acquire"):
                exprs = [node.func.value]
            else:
                return got
            for e in exprs:
                if (isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"
                        and e.attr in nonreentrant):
                    got.add(e.attr)
            return got

        direct: dict[str, set[str]] = {}
        self_calls: dict[str, set[str]] = {}
        for m in methods:
            self_calls[m.name] = _self_method_calls(m)
            got: set[str] = set()
            for node in iter_owned(m.node):
                got |= acquired_attrs(node)
            direct[m.name] = got
        may = {name: set(v) for name, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for name, callees in self_calls.items():
                for c in callees:
                    extra = may.get(c, set()) - may[name]
                    if extra:
                        may[name] |= extra
                        changed = True
        for m in methods:
            for node in iter_owned(m.node):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                held = acquired_attrs(node)
                if not held:
                    continue
                for stmt in node.body:
                    for n in ast.walk(stmt):
                        if (isinstance(n, ast.Call)
                                and isinstance(n.func, ast.Attribute)
                                and isinstance(n.func.value, ast.Name)
                                and n.func.value.id == "self"):
                            callee = n.func.attr
                            re_acq = may.get(callee, set()) & held
                            if re_acq:
                                attr = sorted(re_acq)[0]
                                out.append(_finding(
                                    "lock-held-across-call", m, n,
                                    f"{cls}.{m.name} calls "
                                    f"self.{callee}() while holding "
                                    f"self.{attr}, and {callee} "
                                    f"(re)acquires self.{attr} — "
                                    "threading.Lock is not reentrant, "
                                    "this deadlocks; release first, or "
                                    "split a _locked variant of the "
                                    "callee",
                                ))
    return out


# -- rule 13: metric-name-constant (family: concurrency) ---------------------

_TAPE_METHODS = frozenset({"add", "set"})
_REGISTRY_METHODS = frozenset({"counter", "gauge", "set", "add", "value",
                               "snapshot", "spec", "clear"})


def check_metric_name_constant(project: Project) -> list[Finding]:
    """Registry metric names must come from the ``obs/registry.py``
    constants, mirroring the axis-name rule: a string literal in a
    ``tape.add``/``registry.counter``/``metrics.set`` name position is
    producer/consumer spelling drift waiting to happen (the constants
    exist precisely because the three pre-graftscope telemetry streams
    drifted by hand), and a literal matching NO declared constant is
    drift that already happened."""
    declared = project.declared_metrics
    if not declared:
        return []
    by_value = {v: k for k, v in declared.items()}
    out = []
    for src in project.files:
        for node in ast.walk(src.tree):
            if (not isinstance(node, ast.Call)
                    or not isinstance(node.func, ast.Attribute)
                    or not node.args):
                continue
            recv = terminal_name(node.func.value)
            if recv is None:
                continue
            recv_l = recv.lower().lstrip("_")
            meth = node.func.attr
            if recv_l.endswith("tape"):
                if meth not in _TAPE_METHODS:
                    continue
            elif recv_l.endswith(("metrics", "registry")):
                if meth not in _REGISTRY_METHODS:
                    continue
            else:
                continue
            a0 = node.args[0]
            if not (isinstance(a0, ast.Constant)
                    and isinstance(a0.value, str)):
                continue
            s = a0.value
            if s in by_value:
                out.append(_finding(
                    "metric-name-constant", src.path, a0,
                    f"hardcoded metric name {s!r}; use the shared "
                    f"constant {by_value[s]} (quiver_tpu.obs.registry) "
                    "so producer and consumer spelling cannot drift",
                ))
            elif _METRIC_NAME_RE.match(s):
                out.append(_finding(
                    "metric-name-constant", src.path, a0,
                    f"metric name {s!r} matches no declared registry "
                    f"constant (declared: {sorted(by_value)}) — declare "
                    "it in obs/registry.py first; an undeclared literal "
                    "is spelling drift a consumer cannot catch",
                ))
    return out


RULES = {
    "env-at-trace": check_env_at_trace,
    "axis-name-consistency": check_axis_name_consistency,
    "cond-branch-parity": check_cond_branch_parity,
    "host-op-on-tracer": check_host_op_on_tracer,
    "per-call-logging-in-jit": check_per_call_logging_in_jit,
    "export-doc-drift": check_export_doc_drift,
    "stale-version-read": check_stale_version_read,
    "non-atomic-publish": check_non_atomic_publish,
    "commit-marker-order": check_commit_marker_order,
    "replace-without-fsync": check_replace_without_fsync,
    "executor-lifecycle": check_executor_lifecycle,
    "lock-held-across-call": check_lock_held_across_call,
    "metric-name-constant": check_metric_name_constant,
}

# rule families: ``--select``/``--ignore`` accept family names and expand
# them to their member rules
FAMILIES = {
    "trace": ("env-at-trace", "cond-branch-parity", "host-op-on-tracer",
              "per-call-logging-in-jit"),
    "consistency": ("axis-name-consistency", "export-doc-drift"),
    "staleness": ("stale-version-read",),
    "transaction": ("non-atomic-publish", "commit-marker-order",
                    "replace-without-fsync"),
    "concurrency": ("executor-lifecycle", "lock-held-across-call",
                    "metric-name-constant"),
}


def family_of(rule: str) -> str:
    for fam, rules in FAMILIES.items():
        if rule in rules:
            return fam
    return "meta"

# names valid in suppressions but emitted by the runner itself
META_RULES = ("bad-suppression", "parse-error")


def rule_docs() -> dict[str, str]:
    return {name: (fn.__doc__ or "").strip() for name, fn in RULES.items()}
