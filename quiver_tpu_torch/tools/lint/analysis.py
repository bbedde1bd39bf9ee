"""Capture-reachability analysis over the linted source tree.

The question every trace-family rule asks is *"does this code run under
CUDA-graph capture or a torch trace?"*. Such code runs once, when the
graph is captured (or the function traced), and never again on replay: a
host read there (``.item()``, a boolean mask, ``torch.cuda.synchronize``)
breaks the capture, and an environment read or a log line there is pinned
to the capture while looking live. PR 12's captured trainer step failed on
the card for exactly such a host read. Answering it statically needs a
conservative call-graph walk:

1. **Entry points**: the bodies of ``with torch.cuda.graph(...)`` blocks
   (each a *capture region*); callables given to
   ``torch.cuda.make_graphed_callables``, ``torch.compile`` (as a call or
   a decorator) and ``torch.func.{grad, grad_and_value, vmap, jacrev,
   jacfwd, functional_call}``; the branches of ``torch.cond``.
2. **Propagation**: from captured code, a call by name marks the callee
   captured. Name calls resolve lexically (params/locals shadow globals).
   ``self.<name>(...)`` resolves within the caller's class first: to its
   method of that name, else, when the class stores a constructor
   argument under that name (``self.step = step``), to the callables
   every instantiation of the class passes there; other attribute calls
   resolve by terminal name against every named function in the analyzed
   file set (conservative: homonyms all get marked). Calling an object
   that resolves to no function (a parameter, a local, an instance
   attribute) may call an ``nn.Module``, so it marks every ``forward`` of
   an ``nn.Module`` subclass. Class instantiation marks ``__init__``;
   property *access* marks the property body; local functions/lambdas
   passed as arguments or returned from captured code are marked.
3. **Barriers**: a *resolve-once* function (``global X`` + an ``if X is
   [not] None`` guard + an assignment to ``X``) runs its slow path once per
   process, not once per capture; a call whose every path runs under a
   false ``torch.cuda.is_current_stream_capturing()`` (the body of ``if
   not (... capturing())``, the ``else`` of ``if ... capturing()``) does
   not run under capture. The walk neither flags nor descends into either.

Everything here is stdlib ``ast``; the analyzed code is never imported.
"""

from __future__ import annotations

import ast
import dataclasses
import re

__all__ = [
    "FuncInfo",
    "SourceFile",
    "Project",
    "analyze",
    "capture_guarded",
    "parent_map",
    "terminal_name",
    "iter_owned",
    "is_env_read",
]

# torch.func transforms (receiver ``func``, or imported by name):
# positional index of the transformed callable
_FUNC_TRANSFORMS = {"grad": (0,), "grad_and_value": (0,), "vmap": (0,),
                    "jacrev": (0,), "jacfwd": (0,), "functional_call": (0,)}
# entry callables by (receiver terminal, attribute); None = any receiver
_ENTRY_CALLS = {
    (None, "make_graphed_callables"): (0,),
    ("torch", "compile"): (0,),
    ("torch", "cond"): (1, 2),
    **{("func", n): p for n, p in _FUNC_TRANSFORMS.items()},
}
# the same entries called by a bare name imported from torch
_IMPORTED_ENTRIES = {"compile": (0,), "cond": (1, 2), "make_graphed_callables": (0,),
                     **_FUNC_TRANSFORMS}

# decorator names that make the decorated function an entry
_TRACE_DECORATORS = {"compile"}

# attribute accesses and method calls that read STATIC tensor metadata on
# the host, not device values
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "is_leaf", "itemsize", "nbytes", "names"}
STATIC_METHODS = {"size", "dim", "numel", "stride", "element_size",
                  "is_contiguous", "get_device", "data_ptr", "nelement",
                  "is_floating_point", "is_complex", "storage_offset"}

# attribute-call names that are overwhelmingly builtin container/tensor
# methods: linking them by terminal name to same-named project functions
# produces wrong call-graph edges (e.g. ``tiers.append(...)`` marking a
# project-level ``def append`` captured)
_BUILTIN_METHOD_NAMES = frozenset(
    n for t in (list, dict, str, set, tuple, bytes, frozenset)
    for n in dir(t) if not n.startswith("_")
) | {"to", "reshape", "item", "view", "tolist", "add", "max", "min", "sum",
     "mean", "all", "any", "copy_", "fill_", "zero_", "clone", "detach",
     "contiguous", "flatten", "expand", "gather", "scatter_", "where",
     "numpy", "cpu", "cuda", "float", "int", "long", "bool", "half",
     "size", "dim", "numel", "stride", "backward", "record_stream",
     "synchronize", "wait_stream", "zero_grad"}

# a registry metric name: dotted lowercase segments, each starting with a
# letter ("feature.routed_overflow") — version strings like "1.0" do not
# match
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")

_CAPTURING = "is_current_stream_capturing"


def terminal_name(expr: ast.AST) -> str | None:
    """The rightmost name of a call target: ``torch.cuda.graph`` ->
    ``graph``."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def iter_owned(func_node: ast.AST):
    """Yield the AST nodes lexically owned by one function — its body minus
    the bodies of nested function/class definitions (those have their own
    FuncInfo / are analyzed separately). Nested defs themselves are
    yielded (the ``def`` executes in this scope) but never descended
    into — including when they sit directly in the body (a module's
    top-level functions must not leak their statements into the module
    pseudo-function). A capture region (a ``with`` statement) owns its
    body."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
    if isinstance(func_node, ast.Lambda):
        roots = [func_node.body]
    else:
        roots = list(func_node.body)
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, defs):
            continue
        for child in ast.iter_child_nodes(node):
            if isinstance(child, defs):
                stack.append(child)  # yield the def, not its body
                continue
            stack.append(child)


def is_env_read(node: ast.AST) -> str | None:
    """Return a short description when ``node`` reads the environment:
    ``os.environ.get(...)``, ``os.environ[...]``, ``os.getenv(...)`` (plus
    the bare-``environ`` spellings a ``from os import environ`` leaves)."""
    if isinstance(node, ast.Call):
        t = terminal_name(node.func)
        if t == "getenv":
            return "os.getenv(...)"
        if t == "get" and isinstance(node.func, ast.Attribute):
            if terminal_name(node.func.value) == "environ":
                return "os.environ.get(...)"
    elif isinstance(node, ast.Subscript):
        if terminal_name(node.value) == "environ":
            return "os.environ[...]"
    return None


def is_graph_capture(expr: ast.AST) -> bool:
    """Whether a ``with`` item's context expression opens a CUDA-graph
    capture: ``torch.cuda.graph(...)`` (or ``cuda.graph``)."""
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "graph"
            and terminal_name(expr.func.value) == "cuda")


def _mentions_capturing(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and terminal_name(n.func) == _CAPTURING
               for n in ast.walk(expr))


def _implies_capturing(test: ast.AST) -> bool:
    """``test`` true implies the stream is capturing: the check itself, or
    a conjunction holding it."""
    if isinstance(test, ast.Call):
        return terminal_name(test.func) == _CAPTURING
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_implies_capturing(v) for v in test.values)
    return False


def _implies_not_capturing(test: ast.AST) -> bool:
    """``test`` true implies the stream is NOT capturing: ``not C`` for a
    ``C`` that implies capturing, or a conjunction holding one."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _implies_capturing(test.operand)
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_implies_not_capturing(v) for v in test.values)
    return False


def parent_map(root: ast.AST) -> dict[int, ast.AST]:
    """``id(node) -> parent`` for every node under ``root``."""
    out = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _branches(parents: dict, target: ast.AST):
    """Yield ``(test, in_body)`` for every ``if`` (statement or
    expression) whose body or ``else`` holds ``target``."""
    child = target
    while id(child) in parents:
        parent = parents[id(child)]
        if isinstance(parent, (ast.If, ast.IfExp)):
            body = parent.body if isinstance(parent.body, list) else [parent.body]
            orelse = (parent.orelse if isinstance(parent.orelse, list)
                      else [parent.orelse])
            if child in body:
                yield parent.test, True
            elif child in orelse:
                yield parent.test, False
        child = parent


def capture_guarded(parents: dict, target: ast.AST) -> bool:
    """Whether ``target`` runs only while
    ``torch.cuda.is_current_stream_capturing()`` is false: it sits in the
    body of an ``if`` whose test implies not capturing, or in the ``else``
    of one whose test implies capturing (``parents``: the enclosing
    function's :func:`parent_map`)."""
    return any(_implies_not_capturing(test) if in_body else _implies_capturing(test)
               for test, in_body in _branches(parents, target))


@dataclasses.dataclass
class FuncInfo:
    """Per-function facts collected in one parse pass."""

    # FunctionDef | AsyncFunctionDef | Lambda | Module | With (a capture
    # region: the body of a ``with torch.cuda.graph(...)``)
    node: ast.AST
    path: str
    name: str | None  # None for lambdas, regions and the module pseudo-function
    qualname: str
    parent: "FuncInfo | None"
    class_name: str | None = None
    params: list[str] = dataclasses.field(default_factory=list)
    # positional parameters WITHOUT defaults, minus self/cls: the arguments
    # that plausibly carry device tensors (keyword-only / defaulted args
    # are config by convention in this codebase)
    taint_params: list[str] = dataclasses.field(default_factory=list)
    local_names: set[str] = dataclasses.field(default_factory=set)
    imported_names: set[str] = dataclasses.field(default_factory=set)
    # the imported names that come from outside the analyzed set (torch,
    # numpy, the standard library): calls through them link to nothing
    external_names: set[str] = dataclasses.field(default_factory=set)
    local_funcs: dict[str, list["FuncInfo"]] = dataclasses.field(
        default_factory=dict)
    # (kind, name, node): kind is "name" | "attr" | "self"
    calls: list[tuple[str, str, ast.AST]] = dataclasses.field(
        default_factory=list)
    # local functions/lambdas referenced as call arguments or returned
    passed_local_funcs: list["FuncInfo"] = dataclasses.field(
        default_factory=list)
    attr_loads: set[str] = dataclasses.field(default_factory=set)
    is_property: bool = False
    is_resolve_once: bool = False
    # pinned eager by annotation: ``# graftlint: eager -- <reason>`` on (or
    # directly above) the def line — for functions that are lexically
    # reachable from captured code but eager-only by contract
    is_eager_pinned: bool = False
    is_module: bool = False
    is_region: bool = False
    traced: bool = False
    trace_reason: str | None = None
    trace_chain: tuple[str, ...] = ()

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclasses.dataclass
class SourceFile:
    path: str  # display path (relative where possible)
    text: str
    tree: ast.Module
    module_info: FuncInfo = None  # set by analyze()
    funcs: list[FuncInfo] = dataclasses.field(default_factory=list)
    # def-line -> reason, from ``# graftlint: eager -- <reason>`` comments
    eager_lines: dict[int, str] = dataclasses.field(default_factory=dict)
    # bare name -> original name, for names imported from torch
    torch_imports: dict[str, str] = dataclasses.field(default_factory=dict)
    # names bound anywhere in the file by imports from outside the
    # analyzed set
    external_names: set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Project:
    files: list[SourceFile]
    funcs: list[FuncInfo] = dataclasses.field(default_factory=list)
    # simple name -> named functions/methods anywhere in the file set
    index: dict[str, list[FuncInfo]] = dataclasses.field(default_factory=dict)
    class_index: dict[str, list[FuncInfo]] = dataclasses.field(
        default_factory=dict)  # class name -> [__init__ FuncInfo]
    property_index: dict[str, list[FuncInfo]] = dataclasses.field(
        default_factory=dict)
    # (path, class) -> {method name: [FuncInfo]} for methods defined
    # directly in the class body
    class_methods: dict[tuple[str, str], dict[str, list[FuncInfo]]] = (
        dataclasses.field(default_factory=dict))
    # class name -> base terminal names
    class_bases: dict[str, set[str]] = dataclasses.field(default_factory=dict)
    declared_axes: dict[str, str] = dataclasses.field(
        default_factory=dict)  # constant name -> axis string
    # metric-name constants (obs/registry.py discipline): ALL_CAPS module
    # constants whose value is a dotted lowercase metric name
    declared_metrics: dict[str, str] = dataclasses.field(
        default_factory=dict)
    node_func: dict[int, FuncInfo] = dataclasses.field(default_factory=dict)
    # id(func node) -> CFG, filled lazily by tools.lint.cfg.cfg_of
    cfg_cache: dict = dataclasses.field(default_factory=dict)
    # id(func node) -> parent_map, filled lazily by parents_of
    parent_cache: dict = dataclasses.field(default_factory=dict)

    def owner_of(self, node: ast.AST) -> FuncInfo | None:
        return self.node_func.get(id(node))

    def parents_of(self, func: FuncInfo) -> dict:
        """The memoized :func:`parent_map` of one function's node."""
        out = self.parent_cache.get(id(func.node))
        if out is None:
            out = self.parent_cache[id(func.node)] = parent_map(func.node)
        return out


# -- per-file collection ------------------------------------------------------


def _decorator_names(dec: ast.AST) -> set[str]:
    """Terminal names reachable in a decorator expression, unwrapping
    ``partial(torch.compile, ...)``."""
    names = set()
    t = terminal_name(dec)
    if t:
        names.add(t)
    if isinstance(dec, ast.Call):
        ft = terminal_name(dec.func)
        if ft:
            names.add(ft)
        if ft == "partial" and dec.args:
            inner = terminal_name(dec.args[0])
            if inner:
                names.add(inner)
    return names


def _collect_params(node: ast.AST) -> tuple[list[str], list[str]]:
    """(all param names, taint params: positional-without-default minus
    self/cls)."""
    if isinstance(node, (ast.Module, ast.With, ast.AsyncWith)):
        return [], []
    a = node.args
    allp = [p.arg for p in
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
    if a.vararg:
        allp.append(a.vararg.arg)
    if a.kwarg:
        allp.append(a.kwarg.arg)
    pos = list(a.posonlyargs) + list(a.args)
    n_default = len(a.defaults)
    no_default = pos[: len(pos) - n_default] if n_default else pos
    taint = [p.arg for p in no_default if p.arg not in ("self", "cls")]
    return allp, taint


def _detect_resolve_once(info: FuncInfo) -> bool:
    """The sanctioned memoization idiom: ``global X`` + ``if X is [not]
    None`` + an assignment to X. Such a function's slow path runs once per
    process — a barrier for the captured-reachability walk."""
    if isinstance(info.node, (ast.Lambda, ast.Module)) or info.is_region:
        return False
    globals_declared: set[str] = set()
    guarded: set[str] = set()
    assigned: set[str] = set()
    for node in iter_owned(info.node):
        if isinstance(node, ast.Global):
            globals_declared.update(node.names)
        elif isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            cmp = node.test
            if (isinstance(cmp.left, ast.Name)
                    and len(cmp.ops) == 1
                    and isinstance(cmp.ops[0], (ast.Is, ast.IsNot))
                    and len(cmp.comparators) == 1
                    and isinstance(cmp.comparators[0], ast.Constant)
                    and cmp.comparators[0].value is None):
                guarded.add(cmp.left.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigned.add(t.id)
    return bool(globals_declared & guarded & assigned)


class _Collector(ast.NodeVisitor):
    """One pass over a file: build FuncInfos, local scopes, call edges."""

    def __init__(self, src: SourceFile, project: Project, roots: set[str]):
        self.src = src
        self.project = project
        self.roots = roots
        module = FuncInfo(node=src.tree, path=src.path, name=None,
                          qualname="<module>", parent=None, is_module=True)
        src.module_info = module
        self.stack: list[FuncInfo] = [module]
        self.class_stack: list[str] = []
        self._register(module)

    # -- helpers --

    def _register(self, info: FuncInfo):
        self.src.funcs.append(info)
        self.project.funcs.append(info)

    def _own(self, node: ast.AST):
        self.project.node_func[id(node)] = self.stack[-1]

    def _bind_local(self, name: str):
        self._scope().local_names.add(name)

    def _bind_func(self, name: str, info: FuncInfo):
        self._scope().local_funcs.setdefault(name, []).append(info)

    def _scope(self) -> FuncInfo:
        """The innermost real scope (a capture region binds into the
        function that holds it)."""
        for info in reversed(self.stack):
            if not info.is_region:
                return info
        return self.stack[0]

    # -- defs --

    def _enter_func(self, node, name: str | None):
        parent = self.stack[-1]
        qual = (parent.qualname + "." if not parent.is_module else "") + (
            name or "<lambda>")
        cls = self.class_stack[-1] if self.class_stack else None
        allp, taint = _collect_params(node)
        info = FuncInfo(node=node, path=self.src.path, name=name,
                        qualname=qual, parent=parent, class_name=cls,
                        params=allp, taint_params=taint)
        info.local_names.update(allp)
        self._register(info)
        return info

    def visit_FunctionDef(self, node):
        self._visit_funcdef(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_funcdef(node)

    def _visit_funcdef(self, node):
        info = self._enter_func(node, node.name)
        info.is_eager_pinned = node.lineno in self.src.eager_lines
        dec_names = set()
        for dec in node.decorator_list:
            dec_names |= _decorator_names(dec)
            # decorator expressions evaluate in the ENCLOSING scope
            self.visit(dec)
        info.is_property = "property" in dec_names or "cached_property" in dec_names
        if dec_names & _TRACE_DECORATORS and not info.is_eager_pinned:
            info.traced = True
            info.trace_reason = (
                f"decorated with {sorted(dec_names & _TRACE_DECORATORS)[0]}")
        # the def binds its name in the enclosing scope; methods bind in
        # the class namespace, which plain calls cannot see lexically
        directly_in_class = bool(self.class_stack) and self.stack[-1].is_module
        if not directly_in_class:
            self._bind_func(node.name, info)
            self._bind_local(node.name)
        else:
            key = (self.src.path, self.class_stack[-1])
            self.project.class_methods.setdefault(key, {}).setdefault(
                node.name, []).append(info)
        # index every named function by simple name (conservative linking)
        self.project.index.setdefault(node.name, []).append(info)
        if info.is_property:
            self.project.property_index.setdefault(
                node.name, []).append(info)
        if directly_in_class and node.name == "__init__":
            self.project.class_index.setdefault(
                self.class_stack[-1], []).append(info)
        self.stack.append(info)
        for stmt in node.body:
            self.visit(stmt)
        self.stack.pop()
        info.is_resolve_once = _detect_resolve_once(info)

    def visit_Lambda(self, node):
        info = self._enter_func(node, None)
        self.stack.append(info)
        self.visit(node.body)
        self.stack.pop()

    def visit_ClassDef(self, node):
        self._own(node)
        self._bind_local(node.name)
        self.project.class_bases.setdefault(node.name, set()).update(
            t for t in (terminal_name(b) for b in node.bases) if t)
        self.class_stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self.class_stack.pop()

    # -- scope bindings --

    def visit_Global(self, node):
        self._own(node)

    def _bind_import(self, name: str, external: bool):
        self._scope().imported_names.add(name)
        if external:
            self._scope().external_names.add(name)
            self.src.external_names.add(name)

    def visit_Import(self, node):
        self._own(node)
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            self._bind_import(name, alias.name.split(".")[0] not in self.roots)

    def visit_ImportFrom(self, node):
        self._own(node)
        root = (node.module or "").split(".")[0]
        external = node.level == 0 and root not in self.roots
        for alias in node.names:
            self._bind_import(alias.asname or alias.name, external)
            if root == "torch" and node.level == 0:
                self.src.torch_imports[alias.asname or alias.name] = alias.name

    def _bind_target(self, target):
        if isinstance(target, ast.Name):
            self._bind_local(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value)

    def visit_Assign(self, node):
        self._own(node)
        # a name bound to a lambda behaves like a local def
        if isinstance(node.value, ast.Lambda):
            before = len(self.src.funcs)
            self.visit(node.value)
            lam = self.src.funcs[before]  # the outermost lambda just visited
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._bind_func(t.id, lam)
                    lam.qualname = (self.stack[-1].qualname + "." + t.id
                                    + ".<lambda>")
        else:
            self.visit(node.value)
        for t in node.targets:
            self._bind_target(t)
            self.visit(t)
        # module-level axis-name constants: NAME_AXIS = "literal"; and
        # metric-name constants: ALL_CAPS = "dotted.lowercase"
        if (self.stack[-1].is_module
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id.endswith("_AXIS"):
                    self.project.declared_axes[t.id] = node.value.value
                elif (t.id.isupper()
                      and _METRIC_NAME_RE.match(node.value.value)):
                    self.project.declared_metrics[t.id] = node.value.value

    def visit_AnnAssign(self, node):
        self._own(node)
        if node.value is not None:
            self.visit(node.value)
        self._bind_target(node.target)

    def visit_AugAssign(self, node):
        self._own(node)
        self.visit(node.value)
        self._bind_target(node.target)

    def visit_For(self, node):
        self._own(node)
        self._bind_target(node.target)
        self.generic_visit(node)

    def visit_AsyncFor(self, node):
        self.visit_For(node)

    def visit_With(self, node):
        self._own(node)
        for item in node.items:
            if item.optional_vars is not None:
                self._bind_target(item.optional_vars)
        capture = next((item.context_expr for item in node.items
                        if is_graph_capture(item.context_expr)), None)
        if capture is None:
            self.generic_visit(node)
            return
        for item in node.items:
            self.visit(item)
        # the body of a CUDA-graph capture: a region of its own, an entry
        parent = self.stack[-1]
        region = FuncInfo(
            node=node, path=self.src.path, name=None,
            qualname=(parent.qualname + "." if not parent.is_module else "")
            + f"<cuda.graph@{node.lineno}>",
            parent=parent, class_name=parent.class_name, is_region=True,
            traced=True,
            trace_reason=f"body of torch.cuda.graph at {self.src.path}:"
                         f"{node.lineno}")
        self._register(region)
        self.stack.append(region)
        for stmt in node.body:
            self.visit(stmt)
        self.stack.pop()

    def visit_AsyncWith(self, node):
        self.visit_With(node)

    def visit_ExceptHandler(self, node):
        self._own(node)
        if node.name:
            self._bind_local(node.name)
        self.generic_visit(node)

    def visit_NamedExpr(self, node):
        self._own(node)
        self._bind_target(node.target)
        self.visit(node.value)

    def visit_comprehension(self, node):
        self._bind_target(node.target)
        self.generic_visit(node)

    # -- uses --

    def visit_Attribute(self, node):
        self._own(node)
        if isinstance(node.ctx, ast.Load):
            self.stack[-1].attr_loads.add(node.attr)
        self.generic_visit(node)

    def visit_Return(self, node):
        self._own(node)
        if node.value is not None:
            self._note_passed(node.value)
        self.generic_visit(node)

    def _note_passed(self, expr):
        """A local function referenced as a value (argument / return) from
        captured code will almost certainly be invoked during the capture.
        Module-level functions passed by name are excluded: those are
        usually host callbacks."""
        names = []
        if isinstance(expr, ast.Name):
            names = [expr.id]
        elif isinstance(expr, (ast.Tuple, ast.List)):
            names = [e.id for e in expr.elts if isinstance(e, ast.Name)]
        here = self.stack[-1]
        for n in names:
            scope = here
            while scope is not None and not scope.is_module:
                if n in scope.local_funcs:
                    here.passed_local_funcs.extend(scope.local_funcs[n])
                    break
                if n in scope.local_names or n in scope.imported_names:
                    break
                scope = scope.parent

    def visit_Call(self, node):
        self._own(node)
        here = self.stack[-1]
        t = terminal_name(node.func)
        if t is not None:
            if isinstance(node.func, ast.Name):
                kind = "name"
            elif (isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "self"):
                kind = "self"
            else:
                kind = "attr"
            here.calls.append((kind, t, node))
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            self._note_passed(arg)
        self.generic_visit(node)

    def generic_visit(self, node):
        self._own(node)
        super().generic_visit(node)


# -- entry marking + propagation ---------------------------------------------


def _entry_positions(call: ast.Call, src: SourceFile) -> tuple[int, ...] | None:
    """Positional indices of the callables a call hands to a torch
    capture or trace, or None when it is no such call."""
    func = call.func
    if isinstance(func, ast.Attribute):
        recv = terminal_name(func.value)
        return _ENTRY_CALLS.get((recv, func.attr),
                                _ENTRY_CALLS.get((None, func.attr)))
    if isinstance(func, ast.Name) and func.id in src.torch_imports:
        return _IMPORTED_ENTRIES.get(src.torch_imports[func.id])
    return None


def _func_candidates(expr: ast.AST, scope: FuncInfo,
                     project: Project) -> list[FuncInfo]:
    """Resolve an expression in entry-argument position to the functions
    it may denote."""
    if isinstance(expr, ast.Lambda):
        owner = project.owner_of(expr.body)
        return [owner] if owner is not None else []
    if isinstance(expr, ast.Call):  # partial(f, ...) and friends
        if terminal_name(expr.func) == "partial" and expr.args:
            return _func_candidates(expr.args[0], scope, project)
        return []
    if isinstance(expr, ast.Name):
        s = scope
        while s is not None:
            if expr.id in s.local_funcs:
                return list(s.local_funcs[expr.id])
            if expr.id in s.local_names:
                return []  # shadowed by a plain local — unresolvable
            if expr.id in s.imported_names:
                return list(project.index.get(expr.id, []))
            s = s.parent
        return list(project.index.get(expr.id, []))
    if isinstance(expr, ast.Attribute):
        return list(project.index.get(expr.attr, []))
    if isinstance(expr, (ast.Tuple, ast.List)):  # make_graphed_callables tuples
        out = []
        for e in expr.elts:
            out.extend(_func_candidates(e, scope, project))
        return out
    return []


def _mark(info: FuncInfo, reason: str, chain: tuple[str, ...],
          work: list[FuncInfo]):
    if (info.traced or info.is_resolve_once or info.is_eager_pinned
            or info.is_module):
        return
    info.traced = True
    info.trace_reason = reason
    info.trace_chain = chain
    work.append(info)


def _class_of(f: FuncInfo) -> str | None:
    """The class a (possibly nested) function's ``self`` belongs to."""
    return f.class_name


def _stored_args(project: Project) -> dict[tuple[str, str], dict[str, int]]:
    """(path, class) -> {attribute: constructor parameter position} for
    attributes a class's ``__init__`` assigns straight from one of its
    parameters (``self.step = step``)."""
    out: dict[tuple[str, str], dict[str, int]] = {}
    for key, methods in project.class_methods.items():
        for init in methods.get("__init__", []):
            pos = [p for p in init.params if p not in ("self", "cls")]
            for node in iter_owned(init.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in pos):
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.setdefault(key, {})[t.attr] = pos.index(
                            node.value.id)
    return out


def _instantiations(project: Project, cls: str) -> list[tuple[ast.Call, FuncInfo]]:
    """Every call ``cls(...)`` in the analyzed set, with its caller."""
    out = []
    for f in project.funcs:
        for kind, name, node in f.calls:
            if kind == "name" and name == cls:
                out.append((node, f))
    return out


def _module_forwards(project: Project) -> list[FuncInfo]:
    """``forward`` methods of classes whose bases include ``Module``."""
    out = []
    for (_path, cls), methods in project.class_methods.items():
        if "Module" in project.class_bases.get(cls, set()):
            out.extend(methods.get("forward", []))
    return out


def _project_roots(files: list[SourceFile]) -> set[str]:
    """Top-level module names of the analyzed set: the first component of
    every file's path (``quiver_tpu_torch``, ``chip_smoke``)."""
    roots = set()
    for src in files:
        first = src.path.replace("\\", "/").lstrip("/").split("/")[0]
        roots.add(first[:-3] if first.endswith(".py") else first)
    return roots


def _receiver_root(expr: ast.AST) -> str | None:
    """The name a dotted receiver starts from: ``torch.cuda`` -> ``torch``."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def analyze(files: list[SourceFile]) -> Project:
    project = Project(files=files)
    roots = _project_roots(files)
    for src in files:
        _Collector(src, project, roots).visit(src.tree)

    # pass 2: entry call sites anywhere in any file
    work: list[FuncInfo] = []
    for src in files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            positions = _entry_positions(node, src)
            if positions is None:
                continue
            t = terminal_name(node.func)
            scope = project.owner_of(node) or src.module_info
            for pos in positions:
                if pos < len(node.args):
                    for c in _func_candidates(node.args[pos], scope, project):
                        _mark(c, f"passed to {t} at {src.path}:{node.lineno}",
                              (), work)

    # decorator entries and capture regions found during collection seed
    # the worklist too
    for f in project.funcs:
        if f.traced:
            work.append(f)

    stored = _stored_args(project)
    forwards = _module_forwards(project)
    by_path = {src.path: src for src in files}

    def project_file(f: FuncInfo) -> SourceFile:
        return by_path[f.path]

    # pass 3: propagate over the call graph
    seen_edges: set[tuple[int, int]] = set()
    while work:
        f = work.pop()
        chain = f.trace_chain + (f.qualname,)
        short_chain = chain[-4:]
        via = f"called from {f.qualname} ({f.path}:{f.line})"
        for kind, name, node in f.calls:
            if capture_guarded(project.parents_of(f), node):
                continue  # runs only while the stream is not capturing
            targets: list[FuncInfo] = []
            if kind == "name":
                s = f
                resolved = None
                while s is not None:
                    if name in s.local_funcs:
                        resolved = list(s.local_funcs[name])
                        break
                    if name in s.local_names and not s.is_module:
                        # a plain local or parameter: it may hold a module
                        resolved = list(forwards)
                        break
                    if name in s.external_names:
                        resolved = []  # torch, numpy, the standard library
                        break
                    if name in s.imported_names:
                        resolved = list(project.index.get(name, []))
                        break
                    s = s.parent
                targets = (resolved if resolved is not None
                           else list(project.index.get(name, [])))
                # instantiation of a known class runs its __init__
                targets += project.class_index.get(name, [])
            elif kind == "self" and _class_of(f) is not None:
                key = (f.path, _class_of(f))
                own = project.class_methods.get(key, {}).get(name)
                if own:
                    targets = list(own)
                elif name in stored.get(key, {}):
                    # a callable the constructor stored: whatever every
                    # instantiation passes there
                    pos = stored[key][name]
                    for call, caller in _instantiations(project, key[1]):
                        arg = None
                        if pos < len(call.args):
                            arg = call.args[pos]
                        else:
                            arg = next((kw.value for kw in call.keywords
                                        if kw.arg == name), None)
                        if arg is not None:
                            targets += _func_candidates(arg, caller, project)
                    targets += forwards
                elif name in _BUILTIN_METHOD_NAMES:
                    targets = []
                else:
                    # inherited, or an instance attribute holding an object
                    targets = list(project.index.get(name, [])) + forwards
            else:  # attribute call: conservative terminal-name linking,
                # except names that are overwhelmingly builtin methods and
                # calls into modules from outside the analyzed set
                ext = project_file(f).external_names
                if (name in _BUILTIN_METHOD_NAMES
                        or _receiver_root(node.func.value) in ext):
                    targets = []
                else:
                    targets = list(project.index.get(name, []))
            for g in targets:
                edge = (id(f), id(g))
                if edge in seen_edges:
                    continue
                seen_edges.add(edge)
                _mark(g, via, short_chain, work)
        for g in f.passed_local_funcs:
            edge = (id(f), id(g))
            if edge not in seen_edges:
                seen_edges.add(edge)
                _mark(g, f"closure passed from {f.qualname}", short_chain,
                      work)
        for attr in f.attr_loads - STATIC_ATTRS:  # a tensor's .shape is no property
            for g in project.property_index.get(attr, []):
                edge = (id(f), id(g))
                if edge not in seen_edges:
                    seen_edges.add(edge)
                    _mark(g, f"property read from {f.qualname}", short_chain,
                          work)
    return project
