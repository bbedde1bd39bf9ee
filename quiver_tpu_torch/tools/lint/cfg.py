"""Per-function control-flow graphs + dominators — the graftlint v2 engine.

graftlint v1 could ask *"is a guard called somewhere in this function?"* —
good enough for trace-reachability, useless for the PR 5-8 disciplines
where placement matters: ``check_topo_version()`` inside one ``if`` branch
protects nothing, and a version check *after* the stale read is theater.
The question the new rule families need is *"does a guard DOMINATE this
operation?"* — every path from function entry to the operation passes
through the guard.

This module answers it with the textbook construction, statement-granular:

1. **CFG**: one graph per function; basic blocks hold *entries* — either a
   simple statement (owning its whole subtree) or a compound-statement
   *header* (owning only the test/iter/items expressions; the body lives
   in its own blocks). ``if``/``while``/``for``/``try``/``with``/``match``
   and ``break``/``continue``/``return``/``raise`` get their usual edges;
   every statement inside a ``try`` body additionally edges to each
   handler (an exception can occur at any statement boundary).
2. **Dominators**: the iterative forward dataflow on reverse-postorder —
   function-sized graphs make the classic O(n^2) bound irrelevant.
3. **Guard queries**: ``calls_dominating(node)`` (terminal call names
   guaranteed to have run before ``node``), ``exit_dominating_calls()``
   (calls guaranteed to run on every normal completion — the seed of the
   interprocedural *guard-establisher* fixpoint: a function whose exit is
   dominated by a guard call is itself a guard for its callers).

Known simplifications, all conservative toward *more* findings, never
fewer: a ``finally`` body is modeled on the normal path only (a guard
placed solely in ``finally`` is not credited as dominating later reads),
``while True:`` keeps its loop-exit edge, and a ``raise`` edges to the
handlers *and* the exit.
"""

from __future__ import annotations

import ast
import dataclasses

from .analysis import FuncInfo, Project, terminal_name

__all__ = [
    "Block",
    "CFG",
    "build_cfg",
    "cfg_of",
    "propagate_guard_establishers",
]

# entry kinds: "stmt" owns the whole statement subtree; "header" owns only
# the control expression(s) of a compound statement
_NESTED_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _owned_exprs(entry: tuple[str, ast.AST]) -> list[ast.AST]:
    """The expressions an entry actually evaluates when control reaches
    it (a header evaluates its test/iter/items, not its body)."""
    kind, node = entry
    if kind == "stmt":
        return [node]
    if isinstance(node, ast.If) or isinstance(node, ast.While):
        return [node.test]
    if isinstance(node, (ast.For, ast.AsyncFor)):
        return [node.target, node.iter]
    if isinstance(node, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in node.items]
    if isinstance(node, ast.Match):
        return [node.subject]
    if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
        return []
    return []


def _walk_shallow(root: ast.AST):
    """ast.walk that does not descend into nested function/class bodies
    (their statements do not execute when this entry does)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _NESTED_DEFS):
                continue
            stack.append(child)


@dataclasses.dataclass
class Block:
    id: int
    entries: list[tuple[str, ast.AST]] = dataclasses.field(
        default_factory=list)
    succs: set[int] = dataclasses.field(default_factory=set)
    preds: set[int] = dataclasses.field(default_factory=set)


class CFG:
    """Control-flow graph of one function, with dominators on demand."""

    def __init__(self, func_node: ast.AST):
        self.func_node = func_node
        self.blocks: list[Block] = []
        self.entry = self._new_block().id
        self.exit = self._new_block().id
        # id(ast node) -> (block id, entry index) for every node owned by
        # an entry's evaluated expressions
        self._node_entry: dict[int, tuple[int, int]] = {}
        self._dom: list[set[int]] | None = None
        self._exit_calls: set[str] | None = None
        _Builder(self).build()
        self._index_nodes()

    # -- construction helpers (used by _Builder) -----------------------------

    def _new_block(self) -> Block:
        b = Block(id=len(self.blocks))
        self.blocks.append(b)
        return b

    def _edge(self, a: int, b: int) -> None:
        self.blocks[a].succs.add(b)
        self.blocks[b].preds.add(a)

    def _index_nodes(self) -> None:
        for b in self.blocks:
            for idx, entry in enumerate(b.entries):
                for expr in _owned_exprs(entry):
                    for node in _walk_shallow(expr):
                        self._node_entry.setdefault(id(node), (b.id, idx))

    # -- dominators ----------------------------------------------------------

    def _reachable(self) -> list[int]:
        seen = {self.entry}
        stack = [self.entry]
        while stack:
            b = stack.pop()
            for s in self.blocks[b].succs:
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return sorted(seen)

    def dominators(self) -> list[set[int]]:
        """dom[b] = blocks on EVERY entry->b path (b included);
        unreachable blocks get an empty set."""
        if self._dom is not None:
            return self._dom
        reach = self._reachable()
        n = len(self.blocks)
        all_reach = set(reach)
        dom: list[set[int]] = [set() for _ in range(n)]
        for b in reach:
            dom[b] = {self.entry} if b == self.entry else set(all_reach)
        changed = True
        while changed:
            changed = False
            for b in reach:
                if b == self.entry:
                    continue
                preds = [p for p in self.blocks[b].preds if p in all_reach]
                new = set(all_reach)
                for p in preds:
                    new &= dom[p]
                if not preds:
                    new = set()
                new |= {b}
                if new != dom[b]:
                    dom[b] = new
                    changed = True
        self._dom = dom
        return dom

    # -- queries -------------------------------------------------------------

    def entry_of(self, node: ast.AST) -> tuple[int, int] | None:
        """(block id, entry index) of the entry that evaluates ``node``,
        or None when the node is not part of this CFG's evaluated code
        (e.g. inside a nested def)."""
        return self._node_entry.get(id(node))

    def dominating_entries(self, node: ast.AST):
        """Yield every entry guaranteed to have executed before ``node``
        does: entries of strictly-dominating blocks, plus earlier entries
        of the node's own block."""
        where = self.entry_of(node)
        if where is None:
            return
        bid, idx = where
        dom = self.dominators()
        for d in dom[bid]:
            if d == bid:
                continue
            yield from self.blocks[d].entries
        for entry in self.blocks[bid].entries[:idx]:
            yield entry

    def calls_dominating(self, node: ast.AST) -> set[str]:
        """Terminal names of every call guaranteed to have run before
        ``node`` executes."""
        out: set[str] = set()
        for entry in self.dominating_entries(node):
            for expr in _owned_exprs(entry):
                for n in _walk_shallow(expr):
                    if isinstance(n, ast.Call):
                        t = terminal_name(n.func)
                        if t:
                            out.add(t)
        return out

    def exit_dominating_calls(self) -> set[str]:
        """Terminal names of calls guaranteed to run on EVERY path that
        reaches the function's exit — what the function *establishes* for
        its callers. A function with no reachable exit (every path
        raises) establishes everything it calls on the way out; we return
        the calls of entry-dominated blocks in that case."""
        if self._exit_calls is not None:
            return self._exit_calls
        dom = self.dominators()
        out: set[str] = set()
        target = self.exit
        if not dom[target]:  # exit unreachable: use the entry block chain
            target = self.entry
        for d in dom[target]:
            for entry in self.blocks[d].entries:
                for expr in _owned_exprs(entry):
                    for n in _walk_shallow(expr):
                        if isinstance(n, ast.Call):
                            t = terminal_name(n.func)
                            if t:
                                out.add(t)
        self._exit_calls = out
        return out


class _Builder:
    """One pass over a function body, threading a current block."""

    def __init__(self, cfg: CFG):
        self.cfg = cfg
        # (break target, continue target) stack for loops
        self.loops: list[tuple[int, int]] = []
        # handler-entry block ids for the innermost try statements
        self.handlers: list[list[int]] = []

    def build(self) -> None:
        node = self.cfg.func_node
        if isinstance(node, ast.Lambda):
            b = self.cfg._new_block()
            self.cfg._edge(self.cfg.entry, b.id)
            b.entries.append(("stmt", ast.Expr(value=node.body)))
            # keep the real nodes indexed (the synthetic Expr is unmapped)
            self.cfg._edge(b.id, self.cfg.exit)
            return
        body = getattr(node, "body", [])
        if not isinstance(body, list):
            body = [body]
        first = self.cfg._new_block()
        self.cfg._edge(self.cfg.entry, first.id)
        last = self.stmts(body, first.id)
        if last is not None:
            self.cfg._edge(last, self.cfg.exit)

    # returns the open block id after the statements, or None if flow
    # cannot fall through (return/raise/break/continue on every path)
    def stmts(self, body: list[ast.stmt], cur: int) -> int | None:
        for stmt in body:
            if cur is None:
                # unreachable code still gets blocks (so its nodes index
                # somewhere), but no incoming edges
                cur = self.cfg._new_block().id
            cur = self.stmt(stmt, cur)
        return cur

    def _exc_edges(self, bid: int) -> None:
        """An exception raised in ``bid`` can jump to every enclosing
        handler."""
        for handler_blocks in self.handlers:
            for h in handler_blocks:
                self.cfg._edge(bid, h)

    def stmt(self, node: ast.stmt, cur: int) -> int | None:
        cfg = self.cfg
        if isinstance(node, (ast.Return,)):
            cfg.blocks[cur].entries.append(("stmt", node))
            cfg._edge(cur, cfg.exit)
            return None
        if isinstance(node, ast.Raise):
            cfg.blocks[cur].entries.append(("stmt", node))
            self._exc_edges(cur)
            cfg._edge(cur, cfg.exit)
            return None
        if isinstance(node, ast.Break):
            cfg.blocks[cur].entries.append(("stmt", node))
            if self.loops:
                cfg._edge(cur, self.loops[-1][0])
            return None
        if isinstance(node, ast.Continue):
            cfg.blocks[cur].entries.append(("stmt", node))
            if self.loops:
                cfg._edge(cur, self.loops[-1][1])
            return None
        if isinstance(node, ast.If):
            cfg.blocks[cur].entries.append(("header", node))
            after = cfg._new_block().id
            then = cfg._new_block().id
            cfg._edge(cur, then)
            then_end = self.stmts(node.body, then)
            if then_end is not None:
                cfg._edge(then_end, after)
            if node.orelse:
                els = cfg._new_block().id
                cfg._edge(cur, els)
                els_end = self.stmts(node.orelse, els)
                if els_end is not None:
                    cfg._edge(els_end, after)
            else:
                cfg._edge(cur, after)
            return after if cfg.blocks[after].preds else None
        if isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            header = cfg._new_block().id
            cfg._edge(cur, header)
            cfg.blocks[header].entries.append(("header", node))
            after = cfg._new_block().id
            body = cfg._new_block().id
            cfg._edge(header, body)
            self.loops.append((after, header))
            body_end = self.stmts(node.body, body)
            self.loops.pop()
            if body_end is not None:
                cfg._edge(body_end, header)
            if node.orelse:
                els = cfg._new_block().id
                cfg._edge(header, els)
                els_end = self.stmts(node.orelse, els)
                if els_end is not None:
                    cfg._edge(els_end, after)
            else:
                cfg._edge(header, after)
            return after if cfg.blocks[after].preds else None
        if isinstance(node, (ast.With, ast.AsyncWith)):
            cfg.blocks[cur].entries.append(("header", node))
            body = cfg._new_block().id
            cfg._edge(cur, body)
            return self.stmts(node.body, body)
        if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            return self._try(node, cur)
        if isinstance(node, ast.Match):
            cfg.blocks[cur].entries.append(("header", node))
            after = cfg._new_block().id
            exhaustive = False
            for case in node.cases:
                cb = cfg._new_block().id
                cfg._edge(cur, cb)
                end = self.stmts(case.body, cb)
                if end is not None:
                    cfg._edge(end, after)
                if (isinstance(case.pattern, ast.MatchAs)
                        and case.pattern.pattern is None
                        and case.guard is None):
                    exhaustive = True
            if not exhaustive:
                cfg._edge(cur, after)
            return after if cfg.blocks[after].preds else None
        # simple statement (incl. nested def/class, whose body is opaque)
        cfg.blocks[cur].entries.append(("stmt", node))
        return cur

    def _try(self, node, cur: int) -> int | None:
        cfg = self.cfg
        after = cfg._new_block().id
        # handler entry blocks exist before the body so body statements
        # can edge into them
        handler_entries = [cfg._new_block().id for _ in node.handlers]
        self.handlers.append(handler_entries)
        # each try-body statement sits in its own block with an edge to
        # every handler: the exception can fire at any statement boundary
        body_cur = cfg._new_block().id
        cfg._edge(cur, body_cur)
        for h in handler_entries:
            cfg._edge(body_cur, h)
        for stmt in node.body:
            nxt = self.stmt(stmt, body_cur)
            if nxt is None:
                body_cur = None
                break
            if nxt == body_cur:
                # split so the NEXT statement gets its own handler edges
                fresh = cfg._new_block().id
                cfg._edge(nxt, fresh)
                body_cur = fresh
            else:
                body_cur = nxt
            for h in handler_entries:
                cfg._edge(body_cur, h)
        self.handlers.pop()
        ends: list[int] = []
        if body_cur is not None:
            if node.orelse:
                els = cfg._new_block().id
                cfg._edge(body_cur, els)
                els_end = self.stmts(node.orelse, els)
                if els_end is not None:
                    ends.append(els_end)
            else:
                ends.append(body_cur)
        for h_entry, handler in zip(handler_entries, node.handlers):
            h_end = self.stmts(handler.body, h_entry)
            if h_end is not None:
                ends.append(h_end)
        if node.finalbody:
            fin = cfg._new_block().id
            for e in ends:
                cfg._edge(e, fin)
            if not ends:
                # every path raised/returned: the finally still runs, but
                # we keep it off the normal path (conservative)
                cfg._edge(cur, fin)
            return self.stmts(node.finalbody, fin)
        for e in ends:
            cfg._edge(e, after)
        return after if cfg.blocks[after].preds else None


def build_cfg(func_node: ast.AST) -> CFG:
    return CFG(func_node)


def cfg_of(project: Project, info: FuncInfo) -> CFG:
    """Project-memoized CFG for one function."""
    cache = project.cfg_cache
    cfg = cache.get(id(info.node))
    if cfg is None:
        cfg = CFG(info.node)
        cache[id(info.node)] = cfg
    return cfg


def propagate_guard_establishers(project: Project,
                                 seeds: set[str]) -> set[str]:
    """Interprocedural guard-fact propagation over the call graph: start
    from ``seeds`` (function names that ARE guards — e.g. they raise
    VersionMismatchError) and add every named function whose exit is
    dominated by a call to a known guard; repeat to fixpoint. A call to
    any returned name counts as a guard call for dominance queries
    (terminal-name linking, consistent with the rest of graftlint's
    conservative call-graph resolution)."""
    names = set(seeds)
    if not names:
        return names
    candidates = [
        f for f in project.funcs
        if f.name and not f.is_module
        and isinstance(f.node, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    changed = True
    while changed:
        changed = False
        for f in candidates:
            if f.name in names:
                continue
            if cfg_of(project, f).exit_dominating_calls() & names:
                names.add(f.name)
                changed = True
    return names
