"""LOCKORDER — static lock-acquisition graph + guarded-attribute writes
(counterpart of ``raft_tpu.analysis.checkers.lockorder``).

Two sub-checks over the lock inventory the project model collected:

**Acquisition-order cycles.**  An edge A→B exists when code acquires B
(lexically nested ``with``, or a call made while holding A whose callee
may acquire B — transitively over resolved call edges).  Any strongly
connected component in that graph is an ordering hazard: two threads
taking the component's locks from different entry points can deadlock.
A self-edge on a non-reentrant ``threading.Lock`` (re-acquiring while
holding, directly or through a call chain) is reported the same way.

**Guarded-attribute discipline.**  Within a class, any attribute
written inside a ``with self.<lock>`` block anywhere is lock-guarded;
every other write to it must hold one of its guarding locks.
``__init__`` (no concurrent readers yet) and ``*_locked`` methods
(named convention: caller holds the lock) are exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.model import (
    ClassInfo,
    FunctionInfo,
    Project,
)

_NONREENTRANT = {"Lock"}


def _class_of(project: Project, fn: FunctionInfo) -> Optional[ClassInfo]:
    if fn.class_name is None:
        return None
    return project.classes.get(f"{fn.module.name}.{fn.class_name}")


def _lock_id(project: Project, fn: FunctionInfo, expr: ast.AST) -> Optional[str]:
    """Canonical lock identity of a ``with`` subject, when recognizable."""
    cls = _class_of(project, fn)
    if (
        cls is not None
        and isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        attr = cls.lock_aliases.get(expr.attr, expr.attr)
        if attr in cls.lock_attrs:
            return f"{cls.qualname}.{attr}"
    if isinstance(expr, ast.Name) and expr.id in fn.module.module_locks:
        return f"{fn.module.name}.{expr.id}"
    return None


def _lock_ctor(project: Project, lock_id: str) -> str:
    owner, _, attr = lock_id.rpartition(".")
    cls = project.classes.get(owner)
    if cls is not None:
        return cls.lock_attrs.get(attr, "?")
    mod = project.modules.get(owner)
    if mod is not None:
        return mod.module_locks.get(attr, "?")
    return "?"


def check(project: Project, result) -> None:
    # pass 1: per-function direct acquisitions, lexical nesting edges and
    # calls made while holding a lock
    direct: Dict[str, Set[str]] = {q: set() for q in project.functions}
    edges: Dict[Tuple[str, str], Tuple[FunctionInfo, ast.AST]] = {}
    calls_holding: List[Tuple[FunctionInfo, str, str, ast.AST]] = []

    for fn in project.functions.values():
        _scan_fn(project, fn, direct, edges, calls_holding)

    # pass 2: transitive may-acquire over resolved call edges
    may: Dict[str, Set[str]] = {q: set(s) for q, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for fn in project.functions.values():
            acc = may[fn.qualname]
            before = len(acc)
            for callee in fn.calls:
                acc |= may.get(callee, set())
            changed = changed or len(acc) != before

    for fn, held, callee, node in calls_holding:
        for target in sorted(may.get(callee, ())):
            edges.setdefault((held, target), (fn, node))

    result.stats["lockorder_locks"] = len(
        {l for pair in edges for l in pair}
        | {l for s in direct.values() for l in s}
    )
    result.stats["lockorder_edges"] = len(edges)

    _report_cycles(project, edges, result)
    for cls in sorted(project.classes.values(), key=lambda c: c.qualname):
        if cls.lock_attrs:
            _check_guarded_attrs(project, cls, result)


def _scan_fn(project, fn, direct, edges, calls_holding) -> None:
    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            # nested defs run at call time, not under this lexical lock
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                lid = _lock_id(project, fn, item.context_expr)
                if lid is None:
                    continue
                direct[fn.qualname].add(lid)
                for h in new_held:
                    edges.setdefault((h, lid), (fn, node))
                new_held = new_held + (lid,)
            for child in node.body:
                visit(child, new_held)
            return
        if isinstance(node, ast.Call) and held:
            callee = project._resolve_callee(fn, fn.module, node.func)
            if callee is not None:
                for h in held:
                    calls_holding.append((fn, h, callee, node))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.node.body:
        visit(stmt, ())


def _report_cycles(project: Project, edges, result) -> None:
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())

    for scc in _sccs(adj):
        cyclic = len(scc) > 1 or (len(scc) == 1 and scc[0] in adj[scc[0]])
        if not cyclic:
            continue
        if len(scc) == 1:
            lock = scc[0]
            if _lock_ctor(project, lock) not in _NONREENTRANT:
                continue  # RLock/Condition re-acquisition is legal
            fn, node = edges[(lock, lock)]
            f = project.finding(
                "LOCKORDER", fn.module, node, fn.qualname,
                f"re-acquires non-reentrant lock {lock} while holding it "
                "(direct or through the call chain) — self-deadlock",
                suppressed_sink=result.suppressed,
            )
        else:
            cycle = sorted(scc)
            site = None
            for a in cycle:
                for b in cycle:
                    if (a, b) in edges:
                        site = edges[(a, b)]
                        break
                if site:
                    break
            fn, node = site
            f = project.finding(
                "LOCKORDER", fn.module, node, fn.qualname,
                "lock-acquisition cycle (threads entering from different "
                f"points can deadlock): {' ⇄ '.join(cycle)}",
                suppressed_sink=result.suppressed,
            )
        if f is not None:
            result.findings.append(f)


def _sccs(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan, iterative (the graph is tiny but recursion limits are
    cheap to avoid)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _check_guarded_attrs(project: Project, cls: ClassInfo, result) -> None:
    # (attr, held-locks, method, node) for every self.<attr> write
    writes: List[Tuple[str, Tuple[str, ...], FunctionInfo, ast.AST]] = []

    methods = [
        fn for fn in project.functions.values()
        if fn.module is cls.module and fn.class_name == cls.node.name
    ]

    for fn in methods:
        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in node.items:
                    lid = _lock_id(project, fn, item.context_expr)
                    if lid is not None:
                        new_held = new_held + (lid,)
                for child in node.body:
                    visit(child, new_held)
                return
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if (
                        isinstance(leaf, ast.Attribute)
                        and isinstance(leaf.ctx, ast.Store)
                        and isinstance(leaf.value, ast.Name)
                        and leaf.value.id == "self"
                    ):
                        writes.append((leaf.attr, held, fn, node))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.node.body:
            visit(stmt, ())

    guards: Dict[str, Set[str]] = {}
    for attr, held, fn, node in writes:
        if held:
            guards.setdefault(attr, set()).update(held)

    for attr, held, fn, node in writes:
        if attr not in guards or held:
            continue
        if fn.name == "__init__" or fn.name.endswith("_locked"):
            continue
        lock_names = ", ".join(sorted(guards[attr]))
        f = project.finding(
            "LOCKORDER", fn.module, node, f"{fn.qualname}",
            f"writes lock-guarded attribute self.{attr} without holding "
            f"its lock (guarded elsewhere by {lock_names})",
            suppressed_sink=result.suppressed,
        )
        if f is not None:
            result.findings.append(f)
