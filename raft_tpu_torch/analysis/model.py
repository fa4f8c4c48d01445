"""The shared project model every checker runs against (counterpart of
``raft_tpu.analysis.model``).

One pass parses the package with :mod:`ast` and builds:

* a **module index** (dotted name → parsed tree + source + per-line
  suppressions + import alias map),
* a **function index** (dotted qualname → def node, class, module) over
  top-level functions and methods,
* a **call graph** with conservative name resolution — ``self.meth()``
  within a class, bare names to same-module or imported functions,
  ``mod.fn()`` through project-module imports.  Unresolvable dynamic
  calls simply contribute no edge (checkers stay sound w.r.t. what they
  claim, not complete),
* a **lock inventory**: ``self._x = threading.Lock/RLock/Condition/
  Semaphore`` attributes per class and module-level lock assignments.

Checkers consume this read-only and emit findings through
:meth:`Project.finding`, which applies per-line suppression comments
(``# raft-tpu: ignore[RULE]`` — several rules comma-separated; the
comment anywhere on the flagged node's physical lines suppresses it).

Everything here is stdlib-only and never imports the modules it
analyzes: no device, no kernel build, so the tests and the CLI stay
CPU-cheap (the unavoidable cost is ``raft_tpu_torch/__init__`` running on
package import).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.findings import Finding

_SUPPRESS_RE = re.compile(r"#\s*raft-tpu:\s*ignore\[([A-Z0-9_,\s]+)\]")

#: threading constructors whose instances count as locks
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FunctionInfo:
    """One top-level function or method (nested defs stay inside)."""

    qualname: str                    # "pkg.mod.Class.meth" / "pkg.mod.fn"
    module: "ModuleInfo"
    node: ast.AST                    # FunctionDef | AsyncFunctionDef
    class_name: Optional[str] = None
    calls: Set[str] = field(default_factory=set)  # resolved callee qualnames

    @property
    def name(self) -> str:
        return self.node.name


@dataclass
class ClassInfo:
    qualname: str
    module: "ModuleInfo"
    node: ast.ClassDef
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr → ctor
    #: ``self._cond = Condition(self._lock)`` makes _cond an alias of
    #: _lock — acquiring either takes the same underlying lock
    lock_aliases: Dict[str, str] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str                        # dotted, package-rooted: "pkg.sub.mod"
    path: str                        # relative to the scan root's parent
    tree: ast.Module
    source: str
    suppressions: Dict[int, Set[str]]          # line → rules ignored there
    imports: Dict[str, str] = field(default_factory=dict)  # alias → dotted
    module_locks: Dict[str, str] = field(default_factory=dict)  # name → ctor

    def lines(self, node: ast.AST) -> Iterable[int]:
        start = getattr(node, "lineno", None)
        if start is None:
            return ()
        return range(start, (getattr(node, "end_lineno", None) or start) + 1)

    def is_suppressed(self, rule: str, node: ast.AST) -> bool:
        for line in self.lines(node):
            if rule in self.suppressions.get(line, ()):
                return True
        return False


def _scan_suppressions(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[lineno] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _scan_imports(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
                if a.asname is None and "." in a.name:
                    # "import a.b.c" binds "a" but makes a.b.c importable;
                    # remember the full path under its head for resolution
                    aliases.setdefault(a.name, a.name)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


class Project:
    """Parsed view of one package directory (``raft_tpu_torch`` or a
    fixture)."""

    def __init__(self, root: str, readme: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.package = os.path.basename(self.root)
        self.base = os.path.dirname(self.root)
        #: repo-root README to reconcile the env table against (ENVREG);
        #: autodetected next to the package when not given
        if readme is None:
            candidate = os.path.join(self.base, "README.md")
            readme = candidate if os.path.exists(candidate) else None
        self.readme = readme
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._parse_tree()
        self._index_defs()
        self._resolve_calls()

    # -- construction --------------------------------------------------------
    def _parse_tree(self) -> None:
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".")
            )
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, self.base)
                parts = os.path.relpath(path, self.root)[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                name = ".".join([self.package] + [p for p in parts if p])
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=rel)
                self.modules[name] = ModuleInfo(
                    name=name,
                    path=rel,
                    tree=tree,
                    source=source,
                    suppressions=_scan_suppressions(source),
                    imports=_scan_imports(tree),
                )

    def _index_defs(self) -> None:
        for mod in self.modules.values():
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{mod.name}.{node.name}"
                    self.functions[q] = FunctionInfo(q, mod, node)
                elif isinstance(node, ast.ClassDef):
                    cq = f"{mod.name}.{node.name}"
                    cls = ClassInfo(cq, mod, node)
                    self.classes[cq] = cls
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            fq = f"{cq}.{item.name}"
                            self.functions[fq] = FunctionInfo(
                                fq, mod, item, class_name=node.name
                            )
                    self._collect_lock_attrs(cls)
                elif isinstance(node, ast.Assign):
                    self._collect_module_lock(mod, node)

    def _lock_ctor(self, mod: ModuleInfo, call: ast.AST) -> Optional[str]:
        """``"Lock"``/``"RLock"``/... when ``call`` constructs one."""
        if not isinstance(call, ast.Call):
            return None
        name = dotted(call.func)
        if name is None:
            return None
        head, _, tail = name.rpartition(".")
        ctor = tail or name
        if ctor not in _LOCK_CTORS:
            return None
        if head:
            return ctor if mod.imports.get(head, head) == "threading" else None
        return (
            ctor if mod.imports.get(ctor, "") == f"threading.{ctor}" else None
        )

    def _collect_lock_attrs(self, cls: ClassInfo) -> None:
        for node in ast.walk(cls.node):
            if not isinstance(node, ast.Assign):
                continue
            ctor = self._lock_ctor(cls.module, node.value)
            if ctor is None:
                # Condition(self._lock) wrapping an existing lock is the
                # same lock; plain aliases are not re-counted
                continue
            alias_of = None
            if ctor == "Condition":
                if node.value.args:
                    wrapped = node.value.args[0]
                    if (
                        isinstance(wrapped, ast.Attribute)
                        and isinstance(wrapped.value, ast.Name)
                        and wrapped.value.id == "self"
                    ):
                        alias_of = wrapped.attr
                else:
                    ctor = "RLock"  # bare Condition() is backed by an RLock
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    if alias_of is not None:
                        cls.lock_aliases[tgt.attr] = alias_of
                    else:
                        cls.lock_attrs[tgt.attr] = ctor

    def _collect_module_lock(self, mod: ModuleInfo, node: ast.Assign) -> None:
        ctor = self._lock_ctor(mod, node.value)
        if ctor is None:
            return
        if ctor == "Condition" and not node.value.args:
            ctor = "RLock"
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                mod.module_locks[tgt.id] = ctor

    # -- call-graph resolution -----------------------------------------------
    def _project_module(self, dotted_name: str) -> Optional[str]:
        """Map an imported dotted name onto a scanned module, if any."""
        if dotted_name in self.modules:
            return dotted_name
        return None

    def _resolve_calls(self) -> None:
        for fn in self.functions.values():
            mod = fn.module
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self._resolve_callee(fn, mod, node.func)
                if callee is not None:
                    fn.calls.add(callee)

    def _resolve_callee(
        self, fn: FunctionInfo, mod: ModuleInfo, func: ast.AST
    ) -> Optional[str]:
        # self.meth() → method on the same class
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and fn.class_name is not None
        ):
            q = f"{mod.name}.{fn.class_name}.{func.attr}"
            return q if q in self.functions else None
        name = dotted(func)
        if name is None:
            return None
        if "." not in name:
            # bare call: same-module function, else from-import
            q = f"{mod.name}.{name}"
            if q in self.functions:
                return q
            target = mod.imports.get(name)
            if target and target in self.functions:
                return target
            return None
        head, _, tail = name.rpartition(".")
        target_mod = self._project_module(mod.imports.get(head, head))
        if target_mod is not None:
            q = f"{target_mod}.{tail}"
            return q if q in self.functions else None
        return None

    # -- queries -------------------------------------------------------------
    def functions_matching(self, suffix: str) -> List[FunctionInfo]:
        """Functions whose qualname ends with ``suffix`` (dot-anchored)."""
        out = []
        for q, fn in self.functions.items():
            if q == suffix or q.endswith("." + suffix):
                out.append(fn)
        return out

    def classes_matching(self, suffix: str) -> List[ClassInfo]:
        out = []
        for q, cls in self.classes.items():
            if q == suffix or q.endswith("." + suffix):
                out.append(cls)
        return out

    def modules_matching(self, suffix: str) -> List[ModuleInfo]:
        out = []
        for name, mod in self.modules.items():
            if name == suffix or name.endswith("." + suffix):
                out.append(mod)
        return out

    def reachable(self, roots: Sequence[FunctionInfo]) -> List[FunctionInfo]:
        """Transitive closure over resolved call edges, roots included."""
        seen: Dict[str, FunctionInfo] = {}
        stack = list(roots)
        while stack:
            fn = stack.pop()
            if fn.qualname in seen:
                continue
            seen[fn.qualname] = fn
            for callee in fn.calls:
                nxt = self.functions.get(callee)
                if nxt is not None and nxt.qualname not in seen:
                    stack.append(nxt)
        return list(seen.values())

    # -- finding emission ----------------------------------------------------
    def finding(
        self,
        rule: str,
        mod: ModuleInfo,
        node: ast.AST,
        symbol: str,
        message: str,
        suppressed_sink: Optional[List[Finding]] = None,
    ) -> Optional[Finding]:
        """Build a Finding unless a suppression comment covers ``node``."""
        f = Finding(
            rule=rule,
            path=mod.path,
            line=getattr(node, "lineno", 0) or 0,
            symbol=symbol,
            message=message,
        )
        if mod.is_suppressed(rule, node):
            if suppressed_sink is not None:
                suppressed_sink.append(f)
            return None
        return f


# -- shared AST helpers used by several checkers ----------------------------

def resolves_to(mod: ModuleInfo, node: ast.AST, full: str) -> bool:
    """Whether a Name/Attribute chain denotes ``full`` under the module's
    import aliases (``np.asarray`` → ``numpy.asarray``, ``cuda.synchronize``
    → ``torch.cuda.synchronize``, ...)."""
    name = dotted(node)
    if name is None:
        return False
    head, _, rest = name.partition(".")
    resolved = mod.imports.get(head, head)
    return (resolved + ("." + rest if rest else "")) == full


def call_name(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """The import-resolved dotted name of a call target, else None."""
    name = dotted(call.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    resolved = mod.imports.get(head, head)
    return resolved + ("." + rest if rest else "")


def walk_scope(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested def/class bodies."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                    ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(child))
