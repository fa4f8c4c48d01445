"""ENVREG — every ``RAFT_TPU_*`` setting goes through the typed registry
(counterpart of ``raft_tpu.analysis.checkers.envreg``).

Three reconciliations, all static:

1. **No stray reads.**  Outside ``core/env.py`` itself, any literal
   ``RAFT_TPU_*`` read through ``os.environ.get`` / ``os.getenv`` /
   ``os.environ[...]`` / ``"X" in os.environ`` must migrate to the
   :mod:`raft_tpu_torch.core.env` accessors (``env.has``/``env.raw``
   cover membership and save-restore).  A read that must run before the
   package can import carries an inline suppression with its reason.
2. **Accessor names are declared.**  Accessor call sites with a
   literal name must reference a ``KNOWN_VARS`` row (parsed from the
   AST of ``core/env.py``, never imported) and with the declared type
   (``env_int`` against a ``float`` row is drift).
3. **README table ↔ registry.**  Every declared var appears in the
   port's env table and vice versa — docs cannot go stale silently.  The
   port's table is the one in the README's "PyTorch / H100 port" section
   (:data:`README_SECTION`, up to the next ``## `` heading); raft_tpu's
   own table, further down the same README, is raft_tpu's registry's and
   is not read here.  A README without that heading is read whole (a
   fixture's).  Skipped when the scan root has no ``core/env.py``/README.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Optional, Tuple

from raft_tpu_torch.analysis.model import ModuleInfo, Project, call_name, dotted

_VAR_RE = re.compile(r"RAFT_TPU_[A-Z0-9_]+")

#: the README heading whose section holds the port's env table
README_SECTION = "## PyTorch / H100 port"

_ACCESSORS = {
    "env_str": "str",
    "env_int": "int",
    "env_float": "float",
    "env_bool": "bool",
    "has": None,      # type-agnostic
    "raw": None,
}


def check(project: Project, result) -> None:
    registry = _load_registry(project)
    result.stats["envreg_known_vars"] = len(registry or {})

    for mod in sorted(project.modules.values(), key=lambda m: m.name):
        if mod.name.endswith("core.env"):
            continue
        _check_direct_reads(project, mod, result)
        if registry is not None:
            _check_accessor_calls(project, mod, registry, result)

    if registry is not None and project.readme:
        _check_readme(project, registry, result)


def _load_registry(project: Project) -> Optional[Dict[str, Tuple[str, int]]]:
    """name → (kind, lineno) parsed from core/env.py's KNOWN_VARS."""
    mods = project.modules_matching("core.env")
    if not mods:
        return None
    mod = mods[0]
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "KNOWN_VARS"
            for t in targets
        ):
            continue
        out: Dict[str, Tuple[str, int]] = {}
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for item in node.value.elts:
                if not (isinstance(item, ast.Call) and item.args):
                    continue
                name = item.args[0]
                kind = item.args[1] if len(item.args) > 1 else None
                if isinstance(name, ast.Constant) and isinstance(
                    name.value, str
                ):
                    k = (
                        kind.value
                        if isinstance(kind, ast.Constant) else "str"
                    )
                    out[name.value] = (k, item.lineno)
        return out
    return None


def _literal_env_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("RAFT_TPU_"):
        return node.value
    return None


def _check_direct_reads(project: Project, mod: ModuleInfo, result) -> None:
    for node in ast.walk(mod.tree):
        var = None
        how = None
        if isinstance(node, ast.Call):
            cn = call_name(mod, node)
            if cn == "os.getenv" and node.args:
                var, how = _literal_env_name(node.args[0]), "os.getenv"
            elif cn in ("os.environ.get", "environ.get") and node.args:
                var, how = _literal_env_name(node.args[0]), "os.environ.get"
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            if dotted(node.value) in ("os.environ", "environ"):
                var, how = _literal_env_name(node.slice), "os.environ[...]"
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)):
            if dotted(node.comparators[0]) in ("os.environ", "environ"):
                var, how = (
                    _literal_env_name(node.left), "membership in os.environ"
                )
        if var is None:
            continue
        f = project.finding(
            "ENVREG", mod, node, var,
            f"direct {how} read of {var}; route it through the typed "
            "raft_tpu_torch.core.env accessors so the registry and README "
            "stay reconciled",
            suppressed_sink=result.suppressed,
        )
        if f is not None:
            result.findings.append(f)


def _check_accessor_calls(project, mod, registry, result) -> None:
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        cn = call_name(mod, node)
        if cn is None:
            continue
        accessor = cn.rsplit(".", 1)[-1]
        if accessor not in _ACCESSORS:
            continue
        if not (
            cn == f"raft_tpu_torch.core.env.{accessor}"
            or cn.endswith(f"core.env.{accessor}")
            or cn == f"env.{accessor}"
        ):
            continue
        var = _literal_env_name(node.args[0])
        if var is None:
            continue
        if var not in registry:
            f = project.finding(
                "ENVREG", mod, node, var,
                f"{accessor}({var!r}) reads a variable not declared in "
                "core/env.py KNOWN_VARS; add a registry row (and README "
                "entry)",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)
            continue
        expected = _ACCESSORS[accessor]
        declared = registry[var][0]
        if expected is not None and expected != declared:
            f = project.finding(
                "ENVREG", mod, node, var,
                f"{accessor}({var!r}) disagrees with the registry, which "
                f"declares {var} as {declared!r}",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)


def _check_readme(project: Project, registry, result) -> None:
    with open(project.readme, encoding="utf-8") as f:
        lines = f.readlines()
    start, end = _section(lines)
    documented: Dict[str, int] = {}
    for lineno, line in enumerate(lines, start=1):
        if not start <= lineno < end or not line.lstrip().startswith("|"):
            continue
        first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
        for var in _VAR_RE.findall(first_cell):
            documented.setdefault(var, lineno)

    env_mod = project.modules_matching("core.env")[0]
    anchor = ast.Module(body=[], type_ignores=[])  # line 0 fallback

    for var, (kind, lineno) in sorted(registry.items()):
        if var not in documented:
            site = ast.copy_location(ast.Pass(), env_mod.tree.body[0])
            site.lineno = lineno
            site.end_lineno = lineno
            f = project.finding(
                "ENVREG", env_mod, site, var,
                f"{var} is declared in KNOWN_VARS but missing from the "
                "README's port environment-variable table",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)

    for var, lineno in sorted(documented.items()):
        if var not in registry:
            site = ast.Pass()
            site.lineno = lineno
            site.end_lineno = lineno
            site.col_offset = 0
            readme_mod = ModuleInfo(
                name="README", path=_rel_readme(project), tree=anchor,
                source="", suppressions={},
            )
            f = project.finding(
                "ENVREG", readme_mod, site, var,
                f"README documents {var} but core/env.py KNOWN_VARS has "
                "no such row — stale docs or an undeclared knob",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)


def _section(lines) -> Tuple[int, int]:
    """[start, end) line numbers (1-based) of the port's README section,
    or the whole file when it has no such heading."""
    start = next((n for n, line in enumerate(lines, start=1)
                  if line.rstrip("\n") == README_SECTION), None)
    if start is None:
        return 1, len(lines) + 1
    end = next((n for n, line in enumerate(lines, start=1)
                if n > start and line.startswith("## ")), len(lines) + 1)
    return start, end


def _rel_readme(project: Project) -> str:
    import os

    return os.path.relpath(project.readme, project.base)
