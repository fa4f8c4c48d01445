"""TRACED — the observability-coverage contract, statically (counterpart
of ``raft_tpu.analysis.checkers.traced``).

* every canonical entry point (build/search/fit/... — the
  :data:`ENTRY_NAMES` list) exported through the ``neighbors`` /
  ``cluster`` package ``__all__`` must carry the ``@traced`` decorator,
* the serve online surface (:data:`SERVE_ENTRY_POINTS`) must carry
  ``@traced("<exact label>")`` — a latency excursion with no span, or
  two surfaces sharing a label, makes the obs story unreadable,
* explicit ``@traced("...")`` labels must be unique project-wide,
* the pipelined dispatch path must keep its detached-span and
  request-id plumbing (``open_span``/``finish_span`` across threads,
  ``req_id`` through ``_Request.__slots__``, ``_record_flight`` with
  member ``request_ids`` on both dispatch paths),
* the ragged descriptor plumbing must stay intact: per-request ``k`` /
  ``fid`` ride ``_Request.__slots__`` into ``_invoke``'s descriptor
  columns (``row_k`` / ``row_fid``), flight records carry member
  ``fid``s, and the continuous-admission worker keeps its
  ``sem_held`` slot-before-batch handoff.

Discovery counts land in ``result.stats`` so the tests can
assert the contract is not vacuously green.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.model import ModuleInfo, Project, dotted

#: canonical entry-point names inside exported backend modules — a
#: helper named anything else is free to stay untraced; anything on
#: this list is user-facing API surface and must report spans
ENTRY_NAMES = {
    "build", "build_batch", "search", "extend",
    "knn", "knn_query", "all_knn_query", "eps_nn",
    "fit", "fit_sharded", "predict", "fit_predict", "transform",
    "save", "load", "serialize_to_hnswlib",
}

#: packages (matched by dotted suffix) whose ``__all__`` defines the
#: traced API surface
API_PACKAGES = ("neighbors", "cluster")

#: online (method) entry points and the span label each must carry —
#: additions to the serve API surface belong on this list
SERVE_ENTRY_POINTS = {
    ("serve.service.SearchService", "search"): "serve.search",
    ("serve.service.SearchService", "explain"): "serve.explain",
    ("serve.service.SearchService", "swap"): "serve.swap",
    ("serve.service.SearchService", "warmup"): "serve.warmup",
    ("serve.service.SearchService", "flush"): "serve.flush",
    ("serve.mutation.MutableIndex", "upsert"): "serve.upsert",
    ("serve.mutation.MutableIndex", "delete"): "serve.delete",
    ("serve.ragged.RaggedSearcher", "__call__"): "serve.ragged.dispatch",
    ("serve.compactor.Compactor", "compact"): "serve.compact",
    ("serve.compactor.Compactor", "promote"): "serve.compact.promote",
    ("serve.compactor.Compactor", "abort"): "serve.compact.abort",
    ("serve.compactor.Compactor", "rebuild_sharded"):
        "serve.compact.rebuild_sharded",
    ("obs.slo.SloEngine", "evaluate_once"): "slo.evaluate",
    ("obs.incidents.IncidentManager", "handle_event"): "incidents.ingest",
    ("serve.overload.AdmissionController", "decide"):
        "serve.admission.decide",
    ("serve.overload.DegradedModeManager", "step"): "serve.degrade.step",
    ("serve.overload.HedgedDispatcher", "dispatch"): "serve.hedge.dispatch",
    ("obs.autotune.Autotuner", "step"): "autotune.step",
    ("serve.effort.EffortArbiter", "apply"): "serve.effort.apply",
    ("obs.perf.PerfLedger", "record"): "perf.record",
    ("obs.perf.PerfLedger", "evaluate"): "perf.evaluate",
    ("store.tiered.TieredStore", "ensure_resident"): "store.pager.ensure",
    ("store.tiered.TieredStore", "prefetch"): "store.pager.prefetch",
    ("store.tiered.TieredStore", "evict"): "store.pager.evict",
    ("obs.explain.QueryArchive", "record"): "explain.record",
    ("obs.explain.QueryArchive", "dump"): "explain.dump",
    ("obs.gateway.OperationalGateway", "dispatch"): "gateway.request",
}

#: module-level (function) serve entry points and their span labels —
#: the distributed build surface lives on functions, not classes
SERVE_FUNCTION_ENTRY_POINTS = {
    ("serve.build", "build_sharded"): "serve.build",
    ("serve.build", "knn_graph_sharded"): "serve.build.knn_graph",
}

#: the closed ``kernel_path`` vocabulary: a kernel of ``csrc/`` ("cuda"),
#: the plain PyTorch version ("torch"), or a sharded index's merge of its
#: shards' searches ("sharded") — the batcher, the perf ledger's keys and
#: the bench records read the stamp as an enum
KERNEL_PATH_VOCAB = frozenset({"cuda", "torch", "sharded"})


def check(project: Project, result) -> None:
    entry_points = _api_entry_points(project)
    result.stats["traced_entry_points"] = len(entry_points)
    for qual, (mod, node) in sorted(entry_points.items()):
        if _traced_label(mod, node) is _UNTRACED:
            f = project.finding(
                "TRACED", mod, node, qual,
                "exported entry point lacks @traced — it would ship "
                "unobservable (no span, no latency series)",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)

    _check_serve_labels(project, result)
    _check_label_uniqueness(project, result)
    _check_batcher_plumbing(project, result)
    _check_kernel_dispatch(project, result)


# -- API-surface discovery through package __all__ --------------------------

def _api_entry_points(
    project: Project,
) -> Dict[str, Tuple[ModuleInfo, ast.AST]]:
    out: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
    for suffix in API_PACKAGES:
        for pkg in project.modules_matching(suffix):
            exports = _all_literal(pkg)
            if exports is None:
                continue
            for name in exports:
                target = pkg.imports.get(name)
                if target is None:
                    continue
                if target in project.modules:
                    # module export: its ENTRY_NAMES defs are the surface
                    sub = project.modules[target]
                    for qual, node in _module_entry_defs(project, sub):
                        out[qual] = (sub, node)
                else:
                    # function export: from pkg.mod import fn
                    mod_name, _, fn_name = target.rpartition(".")
                    sub = project.modules.get(mod_name)
                    if sub is None:
                        continue
                    fn = project.functions.get(f"{mod_name}.{fn_name}")
                    if fn is not None and fn.class_name is None:
                        out[f"{mod_name}.{fn_name}"] = (sub, fn.node)
    return out


def _all_literal(mod: ModuleInfo) -> Optional[List[str]]:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__"
            for t in node.targets
        ):
            if isinstance(node.value, (ast.List, ast.Tuple)):
                return [
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                ]
    return None


def _module_entry_defs(project: Project, mod: ModuleInfo):
    """(qualname, def node) for entry-point functions a module exposes —
    its own top-level defs plus project-internal re-exports."""
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in ENTRY_NAMES:
            yield f"{mod.name}.{node.name}", node
    for alias, target in mod.imports.items():
        if alias not in ENTRY_NAMES:
            continue
        mod_name, _, fn_name = target.rpartition(".")
        fn = project.functions.get(target)
        if fn is not None and fn.class_name is None \
                and mod_name in project.modules:
            yield target, fn.node


# -- decorator inspection ---------------------------------------------------

_UNTRACED = object()


def _is_traced_ref(mod: ModuleInfo, node: ast.AST) -> bool:
    name = dotted(node)
    if name is None:
        return False
    head, _, rest = name.partition(".")
    resolved = mod.imports.get(head, head) + ("." + rest if rest else "")
    return resolved.endswith("core.trace.traced") or resolved == "traced"


def _traced_label(mod: ModuleInfo, node: ast.AST):
    """The explicit label, None for default-labelled, _UNTRACED if the
    def carries no @traced at all."""
    for dec in getattr(node, "decorator_list", []):
        if _is_traced_ref(mod, dec):
            return None
        if isinstance(dec, ast.Call) and _is_traced_ref(mod, dec.func):
            if dec.args and isinstance(dec.args[0], ast.Constant):
                return dec.args[0].value
            return None
    return _UNTRACED


def _check_serve_labels(project: Project, result) -> None:
    checked = 0
    for (cls_suffix, meth), label in sorted(SERVE_ENTRY_POINTS.items()):
        for cls in project.classes_matching(cls_suffix):
            checked += 1
            fn = project.functions.get(f"{cls.qualname}.{meth}")
            if fn is None:
                f = project.finding(
                    "TRACED", cls.module, cls.node, f"{cls.qualname}.{meth}",
                    f"serve entry point {meth} is missing from "
                    f"{cls.node.name} (the online span contract lists it)",
                    suppressed_sink=result.suppressed,
                )
            else:
                got = _traced_label(cls.module, fn.node)
                if got == label:
                    continue
                what = (
                    "lacks @traced" if got is _UNTRACED
                    else f"carries span label {got!r}"
                )
                f = project.finding(
                    "TRACED", cls.module,
                    fn.node if fn is not None else cls.node,
                    f"{cls.qualname}.{meth}",
                    f"serve entry point {what}, expected "
                    f"@traced({label!r})",
                    suppressed_sink=result.suppressed,
                )
            if f is not None:
                result.findings.append(f)
    for (mod_suffix, fn_name), label in sorted(
        SERVE_FUNCTION_ENTRY_POINTS.items()
    ):
        for mod in project.modules_matching(mod_suffix):
            checked += 1
            fn = project.functions.get(f"{mod.name}.{fn_name}")
            if fn is None or fn.class_name is not None:
                f = project.finding(
                    "TRACED", mod, mod.tree, f"{mod.name}.{fn_name}",
                    f"serve entry point {fn_name} is missing from "
                    f"{mod.name} (the online span contract lists it)",
                    suppressed_sink=result.suppressed,
                )
            else:
                got = _traced_label(mod, fn.node)
                if got == label:
                    continue
                what = (
                    "lacks @traced" if got is _UNTRACED
                    else f"carries span label {got!r}"
                )
                f = project.finding(
                    "TRACED", mod, fn.node, f"{mod.name}.{fn_name}",
                    f"serve entry point {what}, expected "
                    f"@traced({label!r})",
                    suppressed_sink=result.suppressed,
                )
            if f is not None:
                result.findings.append(f)
    result.stats["traced_serve_entries_checked"] = checked


def _check_label_uniqueness(project: Project, result) -> None:
    seen: Dict[str, str] = {}
    for fn in sorted(project.functions.values(), key=lambda f: f.qualname):
        label = _traced_label(fn.module, fn.node)
        if label is _UNTRACED or label is None:
            continue
        if label in seen:
            f = project.finding(
                "TRACED", fn.module, fn.node, fn.qualname,
                f"span label {label!r} reused (also on {seen[label]}) — "
                "two surfaces would merge into one latency series",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)
        else:
            seen[label] = fn.qualname
    result.stats["traced_labels"] = len(seen)


# -- kernel dispatch attribution --------------------------------------------

def _stamp_literals(node: ast.AST) -> Optional[List[str]]:
    """String literals a ``stamp_kernel_path`` argument can evaluate to
    (handles the ``"a" if cond else "b"`` routing idiom); None when the
    value is not statically enumerable."""
    if isinstance(node, ast.Constant):
        return [node.value] if isinstance(node.value, str) else None
    if isinstance(node, ast.IfExp):
        body = _stamp_literals(node.body)
        orelse = _stamp_literals(node.orelse)
        if body is None or orelse is None:
            return None
        return body + orelse
    return None


def _check_kernel_dispatch(project: Project, result) -> None:
    """Every ``stamp_kernel_path(...)`` call stamps a literal from the
    closed :data:`KERNEL_PATH_VOCAB` (a non-enumerable stamp would mint
    unreadable ledger keys at runtime).  raft_tpu's second half, a
    ``cost_estimate=`` on every ``pallas_call``, has no counterpart: the
    port's kernel wrappers note their work to ``ops.cost`` themselves."""
    n_stamps = 0
    for mod in sorted(project.modules.values(), key=lambda m: m.name):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            tail = name.rsplit(".", 1)[-1]
            if tail.lstrip("_") == "stamp_kernel_path" and node.args:
                n_stamps += 1
                vals = _stamp_literals(node.args[0])
                bad = (
                    "non-literal kernel_path" if vals is None
                    else ", ".join(
                        repr(v) for v in vals if v not in KERNEL_PATH_VOCAB
                    )
                )
                if bad:
                    f = project.finding(
                        "TRACED", mod, node, mod.name,
                        f"stamp_kernel_path({bad}) is outside the closed "
                        f"vocabulary {sorted(KERNEL_PATH_VOCAB)} — ledger "
                        "keys and bench A/B gates read the stamp as an "
                        "enum",
                        suppressed_sink=result.suppressed,
                    )
                    if f is not None:
                        result.findings.append(f)
    result.stats["traced_kernel_path_stamps"] = n_stamps


# -- batcher detached-span / request-id plumbing ----------------------------

def _contains_identifier(node: ast.AST, ident: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == ident:
            return True
        if isinstance(n, ast.Attribute) and n.attr == ident:
            return True
        if isinstance(n, ast.keyword) and n.arg == ident:
            return True
        if isinstance(n, ast.Constant) and n.value == ident:
            return True
    return False


def _check_batcher_plumbing(project: Project, result) -> None:
    classes = project.classes_matching("serve.batcher.MicroBatcher")
    result.stats["traced_batcher_classes"] = len(classes)
    for cls in classes:
        mod = cls.module

        def method(name: str):
            return project.functions.get(f"{cls.qualname}.{name}")

        def require(fn_name: str, ident: str, why: str):
            fn = method(fn_name)
            if fn is None:
                return  # absence of the method is its own refactor signal
            if not _contains_identifier(fn.node, ident):
                f = project.finding(
                    "TRACED", mod, fn.node, fn.qualname,
                    f"{fn_name} no longer references `{ident}` — {why}",
                    suppressed_sink=result.suppressed,
                )
                if f is not None:
                    result.findings.append(f)

        require("_dispatch_pipelined", "open_span",
                "the detached serve.batch span must open at dispatch")
        require("_dispatch_pipelined", "finish_span",
                "the dispatch failure path must close the span it opened")
        require("_complete", "finish_span",
                "the completion thread must close the detached span")
        require("submit", "next_request_id",
                "every request gets a process-wide id at submit")
        require("submit", "request_id",
                "the id must be exposed on the returned future")
        for path in ("_dispatch_locked", "_complete"):
            require(path, "_record_flight",
                    "both dispatch paths must feed the flight recorder")
            require(path, "request_ids",
                    "batch records must carry member request ids")
        require("_record_flight", "req_id",
                "member request ids must cross into batch records")

        # ragged descriptor plumbing: per-request k/fid must ride the
        # dispatch as data columns and land in flight records
        require("_invoke_args", "row_k",
                "ragged dispatches must pass the per-request k column")
        require("_invoke_args", "row_fid",
                "ragged dispatches must pass the per-request filter-id "
                "column")
        require("_record_flight", "fid",
                "ragged batch records must carry member filter ids")
        require("_worker", "sem_held",
                "continuous admission claims the in-flight slot before "
                "cutting the batch")

        # overload plumbing: every batch cut must pass through the
        # admission gate (shed/expire decisions are made at cut time,
        # not at submit), and priority/deadline must enter at submit
        require("submit", "priority",
                "requests must carry their priority class from submit")
        require("submit", "deadline",
                "requests must carry their absolute deadline from submit")
        for path in ("_worker", "flush"):
            require(path, "_admit",
                    "every batch cut must pass the admission gate "
                    "(deadline expiry + priority shedding)")

        # _Request.__slots__ must carry req_id so ids cross the queue,
        # and the ragged descriptor fields k / fid alongside it
        for req_cls in project.classes_matching(
            f"{mod.name.rsplit('.', 1)[-1]}._Request"
        ):
            if req_cls.module is not mod:
                continue
            slots = _class_slots(req_cls.node)
            if slots is None:
                continue
            for slot, why in (
                ("req_id", "request ids cannot cross the queue"),
                ("k", "per-request k cannot cross the queue"),
                ("fid", "per-request filter ids cannot cross the queue"),
                ("priority", "priority classes cannot cross the queue — "
                 "admission would shed blind"),
                ("deadline", "deadlines cannot cross the queue — expired "
                 "work would dispatch anyway"),
            ):
                if slot in slots:
                    continue
                f = project.finding(
                    "TRACED", mod, req_cls.node, req_cls.qualname,
                    f"_Request dropped its {slot} slot; {why}",
                    suppressed_sink=result.suppressed,
                )
                if f is not None:
                    result.findings.append(f)


def _class_slots(node: ast.ClassDef) -> Optional[Set[str]]:
    for item in node.body:
        if isinstance(item, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__slots__"
            for t in item.targets
        ):
            if isinstance(item.value, (ast.Tuple, ast.List)):
                return {
                    e.value for e in item.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                }
    return None
