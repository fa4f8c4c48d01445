"""Trace coverage of the port: every public function of raft_tpu that
carries a ``__traced__`` label (``@traced``) and has a counterpart of the
same name in the same module of the port carries the same label there, so
the span series of both packages are named alike."""

import os
import importlib
import inspect

import pytest
import torch

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

#: raft_tpu modules whose traced entry points the port has
MODULES = (
    "neighbors.brute_force", "neighbors.ivf_flat", "neighbors.ivf_pq", "neighbors.cagra",
    "neighbors.refine", "neighbors.nn_descent", "neighbors.vpq_dataset", "neighbors.hnsw",
    "cluster.kmeans", "cluster.kmeans_balanced", "distance.pairwise", "distance.fused_nn",
    "ops.matrix", "store.tiered",
    "serve.mutation", "serve.ragged", "serve.overload", "serve.effort", "serve.compactor",
    "serve.service", "obs.perf", "obs.explain", "obs.incidents", "obs.slo", "obs.autotune",
    "obs.gateway",
    "sparse.distance", "sparse.neighbors", "sparse.solver", "cluster.spectral",
    "cluster.single_linkage", "cluster.auto_find_k", "distance.kernels",
    "neighbors.ball_cover", "neighbors.extras",
)


def _traced(module):
    """(qualified name, label) of the module's own traced functions and
    methods of its own classes."""
    out = []
    for name, obj in vars(module).items():
        if inspect.isclass(obj) and obj.__module__ == module.__name__:
            out += [(f"{name}.{a}", v.__traced__) for a, v in vars(obj).items()
                    if hasattr(v, "__traced__")]
        elif hasattr(obj, "__traced__") and getattr(obj, "__module__", None) == module.__name__:
            out.append((name, obj.__traced__))
    return out


def _resolve(module, qualname):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


@pytest.mark.parametrize("mod", MODULES)
def test_port_carries_raft_labels(mod):
    jmod = importlib.import_module(f"raft_tpu.{mod}")
    tmod = importlib.import_module(f"raft_tpu_torch.{mod}")
    labels = _traced(jmod)
    assert labels, f"raft_tpu.{mod} has no traced entry point"
    for qualname, label in labels:
        ported = _resolve(tmod, qualname)
        if ported is None or not callable(ported):
            continue     # not ported (ROADMAP Queue 1 item 7b)
        assert getattr(ported, "__traced__", None) == label, (mod, qualname)


def test_coverage_is_not_vacuous():
    seen = 0
    for mod in MODULES:
        jmod = importlib.import_module(f"raft_tpu.{mod}")
        tmod = importlib.import_module(f"raft_tpu_torch.{mod}")
        seen += sum(_resolve(tmod, q) is not None for q, _ in _traced(jmod))
    assert seen >= 87, seen


# ---------------------------------------------------------------------------
# public names: every module of raft_tpu that the port has carries raft_tpu's
# public names, minus the explicit lists below

#: names that exist for the TPU alone, by raft_tpu module
TPU_ONLY = {
    # Pallas routing switches and the Pallas select_k entry
    "kernels": {"use_pallas", "interpret_mode", "select_k_enabled", "cagra_fused_enabled",
                "select_k_pallas"},
    "kernels.select_k": {"LANE", "SUBLANE", "select_k_pallas"},
    # the (8, 128) tile policy of the TPU kernels
    "kernels.toolkit": {"LANE", "SUBLANE", "TilePolicy", "choose_tile_policy", "col_ids_tile",
                        "next_pow2", "pad_dim"},
    # query-major VMEM sizing and the Pallas paged-scan envelope
    "kernels.ivf_scan": {"QM_VMEM_BUDGET", "qm_query_tile", "qm_scratch_bytes",
                         "paged_scan_supported"},
    # readers of jax's device-time planes
    "bench.device_time": {"device_busy_seconds", "plane_busy_ps"},
    # XLA's compiled-program cost analysis and compile events
    "obs": {"analyze_compiled", "xla_events"},
    "obs.cost": {"analyze_compiled"},
    # the RECOMPILE rule reasons about jax.jit tracing; the port has no jit
    "analysis.checkers": {"recompile"},
}

#: multi-device names not ported yet: ROADMAP Queue 1 item 7b
ITEM_7 = {
    "bench.frontier": {"sweep_sharded"},
    "serve": {"ReplicaGroup", "build_sharded", "knn_graph_sharded",
              "make_replicated_search", "replicated_search"},
}

#: raft_tpu modules not ported yet, and names of ported modules that belong
#: to them (empty since ROADMAP Queue 1 item 6b closed)
NOT_YET = set()
ITEM_6B = {}


def _defined_names(module):
    """``__all__``, else the public names the module's own source binds at
    top level (imports excluded)."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    import ast

    tree = ast.parse(inspect.getsource(module))
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.append(node.target.id)
    return [n for n in out if not n.startswith("_")]


def _rel(name):
    return name.split(".", 1)[1] if "." in name else ""


def _unported(rel):
    return any(rel == m or rel.startswith(m + ".") for m in NOT_YET)


def _has(rel):
    """Whether the port has the counterpart of raft_tpu module ``rel``."""
    import importlib.util

    try:
        return importlib.util.find_spec(f"raft_tpu_torch.{rel}") is not None
    except ModuleNotFoundError:   # its parent package is not ported
        return False


def _ported_pairs():
    import pkgutil

    import raft_tpu

    for info in pkgutil.walk_packages(raft_tpu.__path__, "raft_tpu."):
        rel = _rel(info.name)
        if any(p.startswith("_") for p in rel.split(".")) or _unported(rel):
            continue
        if not _has(rel):
            continue
        yield rel, importlib.import_module(info.name), importlib.import_module(
            f"raft_tpu_torch.{rel}")


def _missing(rel, jmod, tmod):
    skip = TPU_ONLY.get(rel, set()) | ITEM_7.get(rel, set()) | ITEM_6B.get(rel, set())
    out = []
    for name in _defined_names(jmod):
        if name in skip:
            continue
        obj = getattr(jmod, name)
        if inspect.ismodule(obj):
            sub = _rel(obj.__name__)
            if not _unported(sub) and not _has(sub):
                out.append(name)
            continue
        if name in vars(tmod):
            continue
        src = getattr(obj, "__module__", None) or ""
        if callable(obj) and src.startswith("raft_tpu.") and src != jmod.__name__:
            # a re-export: checked where it is defined, once that module is ported
            if _unported(_rel(src)) or not _has(_rel(src)):
                continue
            owner = importlib.import_module(f"raft_tpu_torch.{_rel(src)}")
            if name not in vars(owner):
                out.append(f"{name} (from {_rel(src)})")
            continue
        out.append(name)
    return out


def test_ported_modules_carry_raft_public_names():
    gaps = {rel: m for rel, jmod, tmod in _ported_pairs() if (m := _missing(rel, jmod, tmod))}
    assert gaps == {}


def test_public_name_check_is_not_vacuous():
    pairs = {rel: (jmod, tmod) for rel, jmod, tmod in _ported_pairs()}
    for rel in ("ops.matrix", "sparse.linalg", "sparse.solver", "cluster.spectral", "random.rng",
                "label.merge_labels", "solver.linear_assignment", "ops.lanczos", "ops.linalg",
                "distance.kernels", "core.resources", "neighbors.ball_cover", "neighbors.extras",
                "neighbors.helpers", "core.fanout", "core.interruptible", "core.manager",
                "core.native", "bench.get_dataset", "compat", "compat.pylibraft",
                *(f"compat.pylibraft.{m}" for m in ("cluster", "common", "config", "distance",
                                                    "matrix", "neighbors", "random"))):
        assert rel in pairs, rel
    assert len(pairs) >= 118, len(pairs)
    # a name dropped from a ported module is caught
    jmod, tmod = pairs["ops.matrix"]

    class Stripped:
        pass

    stripped = Stripped()
    vars(stripped).update({k: v for k, v in vars(tmod).items() if k != "merge_topk"})
    assert _missing("ops.matrix", jmod, stripped) == ["merge_topk"]
