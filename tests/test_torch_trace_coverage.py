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
            continue     # not ported (fit_sharded: ROADMAP Queue 1 item 7)
        assert getattr(ported, "__traced__", None) == label, (mod, qualname)


def test_coverage_is_not_vacuous():
    seen = 0
    for mod in MODULES:
        jmod = importlib.import_module(f"raft_tpu.{mod}")
        tmod = importlib.import_module(f"raft_tpu_torch.{mod}")
        seen += sum(_resolve(tmod, q) is not None for q, _ in _traced(jmod))
    assert seen >= 45, seen
