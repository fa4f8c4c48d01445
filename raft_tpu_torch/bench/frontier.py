"""Measured QPS–recall frontier sweep → serialized :class:`FrontierModel`
(counterpart of ``raft_tpu.bench.frontier``): the closed-loop autotuner's
measurement leg.

- sweeps every algorithm's effort grid on a synthetic DEEP-geometry
  dataset at a chosen scale (``--n``), with per-algorithm checkpoint /
  resume: a sweep killed midway keeps the finished algorithms;
- pareto-filters each serve backend's points and writes a schema-versioned
  :class:`~raft_tpu_torch.obs.autotune.FrontierModel` (the file
  ``RAFT_TPU_FRONTIER_PATH`` points the serving
  :class:`~raft_tpu_torch.obs.autotune.Autotuner` at; raft_tpu reads it
  too), plus the enveloped bench record for ``bench compare``.

    python -m raft_tpu_torch.bench frontier --n 100000
    python -m raft_tpu_torch.bench frontier --platform cpu --n 2000

Runs on the card unless ``--platform cpu``.  Writes
``bench_results/frontier_<platform>.json`` (the sweep, plus ``.png`` where
matplotlib is installed) and ``--out`` (default
``bench_results/frontier_model_<platform>.json``, the model), under the
working directory.  ``--sharded`` (raft_tpu's shard-parallel build) is
multi-GPU work: ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs.autotune import FrontierModel, FrontierPoint

#: bench-harness algo name → serve backend tag: the FrontierModel key the
#: serving Autotuner resolves through ``EffortSpec.backend``.  Comparators
#: stay in the sweep artifact but never enter the model: the autotuner can
#: only move the serve backends.
SERVE_BACKENDS = {
    "raft_tpu_brute_force": "brute_force",
    "raft_tpu_ivf_flat": "ivf_flat",
    "raft_tpu_ivf_pq": "ivf_pq",
    "raft_tpu_cagra": "cagra",
}

#: where the sweep and the model go by default, under the working directory
OUT_DIR = "bench_results"


def default_grids(n: int, dim: int, metric: str, *, comparators: bool = True
                  ) -> List[Tuple[str, Dict[str, Any], List[Dict[str, Any]]]]:
    """The sweep grid, ``(algo, build_param, effort points)`` per entry
    (raft_tpu's).  The serve entries sweep exactly the knobs the serving
    ``EffortSpec`` moves (n_probes / refine_ratio / itopk_size /
    search_width), so every measured point is one the autotuner can pick."""
    grids: List[Tuple[str, Dict[str, Any], List[Dict[str, Any]]]] = [
        ("raft_tpu_brute_force", {}, [{}]),
        ("raft_tpu_ivf_flat", {"n_lists": max(64, n // 500)},
         [{"n_probes": p} for p in (4, 8, 16, 32, 64)]),
        (
            # pq_dim = d/2: the auto d/4 is too coarse past ~64 dims for
            # recall >= 0.9 at k=10
            "raft_tpu_ivf_pq",
            {"n_lists": max(64, n // 500), "pq_dim": dim // 2},
            [{"n_probes": p} for p in (4, 8, 16, 32, 64)]
            + [{"n_probes": p, "refine_ratio": r} for p in (8, 16, 32) for r in (2, 4)],
        ),
        (
            # degree-64 graph with entry-point-seeded width-1 walks
            "raft_tpu_cagra",
            {"graph_degree": 64, "intermediate_graph_degree": 128},
            [{"itopk_size": t, "search_width": 1, "max_iterations": mi,
              "num_entry_centers": s}
             for t in (16, 32) for mi in (3, 4, 6, 8) for s in (8, 16)]
            + [{"itopk_size": 64, "search_width": 1}, {"itopk_size": 64, "search_width": 4}],
        ),
    ]
    if comparators:
        grids.insert(0, ("numpy_exact", {}, [{}]))
        grids.extend([
            # half the bytes a hop gathers: bf16 walk rows
            ("raft_tpu_cagra_bf16", {"graph_degree": 64, "intermediate_graph_degree": 128},
             [{"itopk_size": t, "search_width": 1, "max_iterations": mi,
               "num_entry_centers": 16} for t in (16, 32) for mi in (4, 6, 8)]),
            # memory-lean CAGRA: VPQ-compressed, decoded on gather
            ("raft_tpu_cagra_vpq", {"graph_degree": 64, "intermediate_graph_degree": 128},
             [{"itopk_size": t, "search_width": 1, "max_iterations": mi,
               "num_entry_centers": 16} for t in (16, 32) for mi in (4, 8)]),
            ("hnswlib_format", {"graph_degree": 32}, [{"ef": e} for e in (32, 64, 128)]),
            # the same exported file searched by the native C++ HNSW engine
            ("hnsw_native", {"graph_degree": 32},
             [{"ef": 64, "n_seeds": 1}, {"ef": 128, "n_seeds": 1},
              {"ef": 128, "n_seeds": 128}, {"ef": 256, "n_seeds": 256}]),
        ])
        if metric != "inner_product":
            # sklearn's spatial trees refuse unnormalized MIP
            grids.insert(1, ("sklearn", {"algorithm": "ball_tree"}, [{}]))
    return grids


def make_dataset(name: str, n: int, *, n_queries: int, k: int, dim: int = 0,
                 metric: str = "", res=None):
    """Synthetic dataset of ``n`` rows with ground truth: a registered name
    scales its geometry (``datasets.synthetic``); another name takes
    DEEP-like geometry (``dim`` / ``metric``, default 96-dim inner
    product).  The ground truth runs on ``res``' device."""
    from raft_tpu_torch.bench import datasets

    if name in datasets.SYNTH_SHAPES:
        full_n = datasets.SYNTH_SHAPES[name][0]
        ds = datasets.synthetic(name, scale=n / full_n, n_queries=n_queries)
    else:
        ds = datasets.synthetic_geometry(name, n, dim or 96, metric or "inner_product",
                                         n_queries=n_queries)
    return datasets.generate_groundtruth(ds, k=k, res=res)


# -- the sweep -----------------------------------------------------------


def sweep(ds, grids, *, k: int, checkpoint_path: str, warmup: int = 1, iters: int = 3,
          res=None, kernels_used: Optional[Dict[str, Dict[str, Any]]] = None) -> List[Any]:
    """Run every grid entry with per-algorithm checkpoint / resume.

    Each finished algorithm is written to ``checkpoint_path``; a restart
    resumes from it and runs only what is missing.  A failed algorithm is
    recorded and the sweep goes on, except a failure whose message says the
    backend is "unavailable": the sweep then keeps it un-done and exits
    (``SystemExit``) so that a resume retries it.  ``kernels_used`` (a dict)
    receives, per algorithm, ``{"kernel_path": the leg its last search took
    ("cuda" on the card's kernels, "torch" on the plain versions),
    "launches": {kernel: launches in its build and searches}}``."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.bench import runner

    n = int(ds.base.shape[0])
    done_algos: set = set()
    results: List[Any] = []
    used: Dict[str, Dict[str, Any]] = {}
    if os.path.exists(checkpoint_path):
        try:
            with open(checkpoint_path) as fh:
                part = json.load(fh)
            # the dataset is part of the signature: a partial of another
            # dataset with the same n / k must not merge into this one
            if (part.get("n"), part.get("k"), part.get("dataset")) == (n, k, ds.name):
                done_algos = set(part["done_algos"])
                results = [runner.RunResult(**d) for d in part["results"]]
                used = dict(part.get("kernels", {}))
                print(f"resuming from {checkpoint_path}: {sorted(done_algos)} done")
        except Exception as e:
            print(f"ignoring unreadable partial ({e})")

    def checkpoint() -> None:
        with open(checkpoint_path, "w") as fh:
            json.dump({"n": n, "k": k, "dataset": ds.name, "done_algos": sorted(done_algos),
                       "results": [r.to_dict() for r in results], "kernels": used}, fh)

    for name, build_param, search_params in grids:
        if name in done_algos:
            continue
        t0 = time.time()
        kernels.consume_kernel_path()   # drop a stale stamp
        before = kernels.launch_counts()
        try:
            rs = runner.run_case(ds, name, build_param, search_params, k=k, warmup=warmup,
                                 iters=iters, res=res)
        except Exception as e:  # record the failure, keep the sweep going
            print(f"{name}: FAILED ({e})")
            if "unavailable" in str(e).lower():
                checkpoint()
                print("backend unavailable — aborting; checkpoint kept")
                raise SystemExit(1)
            done_algos.add(name)
            checkpoint()
            continue
        after = kernels.launch_counts()
        used[name] = {"kernel_path": kernels.consume_kernel_path("unknown"),
                      "launches": {n_: after[n_] - before[n_] for n_ in after
                                   if after[n_] > before[n_]}}
        results.extend(rs)
        done_algos.add(name)
        checkpoint()
        good = [r for r in rs if r.recall >= 0.9] or rs
        best = max(good, key=lambda r: r.qps)
        print(f"{name}: {len(rs)} points in {time.time() - t0:.0f}s; "
              f"best{'@recall≥0.9' if good is not rs else ' (no point ≥0.9)'}: "
              f"{best.qps:.0f} qps @ {best.recall:.3f} [{used[name]['kernel_path']}]")
    if kernels_used is not None:
        kernels_used.update(used)
    return results


# -- the model -----------------------------------------------------------


def frontier_model(results, *, n_queries: int,
                   meta: Optional[Dict[str, Any]] = None) -> FrontierModel:
    """Fold sweep results into a pareto-filtered :class:`FrontierModel`.
    Only serve-backend points enter; ``device_s_per_query`` is the measured
    device time of a batch over its queries (None where none was measured,
    never made up)."""
    model = FrontierModel(meta=dict(meta or {}))
    for r in results:
        backend = SERVE_BACKENDS.get(r.algo)
        if backend is None:
            continue
        model.add(backend, FrontierPoint(
            effort=dict(r.search_param),
            qps=float(r.qps),
            recall=float(r.recall),
            device_s_per_query=(None if not r.device_time_s
                                else float(r.device_time_s) / max(1, n_queries)),
        ))
    model.pareto_filter()
    return model


# -- CLI -----------------------------------------------------------------


def frontier_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("raft_tpu_torch.bench frontier",
                                 description="measured QPS–recall frontier sweep → FrontierModel")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dataset", default="deep-image-96-inner",
                    help="synthetic geometry (see bench.datasets); another name uses "
                    "--dim/--metric DEEP-like geometry")
    ap.add_argument("--dim", type=int, default=0)
    ap.add_argument("--metric", default="")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--platform", default="", help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--algos", default="", help="comma filter, e.g. raft_tpu_ivf_pq")
    ap.add_argument("--no-comparators", action="store_true",
                    help="serve backends only (the autotuner's model leg)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="shard-parallel builds over N cards (not ported: ROADMAP Queue 1 "
                    "item 7)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sweep-out", default="",
                    help=f"sweep artifact (default {OUT_DIR}/frontier_<platform>.json)")
    ap.add_argument("--out", default="",
                    help=f"FrontierModel path (default {OUT_DIR}/frontier_model_<platform>.json); "
                    "point RAFT_TPU_FRONTIER_PATH here")
    args = ap.parse_args(list(argv) if argv is not None else None)

    if args.sharded:
        raise NotImplementedError(
            "bench frontier --sharded (shard-parallel builds over several cards) is not "
            "ported yet (ROADMAP Queue 1 item 7)")

    from raft_tpu_torch.bench import device_time, export, plot
    from raft_tpu_torch.core.resources import Resources

    res = Resources(device=args.platform or "cuda")
    platform = res.device.type
    device = device_time.card(res.device)
    print(f"device: {device.get('nvidia_smi', device['name'])}", flush=True)

    ds = make_dataset(args.dataset, args.n, n_queries=args.queries, k=args.k, dim=args.dim,
                      metric=args.metric, res=res)
    n, dim = int(ds.base.shape[0]), int(ds.base.shape[1])

    sweep_out = args.sweep_out or os.path.join(OUT_DIR, f"frontier_{platform}.json")
    model_out = args.out or os.path.join(OUT_DIR, f"frontier_model_{platform}.json")
    for path in (sweep_out, model_out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    grids = default_grids(n, dim, ds.metric, comparators=not args.no_comparators)
    if args.algos:
        keep = set(args.algos.split(","))
        grids = [g for g in grids if g[0] in keep]
    kernels_used: Dict[str, Dict[str, Any]] = {}
    results = sweep(ds, grids, k=args.k, checkpoint_path=sweep_out + ".partial",
                    warmup=args.warmup, iters=args.iters, res=res, kernels_used=kernels_used)

    # per-algo build cost beside the QPS pareto
    build_seconds: Dict[str, float] = {}
    for r in results:
        build_seconds[r.algo] = max(build_seconds.get(r.algo, 0.0), r.build_time_s)
    for a, bs in sorted(build_seconds.items()):
        print(f"build_s {a}: {bs:.1f}")

    doc = {
        "platform": platform,
        "device": device,
        "n": n,
        "dim": dim,
        "n_queries": int(ds.queries.shape[0]),
        "k": args.k,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "build_seconds": build_seconds,
        "kernels": kernels_used,
        "frontiers": dict(plot.group_frontiers(results)),
        "results": [r.to_dict() for r in results],
    }
    with open(sweep_out, "w") as fh:
        json.dump(doc, fh, indent=2)
    part_path = sweep_out + ".partial"
    if os.path.exists(part_path):
        os.remove(part_path)
    print("wrote", sweep_out)

    meta = {"dataset": ds.name, "n": n, "dim": dim, "n_queries": int(ds.queries.shape[0]),
            "k": args.k, "platform": platform, "metric": ds.metric, "sharded": 0}
    model = frontier_model(results, n_queries=int(ds.queries.shape[0]), meta=meta)
    model.save(model_out)
    print("wrote", model_out, f"({sum(len(p) for p in model.points.values())} pareto points "
          f"across {len(model.points)} backends)")

    # the comparable headline for ``bench compare``: the best serve-backend
    # QPS at recall >= 0.9 (else the overall best, for tiny smoke sweeps);
    # $RAFT_TPU_BENCH_RECORD, else beside the sweep
    serve_pts = [r for r in results if r.algo in SERVE_BACKENDS]
    if serve_pts:
        good = [r for r in serve_pts if r.recall >= 0.9] or serve_pts
        head = max(good, key=lambda r: r.qps)
        path = export.write_bench_record({
            "metric": f"frontier_{ds.name}_k{args.k}",
            "value": round(head.qps, 1),
            "unit": "queries/s",
            "platform": platform,
            "device": device,
            "kernel_path": kernels_used[head.algo]["kernel_path"],
            "recall": round(head.recall, 4),
            "algo": head.algo,
            "search_param": head.search_param,
            "frontier": model.to_dict(),
        }, os.environ.get(export.RECORD_PATH_ENV) or sweep_out.replace(".json", "_record.json"))
        if path:
            print("wrote", path)

    try:
        plot.plot_results(results, sweep_out.replace(".json", ".png"),
                          title=f"recall/QPS frontier ({platform}, n={n})")
        print("wrote", sweep_out.replace(".json", ".png"))
    except Exception as e:
        print("plot skipped:", e)
    return 0


if __name__ == "__main__":
    sys.exit(frontier_main())
