"""CLI: ``python -m raft_tpu_torch.bench --dataset sift-128-euclidean --scale 0.01``
(counterpart of ``python -m raft_tpu.bench``; the reference's
``python -m raft_ann_bench.run``).

Runs every algorithm of a config (the default one, ``--config`` JSON of
the runner's shape, a reference conf ``--conf`` or a reference YAML grid
``--algo-yaml``) on a dataset with ground truth, and writes
``<out>/<dataset>.json`` / ``.csv`` (one row per algorithm and search
param: recall, QPS, latency, build time, device time) and a headline
record ``<dataset>_record.json``.  ``python -m raft_tpu_torch.bench compare
--baseline X --candidate Y`` diffs two records.  The run is on the card;
``--device cpu`` asks for the CPU (raft_tpu's ``RAFT_TPU_PLATFORM=cpu``).
Every printed number stands beside the device it ran on (the card's name
and power limit).  ``python -m raft_tpu_torch.bench frontier`` runs the
QPS–recall frontier sweep (``bench.frontier``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from raft_tpu_torch.bench import datasets, export, runner

DEFAULT_CONFIG = {
    "algos": [
        {"name": "raft_tpu_brute_force", "build_param": {}, "search_params": [{}]},
        {
            "name": "raft_tpu_ivf_flat",
            "build_param": {"n_lists": 256},
            "search_params": [{"n_probes": p} for p in (8, 16, 32, 64)],
        },
        {
            "name": "raft_tpu_ivf_pq",
            "build_param": {"n_lists": 256, "pq_bits": 8},
            "search_params": [
                {"n_probes": p, "refine_ratio": r}
                for p in (8, 32) for r in (1, 2)
            ],
        },
        {
            "name": "raft_tpu_cagra",
            "build_param": {"graph_degree": 32, "intermediate_graph_degree": 64},
            "search_params": [{"itopk_size": t} for t in (32, 64, 128)],
        },
    ]
}


def _conf_dataset(info, args):
    """The dataset of a conf / yaml run: the registry's big-ann files when
    they are under --data-dir (memmapped, --scale cuts rows), else a
    synthetic one of the published geometry."""
    base_path = os.path.join(args.data_dir, info["base_file"]) \
        if info.get("base_file") else ""
    if base_path and os.path.exists(base_path):
        rows = info.get("subset_size") or None
        if rows and args.scale < 1.0:
            rows = max(1000, int(rows * args.scale))
            print(f"scale={args.scale}: using first {rows} rows of "
                  f"{info['base_file']}", file=sys.stderr)
        ds = datasets.Dataset(
            name=info["name"],
            base=datasets.read_bin(base_path, rows=rows, mmap=True),
            queries=datasets.read_bin(
                os.path.join(args.data_dir, info["query_file"])),
            metric=info["metric"],
        )
        # the conf's published ground truth serves a full-scale run only:
        # a row slice changes the true neighbours
        gt = info.get("groundtruth_file", "")
        gt_path = os.path.join(args.data_dir, gt) if gt else ""
        if gt_path and os.path.exists(gt_path) and rows == (
                info.get("subset_size") or rows):
            gt_arr = datasets.read_bin(gt_path, dtype=np.int32)
            if gt_arr.shape[0] == ds.queries.shape[0]:
                ds.gt_neighbors = gt_arr
                print(f"loaded groundtruth from {gt}", file=sys.stderr)
            else:   # a stale file: regenerate
                print(f"groundtruth rows {gt_arr.shape[0]} != queries "
                      f"{ds.queries.shape[0]}; regenerating",
                      file=sys.stderr)
        return ds
    return datasets.synthetic_geometry(
        info["name"], info.get("subset_size") or 1_000_000,
        info["dims"] or 96, info["metric"], scale=args.scale,
    )


def _clamp_n_lists(config, ds):
    """A scaled-down run keeps the conf's grid, with n_lists clamped to
    5 sqrt(n) (a 50K-list entry on a 1 % run has more lists than rows),
    and says so."""
    n_rows = ds.base.shape[0]
    cap = max(16, int(5 * n_rows**0.5))
    for a in config["algos"]:
        nl = a["build_param"].get("n_lists", 0)
        if nl > cap:
            print(f"clamped {a.get('label', a['name'])} n_lists "
                  f"{nl} -> {cap} (n={n_rows})", file=sys.stderr)
            a["build_param"]["n_lists"] = cap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "compare":
        return export.compare_main(argv[1:])
    if argv and argv[0] == "frontier":
        # the QPS–recall frontier sweep → a FrontierModel (the autotuner's
        # measurement leg); imported here, off the default path
        from raft_tpu_torch.bench import frontier as frontier_mod

        return frontier_mod.frontier_main(argv[1:])
    ap = argparse.ArgumentParser("raft_tpu_torch.bench")
    ap.add_argument("--dataset", default="sift-128-euclidean")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="fraction of the standard dataset size to generate")
    ap.add_argument("--config", default="", help="JSON config path ({algos: [...]})")
    ap.add_argument("--conf", default="", help="reference per-dataset conf (run/conf/*.json)")
    ap.add_argument("--algo-yaml", default="", help="reference per-algorithm tuning grid "
                    "(run/conf/algos/*.yaml), expanded like run/__main__; with --group and "
                    "--datasets-yaml / --dataset")
    ap.add_argument("--group", default="base", help="tuning group inside --algo-yaml")
    ap.add_argument("--datasets-yaml", default="",
                    help="reference run/conf/datasets.yaml; --dataset names an entry in it")
    ap.add_argument("--data-dir", default="", help="root of the conf's base_file / query_file")
    ap.add_argument("-k", type=int, default=0)
    ap.add_argument("--out", default="bench_results")
    ap.add_argument("--algorithms", default="", help="comma-separated filter over the algos")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from raft_tpu_torch.bench import device_time
    from raft_tpu_torch.core.resources import Resources

    res = Resources(device=args.device)
    device = device_time.card(res.device)
    print(f"device: {device.get('nvidia_smi', device['name'])}", flush=True)
    k = args.k or 10
    if args.algo_yaml:
        from raft_tpu_torch.bench import conf as conf_mod

        if args.datasets_yaml:
            registry = conf_mod.load_datasets_yaml(args.datasets_yaml)
            if args.dataset not in registry:
                print(f"{args.dataset!r} not in {args.datasets_yaml}; have {sorted(registry)}",
                      file=sys.stderr)
                return 1
            info = registry[args.dataset]
        else:
            dims, metric = conf_mod._REF_DATASET_GEOMETRY.get(args.dataset, (0, "sqeuclidean"))
            info = {"name": args.dataset, "dims": dims, "metric": metric, "subset_size": 0,
                    "k": k, "base_file": "", "query_file": ""}
        config = conf_mod.load_algo_yaml(args.algo_yaml, group=args.group, dataset_info=info)
        for note in config.pop("skipped", []):
            print(f"skipped: {note}", file=sys.stderr)
        if args.algorithms:
            # the expanded label, the engine name or the yaml's own name
            keep = set(args.algorithms.split(","))
            config["algos"] = [a for a in config["algos"]
                               if a.get("label") in keep or a["name"] in keep
                               or a.get("label", "").split(".")[0] in keep]
        if not config["algos"]:
            print("grid contained no runnable entries", file=sys.stderr)
            return 1
        ds = _conf_dataset(info, args)
        _clamp_n_lists(config, ds)
    elif args.conf:
        from raft_tpu_torch.bench import conf as conf_mod

        algo_filter = set(args.algorithms.split(",")) if args.algorithms else None
        info, config, skipped = conf_mod.load(args.conf, algo_filter=algo_filter)
        for note in skipped:
            print(f"skipped: {note}", file=sys.stderr)
        if not config["algos"]:
            print("conf contained no runnable algos", file=sys.stderr)
            return 1
        k = args.k or info["k"]
        ds = _conf_dataset(info, args)
        _clamp_n_lists(config, ds)
    else:
        if args.config:
            with open(args.config) as fh:
                config = json.load(fh)
        else:
            config = DEFAULT_CONFIG
        if args.algorithms:
            keep = set(args.algorithms.split(","))
            config = {"algos": [a for a in config["algos"] if a["name"] in keep]}
        ds = datasets.synthetic(args.dataset, scale=args.scale)
    args.k = k
    if ds.gt_neighbors is None or ds.gt_neighbors.shape[1] < args.k:
        datasets.generate_groundtruth(ds, k=max(args.k, 100), res=res)
    results = runner.run_config(ds, config, k=args.k, res=res)

    os.makedirs(args.out, exist_ok=True)
    out_name = ds.name if (args.conf or args.algo_yaml) else args.dataset
    base = os.path.join(args.out, f"{out_name}")
    runner.save_results(results, base + ".json")
    export.to_csv(results, base + ".csv")
    # one headline record: the best QPS among the runs within 0.02 of the
    # sweep's best recall
    best_recall = max(r.recall for r in results)
    head = max((r for r in results if r.recall >= best_recall - 0.02), key=lambda r: r.qps)
    export.write_bench_record({
        "metric": f"bench_{out_name}_k{args.k}", "value": head.qps, "unit": "queries/s",
        "platform": res.device.type, "device": device,
        "kernel_path": export.kernel_path(res.device), "recall": head.recall,
        "latency_ms": head.latency_ms, "algo": head.algo, "search_param": head.search_param,
    }, base + "_record.json")
    for r in results:
        dev_s = "n/a" if r.device_time_s is None else f"{r.device_time_s * 1e3:.3f}ms"
        print(f"{r.algo:24s} recall={r.recall:.4f} qps={r.qps:10.1f} "
              f"latency={r.latency_ms:.3f}ms build={r.build_time_s:.1f}s device={dev_s} "
              f"{r.search_param} [{device['name']}, {device['power_limit']}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
