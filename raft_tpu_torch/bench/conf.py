"""Runs from the reference's own configs (counterpart of
``raft_tpu.bench.conf``): a per-dataset JSON conf
(python/raft-ann-bench/.../run/conf/*.json) or a per-algorithm YAML tuning
grid (run/conf/algos/*.yaml), translated to the runner's config shape
with the reference's parameter names mapped onto the port's
``IndexParams`` / ``SearchParams`` (nlist -> n_lists, nprobe -> n_probes,
pq_dim / M -> pq_dim, ratio -> 1 / kmeans_trainset_fraction, itopk ->
itopk_size, ...).

``raft_*`` / ``faiss_*`` IVF and CAGRA entries translate; ggnn, hnswlib
and unknown algorithms are skipped and reported, never dropped silently.
Every translated name must be a field of the port's parameter classes
(``ValueError`` otherwise).  Datasets named in a conf are read from disk
when their files exist, else generated with the published geometry.
``yaml`` is imported when a YAML file is read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

#: published geometry of the reference's conf datasets: dims, metric
#: (ref: run/conf/*.json "dataset" sections + datasets.yaml)
_REF_DATASET_GEOMETRY = {
    "deep-100M": (96, "sqeuclidean"),
    "deep-1B": (96, "sqeuclidean"),
    "deep-image-96-inner": (96, "inner_product"),
    "bigann-100M": (128, "sqeuclidean"),
    "sift-128-euclidean": (128, "sqeuclidean"),
    "glove-100-inner": (100, "inner_product"),
    "glove-100-angular": (100, "cosine"),
    "nytimes-256-angular": (256, "cosine"),
    "fashion-mnist-784-euclidean": (784, "sqeuclidean"),
    "mnist-784-euclidean": (784, "sqeuclidean"),
    "wiki_all_1M": (768, "inner_product"),
    "wiki_all_10M": (768, "inner_product"),
    "wiki_all_88M": (768, "inner_product"),
    "lastfm-65-angular": (65, "cosine"),
}

_REF_METRIC = {"euclidean": "sqeuclidean", "inner_product": "inner_product",
               "angular": "cosine", "cosine": "cosine"}


def _ratio_to_fraction(bp: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    if "niter" in bp:
        out["kmeans_n_iters"] = int(bp["niter"])
    if "ratio" in bp:
        # ref raft_benchmark.cu parse_build_param:
        # kmeans_trainset_fraction = 1.0 / ratio
        out["kmeans_trainset_fraction"] = 1.0 / float(bp["ratio"])
    return out


def _map_ivf_flat(bp: Dict[str, Any]) -> Dict[str, Any]:
    return {"n_lists": int(bp["nlist"]), **_ratio_to_fraction(bp)}


def _map_ivf_pq(bp: Dict[str, Any],
                search_params: List[Dict[str, Any]]) -> Dict[str, Any]:
    out = {"n_lists": int(bp["nlist"]), **_ratio_to_fraction(bp)}
    # raft confs say pq_dim; faiss confs say M (same quantity)
    if "pq_dim" in bp:
        out["pq_dim"] = int(bp["pq_dim"])
    elif "M" in bp:
        out["pq_dim"] = int(bp["M"])
    if "pq_bits" in bp:
        out["pq_bits"] = int(bp["pq_bits"])
    # the reference tunes the search-side LUT dtype (smemLutDtype); the
    # port's analogous knob is the build-side decoded-cache dtype —
    # honor a half/fp8 request with the matching cache rung
    luts = {sp.get("smemLutDtype", sp.get("internalDistanceDtype", ""))
            for sp in search_params}
    if "fp8" in luts:
        out["decoded_dtype"] = "int8"
    elif "half" in luts:
        out["decoded_dtype"] = "bfloat16"
    return out


def _map_cagra(bp: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    if "graph_degree" in bp:
        out["graph_degree"] = int(bp["graph_degree"])
    if "intermediate_graph_degree" in bp:
        out["intermediate_graph_degree"] = int(bp["intermediate_graph_degree"])
    return out


def _map_ivf_search(sp: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    if "nprobe" in sp:
        out["n_probes"] = int(sp["nprobe"])
    if "refine_ratio" in sp:
        rr = int(float(sp["refine_ratio"]))
        if rr > 1:
            out["refine_ratio"] = rr
    return out


def _map_cagra_search(sp: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    if "itopk" in sp:
        out["itopk_size"] = int(sp["itopk"])
    if "search_width" in sp:
        out["search_width"] = int(sp["search_width"])
    if "max_iterations" in sp:
        out["max_iterations"] = int(sp["max_iterations"])
    return out


def _param_fields(engine: str):
    """The field names of an engine's (IndexParams, SearchParams)."""
    import dataclasses

    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    mod = {"raft_tpu_ivf_flat": ivf_flat, "raft_tpu_ivf_pq": ivf_pq, "raft_tpu_cagra": cagra}[engine]
    build = {f.name for f in dataclasses.fields(mod.IndexParams)} - {"metric"}
    search = {f.name for f in dataclasses.fields(mod.SearchParams)}
    if engine == "raft_tpu_ivf_pq":
        search |= {"refine_ratio"}    # the runner's exact-refine multiplier
    return build, search


def _check_fields(entry: Dict[str, Any]) -> Dict[str, Any]:
    """Raise when a translated name is not a field of the port's params."""
    build, search = _param_fields(entry["name"])
    for name in entry["build_param"]:
        if name not in build:
            raise ValueError(f"{entry.get('label', entry['name'])}: build param {name!r} "
                             f"is not a field of the port's IndexParams")
    for sp in entry["search_params"]:
        for name in sp:
            if name not in search:
                raise ValueError(f"{entry.get('label', entry['name'])}: search param "
                                 f"{name!r} is not a field of the port's SearchParams")
    return entry


def translate(conf: Dict[str, Any], *, algo_filter: Optional[set] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any], List[str]]:
    """Reference conf → (dataset_info, runner config, skipped notes).

    dataset_info: {"name", "dims", "metric", "subset_size", "k",
    "batch_size", "base_file", "query_file"} — dims/metric resolved from
    the published geometry table (falling back to the conf's "distance").
    """
    ds = conf.get("dataset", {})
    name = ds.get("name", "unknown")
    geom = _REF_DATASET_GEOMETRY.get(name)
    metric = _REF_METRIC.get(ds.get("distance", ""), None)
    if geom:
        dims, geom_metric = geom
        metric = metric or geom_metric
    else:
        dims = int(ds.get("dims", 0))
        if not dims:
            raise ValueError(
                f"dataset {name!r} not in the geometry table and the conf "
                "carries no dims; add it to _REF_DATASET_GEOMETRY")
        metric = metric or "sqeuclidean"
    info = {
        "name": name,
        "dims": dims,
        "metric": metric,
        "subset_size": int(ds.get("subset_size", 0)),
        "k": int(conf.get("search_basic_param", {}).get("k", 10)),
        "batch_size": int(
            conf.get("search_basic_param", {}).get("batch_size", 10_000)),
        "base_file": ds.get("base_file", ""),
        "query_file": ds.get("query_file", ""),
        "groundtruth_file": ds.get("groundtruth_neighbors_file", ""),
    }

    algos, skipped = [], []
    for entry in conf.get("index", []):
        algo = entry.get("algo", "")
        ename = entry.get("name", algo)
        if algo_filter is not None and ename not in algo_filter \
                and algo not in algo_filter:
            continue
        bp = entry.get("build_param", {})
        sps = entry.get("search_params", [{}])
        try:
            if algo.endswith("ivf_flat"):
                algos.append(_check_fields({
                    "name": "raft_tpu_ivf_flat",
                    "label": ename,
                    "build_param": _map_ivf_flat(bp),
                    "search_params": [_map_ivf_search(s) for s in sps],
                }))
            elif algo.endswith("ivf_pq"):
                algos.append(_check_fields({
                    "name": "raft_tpu_ivf_pq",
                    "label": ename,
                    "build_param": _map_ivf_pq(bp, sps),
                    "search_params": [_map_ivf_search(s) for s in sps],
                }))
            elif algo.endswith("cagra"):
                algos.append(_check_fields({
                    "name": "raft_tpu_cagra",
                    "label": ename,
                    "build_param": _map_cagra(bp),
                    "search_params": [_map_cagra_search(s) for s in sps],
                }))
            elif algo == "ggnn":
                skipped.append(f"{ename}: ggnn is CUDA-only; the graph "
                               "family maps to raft_tpu_cagra entries")
            elif algo == "hnswlib":
                skipped.append(f"{ename}: hnswlib is not a dependency; the native "
                               "engine benches exported indexes (bench.runner hnsw_native)")
            else:
                skipped.append(f"{ename}: unknown algo {algo!r}")
        except KeyError as e:  # a param the mapper requires is missing
            skipped.append(f"{ename}: missing build param {e}")
    return info, {"algos": algos}, skipped


def load(path: str, *, algo_filter: Optional[set] = None):
    """Load a reference-shaped conf file and translate it."""
    with open(path) as fh:
        conf = json.load(fh)
    if "index" not in conf:
        raise ValueError(
            f"{os.path.basename(path)} is not a reference-shaped conf "
            "(no top-level 'index' list)")
    return translate(conf, algo_filter=algo_filter)


# ---- per-algo YAML tuning grids (ref: run/conf/algos/*.yaml + the
# cartesian expansion of run/__main__.py; constraints modules prune
# infeasible combos — here the feasibility rules inline) ----

def _product(grid: Dict[str, list]) -> List[Dict[str, Any]]:
    keys = sorted(grid)
    out: List[Dict[str, Any]] = [{}]
    for key in keys:
        vals = grid[key]
        if not isinstance(vals, list):
            vals = [vals]
        out = [{**d, key: v} for d in out for v in vals]
    return out


def _build_feasible(algo: str, bp: Dict[str, Any], dims: int, n: int) -> bool:
    """The role of the reference's constraints module
    (raft_ann_bench.constraints.raft_ivf_pq_build_constraints: pq_dim
    bounds vs dims); plus the hard n_lists <= n rule."""
    if bp.get("nlist", 1) > max(1, n):
        return False
    pq_dim = bp.get("pq_dim", bp.get("M", 0))
    if pq_dim and dims and pq_dim > dims:
        return False
    return True


def load_algo_yaml(path: str, *, group: str = "base",
                   dataset_info: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """One algos/*.yaml tuning grid → runner config: the named group's
    build grid expands to one entry per build combo (cartesian), each
    carrying the group's expanded search grid — the reference's
    run/__main__ semantics.  Infeasible combos prune silently (the
    constraints-module role); the caller's dataset decides dims/n."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh)
    name = doc.get("name", "unknown")
    groups = doc.get("groups", {})
    if group not in groups:
        raise ValueError(
            f"{name} has no group {group!r}; available: {sorted(groups)}")
    g = groups[group]
    dims = int((dataset_info or {}).get("dims", 0))
    n = int((dataset_info or {}).get("subset_size", 0)) or (1 << 62)
    builds = [bp for bp in _product(g.get("build", {}))
              if _build_feasible(name, bp, dims, n)]
    searches = _product(g.get("search", {}))
    entries = []
    for bp in builds:
        label = name + "." + "-".join(
            f"{k}{bp[k]}" for k in sorted(bp))
        entries.append({"name": name, "algo": name,
                        "build_param": bp, "search_params": searches,
                        "file": label})
    # reuse the JSON-conf translator for the name/param mapping
    info = dataset_info or {"name": "unknown", "dims": dims,
                            "subset_size": 0}
    conf = {"dataset": {"name": info.get("name", "unknown"),
                        # carry dims so translate() never depends on the
                        # built-in geometry table for registry datasets
                        "dims": dims,
                        "distance": {"sqeuclidean": "euclidean"}.get(
                            info.get("metric", ""), info.get("metric", "")),
            },
            "search_basic_param": {"k": info.get("k", 10)},
            "index": [{**e, "name": e["file"]} for e in entries]}
    _, cfg, skipped = translate(conf)
    return {"algos": cfg["algos"], "skipped": skipped}


def load_datasets_yaml(path: str) -> Dict[str, Dict[str, Any]]:
    """run/conf/datasets.yaml → {name: dataset_info} (the geometry +
    file-name registry the reference ships)."""
    import yaml

    with open(path) as fh:
        docs = yaml.safe_load(fh)
    out = {}
    for d in docs or []:
        name = d.get("name")
        if not name:
            continue
        out[name] = {
            "name": name,
            "dims": int(d.get("dims", 0) or
                        _REF_DATASET_GEOMETRY.get(name, (0, ""))[0]),
            "metric": _REF_METRIC.get(d.get("distance", ""), "sqeuclidean"),
            "subset_size": int(d.get("subset_size", 0)),
            "base_file": d.get("base_file", ""),
            "query_file": d.get("query_file", ""),
            "groundtruth_file": d.get("groundtruth_neighbors_file", ""),
            "k": 10,
        }
    return out
