"""The BASELINE ladder, configs 1-4, with QPS at recall, GB/s and the share
of the card's peak (counterpart of ``raft_tpu.bench.ladder``):

  1. pairwise L2, 1k x 128: agreement with numpy and bandwidth;
  2. brute-force kNN, 10k x 128 (SIFT-10k shape): recall 1.0, GB/s, GFLOP/s;
  3. IVF-Flat, 1M x 128 (SIFT-1M shape): QPS at recall >= 0.95;
  4. IVF-PQ + CAGRA, 100k x 96 (DEEP shape): QPS at recall >= 0.95.

Usage (on the card; ``--device cpu`` runs on the CPU)::

    python -m raft_tpu_torch.bench.ladder [--scale 1.0] [--configs 1,2,3,4] [--out F]

Every record names the device it ran on (the card's name and power limit
from ``nvidia-smi``) and the ``kernel_path`` of its searches.  Times stop
after ``torch.cuda.synchronize()``; ``device_seconds`` is the card's busy
time for one call (``device_time.measure_device_time``), None on the CPU.
The peak shares use the H100 SXM's data-sheet rates (``ops.cost``).  The
results go to ``bench_results/ladder_<platform>.json`` by default.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from raft_tpu_torch.ops import cost

#: the card's peaks for the shares of peak (H100 SXM data sheet, ops.cost);
#: no share is computed on the CPU
_PEAKS = {
    "cuda": {"flops_bf16": cost.H100_PEAK_OPS["bfloat16"], "flops_f32": cost.H100_F32_FLOPS,
             "hbm_gbs": cost.H100_BYTES_PER_S / 1e9},
}


def _sync(res) -> None:
    if res.device.type == "cuda":
        torch.cuda.synchronize(res.device)


def _timeit(res, fn, *args, warmup=2, iters=5):
    for _ in range(warmup):
        fn(*args)
    _sync(res)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(res)
    return (time.perf_counter() - t0) / iters


def _dev(fn, *args):
    """The card's busy seconds for one call (None on the CPU)."""
    from raft_tpu_torch.bench.device_time import measure_device_time

    return measure_device_time(fn, *args)


def _blobs(n, d, n_clusters, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    asg = rng.integers(0, n_clusters, n)
    return centers, centers[asg] + rng.standard_normal((n, d)).astype(np.float32) * 0.35


def _recall(ids, gt):
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    ids = ids.cpu() if isinstance(ids, torch.Tensor) else torch.from_numpy(np.asarray(ids))
    gt = gt.cpu() if isinstance(gt, torch.Tensor) else torch.from_numpy(np.asarray(gt))
    return neighborhood_recall(ids, gt)


def config1_pairwise(res, platform):
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 128)).astype(np.float32)
    y = rng.standard_normal((1000, 128)).astype(np.float32)
    xd, yd = torch.from_numpy(x).to(res.device), torch.from_numpy(y).to(res.device)
    got = pairwise_distance(xd, yd, metric="sqeuclidean", res=res).cpu().numpy()
    want = ((x[:, None] - y[None]) ** 2).sum(-1)
    max_rel = float(np.max(np.abs(got - want) / np.maximum(want, 1e-6)))
    s = _timeit(res, lambda a, b: pairwise_distance(a, b, metric="sqeuclidean", res=res), xd, yd)
    bytes_moved = (2 * 1000 * 128 + 1000 * 1000) * 4
    return {"config": "1_pairwise_l2_1kx128", "max_rel_err_vs_numpy": max_rel, "seconds": s,
            "gbs": bytes_moved / s / 1e9, "pass": max_rel < 1e-4}


def config2_bruteforce(res, platform, scale):
    from raft_tpu_torch.neighbors import brute_force

    n, d, n_q, k = int(10_000 * scale), 128, int(1_000 * scale), 10
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((n_q, d)).astype(np.float32)
    xd, qd = torch.from_numpy(x).to(res.device), torch.from_numpy(q).to(res.device)
    _, ids = brute_force.knn(xd, qd, k, res=res)
    if n * n_q <= 2e7:   # exact numpy ground truth
        gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :k]
        recall = _recall(ids, gt)
    else:
        recall = None
    s = _timeit(res, lambda a, b: brute_force.knn(a, b, k, res=res), xd, qd)
    dev_s = _dev(lambda a, b: brute_force.knn(a, b, k, res=res), xd, qd)
    flops = 2.0 * n * n_q * d
    peaks = _PEAKS.get(platform)
    return {"config": "2_bruteforce_sift10k", "n": n, "recall": recall, "qps": n_q / s,
            "device_seconds": dev_s, "device_qps": n_q / dev_s if dev_s else None,
            "gflops": flops / s / 1e9,
            "mfu_f32": (flops / s) / peaks["flops_f32"] if peaks else None,
            "pass": recall is None or recall >= 0.999}


def config3_ivf_flat(res, platform, scale):
    from raft_tpu_torch.neighbors import brute_force, ivf_flat

    n, d, n_q, k = int(1_000_000 * scale), 128, int(10_000 * scale), 10
    n = max(n, 20_000)
    n_q = max(n_q, 200)
    n_clusters = max(64, n // 250)   # ~250 rows a cluster at any scale
    c, x = _blobs(n, d, n_clusters, 2)
    rng_q = np.random.default_rng(3)
    q = (c[rng_q.integers(0, n_clusters, n_q)]
         + rng_q.standard_normal((n_q, d)).astype(np.float32) * 0.35)
    xd, qd = torch.from_numpy(x).to(res.device), torch.from_numpy(q).to(res.device)
    _sync(res)
    t0 = time.perf_counter()
    index = ivf_flat.build(
        ivf_flat.IndexParams(n_lists=max(64, int(np.sqrt(n) * 2)), kmeans_n_iters=10), xd,
        res=res)
    _sync(res)
    build_s = time.perf_counter() - t0
    _, gt = brute_force.knn(xd, qd, k, res=res)
    best = None
    for p in (8, 16, 32, 64, 128):
        if p > index.n_lists:
            break
        sp = ivf_flat.SearchParams(n_probes=p)
        _, ids = ivf_flat.search(sp, index, qd, k, res=res)
        r = _recall(ids, gt)
        s = _timeit(res, lambda qq: ivf_flat.search(sp, index, qq, k, res=res), qd)
        best = {"n_probes": p, "recall": r, "qps": n_q / s}
        if r >= 0.95:
            break
    dev_s = _dev(lambda qq: ivf_flat.search(sp, index, qq, k, res=res), qd)
    best["device_seconds"] = dev_s
    best["device_qps"] = n_q / dev_s if dev_s else None
    # bytes: the probed lists' rows streamed per query batch
    scanned = n_q * best["n_probes"] * index.list_cap * d * 4
    peaks = _PEAKS.get(platform)
    return {"config": "3_ivf_flat_sift1m", "n": n, "build_s": build_s, **best,
            "scan_gbs": scanned * best["qps"] / n_q / 1e9,
            "hbm_frac": ((scanned * best["qps"] / n_q) / (peaks["hbm_gbs"] * 1e9)
                         if peaks else None),
            "pass": best["recall"] >= 0.9}


def config4_ivf_pq_cagra(res, platform, scale):
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    n, d, n_q, k = int(100_000 * scale), 96, int(10_000 * scale), 10
    n = max(n, 20_000)
    n_q = max(n_q, 200)
    n_clusters = max(64, n // 100)
    c, x = _blobs(n, d, n_clusters, 4)
    rng_q = np.random.default_rng(5)
    q = (c[rng_q.integers(0, n_clusters, n_q)]
         + rng_q.standard_normal((n_q, d)).astype(np.float32) * 0.35)
    xd, qd = torch.from_numpy(x).to(res.device), torch.from_numpy(q).to(res.device)
    _, gt = brute_force.knn(xd, qd, k, res=res)

    _sync(res)
    t0 = time.perf_counter()
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=1024, pq_dim=d // 2, kmeans_n_iters=10), xd,
                      res=res)
    _sync(res)
    pq_build_s = time.perf_counter() - t0
    pq_best = None
    for p in (8, 16, 32, 64, 128, 256):
        sp = ivf_pq.SearchParams(n_probes=p, lut_dtype="bfloat16")

        def fn(qq, sp=sp):
            _, ci = ivf_pq.search(sp, pq, qq, k * 4, res=res)
            return refine(xd, qq, ci, k, res=res)

        _, ids = fn(qd)
        r = _recall(ids, gt)
        s = _timeit(res, fn, qd)
        pq_best = {"n_probes": p, "recall": r, "qps": n_q / s}
        if r >= 0.95:
            break
    dev_s = _dev(fn, qd)
    pq_best["device_seconds"] = dev_s
    pq_best["device_qps"] = n_q / dev_s if dev_s else None

    _sync(res)
    t0 = time.perf_counter()
    cg = cagra.build(cagra.IndexParams(graph_degree=64), xd, res=res)
    _sync(res)
    cg_build_s = time.perf_counter() - t0
    cg_best = None
    # entry-seeded width 1: hops up until the recall gate clears, then a
    # wider buffer
    for itopk, mi in ((16, 3), (16, 4), (16, 6), (16, 8), (32, 8), (32, 16), (64, 0)):
        sp = cagra.SearchParams(itopk_size=itopk, search_width=1, max_iterations=mi,
                                num_entry_centers=16)
        _, ids = cagra.search(sp, cg, qd, k, res=res)
        r = _recall(ids, gt)
        s = _timeit(res, lambda qq: cagra.search(sp, cg, qq, k, res=res), qd)
        cg_best = {"itopk": itopk, "max_iterations": mi, "recall": r, "qps": n_q / s}
        if r >= 0.95:
            break
    dev_s = _dev(lambda qq: cagra.search(sp, cg, qq, k, res=res), qd)
    cg_best["device_seconds"] = dev_s
    cg_best["device_qps"] = n_q / dev_s if dev_s else None
    return {"config": "4_ivf_pq_cagra_deep100k", "n": n,
            "ivf_pq": {"build_s": pq_build_s, **pq_best},
            "cagra": {"build_s": cg_build_s, **cg_best},
            "pass": pq_best["recall"] >= 0.9 and cg_best["recall"] >= 0.85}


CONFIGS = {"1": lambda res, platform, scale: config1_pairwise(res, platform),
           "2": config2_bruteforce, "3": config3_ivf_flat, "4": config4_ivf_pq_cagra}


def run(res, configs="1,2,3,4", scale: float = 1.0):
    """The wanted configs' records, each stamped with its device and
    ``kernel_path``; a record of a scaled-down run is marked so (``pass``
    "scaled", the row count in its name)."""
    from raft_tpu_torch.bench.device_time import card
    from raft_tpu_torch.bench.export import kernel_path

    platform = res.device.type
    device = card(res.device)
    records = []
    for key in configs.split(","):
        rec = CONFIGS[key](res, platform, scale)
        if scale < 1.0 and "n" in rec:
            rec["config"] = f"{rec['config']}@n{rec['n']}"
            if rec.get("pass") is True:
                rec["pass"] = "scaled"
        rec["device"] = device
        rec["kernel_path"] = kernel_path(res.device)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink factor for quick runs (e.g. 0.02)")
    ap.add_argument("--out", default="")
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from raft_tpu_torch.core.resources import Resources

    res = Resources(device=args.device, workspace_limit_bytes=1 << 30)
    platform = res.device.type
    out_path = args.out or os.path.join("bench_results", f"ladder_{platform}.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    from raft_tpu_torch.bench.runner import warm_kernels

    warm_kernels(res)   # the kernels' build stays out of every timer
    records = run(res, args.configs, args.scale)
    doc = {"platform": platform, "scale": args.scale,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"), "records": records}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
