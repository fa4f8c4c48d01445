"""Primitive benchmarks (counterpart of ``raft_tpu.bench.prims``; the
reference's ``cpp/bench/prims``): a table of timings of the hot primitives
under raft_tpu's case names.

    python -m raft_tpu_torch.bench.prims [--out results.json] [--filter select_k]

Each case runs twice to warm up, then five times between CUDA events on
the card (the host clock on the CPU, ``--device cpu``).  A case builds its
inputs only when the filter selects it.  raft_tpu's ``ivf_scan_ab`` and
``bf_knn_ab`` cases have ``_pallas`` / ``/xla`` twins, made by flipping
its kernel gate around each call; the port routes by device and has no
such gate, so each keeps one case a schedule (the kernels on the card).
Kernel against plain version is ``chip_smoke.py``'s and ``kernel_ab.py``'s
work.  ``fused_l2_nn/...`` runs ``distance.fused_l2_nn_argmin``, the
distance tile (the port does not route it to kernel #7).  Every row names
its device (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _timeit(res, fn: Callable, args, warmup: int = 2, iters: int = 5) -> float:
    for _ in range(warmup):
        fn(*args)
    if res.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(res.device)
    return start.elapsed_time(end) / 1e3 / iters


def _cases(res) -> List[Dict]:
    """The cases; ``args`` is a function that makes the inputs."""
    from raft_tpu_torch.distance.fused_nn import fused_l2_nn_argmin
    from raft_tpu_torch.distance.pairwise import pairwise_distance
    from raft_tpu_torch.neighbors import brute_force as _bf
    from raft_tpu_torch.neighbors import ivf_pq as _pq
    from raft_tpu_torch.ops.matrix import select_k

    dev = res.device

    def normal(seed, *shape):
        return lambda: torch.from_numpy(
            np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)

    cases = []
    # select_k (the reference's bench/prims/matrix/select_k.cu shapes)
    for rows, cols, k in [(1024, 16384, 64), (128, 131072, 256), (4096, 2048, 10)]:
        cases.append({"name": f"select_k/{rows}x{cols}/k{k}",
                      "fn": functools.partial(select_k, k=k, select_min=True),
                      "args": lambda rows=rows, cols=cols: (normal(0, rows, cols)(),),
                      "bytes": rows * cols * 4, "flops": 0})
    # the two select paths either side of the chunked threshold
    ab_shapes = {(1024, c): (10, 64, 256) for c in (4096, 8192, 16384, 32768, 131072)}
    ab_shapes[(64, 1_000_000)] = (100,)
    ab_shapes[(4096, 8192)] = (16,)
    for (rows, cols), ks in ab_shapes.items():
        shared = {}

        def x_of(rows=rows, cols=cols, shared=shared):   # one array per shape
            if "x" not in shared:
                shared["x"] = normal(1, rows, cols)()
            return (shared["x"],)

        for k in ks:
            for algo in ("topk", "chunked"):
                cases.append({"name": f"select_k_ab/{rows}x{cols}/k{k}/{algo}",
                              "fn": functools.partial(select_k, k=k, select_min=True, algo=algo),
                              "args": x_of, "bytes": rows * cols * 4, "flops": 0})
    # pairwise distance (the reference's bench/prims/distance)
    for m, n, d, metric in [(2048, 2048, 128, "sqeuclidean"), (1024, 1024, 512, "l1")]:
        cases.append({"name": f"pairwise/{metric}/{m}x{n}x{d}",
                      "fn": functools.partial(pairwise_distance, metric=metric, res=res),
                      "args": lambda m=m, n=n, d=d: (normal(2, m, d)(), normal(3, n, d)()),
                      "bytes": (m + n) * d * 4 + m * n * 4, "flops": 2 * m * n * d})
    # IVF-PQ's two scan schedules on one index, built on first use
    scan_state: Dict = {}

    def scan_args():
        if "index" not in scan_state:
            rng = np.random.default_rng(4)
            blob_c = rng.standard_normal((512, 96)).astype(np.float32) * 4
            asg = rng.integers(0, 512, 100_000)
            xb = blob_c[asg] + rng.standard_normal((100_000, 96)).astype(np.float32)
            scan_state["index"] = _pq.build(
                _pq.IndexParams(n_lists=1024, pq_dim=48, kmeans_n_iters=5), xb, res=res)
            scan_state["q"] = normal(5, 4096, 96)()
        return (scan_state["q"],)

    # the probed rows at the mean list size, bf16 (the default cache): a
    # rate comparable between schedules, not the bytes either really reads
    scan_bytes = 4096 * 32 * (100_000 // 1024) * 96 * 2
    for strat in ("query_major", "probe_major"):
        sp = _pq.SearchParams(n_probes=32, strategy=strat)
        cases.append({"name": f"ivf_scan_ab/100kx96/p32/{strat}",
                      "fn": lambda q, sp=sp: _pq.search(sp, scan_state["index"], q, 10, res=res),
                      "args": scan_args, "bytes": scan_bytes, "flops": 0})
    # brute-force kNN: the fused kernel (#2) on the card
    cases.append({"name": "bf_knn_ab/200kx96/q4096/k10",
                  "fn": lambda xx, qq: _bf.knn(xx, qq, 10, res=res),
                  "args": lambda: (normal(6, 200_000, 96)(), normal(7, 4096, 96)()),
                  "bytes": 200_000 * 96 * 4, "flops": 2 * 200_000 * 4096 * 96})
    # fused L2 argmin (the reference's bench/prims/distance/fused_l2_nn.cu)
    m, n, d = 8192, 1024, 128
    cases.append({"name": f"fused_l2_nn/{m}x{n}x{d}",
                  "fn": functools.partial(fused_l2_nn_argmin, res=res),
                  "args": lambda: (normal(8, m, d)(), normal(9, n, d)()),
                  "bytes": (m + n) * d * 4, "flops": 2 * m * n * d})
    return cases


def run(filter_: str = "", out_path: str = "", *, res=None) -> List[Dict]:
    """Time every case whose name holds ``filter_``; with ``out_path``, write
    the rows there (and each finished case to ``<out>.partial``, from which
    a cut run resumes)."""
    from raft_tpu_torch.bench.device_time import card
    from raft_tpu_torch.core.resources import ensure

    res = ensure(res)
    device = card(res.device)
    part = out_path + ".partial" if out_path else ""
    results: List[Dict] = []
    done = set()
    if part and os.path.exists(part):
        with open(part) as f:
            results = json.load(f)
        done = {r["name"] for r in results}
        print(f"resuming from {part}: {len(done)} cases done")
    for case in _cases(res):
        if filter_ and filter_ not in case["name"]:
            continue
        if case["name"] in done:
            continue
        s = _timeit(res, case["fn"], case["args"]())
        row = {"name": case["name"], "seconds": s, "gbps": case["bytes"] / s / 1e9,
               "gflops": case["flops"] / s / 1e9 if case["flops"] else None,
               "platform": res.device.type, "device": device}
        results.append(row)
        print(json.dumps(row), flush=True)
        if part:
            with open(part, "w") as f:
                json.dump(results, f)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
        if part and os.path.exists(part):
            os.remove(part)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", default="", help="substring filter on case names")
    ap.add_argument("--out", default="", help="write JSON results here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from raft_tpu_torch.core.resources import Resources

    res = Resources(device=args.device)
    from raft_tpu_torch.bench.runner import warm_kernels

    warm_kernels(res)   # the kernels' build stays out of every timer
    run(args.filter, args.out, res=res)


if __name__ == "__main__":
    main()
