#!/usr/bin/env python3
"""Times the redesigned kernels of one tree of the PyTorch port on one CUDA
card, at the shapes PERF.md holds them to, beside the PyTorch library call
that computes the same function where there is one: select_k (#1),
fused_knn (#2), the fused L2 argmin (#7), the probe-major scan (#3), the
query-major scan (#5), the CAGRA search whose walk is #8, and csr_spmm
(no TPU kernel).

    python3 kernel_ab.py [--tree DIR] [--only select_k,fused_knn,fused_argmin,scan,qm,cagra,spmm]
    python3 kernel_ab.py --tree DIR --only host64 --index-dir DIR2

``--tree`` names the directory that holds the ``raft_tpu_torch`` package to
time (default: this script's checkout), so that a change and its parent are
timed by the same code on the same card, in turns (parent, change, change,
parent).  The kernels build from that tree's sources into
its own build directory.  Inputs: the main path's dataset (synthetic
sift-128-euclidean rows, seed 0) for fused_knn, #7 (8,192 and all 1M rows
against 1,024 rows sampled with seed 0, as ``chip_smoke.py``'s k-means
centers) and the scans (probe-major inputs of the IVF-Flat index and of
the IVF-PQ index's bf16 scan cache with f32 products, as ``chip_smoke.py``
builds them: all 10,000 queries at kk = 10, 40 (the refined IVF-PQ
search's k') and 258, the first 1,000 at kk = 1,000), seeded normal rows
for select_k.  ``qm``: the query-major scan on
the main path's serving batch (the first 64 queries, 20 probes, kk = 10)
over the IVF-Flat lists (f32), the IVF-PQ bf16 cache (bf16 and f32
products) and IVF-Flat over the rows x 16 rounded to uint8, and at kk =
1,000 on the same 64 and on the first 1,000 queries (f32); on a tree that
names its blocks an SM (``QM_PER_SM``) also the f32 legs at other splits
of the probes.
``cagra``: the CAGRA index at raft's defaults, searched (itopk 64, k = 10)
for all 10,000 queries and for the first 64: the warm wall (median of 5,
synchronised) and, from one profiled window, the device time by kernel and
the busy share.  ``host64`` (not in the default set): the host cost of the
serving batch, the first 64 queries through ``cagra.search`` (itopk 64) and
``ivf_flat.search`` (20 probes), k = 10: the median over 200 warm calls
of the synchronised wall and of the time until the call returns; on a
tree with ``obs`` also both with its spans disabled.  With ``--index-dir``
the first run saves its two indexes there and every later run loads them,
so that runs of two trees in turns search the same indexes.  ``spmm``:
csr_spmm at PERF.md's three shapes, each beside its byte bound and one
PyTorch call: the SpMV of the kNN graph's normalized Laplacian (the main
rows at k = 15, weights 1 / (1 + d)) and of R-MAT at scale 20, edge factor
16, symmetrized (both beside ``torch.sparse.mm`` on the same CSR), and
``ops.linalg.reduce_rows_by_key`` of the main rows into the IVF-Flat
index's 1,024 lists (keys: each row's nearest center by #7), the kernel on
the sorted keys beside ``index_add_`` and beside the whole entry point.
Prints the card's name and power limit, then one JSON line per shape: the kernel's
and the library call's mean ms over CUDA events (for select_k and the
query-major scan also their device time per call, and for fused_knn each
of its kernels' device time, from the profiler).  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: host64: warm calls timed in each process
HOST_CALLS = 200


def _device_work(e) -> bool:
    """A profiler event of work on the card: a device event that is not one
    of the port's ``raft_tpu.<label>`` trace ranges (annotations spanning a
    call, gaps included; a tree older than those ranges has none)."""
    return e.device_type.name == "CUDA" and not e.name.startswith("raft_tpu.")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--only", default="select_k,fused_knn,fused_argmin,scan,qm,cagra,spmm",
                    help="comma-separated kernels to time (and host64)")
    ap.add_argument("--index-dir", default=None,
                    help="host64: where its indexes are saved by the first run and loaded")
    args = ap.parse_args()
    only = set(args.only.split(","))
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import kernels
    from raft_tpu_torch.bench import datasets
    from raft_tpu_torch.kernels import fused_knn as fk
    from raft_tpu_torch.kernels import select_k as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t = time.perf_counter()
    kernels.library()
    print(f"tree {tree}: kernels built+loaded in {time.perf_counter() - t:.1f} s", flush=True)
    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps=50):
        """Device time per call of ``fn``, all its kernels (``torch.profiler``):
        CUDA events around launches this short time the host."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.events()
                   if _device_work(e)) / 1e3 / reps

    def by_kernel(fn):
        """Device ms of each kernel one call of ``fn`` launches (profiler)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if _device_work(e):
                out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.device_time_total / 1e3
        return out

    def emit(kernel, shape, ms, library, library_ms, **extra):
        print(json.dumps({"tree": str(tree), "kernel": kernel, "shape": shape, "ms": ms,
                          "library": library, "library_ms": library_ms, **extra}), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    for rows, n, k, with_ids, note in () if "select_k" not in only else ((10000, 258, 129, True, "refine (CAGRA build)"),
                                       (10000, 1099, 20, False, "IVF coarse selection"),
                                       (512, 64, 1, False, "CAGRA pick_parents"),
                                       (64, 128, 64, False, "filtered CAGRA buffer"),
                                       (64, 74, 10, False, "filtered CAGRA result"),
                                       (40, 4000, 2048, True, "deep k")):
        s = torch.randn(rows, n, generator=g, device=dev)
        ids = (torch.randint(0, 1 << 20, (rows, n), generator=g, device=dev, dtype=torch.int32)
               if with_ids else None)
        reps = 50 if rows * n < 1 << 20 else 20
        kern = lambda: sk.select_k_kernel(s, k, input_indices=ids)
        lib = lambda: torch.topk(s, k, dim=1, largest=False)
        emit("select_k", f"[{rows}, {n}] k={k}" + (" with ids" if with_ids else ""),
             cuda_ms(kern, reps), "torch.topk", cuda_ms(lib, reps), use=note,
             device_ms=device_ms(kern), library_device_ms=device_ms(lib))

    ds = datasets.synthetic("sift-128-euclidean", seed=0)
    x = torch.from_numpy(ds.base).to(dev)
    q = torch.from_numpy(ds.queries).to(dev)
    xx = (x * x).sum(dim=1)
    del ds
    for n_q, k, reps in () if "fused_knn" not in only else ((256, 10, 5), (256, 129, 5),
                                                            (1000, 2048, 3)):
        qs = q[:n_q]
        emit("fused_knn", f"q [{n_q}, 128] x [{x.shape[0]}, 128] k={k}",
             cuda_ms(lambda: fk.fused_l2_topk(qs, x, xx, k), reps),
             "torch.topk(torch.cdist)",
             cuda_ms(lambda: torch.topk(torch.cdist(qs, x), k, dim=1, largest=False), reps),
             by_kernel=by_kernel(lambda: fk.fused_l2_topk(qs, x, xx, k)))

    if "fused_argmin" in only:
        import numpy as np

        from raft_tpu_torch.kernels import fused_argmin as fa

        rows = np.sort(np.random.default_rng(0).choice(x.shape[0], 1024, replace=False))
        c = x[torch.from_numpy(rows).to(dev)]
        cc = (c * c).sum(dim=1)
        for n, reps in ((8192, 20), (x.shape[0], 5)):
            xs = x[:n]
            emit("fused_argmin", f"[{n}, 128] x [1024, 128]",
                 cuda_ms(lambda: kernels.fused_l2_argmin(xs, c, cc), reps),
                 "torch.addmm(cc, x, c.T, alpha=-2).min(dim=1)",
                 cuda_ms(lambda: torch.addmm(cc, xs, c.T, alpha=-2).min(dim=1), reps),
                 # this tree's center parts, where it cuts the centers
                 parts=(list(fa.center_parts(n, 1024, fa._BLOCKS_PER_SM * kernels.sm_count(0)))
                        if hasattr(fa, "center_parts") else None))

    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.kernels import ivf_scan as scan
    from raft_tpu_torch.neighbors import _common, ivf_flat, ivf_pq

    res = Resources(device="cuda")
    flat_params = ivf_flat.IndexParams(n_lists=1024, kmeans_n_iters=20,
                                       kmeans_trainset_fraction=0.5, seed=0)
    built = {}

    def index(name):
        """The main path's indexes, built once."""
        if name not in built:
            if name == "flat":
                built[name] = ivf_flat.build(flat_params, x, res=res)
            elif name == "pq":
                built[name] = ivf_pq.build(ivf_pq.IndexParams(
                    n_lists=1024, pq_dim=64, pq_bits=8, kmeans_n_iters=20,
                    kmeans_trainset_fraction=0.5, seed=0), x, res=res)
            else:   # IVF-Flat over the rows x 16 rounded to uint8 (chip_smoke's)
                built[name] = ivf_flat.build(
                    flat_params, torch.clamp(torch.round(x * 16.0), 0, 255).to(torch.uint8),
                    res=res)
        return built[name]

    if "scan" in only:
        flat, pq = index("flat"), index("pq")
        for tag, idx, mod, kw in (("float32", flat, ivf_flat, {}),
                                  ("bfloat16", pq, ivf_pq, ivf_pq.scan_kwargs(pq, "float32"))):
            # (queries, kk, the k the buckets are sized for, reps): the main
            # path's buckets at kk 10 and 258, the deep-k phase's at 1,000
            for n_q, kk, k, reps in ((q.shape[0], 10, 10, 10), (q.shape[0], 40, 40, 5),
                                     (q.shape[0], 258, 10, 5), (1000, 1000, 1000, 5)):
                qs = q[:n_q]
                _, bucket, _, _ = _common.select_scan_strategy(
                    "probe_major", n_q, 20, idx.n_lists, idx.list_cap, x.shape[1],
                    res.workspace_limit_bytes, k=k)
                a = mod.probe_major_scan_inputs(idx, qs, 20, kk, bucket)[0]
                emit("ivf_scan_probe_major", f"{tag} rows, B={a[1].shape[0]} G={a[1].shape[1]} "
                     f"kk={kk} ({n_q} q)", cuda_ms(lambda: scan.ivf_scan_probe_major(
                         *a, metric="sqeuclidean", **kw), reps), None, None)

    if "qm" in only:
        q_u8 = torch.clamp(torch.round(q * 16.0), 0, 255)
        legs = (("float32 rows", "flat", ivf_flat, q, {}),
                ("bfloat16 rows, bfloat16 products", "pq", ivf_pq, q,
                 ivf_pq.scan_kwargs(index("pq"), "bfloat16")),
                ("bfloat16 rows, float32 products", "pq", ivf_pq, q,
                 ivf_pq.scan_kwargs(index("pq"), "float32")),
                ("uint8 rows", "u8", ivf_flat, q_u8, {"scan_scale": None}))
        for tag, name, mod, qs_all, kw in legs:
            for n_q, kk, reps in ((64, 10, 50), (64, 1000, 20), (1000, 1000, 5)):
                if kk == 1000 and name != "flat":
                    continue
                a = mod.query_major_scan_inputs(index(name), qs_all[:n_q], 20, kk)
                fn = lambda a=a, kw=kw: scan.ivf_scan_query_major(*a, metric="sqeuclidean", **kw)
                extra = {}
                if name == "flat" and hasattr(scan, "QM_PER_SM"):
                    grid_splits = kernels.grid_splits
                    for per_sm in (2, 4, 8, 16):
                        sp = grid_splits(n_q, 20, dev, per_sm=per_sm)
                        kernels.grid_splits = lambda *_, sp=sp, **__: sp
                        extra[f"per_sm {per_sm} ({sp} splits)"] = device_ms(fn, reps=reps)
                    kernels.grid_splits = grid_splits
                emit("ivf_scan_query_major", f"{tag}, Q={n_q} P=20 kk={kk}",
                     cuda_ms(fn, reps), None, None, device_ms=device_ms(fn, reps=20), **extra)

    if "spmm" in only:
        from raft_tpu_torch import random as trandom
        from raft_tpu_torch.kernels import csr_spmm as csr_k
        from raft_tpu_torch.ops import cost, linalg
        from raft_tpu_torch.sparse import COO
        from raft_tpu_torch.sparse import linalg as slinalg
        from raft_tpu_torch.sparse import neighbors as sneighbors

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        def spmv(name, mat):
            ip, ci, cd = mat.row_view()
            n = ip.shape[0] - 1
            xv = torch.randn((n, 1), generator=gen(1), device=dev)
            lib = torch.sparse_csr_tensor(ip.long(), ci.long(), cd, size=(n, n))
            emit("csr_spmm", f"{name} SpMV: {n} rows, {mat.nnz} slots, max degree "
                 f"{int((ip[1:] - ip[:-1]).max())}",
                 cuda_ms(lambda: csr_k.csr_spmm(ip, ci, cd, xv), 20), "torch.sparse.mm (CSR)",
                 cuda_ms(lambda: torch.sparse.mm(lib, xv), 20),
                 bound_ms=cost.bound_ms(cost.csr_spmm_work(n, mat.nnz, n, 1))[0])

        # the kNN graph's normalized Laplacian and R-MAT at Graph500's scale
        # 20, edge factor 16, as chip_smoke.py's phase 26 makes them
        knn = sneighbors.knn_graph(x, 15, res=res)
        sim = COO(knn.rows, knn.cols, torch.where(knn.valid, 1.0 / (1.0 + knn.data),
                                                  torch.zeros_like(knn.data)), knn.shape, knn.nnz)
        spmv("kNN Laplacian", slinalg.laplacian(sim, normalized=True))
        del knn, sim
        e = trandom.rmat(gen(2), 20, 20, 16 << 20, res=res)
        spmv("R-MAT scale 20", slinalg.symmetrize(
            COO(e[:, 0], e[:, 1], torch.ones(e.shape[0], device=dev), (1 << 20, 1 << 20)),
            op="max"))
        del e
        # k-means' centroid sums: the rows by their nearest IVF-Flat center
        centers = index("flat").centers
        keys = kernels.fused_l2_argmin(x, centers, (centers * centers).sum(dim=1))[1]
        n_keys = centers.shape[0]
        order = torch.argsort(keys.long(), stable=True)
        indptr = torch.zeros(n_keys + 1, dtype=torch.int32, device=dev)
        indptr[1:] = torch.cumsum(torch.bincount(keys.long(), minlength=n_keys), 0).to(torch.int32)
        w = torch.ones(x.shape[0], device=dev)
        o32 = order.to(torch.int32)
        emit("csr_spmm", f"reduce_rows_by_key [{x.shape[0]}, {x.shape[1]}] into {n_keys} keys "
             f"(largest {int((indptr[1:] - indptr[:-1]).max())} rows)",
             cuda_ms(lambda: csr_k.csr_spmm(indptr, o32, w, x), 10),
             "torch.zeros(keys, cols).index_add_(0, keys, rows)",
             cuda_ms(lambda: torch.zeros((n_keys, x.shape[1]), device=dev).index_add_(
                 0, keys.long(), x), 10),
             bound_ms=cost.bound_ms(cost.csr_spmm_work(n_keys, x.shape[0], x.shape[0],
                                                       x.shape[1]))[0],
             entry_ms=cuda_ms(lambda: linalg.reduce_rows_by_key(x, keys, n_keys), 10))

    if "cagra" in only:
        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.neighbors import cagra

        t = time.perf_counter()
        cg = cagra.build(cagra.IndexParams(), x, res=res)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        sp = cagra.SearchParams()
        for n_q in (q.shape[0], 64):
            qs = q[:n_q]
            fn = lambda qs=qs: cagra.search(sp, cg, qs, 10, res=res)
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                window = (time.perf_counter() - t0) * 1e3
            by = {}
            for e in prof.events():
                if _device_work(e):
                    by[e.name[:60]] = by.get(e.name[:60], 0.0) + e.device_time_total / 1e3 / 5
            busy = sum(by.values())
            emit("cagra.search", f"{n_q} q, itopk 64, k=10", sorted(walls)[2], None, None,
                 walls=walls, device_busy_ms=busy, device_busy_share=busy * 5 / window,
                 top_device_ms=sorted(by.items(), key=lambda kv: -kv[1])[:6],
                 build_s=build_s)
    if "host64" in only:
        from raft_tpu_torch.neighbors import cagra

        try:
            from raft_tpu_torch.obs import spans as obs_spans
        except ImportError:     # a tree older than obs
            obs_spans = None
        idx_dir = Path(args.index_dir) if args.index_dir else None

        def cached(name, mod, make):
            path = idx_dir / f"{name}.idx" if idx_dir else None
            if path is not None and path.exists():
                return mod.load(str(path), res=res)
            idx = make()
            if path is not None:
                idx_dir.mkdir(parents=True, exist_ok=True)
                mod.save(str(path), idx)
            return idx

        cg = cached("cagra", cagra, lambda: cagra.build(cagra.IndexParams(), x, res=res))
        fl = cached("ivf_flat", ivf_flat, lambda: index("flat"))
        qs = q[:64]
        cagra_sp, flat_sp = cagra.SearchParams(), ivf_flat.SearchParams(n_probes=20)

        def per_call(fn):
            """Median ms of the synchronised wall and of the time until the
            call returns, over HOST_CALLS warm calls."""
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            walls, hosts = [], []
            for _ in range(HOST_CALLS):
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                hosts.append((t1 - t0) * 1e3)
            return statistics.median(walls), statistics.median(hosts)

        for kernel, shape, fn in (
                ("cagra.search", "64 q, itopk 64, k=10",
                 lambda: cagra.search(cagra_sp, cg, qs, 10, res=res)),
                ("ivf_flat.search", "64 q, n_probes 20, k=10",
                 lambda: ivf_flat.search(flat_sp, fl, qs, 10, res=res))):
            wall, host = per_call(fn)
            extra = {}
            if obs_spans is not None:
                was = obs_spans.enabled()
                obs_spans.set_enabled(False)
                extra["spans_off_ms"], extra["spans_off_host_ms"] = per_call(fn)
                obs_spans.set_enabled(was)
            emit(kernel, shape, wall, None, None, host_ms=host, calls=HOST_CALLS, **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
