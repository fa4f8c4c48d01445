#!/usr/bin/env python3
"""On-card smoke of the PyTorch / H100 port (``raft_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of ``raft_tpu_torch/csrc`` with nvcc (sm_90a),
then drives the port's main path at the scale of sift-128-euclidean
(1,000,000 x 128 f32 clustered rows, 10,000 queries, seed 0, synthetic):

1. IVF-Flat build (n_lists=1024, 20 k-means iterations, half the rows as
   trainset: the hierarchical k-means path);
2. the brute-force oracle (fused_knn kernel) for k=10;
3. IVF-Flat search, n_probes=20, k=10: all 10,000 queries at once
   (probe-major scan + select_k), then 20 batches of 64 queries
   (query-major scan + select_k); recall@10 of each against the oracle,
   and of the same searches with every kernel replaced by its plain
   PyTorch version (also at n_probes=2, where recall is below 1);
4. each kernel against its plain version on the inputs the main path gave
   it: select_k bitwise, the others within rtol 1e-5 / atol 1e-4 with ids
   equal on >= 99.9% of slots; times of kernel, plain version and (as a
   yardstick only) one PyTorch library call; the bound of each from the
   work its inputs need (``raft_tpu_torch.ops.cost``);
5. where the time of each search schedule goes: warm wall per search and,
   under ``torch.profiler``, device time by kernel and the device's busy
   share.

Launch counts are set to 0 before each phase of the main path and read
after it.  Prints the card, a JSON line of profiles, a JSON line of
per-kernel results, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no card or any check fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

SEED = 0
K = 10
N_PROBES = 20
LOW_PROBES = 2
QM_BATCH = 64
QM_BATCHES = 20
FUSED_SUBSET = 256
RTOL, ATOL = 1e-5, 1e-4
ID_AGREE = 0.999
PROFILE_REPS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from raft_tpu_torch import datasets, kernels
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.kernels import fused_knn as fk
    from raft_tpu_torch.kernels import ivf_scan as scan
    from raft_tpu_torch.kernels import select_k as sk
    from raft_tpu_torch.neighbors import _common, brute_force, ivf_flat
    from raft_tpu_torch.ops import cost
    from raft_tpu_torch.stats.metrics import recall_at_k

    failures = []

    def check(ok, what):
        print(f"[{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            failures.append(what)

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, reps):
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    # -- 1. the card and the kernels ----------------------------------------
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    lib_path = kernels.build(verbose=True)
    kernels.library()
    print(f"kernels built+loaded in {time.perf_counter() - t:.1f} s: {lib_path.name}", flush=True)

    dev = torch.device("cuda")
    res = Resources(device="cuda")

    # -- 2. data --------------------------------------------------------------
    t = time.perf_counter()
    ds = datasets.synthetic("sift-128-euclidean", seed=SEED)
    x = torch.from_numpy(ds.base).to(dev)
    q = torch.from_numpy(ds.queries).to(dev)
    sync()
    print(f"data {tuple(x.shape)} queries {tuple(q.shape)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    phase_launches = {}

    @contextlib.contextmanager
    def phase(name):
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        phase_launches[name] = kernels.launch_counts()
        print(f"{name}: {time.perf_counter() - t0:.3f} s, launches "
              f"{phase_launches[name]}", flush=True)

    # -- 3. main path -------------------------------------------------------
    params = ivf_flat.IndexParams(n_lists=1024, kmeans_n_iters=20,
                                  kmeans_trainset_fraction=0.5, seed=SEED)
    with phase("build"):
        index = ivf_flat.build(params, x, res=res)
    print(f"index: n_lists={index.n_lists} cap={index.list_cap} size={index.size}", flush=True)

    with phase("oracle"):
        gt_v, gt_i = brute_force.knn(x, q, K, res=res)
    check(kernels.consume_kernel_path() == "cuda", "oracle routed to the cuda kernel")
    check(phase_launches["oracle"]["fused_knn"] > 0, "oracle launched fused_knn")

    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    with phase("search_probe_major"):
        v_pm, i_pm = ivf_flat.search(sp, index, q, K, res=res)
    check(kernels.consume_kernel_path() == "cuda", "probe-major search routed to cuda")
    check(phase_launches["search_probe_major"]["ivf_scan_probe_major"] > 0,
          "probe-major search launched ivf_scan_probe_major")
    check(phase_launches["search_probe_major"]["select_k"] > 0,
          "probe-major search launched select_k")

    qm_ms = []
    qm_out = []
    with phase("search_query_major"):
        for b in range(QM_BATCHES):
            qb = q[b * QM_BATCH:(b + 1) * QM_BATCH]
            t0 = time.perf_counter()
            qm_out.append(ivf_flat.search(sp, index, qb, K, res=res))
            sync()
            qm_ms.append((time.perf_counter() - t0) * 1e3)
    check(kernels.consume_kernel_path() == "cuda", "query-major search routed to cuda")
    check(phase_launches["search_query_major"]["ivf_scan_query_major"] > 0,
          "query-major search launched ivf_scan_query_major")
    check(phase_launches["search_query_major"]["select_k"] > 0,
          "query-major search launched select_k")
    v_qm = torch.cat([o[0] for o in qm_out])
    i_qm = torch.cat([o[1] for o in qm_out])
    n_qm = QM_BATCH * QM_BATCHES
    main_launches = {
        name: sum(p[name] for p in phase_launches.values()) for name in kernels.KERNELS
    }

    # -- outputs: shapes, finiteness, recall --------------------------------
    for name, v, i, rows in (("oracle", gt_v, gt_i, q.shape[0]),
                             ("probe-major", v_pm, i_pm, q.shape[0]),
                             ("query-major", v_qm, i_qm, n_qm)):
        check(tuple(v.shape) == (rows, K) and tuple(i.shape) == (rows, K)
              and bool(torch.isfinite(v).all()) and bool((i >= 0).all()),
              f"{name} output [{rows}, {K}] finite with real ids")
    rec_pm = recall_at_k(i_pm, gt_i, K)
    rec_qm = recall_at_k(i_qm, gt_i[:n_qm], K)
    print(f"recall@{K} probe-major (10000 queries) {rec_pm:.5f}", flush=True)
    print(f"recall@{K} query-major ({QM_BATCHES} x {QM_BATCH}) {rec_qm:.5f}; "
          f"per batch ms median {float(np.median(qm_ms)):.3f} "
          f"min {min(qm_ms):.3f} max {max(qm_ms):.3f}", flush=True)
    check(rec_pm >= 0.8 and rec_qm >= 0.8, "recall@10 of both searches >= 0.8")

    # oracle against an exact float64 numpy reference on a small input
    xs, qs = ds.base[:20000], ds.queries[:64]
    ref_d = ((qs.astype(np.float64)[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    ref_i = np.argsort(ref_d, axis=1, kind="stable")[:, :K]
    sv, si = brute_force.knn(torch.from_numpy(xs).to(dev), torch.from_numpy(qs).to(dev),
                             K, res=res)
    check(recall_at_k(si, ref_i, K) >= 0.99, "brute force matches float64 numpy on 64 x 20000")
    check(np.allclose(sv.cpu().numpy(), np.take_along_axis(ref_d, ref_i, 1),
                      rtol=1e-3, atol=1e-2), "brute-force distances match float64 numpy")

    # the same searches with every kernel replaced by its plain version
    @contextlib.contextmanager
    def plain_versions():
        saved = (sk.select_k_kernel, scan.ivf_scan_probe_major, scan.ivf_scan_query_major)
        sk.select_k_kernel = lambda *a, **kw: sk.select_k_torch(*a, **kw)
        scan.ivf_scan_probe_major = scan.ivf_scan_probe_major_torch
        scan.ivf_scan_query_major = scan.ivf_scan_query_major_torch
        try:
            yield
        finally:
            sk.select_k_kernel, scan.ivf_scan_probe_major, scan.ivf_scan_query_major = saved

    def recalls(n_probes):
        """recall@K of both schedules at ``n_probes``: (probe-major over
        all queries, query-major over the 64-query batches)."""
        sp_n = ivf_flat.SearchParams(n_probes=n_probes)
        _, i_all = ivf_flat.search(sp_n, index, q, K, res=res)
        i_b = torch.cat([
            ivf_flat.search(sp_n, index, q[b * QM_BATCH:(b + 1) * QM_BATCH], K, res=res)[1]
            for b in range(QM_BATCHES)
        ])
        return recall_at_k(i_all, gt_i, K), recall_at_k(i_b, gt_i[:n_qm], K)

    # at 20 probes this data gives recall 1.0 on any path; LOW_PROBES makes
    # the kernel-vs-plain recall comparison able to fail
    kernel_low = recalls(LOW_PROBES)
    kernels.reset_launch_counts()
    with plain_versions():
        plain_main = recalls(N_PROBES)
        plain_low = recalls(LOW_PROBES)
    check(sum(kernels.launch_counts().values()) == 0, "plain path launched no kernel")
    for n_probes, kern, plain in ((N_PROBES, (rec_pm, rec_qm), plain_main),
                                  (LOW_PROBES, kernel_low, plain_low)):
        print(f"recall@{K} n_probes={n_probes}: kernel path probe-major {kern[0]:.5f} "
              f"query-major {kern[1]:.5f}; plain path {plain[0]:.5f} {plain[1]:.5f}",
              flush=True)
        check(abs(kern[0] - plain[0]) <= 0.005 and abs(kern[1] - plain[1]) <= 0.005,
              f"n_probes={n_probes}: kernel-path recall within 0.005 of the plain path")

    # -- 4. kernels against their plain versions ----------------------------
    results = []

    def max_err(kv, pv):
        fin = torch.isfinite(pv)
        return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0

    def close(name, kv, ki, pv, pi):
        same_inf = torch.equal(torch.isfinite(kv), torch.isfinite(pv))
        err = max_err(kv, pv)
        agree = float((ki == pi).float().mean())
        check(same_inf and torch.allclose(kv, pv, rtol=RTOL, atol=ATOL),
              f"{name} values within rtol {RTOL} atol {ATOL} (max abs err {err:.3e})")
        check(agree >= ID_AGREE, f"{name} ids agree on {agree:.5f} of slots")
        return err

    def record(name, source, replaces, err, ms, plain_ms, work, raft_cost, library_ms, shape):
        """``work``: what the call needs at this run's inputs (the bound);
        ``raft_cost``: raft_tpu's schedule formula, for comparison."""
        bound, by = cost.bound_ms(work)
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "shape": shape,
            "raft_formula_bound_ms": cost.bound_ms(raft_cost)[0],
        })

    metric = "sqeuclidean"
    # select_k: the coarse selection of the probe-major search
    cs = _common.coarse_scores(q, index.centers, metric)
    kv, ki = sk.select_k_kernel(cs, N_PROBES)
    pv, pi = sk.select_k_torch(cs, N_PROBES)
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          f"select_k coarse {tuple(cs.shape)} k={N_PROBES} bitwise equal to plain")
    err = max_err(kv, pv)
    # select_k: the probe-major merge, with input ids
    _, bucket, _, _ = _common.select_scan_strategy(
        "auto", q.shape[0], N_PROBES, index.n_lists, index.list_cap, index.dim,
        res.workspace_limit_bytes, k=K)
    pm_args, bucket_pair = ivf_flat.probe_major_scan_inputs(index, q, N_PROBES, K, bucket)
    kk = pm_args[-1]
    pm_v, pm_i = scan.ivf_scan_probe_major(*pm_args, metric=metric)
    pair_v, pair_i = _common.scatter_pair_partials(
        pm_v.reshape(-1, kk), pm_i.reshape(-1, kk), bucket_pair, q.shape[0], N_PROBES, kk)
    mv, mi = sk.select_k_kernel(pair_v, K, input_indices=pair_i)
    mpv, mpi = sk.select_k_torch(pair_v, K, input_indices=pair_i)
    check(torch.equal(mv, mpv) and torch.equal(mi, mpi),
          f"select_k merge {tuple(pair_v.shape)} k={K} bitwise equal to plain")
    err = max(err, max_err(mv, mpv))
    ms = cuda_ms(lambda: sk.select_k_kernel(cs, N_PROBES), 20)
    plain_ms = cuda_ms(lambda: sk.select_k_torch(cs, N_PROBES), 3)
    lib_ms = cuda_ms(lambda: torch.topk(cs, N_PROBES, dim=1, largest=False), 20)
    merge_ms = cuda_ms(lambda: sk.select_k_kernel(pair_v, K, input_indices=pair_i), 20)
    merge_bound, _ = cost.bound_ms(cost.select_k_work(*pair_v.shape, K, with_ids=True))
    print(f"select_k merge {tuple(pair_v.shape)} k={K}: {merge_ms:.4f} ms, "
          f"bound {merge_bound:.4f} ms (bytes)", flush=True)
    record("select_k", "raft_tpu_torch/csrc/select_k.cu", "raft_tpu/kernels/select_k.py:168",
           err, ms, plain_ms, cost.select_k_work(cs.shape[0], cs.shape[1], N_PROBES),
           cost.select_k_cost(cs.shape[0], cs.shape[1], N_PROBES),
           lib_ms, f"[{cs.shape[0]}, {cs.shape[1]}] k={N_PROBES}")

    # fused_knn: a subset of the oracle's queries (the plain [n_q, n] matrix
    # of all 10,000 would be 40 GB)
    xx = (x * x).sum(dim=1)
    qs_t = q[:FUSED_SUBSET]
    kv, ki = fk.fused_l2_topk(qs_t, x, xx, K)
    pv, pi = fk.fused_l2_topk_torch(qs_t, x, xx, K)
    err = close("fused_knn", kv, ki, pv, pi)
    ms = cuda_ms(lambda: fk.fused_l2_topk(qs_t, x, xx, K), 5)
    plain_ms = cuda_ms(lambda: fk.fused_l2_topk_torch(qs_t, x, xx, K), 1)
    lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(qs_t, x), K, dim=1, largest=False), 5)
    full_ms = cuda_ms(lambda: fk.fused_l2_topk(q, x, xx, K), 2)
    full_bound, full_by = cost.bound_ms(cost.fused_knn_work(q.shape[0], x.shape[0], x.shape[1], K))
    print(f"fused_knn full oracle [10000 x 1000000 x 128] k={K}: {full_ms:.3f} ms, "
          f"bound {full_bound:.3f} ms ({full_by})", flush=True)
    record("fused_knn", "raft_tpu_torch/csrc/fused_knn.cu", "raft_tpu/kernels/fused_knn.py:121",
           err, ms, plain_ms, cost.fused_knn_work(FUSED_SUBSET, x.shape[0], x.shape[1], K),
           cost.fused_knn_cost(FUSED_SUBSET, x.shape[0], x.shape[1], K),
           lib_ms, f"q [{FUSED_SUBSET}, 128] x [1000000, 128] k={K}")

    # the scans' bound counts the real rows of the lists each query probes
    list_rows = (index.list_index >= 0).sum(dim=1)

    # probe-major scan: the inputs of the 10,000-query search
    ppv, ppi = scan.ivf_scan_probe_major_torch(*pm_args, metric=metric)
    err = close("ivf_scan_probe_major", pm_v, pm_i, ppv, ppi)
    ms = cuda_ms(lambda: scan.ivf_scan_probe_major(*pm_args, metric=metric), 5)
    plain_ms = cuda_ms(lambda: scan.ivf_scan_probe_major_torch(*pm_args, metric=metric), 1)
    B, G = pm_args[1].shape[:2]
    live = int(torch.isfinite(pm_args[2]).any(dim=1).sum())
    probes = _common.coarse_select(q, index.centers, metric, N_PROBES)
    record("ivf_scan_probe_major", "raft_tpu_torch/csrc/ivf_scan.cu",
           "raft_tpu/kernels/ivf_scan.py:375", err, ms, plain_ms,
           cost.scan_work(probes, list_rows, index.dim, probes.numel(), kk),
           cost.ivf_scan_cost(live, G, index.list_cap, index.dim, kk), None,
           f"B={B} ({live} non-empty) G={G} cap={index.list_cap} d={index.dim} kk={kk}")

    # query-major scan: the inputs of the 20 serving batches
    kvs, kis, pvs, pis = [], [], [], []
    for b in range(QM_BATCHES):
        args = ivf_flat.query_major_scan_inputs(
            index, q[b * QM_BATCH:(b + 1) * QM_BATCH], N_PROBES, K)
        v1, i1 = scan.ivf_scan_query_major(*args, metric=metric)
        v2, i2 = scan.ivf_scan_query_major_torch(*args, metric=metric)
        kvs.append(v1), kis.append(i1), pvs.append(v2), pis.append(i2)
    err = close("ivf_scan_query_major", torch.cat(kvs), torch.cat(kis),
                torch.cat(pvs), torch.cat(pis))
    qm_args = ivf_flat.query_major_scan_inputs(index, q[:QM_BATCH], N_PROBES, K)
    ms = cuda_ms(lambda: scan.ivf_scan_query_major(*qm_args, metric=metric), 10)
    plain_ms = cuda_ms(lambda: scan.ivf_scan_query_major_torch(*qm_args, metric=metric), 2)
    record("ivf_scan_query_major", "raft_tpu_torch/csrc/ivf_scan.cu",
           "raft_tpu/kernels/ivf_scan.py:649", err, ms, plain_ms,
           cost.scan_work(qm_args[0], list_rows, index.dim, QM_BATCH, K),
           cost.ivf_scan_cost(QM_BATCH * N_PROBES, 1, index.list_cap, index.dim, K), None,
           f"Q={QM_BATCH} P={N_PROBES} cap={index.list_cap} d={index.dim} kk={K}")

    # -- 5. where the time of a search goes ---------------------------------
    from torch.profiler import ProfilerActivity, profile

    def profile_search(fn):
        """Warm wall per call: the median of PROFILE_REPS untraced calls.
        Then one traced window of PROFILE_REPS calls, from which come the
        device time per kernel name per call and the device's busy share
        of that same window's wall (the tracer's host work stretches the
        window, so the share is a lower bound on the untraced one)."""
        fn()
        sync()
        walls = []
        for _ in range(PROFILE_REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REPS):
                fn()
            sync()
            window_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for evt in prof.events():
            if evt.device_type.name == "CUDA":
                by_kernel[evt.name] = (by_kernel.get(evt.name, 0.0)
                                       + evt.device_time_total / 1e3 / PROFILE_REPS)
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        return {
            "wall_ms_median": float(np.median(walls)), "wall_ms_all": walls,
            "traced_wall_ms": window_ms / PROFILE_REPS, "device_busy_ms": busy,
            "device_busy_share": busy * PROFILE_REPS / window_ms,
            "top_device_ms": [[name[:80], ms] for name, ms in top],
        }

    profiles = {
        "probe_major_10000q": profile_search(lambda: ivf_flat.search(sp, index, q, K, res=res)),
        f"query_major_{QM_BATCH}q": profile_search(
            lambda: ivf_flat.search(sp, index, q[:QM_BATCH], K, res=res)),
    }
    for name, prof_out in profiles.items():
        check(prof_out["device_busy_ms"] > 0, f"profile of {name} saw device time")
    print(json.dumps({"profile": profiles}), flush=True)

    for name in kernels.KERNELS:
        check(main_launches[name] > 0, f"{name} launched {main_launches[name]} times on the main path")
    print(f"phase launches: {json.dumps(phase_launches)}", flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
