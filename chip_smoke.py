#!/usr/bin/env python3
"""On-card smoke of the PyTorch / H100 port (``raft_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of ``raft_tpu_torch/csrc`` with nvcc (sm_90a),
then drives the port's main paths at the scale of sift-128-euclidean
(1,000,000 x 128 f32 clustered rows, 10,000 queries, seed 0, synthetic):

1. IVF-Flat build (n_lists=1024, 20 k-means iterations, half the rows as
   trainset: the hierarchical k-means path);
2. the brute-force oracle (fused_knn kernel) for k=10;
3. IVF-Flat search, n_probes=20, k=10: all 10,000 queries at once
   (probe-major scan + select_k), then 20 batches of 64 queries
   (query-major scan + select_k);
4. IVF-PQ build at raft_tpu's ladder config 4 (n_lists=1024, pq_dim=64,
   pq_bits=8, per-subspace codebooks; the "auto" scan cache, bf16), and an
   int8 scan cache decoded from the same codes; IVF-PQ search, n_probes=20,
   k=10, both schedules, on the bf16 cache with f32 and bf16 products and
   on the int8 cache; a k=40 search refined exactly to k=10;
5. reproducibility: two k-means fits of the builds' trainset with one seed
   give bitwise-equal centers, and two predicts equal labels;
6. recall@10 of every search against the oracle, and of the same searches
   with every kernel replaced by its plain PyTorch version (also at
   n_probes=2, where recall is below 1);
7. each kernel against its plain version on the inputs the main path gave
   it: select_k and the bf16 / int8 scan legs bitwise, the others within
   rtol 1e-5 / atol 1e-4 with ids equal on >= 99.9% of slots; times of
   kernel, plain version and (as a yardstick only) one PyTorch library
   call; the bound of each from the work its inputs need
   (``raft_tpu_torch.ops.cost``);
8. where the time of each search schedule goes: warm wall per search and,
   under ``torch.profiler``, device time by kernel and the device's busy
   share.

Launch counts are set to 0 before each phase of the main paths and read
after it.  Prints the card, a JSON line of profiles, a JSON line of
per-kernel results, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no card or any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
#: raft_tpu's ladder config 4 (raft_tpu/bench/ladder.py): pq_dim = d / 2
PQ_DIM, PQ_BITS = 64, 8
REFINE_RATIO = 4
#: the IVF-PQ legs of the main path: (scan cache, lut_dtype)
PQ_LEGS = (("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"))
#: the leg refined and profiled (config 4 searches with bf16 products)
PQ_MAIN = ("bfloat16", "bfloat16")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from raft_tpu_torch import datasets, kernels
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.core.resources import Resources, as_f32
    from raft_tpu_torch.kernels import fused_knn as fk
    from raft_tpu_torch.kernels import ivf_scan as scan
    from raft_tpu_torch.kernels import select_k as sk
    from raft_tpu_torch.neighbors import _common, brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
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

    # -- the card and the kernels -------------------------------------------
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

    # -- data -----------------------------------------------------------------
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
              f"{ {n: c for n, c in phase_launches[name].items() if c} }", flush=True)

    def batches(search_fn, k):
        """``search_fn(query_block, k)`` over the QM_BATCHES serving batches:
        (values, ids, wall ms per batch)."""
        outs, walls = [], []
        for b in range(QM_BATCHES):
            t0 = time.perf_counter()
            outs.append(search_fn(q[b * QM_BATCH:(b + 1) * QM_BATCH], k))
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), walls

    n_qm = QM_BATCH * QM_BATCHES
    outputs = {}   # name -> (values, ids) of each main-path search

    # -- main path: IVF-Flat + the oracle -----------------------------------
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
        outputs["ivf_flat probe-major"] = ivf_flat.search(sp, index, q, K, res=res)
    check(kernels.consume_kernel_path() == "cuda", "probe-major search routed to cuda")
    check(phase_launches["search_probe_major"]["ivf_scan_probe_major"] > 0,
          "probe-major search launched ivf_scan_probe_major")
    check(phase_launches["search_probe_major"]["select_k"] > 0,
          "probe-major search launched select_k")

    with phase("search_query_major"):
        v_qm, i_qm, qm_ms = batches(lambda qb, k: ivf_flat.search(sp, index, qb, k, res=res), K)
    outputs["ivf_flat query-major"] = (v_qm, i_qm)
    check(kernels.consume_kernel_path() == "cuda", "query-major search routed to cuda")
    check(phase_launches["search_query_major"]["ivf_scan_query_major"] > 0,
          "query-major search launched ivf_scan_query_major")
    check(phase_launches["search_query_major"]["select_k"] > 0,
          "query-major search launched select_k")
    print(f"ivf_flat query-major per batch ms median {float(np.median(qm_ms)):.3f} "
          f"min {min(qm_ms):.3f} max {max(qm_ms):.3f}", flush=True)

    # -- main path: IVF-PQ + refine -----------------------------------------
    pq_params = ivf_pq.IndexParams(n_lists=1024, pq_dim=PQ_DIM, pq_bits=PQ_BITS,
                                   kmeans_n_iters=20, kmeans_trainset_fraction=0.5,
                                   seed=SEED)
    with phase("pq_build"):
        pq_index = ivf_pq.build(pq_params, x, res=res)
    print(f"ivf_pq index: n_lists={pq_index.n_lists} cap={pq_index.list_cap} "
          f"size={pq_index.size} rot_dim={pq_index.rot_dim} pq_dim={pq_index.pq_dim} "
          f"decoded_dtype={pq_index.decoded_dtype}", flush=True)
    check(pq_index.decoded_dtype == "bfloat16", "ivf_pq 'auto' scan cache resolved to bfloat16")
    t = time.perf_counter()
    pq_indexes = {"bfloat16": pq_index,
                  "int8": ivf_pq.with_decoded_dtype(pq_index, "int8")}
    sync()
    print(f"int8 scan cache decoded from the codes in {time.perf_counter() - t:.3f} s, "
          f"scan_scale {pq_indexes['int8'].scan_scale!r}", flush=True)

    def pq_search(cache, lut, n_probes=N_PROBES, strategy="auto"):
        """``(queries, k) -> (values, ids)`` on the ``cache`` index with
        ``lut`` products."""
        sp_pq = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype=lut, strategy=strategy)
        return lambda qb, k: ivf_pq.search(sp_pq, pq_indexes[cache], qb, k, res=res)

    for cache, lut in PQ_LEGS:
        tag = f"{cache} cache, {lut} products"
        leg = scan.kernel_name("probe_major", pq_indexes[cache].list_data)
        with phase(f"pq_search_probe_major[{tag}]"):
            outputs[f"ivf_pq probe-major [{tag}]"] = pq_search(cache, lut)(q, K)
        check(kernels.consume_kernel_path() == "cuda", f"ivf_pq probe-major [{tag}] routed to cuda")
        check(phase_launches[f"pq_search_probe_major[{tag}]"][leg] > 0,
              f"ivf_pq probe-major [{tag}] launched {leg}")
        leg = scan.kernel_name("query_major", pq_indexes[cache].list_data)
        with phase(f"pq_search_query_major[{tag}]"):
            v_b, i_b, walls = batches(pq_search(cache, lut), K)
        outputs[f"ivf_pq query-major [{tag}]"] = (v_b, i_b)
        check(kernels.consume_kernel_path() == "cuda", f"ivf_pq query-major [{tag}] routed to cuda")
        check(phase_launches[f"pq_search_query_major[{tag}]"][leg] > 0,
              f"ivf_pq query-major [{tag}] launched {leg}")
        print(f"ivf_pq query-major [{tag}] per batch ms median {float(np.median(walls)):.3f} "
              f"min {min(walls):.3f} max {max(walls):.3f}", flush=True)

    def refined(n_probes=N_PROBES):
        """k * REFINE_RATIO candidates from the PQ_MAIN leg, refined to k
        against the dataset: (candidate ids, (values, ids))."""
        _, cand = pq_search(*PQ_MAIN, n_probes)(q, K * REFINE_RATIO)
        return cand, refine(x, q, cand, K, res=res)

    with phase("pq_refine"):
        cand, outputs["ivf_pq probe-major + refine"] = refined()
    main_launches = {
        name: sum(p[name] for p in phase_launches.values()) for name in kernels.KERNELS
    }

    # -- outputs: shapes, finiteness, recall --------------------------------
    for name, (v, i) in [("oracle", (gt_v, gt_i))] + list(outputs.items()):
        rows = v.shape[0]
        check(rows in (q.shape[0], n_qm) and tuple(v.shape) == (rows, K)
              and tuple(i.shape) == (rows, K) and bool(torch.isfinite(v).all())
              and bool((i >= 0).all()), f"{name} output [{rows}, {K}] finite with real ids")
    recall = {name: recall_at_k(i, gt_i[:i.shape[0]], K) for name, (_, i) in outputs.items()}
    for name, r in recall.items():
        print(f"recall@{K} {name}: {r:.5f}", flush=True)
    check(all(r >= 0.8 for name, r in recall.items() if name.startswith("ivf_flat")),
          "recall@10 of both IVF-Flat searches >= 0.8")
    main_pq = f"ivf_pq probe-major [{PQ_MAIN[0]} cache, {PQ_MAIN[1]} products]"
    r_ref = recall["ivf_pq probe-major + refine"]
    check(r_ref >= 0.9 and r_ref >= recall[main_pq],
          f"refined recall@10 {r_ref:.5f} >= 0.9 and >= the unrefined {recall[main_pq]:.5f}")

    # oracle against an exact float64 numpy reference on a small input
    xs, qs = ds.base[:20000], ds.queries[:64]
    ref_d = ((qs.astype(np.float64)[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    ref_i = np.argsort(ref_d, axis=1, kind="stable")[:, :K]
    sv, si = brute_force.knn(torch.from_numpy(xs).to(dev), torch.from_numpy(qs).to(dev),
                             K, res=res)
    check(recall_at_k(si, ref_i, K) >= 0.99, "brute force matches float64 numpy on 64 x 20000")
    check(np.allclose(sv.cpu().numpy(), np.take_along_axis(ref_d, ref_i, 1),
                      rtol=1e-3, atol=1e-2), "brute-force distances match float64 numpy")
    # refine's distances against float64 numpy on its first 64 queries
    rv, ri = outputs["ivf_pq probe-major + refine"]
    exact = ((ds.queries[:64, None, :].astype(np.float64)
              - ds.base[ri[:64].cpu().numpy()]) ** 2).sum(-1)
    check(np.allclose(rv[:64].cpu().numpy(), exact, rtol=1e-4, atol=1e-2),
          "refined distances match float64 numpy on 64 queries")

    # -- reproducibility of the build ---------------------------------------
    n_train = min(x.shape[0], max(2 * params.n_lists,
                                  int(x.shape[0] * params.kmeans_trainset_fraction)))
    trainset = as_f32(_common.subsample_trainset(x, n_train, SEED), dev)
    kb = kmeans_balanced.KMeansBalancedParams(n_iters=params.kmeans_n_iters, seed=SEED)
    t = time.perf_counter()
    fits = [kmeans_balanced.fit(kb, trainset, params.n_lists, res=res) for _ in range(2)]
    labels = [kmeans_balanced.predict(fits[0], x, res=res) for _ in range(2)]
    sync()
    print(f"two fits on {n_train} rows and two predicts over {x.shape[0]} in "
          f"{time.perf_counter() - t:.1f} s; lists after the split: ivf_flat "
          f"{index.n_lists}, ivf_pq {pq_index.n_lists}", flush=True)
    check(torch.equal(fits[0], fits[1]), "two k-means fits, one seed: centers bitwise equal")
    check(torch.equal(labels[0], labels[1]), "two predicts: labels equal")
    del trainset, fits, labels

    # -- the same searches with every kernel replaced by its plain version --
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
        """recall@K of every main-path search at ``n_probes``, by name."""
        sp_n = ivf_flat.SearchParams(n_probes=n_probes)
        searches = {
            "ivf_flat probe-major": lambda: ivf_flat.search(sp_n, index, q, K, res=res),
            "ivf_flat query-major": lambda: batches(
                lambda qb, k: ivf_flat.search(sp_n, index, qb, k, res=res), K)[:2],
        }
        for cache, lut in PQ_LEGS:
            tag = f"{cache} cache, {lut} products"
            fn = pq_search(cache, lut, n_probes)
            searches[f"ivf_pq probe-major [{tag}]"] = lambda fn=fn: fn(q, K)
            searches[f"ivf_pq query-major [{tag}]"] = lambda fn=fn: batches(fn, K)[:2]
        searches["ivf_pq probe-major + refine"] = lambda: refined(n_probes)[1]
        out = {}
        for name, fn in searches.items():
            i = fn()[1]
            out[name] = recall_at_k(i, gt_i[:i.shape[0]], K)
        return out

    # at 20 probes the IVF-Flat searches give recall 1.0 on any path;
    # LOW_PROBES makes the kernel-vs-plain recall comparison able to fail
    kernel_low = recalls(LOW_PROBES)
    kernels.reset_launch_counts()
    with plain_versions():
        plain_main = recalls(N_PROBES)
        plain_low = recalls(LOW_PROBES)
    check(sum(kernels.launch_counts().values()) == 0, "plain path launched no kernel")
    recall_table = {}
    for n_probes, kern, plain in ((N_PROBES, recall, plain_main),
                                  (LOW_PROBES, kernel_low, plain_low)):
        for name in kern:
            recall_table[f"{name} n_probes={n_probes}"] = [kern[name], plain[name]]
            print(f"recall@{K} n_probes={n_probes} {name}: kernel path {kern[name]:.5f}, "
                  f"plain path {plain[name]:.5f}", flush=True)
            check(abs(kern[name] - plain[name]) <= 0.005,
                  f"n_probes={n_probes} {name}: kernel-path recall within 0.005 of the plain path")
    print(json.dumps({"recall_kernel_vs_plain": recall_table}), flush=True)

    # -- kernels against their plain versions -------------------------------
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

    def bitwise(name, kv, ki, pv, pi):
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"{name} values and ids bitwise equal to the plain version")
        return max_err(kv, pv)

    def record(name, source, replaces, err, ms, plain_ms, work, raft_cost, library_ms, shape,
               **extra):
        """``work``: what the call needs at this run's inputs (the bound);
        ``raft_cost``: raft_tpu's schedule formula, for comparison."""
        bound, by = cost.bound_ms(work)
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "shape": shape,
            "raft_formula_bound_ms": cost.bound_ms(raft_cost)[0], **extra,
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

    def scan_leg(schedule, name, idx, arg_sets, compare, legs):
        """Kernel vs plain for one C entry of ``schedule`` on the main
        path's inputs ``arg_sets`` (the 10,000-query probe-major block, or
        the 20 serving batches), timed on the first.  ``legs``: (scan_kw,
        compute) pairs of the entry; the first is recorded, the others
        measured beside it."""
        kernel = getattr(scan, f"ivf_scan_{schedule}")
        plain = getattr(scan, f"ivf_scan_{schedule}_torch")
        args = arg_sets[0]
        kk, width = args[-1], args[1].shape[-1]
        itemsize = idx.list_data.element_size()
        list_rows = (idx.list_index >= 0).sum(dim=1)
        if schedule == "probe_major":
            B, G = args[1].shape[:2]
            live = int(torch.isfinite(args[2]).any(dim=1).sum())
            probes = _common.coarse_select(q, idx.centers, metric, N_PROBES)
            out_rows, raft_blocks, reps = probes.numel(), (live, G), (5, 1)
            replaces, shape = "raft_tpu/kernels/ivf_scan.py:375", f"B={B} ({live} non-empty) G={G}"
        else:
            probes = args[0]
            out_rows, raft_blocks, reps = probes.shape[0], (probes.numel(), 1), (10, 2)
            replaces, shape = "raft_tpu/kernels/ivf_scan.py:649", f"Q={out_rows} P={N_PROBES}"
        measured = []
        for kw, comp in legs:
            scan_dtype = kw.get("scan_dtype", "highest")
            outs = [(kernel(*a, metric=metric, **kw), plain(*a, metric=metric, **kw))
                    for a in arg_sets]
            err_ = compare(f"{name} {scan_dtype} products",
                           *(torch.cat([o[s][j] for o in outs]) for s in (0, 1) for j in (0, 1)))
            work = cost.scan_work(probes, list_rows, width, out_rows, kk, itemsize=itemsize,
                                  compute=comp)
            raft = dataclasses.replace(cost.ivf_scan_cost(
                *raft_blocks, idx.list_cap, width, kk, itemsize=itemsize), compute=comp)
            measured.append((scan_dtype, err_,
                             cuda_ms(lambda: kernel(*args, metric=metric, **kw), reps[0]),
                             cuda_ms(lambda: plain(*args, metric=metric, **kw), reps[1]),
                             work, raft))
        (scan_dtype, err_, ms_, plain_, work, raft), *others = measured
        also = [dict(zip(("scan_dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"),
                         (o[0], o[1], o[2], o[3], *cost.bound_ms(o[4])))) for o in others]
        record(name, "raft_tpu_torch/csrc/ivf_scan.cu", replaces, err_, ms_, plain_, work, raft,
               None, f"{shape} cap={idx.list_cap} d={width} kk={kk} rows {idx.list_data.dtype}",
               scan_dtype=scan_dtype, **({"also": also} if also else {}))

    def serving_batches(inputs_fn):
        return [inputs_fn(q[b * QM_BATCH:(b + 1) * QM_BATCH]) for b in range(QM_BATCHES)]

    # the f32 legs (IVF-Flat's inputs)
    scan_leg("probe_major", "ivf_scan_probe_major", index, [pm_args], close, [({}, "float32")])
    scan_leg("query_major", "ivf_scan_query_major", index, serving_batches(
        lambda qb: ivf_flat.query_major_scan_inputs(index, qb, N_PROBES, K)),
        close, [({}, "float32")])

    # the bf16 and int8 legs (IVF-PQ's inputs): bitwise, as the summation
    # order matches the plain version's and every product is exact
    bf16, i8 = pq_indexes["bfloat16"], pq_indexes["int8"]
    _, pq_bucket, _, _ = _common.select_scan_strategy(
        "auto", q.shape[0], N_PROBES, bf16.n_lists, bf16.list_cap, bf16.rot_dim,
        res.workspace_limit_bytes, k=K)
    for name, idx, legs in (
        ("bf16", bf16, [(ivf_pq.scan_kwargs(bf16, "bfloat16"), "bfloat16"),
                        (ivf_pq.scan_kwargs(bf16, "float32"), "float32")]),
        ("int8", i8, [(ivf_pq.scan_kwargs(i8), "int8")]),
    ):
        args, _ = ivf_pq.probe_major_scan_inputs(idx, q, N_PROBES, K, pq_bucket)
        scan_leg("probe_major", f"ivf_scan_probe_major_{name}", idx, [args], bitwise, legs)
        scan_leg("query_major", f"ivf_scan_query_major_{name}", idx, serving_batches(
            lambda qb: ivf_pq.query_major_scan_inputs(idx, qb, N_PROBES, K)), bitwise, legs)

    # -- where the time of a search goes ------------------------------------
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

    pq_main = pq_search(*PQ_MAIN)
    profiles = {
        "probe_major_10000q": profile_search(lambda: ivf_flat.search(sp, index, q, K, res=res)),
        f"query_major_{QM_BATCH}q": profile_search(
            lambda: ivf_flat.search(sp, index, q[:QM_BATCH], K, res=res)),
        "pq_probe_major_10000q": profile_search(lambda: pq_main(q, K)),
        f"pq_query_major_{QM_BATCH}q": profile_search(lambda: pq_main(q[:QM_BATCH], K)),
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
