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
5. CAGRA with raft's defaults (``cagra.IndexParams()``: intermediate
   degree 128, graph degree 64, "auto" = the IVF-PQ graph build at 1M rows:
   1,000 lists, 32 probes, 258 candidates per row refined to 129), timed by
   stage, with the graph's invariants (no -1, no self edge, no repeated
   edge in a row); CAGRA search (``SearchParams()``: itopk 64, width 1, 16
   entry centres), k=10, on all 10,000 queries and on 20 batches of 64,
   one walk launch (``cagra_traverse``: every hop of a query tile) per
   tile and no hop launch; then the walk driven hop by hop through the
   public pieces to hop 3 of the first tile, whose single hop
   (``cagra_fused_hop``, raft_tpu's hop kernel) runs once;
6. reproducibility: two k-means fits of the builds' trainset with one seed
   give bitwise-equal centers, and two predicts equal labels;
7. recall@10 of every search against the oracle, and of the same searches
   with every kernel replaced by its plain PyTorch version (also at
   n_probes=2, and for CAGRA at itopk 16 / 4 hops, where recall is below 1);
8. each kernel against its plain version on the inputs the main path gave
   it: select_k, the bf16 / int8 scan legs, the CAGRA hop and the CAGRA
   walk of the first query tile (f32 and bf16 rows, dense and paged)
   bitwise, the others within rtol 1e-5 / atol 1e-4 with ids equal
   on >= 99.9% of slots, also at the widened k the CAGRA build needs (k=129
   for select_k and fused_knn, kk=258 for probe-major, and select_k at
   the filtered CAGRA search's shapes on the device clock); times of kernel,
   plain version and (as a yardstick only) one PyTorch library call; the
   bound of each from the work its inputs need (``raft_tpu_torch.ops.cost``);
   every float leg of probe-major (f32, bf16 with bf16 and f32 products,
   uint8, int8 values) bitwise its plain version at kk 10, 128, 129, 258 and
   1,000 on the first 1,000 queries, monolithic, paged, with pass10 and
   both, and on synthetic lists at its tile's edges (``pm_tile_edges``);
9. filtered search (numpy filters from seed 0 over the 1M ids: ``pass50``
   and ``pass10``, Bitsets passing 50 % / 10 %; ``tomb1``, 1 % tombstones;
   ``table8``, 8 filters passing 10-90 % with each serving query's filter
   drawn from them, through ``RowFilter.from_table``; ``rows64``, the same
   rows by ``RowFilter.from_mask_rows``, no descriptor): the filtered
   oracle (brute force), IVF-Flat (pass50 / pass10 / tomb1 probe-major on
   10,000 queries, pass10 query-major and table8 / rows64 on the 20 x 64
   serving queries), IVF-PQ on every leg (pass10 on both schedules, table8),
   a refined pass10 search, and CAGRA (pass50 on 10,000 queries, pass10 on
   1,000, table8 on 64); no returned id fails its filter or repeats, recall
   against the filtered oracle, the same searches on the plain versions
   (IVF-Flat also at n_probes=2, where recall is below 1), and each filter
   leg of the scans against its plain version on the inputs the main path
   gave it;
10. paged storage (``raft_tpu_torch.store``, 1024-row pages): second copies
   of the IVF-Flat index, both IVF-PQ caches, the brute-force rows and the
   CAGRA index, paginated; with a pool holding every page (identity-pinned,
   the upload timed beside one pinned ``copy_``) every search above is
   repeated on them — IVF unfiltered, pass10 and table8 on both schedules,
   the refined search, brute force on 1,000 queries, CAGRA on 10,000 and
   20 x 64 queries and pass50 on 64 — and must be bitwise equal to the
   monolithic search, on the paged legs only (``*_paged*``,
   ``cagra_traverse_paged``, one walk launch per tile; the paged hop once,
   hop by hop); an
   IVF-Flat pool of a quarter of the pages serves 200 queries in batches
   of 8 (bitwise equal, with misses and evictions; per batch the wall, the
   monolithic wall and the admission's upload rate); a budget of half the
   rows makes paged brute force and CAGRA raise ``BudgetExceeded``; and
   each paged leg against its plain version and beside its unpaged kernel
   on the same rows;
11. kernel #7 (``kernels.fused_l2_argmin``) at raft_tpu's prims shape
   (8,192 x 1,024 centers x 128) and at the k-means assignment of the 1M
   rows; flat k-means (``cluster.kmeans.fit``, 1,024 clusters, 20 Lloyd
   iterations, ``init="array"`` from a seeded sample of rows): two fits
   bitwise equal, inertia finite and falling, ``predict`` equal to
   ``distance.fused_l2_nn_argmin``; ``distance.pairwise_distance`` over
   every canonical metric on 2,048 x 2,048 rows (non-negative rows for the
   divergences, 2-D for haversine), ``fused_l2_nn`` and
   ``masked_l2_nn_argmin`` at 8,192 x 1,024, each held to the same call on
   the CPU; brute force over l1, cosine, chebyshev and correlation (100,000
   rows, 1,000 queries, the select_k kernel);
12. IVF-Flat over the 1M rows scaled by 16, rounded and clipped to uint8
   (BIGANN's dtype), the same integers shifted to int8, and cast to bf16,
   at raft's defaults: recall against the uint8 oracle, every search on its
   storage type's legs (``_u8`` / ``_s8`` / ``_bf16``, filtered too), a
   save / load round trip in raft_tpu's format, and the same searches on
   the plain versions; the uint8 and int8 indexes paginated, pinned (every
   search again, bitwise, on the ``_u8_paged`` / ``_s8_paged`` legs) and
   over budget (a quarter of the pages, batches of 8, bitwise), and each
   paged 8-bit leg against its plain version and its unpaged kernel;
13. deep k: IVF-Flat at k=1,000 on both schedules and brute force at
   k=2,048 on 1,000 queries, and a 64-query batch at k=1,000 (its probes
   split over blocks and merged past k = 128) equal to the same queries of
   the 1,000-query search;
14. four threads, each on its own CUDA stream, searching the over-budget
   IVF-Flat index: bitwise the single-thread results;
15. CAGRA over the uint8 rows of 12 at raft's defaults (kept 1 byte a
   value; the IVF-PQ graph build), and the same graph over the int8 rows:
   10,000 queries each on the walk's uint8 / int8 legs, recall@10 against
   the uint8 oracle, paginated copies (pinned, bitwise the dense search),
   a hop by hop capture; later the same searches on the plain versions,
   the first tile's walk on both legs, dense and paged, and the single hop
   on 8-bit rows, each bitwise its plain version;
16. where the time of each search goes: warm wall per search and, under
   ``torch.profiler``, device time by kernel and the device's busy share;
17. raft_tpu's BASELINE ladder (``raft_tpu_torch.bench.ladder``, configs
   1-4 at scale 1.0): every config passes, on the card, with its launches;
18. the harness end to end: ``python -m raft_tpu_torch.bench --scale 0.01``
   in a subprocess (a row per algorithm with recall, QPS, build time and
   device time), the rows ``raft_tpu_cagra_vpq`` and ``hnswlib_format`` on
   the same dataset in this process, and one ``bench.prims`` case of each
   family;
19. ``brute_force.make_batch_k_query`` batches bitwise ``brute_force.search``
   at the same k, and IVF-PQ at the ladder's config 4 with bf16 internal
   distances (plain ops) against f32 (the scan kernel), both refined;
20. NN-descent: CAGRA with ``build_algo="nn_descent"`` at raft's defaults
   over all rows (tiles sized by a 1 GiB workspace):
   build time by stage, the iterations and their updates, the graph's
   invariants, recall@10 of the walk over it against the oracle (beside the
   IVF-PQ-built graph's), kNN graph recall@10 on 1,000 sampled rows, the
   merge's select_k launches and one tile's merge held bitwise to the plain
   select_k (its time joins the kernels line); then over the first
   ``ND_BATCH_ROWS`` rows two seeded in-memory builds bitwise equal, and
   ``"nn_descent_batch"`` over those rows as a host array (clusters of <=
   65,536 rows): time, peak device memory below the in-memory build's over
   the same rows, kNN graph recall@10 on 1,000 sampled rows;
21. VPQ: ``cagra.compress`` of phase 5's index at ``VpqParams()``, its
   compression ratio, 1,000 queries on the plain walk (kernel_path "torch")
   bitwise the plain walk over the decoded rows, recall@10 >= 0.5, and a
   save / load round trip in raft_tpu's format;
22. hnsw: phase 5's index written in hnswlib's layout (a temporary
   directory, removed after), its size and time, loaded back (base-layer
   links equal to the graph), and searched at ef 64 on 10,000 queries, one
   walk launch a tile, recall@10 >= 0.9;
23. obs: the 64-query IVF-Flat search's warm wall with spans on and off
   (interleaved; overhead < 5 %), a span series in ``obs.to_prometheus()``
   for every entry point the phases called, the kernel-build counter against
   the sources this process built, the over-budget store's page counters
   against its own, and ``obs.analyze_callable`` of the 10,000-query
   IVF-Flat search against the sum of its noted work (roofline share <= 1);
24. serving (``raft_tpu_torch.serve``): phase 1's index as a
   ``MutableIndex`` behind ``SearchService(k=10, max_batch=64,
   max_delay_ms=2.0)``, warmed; eight client threads send the 10,000
   queries as single-query requests, and every answer equals
   ``ivf_flat.search`` of that query alone; no kernel build or library load
   on the dispatch thread after warmup; pipeline depth 1 gives the same
   bytes; 10,000 rows upserted and 1 % of the ids deleted while two threads
   keep searching, after which every upserted row finds itself first and no
   deleted id comes back; ragged requests (k drawn from 1..10, ``table8``
   filter ids) never return an id their filter fails and equal the direct
   filtered search; ``compact_now`` promotes a shadow (IVF ``extend`` into
   an empty clone with the trained centers; its gate's exact oracle on
   fused_knn) whose recall@10 against brute force over the live rows is no
   lower than before; and a second service over phase 5's CAGRA index
   answers the 20 x 64 batches as ``cagra.search`` did, on the walk.
   Prints ``stats()`` (qps, p50 / p99, batch fill), the device's busy share
   under the single-query load (its profiler windows taken in a process of
   its own), the compaction time and each kernel's launches in the phase.
   Beside it, unchecked, the same window in this process at six earlier
   points and on the phase's own service, with the launch calls that lost
   their device records (ROADMAP Q3.8);
25. serving's optional obs layers: ``python -m raft_tpu_torch.bench
   frontier --no-comparators`` at its defaults (100,000 x 96 inner-product
   rows, 1,000 queries; brute force, IVF-Flat, IVF-PQ and CAGRA) in a
   process of its own, its model loaded, every pareto point a knob set its
   backend's ``EffortSpec`` actuates with its device time measured, every
   algorithm on the cuda leg, and select_k, fused_knn, the IVF scans and the
   CAGRA walk launched (the counts its artifact records); phase 1's index
   measured at each n_probes of its effort ladder (device seconds by CUDA
   events) into a ``FrontierModel`` that steers an ``Autotuner``, behind a
   service with the
   recall auditor (at its defaults), ``slo=True`` and a gateway on
   127.0.0.1: at every level the served batches equal ``ivf_flat.search``
   at that level bitwise with no kernel build on the dispatch thread; calm
   ticks of a synthetic clock walk the level to the frontier optimum; under
   the 10,000 single-query requests the recall EWMA stays >= 0.9; a swap to
   a copy with shuffled coarse centers fires the quality alarm once (an
   incident opens, ``healthz`` is not OK, the autotuner buys effort back for
   reason ``recall_floor``), repairing it in place publishes the recovery
   edge, and swapping back starts a fresh EWMA; a latency objective the
   open-loop load breaks publishes ``slo_burn``, the autotuner sheds one
   level after ``degrade_ticks`` and steps toward the optimum after calm
   ticks; after upserts and deletes every GET route answers, ``/metrics``
   carries the recall EWMA and the autotune level, ``/healthz`` agrees with
   ``healthz()``, and the admin plane refuses ``effort_pin`` / ``compact``
   without the bearer token and carries them out with it.  Last, 10,000
   single-query requests with the four layers on, off, and on but the
   auditor (on, off, controller; twice), every run at effort level 0, each
   layered service made for its run and stopped after it; each run's
   requests/s and p50 / p99 printed beside the card's name and power
   limit, with the oracle's seconds a batch, ``live_vectors()``' seconds,
   the gateway's answer times and the autotune level's trajectory;
26. graphs and sparse (``graphs_phase``, at most 150 s): ``sparse.neighbors
   .knn_graph`` over phase 1's rows at k = 15 (fused_knn), weights
   1 / (1 + d), ``spectral.partition`` into 8 clusters twice (labels and
   eigenvalues bitwise equal; 8 labels used; an edge cut at most half a
   seeded random labelling's; eigenvalues within 1e-4 relative of the same
   call on the plain SpMV; kernel #7 holds its k-means assignment); an
   R-MAT graph at Graph500's scale 20, edge factor 16 (``random.rmat``'s
   default theta), symmetrized, by ``modularity_maximization`` twice
   (bitwise; Q above a seeded random labelling's); ``single_linkage`` over
   250,000 x 128 ``make_blobs`` rows (250 blobs, std 1, centre box (0, 10))
   into 250 clusters at c = 15 (ARI >= 0.99 against the blob labels, n - 1
   merges, non-decreasing deltas, last size n; the cross-component rounds
   printed); ``linear_assignment`` of a seeded 2,048 x 2,048 uniform cost
   within n eps of scipy's ``linear_sum_assignment``; ``find_k`` over
   1,000,000 x 128 blobs (16 blobs, kmax 32); sparse ``brute_force_knn``
   and ``pairwise_distance_sparse`` (sqeuclidean, cosine) over a seeded
   100,000 x 20,000 CSR at 0.5 % with 1,000 queries at k = 10, held to the
   dense path on its first 10,000 rows; ``gram_matrix`` (rbf, polynomial)
   at 8,192 x 8,192 x 128 within rtol 1e-4 of the CPU; and the csr_spmm
   kernel bitwise its plain version on the kNN graph's Laplacian and on
   R-MAT's hub rows and a seeded row sample, timed beside its plain version
   and ``torch.sparse.mm``; csr_spmm bitwise its plain version at every
   branch of its plan (``csr_plan_case``: empty windows, warp-round edges, a
   long row, many rows a key; 1, 3, 32, 33 and 128 columns) and at
   ``ops.linalg.reduce_rows_by_key`` of the main rows into phase 1's lists
   (keys by kernel #7), timed beside ``index_add_``.  csr_spmm, fused_knn,
   select_k and fused_argmin must launch in the phase.

Q3.8's probe (``served_window_probe``, not checked) runs after phase 1,
after each section of the main path through the plain versions' searches,
and at four later points.  Launch counts are set to 0 before each phase of
the main paths and read after it.  Prints the card, JSON lines of the over-budget batches, the
uploads, profiles and per-kernel results, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no card or any check fails.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
#: CAGRA: recall floor at SearchParams(), the queries of the kernel-vs-plain
#: recall comparison, the low-effort setting, and the captured hop
CAGRA_RECALL = 0.9
CAGRA_SUBSET = 1000
CAGRA_LOW = dict(itopk_size=16, max_iterations=4)
CAPTURE_HOP = 3
#: the k the CAGRA build asks of select_k (refine) and of the scans
WIDE_K, WIDE_KK = 129, 258
#: the probe-major float legs' sweep: queries of the main path's inputs and
#: each kk it holds bitwise (the list fold to 128, the candidate fold past)
PM_SWEEP_QUERIES, PM_SWEEP_KK = 1000, (10, 128, 129, 258, 1000)
#: the IVF-PQ legs of the main path: (scan cache, lut_dtype)
PQ_LEGS = (("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"))
#: the leg refined and profiled (config 4 searches with bf16 products)
PQ_MAIN = ("bfloat16", "bfloat16")
#: filtered search: filters in the table, queries of the filtered CAGRA
#: searches at 10 % and by table, and the recall floor at pass50 / pass10
TABLE_ROWS = 8
CAGRA_PASS10_QUERIES = 1000
FILTER_RECALL = 0.8
#: paged storage: rows per page (raft_tpu's default), the over-budget arm's
#: share of the pages, its queries and batch, and the paged oracle's queries
PAGE_ROWS = 1024
OVER_BUDGET_FRACTION = 0.25
OVER_BUDGET_QUERIES, OVER_BUDGET_BATCH = 200, 8
PAGED_BF_QUERIES = 1000
#: kernel #7 and flat k-means: raft_tpu's prims bench rows (bench/prims.py),
#: the clusters and Lloyd iterations of the main path's fit
ARGMIN_ROWS, KM_CLUSTERS, KM_ITERS = 8192, 1024, 20
#: the distance layer: rows of each pairwise matrix, rows held to the CPU
DIST_ROWS, DIST_CPU_ROWS = 2048, 256
#: brute force over the other metrics: rows, queries, queries held to the CPU
BF_METRICS = ("l1", "cosine", "chebyshev", "correlation")
BF_ROWS, BF_QUERIES, BF_CPU_QUERIES = 100_000, 1000, 50
#: 8-bit IVF-Flat: the rows scaled by this before rounding to uint8 (the
#: synthetic rows span ~-4..14; BIGANN's uint8 rows span 0..255)
U8_SCALE = 16.0
#: deep k: queries, the IVF k, the brute-force k
DEEP_QUERIES, DEEP_IVF_K, DEEP_BF_K = 1000, 1000, 2048
#: threads searching the over-budget IVF-Flat index, and their batches
THREADS, THREAD_QUERIES = 4, 256
#: IVF-PQ at the ladder's config 4: how far the refined recall with bf16
#: internal distances may fall from the f32 one (bf16 scores carry 8 bits,
#: so candidates near the k' = 40 cut reorder; the refine to k = 10 takes
#: most of that back)
PQ_BF16_TOL = 0.01
#: NN-descent (phase 20): the in-memory build runs over all main rows; the
#: second seeded build (the bitwise check) and the batch build with the
#: in-memory peak it is held under run over the first ND_BATCH_ROWS (the
#: batch build over 1M rows takes ~420 s on an H100, past the 150 s rule);
#: the workspace its tiles are sized by, the batch build's cluster cap
#: (raft_tpu's default) and the rows sampled for graph recall
ND_BATCH_ROWS = 250_000
ND_WORKSPACE = 1 << 30
ND_CLUSTER_ROWS = 65_536
ND_SAMPLE = 1000
#: VPQ (phase 21): queries searched and the recall floor that catches a
#: broken decode; hnsw (phase 22): ef and its recall floor
VPQ_QUERIES, VPQ_RECALL = 1000, 0.5
HNSW_EF, HNSW_RECALL = 64, 0.9
#: obs (phase 23): interleaved rounds of the span-overhead A/B and its limit
OBS_ROUNDS, OBS_OVERHEAD = 300, 0.05
#: serving (phase 24): client threads, rows upserted (each a base row plus
#: noise of this std) and the deleted share of the ids, in this many
#: mutation rounds; the ragged requests, the requests whose busy share is
#: traced, and how long any wait on a request may take
SERVE_THREADS, SERVE_UPSERTS, SERVE_NOISE, SERVE_DELETE = 8, 10_000, 0.5, 0.01
SERVE_ROUNDS, SERVE_RAGGED, SERVE_TRACED, SERVE_WAIT_S = 10, 2000, 2000, 600.0
#: profiler windows of the served load taken before its busy share counts
#: as unmeasured
SERVE_TRACE_ATTEMPTS = 8
#: the argument that makes this script the process of phase 24's busy share
SERVED_BUSY_FLAG = "--served-busy-share"
#: serving's obs layers (phase 25): the frontier sweep's arguments (its
#: defaults, serve backends only), the synthetic clock's tick, a latency
#: objective the open-loop load breaks, the rows upserted (and ten times as
#: many ids deleted) before the gateway compacts, and the cost runs: rounds
#: of (all four layers, none, all but the auditor), the SLO engine's and
#: autotuner's tick and the gateway scrape period under them
FRONTIER_ARGS = ("--no-comparators",)
OBS_TICK_S, OBS_TIGHT_P99_S, OBS_MUTATIONS = 10.0, 0.005, 1000
OBS_COST_ROUNDS, OBS_COST_TICK_S, OBS_SCRAPE_S = 2, 0.5, 1.0
#: graphs and sparse (phase 26): the kNN graph's k and the spectral clusters;
#: R-MAT at Graph500's scale 20, edge factor 16 (rmat's default theta);
#: single linkage over make_blobs at phase 1's geometry; the LAP size; find_k's
#: blobs and kmax; the sparse kNN rows, columns, slots a row, queries, k and
#: the slice held to the dense path; the Gram rows; the R-MAT rows held to the
#: plain SpMV (the highest-degree rows, then a seeded sample); the time limit
GRAPH_K, GRAPH_CLUSTERS = 15, 8
RMAT_SCALE, RMAT_EDGE_FACTOR = 20, 16
SL_ROWS, SL_BLOBS, SL_C = 250_000, 250, 15
LAP_N = 2048
FK_ROWS, FK_BLOBS, FK_KMAX = 1_000_000, 16, 32
SP_ROWS, SP_COLS, SP_PER_ROW, SP_QUERIES, SP_K, SP_SLICE = 100_000, 20_000, 100, 1000, 10, 10_000
GRAM_ROWS = 8192
RMAT_HUB_ROWS, RMAT_SAMPLE_ROWS = 16, 4096
GRAPH_PHASE_S = 150.0


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from raft_tpu_torch import distance, kernels
    from raft_tpu_torch.bench import datasets
    from raft_tpu_torch.bench.device_time import is_device_work, measure_device_time
    from raft_tpu_torch.cluster import kmeans, kmeans_balanced
    from raft_tpu_torch.core.bitset import Bitset, RowFilter
    from raft_tpu_torch.core.resources import Resources, as_f32
    from raft_tpu_torch.kernels import cagra_traverse as ct
    from raft_tpu_torch.kernels import fused_argmin as fa
    from raft_tpu_torch.kernels import fused_knn as fk
    from raft_tpu_torch.kernels import ivf_scan as scan
    from raft_tpu_torch.kernels import select_k as sk
    from raft_tpu_torch.neighbors import _common, brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors import refine as refine_mod
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import cost, matrix
    from raft_tpu_torch.stats.metrics import recall_at_k
    from raft_tpu_torch.store import BudgetExceeded, MemoryBudget, PagedRows, paginate_index

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

    def device_ms(fn, kernel_name, reps=50):
        """Device time of one launch of ``kernel_name`` per call of ``fn``
        (None: of all the call's kernels), from ``torch.profiler``: for a
        kernel shorter than its wrapper's host work, CUDA events around
        back-to-back calls time the host.  Late in this process a window
        loses the records of its first launches (ROADMAP Q3.8), so a window
        with fewer records of ``kernel_name`` than calls is taken again
        with four times the calls, and the mean of the records it kept is
        taken."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        for calls in (reps, 4 * reps):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                sync()
            us = [e.device_time_total for e in prof.events()
                  if is_device_work(e) and (kernel_name is None or kernel_name in e.name)]
            if kernel_name is None or len(us) >= reps:
                break
        if kernel_name is None:   # every kernel the call launches
            return sum(us) / 1e3 / reps
        if len(us) != calls:
            print(f"device_ms: {len(us)} device events of {kernel_name} for {calls} calls; "
                  "their mean is taken", flush=True)
        return sum(us) / 1e3 / len(us) if us else float("nan")

    # -- the card and the kernels -------------------------------------------
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    prebuilt = (kernels.BUILD_DIR / f"libraft_tpu_torch_{kernels._sources_digest()}.so").exists()
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

    def batches(search_fn, k, kw_of=lambda b: {}, queries=None):
        """``search_fn(query_block, k, **kw_of(b))`` over the QM_BATCHES
        serving batches of ``queries`` (default: the main queries): (values,
        ids, wall ms per batch)."""
        queries = q if queries is None else queries
        outs, walls = [], []
        for b in range(QM_BATCHES):
            t0 = time.perf_counter()
            outs.append(search_fn(queries[b * QM_BATCH:(b + 1) * QM_BATCH], k, **kw_of(b)))
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
    # Q3.8: served-load profiler windows at points of this process, up to
    # phase 24's own (not checked; see served_window_probe)
    probes = []

    def probe(where):
        served_window_probe(index, sp, q[:SERVE_TRACED].cpu().numpy(), where, check, probes)

    probe("phase 1's searches")

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
        """``(queries, k, **filter) -> (values, ids)`` on the ``cache`` index
        with ``lut`` products."""
        sp_pq = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype=lut, strategy=strategy)
        return lambda qb, k, **kw: ivf_pq.search(sp_pq, pq_indexes[cache], qb, k, res=res, **kw)

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

    probe("IVF-PQ's build, caches and refine")

    # -- main path: CAGRA ---------------------------------------------------
    @contextlib.contextmanager
    def spied():
        """Record the k of every scan and select_k launch, and time the
        build's stages (synchronised), while the block runs."""
        seen, stage_s = {"scan": set(), "select_k": set()}, {}
        saved = {}

        def spy(mod, attr, key):
            fn = getattr(mod, attr)
            saved.setdefault((mod, attr), fn)

            def wrapper(*a, **kw):
                seen[key].add(a[6] if key == "scan" else a[1])
                return fn(*a, **kw)
            setattr(mod, attr, wrapper)

        def timed(mod, attr):
            fn = getattr(mod, attr)
            saved.setdefault((mod, attr), fn)   # the original, under a spy too

            def wrapper(*a, **kw):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                stage_s[attr] = stage_s.get(attr, 0.0) + time.perf_counter() - t0
                return out
            setattr(mod, attr, wrapper)

        spy(scan, "ivf_scan_probe_major", "scan")
        spy(scan, "ivf_scan_query_major", "scan")
        spy(sk, "select_k_kernel", "select_k")
        # the build's scans (the kk = 258 probe-major legs) inside its search
        for mod, attr in ((ivf_pq, "build"), (ivf_pq, "search"), (scan, "ivf_scan_probe_major"),
                          (cagra, "refine"), (cagra, "optimize"), (cagra, "_build_entry_points")):
            timed(mod, attr)
        try:
            yield seen, stage_s
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)

    cagra_params = cagra.IndexParams()
    with phase("cagra_build"):
        cg = cagra.build(cagra_params, x, res=res)
    # a second build, off the main path and not its time: the stage times
    # (each stage synchronised) and the k of each launch; one seed must give
    # one graph
    with spied() as (seen, stage_s):
        again = cagra.build(cagra_params, x, res=res).graph
    print(f"cagra build stages (s, second build, synchronised): {json.dumps(stage_s)}; "
          f"scan kk {sorted(seen['scan'])}, select_k k {sorted(seen['select_k'])}", flush=True)
    check(torch.equal(again, cg.graph), "two CAGRA builds, one seed: graphs equal")
    del again
    build_launches = phase_launches["cagra_build"]
    check(WIDE_KK in seen["scan"] and build_launches["ivf_scan_probe_major_bf16"] > 0,
          f"cagra build scanned at kk={WIDE_KK} (ivf_scan_probe_major_bf16 launches "
          f"{build_launches['ivf_scan_probe_major_bf16']})")
    check(WIDE_K in seen["select_k"] and build_launches["select_k"] > 0,
          f"cagra build's refine ran select_k at k={WIDE_K}")
    check(build_launches["fused_knn"] > 0, "cagra build's entry points launched fused_knn")
    g = cg.graph
    g_sorted = torch.sort(g, dim=1).values
    check(tuple(g.shape) == (x.shape[0], cagra_params.graph_degree) and g.dtype == torch.int32,
          f"cagra graph {tuple(g.shape)} int32")
    check(bool((g >= 0).all()) and bool((g < x.shape[0]).all()), "cagra graph: no -1, ids < n")
    check(bool((g != torch.arange(x.shape[0], device=dev)[:, None]).all()),
          "cagra graph: no self edge")
    check(bool((g_sorted[:, 1:] != g_sorted[:, :-1]).all()), "cagra graph: no repeated edge in a row")
    del g_sorted
    print(f"cagra index: graph {tuple(g.shape)}, entry points {tuple(cg.entry_centers.shape)}",
          flush=True)

    cagra_sp = cagra.SearchParams()

    def cagra_search(sp=cagra_sp, index=cg):
        return lambda qb, k: cagra.search(sp, index, qb, k, res=res)

    def expected_tiles(n_q, sp=cagra_sp):
        _, _, tile = cagra.search_plan(sp, cg, n_q, K, res)
        return -(-n_q // tile)

    def walk_launches(ph, n_tiles, paged=""):
        """One walk launch a query tile, no hop launch and no per-hop
        select_k (seeds, seed buffer and result: at most two a tile and one
        for the entry points)."""
        c = phase_launches[ph]
        walks = c[f"cagra_traverse{paged}"]
        check(walks == n_tiles and c["cagra_fused_hop"] == c["cagra_fused_hop_paged"] == 0
              and c["select_k"] <= 3 * n_tiles,
              f"{ph}: {walks} cagra_traverse{paged} launches = query tiles {n_tiles}, no hop "
              f"launch, select_k {c['select_k']} <= 3 a tile")

    with phase("cagra_search"):
        outputs["cagra"] = cagra_search()(q, K)
    check(kernels.consume_kernel_path() == "cuda", "cagra search routed to cuda")
    walk_launches("cagra_search", expected_tiles(q.shape[0]))
    with phase("cagra_search_batches"):
        v_b, i_b, walls = batches(cagra_search(), K)
    outputs["cagra batches"] = (v_b, i_b)
    check(kernels.consume_kernel_path() == "cuda", "cagra batches routed to cuda")
    walk_launches("cagra_search_batches", QM_BATCHES * expected_tiles(QM_BATCH))
    print(f"cagra per batch ms median {float(np.median(walls)):.3f} "
          f"min {min(walls):.3f} max {max(walls):.3f}", flush=True)
    metric = "sqeuclidean"

    # raft_tpu's single-hop function (kernels.cagra_traverse.cagra_fused_hop):
    # a walk driven hop by hop through the public pieces, to hop CAPTURE_HOP
    # of the first query tile (its inputs are held to the plain hop below)
    def capture_hop(index, n_q, dataset=None, queries=None):
        """The hop's inputs at hop CAPTURE_HOP, rows read from ``dataset``
        (default: the index's own; a PagedRows for the paged leg), for the
        first tile of ``queries`` (default: the main queries)."""
        ds = index.dataset if dataset is None else dataset
        itopk, _, tile = cagra.search_plan(cagra_sp, index, n_q, K, res)
        qs = (q if queries is None else queries)[:min(n_q, tile)]
        seeds = cagra.make_seed_ids(cagra_sp, index, qs, K, itopk=itopk)
        buf = cagra.traverse_init(ds, qs, seeds, itopk, metric)
        buf_d, buf_i, explored = cagra.traverse_steps(
            ds, index.graph, qs, *buf, steps=CAPTURE_HOP - 1,
            width=cagra_sp.search_width, metric=metric)
        parents, explored = cagra.pick_parents(buf_d, buf_i, explored, cagra_sp.search_width)
        return (ds, index.graph, qs, parents, buf_d, buf_i, explored)

    with phase("cagra_hop"):
        hop_args = capture_hop(cg, q.shape[0])
        hop_out = ct.cagra_fused_hop(*hop_args, metric=metric)
    check(phase_launches["cagra_hop"]["cagra_fused_hop"] == 1
          and phase_launches["cagra_hop"]["cagra_traverse"] == 1,
          "cagra hop by hop: one walk launch to hop 2, then one hop launch")

    probe("CAGRA's build and searches")

    # -- main path: filtered search -------------------------------------------
    n_rows = x.shape[0]
    frng = np.random.default_rng(SEED)
    pass_masks = {name: torch.from_numpy(frng.random(n_rows) < rate).to(dev)
                  for name, rate in (("pass50", 0.5), ("pass10", 0.1), ("tomb1", 0.01))}
    table8 = torch.from_numpy(frng.random((TABLE_ROWS, n_rows))
                              < np.linspace(0.1, 0.9, TABLE_ROWS)[:, None]).to(dev)
    fid = torch.from_numpy(frng.integers(0, TABLE_ROWS, n_qm)).to(dev)
    table_words = RowFilter.from_mask_rows(table8).words
    filters = {
        "pass50": dict(sample_filter=Bitset.from_mask(pass_masks["pass50"])),
        "pass10": dict(sample_filter=Bitset.from_mask(pass_masks["pass10"])),
        "tomb1": dict(deleted_mask=Bitset.from_mask(pass_masks["tomb1"])),
    }
    passes = {"pass50": lambda i: pass_masks["pass50"][i],
              "pass10": lambda i: pass_masks["pass10"][i],
              "tomb1": lambda i: ~pass_masks["tomb1"][i],
              "table8": lambda i: table8[fid[:i.shape[0]].long()[:, None], i]}

    def table8_filter(s, e):
        return dict(sample_filter=RowFilter.from_table(table_words, fid[s:e], n_rows))

    table_batches = [table8_filter(b * QM_BATCH, (b + 1) * QM_BATCH) for b in range(QM_BATCHES)]
    rows_batches = [dict(sample_filter=RowFilter.from_mask_rows(
        table8[fid[b * QM_BATCH:(b + 1) * QM_BATCH].long()])) for b in range(QM_BATCHES)]
    t_all = table8_filter(0, n_qm)
    print(f"filters: pass rates {({k: float(m.float().mean()) for k, m in pass_masks.items()})}, "
          f"table8 rows {[round(float(r), 4) for r in table8.float().mean(dim=1)]}", flush=True)

    with phase("filt_oracle"):
        filt_gt = {name: brute_force.knn(x, q, K, res=res, **kw)[1] for name, kw in filters.items()}
        filt_gt["table8"] = brute_force.knn(x, q[:n_qm], K, res=res, **t_all)[1]
    check(kernels.consume_kernel_path() == "cuda", "filtered oracle routed to cuda")
    check(phase_launches["filt_oracle"]["select_k"] > 0 and
          phase_launches["filt_oracle"]["fused_knn"] == 0,
          "filtered oracle launched select_k and not the unfiltered fused_knn")

    def flat_batches(kw_of):
        return lambda: batches(lambda qb, k, **kw: ivf_flat.search(sp, index, qb, k, res=res, **kw),
                               K, kw_of)[:2]

    def pq_batches(cache, lut, kw_of):
        return lambda: batches(pq_search(cache, lut), K, kw_of)[:2]

    def refined_filtered(cache, lut, n_probes=N_PROBES):
        _, cand_f = pq_search(cache, lut, n_probes)(q, K * REFINE_RATIO, **filters["pass10"])
        return refine(x, q, cand_f, K, res=res)

    def cagra_filtered(qs, kw):
        return lambda: cagra.search(cagra_sp, cg, qs, K, res=res, **kw)

    # (phase, search name, thunk -> (values, ids), filter name, the legs it launches)
    filt_specs = []
    for name in filters:
        filt_specs.append(("filt_ivf_flat_probe_major", f"ivf_flat probe-major {name}",
                           lambda name=name: ivf_flat.search(sp, index, q, K, res=res,
                                                             **filters[name]), name,
                           ["ivf_scan_probe_major_filt"]))
    filt_specs += [
        ("filt_ivf_flat_query_major", "ivf_flat query-major pass10",
         flat_batches(lambda b: filters["pass10"]), "pass10", ["ivf_scan_query_major_filt"]),
        ("filt_ivf_flat_fid", "ivf_flat query-major table8",
         flat_batches(lambda b: table_batches[b]), "table8", ["ivf_scan_query_major_fid"]),
        ("filt_ivf_flat_fid", "ivf_flat query-major rows64 (no descriptor)",
         flat_batches(lambda b: rows_batches[b]), "table8", ["ivf_scan_query_major_fid"]),
    ]
    for cache, lut in PQ_LEGS:
        tag = f"{cache} cache, {lut} products"
        pm_leg = scan.kernel_name("probe_major", pq_indexes[cache].list_data)
        qm_leg = scan.kernel_name("query_major", pq_indexes[cache].list_data)
        filt_specs += [
            (f"filt_pq[{tag}]", f"ivf_pq probe-major pass10 [{tag}]",
             lambda c=cache, lt=lut: pq_search(c, lt)(q, K, **filters["pass10"]), "pass10",
             [pm_leg + "_filt"]),
            (f"filt_pq[{tag}]", f"ivf_pq query-major pass10 [{tag}]",
             pq_batches(cache, lut, lambda b: filters["pass10"]), "pass10", [qm_leg + "_filt"]),
            (f"filt_pq[{tag}]", f"ivf_pq query-major table8 [{tag}]",
             pq_batches(cache, lut, lambda b: table_batches[b]), "table8", [qm_leg + "_fid"]),
        ]
    filt_specs += [
        ("filt_pq_refine", "ivf_pq probe-major pass10 + refine", lambda: refined_filtered(*PQ_MAIN),
         "pass10", [scan.kernel_name("probe_major", pq_indexes[PQ_MAIN[0]].list_data) + "_filt",
                    "select_k"]),
        ("filt_cagra", "cagra pass50", cagra_filtered(q, filters["pass50"]), "pass50",
         ["select_k"]),
        ("filt_cagra", "cagra pass10", cagra_filtered(q[:CAGRA_PASS10_QUERIES], filters["pass10"]),
         "pass10", ["select_k"]),
        ("filt_cagra", "cagra table8", cagra_filtered(q[:QM_BATCH], table_batches[0]), "table8",
         ["select_k"]),
    ]
    filt_out = {}
    for ph in dict.fromkeys(spec[0] for spec in filt_specs):
        specs = [spec for spec in filt_specs if spec[0] == ph]
        with phase(ph):
            for _, name, fn, _, _ in specs:
                filt_out[name] = fn()
        check(kernels.consume_kernel_path() == "cuda", f"{ph} routed to cuda")
        for leg in dict.fromkeys(leg for spec in specs for leg in spec[4]):
            check(phase_launches[ph][leg] > 0, f"{ph} launched {leg}")
    check(phase_launches["filt_cagra"]["cagra_fused_hop"] == 0
          and phase_launches["filt_cagra"]["cagra_traverse"] == 0,
          "filtered CAGRA keeps the hop and walk kernels off filtered traffic, as raft_tpu does")
    probe("the filtered searches")

    # -- main path: paged storage ---------------------------------------------
    # second indexes made from the same tensors (copy.copy), paginated in
    # place: the monolithic indexes above stay as they are
    uploads = []

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def paginate(idx, name, budget=None):
        """A paginated copy of ``idx`` and its pager, timed; pinned up
        front when the pool holds every page (the upload timed beside one
        pinned ``copy_`` of the same bytes)."""
        paged_idx = copy.copy(idx)
        t0 = time.perf_counter()
        pager = paginate_index(paged_idx, page_rows=PAGE_ROWS, budget=budget, name=name)
        sync()
        t_pag = time.perf_counter() - t0
        print(f"{name}: {pager.n_pages} pages of {pager.store.page_bytes} B, {pager.slots} "
              f"slots ({pager.nbytes} device bytes), paginated in {t_pag:.2f} s", flush=True)
        if pager.slots == pager.n_pages:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pager.pin_identity()
            end.record()
            sync()
            pin_ms = start.elapsed_time(end)
            nbytes = pager.store.data.nbytes
            dst = torch.empty_like(pager.pool)
            copy_ms = cuda_ms(lambda: dst.copy_(pager.store.pages, non_blocking=True), 3)
            del dst
            uploads.append({"name": f"{name} pin_identity", "bytes": nbytes, "ms": pin_ms,
                             "gb_per_s": nbytes / pin_ms / 1e6, "pinned_copy_ms": copy_ms,
                             "pinned_copy_gb_per_s": nbytes / copy_ms / 1e6})
            print(f"{name}: pin_identity {pin_ms:.2f} ms ({nbytes / pin_ms / 1e6:.2f} GB/s), "
                  f"one pinned copy_ {copy_ms:.2f} ms", flush=True)
        return paged_idx, pager

    p_flat, flat_pager = paginate(index, "paged_ivf_flat")
    check(p_flat.list_data.device.type == "cpu" and flat_pager.pool.is_cuda
          and p_flat.list_cap % PAGE_ROWS == 0,
          f"paged ivf_flat: host list_data, device pool, cap {index.list_cap} -> "
          f"{p_flat.list_cap}")
    paged_checks = []   # (phase, search name, thunk, the monolithic output, the legs it launches)
    paged_checks += [
        ("paged_ivf_flat", "ivf_flat probe-major", lambda: ivf_flat.search(sp, p_flat, q, K, res=res),
         outputs["ivf_flat probe-major"], ["ivf_scan_probe_major_paged"]),
        ("paged_ivf_flat", "ivf_flat query-major",
         lambda: batches(lambda qb, k: ivf_flat.search(sp, p_flat, qb, k, res=res), K)[:2],
         outputs["ivf_flat query-major"], ["ivf_scan_query_major_paged"]),
        ("paged_ivf_flat", "ivf_flat probe-major pass10",
         lambda: ivf_flat.search(sp, p_flat, q, K, res=res, **filters["pass10"]),
         filt_out["ivf_flat probe-major pass10"], ["ivf_scan_probe_major_paged_filt"]),
        ("paged_ivf_flat", "ivf_flat query-major pass10",
         lambda: batches(lambda qb, k, **kw: ivf_flat.search(sp, p_flat, qb, k, res=res, **kw),
                         K, lambda b: filters["pass10"])[:2],
         filt_out["ivf_flat query-major pass10"], ["ivf_scan_query_major_paged_filt"]),
        ("paged_ivf_flat", "ivf_flat query-major table8",
         lambda: batches(lambda qb, k, **kw: ivf_flat.search(sp, p_flat, qb, k, res=res, **kw),
                         K, lambda b: table_batches[b])[:2],
         filt_out["ivf_flat query-major table8"], ["ivf_scan_query_major_paged_fid"]),
    ]
    p_pq = {}
    for cache in ("bfloat16", "int8"):
        p_pq[cache], _ = paginate(pq_indexes[cache], f"paged_ivf_pq_{cache}")

    def p_pq_search(cache, lut, n_probes=N_PROBES):
        sp_pq = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype=lut)
        return lambda qb, k, **kw: ivf_pq.search(sp_pq, p_pq[cache], qb, k, res=res, **kw)

    for cache, lut in PQ_LEGS:
        tag = f"{cache} cache, {lut} products"
        pm_leg = scan.kernel_name("probe_major", pq_indexes[cache].list_data) + "_paged"
        qm_leg = scan.kernel_name("query_major", pq_indexes[cache].list_data) + "_paged"
        fn = p_pq_search(cache, lut)
        paged_checks += [
            ("paged_ivf_pq", f"ivf_pq probe-major [{tag}]", lambda fn=fn: fn(q, K),
             outputs[f"ivf_pq probe-major [{tag}]"], [pm_leg]),
            ("paged_ivf_pq", f"ivf_pq query-major [{tag}]", lambda fn=fn: batches(fn, K)[:2],
             outputs[f"ivf_pq query-major [{tag}]"], [qm_leg]),
            ("paged_ivf_pq", f"ivf_pq probe-major pass10 [{tag}]",
             lambda fn=fn: fn(q, K, **filters["pass10"]),
             filt_out[f"ivf_pq probe-major pass10 [{tag}]"], [pm_leg + "_filt"]),
            ("paged_ivf_pq", f"ivf_pq query-major pass10 [{tag}]",
             lambda fn=fn: batches(fn, K, lambda b: filters["pass10"])[:2],
             filt_out[f"ivf_pq query-major pass10 [{tag}]"], [qm_leg + "_filt"]),
            ("paged_ivf_pq", f"ivf_pq query-major table8 [{tag}]",
             lambda fn=fn: batches(fn, K, lambda b: table_batches[b])[:2],
             filt_out[f"ivf_pq query-major table8 [{tag}]"], [qm_leg + "_fid"]),
        ]

    def p_refined():
        _, cand_p = p_pq_search(*PQ_MAIN)(q, K * REFINE_RATIO)
        return refine(x, q, cand_p, K, res=res)

    paged_checks.append(("paged_ivf_pq", "ivf_pq probe-major + refine", p_refined,
                         outputs["ivf_pq probe-major + refine"], ["select_k"]))
    p_bf = brute_force.build(x, res=res)
    p_bf, _ = paginate(p_bf, "paged_brute_force")
    bf_ref = brute_force.knn(x, q[:PAGED_BF_QUERIES], K, res=res)
    paged_checks.append(("paged_brute_force", "brute_force",
                         lambda: brute_force.search(p_bf, q[:PAGED_BF_QUERIES], K, res=res),
                         bf_ref, ["fused_knn"]))
    p_cg, _ = paginate(cg, "paged_cagra")
    cagra_pass50_64 = cagra_filtered(q[:QM_BATCH], filters["pass50"])()
    paged_checks += [
        ("paged_cagra", "cagra", lambda: cagra.search(cagra_sp, p_cg, q, K, res=res),
         outputs["cagra"], ["cagra_traverse_paged"]),
        ("paged_cagra", "cagra batches",
         lambda: batches(lambda qb, k: cagra.search(cagra_sp, p_cg, qb, k, res=res), K)[:2],
         outputs["cagra batches"], ["cagra_traverse_paged"]),
        ("paged_cagra_filtered", "cagra pass50 64 q",
         lambda: cagra.search(cagra_sp, p_cg, q[:QM_BATCH], K, res=res, **filters["pass50"]),
         cagra_pass50_64, ["select_k"]),
    ]
    for ph in dict.fromkeys(spec[0] for spec in paged_checks):
        specs = [spec for spec in paged_checks if spec[0] == ph]
        with phase(ph):
            got = {name: fn() for _, name, fn, _, _ in specs}
        check(kernels.consume_kernel_path() == "cuda", f"{ph} routed to cuda")
        for _, name, _, want, legs in specs:
            check(same(got[name], want), f"{ph}: paged {name} bitwise equal to the monolithic search")
        for leg in dict.fromkeys(leg for spec in specs for leg in spec[4]):
            check(phase_launches[ph][leg] > 0, f"{ph} launched {leg}")
        stray = {leg: c for leg, c in phase_launches[ph].items()
                 if c and leg.startswith("ivf_scan") and "_paged" not in leg}
        check(not stray, f"{ph}: no unpaged scan launched {stray or ''}")
    r_mono = recall_at_k(outputs["ivf_pq probe-major + refine"][1], gt_i, K)
    r_paged = recall_at_k(p_refined()[1], gt_i, K)
    check(r_paged == r_mono, f"paged refined recall@10 {r_paged:.5f} == unpaged {r_mono:.5f}")
    walk_launches("paged_cagra", expected_tiles(q.shape[0])
                  + QM_BATCHES * expected_tiles(QM_BATCH), "_paged")
    check(phase_launches["paged_cagra"]["cagra_traverse"] == 0, "paged cagra: no dense walk")

    def paged_view(idx):
        pool, page_slot = idx.paged.view()
        return PagedRows(pool, page_slot, idx.size)

    with phase("paged_cagra_hop"):
        hop_p = capture_hop(p_cg, q.shape[0], paged_view(p_cg))
        hop_p_out = ct.cagra_fused_hop(*hop_p, metric=metric)
    check(phase_launches["paged_cagra_hop"]["cagra_fused_hop_paged"] == 1
          and phase_launches["paged_cagra_hop"]["cagra_traverse_paged"] == 1,
          "paged cagra hop by hop: one paged walk launch, then one paged hop launch")

    # over budget: a quarter of the pages, served 8 queries at a time
    n_pages = flat_pager.n_pages
    page_bytes = flat_pager.store.page_bytes
    over_slots = max(1, int(OVER_BUDGET_FRACTION * n_pages))
    p_over, over_pager = paginate(index, "paged_ivf_flat_over_budget",
                                  budget=MemoryBudget(over_slots * page_bytes + 4 * n_pages))
    check(over_pager.slots == over_slots < n_pages,
          f"over budget: {over_pager.slots} slots of {n_pages} pages (formula: {over_slots})")
    admit_ms = []
    ensure_resident = over_pager.ensure_resident

    def timed_ensure(pages):
        sync()
        t0 = time.perf_counter()
        ensure_resident(pages)
        sync()
        admit_ms.append((time.perf_counter() - t0) * 1e3)

    over_pager.ensure_resident = timed_ensure
    over_starts = range(0, OVER_BUDGET_QUERIES, OVER_BUDGET_BATCH)
    mono_out, mono_walls = [], []
    for b in over_starts:   # the monolithic batches, outside the phase
        t0 = time.perf_counter()
        mono_out.append(ivf_flat.search(sp, index, q[b:b + OVER_BUDGET_BATCH], K, res=res))
        sync()
        mono_walls.append((time.perf_counter() - t0) * 1e3)
    over_rows, over_ok = [], True
    with phase("paged_ivf_flat_over_budget"):
        for i, b in enumerate(over_starts):
            m0 = over_pager.misses + over_pager.prefetched
            t0 = time.perf_counter()
            got = ivf_flat.search(sp, p_over, q[b:b + OVER_BUDGET_BATCH], K, res=res)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            over_ok &= same(got, mono_out[i])
            # pages uploaded: the admission's misses and any the prefetch
            # thread fetched first (the admission then waits on its lock)
            miss = over_pager.misses + over_pager.prefetched - m0
            over_rows.append({"batch": i, "wall_ms": wall, "mono_wall_ms": mono_walls[i],
                              "misses": miss, "admit_ms": admit_ms[-1],
                              "upload_gb_per_s": miss * page_bytes / admit_ms[-1] / 1e6})
    del over_pager.ensure_resident
    check(kernels.consume_kernel_path() == "cuda", "paged_ivf_flat_over_budget routed to cuda")
    check(over_ok, f"over budget: all {len(over_rows)} batches of {OVER_BUDGET_BATCH} bitwise "
          "equal to the monolithic search")
    st = over_pager.stats()
    check(st["misses"] > 0 and st["evictions"] > 0,
          f"over budget: misses {st['misses']} > 0 and evictions {st['evictions']} > 0")
    check(phase_launches["paged_ivf_flat_over_budget"]["ivf_scan_query_major_paged"] > 0,
          "over budget launched ivf_scan_query_major_paged")
    for row in over_rows:
        print(f"over budget batch {row['batch']}: wall {row['wall_ms']:.3f} ms, monolithic "
              f"{row['mono_wall_ms']:.3f} ms, {row['misses']} misses, admission "
              f"{row['admit_ms']:.3f} ms ({row['upload_gb_per_s']:.2f} GB/s)", flush=True)
    print(json.dumps({"paged_over_budget": {"stats": st, "batches": over_rows}}), flush=True)
    # the pinned copy_ of one batch's worth of pages (the upload's yardstick)
    n_cold = max(row["misses"] for row in over_rows)
    src = flat_pager.store.pages[:n_cold]
    dst = torch.empty_like(src, device=dev)
    cold_copy_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    uploads.append({"name": f"over budget admission, {n_cold} pages (the largest)",
                    "bytes": n_cold * page_bytes,
                    "ms": max(r["admit_ms"] for r in over_rows if r["misses"] == n_cold),
                    "pinned_copy_ms": cold_copy_ms,
                    "pinned_copy_gb_per_s": n_cold * page_bytes / cold_copy_ms / 1e6})
    del dst, src

    # loud failures: the dense backends need every page resident
    for kind, idx, search_fn in (
            ("brute_force", brute_force.build(x, res=res),
             lambda i: brute_force.search(i, q[:QM_BATCH], K, res=res)),
            ("cagra", cg, lambda i: cagra.search(cagra_sp, i, q[:QM_BATCH], K, res=res))):
        rows_pages = -(-x.shape[0] // PAGE_ROWS)
        row_page_bytes = PAGE_ROWS * x.shape[1] * 4
        small, _ = paginate(idx, f"loud_{kind}", budget=MemoryBudget(
            rows_pages // 2 * row_page_bytes + 4 * rows_pages))
        try:
            search_fn(small)
            raised = False
        except BudgetExceeded:
            raised = True
        check(raised, f"paged {kind} over budget raises BudgetExceeded")
        small.paged.close()
        del small
    print(json.dumps({"uploads": uploads}), flush=True)

    probe("paged storage")

    # -- main path: kernel #7, the distance layer, flat k-means ----------------
    # k-means' initial centers: a fixed seeded sample of rows (init="array")
    km_rows = np.sort(np.random.default_rng(SEED).choice(x.shape[0], KM_CLUSTERS, replace=False))
    km_init = x[torch.from_numpy(km_rows).to(dev)]
    cc_init = (km_init * km_init).sum(dim=1)
    with phase("fused_argmin"):
        am_small = kernels.fused_l2_argmin(x[:ARGMIN_ROWS], km_init, cc_init)
        am_full = kernels.fused_l2_argmin(x, km_init, cc_init)
    check(phase_launches["fused_argmin"]["fused_argmin"] == 2, "fused_l2_argmin launched #7 twice")
    for tag, (v, i), n in (("8192", am_small, ARGMIN_ROWS), ("1M", am_full, x.shape[0])):
        check(tuple(v.shape) == (n,) and v.dtype == torch.float32 and i.dtype == torch.int32
              and bool(torch.isfinite(v).all()) and bool(((i >= 0) & (i < KM_CLUSTERS)).all()),
              f"fused_l2_argmin {tag} x {KM_CLUSTERS}: finite scores, ids in range")
    # the rows' own centers are sampled rows: each such row's argmin is its
    # own center (or an exact duplicate of it)
    own = am_full[1][torch.from_numpy(km_rows).to(dev)].long()
    check(bool((km_init[own] == km_init).all(dim=1).all()),
          "fused_l2_argmin: each sampled row's nearest center is itself")

    km_params = kmeans.KMeansParams(n_clusters=KM_CLUSTERS, max_iter=KM_ITERS, init="array",
                                    seed=SEED)
    km_history = []
    with phase("kmeans"):
        t0 = time.perf_counter()
        km_c, km_inertia, km_iters = kmeans.fit(km_params, x, init_centers=km_init,
                                                history=km_history, res=res)
        sync()
        km_fit_s = time.perf_counter() - t0
        km_labels = kmeans.predict(km_c, x, res=res)
        km_nn = distance.fused_l2_nn_argmin(x, km_c, res=res)
    again = kmeans.fit(km_params, x, init_centers=km_init, res=res)
    check(torch.equal(again[0], km_c) and float(again[1]) == float(km_inertia)
          and again[2] == km_iters, "two k-means fits, one init: centers and inertia bitwise equal")
    del again
    check(torch.equal(km_labels, km_nn), "kmeans.predict equals fused_l2_nn_argmin on the fit")
    km_falling = all(b <= a * (1 + 1e-6) for a, b in zip(km_history, km_history[1:]))
    check(len(km_history) == km_iters and all(np.isfinite(km_history)) and km_falling
          and km_history[-1] < km_history[0] and np.isfinite(float(km_inertia)),
          f"kmeans inertia finite and falling over {km_iters} iterations "
          f"({km_history[0]:.6g} -> {km_history[-1]:.6g}, final {float(km_inertia):.6g})")
    am_fit = kernels.fused_l2_argmin(x, km_c, (km_c * km_c).sum(dim=1))[1]
    km_agree = float((am_fit.long() == km_labels.long()).float().mean())
    print(f"kmeans fit: {km_fit_s:.3f} s, {km_iters} iterations, "
          f"{km_fit_s * 1e3 / max(km_iters, 1):.3f} ms per Lloyd iteration; inertia by "
          f"iteration {json.dumps(km_history)}; kernel #7's labels (no |x|^2, no clamp) agree "
          f"with predict on {km_agree:.6f} of rows", flush=True)
    del am_fit

    # pairwise distances over every canonical metric, on the card and
    # (DIST_CPU_ROWS rows of x) on the CPU; (rtol, atol): Gram-term metrics
    # cancel terms near |x|^2 (~1e4 here) in another summation order
    cpu = Resources(device="cpu")
    dx, dy = x[:DIST_ROWS], x[DIST_ROWS:2 * DIST_ROWS]
    simplex = lambda t: t.clamp(min=0) / t.clamp(min=0).sum(dim=1, keepdim=True)
    latlon = lambda t: torch.stack([t[:, 0] / 20.0, t[:, 1] / 5.0], dim=1)   # radians
    metric_data = {"hellinger": simplex, "jensenshannon": simplex, "kl_divergence": simplex,
                   "jaccard": lambda t: (t > 5).float(), "dice": lambda t: (t > 5).float(),
                   "russellrao": lambda t: (t > 5).float(), "haversine": latlon,
                   "hamming": lambda t: torch.round(t / 4)}
    gram_tol, elem_tol = (1e-4, 1e-2), (1e-5, 1e-4)
    metric_tol = {"chebyshev": (0.0, 0.0), "hamming": (1e-6, 0.0), "jensenshannon": (1e-4, 1e-5),
                  "kl_divergence": (1e-4, 1e-5), "haversine": (1e-5, 1e-6),
                  "canberra": elem_tol, "l1": elem_tol, "minkowski": (1e-4, 1e-3),
                  "braycurtis": elem_tol}
    canon = sorted(set(distance.DISTANCE_TYPES.values()))
    dist_in = {m: (metric_data.get(m, lambda t: t)(dx), metric_data.get(m, lambda t: t)(dy))
               for m in canon}
    with phase("distance"):
        t0 = time.perf_counter()
        dist_out = {m: distance.pairwise_distance(*dist_in[m], metric=m, res=res) for m in canon}
        sync()
        dist_s = time.perf_counter() - t0
        fnn = distance.fused_l2_nn(x[:ARGMIN_ROWS], km_c, res=res)
        adj = torch.from_numpy(np.random.default_rng(SEED).random((ARGMIN_ROWS, KM_CLUSTERS))
                               < 0.5).to(dev)
        mnn = distance.masked_l2_nn_argmin(x[:ARGMIN_ROWS], km_c, adj, res=res)
    worst = {}
    for m in canon:
        a, b = dist_in[m]
        ref = distance.pairwise_distance(a[:DIST_CPU_ROWS].cpu(), b.cpu(), metric=m, res=cpu)
        got = dist_out[m][:DIST_CPU_ROWS].cpu()
        rtol, atol = metric_tol.get(m, gram_tol)
        worst[m] = float((got - ref).abs().max())
        check(tuple(dist_out[m].shape) == (DIST_ROWS, DIST_ROWS)
              and bool(torch.isfinite(dist_out[m]).all())
              and torch.allclose(got, ref, rtol=rtol, atol=atol),
              f"pairwise_distance {m} [{DIST_ROWS}, {DIST_ROWS}] within rtol {rtol} atol {atol} "
              f"of the CPU (max abs diff {worst[m]:.3e})")
    print(f"pairwise_distance, {len(canon)} metrics on {DIST_ROWS} x {DIST_ROWS} x "
          f"{dx.shape[1]}: {dist_s:.3f} s", flush=True)
    for tag, (v, i), ref in (
            ("fused_l2_nn", fnn, distance.fused_l2_nn(x[:ARGMIN_ROWS].cpu(), km_c.cpu(), res=cpu)),
            ("masked_l2_nn_argmin", mnn, distance.masked_l2_nn_argmin(
                x[:ARGMIN_ROWS].cpu(), km_c.cpu(), adj.cpu(), res=cpu))):
        agree = float((i.cpu() == ref[1]).float().mean())
        check(torch.allclose(v.cpu(), ref[0], rtol=1e-4, atol=1e-2) and agree >= ID_AGREE,
              f"{tag} {ARGMIN_ROWS} x {KM_CLUSTERS}: values within rtol 1e-4 atol 1e-2 of the "
              f"CPU, ids agree on {agree:.5f}")
    del dist_out, dist_in, adj

    # brute force over metrics past the fused kernel's: the tiled leg, its
    # selections on the select_k kernel
    bx, bq = x[:BF_ROWS], q[:BF_QUERIES]
    with phase("brute_force_metrics"):
        bfm = {m: brute_force.knn(bx, bq, K, metric=m, res=res) for m in BF_METRICS}
    check(kernels.consume_kernel_path() == "cuda", "brute force metrics routed to cuda")
    check(phase_launches["brute_force_metrics"]["select_k"] > 0
          and phase_launches["brute_force_metrics"]["fused_knn"] == 0,
          "brute force metrics launched select_k (the tiled leg), not fused_knn")
    for m, (v, i) in bfm.items():
        rv, ri = brute_force.knn(bx.cpu(), bq[:BF_CPU_QUERIES].cpu(), K, metric=m, res=cpu)
        v0, i0 = v[:BF_CPU_QUERIES].cpu(), i[:BF_CPU_QUERIES].cpu()
        # ids equal except at a value tie (in either run's list)
        gaps = torch.cat([torch.full((rv.shape[0], 1), float("inf")), rv.diff(dim=1).abs(),
                          torch.full((rv.shape[0], 1), float("inf"))], dim=1)
        untied = (gaps[:, :-1] > 1e-5 * rv.abs().clamp(min=1)) & (gaps[:, 1:] > 1e-5 * rv.abs().clamp(min=1))
        check(bool(torch.isfinite(v).all()) and torch.allclose(v0, rv, rtol=1e-5, atol=1e-4)
              and torch.equal(i0[untied], ri[untied]),
              f"brute force {m} [{BF_QUERIES}, {K}] over {BF_ROWS} rows: values within rtol 1e-5 "
              f"atol 1e-4 of the CPU, ids equal except at ties ({int((~untied).sum())} tied)")

    probe("kernel #7, the distance layer and flat k-means")

    # -- main path: IVF-Flat over 8-bit and bf16 rows ---------------------------
    x_u8 = torch.clamp(torch.round(x * U8_SCALE), 0, 255).to(torch.uint8)
    q_u8 = torch.clamp(torch.round(q * U8_SCALE), 0, 255)            # f32 queries
    rows8 = {"u8": (x_u8, q_u8), "s8": ((x_u8.to(torch.int16) - 128).to(torch.int8), q_u8 - 128),
             "bf16": (x_u8.to(torch.bfloat16), q_u8)}
    with phase("oracle_u8"):
        gt8_i = brute_force.knn(x_u8, q_u8, K, res=res)[1]
    check(phase_launches["oracle_u8"]["fused_knn"] > 0, "uint8 oracle launched fused_knn")
    # a shift by 128 leaves every L2 distance as it is, and bf16 holds these
    # integers exactly: one oracle serves all three
    idx8, out8, legs8 = {}, {}, {}
    for tag, (rows, qs8) in rows8.items():
        with phase(f"ivf_flat_{tag}_build"):
            idx8[tag] = ivf_flat.build(params, rows, res=res)
        check(idx8[tag].list_data.dtype == rows.dtype,
              f"ivf_flat {tag}: lists kept as {rows.dtype} (cap {idx8[tag].list_cap})")
        leg = {"u8": "_u8", "s8": "_s8", "bf16": "_bf16"}[tag]
        legs8[tag] = leg
        with phase(f"ivf_flat_{tag}"):
            out8[f"{tag} probe-major"] = ivf_flat.search(sp, idx8[tag], qs8, K, res=res)
            out8[f"{tag} query-major"] = batches(
                lambda qb, k, **kw: ivf_flat.search(sp, idx8[tag], qb, k, res=res, **kw), K,
                queries=qs8)[:2]
            out8[f"{tag} probe-major pass10"] = ivf_flat.search(sp, idx8[tag], qs8, K, res=res,
                                                                **filters["pass10"])
            out8[f"{tag} query-major pass10"] = batches(
                lambda qb, k, **kw: ivf_flat.search(sp, idx8[tag], qb, k, res=res, **kw), K,
                lambda b: filters["pass10"], qs8)[:2]
            out8[f"{tag} query-major table8"] = batches(
                lambda qb, k, **kw: ivf_flat.search(sp, idx8[tag], qb, k, res=res, **kw), K,
                lambda b: table_batches[b], qs8)[:2]
        check(kernels.consume_kernel_path() == "cuda", f"ivf_flat {tag} routed to cuda")
        pl = phase_launches[f"ivf_flat_{tag}"]
        for name in (f"ivf_scan_probe_major{leg}", f"ivf_scan_probe_major{leg}_filt",
                     f"ivf_scan_query_major{leg}", f"ivf_scan_query_major{leg}_filt",
                     f"ivf_scan_query_major{leg}_fid"):
            check(pl[name] > 0, f"ivf_flat {tag} launched {name}")
        stray = {n: c for n, c in pl.items() if c and n.startswith("ivf_scan") and leg not in n}
        check(not stray, f"ivf_flat {tag}: no other scan leg launched {stray or ''}")
        for sched in ("probe-major", "query-major"):
            r = recall_at_k(out8[f"{tag} {sched}"][1], gt8_i[:out8[f"{tag} {sched}"][1].shape[0]], K)
            out8[f"{tag} {sched} recall"] = r
            check(r >= 0.8, f"ivf_flat {tag} {sched} recall@{K} {r:.5f} >= 0.8 against the "
                  "uint8 oracle")
        for fname in ("pass10", "table8"):
            for name in [n for n in out8 if n.startswith(tag) and n.endswith(fname)]:
                ids = out8[name][1]
                ok = passes[fname](ids.long().clamp(min=0)) | (ids < 0)
                check(bool(ok.all()) and float((ids >= 0).float().mean()) >= 0.99,
                      f"ivf_flat {name}: no id fails its filter, >= 99 % filled")
    # the uint8 and bf16 indexes hold the same integers (bf16 holds them
    # exactly), so their builds train on the same f32 rows: the same ids.
    # (The int8 copy is shifted by 128, which moves k-means' rounding.)
    check(all(torch.equal(out8[f"u8 {s_}"][1], out8[f"bf16 {s_}"][1])
              for s_ in ("probe-major", "query-major")),
          "u8 and bf16 IVF-Flat (one set of integers) give the same ids on both schedules")
    # raft_tpu's format: a save / load round trip in memory
    buf = io.BytesIO()
    ivf_flat.save(buf, idx8["u8"])
    buf.seek(0)
    back = ivf_flat.load(buf, res=res)
    check(back.list_data.dtype == torch.uint8 and torch.equal(back.list_data, idx8["u8"].list_data)
          and same(ivf_flat.search(sp, back, q_u8, K, res=res), out8["u8 probe-major"]),
          f"ivf_flat u8 save -> load ({buf.tell()} bytes): uint8 lists, searches bitwise equal")
    del buf, back

    probe("IVF-Flat over 8-bit and bf16 rows")

    # -- main path: paged 8-bit IVF-Flat (the _u8_paged / _s8_paged legs) ---------
    # the uint8 and int8 indexes paginated as the f32 one: a pinned pool
    # holding every page (every search above, bitwise), and a quarter of the
    # pages served 8 queries at a time
    p8 = {}
    for tag in ("u8", "s8"):
        idx, qs8, leg = idx8[tag], rows8[tag][1], legs8[tag]
        p8[tag], pin8 = paginate(idx, f"paged_ivf_flat_{tag}")

        def p8_batches(kw_of=lambda b: {}, pidx=p8[tag], qs8=qs8):
            return batches(lambda qb, k, **kw: ivf_flat.search(sp, pidx, qb, k, res=res, **kw),
                           K, kw_of, qs8)[:2]

        with phase(f"paged_ivf_flat_{tag}"):
            got8 = {"probe-major": ivf_flat.search(sp, p8[tag], qs8, K, res=res),
                    "query-major": p8_batches(),
                    "probe-major pass10": ivf_flat.search(sp, p8[tag], qs8, K, res=res,
                                                          **filters["pass10"]),
                    "query-major pass10": p8_batches(lambda b: filters["pass10"]),
                    "query-major table8": p8_batches(lambda b: table_batches[b])}
        check(kernels.consume_kernel_path() == "cuda", f"paged_ivf_flat_{tag} routed to cuda")
        for name, out in got8.items():
            check(same(out, out8[f"{tag} {name}"]),
                  f"paged ivf_flat {tag} {name} bitwise equal to the monolithic search")
        pl = phase_launches[f"paged_ivf_flat_{tag}"]
        for name in (f"ivf_scan_probe_major{leg}_paged", f"ivf_scan_probe_major{leg}_paged_filt",
                     f"ivf_scan_query_major{leg}_paged", f"ivf_scan_query_major{leg}_paged_filt",
                     f"ivf_scan_query_major{leg}_paged_fid"):
            check(pl[name] > 0, f"paged ivf_flat {tag} launched {name}")
        stray = {n: c for n, c in pl.items() if c and n.startswith("ivf_scan") and "_paged" not in n}
        check(not stray, f"paged ivf_flat {tag}: no unpaged scan launched {stray or ''}")
        n_pages8, page_bytes8 = pin8.n_pages, pin8.store.page_bytes
        p_ov8, ov8 = paginate(idx, f"paged_ivf_flat_{tag}_over_budget", budget=MemoryBudget(
            max(1, int(OVER_BUDGET_FRACTION * n_pages8)) * page_bytes8 + 4 * n_pages8))
        check(ov8.slots < ov8.n_pages, f"paged ivf_flat {tag} over budget: {ov8.slots} slots of "
              f"{ov8.n_pages} pages")
        want8 = [ivf_flat.search(sp, idx, qs8[b:b + OVER_BUDGET_BATCH], K, res=res)
                 for b in over_starts]
        with phase(f"paged_ivf_flat_{tag}_over_budget"):
            ok8 = all(same(ivf_flat.search(sp, p_ov8, qs8[b:b + OVER_BUDGET_BATCH], K, res=res),
                           want8[i]) for i, b in enumerate(over_starts))
        st8 = ov8.stats()
        check(ok8 and st8["misses"] > 0 and st8["evictions"] > 0
              and phase_launches[f"paged_ivf_flat_{tag}_over_budget"][
                  f"ivf_scan_query_major{leg}_paged"] > 0,
              f"paged ivf_flat {tag} over budget: {len(want8)} batches of {OVER_BUDGET_BATCH} "
              f"bitwise equal to the monolithic search on ivf_scan_query_major{leg}_paged "
              f"({st8['misses']} misses, {st8['evictions']} evictions)")
        ov8.close()
        del p_ov8, ov8, want8, got8

    probe("paged 8-bit IVF-Flat")

    # -- main path: deep k (past the kernels' former 512) -------------------------
    dq = q[:DEEP_QUERIES]
    deep = {}
    with phase("deep_k"):
        for strategy in ("probe_major", "query_major"):
            deep[strategy] = ivf_flat.search(ivf_flat.SearchParams(n_probes=N_PROBES,
                                                                   strategy=strategy),
                                             index, dq, DEEP_IVF_K, res=res)
            check(kernels.consume_kernel_path() == "cuda", f"deep k {strategy} stamped cuda")
        # a serving batch at deep k: its probes split over blocks and merged
        # past k = 128 (merge_parts' radix select)
        deep_batch = ivf_flat.search(ivf_flat.SearchParams(n_probes=N_PROBES,
                                                           strategy="query_major"),
                                     index, q[:QM_BATCH], DEEP_IVF_K, res=res)
        deep["brute_force"] = brute_force.knn(x, dq, DEEP_BF_K, res=res)
        check(kernels.consume_kernel_path() == "cuda", "deep k brute force stamped cuda")
    check(torch.equal(deep_batch[0], deep["query_major"][0][:QM_BATCH])
          and torch.equal(deep_batch[1], deep["query_major"][1][:QM_BATCH]),
          f"deep k: a {QM_BATCH}-query batch (split and merged) equals the same queries "
          f"of the {DEEP_QUERIES}-query search")
    for name, kk_ in (("ivf_scan_probe_major", DEEP_IVF_K), ("ivf_scan_query_major", DEEP_IVF_K),
                      ("fused_knn", DEEP_BF_K)):
        check(phase_launches["deep_k"][name] > 0, f"deep k launched {name} (k {kk_})")
    for name, (v, i) in deep.items():
        k_ = DEEP_BF_K if name == "brute_force" else DEEP_IVF_K
        check(tuple(i.shape) == (DEEP_QUERIES, k_) and bool((i >= 0).all())
              and bool(torch.isfinite(v).all()),
              f"deep k {name} [{DEEP_QUERIES}, {k_}]: every slot filled")
    check(torch.equal(deep["probe_major"][1][:, :K], deep["query_major"][1][:, :K]),
          "deep k: both schedules agree on the first 10")

    probe("deep k")

    # -- main path: threads searching one paged index over budget ----------------
    t_batches = [q[b:b + OVER_BUDGET_BATCH] for b in range(0, THREAD_QUERIES, OVER_BUDGET_BATCH)]
    t_want = [ivf_flat.search(sp, index, qb, K, res=res) for qb in t_batches]
    sync()   # the threads' own streams do not wait on this one
    t_out, t_err = [[] for _ in range(THREADS)], []

    def searcher(t):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for j in range(len(t_batches)):
                    b = (j + t * len(t_batches) // THREADS) % len(t_batches)
                    v, i = ivf_flat.search(sp, p_over, t_batches[b], K, res=res)
                    stream.synchronize()
                    t_out[t].append((b, v, i))
        except Exception as e:  # surfaced by the check below
            t_err.append(repr(e))

    with phase("paged_threads"):
        t0 = time.perf_counter()
        workers = [threading.Thread(target=searcher, args=(t,)) for t in range(THREADS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        threads_s = time.perf_counter() - t0
    t_ok = not t_err and all(len(o) == len(t_batches) for o in t_out) and all(
        same((v, i), t_want[b]) for o in t_out for b, v, i in o)
    check(t_ok, f"{THREADS} threads on their own streams x {len(t_batches)} batches of "
          f"{OVER_BUDGET_BATCH} over budget: bitwise the single-thread results {t_err or ''}")
    check(phase_launches["paged_threads"]["ivf_scan_query_major_paged"] > 0,
          "paged threads launched ivf_scan_query_major_paged")
    print(f"paged threads: {THREADS} x {len(t_batches)} batches in {threads_s:.3f} s; "
          f"pager {json.dumps(over_pager.stats())}", flush=True)
    del t_want, t_out

    probe("threads over one paged index")

    # -- main path: CAGRA over 8-bit rows (BIGANN's uint8) -----------------------
    # raft's defaults over the uint8 rows of the 8-bit IVF-Flat phases: the
    # index keeps 1 byte a value and the walk reads the rows on the hop
    # kernel's uint8 leg; the same graph over the rows shifted to int8 (every
    # L2 distance as it was) serves the int8 leg
    with phase("cagra_u8_build"):
        cg8 = cagra.build(cagra_params, x_u8, res=res)
    g8 = cg8.graph
    g8_sorted = torch.sort(g8, dim=1).values
    check(cg8.dataset.dtype == torch.uint8 and cg8.dataset.element_size() == 1
          and tuple(g8.shape) == (x.shape[0], cagra_params.graph_degree)
          and bool((g8 >= 0).all()) and bool((g8 < x.shape[0]).all())
          and bool((g8 != torch.arange(x.shape[0], device=dev)[:, None]).all())
          and bool((g8_sorted[:, 1:] != g8_sorted[:, :-1]).all()),
          f"cagra uint8: rows kept as uint8, graph {tuple(g8.shape)} with no -1, self edge or "
          "repeated edge")
    check(phase_launches["cagra_u8_build"]["ivf_scan_probe_major_bf16"] > 0
          and phase_launches["cagra_u8_build"]["select_k"] > 0
          and phase_launches["cagra_u8_build"]["fused_knn"] > 0,
          "cagra uint8 build ran the IVF-PQ graph build, refine and entry points on their kernels")
    del g8_sorted
    q_s8 = q_u8 - 128
    cg_s8 = cagra.Index(cg8.metric, rows8["s8"][0], g8, cg8.entry_centers - 128, cg8.entry_ids)
    out_cg8 = {}
    with phase("cagra_u8_search"):
        out_cg8["u8"] = cagra.search(cagra_sp, cg8, q_u8, K, res=res)
    walk_launches("cagra_u8_search", expected_tiles(q.shape[0]))
    with phase("cagra_s8_search"):
        out_cg8["s8"] = cagra.search(cagra_sp, cg_s8, q_s8, K, res=res)
    walk_launches("cagra_s8_search", expected_tiles(q.shape[0]))
    for tag in ("u8", "s8"):
        r = recall_at_k(out_cg8[tag][1], gt8_i, K)
        out_cg8[f"{tag} recall"] = r
        check(r >= CAGRA_RECALL, f"cagra {tag} recall@{K} {r:.5f} >= {CAGRA_RECALL} against the "
              "uint8 oracle")
    p_cg8 = {}
    for tag, idx_ in (("u8", cg8), ("s8", cg_s8)):
        p_cg8[tag], _ = paginate(idx_, f"paged_cagra_{tag}")
        qs8 = q_u8 if tag == "u8" else q_s8
        with phase(f"paged_cagra_{tag}"):
            got8 = cagra.search(cagra_sp, p_cg8[tag], qs8, K, res=res)
        check(same(got8, out_cg8[tag]), f"paged cagra {tag}: bitwise the dense search")
        walk_launches(f"paged_cagra_{tag}", expected_tiles(q.shape[0]), "_paged")
    with phase("cagra_u8_hop"):
        hop8_args = capture_hop(cg8, q.shape[0], queries=q_u8)
        hop8_out = ct.cagra_fused_hop(*hop8_args, metric=metric)
    check(phase_launches["cagra_u8_hop"]["cagra_fused_hop"] == 1,
          "cagra uint8 hop by hop: one hop launch")
    del got8

    main_launches = {
        name: sum(p[name] for p in phase_launches.values()) for name in kernels.KERNELS
    }

    probe("CAGRA over 8-bit rows")

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
    check(all(r >= CAGRA_RECALL for name, r in recall.items() if name.startswith("cagra")),
          f"recall@10 of both CAGRA searches >= {CAGRA_RECALL}")

    # filtered searches: no leak, filled, recall against the filtered oracle
    def leak_free(ids, fname):
        """No id fails its query's filter and no id repeats in a row."""
        ok = passes[fname](ids.long().clamp(min=0)) | (ids < 0)
        srt = torch.sort(ids, dim=1).values
        return bool(ok.all()) and not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any())

    for fname, gi in filt_gt.items():
        check(leak_free(gi, fname) and bool((gi >= 0).all()),
              f"filtered oracle {fname}: no leaked or repeated id, every slot filled")
    filt_recall, filt_fill = {}, {}
    spec_filter = {spec[1]: spec[3] for spec in filt_specs}
    for name, (v, i) in filt_out.items():
        fname = spec_filter[name]
        rows = i.shape[0]
        check(tuple(v.shape) == (rows, K) and bool(torch.isfinite(v[i >= 0]).all())
              and leak_free(i, fname),
              f"{name} [{rows}, {K}]: no leaked or repeated id, finite where filled")
        filt_fill[name] = float((i >= 0).float().mean())
        filt_recall[name] = recall_at_k(i, filt_gt[fname][:rows], K)
        print(f"recall@{K} {name}: {filt_recall[name]:.5f} (filled {filt_fill[name]:.5f})",
              flush=True)
    check(min(filt_fill.values()) >= 0.99, "every filtered search fills >= 99 % of its slots")
    floor_names = [name for name in filt_recall
                   if (name.startswith(("ivf_flat", "cagra")) or name.endswith("+ refine"))
                   and spec_filter[name] in ("pass50", "pass10")]
    check(all(filt_recall[name] >= FILTER_RECALL for name in floor_names),
          f"recall@10 >= {FILTER_RECALL} of {len(floor_names)} filtered IVF-Flat, refined IVF-PQ "
          f"and CAGRA searches at pass50 / pass10")

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

    probe("the outputs' recall")

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

    probe("the build's reproducibility")

    # -- the same searches with every kernel replaced by its plain version --
    @contextlib.contextmanager
    def plain_versions():
        saved = (sk.select_k_kernel, scan.ivf_scan_probe_major, scan.ivf_scan_query_major,
                 cagra.cagra_traverse_steps)
        sk.select_k_kernel = lambda *a, **kw: sk.select_k_torch(*a, **kw)
        scan.ivf_scan_probe_major = scan.ivf_scan_probe_major_torch
        scan.ivf_scan_query_major = scan.ivf_scan_query_major_torch
        cagra.cagra_traverse_steps = ct.cagra_traverse_steps_torch
        try:
            yield
        finally:
            (sk.select_k_kernel, scan.ivf_scan_probe_major, scan.ivf_scan_query_major,
             cagra.cagra_traverse_steps) = saved

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
    def cagra_recalls():
        """CAGRA recall@K on the first CAGRA_SUBSET queries at SearchParams()
        and at the low-effort setting."""
        qs = q[:CAGRA_SUBSET]
        out = {}
        for tag, sp in (("itopk 64", cagra_sp), ("itopk 16, 4 hops",
                                                 cagra.SearchParams(**CAGRA_LOW))):
            i = cagra_search(sp)(qs, K)[1]
            out[f"cagra {tag}"] = recall_at_k(i, gt_i[:CAGRA_SUBSET], K)
        return out

    # at 20 probes the filtered IVF-Flat searches give recall ~1.0 on any
    # path; at LOW_PROBES the kernel-vs-plain comparison of both filter legs
    # can fail
    sp_low = ivf_flat.SearchParams(n_probes=LOW_PROBES)

    def low_filtered():
        i_pm = ivf_flat.search(sp_low, index, q, K, res=res, **filters["pass10"])[1]
        i_fid = batches(lambda qb, k, **kw: ivf_flat.search(sp_low, index, qb, k, res=res, **kw),
                        K, lambda b: table_batches[b])[1]
        return {f"ivf_flat probe-major pass10 n_probes={LOW_PROBES}":
                recall_at_k(i_pm, filt_gt["pass10"], K),
                f"ivf_flat query-major table8 n_probes={LOW_PROBES}":
                recall_at_k(i_fid, filt_gt["table8"], K)}

    kernel_low = recalls(LOW_PROBES)
    kernel_cagra = cagra_recalls()
    kernel_low_filt = low_filtered()
    check(max(kernel_low_filt.values()) < 0.95,
          f"filtered IVF-Flat recall at n_probes={LOW_PROBES} is below 0.95 (the comparison "
          "can fail)")
    kernels.reset_launch_counts()
    with plain_versions():
        plain_main = recalls(N_PROBES)
        plain_low = recalls(LOW_PROBES)
        plain_cagra = cagra_recalls()
        plain_filt = {f"filtered oracle {fname}": recall_at_k(
            brute_force.knn(x, q[:gi.shape[0]], K, res=res,
                            **(t_all if fname == "table8" else filters[fname]))[1], gi, K)
            for fname, gi in filt_gt.items()}
        for _, name, fn, fname, _ in filt_specs:
            i = fn()[1]
            plain_filt[name] = recall_at_k(i, filt_gt[fname][:i.shape[0]], K)
        plain_filt.update(low_filtered())
    check(sum(kernels.launch_counts().values()) == 0, "plain path launched no kernel")
    kernel_filt = dict(filt_recall, **kernel_low_filt,
                       **{f"filtered oracle {fname}": 1.0 for fname in filt_gt})
    recall_table = {}
    for n_probes, kern, plain in ((N_PROBES, recall, plain_main),
                                  (LOW_PROBES, kernel_low, plain_low),
                                  (None, kernel_cagra, plain_cagra),
                                  ("filtered", kernel_filt, plain_filt)):
        for name in plain:
            tag = (name if n_probes == "filtered" else f"{name} n_probes={n_probes}" if n_probes
                   else f"{name}, {CAGRA_SUBSET} queries")
            recall_table[tag] = [kern[name], plain[name]]
            print(f"recall@{K} {tag}: kernel path {kern[name]:.5f}, "
                  f"plain path {plain[name]:.5f}", flush=True)
            check(abs(kern[name] - plain[name]) <= 0.005,
                  f"{tag}: kernel-path recall within 0.005 of the plain path")
    check(kernel_cagra["cagra itopk 16, 4 hops"] < 0.95,
          "cagra low-effort recall is below 0.95 (the comparison can fail)")
    # the 8-bit and bf16 IVF-Flat searches on the plain versions, at 20 and
    # LOW_PROBES probes (where recall is below 1, so the comparison can fail)
    sp_low8 = ivf_flat.SearchParams(n_probes=LOW_PROBES)

    def recalls8():
        out = {}
        for tag, (_, qs8) in rows8.items():
            for sp_, tag_p in ((sp, N_PROBES), (sp_low8, LOW_PROBES)):
                i_pm = ivf_flat.search(sp_, idx8[tag], qs8, K, res=res)[1]
                i_qm = batches(lambda qb, k: ivf_flat.search(sp_, idx8[tag], qb, k, res=res), K,
                               queries=qs8)[1]
                out[f"ivf_flat {tag} probe-major n_probes={tag_p}"] = recall_at_k(i_pm, gt8_i, K)
                out[f"ivf_flat {tag} query-major n_probes={tag_p}"] = recall_at_k(
                    i_qm, gt8_i[:i_qm.shape[0]], K)
        # CAGRA over uint8 / int8 rows on its first CAGRA_SUBSET queries
        for tag, idx_c, qs_c in (("u8", cg8, q_u8), ("s8", cg_s8, q_s8)):
            for sp_, tag_s in ((cagra_sp, "itopk 64"),
                               (cagra.SearchParams(**CAGRA_LOW), "itopk 16, 4 hops")):
                i_c = cagra.search(sp_, idx_c, qs_c[:CAGRA_SUBSET], K, res=res)[1]
                out[f"cagra {tag} {tag_s}, {CAGRA_SUBSET} queries"] = recall_at_k(
                    i_c, gt8_i[:CAGRA_SUBSET], K)
        return out

    kernel8 = recalls8()
    kernels.reset_launch_counts()
    with plain_versions():
        plain8 = recalls8()
    check(sum(kernels.launch_counts().values()) == 0, "plain 8-bit path launched no kernel")
    for name, r in kernel8.items():
        recall_table[name] = [r, plain8[name]]
        print(f"recall@{K} {name}: kernel path {r:.5f}, plain path {plain8[name]:.5f}",
              flush=True)
        check(abs(r - plain8[name]) <= 0.005, f"{name}: kernel-path recall within 0.005 of the "
              "plain path")
    check(min(r for n, r in kernel8.items() if f"={LOW_PROBES}" in n) < 0.95,
          f"8-bit IVF-Flat recall at n_probes={LOW_PROBES} is below 0.95 (the comparison can fail)")
    check(min(r for n, r in kernel8.items() if "4 hops" in n) < 0.95,
          "cagra 8-bit low-effort recall is below 0.95 (the comparison can fail)")
    print(json.dumps({"recall_kernel_vs_plain": recall_table}), flush=True)

    probe("the plain versions' searches")

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

    def bitwise(name, kv, ki, pv, pi, what="the plain version"):
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"{name} values and ids bitwise equal to {what}")
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

    def wide_entry(shape, err, kernel_fn, plain_fn, work, library_fn=None, reps=(10, 2)):
        """One measurement of a kernel at another shape than its recorded
        one (a widened k): times of kernel, plain version and library call,
        and the bound of its work."""
        bound, by = cost.bound_ms(work)
        return {"shape": shape, "max_abs_err": err, "ms": cuda_ms(kernel_fn, reps[0]),
                "plain_ms": cuda_ms(plain_fn, reps[1]), "bound_ms": bound, "bound_by": by,
                "library_ms": cuda_ms(library_fn, reps[0]) if library_fn else None}

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
    # select_k at CAGRA's refine shape: k=129 of 258 exact distances per row
    _, cand_w = pq_search(*PQ_MAIN)(q, WIDE_KK)
    dist_w = refine_mod._distances(q, x[cand_w.long()], metric)
    kv, ki = sk.select_k_kernel(dist_w, WIDE_K, input_indices=cand_w)
    pv, pi = sk.select_k_torch(dist_w, WIDE_K, input_indices=cand_w)
    wide = [wide_entry(
        f"[{dist_w.shape[0]}, {dist_w.shape[1]}] k={WIDE_K} with ids (refine)",
        bitwise(f"select_k {tuple(dist_w.shape)} k={WIDE_K}", kv, ki, pv, pi),
        lambda: sk.select_k_kernel(dist_w, WIDE_K, input_indices=cand_w),
        lambda: sk.select_k_torch(dist_w, WIDE_K, input_indices=cand_w),
        cost.select_k_work(*dist_w.shape, WIDE_K, with_ids=True),
        lambda: torch.topk(dist_w, WIDE_K, dim=1, largest=False))]
    # the graph build's probe-major merge, [rows, 32 probes x 258] k=258: past
    # the kernel's 8192-wide rows, matrix.select_k takes the chunked path
    ip_b, sp_b, top_b = cagra._graph_build_ivf_pq_params(cagra_params, *x.shape)
    qt_b = cagra._graph_build_qtile(res, *x.shape)
    _, bucket_b, _, _ = _common.select_scan_strategy(
        "auto", qt_b, sp_b.n_probes, pq_index.n_lists, pq_index.list_cap, pq_index.rot_dim,
        res.workspace_limit_bytes, k=top_b)
    args_b, pair_b = ivf_pq.probe_major_scan_inputs(pq_index, x[:qt_b], sp_b.n_probes, top_b,
                                                    bucket_b)
    kk_b = args_b[-1]
    vb, ib = scan.ivf_scan_probe_major(*args_b, metric=metric, **ivf_pq.scan_kwargs(pq_index))
    pv_b, pi_b = _common.scatter_pair_partials(vb.reshape(-1, kk_b), ib.reshape(-1, kk_b),
                                               pair_b, qt_b, sp_b.n_probes, kk_b)
    k_b = min(top_b, pv_b.shape[1])
    chunked_ms = cuda_ms(lambda: matrix.select_k(pv_b, k_b, input_indices=pi_b), 5)
    chunked_bound = cost.bound_ms(cost.select_k_work(*pv_b.shape, k_b, with_ids=True))
    topk_ms = cuda_ms(lambda: torch.topk(pv_b, k_b, dim=1, largest=False), 5)
    wide.append({"shape": f"[{pv_b.shape[0]}, {pv_b.shape[1]}] k={k_b} (build merge)",
                 "path": "matrix.select_k chunked (torch.sort), no kernel", "ms": chunked_ms,
                 "bound_ms": chunked_bound[0], "bound_by": chunked_bound[1],
                 "library_ms": topk_ms})
    print(f"build merge {tuple(pv_b.shape)} k={k_b}: chunked path {chunked_ms:.3f} ms, "
          f"torch.topk {topk_ms:.3f} ms", flush=True)
    del args_b, vb, ib, pv_b, pi_b, pair_b
    record("select_k", "raft_tpu_torch/csrc/select_k.cu", "raft_tpu/kernels/select_k.py:168",
           err, ms, plain_ms, cost.select_k_work(cs.shape[0], cs.shape[1], N_PROBES),
           cost.select_k_cost(cs.shape[0], cs.shape[1], N_PROBES),
           lib_ms, f"[{cs.shape[0]}, {cs.shape[1]}] k={N_PROBES}", wide=wide)

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
    # k=129: CAGRA's exact graph build (build_algo="brute_force")
    kv, ki = fk.fused_l2_topk(qs_t, x, xx, WIDE_K)
    pv, pi = fk.fused_l2_topk_torch(qs_t, x, xx, WIDE_K)
    wide = [wide_entry(
        f"q [{FUSED_SUBSET}, 128] x [1000000, 128] k={WIDE_K}",
        close(f"fused_knn k={WIDE_K}", kv, ki, pv, pi),
        lambda: fk.fused_l2_topk(qs_t, x, xx, WIDE_K),
        lambda: fk.fused_l2_topk_torch(qs_t, x, xx, WIDE_K),
        cost.fused_knn_work(FUSED_SUBSET, x.shape[0], x.shape[1], WIDE_K),
        lambda: torch.topk(torch.cdist(qs_t, x), WIDE_K, dim=1, largest=False), reps=(5, 1))]
    record("fused_knn", "raft_tpu_torch/csrc/fused_knn.cu", "raft_tpu/kernels/fused_knn.py:121",
           err, ms, plain_ms, cost.fused_knn_work(FUSED_SUBSET, x.shape[0], x.shape[1], K),
           cost.fused_knn_cost(FUSED_SUBSET, x.shape[0], x.shape[1], K),
           lib_ms, f"q [{FUSED_SUBSET}, 128] x [1000000, 128] k={K}", wide=wide)

    def scan_leg(schedule, name, idx, arg_sets, compare, legs, filt_of=None, filt_tag="",
                 replaces=None, dense=None):
        """Kernel vs plain for one C entry of ``schedule`` on the main
        path's inputs ``arg_sets`` (the 10,000-query probe-major block, or
        the 20 serving batches), timed on the first.  ``legs``: (scan_kw,
        compute) pairs of the entry; the first is recorded, the others
        measured beside it.  ``filt_of(b)``: the filter arguments
        (``list_filter``, ``query_fid``) of arg set b, for a filter leg.
        ``dense``: for a paged leg (``idx`` paginated, the arg sets holding
        its PagedLists), the same rows as one device tensor: the unpaged
        kernel runs on them beside the paged one, must agree bitwise, and
        is timed beside it."""
        kernel = getattr(scan, f"ivf_scan_{schedule}")
        plain = getattr(scan, f"ivf_scan_{schedule}_torch")
        filt_of = filt_of or (lambda b: {})
        args = arg_sets[0]
        kk, width = args[-1], args[1].shape[-1]
        itemsize = idx.list_data.element_size()
        list_rows = (idx.list_index >= 0).sum(dim=1)
        if schedule == "probe_major":
            B, G = args[1].shape[:2]
            live = int(torch.isfinite(args[2]).any(dim=1).sum())
            probes = _common.coarse_select(q, idx.centers, metric, N_PROBES)
            out_rows, raft_blocks, reps = probes.numel(), (live, G), (5, 1)
            replaces = replaces or "raft_tpu/kernels/ivf_scan.py:375"
            shape = f"B={B} ({live} non-empty) G={G}"
        else:
            probes = args[0]
            out_rows, raft_blocks, reps = probes.shape[0], (probes.numel(), 1), (10, 2)
            replaces = replaces or ("raft_tpu/kernels/ivf_scan.py:580" if "query_fid" in filt_of(0)
                                    else "raft_tpu/kernels/ivf_scan.py:649")
            shape = f"Q={out_rows} P={N_PROBES}"
        f0 = filt_of(0)
        cap_w = -(-idx.list_cap // 32) if f0 else 0
        unpaged_args = None if dense is None else args[:3] + (dense,) + args[4:]
        measured = []
        for kw, comp in legs:
            scan_dtype = kw.get("scan_dtype", "highest")
            outs = [(kernel(*a, metric=metric, **kw, **filt_of(b)),
                     plain(*a, metric=metric, **kw, **filt_of(b)))
                    for b, a in enumerate(arg_sets)]
            err_ = compare(f"{name} {scan_dtype} products",
                           *(torch.cat([o[s][j] for o in outs]) for s in (0, 1) for j in (0, 1)))
            work_kw = dict(itemsize=itemsize, compute=comp, cap_w=cap_w,
                           query_fid=f0.get("query_fid"))
            extra = {}
            if dense is None:
                work = cost.scan_work(probes, list_rows, width, out_rows, kk, **work_kw)
            else:
                work = cost.scan_paged_work(
                    probes, list_rows, width, out_rows, kk, **work_kw,
                    blocks=raft_blocks[0], pages_per_list=idx.paged.pages_per_list)
                got = kernel(*args, metric=metric, **kw, **f0)
                ref = kernel(*unpaged_args, metric=metric, **kw, **f0)
                bitwise(f"{name} {scan_dtype} products", *got, *ref,
                        what="the unpaged kernel on the same rows")
                extra["unpaged_ms"] = cuda_ms(
                    lambda: kernel(*unpaged_args, metric=metric, **kw, **f0), reps[0])
            raft = dataclasses.replace(cost.ivf_scan_cost(
                *raft_blocks, idx.list_cap, width, kk, itemsize=itemsize, cap_w=cap_w),
                compute=comp)
            measured.append((scan_dtype, err_,
                             cuda_ms(lambda: kernel(*args, metric=metric, **kw, **f0), reps[0]),
                             cuda_ms(lambda: plain(*args, metric=metric, **kw, **f0), reps[1]),
                             work, raft, extra))
        (scan_dtype, err_, ms_, plain_, work, raft, extra), *others = measured
        also = [dict(zip(("scan_dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"),
                         (o[0], o[1], o[2], o[3], *cost.bound_ms(o[4]))), **o[6]) for o in others]
        source = next(f"raft_tpu_torch/csrc/ivf_scan_{src}.cu" for leg, src in (
            ("_bf16", "bf16"), ("_int8", "int8"), ("_u8", "8bit"), ("_s8", "8bit"), ("", "f32"))
            if leg in name)
        record(name, source, replaces, err_, ms_, plain_, work, raft,
               None, f"{shape} cap={idx.list_cap} d={width} kk={kk} rows {idx.list_data.dtype}"
               + (f", filter {filt_tag}" if filt_tag else "")
               + (f", paged {idx.paged.pages_per_list} x {PAGE_ROWS}-row pages a list"
                  if dense is not None else ""),
               scan_dtype=scan_dtype, **extra, **({"also": also} if also else {}))

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

    # the filter legs, on the filtered main path's inputs: pass10 words on
    # both schedules, the table8 planes with each serving query's fid
    def filter_inputs(idx):
        """(pass10 words [L, cap_w], table8 planes [8, L, cap_w]) of an
        index's lists, packed as its searches pack them."""
        return (scan.pack_list_filter(idx.list_index, filters["pass10"]["sample_filter"].words),
                scan.pack_list_filter_table(idx.list_index, table_words))

    def fid_of(planes):
        return lambda b: dict(list_filter=planes,
                              query_fid=fid[b * QM_BATCH:(b + 1) * QM_BATCH].to(torch.int32))

    lf10, planes8 = filter_inputs(index)
    scan_leg("probe_major", "ivf_scan_probe_major_filt", index, [pm_args], close,
             [({}, "float32")], lambda b: dict(list_filter=lf10), "pass10")
    flat_qm_sets = serving_batches(
        lambda qb: ivf_flat.query_major_scan_inputs(index, qb, N_PROBES, K))
    scan_leg("query_major", "ivf_scan_query_major_filt", index, flat_qm_sets, close,
             [({}, "float32")], lambda b: dict(list_filter=lf10), "pass10")
    scan_leg("query_major", "ivf_scan_query_major_fid", index, flat_qm_sets, close,
             [({}, "float32")], fid_of(planes8), "table8, each query's plane")
    for name, idx, legs in (
        ("bf16", bf16, [(ivf_pq.scan_kwargs(bf16, "bfloat16"), "bfloat16"),
                        (ivf_pq.scan_kwargs(bf16, "float32"), "float32")]),
        ("int8", i8, [(ivf_pq.scan_kwargs(i8), "int8")]),
    ):
        lf_pq, planes_pq = filter_inputs(idx)
        args, _ = ivf_pq.probe_major_scan_inputs(idx, q, N_PROBES, K, pq_bucket)
        scan_leg("probe_major", f"ivf_scan_probe_major_{name}_filt", idx, [args], bitwise, legs,
                 lambda b: dict(list_filter=lf_pq), "pass10")
        pq_qm_sets = serving_batches(
            lambda qb: ivf_pq.query_major_scan_inputs(idx, qb, N_PROBES, K))
        scan_leg("query_major", f"ivf_scan_query_major_{name}_filt", idx, pq_qm_sets, bitwise,
                 legs, lambda b: dict(list_filter=lf_pq), "pass10")
        scan_leg("query_major", f"ivf_scan_query_major_{name}_fid", idx, pq_qm_sets, bitwise,
                 legs, fid_of(planes_pq), "table8, each query's plane")
    del lf10, planes8, flat_qm_sets, lf_pq, planes_pq, pq_qm_sets

    # the paged legs (#4, and query-major's paged read) on the paged main
    # path's inputs, each beside the unpaged kernel on the same rows
    paged_pm = "raft_tpu/kernels/ivf_scan.py:278"
    for tag, idx, legs in (
        ("", p_flat, [({}, "float32")]),
        ("_bf16", p_pq["bfloat16"], [(ivf_pq.scan_kwargs(bf16, "bfloat16"), "bfloat16"),
                                     (ivf_pq.scan_kwargs(bf16, "float32"), "float32")]),
        ("_int8", p_pq["int8"], [(ivf_pq.scan_kwargs(i8), "int8")]),
    ):
        dense = idx.list_data.to(dev)
        lf_p, planes_p = filter_inputs(idx)
        if tag:
            args, _ = ivf_pq.probe_major_scan_inputs(idx, q, N_PROBES, K, pq_bucket)
            qm_sets = serving_batches(
                lambda qb: ivf_pq.query_major_scan_inputs(idx, qb, N_PROBES, K))
        else:
            args, _ = ivf_flat.probe_major_scan_inputs(idx, q, N_PROBES, K, bucket)
            qm_sets = serving_batches(
                lambda qb: ivf_flat.query_major_scan_inputs(idx, qb, N_PROBES, K))
        scan_leg("probe_major", f"ivf_scan_probe_major{tag}_paged", idx, [args], bitwise, legs,
                 replaces=paged_pm, dense=dense)
        scan_leg("probe_major", f"ivf_scan_probe_major{tag}_paged_filt", idx, [args], bitwise,
                 legs, lambda b: dict(list_filter=lf_p), "pass10", replaces=paged_pm, dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major{tag}_paged", idx, qm_sets, bitwise, legs,
                 dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major{tag}_paged_filt", idx, qm_sets, bitwise,
                 legs, lambda b: dict(list_filter=lf_p), "pass10", dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major{tag}_paged_fid", idx, qm_sets, bitwise,
                 legs, fid_of(planes_p), "table8, each query's plane", dense=dense)
        del dense, lf_p, planes_p, args, qm_sets

    # probe-major at kk=258 (the CAGRA build's scan), on the kk=10 row's
    # queries and buckets: f32 rows (IVF-Flat) and bf16 rows with f32
    # products (the build's leg)
    def wide_scan(name, idx, args, compare, kw):
        kernel = lambda: scan.ivf_scan_probe_major(*args, metric=metric, **kw)
        plain = lambda: scan.ivf_scan_probe_major_torch(*args, metric=metric, **kw)
        kv, ki = kernel()
        pv, pi = plain()
        probes = _common.coarse_select(q, idx.centers, metric, N_PROBES)
        work = cost.scan_work(probes, (idx.list_index >= 0).sum(dim=1), args[1].shape[-1],
                              probes.numel(), WIDE_KK, itemsize=idx.list_data.element_size())
        entry = wide_entry(f"B={args[1].shape[0]} G={args[1].shape[1]} kk={WIDE_KK}",
                           compare(f"{name} kk={WIDE_KK}", kv, ki, pv, pi), kernel, plain,
                           work, reps=(5, 1))
        next(r for r in results if r["name"] == name).setdefault("wide", []).append(entry)

    wide_scan("ivf_scan_probe_major", index,
              ivf_flat.probe_major_scan_inputs(index, q, N_PROBES, WIDE_KK, bucket)[0], close, {})
    wide_scan("ivf_scan_probe_major_bf16", bf16,
              ivf_pq.probe_major_scan_inputs(bf16, q, N_PROBES, WIDE_KK, pq_bucket)[0], bitwise,
              ivf_pq.scan_kwargs(bf16, "float32"))

    # the raw 8-bit legs (IVF-Flat over uint8 / int8 rows), unfiltered and on
    # both filter legs, on the 8-bit main path's inputs: bitwise
    raw_kw = [({"scan_scale": None}, "float32")]
    for tag in ("u8", "s8"):
        idx, qs8 = idx8[tag], rows8[tag][1]
        args8, _ = ivf_flat.probe_major_scan_inputs(idx, qs8, N_PROBES, K, bucket)
        sets8 = [ivf_flat.query_major_scan_inputs(idx, qs8[b * QM_BATCH:(b + 1) * QM_BATCH],
                                                  N_PROBES, K) for b in range(QM_BATCHES)]
        lf8, planes8_ = filter_inputs(idx)
        scan_leg("probe_major", f"ivf_scan_probe_major_{tag}", idx, [args8], bitwise, raw_kw)
        scan_leg("probe_major", f"ivf_scan_probe_major_{tag}_filt", idx, [args8], bitwise, raw_kw,
                 lambda b: dict(list_filter=lf8), "pass10")
        scan_leg("query_major", f"ivf_scan_query_major_{tag}", idx, sets8, bitwise, raw_kw)
        scan_leg("query_major", f"ivf_scan_query_major_{tag}_filt", idx, sets8, bitwise, raw_kw,
                 lambda b: dict(list_filter=lf8), "pass10")
        scan_leg("query_major", f"ivf_scan_query_major_{tag}_fid", idx, sets8, bitwise, raw_kw,
                 fid_of(planes8_), "table8, each query's plane")
        del args8, sets8, lf8, planes8_
        # the same legs read through the pinned pool's page table, beside the
        # unpaged kernel on the same rows
        idx = p8[tag]
        dense = idx.list_data.to(dev)
        args8, _ = ivf_flat.probe_major_scan_inputs(idx, qs8, N_PROBES, K, bucket)
        sets8 = [ivf_flat.query_major_scan_inputs(idx, qs8[b * QM_BATCH:(b + 1) * QM_BATCH],
                                                  N_PROBES, K) for b in range(QM_BATCHES)]
        lf8, planes8_ = filter_inputs(idx)
        scan_leg("probe_major", f"ivf_scan_probe_major_{tag}_paged", idx, [args8], bitwise,
                 raw_kw, replaces=paged_pm, dense=dense)
        scan_leg("probe_major", f"ivf_scan_probe_major_{tag}_paged_filt", idx, [args8], bitwise,
                 raw_kw, lambda b: dict(list_filter=lf8), "pass10", replaces=paged_pm,
                 dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major_{tag}_paged", idx, sets8, bitwise, raw_kw,
                 dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major_{tag}_paged_filt", idx, sets8, bitwise,
                 raw_kw, lambda b: dict(list_filter=lf8), "pass10", dense=dense)
        scan_leg("query_major", f"ivf_scan_query_major_{tag}_paged_fid", idx, sets8, bitwise,
                 raw_kw, fid_of(planes8_), "table8, each query's plane", dense=dense)
        del args8, sets8, lf8, planes8_, dense

    # the float legs of #3 / #4 (product and fold redesigned together),
    # bitwise their plain versions at each fold's kk and its edges: the first
    # PM_SWEEP_QUERIES queries of each leg's main-path inputs at kk in
    # PM_SWEEP_KK, monolithic, through the pinned pool's page table, with the
    # pass10 filter, and both; then synthetic lists at the tile's edges
    t_sweep = time.perf_counter()
    swept = pm_sweep(
        [("float32", index, p_flat, ivf_flat, q, {}),
         ("bfloat16, bfloat16 products", bf16, p_pq["bfloat16"], ivf_pq, q,
          ivf_pq.scan_kwargs(bf16, "bfloat16")),
         ("bfloat16, float32 products", bf16, p_pq["bfloat16"], ivf_pq, q,
          ivf_pq.scan_kwargs(bf16, "float32")),
         ("uint8", idx8["u8"], p8["u8"], ivf_flat, rows8["u8"][1], {"scan_scale": None}),
         ("int8 values", idx8["s8"], p8["s8"], ivf_flat, rows8["s8"][1], {"scan_scale": None})],
        lambda idx: filter_inputs(idx)[0], metric, res)
    check(all(ok_ for _, ok_ in swept), f"probe-major float legs bitwise their plain versions "
          f"at kk {PM_SWEEP_KK} on {PM_SWEEP_QUERIES} queries, monolithic, paged, pass10 and "
          f"both ({len(swept)} launches, {time.perf_counter() - t_sweep:.1f} s; failed: "
          f"{[n_ for n_, ok_ in swept if not ok_]})")
    edge = pm_tile_edges(dev, scan)
    check(all(ok_ for _, ok_ in edge), f"probe-major float legs bitwise their plain versions "
          f"at the tile's edges ({len(edge)} launches; failed: "
          f"{[n_ for n_, ok_ in edge if not ok_]})")

    # deep k: the IVF-Flat scans at k 1000 and fused_knn at k 2048, on the
    # deep main path's queries, bitwise, each recorded beside its kk=10 row
    def add_wide(name, entry):
        next(r for r in results if r["name"] == name).setdefault("wide", []).append(entry)

    _, bucket_d, _, _ = _common.select_scan_strategy(
        "probe_major", DEEP_QUERIES, N_PROBES, index.n_lists, index.list_cap, index.dim,
        res.workspace_limit_bytes, k=DEEP_IVF_K)
    args_d, _ = ivf_flat.probe_major_scan_inputs(index, dq, N_PROBES, DEEP_IVF_K, bucket_d)
    probes_d = _common.coarse_select(dq, index.centers, metric, N_PROBES)
    rows_d = (index.list_index >= 0).sum(dim=1)
    for schedule, args_ in (("probe_major", args_d),
                            ("query_major", ivf_flat.query_major_scan_inputs(
                                index, dq, N_PROBES, DEEP_IVF_K))):
        kern = getattr(scan, f"ivf_scan_{schedule}")
        plain_fn = getattr(scan, f"ivf_scan_{schedule}_torch")
        kk_ = args_[-1]
        out_rows = probes_d.numel() if schedule == "probe_major" else DEEP_QUERIES
        add_wide(f"ivf_scan_{schedule}", wide_entry(
            f"{DEEP_QUERIES} q, kk={kk_}", bitwise(f"ivf_scan_{schedule} kk={kk_}",
                                                   *kern(*args_), *plain_fn(*args_)),
            lambda: kern(*args_), lambda: plain_fn(*args_),
            cost.scan_work(probes_d, rows_d, index.dim, out_rows, kk_), reps=(5, 1)))
    del args_d
    # the deep-k serving batch: its probes in parts, merged past k = 128
    args_s = ivf_flat.query_major_scan_inputs(index, q[:QM_BATCH], N_PROBES, DEEP_IVF_K)
    kk_ = args_s[-1]
    n_parts = scan.query_major_parts(N_PROBES, kernels.grid_splits(
        QM_BATCH, N_PROBES, dev, per_sm=scan.QM_PER_SM))[1]
    check(n_parts > 1, f"deep k serving batch: {n_parts} parts")
    add_wide("ivf_scan_query_major", wide_entry(
        f"{QM_BATCH} q, kk={kk_}, each query's probes in {n_parts} parts (merge_parts)",
        bitwise(f"ivf_scan_query_major {QM_BATCH} q kk={kk_} in {n_parts} parts",
                *scan.ivf_scan_query_major(*args_s), *scan.ivf_scan_query_major_torch(*args_s)),
        lambda: scan.ivf_scan_query_major(*args_s), lambda: scan.ivf_scan_query_major_torch(*args_s),
        cost.scan_work(args_s[0], rows_d, index.dim, QM_BATCH, kk_), reps=(10, 1)))
    del args_s
    kv, ki = fk.fused_l2_topk(dq, x, xx, DEEP_BF_K)
    pv, pi = fk.fused_l2_topk_torch(dq, x, xx, DEEP_BF_K)
    add_wide("fused_knn", wide_entry(
        f"q [{DEEP_QUERIES}, 128] x [1000000, 128] k={DEEP_BF_K}",
        bitwise(f"fused_knn k={DEEP_BF_K}", kv, ki, pv, pi),
        lambda: fk.fused_l2_topk(dq, x, xx, DEEP_BF_K),
        lambda: fk.fused_l2_topk_torch(dq, x, xx, DEEP_BF_K),
        cost.fused_knn_work(DEEP_QUERIES, x.shape[0], x.shape[1], DEEP_BF_K),
        lambda: torch.topk(torch.cdist(dq, x), DEEP_BF_K, dim=1, largest=False), reps=(3, 1)))
    del kv, ki, pv, pi

    # kernel #7 at the prims shape (recorded) and at the k-means assignment
    # of 1M rows: bitwise; its library yardstick is two calls (no single
    # PyTorch call computes a fused argmin): addmm, then min
    x_am = x[:ARGMIN_ROWS]
    am_args = {"8192": (x_am, km_init, cc_init), "1M": (x, km_init, cc_init)}
    am_err = 0.0
    for tag, a in am_args.items():
        am_err = max(am_err, bitwise(f"fused_argmin {tag} x {KM_CLUSTERS}",
                                     *kernels.fused_l2_argmin(*a), *fa.fused_l2_argmin_torch(*a)))

    def am_library(a):
        return lambda: torch.addmm(a[2], a[0], a[1].T, alpha=-2).min(dim=1)

    full = am_args["1M"]
    record("fused_argmin", "raft_tpu_torch/csrc/fused_argmin.cu",
           "raft_tpu/kernels/fused_argmin.py:84", am_err,
           cuda_ms(lambda: kernels.fused_l2_argmin(*am_args["8192"]), 20),
           cuda_ms(lambda: fa.fused_l2_argmin_torch(*am_args["8192"]), 3),
           cost.fused_argmin_work(ARGMIN_ROWS, KM_CLUSTERS, x.shape[1]),
           cost.fused_argmin_cost(ARGMIN_ROWS, KM_CLUSTERS, x.shape[1]),
           cuda_ms(am_library(am_args["8192"]), 20),
           f"[{ARGMIN_ROWS}, 128] x [{KM_CLUSTERS}, 128] (raft_tpu bench/prims.py:215)",
           library_call="torch.addmm(cc, x, c.T, alpha=-2) then .min(dim=1): two calls",
           center_parts=fa.center_parts(ARGMIN_ROWS, KM_CLUSTERS,
                                        fa._BLOCKS_PER_SM * kernels.sm_count(0)),
           wide=[wide_entry(f"[{x.shape[0]}, 128] x [{KM_CLUSTERS}, 128] (the k-means assignment)",
                            am_err, lambda: kernels.fused_l2_argmin(*full),
                            lambda: fa.fused_l2_argmin_torch(*full),
                            cost.fused_argmin_work(x.shape[0], KM_CLUSTERS, x.shape[1]),
                            am_library(full), reps=(5, 2))])
    r7 = results[-1]
    for tag, e in (("8192", r7), ("1M", r7["wide"][0])):
        print(f"fused_argmin {tag} x {KM_CLUSTERS} x 128: {e['ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), {100 * e['bound_ms'] / e['ms']:.1f} % "
              f"of bound; addmm + min {e['library_ms']:.4f} ms; plain {e['plain_ms']:.3f} ms",
              flush=True)
    del am_args, full, x_am

    # the CAGRA hop: the inputs of hop CAPTURE_HOP of the first query tile
    # (the main path's capture; f32 rows, and a bf16 copy of the dataset),
    # and of a 64-query batch
    def hop_check(tag, args):
        got = ct.cagra_fused_hop(*args, metric=metric)
        want = ct.cagra_fused_hop_torch(*args, metric=metric)
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        check(ok, f"cagra hop {tag}: values, ids and flags bitwise equal to the plain version")
        check(not torch.equal(got[1], args[5]), f"cagra hop {tag} changed the buffer")
        return max_err(got[0], want[0])

    def hop_work(args):
        """The hop's bound from the rows it really reads (repeats and ids
        already in the buffer go unread), counted by the plain version."""
        paged = isinstance(args[0], PagedRows)
        rows = args[0].pool if paged else args[0]
        live, fetched = ct.cagra_hop_reads(*args, metric=metric)
        return cost.cagra_hop_work(live, fetched, args[1].shape[1], args[0].shape[1],
                                   args[4].shape[1], itemsize=rows.element_size(), paged=paged,
                                   width=args[3].shape[1])

    err = hop_check(f"tile {hop_args[2].shape[0]} f32", hop_args)
    check(all(torch.equal(a, b) for a, b in zip(hop_out, ct.cagra_fused_hop(*hop_args,
                                                                          metric=metric))),
          "cagra hop: the main path's launch gave the same buffers again")
    cg_bf16 = cagra.Index(cg.metric, cg.dataset.to(torch.bfloat16), cg.graph, cg.entry_centers,
                          cg.entry_ids)
    hop_bf = capture_hop(cg_bf16, q.shape[0])
    err = max(err, hop_check(f"tile {hop_bf[2].shape[0]} bf16 rows", hop_bf))
    hop_small = capture_hop(cg, QM_BATCH)
    err = max(err, hop_check(f"tile {QM_BATCH} f32", hop_small))
    hop_ms = device_ms(lambda: ct.cagra_fused_hop(*hop_args, metric=metric), "cagra_walk_kernel")
    hop_plain = cuda_ms(lambda: ct.cagra_fused_hop_torch(*hop_args, metric=metric), 3)
    tile, itopk = hop_args[4].shape
    also = [wide_entry(f"tile {t}, itopk {a[4].shape[1]}, {tag}", err,
                       lambda a=a: ct.cagra_fused_hop(*a, metric=metric),
                       lambda a=a: ct.cagra_fused_hop_torch(*a, metric=metric), hop_work(a),
                       reps=(50, 3))
            for tag, t, a in (("bf16 rows", hop_bf[2].shape[0], hop_bf),
                              ("f32 rows", QM_BATCH, hop_small))]
    for entry, a in zip(also, (hop_bf, hop_small)):
        entry.pop("library_ms")
        entry["wall_ms"] = entry["ms"]
        entry["ms"] = device_ms(lambda: ct.cagra_fused_hop(*a, metric=metric), "cagra_walk_kernel")
    record("cagra_fused_hop", "raft_tpu_torch/csrc/cagra_hop.cu",
           "raft_tpu/kernels/cagra_traverse.py:278", err, hop_ms, hop_plain, hop_work(hop_args),
           cost.cagra_traverse_cost(tile, cagra_sp.search_width, cg.graph_degree, cg.dim, itopk),
           None, f"tile {tile}, width {cagra_sp.search_width}, deg {cg.graph_degree}, "
           f"d {cg.dim}, itopk {itopk}, f32 rows (hop {CAPTURE_HOP})", also=also,
           wall_ms=cuda_ms(lambda: ct.cagra_fused_hop(*hop_args, metric=metric), 50))
    # select_k at the filtered CAGRA search's own shapes, from hop
    # CAPTURE_HOP's buffers: the filtered body's buffer fold ([64, 2 itopk],
    # k = itopk) and result fold ([64, k + itopk], k).  Launches this short
    # are timed on the device (profiler), the wall beside it
    nxt = ct.cagra_fused_hop(*hop_small, metric=metric)
    for tag, rows_, k_ in (
            ("filtered buffer", torch.cat([hop_small[4], nxt[0]], dim=1), hop_small[4].shape[1]),
            ("filtered result", torch.cat([hop_small[4][:, :K], nxt[0]], dim=1), K)):
        bound_, by_ = cost.bound_ms(cost.select_k_work(rows_.shape[0], rows_.shape[1], k_))
        add_wide("select_k", {
            "shape": f"[{rows_.shape[0]}, {rows_.shape[1]}] k={k_} (CAGRA {tag})",
            "max_abs_err": bitwise(f"select_k {tuple(rows_.shape)} k={k_} (CAGRA {tag})",
                                   *sk.select_k_kernel(rows_, k_), *sk.select_k_torch(rows_, k_)),
            "ms": device_ms(lambda: sk.select_k_kernel(rows_, k_), "select_k"),
            "wall_ms": cuda_ms(lambda: sk.select_k_kernel(rows_, k_), 200),
            "plain_ms": device_ms(lambda: sk.select_k_torch(rows_, k_), None, reps=20),
            "bound_ms": bound_, "bound_by": by_,
            "library_ms": device_ms(lambda: torch.topk(rows_, k_, dim=1, largest=False), None)})
    del nxt
    # #8's paged leg: the same capture on the paginated index (rows through
    # its identity-pinned pool; a paginated bf16 copy for the bf16 rows),
    # beside the dense leg on the same inputs
    p_cg_bf16, _ = paginate(cg_bf16, "paged_cagra_bf16")
    check(all(torch.equal(a, b) for a, b in zip(hop_p_out, ct.cagra_fused_hop(*hop_p,
                                                                            metric=metric))),
          "paged cagra hop: the main path's launch gave the same buffers again")
    hop_pbf = capture_hop(p_cg_bf16, q.shape[0], paged_view(p_cg_bf16))
    err = hop_check(f"tile {hop_p[2].shape[0]} f32, paged", hop_p)
    err = max(err, hop_check(f"tile {hop_pbf[2].shape[0]} bf16 rows, paged", hop_pbf))
    unpaged = {}
    for tag, a, dense_rows in (("f32", hop_p, cg.dataset), ("bf16", hop_pbf, cg_bf16.dataset)):
        dense_args = (dense_rows,) + a[1:]
        bitwise(f"cagra hop {tag}, paged leg", *ct.cagra_fused_hop(*a, metric=metric)[:2],
                *ct.cagra_fused_hop(*dense_args, metric=metric)[:2],
                what="the dense leg on the same inputs")
        unpaged[tag] = device_ms(lambda: ct.cagra_fused_hop(*dense_args, metric=metric),
                                 "cagra_walk_kernel")
    also = [wide_entry(f"tile {hop_pbf[2].shape[0]}, itopk {hop_pbf[4].shape[1]}, bf16 rows",
                       err, lambda: ct.cagra_fused_hop(*hop_pbf, metric=metric),
                       lambda: ct.cagra_fused_hop_torch(*hop_pbf, metric=metric),
                       hop_work(hop_pbf), reps=(50, 3))]
    also[0].pop("library_ms")
    also[0]["wall_ms"] = also[0]["ms"]
    also[0]["ms"] = device_ms(lambda: ct.cagra_fused_hop(*hop_pbf, metric=metric),
                              "cagra_walk_kernel")
    also[0]["unpaged_ms"] = unpaged["bf16"]
    tile, itopk = hop_p[4].shape
    record("cagra_fused_hop_paged", "raft_tpu_torch/csrc/cagra_hop.cu",
           "raft_tpu/kernels/cagra_traverse.py:180", err,
           device_ms(lambda: ct.cagra_fused_hop(*hop_p, metric=metric), "cagra_walk_kernel"),
           cuda_ms(lambda: ct.cagra_fused_hop_torch(*hop_p, metric=metric), 3), hop_work(hop_p),
           cost.cagra_traverse_cost(tile, cagra_sp.search_width, cg.graph_degree, cg.dim, itopk),
           None, f"tile {tile}, width {cagra_sp.search_width}, deg {cg.graph_degree}, "
           f"d {cg.dim}, itopk {itopk}, f32 rows in {p_cg.paged.n_pages} pages of {PAGE_ROWS} "
           f"(hop {CAPTURE_HOP})", also=also, unpaged_ms=unpaged["f32"],
           wall_ms=cuda_ms(lambda: ct.cagra_fused_hop(*hop_p, metric=metric), 50))

    # #8 as one launch: the whole walk of the first query tile (its seed
    # buffer, max_iter hops) and of a 64-query batch, f32 and bf16 rows,
    # dense and through the pinned pools' page tables, against the plain
    # loop of pick and hop on the same inputs
    _, walk_steps, _ = cagra.search_plan(cagra_sp, cg, q.shape[0], K, res)

    def capture_walk(index, n_q, dataset=None, queries=None):
        ds = index.dataset if dataset is None else dataset
        itopk, _, tile = cagra.search_plan(cagra_sp, index, n_q, K, res)
        qs = (q if queries is None else queries)[:min(n_q, tile)]
        seeds = cagra.make_seed_ids(cagra_sp, index, qs, K, itopk=itopk)
        return (ds, index.graph, qs, *cagra.traverse_init(ds, qs, seeds, itopk, metric))

    def walk_fn(a, plain=False):
        fn = ct.cagra_traverse_steps_torch if plain else ct.cagra_traverse_steps
        return lambda: fn(*a, steps=walk_steps, width=cagra_sp.search_width, metric=metric)

    def walk_check(tag, a):
        """The walk against its plain version: ((live parents, fetched
        rows), max abs err)."""
        got, want = walk_fn(a)(), walk_fn(a, plain=True)()
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and all(torch.equal(x, y) for x, y in zip(got[1:], want[1:])),
              f"cagra walk {tag}: values (by their bits), ids, explored flags, live parents "
              "and fetched rows equal to the plain loop of pick and hop")
        check(not torch.equal(got[1], a[4]), f"cagra walk {tag} changed the buffer")
        return got[3:5], max_err(got[0], want[0])

    def walk_work(a, reads):
        """The walk's bound from the rows it really read (its own counts)."""
        paged = isinstance(a[0], PagedRows)
        rows = a[0].pool if paged else a[0]
        return cost.cagra_hop_work(*reads, a[1].shape[1], a[0].shape[1], a[3].shape[1],
                                   itemsize=rows.element_size(), paged=paged)

    def walk_raft_cost(a):
        c = cost.cagra_traverse_cost(a[2].shape[0], cagra_sp.search_width, a[1].shape[1],
                                     a[0].shape[1], a[3].shape[1])
        return dataclasses.replace(c, flops=c.flops * walk_steps,
                                   bytes_accessed=c.bytes_accessed * walk_steps)

    def walk_entry(tag, a):
        reads, err_ = walk_check(tag, a)
        bound_, by_ = cost.bound_ms(walk_work(a, reads))
        return {"shape": f"tile {a[2].shape[0]}, itopk {a[3].shape[1]}, {tag}",
                "max_abs_err": err_, "ms": device_ms(walk_fn(a), "cagra_walk_kernel", reps=10),
                "wall_ms": cuda_ms(walk_fn(a), 10), "plain_ms": cuda_ms(walk_fn(a, True), 1),
                "bound_ms": bound_, "bound_by": by_, "live_parents": int(reads[0].sum()),
                "fetched_rows": int(reads[1].sum())}

    for name, replaces, a, others, dense_rows in (
            ("cagra_traverse", "raft_tpu/kernels/cagra_traverse.py:278", capture_walk(cg, q.shape[0]),
             [("bf16 rows", capture_walk(cg_bf16, q.shape[0])),
              ("f32 rows", capture_walk(cg, QM_BATCH))], None),
            ("cagra_traverse_paged", "raft_tpu/kernels/cagra_traverse.py:180",
             capture_walk(p_cg, q.shape[0], paged_view(p_cg)),
             [("bf16 rows, paged", capture_walk(p_cg_bf16, q.shape[0], paged_view(p_cg_bf16)))],
             cg.dataset)):
        main_e = walk_entry(f"f32 rows, {walk_steps} hops", a)
        extra = {}
        if dense_rows is not None:
            dense_args = (dense_rows,) + a[1:]
            got_p, got_d = walk_fn(a)(), walk_fn(dense_args)()
            check(all(torch.equal(x, y) for x, y in zip(got_p, got_d)),
                  "cagra walk, paged: bitwise the dense walk on the same inputs")
            extra["unpaged_ms"] = device_ms(walk_fn(dense_args), "cagra_walk_kernel", reps=10)
        reads, _ = walk_check(f"{name} recorded", a)
        record(name, "raft_tpu_torch/csrc/cagra_hop.cu", replaces, main_e["max_abs_err"],
               main_e["ms"], main_e["plain_ms"], walk_work(a, reads), walk_raft_cost(a), None,
               f"tile {a[2].shape[0]}, width {cagra_sp.search_width}, deg {cg.graph_degree}, "
               f"d {cg.dim}, itopk {a[3].shape[1]}, {walk_steps} hops, f32 rows"
               + (f" in {p_cg.paged.n_pages} pages of {PAGE_ROWS}" if dense_rows is not None
                  else ""),
               also=[walk_entry(tag, o) for tag, o in others], wall_ms=main_e["wall_ms"],
               live_parents=main_e["live_parents"], fetched_rows=main_e["fetched_rows"],
               **extra)
        r8 = results[-1]
        print(f"{name}: {r8['ms']:.4f} ms device, bound {r8['bound_ms']:.4f} ms "
              f"({r8['bound_by']}), {100 * r8['bound_ms'] / r8['ms']:.1f} % of bound, "
              f"{r8['live_parents']} live parents, {r8['fetched_rows']} rows read; "
              f"plain {r8['plain_ms']:.1f} ms", flush=True)
    del hop_args, hop_bf, hop_small, cg_bf16, hop_p, hop_pbf, p_cg_bf16

    # #8's 8-bit legs: the uint8 and int8 walks of the first query tile,
    # dense and through the pinned pools' page tables, and the single hop on
    # uint8 / int8 rows (dense and paged), each against its plain version
    def record_leg(name, launches, replaces, entry, raft_cost, shape):
        results.append({
            "name": name, "route": "cuda", "source": "raft_tpu_torch/csrc/cagra_hop.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": None, "shape": shape,
            "raft_formula_bound_ms": cost.bound_ms(raft_cost)[0],
            **{k_: v_ for k_, v_ in entry.items() if k_ not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "shape")}})
        r8 = results[-1]
        print(f"{name}: {r8['ms']:.4f} ms device, bound {r8['bound_ms']:.4f} ms "
              f"({r8['bound_by']}), {100 * r8['bound_ms'] / r8['ms']:.1f} % of bound; "
              f"plain {r8['plain_ms']:.1f} ms; {launches} launches on the main path", flush=True)

    for tag, idx_, qs8 in (("u8", cg8, q_u8), ("s8", cg_s8, q_s8)):
        for paged_ in (False, True):
            pidx = p_cg8[tag]
            a = (capture_walk(pidx, q.shape[0], paged_view(pidx), queries=qs8) if paged_
                 else capture_walk(idx_, q.shape[0], queries=qs8))
            e = walk_entry(f"{tag} rows{', paged' if paged_ else ''}, {walk_steps} hops", a)
            if paged_:
                dense_args = (idx_.dataset,) + a[1:]
                check(all(torch.equal(x_, y_) for x_, y_ in zip(walk_fn(a)(),
                                                                walk_fn(dense_args)())),
                      f"cagra walk {tag}, paged: bitwise the dense walk on the same inputs")
                e["unpaged_ms"] = device_ms(walk_fn(dense_args), "cagra_walk_kernel", reps=10)
            ph = f"paged_cagra_{tag}" if paged_ else f"cagra_{tag}_search"
            walk_name = "cagra_traverse_paged" if paged_ else "cagra_traverse"
            record_leg(f"{walk_name}[{tag}]", phase_launches[ph][walk_name],
                       "raft_tpu/kernels/cagra_traverse.py:180" if paged_
                       else "raft_tpu/kernels/cagra_traverse.py:278", e, walk_raft_cost(a),
                       e["shape"])
        hop_a = hop8_args if tag == "u8" else capture_hop(cg_s8, q.shape[0], queries=q_s8)
        hop_pa = capture_hop(p_cg8[tag], q.shape[0], paged_view(p_cg8[tag]), queries=qs8)
        err8 = max(hop_check(f"{tag} rows", hop_a), hop_check(f"{tag} rows, paged", hop_pa))
        bitwise(f"cagra hop {tag}, paged leg", *ct.cagra_fused_hop(*hop_pa, metric=metric)[:2],
                *ct.cagra_fused_hop(*((idx_.dataset,) + hop_pa[1:]), metric=metric)[:2],
                what="the dense leg on the same inputs")
        if tag == "u8":
            check(all(torch.equal(a_, b_) for a_, b_ in zip(
                hop8_out, ct.cagra_fused_hop(*hop8_args, metric=metric))),
                  "cagra uint8 hop: the main path's launch gave the same buffers again")
            bound8, by8 = cost.bound_ms(hop_work(hop_a))
            tile8, itopk8 = hop_a[4].shape
            record_leg("cagra_fused_hop[u8]", phase_launches["cagra_u8_hop"]["cagra_fused_hop"],
                       "raft_tpu/kernels/cagra_traverse.py:278", {
                           "max_abs_err": err8,
                           "ms": device_ms(lambda: ct.cagra_fused_hop(*hop_a, metric=metric),
                                           "cagra_walk_kernel"),
                           "plain_ms": cuda_ms(lambda: ct.cagra_fused_hop_torch(
                               *hop_a, metric=metric), 3),
                           "bound_ms": bound8, "bound_by": by8},
                       cost.cagra_traverse_cost(tile8, cagra_sp.search_width, cg8.graph_degree,
                                                cg8.dim, itopk8),
                       f"tile {tile8}, width {cagra_sp.search_width}, deg {cg8.graph_degree}, "
                       f"d {cg8.dim}, itopk {itopk8}, uint8 rows (hop {CAPTURE_HOP})")
    del hop8_args, hop8_out, p_cg8

    probe("the kernels' timings against their plain versions")

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
            if is_device_work(evt):
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
        "cagra_10000q": profile_search(lambda: cagra_search()(q, K)),
        f"cagra_{QM_BATCH}q": profile_search(lambda: cagra_search()(q[:QM_BATCH], K)),
        "filt_pass10_probe_major_10000q": profile_search(
            lambda: ivf_flat.search(sp, index, q, K, res=res, **filters["pass10"])),
        f"filt_table8_query_major_{QM_BATCH}q": profile_search(
            lambda: ivf_flat.search(sp, index, q[:QM_BATCH], K, res=res, **table_batches[0])),
        f"filt_pass50_cagra_{QM_BATCH}q": profile_search(
            cagra_filtered(q[:QM_BATCH], filters["pass50"])),
        "paged_probe_major_10000q": profile_search(
            lambda: ivf_flat.search(sp, p_flat, q, K, res=res)),
        f"paged_query_major_{QM_BATCH}q": profile_search(
            lambda: ivf_flat.search(sp, p_flat, q[:QM_BATCH], K, res=res)),
        "paged_pq_probe_major_10000q": profile_search(
            lambda: p_pq_search(*PQ_MAIN)(q, K)),
        f"paged_over_budget_{2 * OVER_BUDGET_QUERIES // OVER_BUDGET_BATCH}x"
        f"{OVER_BUDGET_BATCH}q": profile_search(
            lambda: [ivf_flat.search(sp, p_over, q[b:b + OVER_BUDGET_BATCH], K, res=res)
                     for b in range(0, 2 * OVER_BUDGET_QUERIES, OVER_BUDGET_BATCH)][-1]),
        f"paged_cagra_{QM_BATCH}q": profile_search(
            lambda: cagra.search(cagra_sp, p_cg, q[:QM_BATCH], K, res=res)),
        "cagra_u8_10000q": profile_search(lambda: cagra.search(cagra_sp, cg8, q_u8, K, res=res)),
    }
    for name, prof_out in profiles.items():
        check(prof_out["device_busy_ms"] > 0, f"profile of {name} saw device time")
    print(json.dumps({"profile": profiles}), flush=True)

    # The harness's phases run after the profile phase and every kernel
    # timing above, so that those are taken in the state a process without
    # them would be in (the harness opens its own profiler windows); each
    # phase checks its own launches.
    probe("the profile phase")

    # -- raft_tpu's BASELINE ladder, configs 1-4 at scale 1.0 ---------
    from raft_tpu_torch.bench import ladder

    with phase("ladder"):
        ladder_recs = ladder.run(Resources(device="cuda", workspace_limit_bytes=1 << 30),
                                 "1,2,3,4", 1.0)
    for rec in ladder_recs:
        check(rec["pass"] is True and rec["kernel_path"] == "cuda"
              and rec["device"]["name"] == torch.cuda.get_device_name(0)
              and rec["device"]["power_limit"],
              f"ladder {rec['config']}: pass, kernel_path cuda, on {rec['device']['name']} "
              f"at {rec['device']['power_limit']}")
    pl = phase_launches["ladder"]
    check(pl["select_k"] > 0 and pl["fused_knn"] > 0 and pl["cagra_traverse"] > 0
          and pl["ivf_scan_probe_major"] > 0 and pl["ivf_scan_probe_major_bf16"] > 0,
          "ladder launched select_k, fused_knn, the probe-major scans (f32, bf16) and the walk")

    # -- main path: the harness end to end, and one primitive of each family -----
    from raft_tpu_torch.bench import prims

    bench_dir = tempfile.mkdtemp(prefix="raft_tpu_torch_bench_")
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "raft_tpu_torch.bench", "--dataset",
                          "sift-128-euclidean", "--scale", "0.01", "--out", bench_dir],
                         capture_output=True, text=True, timeout=600)
    print(cli.stdout[-3000:], flush=True)
    rows_json, rows_csv = [], []
    if cli.returncode == 0:
        with open(os.path.join(bench_dir, "sift-128-euclidean.json")) as fh:
            rows_json = json.load(fh)
        with open(os.path.join(bench_dir, "sift-128-euclidean.csv")) as fh:
            rows_csv = fh.read().splitlines()[1:]
    shutil.rmtree(bench_dir, ignore_errors=True)
    algos = {r["algo"] for r in rows_json}
    short_rows = [{key: r[key] for key in ("algo", "search_param", "recall", "qps",
                                           "build_time_s", "device_time_s")}
                  for r in rows_json if not (r["recall"] > 0 and r["qps"] > 0
                                             and r["build_time_s"] >= 0 and r["device_time_s"])]
    check(cli.returncode == 0 and algos == {"raft_tpu_brute_force", "raft_tpu_ivf_flat",
                                            "raft_tpu_ivf_pq", "raft_tpu_cagra"}
          and len(rows_csv) == len(rows_json) and not short_rows,
          f"python -m raft_tpu_torch.bench --scale 0.01: rc {cli.returncode}, {len(rows_json)} "
          f"rows ({len(rows_csv)} in the CSV) over {sorted(algos)} with recall, QPS, build time "
          f"and device time, in {time.perf_counter() - t0:.1f} s"
          f"{f'; rows short of one: {short_rows}' if short_rows else ''}"
          f"{cli.stderr[-2000:] if cli.returncode else ''}")
    with phase("prims"):
        prim_rows = [row for f in ("select_k/4096x2048/k10", "select_k_ab/1024x4096/k10/topk",
                                   "pairwise/sqeuclidean", "ivf_scan_ab/100kx96/p32/probe_major",
                                   "bf_knn_ab", "fused_l2_nn")
                     for row in prims.run(f, res=res)]
    check(len(prim_rows) == 6 and all(r["seconds"] > 0 and r["device"]["power_limit"]
                                      for r in prim_rows),
          f"prims: one case of each family timed ({[r['name'] for r in prim_rows]})")
    # the harness's rows that raised before slice 11, on the same dataset
    # through the CLI: the CAGRA graph through an hnswlib file, and CAGRA
    # over VPQ codes (the plain walk)
    bench_dir = tempfile.mkdtemp(prefix="raft_tpu_torch_bench_")
    new_algos = ["hnswlib_format", "raft_tpu_cagra_vpq"]
    bp = {"graph_degree": 32, "intermediate_graph_degree": 64}
    with open(os.path.join(bench_dir, "config.json"), "w") as fh:
        json.dump({"algos": [{"name": "hnswlib_format", "build_param": bp,
                              "search_params": [{"ef": 64}]},
                             {"name": "raft_tpu_cagra_vpq", "build_param": bp,
                              "search_params": [{"itopk_size": 64}]}]}, fh)
    cli = subprocess.run([sys.executable, "-m", "raft_tpu_torch.bench", "--dataset",
                          "sift-128-euclidean", "--scale", "0.01", "--config",
                          os.path.join(bench_dir, "config.json"), "--out", bench_dir],
                         capture_output=True, text=True, timeout=600)
    new_rows = []
    if cli.returncode == 0:
        with open(os.path.join(bench_dir, "sift-128-euclidean.json")) as fh:
            new_rows = json.load(fh)
    shutil.rmtree(bench_dir, ignore_errors=True)
    for r in new_rows:
        print(json.dumps(r), flush=True)
    check(cli.returncode == 0 and [r["algo"] for r in new_rows] == new_algos
          and all(r["recall"] > 0.5 and r["qps"] > 0 and r["build_time_s"] >= 0
                  and r["device_time_s"] for r in new_rows),
          f"harness rows {new_algos} with recall > 0.5, QPS, build time and device time"
          f"{cli.stderr[-2000:] if cli.returncode else ''}")
    # -- main path: batched brute force, and bf16 internal distances in IVF-PQ ---
    bf_idx = brute_force.build(x, res=res)
    with phase("batch_k_query"):
        bkq = brute_force.make_batch_k_query(bf_idx, q[:1000], K, res=res)
        bk_batches = []
        for o in (0, K, 3 * K, 7 * K):   # each batch beside the k it was cut from
            bk_batches.append((bkq.batch(o, K), bkq._cached_k))
    ok_bk = True
    for b, k_cut in bk_batches:
        v_, i_ = brute_force.search(bf_idx, q[:1000], k_cut, res=res)
        ok_bk &= torch.equal(b.distances(), v_[:, b.offset:b.offset + b.size]) and torch.equal(
            b.indices(), i_[:, b.offset:b.offset + b.size])
    check(ok_bk and bkq._cached_k == 8 * K and phase_launches["batch_k_query"]["fused_knn"] > 0,
          f"make_batch_k_query: batches at offsets 0..{7 * K} (k grown to {bkq._cached_k}) "
          "bitwise brute_force.search at the same k, on fused_knn")
    del bf_idx, bkq, bk_batches
    # raft_tpu's ladder config 4 (100k x 96, n_lists 1024, pq_dim 48, bf16
    # products, k' = 4 k refined): f32 against bf16 internal distances
    l4_c, l4_x = ladder._blobs(100_000, 96, 1000, 4)
    rng_l4 = np.random.default_rng(5)
    l4_q = torch.from_numpy(l4_c[rng_l4.integers(0, 1000, 10_000)] + rng_l4.standard_normal(
        (10_000, 96)).astype(np.float32) * 0.35).to(dev)
    l4_x = torch.from_numpy(l4_x).to(dev)
    l4_gt = brute_force.knn(l4_x, l4_q, K, res=res)[1]
    l4_pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=1024, pq_dim=48, kmeans_n_iters=10), l4_x,
                         res=res)
    l4_r = {}
    for internal in ("float32", "bfloat16"):
        with phase(f"pq_internal_{internal}"):
            l4_sp = ivf_pq.SearchParams(n_probes=32, lut_dtype="bfloat16",
                                        internal_distance_dtype=internal)
            cand = ivf_pq.search(l4_sp, l4_pq, l4_q, 4 * K, res=res)[1]
            l4_r[internal] = recall_at_k(refine(l4_x, l4_q, cand, K, res=res)[1], l4_gt, K)
    check(phase_launches["pq_internal_bfloat16"]["ivf_scan_probe_major_bf16"] == 0
          and phase_launches["pq_internal_float32"]["ivf_scan_probe_major_bf16"] > 0,
          "bf16 internal distances on plain ops (no scan kernel), f32 on the bf16 scan")
    check(abs(l4_r["bfloat16"] - l4_r["float32"]) <= PQ_BF16_TOL and l4_r["bfloat16"] >= 0.9,
          f"ladder config 4 IVF-PQ refined recall@{K}: bf16 internal {l4_r['bfloat16']:.5f} "
          f"within {PQ_BF16_TOL} of f32 internal {l4_r['float32']:.5f}")
    del l4_x, l4_q, l4_pq, l4_gt, cand

    probe("the harness phases")

    # -- phase 20: CAGRA's NN-descent builds (in memory and out of core) -------
    from raft_tpu_torch.neighbors import hnsw, nn_descent, vpq_dataset

    nd_res = Resources(device="cuda", workspace_limit_bytes=ND_WORKSPACE)
    n_nd = x.shape[0]
    nd_inter = min(cagra_params.intermediate_graph_degree, n_nd - 1)
    nd_k = min(n_nd - 1, max(nd_inter + nd_inter // 2, nd_inter + 8))   # cagra.build's rule
    nd_c = min(nd_k, 16) * (nd_k + 1)                                  # sample * k + sample
    kept = {}

    @contextlib.contextmanager
    def nd_spy(fn_name):
        """While the block runs: keep what ``nn_descent.<fn_name>`` returns
        (the kNN graph and its updates per iteration), its synchronised time
        and the peak device memory it allocated above what was held before
        it, the synchronised time of the graph's optimisation and of the
        entry points, and the inputs of the first merge select_k (rows of
        k + c candidates with their ids)."""
        saved = [(nn_descent, fn_name), (cagra, "optimize"), (cagra, "_build_entry_points"),
                 (sk, "select_k_kernel")]
        saved = [(m, a, getattr(m, a)) for m, a in saved]

        def timed(fn, key):
            def wrapper(*a, **kw):
                sync()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                kept[f"{key}_s"] = kept.get(f"{key}_s", 0.0) + time.perf_counter() - t0
                if key == fn_name:
                    kept[key] = out
                    kept["peak"] = torch.cuda.max_memory_allocated() - held
                return out
            return wrapper

        select = saved[3][2]

        def first_merge(*a, **kw):
            scores, k = a[0], a[1]
            if ("merge" not in kept and k == nd_k and scores.shape[1] == nd_k + nd_c
                    and kw.get("input_indices") is not None):
                kept["merge"] = (scores.clone(), kw["input_indices"].clone(), kw)
            return select(*a, **kw)

        for m, a, fn in saved[:3]:
            setattr(m, a, timed(fn, a))
        sk.select_k_kernel = first_merge
        try:
            yield
        finally:
            for m, a, fn in saved:
                setattr(m, a, fn)

    def nd_build(algo, data, ph=None):
        """A CAGRA build with ``build_algo``: (index, seconds, the peak device
        memory it allocated above what was held before it)."""
        sync()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (phase(ph) if ph else contextlib.nullcontext()):
            idx = cagra.build(cagra.IndexParams(build_algo=algo), data, res=nd_res)
        sync()
        return idx, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - held

    def knn_graph_recall(data, graphs):
        """kNN graph recall@K of each graph in ``graphs`` on ND_SAMPLE rows
        of ``data`` sampled with SEED, against their exact K nearest other
        rows."""
        sample = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
            data.shape[0], ND_SAMPLE, replace=False))).to(dev)
        exact = brute_force.knn(data, data[sample], K + 1, res=res)[1]
        self_col = exact == sample[:, None].to(exact.dtype)
        exact = torch.gather(exact, 1, torch.sort(self_col.to(torch.uint8), dim=1,
                                                  stable=True).indices)[:, :K]
        return {name: recall_at_k(gr.to(dev)[sample][:, :K], exact, K)
                for name, gr in graphs.items()}

    # the in-memory build over all rows
    kept.clear()
    with nd_spy("build"):
        nd_idx, nd_secs, nd_peak = nd_build("nn_descent", x, "nn_descent_build")
    nd_knn, nd_stages, merge_in = kept["build"], dict(kept), kept.get("merge")
    nd_knn_peak = kept["peak"]
    nd_stages = {key: v for key, v in nd_stages.items() if key.endswith("_s")}
    nd_tile = nn_descent._tile_rows(nd_res, n_nd, nd_c, x.shape[1])
    nd_tiles = -(-n_nd // nd_tile)
    print(f"nn_descent build of {n_nd} rows: {nd_secs:.2f} s, stages (synchronised) "
          f"{json.dumps(nd_stages)}; {len(nd_knn.updates)} iterations, updates "
          f"{nd_knn.updates}; k {nd_k}, candidates a row {nd_c}, tile {nd_tile} rows "
          f"({nd_tiles} tiles); peak device memory above the held: NN-descent "
          f"{nd_knn_peak / 2**30:.2f} GiB, the whole CAGRA build {nd_peak / 2**30:.2f} GiB"
          f"{'' if nd_secs <= 150 else '; OVER 150 s'}", flush=True)
    ndl = phase_launches["nn_descent_build"]
    check(ndl["select_k"] >= nd_tiles * (len(nd_knn.updates) + 1) and merge_in is not None,
          f"nn_descent merge: {ndl['select_k']} select_k launches >= {nd_tiles} tiles x "
          f"({len(nd_knn.updates)} iterations + the starting graph), at rows of {nd_k} + {nd_c}")
    g = nd_idx.graph
    g_sorted = torch.sort(g, dim=1).values
    check(tuple(g.shape) == (n_nd, cagra_params.graph_degree) and g.dtype == torch.int32
          and bool((g >= 0).all()) and bool((g < n_nd).all())
          and bool((g != torch.arange(n_nd, device=dev)[:, None]).all())
          and bool((g_sorted[:, 1:] != g_sorted[:, :-1]).all()),
          f"nn_descent cagra graph {tuple(g.shape)} int32: no -1, no self edge, no repeated edge")
    del g_sorted
    with phase("nn_descent_search"):
        _, nd_ids = cagra.search(cagra_sp, nd_idx, q, K, res=res)
    walk_launches("nn_descent_search", expected_tiles(q.shape[0]))
    nd_recall = recall_at_k(nd_ids, gt_i, K)
    check(nd_recall >= CAGRA_RECALL,
          f"recall@{K} of the walk over the NN-descent graph {nd_recall:.5f} >= {CAGRA_RECALL} "
          f"(the IVF-PQ-built graph: {recall['cagra']:.5f})")
    graph_recall = knn_graph_recall(x, {"nn_descent": nd_knn.graph})
    print(f"kNN graph recall@{K} on {ND_SAMPLE} sampled rows of {n_nd}: "
          f"{json.dumps(graph_recall)}", flush=True)
    # one tile's merge select_k against its plain version, and its time
    if merge_in is not None:
        m_sc, m_ids, m_kw = merge_in
        m_kw = {key: v for key, v in m_kw.items() if key != "input_indices"}
        mk = sk.select_k_kernel(m_sc, nd_k, input_indices=m_ids, **m_kw)
        mp = sk.select_k_torch(m_sc, nd_k, input_indices=m_ids, **m_kw)
        entry = wide_entry(
            f"[{m_sc.shape[0]}, {m_sc.shape[1]}] k={nd_k} with ids (NN-descent merge, one tile)",
            bitwise(f"nn_descent merge select_k {tuple(m_sc.shape)} k={nd_k}", *mk, *mp),
            lambda: sk.select_k_kernel(m_sc, nd_k, input_indices=m_ids, **m_kw),
            lambda: sk.select_k_torch(m_sc, nd_k, input_indices=m_ids, **m_kw),
            cost.select_k_work(*m_sc.shape, nd_k, with_ids=True),
            lambda: torch.topk(m_sc, nd_k, dim=1, largest=False), reps=(20, 2))
        entry["launches"] = ndl["select_k"]
        next(r for r in results if r["name"] == "select_k").setdefault("wide", []).append(entry)
        print(f"nn_descent merge select_k: {json.dumps(entry)}", flush=True)
    del nd_idx, nd_knn, merge_in, nd_ids, g
    kept.clear()
    # over the first ND_BATCH_ROWS rows: two seeded in-memory builds, then the
    # out-of-core build over those rows as a host array
    x_nd = x[:ND_BATCH_ROWS]
    n_bt = x_nd.shape[0]
    gt_nd = gt_i if n_bt == n_nd else brute_force.knn(x_nd, q, K, res=res)[1]
    with nd_spy("build"):
        nd_a, nd_secs_a, _ = nd_build("nn_descent", x_nd)
    nd_a_knn, nd_a_peak = kept["build"], kept["peak"]
    kept.clear()
    with nd_spy("build"):
        nd_b, nd_secs_b, _ = nd_build("nn_descent", x_nd)
    check(torch.equal(nd_b.graph, nd_a.graph)
          and torch.equal(kept["build"].graph, nd_a_knn.graph),
          f"two NN-descent builds of {n_bt} rows, one seed: kNN and CAGRA graphs bitwise "
          f"equal ({nd_secs_a:.2f} s, {nd_secs_b:.2f} s; {len(nd_a_knn.updates)} iterations)")
    del nd_a, nd_b
    x_host = x_nd.cpu().numpy()
    kept.clear()
    with nd_spy("build_batch"):
        nb_idx, nb_secs, nb_peak = nd_build("nn_descent_batch", x_host, "nn_descent_batch")
    nb_knn, nb_knn_peak = kept["build_batch"], kept["peak"]
    print(f"nn_descent_batch build of {n_bt} rows (clusters of <= {ND_CLUSTER_ROWS} rows): "
          f"{nb_secs:.2f} s, stages {json.dumps({k_: v for k_, v in kept.items() if k_.endswith('_s')})}, "
          f"peak device memory above the held: NN-descent {nb_knn_peak / 2**30:.2f} GiB, the "
          f"whole CAGRA build {nb_peak / 2**30:.2f} GiB"
          f"{'' if nb_secs <= 150 else '; OVER 150 s'}", flush=True)
    check(nb_knn_peak < nd_a_peak,
          f"nn_descent.build_batch peak device memory {nb_knn_peak / 2**30:.2f} GiB < "
          f"nn_descent.build's {nd_a_peak / 2**30:.2f} GiB over the same {n_bt} rows")
    graph_recall = knn_graph_recall(x_nd, {"nn_descent": nd_a_knn.graph,
                                           "nn_descent_batch": nb_knn.graph})
    with phase("nn_descent_batch_search"):
        _, nb_ids = cagra.search(cagra_sp, nb_idx, q, K, res=res)
    print(f"kNN graph recall@{K} on {ND_SAMPLE} sampled rows of {n_bt}: "
          f"{json.dumps(graph_recall)}; walk recall@{K} over the batch-built graph "
          f"{recall_at_k(nb_ids, gt_nd, K):.5f}", flush=True)
    check(graph_recall["nn_descent_batch"] >= 0.9,
          f"nn_descent_batch kNN graph recall@{K} {graph_recall['nn_descent_batch']:.5f} >= 0.9 "
          f"on {ND_SAMPLE} sampled rows")
    del nb_idx, nd_a_knn, nb_knn, x_host, kept["build_batch"]

    # -- phase 21: VPQ-compressed CAGRA ---------------------------------------
    def plain_walk(dataset, index, queries, seeds):
        """cagra.search's plain path over ``dataset``: the seed buffer, the
        plain walk (no kernel), the best K of the buffer."""
        itopk, max_iter, tile = cagra.search_plan(cagra_sp, index, queries.shape[0], K, res)
        out = []
        for s0 in range(0, queries.shape[0], tile):
            qs = queries[s0:s0 + tile]
            buf = cagra.traverse_init(dataset, qs, seeds[s0:s0 + tile], itopk, metric)
            bd, bi = ct.cagra_traverse_steps_torch(dataset, index.graph, qs, *buf, steps=max_iter,
                                                   width=cagra_sp.search_width, metric=metric)[:2]
            v, i = matrix.select_k(bd, K, select_min=True, input_indices=bi)
            out.append(torch.where(torch.isfinite(v), i, torch.full_like(i, -1)))
        return torch.cat(out)

    sync()
    t0 = time.perf_counter()
    with phase("vpq_compress"):
        vpq_idx = cagra.compress(cg, res=res)
    vpq_s = time.perf_counter() - t0
    vds = vpq_idx.dataset
    ratio = vpq_dataset.compression_ratio(vds)
    qv = q[:VPQ_QUERIES]
    seeds_v = cagra.make_seed_ids(cagra_sp, vpq_idx, qv, K)
    kernels.consume_kernel_path()
    t0 = time.perf_counter()
    with phase("vpq_search"):
        _, vpq_ids = cagra.search(cagra_sp, vpq_idx, qv, K, res=res, seed_ids=seeds_v)
    vpq_wall = time.perf_counter() - t0
    check(kernels.consume_kernel_path() == "torch", "VPQ search stamped kernel_path torch")
    dense = vds.decode(torch.arange(vds.shape[0], device=dev))

    class DecodedRows:
        """Dense rows read by the plain walk's decode-on-gather path, as it
        reads a VPQ dataset's."""

        shape = dense.shape

        @staticmethod
        def decode(ids):
            return dense[ids.long().clamp(0, dense.shape[0] - 1)]

    check(torch.equal(vpq_ids, plain_walk(DecodedRows(), vpq_idx, qv, seeds_v)),
          f"VPQ search of {VPQ_QUERIES} queries: ids bitwise the plain walk over the decoded rows")
    vpq_recall = recall_at_k(vpq_ids, gt_i[:VPQ_QUERIES], K)
    vpq_busy = measure_device_time(
        lambda: cagra.search(cagra_sp, vpq_idx, qv, K, res=res, seed_ids=seeds_v)) or math.nan
    print(f"vpq: compress {vpq_s:.2f} s, ratio {ratio:.3f}, vq centres "
          f"{vds.vq_centers.shape[0]}, pq_dim {vds.pq_dim}, search of {VPQ_QUERIES} queries "
          f"{vpq_wall * 1e3:.1f} ms (device busy {vpq_busy * 1e3:.2f} ms, share "
          f"{vpq_busy / vpq_wall:.3f}), recall@{K} {vpq_recall:.5f}, mean |decoded - row| "
          f"{float((dense - x).norm(dim=1).mean()):.4f}", flush=True)
    del dense
    check(vpq_recall >= VPQ_RECALL, f"VPQ recall@{K} {vpq_recall:.5f} >= {VPQ_RECALL}")
    vdir = tempfile.mkdtemp(prefix="raft_tpu_torch_vpq_")
    try:
        vpath = os.path.join(vdir, "cagra_vpq.idx")
        cagra.save(vpath, vpq_idx)
        back = cagra.load(vpath, res=res)
        ids_probe = torch.randint(0, vds.shape[0], (4096,), device=dev)
        _, back_ids = cagra.search(cagra_sp, back, qv, K, res=res, seed_ids=seeds_v)
        check(isinstance(back.dataset, vpq_dataset.VpqDataset)
              and torch.equal(back.dataset.decode(ids_probe), vds.decode(ids_probe))
              and torch.equal(back_ids, vpq_ids),
              "VPQ save / load round trip in raft_tpu's format: decode and search equal")
        del back
    finally:
        shutil.rmtree(vdir, ignore_errors=True)
    del vpq_idx, vds

    # -- phase 22: hnswlib export, load and search of phase 5's index ----------
    hdir = tempfile.mkdtemp(prefix="raft_tpu_torch_hnsw_")
    try:
        hpath = os.path.join(hdir, "cagra.hnsw")
        t0 = time.perf_counter()
        with phase("hnsw_export"):
            hnsw.serialize_to_hnswlib(hpath, cg, res=res)
        h_write = time.perf_counter() - t0
        h_size = os.path.getsize(hpath)
        t0 = time.perf_counter()
        with phase("hnsw_load"):
            h_idx = hnsw.load(hpath, cg.dim, res=res)
        h_read = time.perf_counter() - t0
    finally:
        shutil.rmtree(hdir, ignore_errors=True)
    check(phase_launches["hnsw_export"]["fused_knn"] > 0,
          "hnsw export: the upper levels' kNN launched fused_knn")
    check(torch.equal(h_idx.graph, cg.graph) and torch.equal(h_idx.dataset, cg.dataset),
          "hnsw load: base-layer links equal index.graph, rows equal the dataset")
    t0 = time.perf_counter()
    with phase("hnsw_search"):
        _, h_ids = hnsw.search(h_idx, q, K, ef=HNSW_EF, res=res)
    sync()
    h_wall = time.perf_counter() - t0
    h_tiles = -(-q.shape[0] // cagra.search_plan(cagra.SearchParams(itopk_size=HNSW_EF), h_idx,
                                                 q.shape[0], K, res)[2])
    hl = phase_launches["hnsw_search"]
    check(hl["cagra_traverse"] == h_tiles and hl["cagra_fused_hop"] == 0,
          f"hnsw search: {hl['cagra_traverse']} cagra_traverse launches = query tiles {h_tiles}")
    h_recall = recall_at_k(h_ids, gt_i, K)
    h_busy = measure_device_time(lambda: hnsw.search(h_idx, q, K, ef=HNSW_EF, res=res)) or math.nan
    print(f"hnsw: file {h_size / 2**20:.1f} MiB written in {h_write:.2f} s, loaded in "
          f"{h_read:.2f} s ({h_idx.entry_ids.shape[0]} upper-level entry points); search of "
          f"{q.shape[0]} queries at ef {HNSW_EF} {h_wall * 1e3:.1f} ms (device busy "
          f"{h_busy * 1e3:.2f} ms, share {h_busy / h_wall:.3f}), recall@{K} {h_recall:.5f}",
          flush=True)
    check(h_recall >= HNSW_RECALL, f"hnsw search recall@{K} {h_recall:.5f} >= {HNSW_RECALL}")
    del h_idx

    probe("phases 20-22")

    # -- phase 23: the observability substrate ------------------------------------
    from raft_tpu_torch import obs
    from raft_tpu_torch.obs import spans as obs_spans

    q64 = q[:QM_BATCH]
    for _ in range(20):
        ivf_flat.search(sp, index, q64, K, res=res)
    sync()
    walls = {True: [], False: []}
    for r in range(OBS_ROUNDS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            obs_spans.set_enabled(on)
            t0 = time.perf_counter()
            ivf_flat.search(sp, index, q64, K, res=res)
            sync()
            walls[on].append(time.perf_counter() - t0)
    obs_spans.set_enabled(True)
    on_ms, off_ms = (float(np.median(walls[v])) * 1e3 for v in (True, False))
    overhead = on_ms / off_ms - 1.0
    print(f"span overhead, {QM_BATCH}-query IVF-Flat search, median of {OBS_ROUNDS} "
          f"interleaved calls: spans on {on_ms:.4f} ms, off {off_ms:.4f} ms "
          f"({overhead * 100:+.2f} %)", flush=True)
    check(overhead < OBS_OVERHEAD, f"span overhead {overhead * 100:+.2f} % < "
          f"{OBS_OVERHEAD * 100:.0f} % of the {off_ms:.4f} ms disabled wall")
    prom = obs.to_prometheus()
    called = ("ivf_flat.build", "ivf_flat.search", "ivf_flat.save", "ivf_flat.load",
              "ivf_pq.build", "ivf_pq.search", "refine.refine", "brute_force.knn",
              "brute_force.build", "brute_force.search", "cagra.build", "cagra.search",
              "cagra.optimize", "cagra.compress", "cagra.save", "cagra.load",
              "nn_descent.build", "nn_descent.build_batch", "vpq_dataset.build",
              "hnsw.serialize_to_hnswlib", "hnsw.load", "hnsw.search", "kmeans.fit",
              "kmeans.predict", "kmeans_balanced.fit", "kmeans_balanced.predict",
              "pairwise.pairwise_distance", "fused_nn.fused_l2_nn", "matrix.select_k",
              "store.pager.ensure")
    missing = [name for name in called if f'raft_tpu_span_seconds_count{{span="{name}"}}' not in prom]
    check(not missing, f"to_prometheus has a span series of each of {len(called)} entry points "
          f"the phases called{f' (missing: {missing})' if missing else ''}")
    reg = obs.default_registry()
    builds = sum(reg.counter("raft_tpu_kernel_builds_total").collect().values())
    loads = reg.counter("raft_tpu_kernel_library_total").collect()
    n_sources = 0 if prebuilt else len(list(kernels.CSRC.glob("*.cu")))
    check(builds == n_sources and sum(loads.values()) == 1,
          f"kernel builds counted {builds:.0f} = sources this process built {n_sources}; "
          f"library loads {dict((dict(k_)['result'], v) for k_, v in loads.items())}")
    page = {key: reg.counter(f"raft_tpu_page_{key}_total").value(index=over_pager.name)
            for key in ("hits", "misses", "evictions")}
    check(page == {"hits": over_pager.hits, "misses": over_pager.misses,
                   "evictions": over_pager.evictions},
          f"over-budget IVF-Flat: registry page counters {page} equal the store's own")
    with cost.capture() as notes:
        ivf_flat.search(sp, index, q, K, res=res)
    rep = obs.analyze_callable(lambda: ivf_flat.search(sp, index, q, K, res=res))
    total = cost.noted_total(notes)
    rep_d = rep.to_dict() if rep is not None else {}
    print(f"analyze_callable, {q.shape[0]}-query IVF-Flat search: {json.dumps(rep_d)}; "
          f"noted {[n_ for n_, _ in notes]}", flush=True)
    check(total is not None and rep_d.get("flops") == total.flops
          and rep_d.get("bytes_accessed") == total.bytes_accessed
          and 0 < rep_d.get("utilization", 0.0) <= 1,
          f"analyze_callable: flops {rep_d.get('flops')} and bytes {rep_d.get('bytes_accessed')} "
          f"= the sum of {len(notes)} noted KernelCosts; roofline share "
          f"{rep_d.get('utilization')} <= 1")

    # -- phase 24: serving one index on the card ----------------------------------
    t24 = time.perf_counter()
    serving_phase(x=x, q=q, index=index, sp=sp, cg=cg, cagra_sp=cagra_sp,
                  cagra_batches=outputs["cagra batches"], table8=table8, res=res, check=check,
                  phase=phase, phase_launches=phase_launches, probes=probes)
    print(f"phase 24 (serving): {time.perf_counter() - t24:.1f} s", flush=True)

    # -- phase 25: serving's optional obs layers -------------------------------------
    t25 = time.perf_counter()
    obs_layers_phase(x=x, q=q, index=index, sp=sp, gt_i=gt_i, res=res, check=check,
                     phase=phase, phase_launches=phase_launches, smi=smi)
    print(f"phase 25 (obs layers): {time.perf_counter() - t25:.1f} s", flush=True)

    # -- phase 26: graphs and sparse ---------------------------------------------------
    t26 = time.perf_counter()
    graphs_phase(x=x, list_centers=index.centers, res=res, check=check, phase=phase,
                 phase_launches=phase_launches, record=record, main_launches=main_launches,
                 cuda_ms=cuda_ms, smi=smi)
    t26 = time.perf_counter() - t26
    print(f"phase 26 (graphs and sparse): {t26:.1f} s", flush=True)
    check(t26 <= GRAPH_PHASE_S, f"phase 26 took {t26:.1f} s <= {GRAPH_PHASE_S:.0f} s")

    for name in kernels.KERNELS:
        check(main_launches[name] > 0, f"{name} launched {main_launches[name]} times on the main path")
    print(f"phase launches (nonzero): "
          f"{json.dumps({ph: {n: c for n, c in d.items() if c} for ph, d in phase_launches.items()})}",
          flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    nums = [v for r in results for e in [r] + r.get("also", []) for v in e.values()
            if isinstance(v, float)]
    check(all(np.isfinite(v) for v in nums), f"every number of the kernels line is finite "
          f"({sum(not np.isfinite(v) for v in nums)} of {len(nums)} are not)")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def served_busy_share(directory: str, n_probes: int) -> dict:
    """Phase 24's busy share, in a process of its own: the index saved in
    ``directory`` behind phase 24's service, warmed and loaded once with the
    saved queries, then :func:`_served_window` windows of that load until one
    holds every launch's record.  Returns ``{"busy_s", "wall_s", "tries"}``."""
    import numpy as np
    import torch

    from raft_tpu_torch import kernels, serve
    from raft_tpu_torch.bench.device_time import busy_seconds
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import slowlog

    # as in phase 24: the open-loop load crosses the slow-query threshold by
    # design, and no automatic profiler capture may run beside the windows
    slowlog.configure(None)
    os.environ["RAFT_TPU_PERF_CAPTURE_S"] = "0"
    kernels.library()
    index = ivf_flat.load(os.path.join(directory, "flat.idx"), res=Resources(device="cuda"))
    queries = np.load(os.path.join(directory, "queries.npy"))
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    svc = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0)
    busy, wall, tries = None, float("nan"), []
    try:
        svc.add_index("flat", serve.MutableIndex(index, search_params=ivf_flat.SearchParams(
            n_probes=n_probes)), warmup=True)
        _drive(svc, "flat", queries, check)
        for _ in range(SERVE_TRACE_ATTEMPTS):
            win = _served_window(svc, queries, check)
            tries.append((win["records"], win["launched"], win["missing"]))
            wall = win["wall_s"]
            if win["spans"] and not win["missing"]:
                busy = busy_seconds(win["spans"]) / 1e6
                break
    finally:
        svc.stop()
    torch.cuda.synchronize()
    return {"busy_s": None if failures else busy, "wall_s": wall, "tries": tries + failures}


def _served_window(svc, queries, check) -> dict:
    """One ``torch.profiler`` window of ``queries`` served by ``svc`` (the
    window of ``bench.device_time.trace_device_spans``), held to the
    launches counted in it.
    Besides the device records and the launches without one, it lists each
    CUDA launch call of the window whose correlation id has no device
    record (its position among the window's launch calls, its name and its
    ms after the window opened), and the least ms from a launch call to its
    kernel's start on the card (ROADMAP Q3.8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch import kernels
    from raft_tpu_torch.bench.device_time import is_device_work, missing_records

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _drive(svc, "flat", queries, check)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = kernels.launch_counts()
    launched = {n: after[n] - before[n] for n in after if after[n] > before[n]}
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if is_device_work(e)]
    results = prof.profiler.kineto_results
    raw = list(results.events())
    cuda = torch.autograd.DeviceType.CUDA
    started = {e.correlation_id(): e.start_ns() for e in raw if e.device_type() == cuda}
    calls = sorted((e for e in raw if e.device_type() != cuda
                    and e.name().startswith("cudaLaunchKernel")), key=lambda e: e.start_ns())
    opened = (results.trace_start_ns() if hasattr(results, "trace_start_ns")
              else calls[0].start_ns() if calls else 0)
    lost = [(i, e.name(), round((e.start_ns() - opened) / 1e6, 3))
            for i, e in enumerate(calls) if e.correlation_id() not in started]
    gaps = [started[e.correlation_id()] - e.start_ns() for e in calls
            if e.correlation_id() in started]
    return {"records": len(spans), "launched": launched,
            "missing": missing_records(spans, launched), "spans": spans, "wall_s": wall,
            "launch_calls": len(calls), "calls_without_record": len(lost),
            "first_calls_without_record": lost[:6],
            "launch_to_start_ms_min": min(gaps) / 1e6 if gaps else None}


def served_window_probe(index, sp, queries, where: str, check, probes: list) -> None:
    """Q3.8's probe: a fresh service over ``index`` (phase 24's settings),
    warmed with ``queries``, and one :func:`_served_window` of them, appended
    to ``probes`` and printed with the card's memory in use.  Not checked:
    it records where in this process the served load's windows start to
    lose device records."""
    import torch

    from raft_tpu_torch import serve
    from raft_tpu_torch.obs import profiler as obs_profiler
    from raft_tpu_torch.obs import slowlog

    # as in phase 24: no slow-query log and no automatic capture beside the
    # window, both restored after it
    slow_ms, capture_s = slowlog.threshold_ms(), os.environ.get("RAFT_TPU_PERF_CAPTURE_S")
    slowlog.configure(None)
    os.environ["RAFT_TPU_PERF_CAPTURE_S"] = "0"
    svc = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0)
    try:
        svc.add_index("flat", serve.MutableIndex(index, search_params=sp), warmup=True)
        _drive(svc, "flat", queries, check)
        win = _served_window(svc, queries, check)
    finally:
        svc.stop()
        slowlog.configure(slow_ms)
        if capture_s is None:
            os.environ.pop("RAFT_TPU_PERF_CAPTURE_S", None)
        else:
            os.environ["RAFT_TPU_PERF_CAPTURE_S"] = capture_s
    win.pop("spans")
    last = obs_profiler.last_capture()
    free, total = torch.cuda.mem_get_info()
    probes.append({"where": where, **win,
                   "last_capture": None if last is None else last.get("reason"),
                   "card_used_gib": (total - free) / 2**30,
                   "torch_reserved_gib": torch.cuda.memory_reserved() / 2**30})
    print(f"served-load window (Q3.8, not checked) after {where}: {json.dumps(probes[-1])}",
          flush=True)


def _drive(svc, name, queries, check, threads=SERVE_THREADS, kw_of=None, latencies=None):
    """``queries`` sent as single-query requests (``kw_of(i)``: their ragged
    k / fid) from ``threads`` client threads, all submitted before any is
    awaited: the answers (a list, by request) and the wall seconds.  With a
    ``latencies`` list, each request's seconds from submit to answer are
    appended to it."""
    out = [None] * queries.shape[0]
    errors = []

    def client(t):
        try:
            futs = []
            for i in range(t, queries.shape[0], threads):
                t_sub = time.perf_counter()
                f = svc.submit(name, queries[i], **(kw_of(i) if kw_of else {}))
                if latencies is not None:
                    f.add_done_callback(
                        lambda _f, t_sub=t_sub: latencies.append(time.perf_counter() - t_sub))
                futs.append((i, f))
            for i, f in futs:
                out[i] = f.result(SERVE_WAIT_S)
        except Exception as exc:  # noqa: BLE001 — reported by the check below
            errors.append(repr(exc))

    workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    check(not errors and not any(w.is_alive() for w in workers),
          f"{name}: {queries.shape[0]} requests from {threads} threads answered "
          f"({errors[:2]})")
    return out, wall


def _stack(answers):
    import numpy as np

    return (np.stack([a[0] for a in answers]), np.stack([a[1] for a in answers]))


def serving_phase(*, x, q, index, sp, cg, cagra_sp, cagra_batches, table8, res, check, phase,
                  phase_launches, probes):
    """Phase 24: raft_tpu's README serving path on the card (see the module
    docstring).  Returns nothing; every check goes through ``check``."""
    import numpy as np
    import torch

    from raft_tpu_torch import serve
    from raft_tpu_torch.core.bitset import RowFilter
    from raft_tpu_torch.obs import slowlog
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.stats.metrics import recall_at_k

    qn = q.cpu().numpy()
    n_q, n_rows = qn.shape[0], x.shape[0]
    serve_phases = []
    # the open-loop clients queue every request at once, so queue waits
    # cross the slow-query threshold by design (as raft_tpu's serving bench
    # legs do, the log is off for the phase); and the perf ledger's
    # automatic profiler capture on a device-time trip would run beside the
    # phase's own profiler window, so it is off too
    slowlog.configure(None)
    os.environ["RAFT_TPU_PERF_CAPTURE_S"] = "0"

    def serve_phase(name):
        serve_phases.append(name)
        return phase(name)

    def report(svc, name, tag):
        st = svc.stats(name)
        print(f"serve {tag}: qps {st['qps']}, p50 {st['p50_ms']} ms, p99 {st['p99_ms']} ms, "
              f"batch fill {st['batch_fill']}, batches {st['batches']}, requests "
              f"{st['requests']}, recompiles {st['recompiles']}, warmup builds "
              f"{st['warmup_compiles']}, kernel paths {st['kernel_paths']}, stages "
              f"{json.dumps(st['stages'])}", flush=True)
        return st

    # 1-2: the IVF-Flat service, each answer against the query alone
    svc = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0,
                              compaction=serve.CompactionPolicy())
    svc.pause_compaction()
    mi = serve.MutableIndex(index, search_params=sp)
    with serve_phase("serve_warmup"):
        svc.add_index("flat", mi, warmup=True)
    with serve_phase("serve_ivf_flat"):
        answers, wall = _drive(svc, "flat", qn, check)
    d2, i2 = _stack(answers)
    st = report(svc, "flat", f"{n_q} single-query requests, {wall:.3f} s wall, "
                f"{n_q / wall:.0f} requests/s,")
    check(st["recompiles"] == 0, f"no kernel build or library load on the dispatch thread "
          f"after warmup (recompiles {st['recompiles']})")
    check(st["kernel_paths"] and set(st["kernel_paths"]) == {"cuda"},
          f"every served batch stamped kernel_path cuda ({st['kernel_paths']})")
    alone = [ivf_flat.search(sp, index, q[i:i + 1], K, res=res) for i in range(n_q)]
    ref_d = torch.cat([a[0] for a in alone]).cpu().numpy()
    ref_i = torch.cat([a[1] for a in alone]).cpu().numpy()
    same_bits = float((d2.view(np.int32) == ref_d.view(np.int32)).mean())
    check(np.array_equal(i2, ref_i) and np.allclose(d2, ref_d, rtol=RTOL, atol=ATOL),
          f"each of the {n_q} served answers equals ivf_flat.search of that query alone: ids "
          f"equal on {float((i2 == ref_i).mean()):.6f} of slots, distances bitwise on "
          f"{same_bits:.6f}")
    # Q3.8: late in this long process a window of the batcher's launches
    # loses the records of its first launches (in torch's events and in
    # kineto's raw ones alike), where a fresh process keeps every record.
    # This service's own window is recorded beside the earlier probes; the
    # checked busy share is taken in a process of its own, over this index
    # saved and loaded back
    win = _served_window(svc, qn[:SERVE_TRACED], check)
    win.pop("spans")
    probes.append({"where": "phase 24's own service", **win})
    print(f"served-load windows in this process (Q3.8, not checked): "
          f"{[(p_['where'], p_['missing']) for p_ in probes]}; phase 24's own: "
          f"{json.dumps(probes[-1])}", flush=True)
    busy_dir = tempfile.mkdtemp(prefix="chip_smoke_busy_")
    try:
        ivf_flat.save(os.path.join(busy_dir, "flat.idx"), index)
        np.save(os.path.join(busy_dir, "queries.npy"), qn[:SERVE_TRACED])
        child = subprocess.run([sys.executable, os.path.abspath(__file__), SERVED_BUSY_FLAG,
                                busy_dir, str(sp.n_probes)],
                               capture_output=True, text=True, timeout=SERVE_WAIT_S,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
    finally:
        shutil.rmtree(busy_dir, ignore_errors=True)
    try:
        measured = json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        measured = {"busy_s": None, "wall_s": float("nan"), "tries": child.stderr[-2000:]}
    busy, wall, tries = measured["busy_s"], measured["wall_s"], measured["tries"]
    share = busy / wall if busy else float("nan")
    print(f"serve busy share (its own process): {SERVE_TRACED} single-query requests, device "
          f"busy {busy if busy is None else round(busy * 1e3, 3)} ms in {wall * 1e3:.1f} ms "
          f"wall, share {share:.4f}; windows (device records, launches, launches without a "
          f"record): {tries}", flush=True)
    check(busy is not None and 0 < share <= 1, f"busy share of the served load {share:.4f} in (0, 1]")

    # 3: pipeline depth 1 gives the same bytes
    svc1 = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0, pipeline_depth=1)
    try:
        svc1.add_index("flat", serve.MutableIndex(index, search_params=sp), warmup=True)
        with serve_phase("serve_depth1"):
            answers1, wall1 = _drive(svc1, "flat", qn, check)
        report(svc1, "flat", f"depth 1, {wall1:.3f} s wall, {n_q / wall1:.0f} requests/s,")
    finally:
        svc1.stop()
    d1, i1 = _stack(answers1)
    check(np.array_equal(i1, i2) and np.array_equal(d1.view(np.int32), d2.view(np.int32)),
          "pipeline depth 1 and 2 give the same bytes")

    # 4: mutations while two threads search
    rng = np.random.default_rng(SEED + 24)
    src = torch.from_numpy(rng.choice(n_rows, SERVE_UPSERTS, replace=False)).to(x.device)
    new_rows = (x[src].cpu().numpy()
                + rng.standard_normal((SERVE_UPSERTS, x.shape[1])).astype(np.float32)
                * np.float32(SERVE_NOISE))
    del_ids = rng.choice(n_rows, int(SERVE_DELETE * n_rows), replace=False)
    stop = threading.Event()
    seen, errs = [0, 0], []

    def searcher(t):
        j = t
        while not stop.is_set():
            try:
                d, i = svc.search("flat", qn[j % n_q], timeout=SERVE_WAIT_S)
                seen[t] += int(np.isfinite(d).all() and i.shape == (K,))
            except Exception as exc:  # noqa: BLE001 — reported by the check below
                errs.append(repr(exc))
                return
            j += 2

    up_ids = []
    with serve_phase("serve_mutate"):
        workers = [threading.Thread(target=searcher, args=(t,)) for t in range(2)]
        for w in workers:
            w.start()
        t0 = time.perf_counter()
        per = SERVE_UPSERTS // SERVE_ROUNDS
        per_del = del_ids.shape[0] // SERVE_ROUNDS
        for r in range(SERVE_ROUNDS):
            up_ids.append(mi.upsert(new_rows[r * per:(r + 1) * per]))
            mi.delete(del_ids[r * per_del:(r + 1) * per_del])
            # each round is searched before the next lands
            served, t_round = sum(seen), time.perf_counter()
            while (sum(seen) < served + 2 and not errs
                   and time.perf_counter() - t_round < SERVE_WAIT_S):
                time.sleep(1e-3)
        t_mut = time.perf_counter() - t0
        stop.set()
        for w in workers:
            w.join(SERVE_WAIT_S)
    up_ids = np.concatenate(up_ids)
    print(f"serve mutations: {SERVE_UPSERTS} upserts and {del_ids.shape[0]} deletes in "
          f"{SERVE_ROUNDS} rounds, {t_mut:.3f} s, while 2 threads served {sum(seen)} searches; "
          f"pending {mi.pending_mutations()}", flush=True)
    check(not errs and sum(seen) > 0 and not any(w.is_alive() for w in workers),
          f"searches during the mutations all answered ({sum(seen)}, errors {errs[:2]})")
    with serve_phase("serve_after_mutation"):
        up_answers, _ = _drive(svc, "flat", new_rows, check)
        q_answers, _ = _drive(svc, "flat", qn, check)
    _, up_i = _stack(up_answers)
    _, q_i = _stack(q_answers)
    check(np.array_equal(up_i[:, 0], up_ids), f"each of the {SERVE_UPSERTS} upserted rows "
          f"queried by itself returns its own id first "
          f"({int((up_i[:, 0] == up_ids).sum())} do)")
    check(not np.isin(q_i, del_ids).any() and not np.isin(up_i, del_ids).any(),
          f"no deleted id among {q_i.size + up_i.size} returned ids")

    # 5: ragged requests with table8 filter ids
    svc_r = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0,
                                ragged=serve.RaggedSpec(k_max=K))
    try:
        svc_r.add_index("flat", mi)
        table = table8.cpu().numpy()
        fids = [svc_r.register_filter("flat", table[r]) for r in range(table.shape[0])]
        svc_r.warmup("flat")
        kq = rng.integers(1, K + 1, SERVE_RAGGED)
        fq = rng.choice(fids, SERVE_RAGGED)
        with serve_phase("serve_ragged"):
            r_answers, r_wall = _drive(svc_r, "flat", qn[:SERVE_RAGGED], check,
                                      kw_of=lambda i: dict(k=int(kq[i]), fid=int(fq[i])))
        report(svc_r, "flat", f"ragged, {SERVE_RAGGED} requests, {r_wall:.3f} s wall,")
        st_r = svc_r.stats("flat")
    finally:
        svc_r.stop()
    planes = np.vstack([np.ones((1, n_rows), bool), table])
    bad, shapes = 0, 0
    for (d, i), k_, f_ in zip(r_answers, kq, fq):
        shapes += int(i.shape != (k_,) or d.shape != (k_,))
        main_ids = i[(i >= 0) & (i < n_rows)]
        bad += int((~planes[f_][main_ids]).sum() + np.isin(i, del_ids).sum() + (i < 0).sum())
    check(shapes == 0 and bad == 0 and st_r["recompiles"] == 0,
          f"ragged: every answer has its own k, no id fails its request's filter or was "
          f"deleted, no -1 ({bad} bad ids, {shapes} bad shapes)")
    direct = []
    for b in range(0, SERVE_RAGGED, 64):
        rows = slice(b, min(b + 64, SERVE_RAGGED))
        rf = RowFilter.from_mask_rows(torch.from_numpy(planes[fq[rows]]).to(x.device))
        direct.append(mi.search(q[rows], K, sample_filter=rf,
                                row_k=torch.from_numpy(kq[rows].astype(np.int32)))[1])
    direct = torch.cat(direct).cpu().numpy()
    check(all(np.array_equal(i, direct[n, :k_]) for n, ((_, i), k_) in
              enumerate(zip(r_answers, kq))),
          "ragged answers equal the direct filtered search of the same queries (ids)")
    check(phase_launches["serve_ragged"]["ivf_scan_query_major_fid"] > 0,
          "ragged filtered requests launched the query_fid leg (#6)")

    # 6: compaction
    rows_h, gids = mi.live_vectors()
    _, o = brute_force.knn(torch.from_numpy(rows_h).to(x.device), q, K, res=res)
    oracle = gids[o.cpu().numpy()]
    recall_before = recall_at_k(q_i, oracle, K)
    del rows_h
    with serve_phase("serve_compact"):
        t0 = time.perf_counter()
        result = svc.compact_now("flat")
        t_compact = time.perf_counter() - t0
    print(f"serve compaction: {t_compact:.3f} s, {json.dumps(result, default=str)}", flush=True)
    check(result.get("status") == "promoted", f"compact_now promoted ({result.get('status')}, "
          f"{result.get('detail')})")
    # the extend's assignment is kmeans_balanced.predict, raft_tpu's
    # pairwise.tiled_argmin (the distance tile and its argmin, plain ops in
    # both packages): kernel #7 is on no serving path
    check(phase_launches["serve_compact"]["fused_knn"] > 0,
          "compaction's quality gate launched fused_knn (#2) for its exact oracle")
    with serve_phase("serve_after_compact"):
        c_answers, _ = _drive(svc, "flat", qn, check)
        up_c, _ = _drive(svc, "flat", new_rows[:1000], check)
    _, c_i = _stack(c_answers)
    recall_after = recall_at_k(c_i, oracle, K)
    print(f"serve recall@{K} against brute force over the live rows: before compaction "
          f"{recall_before:.5f}, after {recall_after:.5f}", flush=True)
    check(recall_after >= recall_before, f"compacted index recall@{K} {recall_after:.5f} >= "
          f"{recall_before:.5f} before")
    check(np.array_equal(_stack(up_c)[1][:, 0], up_ids[:1000]),
          "after compaction 1,000 upserted rows still find their own ids first")
    st = report(svc, "flat", "after compaction")
    check(st["recompiles"] == 0 and st["version"] == 2 and st["side_rows"] == 0,
          f"after compaction: version {st['version']}, side rows {st['side_rows']}, "
          f"recompiles {st['recompiles']}")
    health = svc.healthz()
    prom = svc.prometheus()
    plan = svc.explain("flat", qn[0])
    check(health["status"] in ("OK", "DEGRADED") and 'raft_tpu_serve_requests_total{index="flat"}'
          in prom and plan["kernel_path"] == "cuda" and plan["probe"]["n_probes"] == sp.n_probes,
          f"healthz {health['status']} (index checks "
          f"{ {k: v['status'] for k, v in health['indexes']['flat']['checks'].items()} }; "
          f"memory {health['memory']['detail']}; perf {health.get('perf')}), "
          f"prometheus serve series, explain kernel_path {plan['kernel_path']}")
    svc.stop()

    # 7: CAGRA through a second service
    svc_c = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0)
    try:
        svc_c.add_index("cagra", serve.MutableIndex(cg, search_params=cagra_sp), warmup=True)
        with serve_phase("serve_cagra"):
            futs = [svc_c.submit("cagra", qn[b * QM_BATCH:(b + 1) * QM_BATCH])
                    for b in range(QM_BATCHES)]
            c_out = [f.result(SERVE_WAIT_S) for f in futs]
        report(svc_c, "cagra", f"{QM_BATCHES} x {QM_BATCH}-query requests,")
    finally:
        svc_c.stop()
    cd = np.concatenate([a[0] for a in c_out])
    ci = np.concatenate([a[1] for a in c_out])
    want_d, want_i = (t.cpu().numpy() for t in cagra_batches)
    check(np.array_equal(ci, want_i) and np.array_equal(cd.view(np.int32), want_d.view(np.int32)),
          f"served CAGRA batches equal cagra.search of the same batches bitwise "
          f"(ids equal on {float((ci == want_i).mean()):.6f})")
    check(phase_launches["serve_cagra"]["cagra_traverse"] > 0, "served CAGRA launched the walk (#8)")
    launched = {}
    for ph in serve_phases:
        for name, c in phase_launches[ph].items():
            if c:
                launched[name] = launched.get(name, 0) + c
    print(f"serve launches in phase 24: {json.dumps(launched)}", flush=True)
    for name in ("select_k", "fused_knn", "ivf_scan_query_major", "ivf_scan_query_major_fid",
                 "cagra_traverse"):
        check(launched.get(name, 0) > 0, f"phase 24 launched {name} through the service "
              f"({launched.get(name, 0)})")


def obs_layers_phase(*, x, q, index, sp, gt_i, res, check, phase, phase_launches, smi):
    """Phase 25: serving's optional obs layers on the card (see the module
    docstring).  Every file it writes goes under one temporary directory,
    removed at the end; every check goes through ``check``."""
    import copy
    import secrets
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from raft_tpu_torch import obs, serve
    from raft_tpu_torch.bench import frontier as bench_frontier
    from raft_tpu_torch.bench import runner
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors import effort as neighbors_effort
    from raft_tpu_torch.obs import events, incidents
    from raft_tpu_torch.obs import quality as obs_quality
    from raft_tpu_torch.stats.metrics import recall_at_k

    def sync():
        torch.cuda.synchronize()

    qn = q.cpu().numpy()
    n_q, dev = qn.shape[0], x.device
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    keep_env = {k: os.environ.get(k) for k in (
        "RAFT_TPU_BENCH_RECORD", "RAFT_TPU_FLIGHT_DIR", "RAFT_TPU_INCIDENT_DIR",
        "RAFT_TPU_SLO_EVAL_S")}
    # the sweep's record, the alarm's flight dumps and incident exports go
    # to the temporary directory
    os.environ["RAFT_TPU_BENCH_RECORD"] = os.path.join(tmp, "frontier_record.json")
    os.environ["RAFT_TPU_FLIGHT_DIR"] = tmp
    os.environ["RAFT_TPU_INCIDENT_DIR"] = tmp
    seen = []
    sub = events.subscribe(seen.append, kinds=frozenset({"quality_alarm", "slo_burn",
                                                         "autotune_step"}),
                           name="chip_smoke_obs")
    cost = {"device": smi}
    services = []
    try:
        # 1: the frontier sweep at its defaults, serve backends only, as a
        # user runs it: in a process of its own (whose torch.profiler windows
        # hold every kernel record; this process has run many windows), its
        # launches read from the artifact
        sweep_out = os.path.join(tmp, "frontier_cuda.json")
        model_out = os.path.join(tmp, "frontier_model_cuda.json")
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "raft_tpu_torch.bench", "frontier",
                              *FRONTIER_ARGS, "--sweep-out", sweep_out, "--out", model_out],
                             capture_output=True, text=True, timeout=SERVE_WAIT_S,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        cost["sweep_s"] = time.perf_counter() - t0
        print(cli.stdout[-3000:], cli.stderr[-2000:], flush=True)
        check(cli.returncode == 0, f"python -m raft_tpu_torch.bench frontier "
              f"{' '.join(FRONTIER_ARGS)} exited 0 ({cli.returncode})")
        model = obs.FrontierModel.load(model_out)
        doc = json.load(open(sweep_out))
        backends = set(bench_frontier.SERVE_BACKENDS.values())
        check(set(model.backends()) == backends and all(model.points[b] for b in backends),
              f"the frontier model loads with pareto points for every serve backend "
              f"({ {b: len(p) for b, p in model.points.items()} }, {len(doc['results'])} "
              f"swept points)")
        params_cls = {"ivf_flat": ivf_flat.SearchParams, "ivf_pq": ivf_pq.SearchParams,
                      "cagra": cagra.SearchParams}
        actuated, bad_points = 0, []
        for backend, points in model.points.items():
            for p in points:
                effort = dict(p.effort)
                extra = {"refine_ratio": effort.pop("refine_ratio")} if "refine_ratio" in effort else {}
                if backend == "brute_force":
                    ok = not effort and not extra
                else:
                    params = params_cls[backend](**effort)
                    spec = neighbors_effort.spec_for_params(params, **extra)
                    ok = spec is not None and spec.backend == backend and spec.apply(params) == params
                actuated += ok
                if not ok or p.device_s_per_query is None:
                    bad_points.append((backend, p.to_dict()))
        check(not bad_points, f"each of {actuated} pareto points is a knob set its backend's "
              f"EffortSpec actuates, with its device seconds per query measured "
              f"({bad_points[:3]})")
        paths = {a: u["kernel_path"] for a, u in doc["kernels"].items()}
        check(set(paths.values()) == {"cuda"},
              f"every swept algorithm's searches took the cuda leg ({paths})")
        sl = {}
        for used in doc["kernels"].values():
            for n_, c in used["launches"].items():
                sl[n_] = sl.get(n_, 0) + c
        print(f"sweep launches: {json.dumps(sl)}", flush=True)
        scans = sum(c for n_, c in sl.items() if n_.startswith("ivf_scan_"))
        check(sl.get("select_k", 0) > 0 and sl.get("fused_knn", 0) > 0 and scans > 0
              and sl.get("cagra_traverse", 0) > 0,
              f"the sweep launched select_k {sl.get('select_k')}, fused_knn "
              f"{sl.get('fused_knn')}, the IVF scans {scans} and the CAGRA walk "
              f"{sl.get('cagra_traverse')}")
        best = {}
        for r in doc["results"]:
            if r["recall"] >= 0.9 and r["qps"] > best.get(r["algo"], {}).get("qps", 0.0):
                best[r["algo"]] = {"qps": r["qps"], "recall": r["recall"],
                                   "search_param": r["search_param"]}
        cost["sweep_best_at_recall_0.9"] = best
        print(f"frontier sweep: {cost['sweep_s']:.1f} s; best QPS at recall >= 0.9 per "
              f"algorithm {json.dumps(best)}; build s {json.dumps(doc['build_seconds'])} "
              f"[{smi}]", flush=True)

        # 2: the served index's own frontier, at its effort ladder's n_probes;
        # device seconds from CUDA events on the stream around the searches
        levels = serve.EffortArbiter(None).levels()
        base = neighbors_effort.spec_for_params(sp)
        results = []
        for level in levels:
            lp = base.degraded(level).apply(sp)
            ivf_flat.search(lp, index, q, K, res=res)
            sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(3):
                _, ids = ivf_flat.search(lp, index, q, K, res=res)
            end.record()
            sync()
            dt = (time.perf_counter() - t0) / 3
            dev_s = start.elapsed_time(end) / 3 / 1e3
            results.append(runner.RunResult(
                algo="raft_tpu_ivf_flat", dataset="sift-128-euclidean", k=K,
                build_param={"n_lists": index.n_lists}, search_param={"n_probes": lp.n_probes},
                build_time_s=0.0, qps=n_q / dt, latency_ms=dt / n_q * 1e3,
                recall=recall_at_k(ids, gt_i, K), end_to_end_s=dt, device_time_s=dev_s,
                device_qps=None if not dev_s else n_q / dev_s))
        served_model = bench_frontier.frontier_model(results, n_queries=n_q, meta={
            "dataset": "sift-128-euclidean", "n": int(x.shape[0]), "k": K, "platform": "cuda"})
        cost["served_frontier"] = [{"n_probes": r.search_param["n_probes"], "qps": r.qps,
                                    "recall": r.recall, "device_s": r.device_time_s}
                                   for r in results]
        print(f"served index frontier (levels {list(levels)}): "
              f"{json.dumps(cost['served_frontier'])}; pareto "
              f"{[p.to_dict() for p in served_model.points['ivf_flat']]}", flush=True)
        check(all(r.device_time_s for r in results),
              "every level of the served frontier has its device time measured")

        # the service with all four layers; its own SLO and autotune ticks
        # never run: the phase drives both on a synthetic clock
        os.environ["RAFT_TPU_SLO_EVAL_S"] = "86400"
        token = secrets.token_hex(16)
        auditor = obs.QualityAuditor()
        tuner = obs.Autotuner(frontier=served_model)
        svc = serve.SearchService(
            k=K, max_batch=64, max_delay_ms=2.0, compaction=serve.CompactionPolicy(),
            auditor=auditor, slo=True, autotune=tuner,
            gateway=obs.GatewayConfig(port=0, admin=True, token=token))
        services.append((svc, auditor, tuner))
        svc.pause_compaction()
        mi = serve.MutableIndex(index, search_params=sp)
        with phase("obs_warmup"):
            svc.add_index("flat", mi, warmup=True)
        arb = svc.effort_arbiter("flat")
        state = tuner._states["flat"]
        clock = [1000.0]

        def tick(n=1, dt=OBS_TICK_S):
            out = []
            for _ in range(n):
                clock[0] += dt
                svc.slo_engine.evaluate_once(now=clock[0])
                out.append(tuner.step("flat", now=clock[0]))
            return out

        mismatched = []
        with phase("obs_levels"):
            for level in levels:
                arb.set_autotune_level(level)
                lp = arb.apply(mi) or sp
                futs = [svc.submit("flat", qn[b * QM_BATCH:(b + 1) * QM_BATCH])
                        for b in range(QM_BATCHES)]
                for b, f in enumerate(futs):
                    d, i = f.result(SERVE_WAIT_S)
                    wd, wi = ivf_flat.search(lp, index, q[b * QM_BATCH:(b + 1) * QM_BATCH], K,
                                             res=res)
                    if not (np.array_equal(i, wi.cpu().numpy())
                            and np.array_equal(d.view(np.int32), wd.cpu().numpy().view(np.int32))):
                        mismatched.append((level, b))
        arb.set_autotune_level(0)
        st = svc.stats("flat")
        check(not mismatched, f"at every autotune level {list(levels)} the served "
              f"{QM_BATCHES} x {QM_BATCH}-query batches equal ivf_flat.search at that "
              f"level's n_probes bitwise ({mismatched[:4]})")
        check(st["recompiles"] == 0, f"no kernel build or library load on the dispatch "
              f"thread while the level moved (recompiles {st['recompiles']})")
        target = tuner._target_level(state)
        walk = tick(3 * max(1, target) + 3)
        print(f"autotuner: frontier predictions {state.predictions}, target level {target}; "
              f"calm ticks walk {walk}", flush=True)
        check(walk[-1] == target, f"calm ticks walk the level to the frontier optimum "
              f"{target} ({walk})")

        # 3: the auditor under phase 24's load, at its defaults
        lat = []
        with phase("obs_load"):
            answers, wall = _drive(svc, "flat", qn, check, latencies=lat)
        t0 = time.perf_counter()
        flushed = auditor.flush(SERVE_WAIT_S)
        cost["audit_backlog_s"] = time.perf_counter() - t0
        snap = auditor.snapshot()
        ewma = auditor.recall_ewma("flat")
        cost["auditor"] = {k: snap[k] for k in ("submitted", "processed", "dropped", "errors")}
        print(f"auditor under {n_q} single-query requests at level {arb.autotune_level} "
              f"({wall:.3f} s, {n_q / wall:.0f} requests/s, p50 "
              f"{np.percentile(lat, 50) * 1e3:.1f} ms, p99 {np.percentile(lat, 99) * 1e3:.1f} "
              f"ms): {json.dumps(snap['indexes'].get('flat'))}, {cost['auditor']}, backlog "
              f"drained in {cost['audit_backlog_s']:.2f} s", flush=True)
        check(flushed and snap["processed"] > 0 and ewma is not None and ewma >= 0.9,
              f"audited {snap['processed']} batches (dropped {snap['dropped']}, errors "
              f"{snap['errors']}); recall EWMA {ewma} >= 0.9")
        rows_t = []
        for _ in range(2):
            t0 = time.perf_counter()
            vecs, vec_ids = mi.live_vectors()
            rows_t.append(time.perf_counter() - t0)
        oracle_t = []
        for b in range(3):
            t0 = time.perf_counter()
            obs_quality._exact_topk(vecs, vec_ids, qn[b * QM_BATCH:(b + 1) * QM_BATCH], K,
                                    mi.metric)
            oracle_t.append(time.perf_counter() - t0)
        del vecs, vec_ids
        cost["live_vectors_s"] = rows_t
        cost["oracle_s_per_batch"] = oracle_t
        print(f"live_vectors() of {mi.size} rows: {rows_t} s; the oracle of one "
              f"{QM_BATCH}-query batch: {oracle_t} s [{smi}]", flush=True)
        levels_load = tick(3)
        paging = svc.slo_engine.paging()
        cost["default_objective_after_load"] = {
            "paging": paging, "levels": levels_load,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}
        budgets = {s_.name: svc.slo_engine.budget_remaining(s_.name)
                   for s_ in svc.slo_engine.specs()}
        print(f"after the load, the default objectives: paging {paging}, budgets {budgets}; "
              f"autotune levels over 3 ticks {levels_load}", flush=True)

        # a corrupted index: coarse centers shuffled, the lists untouched
        level_before = arb.autotune_level
        bad = copy.copy(index)
        perm = np.random.default_rng(SEED + 25).permutation(index.n_lists)
        bad.centers = index.centers[torch.from_numpy(perm).to(dev)]
        n_alarms = sum(e.kind == "quality_alarm" and not e.recovered for e in seen)
        version_bad = svc.swap("flat", serve.MutableIndex(bad, search_params=sp))

        def serve_until(done, limit=2000):
            """64-query batches until ``done()``, each sampled batch audited
            before the next is sent: the batches it took."""
            for b in range(limit):
                svc.search("flat", qn[(b % QM_BATCHES) * QM_BATCH:
                                      ((b % QM_BATCHES) + 1) * QM_BATCH], timeout=SERVE_WAIT_S)
                auditor.flush(SERVE_WAIT_S)
                if done():
                    return b + 1
            return limit

        with phase("obs_corrupt"):
            before = auditor.snapshot()["submitted"]
            sent = serve_until(lambda: auditor.snapshot()["submitted"] > before)
            auditor.flush(SERVE_WAIT_S)
        alarms = [e for e in seen if e.kind == "quality_alarm" and not e.recovered][n_alarms:]
        open_inc = [i.to_dict() for i in incidents.default_manager().open_incidents()]
        report = svc.healthz()
        print(f"corrupted swap v{version_bad}: {sent} batches until a sample, alarms "
              f"{[(e.fields['version'], round(e.fields['ewma'], 4)) for e in alarms]}, open "
              f"incidents {[(i['id'], i['reason']) for i in open_inc]}, healthz "
              f"{report['status']} (recall {report['indexes']['flat']['checks']['recall']})",
              flush=True)
        check(len(alarms) == 1 and alarms[0].fields["version"] == version_bad,
              f"after one flush the alarm fired once, for the corrupted version "
              f"({len(alarms)} alarms)")
        check(any("quality_alarm" in json.dumps(i, default=str) for i in open_inc),
              "an open incident holds the quality_alarm")
        check(report["status"] != "OK", f"healthz is not OK ({report['status']})")
        raised = tick()
        last = [e for e in seen if e.kind == "autotune_step"][-1:]
        if level_before > 0:
            check(raised[-1] == level_before - 1 and last
                  and last[0].fields["step_reason"] == "recall_floor",
                  f"the autotuner raised effort {level_before} -> {raised[-1]} for reason "
                  f"{last[0].fields['step_reason'] if last else None}")
        raised += tick(arb.autotune_level)
        # repair the served version in place: its EWMA climbs back
        bad.centers = index.centers
        with phase("obs_repair"):
            serve_until(lambda: any(e.kind == "quality_alarm" and e.recovered
                                    and e.fields.get("version") == version_bad for e in seen))
            auditor.flush(SERVE_WAIT_S)
        recovered = [e for e in seen if e.kind == "quality_alarm" and e.recovered]
        check(bool(recovered) and recovered[-1].fields["version"] == version_bad,
              f"repairing the served version published the recovery edge (quality_alarm "
              f"recovered=True, EWMA {auditor.recall_ewma('flat')})")
        version_good = svc.swap("flat", mi)
        with phase("obs_swap_back"):
            before = auditor.snapshot()["submitted"]
            serve_until(lambda: auditor.snapshot()["submitted"] > before)
            auditor.flush(SERVE_WAIT_S)
        st_q = auditor.snapshot()["indexes"]["flat"]
        check(st_q["version"] == version_good and not st_q["alarmed"]
              and st_q["recall_ewma"] >= 0.9,
              f"swapping back (v{version_good}) starts a fresh EWMA {st_q['recall_ewma']:.4f}, "
              f"not alarmed; autotune levels {raised}")

        # 4: a latency objective the open-loop load breaks
        svc.slo_engine.add_spec(obs.SloSpec("flat-latency", "flat", "latency", objective=0.99,
                                            target=OBS_TIGHT_P99_S))
        arb.set_autotune_level(0)
        n_burns = sum(e.kind == "slo_burn" and not e.recovered for e in seen)
        with phase("obs_burn"):
            _drive(svc, "flat", qn[:SERVE_TRACED], check)
        burn_levels = tick(tuner.degrade_ticks)
        burns = [e for e in seen if e.kind == "slo_burn" and not e.recovered][n_burns:]
        expect = 1 if state.predictions.get(1, (None, None))[1] is None or \
            state.predictions[1][1] >= state.floor else 0
        print(f"latency objective {OBS_TIGHT_P99_S * 1e3:g} ms: burns "
              f"{[(e.fields['slo'], e.fields['policy'], round(e.fields['burn_short'], 2)) for e in burns]}; "
              f"autotune levels over {tuner.degrade_ticks} burning ticks {burn_levels}", flush=True)
        check(any(e.fields["slo"] == "flat-latency" and e.fields["policy"] == "fast"
                  for e in burns), "the broken latency objective published slo_burn (fast)")
        check(burn_levels[-1] == expect, f"the autotuner shed to level {expect} after "
              f"{tuner.degrade_ticks} burning ticks ({burn_levels})")
        # past the short window the alert re-arms; calm ticks step toward the optimum
        short_s = obs.slo.ALERT_POLICIES[0].short_s
        calm = tick(1, dt=short_s + OBS_TICK_S) + tick(tuner.restore_ticks - 1)
        step = 0 if expect == target else (1 if target > expect else -1)
        check(not svc.slo_engine.paging() and calm[-1] == expect + step,
              f"the alert re-armed and {tuner.restore_ticks} calm ticks moved the level "
              f"{expect} -> {calm[-1]} toward the optimum {target} ({calm})")
        cost["autotune_trajectory"] = {"calm_walk": walk, "after_load": levels_load,
                                       "corrupted": raised, "burn": burn_levels, "calm": calm}

        # mutations, then the gateway over 127.0.0.1
        rng = np.random.default_rng(SEED + 25)
        src = rng.choice(x.shape[0], OBS_MUTATIONS, replace=False)
        new_rows = (x[torch.from_numpy(src).to(dev)].cpu().numpy()
                    + rng.standard_normal((OBS_MUTATIONS, x.shape[1])).astype(np.float32)
                    * np.float32(SERVE_NOISE))
        up_ids = mi.upsert(new_rows)
        mi.delete(rng.choice(x.shape[0], OBS_MUTATIONS * 10, replace=False))
        with phase("obs_mutated"):
            up_answers, _ = _drive(svc, "flat", new_rows, check)
            auditor.flush(SERVE_WAIT_S)
        check(np.array_equal(_stack(up_answers)[1][:, 0], up_ids),
              f"each of the {OBS_MUTATIONS} upserted rows finds itself first")
        url = svc.gateway.url

        def get(path, method="GET", headers=None):
            req = urllib.request.Request(url + path, method=method, headers=headers or {})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
                    return r.status, r.read(), time.perf_counter() - t0
            except urllib.error.HTTPError as err:
                return err.code, err.read(), time.perf_counter() - t0

        inc_list = json.loads(get("/incidents")[1])
        inc_ids = [i["id"] for i in inc_list["open"] + inc_list["recent_closed"]]
        vec = ",".join(f"{v:.6f}" for v in qn[0])
        routes = ["/metrics", "/healthz", "/readyz", "/snapshot", "/slo", "/perf/hotspots",
                  "/incidents", "/flight", f"/explain?name=flat&q={vec}", "/autotune"]
        routes += [f"/incidents/{inc_ids[0]}"] if inc_ids else []
        answered = {r.split("?")[0]: get(r)[0] for r in routes}
        metrics_body = get("/metrics")[1]
        hz_status, hz_body, _ = get("/healthz")
        hz = svc.healthz()
        check(all(c in (200, 503) for c in answered.values()) and answered["/metrics"] == 200
              and b"raft_tpu_recall_ewma" in metrics_body
              and b"raft_tpu_autotune_level" in metrics_body,
              f"every GET route answered ({answered}); /metrics holds raft_tpu_recall_ewma and "
              f"raft_tpu_autotune_level")
        check(json.loads(hz_body)["status"] == hz["status"]
              and hz_status == (503 if hz["status"] == "UNHEALTHY" else 200),
              f"/healthz {hz_status} {json.loads(hz_body)['status']} agrees with healthz() "
              f"{hz['status']}")
        scrape = {"metrics": [get("/metrics")[2] for _ in range(20)],
                  "healthz": [get("/healthz")[2] for _ in range(20)]}
        cost["gateway_ms_median"] = {k: float(np.median(v)) * 1e3 for k, v in scrape.items()}
        auth = {"Authorization": f"Bearer {token}"}
        pin = "/admin/effort_pin?name=flat&level=1"
        refused = (get(pin, "POST")[0], get("/admin/compact?name=flat", "POST")[0])
        pinned = get(pin, "POST", auth)
        eff = arb.effective_level()
        get("/admin/effort_pin?name=flat&level=-1", "POST", auth)
        t0 = time.perf_counter()
        compacted = get("/admin/compact?name=flat", "POST", auth)
        t_compact = time.perf_counter() - t0
        body = json.loads(compacted[1]) if compacted[0] == 200 else {}
        print(f"gateway {url}: routes {answered}; median answer ms "
              f"{json.dumps(cost['gateway_ms_median'])} [{smi}]; admin without the token "
              f"{refused}; pin {pinned[0]} (effective level {eff}); compact {compacted[0]} "
              f"{body.get('status')} in {t_compact:.3f} s", flush=True)
        check(refused == (401, 401) and pinned[0] == 200 and eff == 1
              and compacted[0] == 200 and body.get("status") == "promoted",
              f"the admin plane refused effort_pin and compact without the token {refused} "
              f"and carried them out with it (pin {pinned[0]}, level {eff}; compact "
              f"{compacted[0]} {body.get('status')})")
        with phase("obs_after_compact"):
            up_c, _ = _drive(svc, "flat", new_rows[:100], check)
        check(np.array_equal(_stack(up_c)[1][:, 0], up_ids[:100]),
              "after the compaction upserted rows still find themselves first")
        st = svc.stats("flat")
        check(st["recompiles"] == 0, f"no kernel build on the dispatch thread in phase 25's "
              f"service ({st['recompiles']})")

        # 5: the layers' cost, interleaved in one process: each round serves
        # the load with all four layers on, with none, and with every layer
        # but the auditor (the controller: SLO engine, autotuner, gateway).
        # The layered services are made for their run and stopped, every
        # thread of theirs joined, before the next run; their effort is
        # pinned at the plain service's level 0 (n_probes 20), so every run
        # searches the same lists while the autotuner still ticks
        os.environ["RAFT_TPU_SLO_EVAL_S"] = str(OBS_COST_TICK_S)
        off = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0)
        services.append((off, None, None))
        off.add_index("flat", serve.MutableIndex(index, search_params=sp), warmup=True)
        runs, trajectory, audited = [], [], {}
        for r in range(OBS_COST_ROUNDS):
            for arm in ("on", "off", "controller"):
                aud_r = obs.QualityAuditor() if arm == "on" else None
                tuner_r, svc_r = None, off
                if arm != "off":
                    tuner_r = obs.Autotuner(frontier=served_model, eval_s=OBS_COST_TICK_S)
                    svc_r = serve.SearchService(k=K, max_batch=64, max_delay_ms=2.0,
                                                auditor=aud_r, slo=True, autotune=tuner_r,
                                                gateway=obs.GatewayConfig(port=0))
                    services.append((svc_r, aud_r, tuner_r))
                    svc_r.add_index("flat", serve.MutableIndex(index, search_params=sp),
                                    warmup=True)
                    svc_r.effort_arbiter("flat").set_pin(0)
                    tuner_r.start()
                stop = threading.Event()
                scrapes = []

                def scraper(svc_s=svc_r):
                    while not stop.wait(OBS_SCRAPE_S):
                        for route in ("/metrics", "/healthz"):
                            t0 = time.perf_counter()
                            try:
                                urllib.request.urlopen(svc_s.gateway.url + route,
                                                       timeout=SERVE_WAIT_S).read()
                            except urllib.error.HTTPError as err:   # /healthz 503: UNHEALTHY
                                err.read()
                            scrapes.append(time.perf_counter() - t0)
                        trajectory.append((r, arm, svc_s.effort_arbiter("flat").autotune_level))

                worker = threading.Thread(target=scraper) if arm != "off" else None
                if worker is not None:
                    worker.start()
                lat = []
                with phase(f"obs_cost_{arm}_{r}"):
                    _, wall = _drive(svc_r, "flat", qn, check, latencies=lat)
                backlog = None
                if worker is not None:
                    stop.set()
                    worker.join(SERVE_WAIT_S)
                    arb_r = svc_r.effort_arbiter("flat")
                    level, effective = arb_r.autotune_level, arb_r.effective_level()
                    if aud_r is not None:
                        t0 = time.perf_counter()
                        aud_r.flush(SERVE_WAIT_S)
                        backlog = time.perf_counter() - t0
                        snap = aud_r.snapshot()
                        for key in ("submitted", "processed", "dropped", "errors"):
                            audited[key] = audited.get(key, 0) + snap[key]
                    svc_r.stop()
                    if aud_r is not None:
                        aud_r.stop()
                    tuner_r.stop()
                    services.remove((svc_r, aud_r, tuner_r))
                runs.append({"arm": arm, "round": r, "wall_s": wall,
                             "requests_per_s": n_q / wall,
                             "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                             "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                             "autotune_level": level if arm != "off" else None,
                             "effective_level": effective if arm != "off" else 0,
                             "scrape_ms_median": float(np.median(scrapes)) * 1e3 if scrapes else None,
                             "audit_backlog_s": backlog})
                print(f"obs cost run {r}: {arm}: {json.dumps(runs[-1])} [{smi}]", flush=True)
        cost["runs"] = runs
        cost["cost_auditor"] = audited
        cost["cost_level_trajectory"] = trajectory
        check(all(r_["wall_s"] > 0 and r_["effective_level"] == 0 for r_ in runs)
              and audited.get("errors", 1) == 0 and audited.get("processed", 0) > 0,
              f"the cost runs answered at one effort level (effective "
              f"{sorted({r_['effective_level'] for r_ in runs})}), the auditor without errors "
              f"({audited})")
    finally:
        sub.unsubscribe()
        for svc_, aud_, tuner_ in services:
            svc_.stop()
            if aud_ is not None:
                aud_.stop()
            if tuner_ is not None:
                tuner_.stop()
        for k_, v_ in keep_env.items():
            if v_ is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v_
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"obs layers cost: {json.dumps(cost, default=str)}", flush=True)


def csr_plan_case(case: str, seed: int):
    """(indptr, indices, data) CPU tensors of a CSR shaped after a branch of
    ``csrc/csr_spmm.cu``'s plan (as tests/test_torch_package.py):
    "empty" (most rows empty, whole windows of them), "degrees" (rows of 1,
    31, 32 and 33 slots), "long" (one row of 5,000 slots among short rows),
    "keys" (k-means' centroid sums: 20,000 rows into 7 keys, one empty);
    indices below 5,000, signed values over several magnitudes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if case == "empty":
        deg = np.where(rng.random(3000) < 0.1, rng.integers(1, 9, 3000), 0)
        deg[256:2000] = 0
    elif case == "degrees":
        deg = np.tile([1, 31, 32, 33, 0], 600)
    elif case == "long":
        deg = rng.integers(0, 40, 3000)
        deg[1370] = 5000
    else:
        deg = np.bincount(rng.choice([0, 1, 2, 3, 5, 6], 20000), minlength=7)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    return (torch.from_numpy(indptr), torch.from_numpy(rng.integers(0, 5000, nnz).astype(np.int32)),
            torch.from_numpy((rng.standard_normal(nnz)
                              * 10.0 ** rng.integers(-3, 4, nnz)).astype(np.float32)))


def pm_sweep(legs, pass_filter, metric, res) -> list:
    """(case, bitwise) of probe-major launches against the plain version on
    the first PM_SWEEP_QUERIES queries of each leg's inputs at every kk of
    PM_SWEEP_KK: monolithic, paged, filtered and both.  ``legs``: (tag,
    index, the same index paginated, its module, queries, scan keywords);
    ``pass_filter(index)``: its lists' pass words."""
    import torch

    from raft_tpu_torch.kernels import ivf_scan as scan
    from raft_tpu_torch.neighbors import _common

    out = []
    for tag, idx, pidx, mod, qs_all, kw in legs:
        qs = qs_all[:PM_SWEEP_QUERIES]
        words, paged_words = pass_filter(idx), pass_filter(pidx)   # pages pad the capacity
        for kk in PM_SWEEP_KK:
            _, bucket, _, _ = _common.select_scan_strategy(
                "probe_major", qs.shape[0], N_PROBES, idx.n_lists, idx.list_cap, qs.shape[1],
                res.workspace_limit_bytes, k=kk)
            mono = mod.probe_major_scan_inputs(idx, qs, N_PROBES, kk, bucket)[0]
            paged = mod.probe_major_scan_inputs(pidx, qs, N_PROBES, kk, bucket)[0]
            for variant, args, extra in (("", mono, {}), (", paged", paged, {}),
                                         (", pass10", mono, {"list_filter": words}),
                                         (", paged, pass10", paged,
                                          {"list_filter": paged_words})):
                got = scan.ivf_scan_probe_major(*args, metric=metric, **kw, **extra)
                want = scan.ivf_scan_probe_major_torch(*args, metric=metric, **kw, **extra)
                out.append((f"{tag} kk={kk}{variant}",
                            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    return out


def pm_tile_edges(dev, scan) -> list:
    """(case, bitwise) of every float leg of the probe-major kernel on
    synthetic lists at its tile's edges, against its plain version: a partial
    last chunk of 32 dimensions (d 100), rows whose width in bytes is no
    multiple of 16 (f32 at 97, bf16 at 97 and 100, 8-bit rows), G = 70 (a
    second block of 6 queries), cap = 200 (a partial second tile), 8-row
    pages, a filter, and kk in each fold (10, 40, 129)."""
    import torch

    from raft_tpu_torch.store import PagedLists

    out = []
    n_lists, cap, page_rows = 6, 200, 8
    for dtype, scan_dtype, d in ((torch.float32, "float32", 100), (torch.float32, "bfloat16", 97),
                                 (torch.bfloat16, "float32", 100),
                                 (torch.bfloat16, "bfloat16", 97), (torch.uint8, "float32", 97),
                                 (torch.int8, "float32", 100)):
        g = torch.Generator().manual_seed(d)
        if dtype in (torch.uint8, torch.int8):
            lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
            data = torch.randint(lo, hi, (n_lists, cap, d), generator=g).to(dtype)
        else:
            data = torch.randn(n_lists, cap, d, generator=g).to(dtype)
        ids = torch.arange(n_lists * cap, dtype=torch.int32).reshape(n_lists, cap)
        ids[1, 150:] = -1
        ids[4, 60:] = -1
        vals = data.float()
        y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(())).to(dev)
        qg = torch.randn(5, 70, d, generator=g) * (20.0 if dtype == torch.uint8 else 1.0)
        q2g = (qg * qg).sum(-1)
        q2g[:, 67:] = float("inf")
        args = [torch.randint(0, n_lists, (5,), generator=g, dtype=torch.int32).to(dev),
                qg.to(dev), q2g.to(dev)]
        bits = (torch.rand(n_lists, cap, generator=g) < 0.6) & (ids >= 0)
        bits = torch.nn.functional.pad(bits, (0, -cap % 32)).reshape(n_lists, -1, 32)
        words = (bits.long() << torch.arange(32)).sum(-1).to(torch.int32).to(dev)
        perm = torch.randperm(n_lists * cap // page_rows, generator=g)
        pool = torch.empty((perm.numel(), page_rows, d), dtype=dtype)
        pool[perm] = data.reshape(-1, page_rows, d)
        paged = PagedLists(pool.to(dev), perm.to(torch.int32).to(dev), cap // page_rows)
        kw = dict(scan_dtype=scan_dtype,
                  scan_scale=None if dtype in (torch.uint8, torch.int8) else 1.0)
        mono = data.to(dev)
        for kk in (10, 40, 129):
            for rows, extra, tag in ((mono, {}, ""), (paged, {}, " paged"),
                                     (mono, {"list_filter": words}, " filtered"),
                                     (paged, {"list_filter": words}, " paged filtered")):
                got = scan.ivf_scan_probe_major(*args, rows, y2, ids.to(dev), kk, **kw, **extra)
                want = scan.ivf_scan_probe_major_torch(*args, mono, y2, ids.to(dev), kk, **kw,
                                                       **extra)
                out.append((f"{dtype} {scan_dtype} d={d} kk={kk}{tag}",
                            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    return out


def graphs_phase(*, x, list_centers, res, check, phase, phase_launches, record, main_launches,
                 cuda_ms, smi):
    """Phase 26: the graph and sparse path on the card.  A kNN graph over
    the main rows (fused_knn) partitioned spectrally (csr_spmm in every
    Laplacian matvec, k-means, kernel #7 holding its assignment); R-MAT at
    Graph500's scale 20 by modularity; single linkage over 250,000 blobs;
    the LAP; find_k; sparse kNN (select_k) against the dense path; Gram
    matrices against the CPU; and csr_spmm against its plain version (and
    torch.sparse.mm as a yardstick) at the kNN-graph and R-MAT shapes."""
    import numpy as np
    import scipy.optimize
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch import random as trandom
    from raft_tpu_torch.cluster import find_k, spectral
    from raft_tpu_torch.cluster import single_linkage as run_single_linkage
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.distance import KernelParams, gram_matrix, pairwise_distance
    from raft_tpu_torch.kernels import csr_spmm as csr_k
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import cost
    from raft_tpu_torch.ops import linalg as olinalg
    from raft_tpu_torch.solver import linear_assignment
    from raft_tpu_torch.sparse import COO, CSR
    from raft_tpu_torch.sparse import distance as sdist
    from raft_tpu_torch.sparse import linalg as slinalg
    from raft_tpu_torch.sparse import neighbors as sneighbors
    from raft_tpu_torch.sparse import op as sop
    from raft_tpu_torch.sparse import solver as ssolver
    from raft_tpu_torch.stats import adjusted_rand_index

    dev = x.device
    cpu = Resources(device="cpu")
    subs = []

    def sub(name):
        """A sub-phase whose launch counts join phase 26's."""
        subs.append(name)
        return phase(f"graphs_{name}")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def once_ms(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    @contextlib.contextmanager
    def plain_spmv():
        saved = csr_k.csr_spmm
        csr_k.csr_spmm = csr_k.csr_spmm_torch
        try:
            yield
        finally:
            csr_k.csr_spmm = saved

    # -- the kNN graph and its spectral partition --------------------------------
    n = x.shape[0]
    t0 = time.perf_counter()
    with sub("knn"):
        knn = sneighbors.knn_graph(x, GRAPH_K, res=res)
        v = knn.valid
        sim = COO(knn.rows, knn.cols, torch.where(v, 1.0 / (1.0 + knn.data),
                                                  torch.zeros_like(knn.data)), knn.shape, knn.nnz)
    deg = slinalg.degree(sim)
    print(f"kNN graph of {n} rows at k={GRAPH_K}: {sim.nnz} slots after symmetrize (max), "
          f"degree min {int(deg.min())} max {int(deg.max())}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(phase_launches["graphs_knn"]["fused_knn"] > 0, "knn_graph launched fused_knn")
    check(int(deg.min()) >= GRAPH_K and torch.equal(slinalg.degree(
        COO(sim.cols, sim.rows, sim.data, sim.shape, sim.nnz)), deg),
        f"kNN graph: every row has >= {GRAPH_K} neighbours and the graph is symmetric")

    captured = []
    predict = spectral.kmeans.predict

    def capturing_predict(centers, emb, **kw):
        captured.append((centers, emb))
        return predict(centers, emb, **kw)

    spectral.kmeans.predict = capturing_predict
    try:
        runs = []
        for i in range(2):
            t0 = time.perf_counter()
            with sub(f"spectral_{i}"):
                runs.append(spectral.partition(sim, GRAPH_CLUSTERS, seed=0, res=res))
            print(f"spectral.partition run {i}: {time.perf_counter() - t0:.2f} s, eigenvalues "
                  f"{runs[-1][1].cpu().numpy().tolist()}", flush=True)
    finally:
        spectral.kmeans.predict = predict
    (labels, vals), (labels2, vals2) = runs
    check(phase_launches["graphs_spectral_0"]["csr_spmm"] > 0,
          f"spectral.partition launched csr_spmm "
          f"({phase_launches['graphs_spectral_0']['csr_spmm']})")
    check(torch.equal(labels, labels2) and torch.equal(vals, vals2),
          "spectral.partition twice with seed 0: labels and eigenvalues bitwise equal")
    used = int(torch.unique(labels).numel())
    check(used == GRAPH_CLUSTERS, f"spectral partition uses {used} of {GRAPH_CLUSTERS} labels")
    rand = torch.randint(0, GRAPH_CLUSTERS, (n,), generator=gen(0), device=dev)
    cut, min_size = spectral.analyze_partition(sim, labels, GRAPH_CLUSTERS)
    cut_rand, _ = spectral.analyze_partition(sim, rand, GRAPH_CLUSTERS)
    check(float(cut) <= 0.5 * float(cut_rand),
          f"spectral edge cut {float(cut):.1f} <= 0.5 x a seeded random labelling's "
          f"{float(cut_rand):.1f} (smallest cluster {int(min_size)})")
    t0 = time.perf_counter()
    with plain_spmv():
        kernels.reset_launch_counts()
        labels_p, vals_p = spectral.partition(sim, GRAPH_CLUSTERS, seed=0, res=res)
        plain_launches = kernels.launch_counts()["csr_spmm"]
    rel = float((vals_p - vals).abs().max() / vals.abs().max().clamp(min=1e-30))
    check(plain_launches == 0 and rel <= 1e-4,
          f"eigenvalues of the plain SpMV's run within 1e-4 relative ({rel:.3e}; bitwise "
          f"{torch.equal(vals_p, vals)}, labels bitwise {torch.equal(labels_p, labels)}; "
          f"{time.perf_counter() - t0:.1f} s)")
    centers, emb = captured[0]
    with sub("assign"):
        _, ids = kernels.fused_l2_argmin(emb, centers, (centers * centers).sum(dim=1))
    agree = float((ids == labels).float().mean())
    check(agree >= 0.999, f"kernel #7 on the partition's k-means assignment: ids equal "
          f"kmeans.predict on {agree:.6f} of {n} rows")

    # -- csr_spmm at the kNN graph's Laplacian ----------------------------------------
    lap = slinalg.laplacian(sim, normalized=True)
    ip, ci, cd = lap.row_view()
    xv = torch.randn((n, 1), generator=gen(1), device=dev)
    got = csr_k.csr_spmm(ip, ci, cd, xv)
    plain_ms, want = once_ms(lambda: csr_k.csr_spmm_torch(ip, ci, cd, xv))
    knn_bitwise = torch.equal(got, want)
    check(knn_bitwise, f"csr_spmm bitwise its plain version on the kNN Laplacian "
          f"([{n}] rows, {lap.nnz} slots)")
    knn_ms = cuda_ms(lambda: csr_k.csr_spmm(ip, ci, cd, xv), 20)
    lib = torch.sparse_csr_tensor(ip.long(), ci.long(), cd, size=(n, n))
    lib_ms = cuda_ms(lambda: torch.sparse.mm(lib, xv), 20)
    lib_err = float((torch.sparse.mm(lib, xv) - got).abs().max())
    print(f"csr_spmm kNN Laplacian SpMV: {knn_ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"torch.sparse.mm {lib_ms:.4f} ms (max abs diff {lib_err:.3e}), bound "
          f"{cost.bound_ms(cost.csr_spmm_work(n, lap.nnz, n, 1))[0]:.4f} ms; {smi}", flush=True)

    # -- R-MAT by modularity ------------------------------------------------------------
    n_rmat = 1 << RMAT_SCALE
    n_edges = RMAT_EDGE_FACTOR * n_rmat
    t0 = time.perf_counter()
    with sub("rmat"):
        e = trandom.rmat(gen(2), RMAT_SCALE, RMAT_SCALE, n_edges, res=res)
        adj = slinalg.symmetrize(COO(e[:, 0], e[:, 1], torch.ones(n_edges, device=dev),
                                     (n_rmat, n_rmat)), op="max")
    rdeg = slinalg.degree(adj)
    print(f"R-MAT scale {RMAT_SCALE}, {n_edges} edges: {adj.nnz} slots after symmetrize, "
          f"{int((rdeg > 0).sum())} vertices with an edge, max degree {int(rdeg.max())}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mruns = []
    for i in range(2):
        t0 = time.perf_counter()
        with sub(f"modularity_{i}"):
            mruns.append(spectral.modularity_maximization(adj, GRAPH_CLUSTERS, seed=0, res=res))
        print(f"modularity_maximization run {i}: {time.perf_counter() - t0:.2f} s", flush=True)
    (mlab, mvals), (mlab2, mvals2) = mruns
    check(torch.equal(mlab, mlab2) and torch.equal(mvals, mvals2),
          "modularity_maximization twice with seed 0: labels and eigenvalues bitwise equal")
    q_mod = float(spectral.analyze_modularity(adj, mlab))
    q_rand = float(spectral.analyze_modularity(
        adj, torch.randint(0, GRAPH_CLUSTERS, (n_rmat,), generator=gen(3), device=dev)))
    check(q_mod > q_rand, f"R-MAT modularity Q {q_mod:.4f} > a seeded random labelling's "
          f"{q_rand:.4f}")
    rp, rc, rd = adj.row_view()
    xr = torch.randn((n_rmat, 1), generator=gen(4), device=dev)
    rmat_ms = cuda_ms(lambda: csr_k.csr_spmm(rp, rc, rd, xr), 20)
    rmat_plain_ms, _ = once_ms(lambda: csr_k.csr_spmm_torch(rp, rc, rd, xr))
    rlib = torch.sparse_csr_tensor(rp.long(), rc.long(), rd, size=(n_rmat, n_rmat))
    rmat_lib_ms = cuda_ms(lambda: torch.sparse.mm(rlib, xr), 20)
    # the plain version held to the kernel on the hub rows and a seeded sample
    hubs = torch.topk(rdeg, RMAT_HUB_ROWS).indices
    rows = torch.unique(torch.cat([hubs, torch.randint(0, n_rmat, (RMAT_SAMPLE_ROWS,),
                                                       generator=gen(5), device=dev)]))
    starts, ends = rp[rows].long(), rp[rows + 1].long()
    cnt = ends - starts
    sp_ptr = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=dev)
    sp_ptr[1:] = torch.cumsum(cnt, 0).to(torch.int32)
    slot = torch.repeat_interleave(starts - sp_ptr[:-1].long(), cnt) + torch.arange(
        int(cnt.sum()), device=dev)
    full = csr_k.csr_spmm(rp, rc, rd, xr)
    sample_got = csr_k.csr_spmm(sp_ptr, rc[slot].contiguous(), rd[slot].contiguous(), xr)
    sample_want = csr_k.csr_spmm_torch(sp_ptr, rc[slot].contiguous(), rd[slot].contiguous(), xr)
    check(torch.equal(sample_got, sample_want) and torch.equal(full[rows], sample_got),
          f"csr_spmm bitwise its plain version on {rows.numel()} R-MAT rows ({RMAT_HUB_ROWS} "
          f"hubs, degree up to {int(cnt.max())}) and equal to the full graph's rows")
    print(f"csr_spmm R-MAT SpMV: {rmat_ms:.4f} ms, plain {rmat_plain_ms:.2f} ms, "
          f"torch.sparse.mm {rmat_lib_ms:.4f} ms, bound "
          f"{cost.bound_ms(cost.csr_spmm_work(n_rmat, adj.nnz, n_rmat, 1))[0]:.4f} ms; {smi}",
          flush=True)

    # -- csr_spmm at the branches of its plan, and at k-means' centroid sums ---------------------
    edges = []
    for case in ("empty", "degrees", "long", "keys"):
        for cols in (1, 3, 32, 33, 128):
            ip_e, ix_e, d_e = (t.to(dev) for t in csr_plan_case(case, cols))
            x_e = torch.randn((5000, cols), generator=gen(20 + cols), device=dev)
            edges.append((f"{case}, {cols} columns", torch.equal(
                csr_k.csr_spmm(ip_e, ix_e, d_e, x_e), csr_k.csr_spmm_torch(ip_e, ix_e, d_e, x_e))))
    check(all(ok_ for _, ok_ in edges), f"csr_spmm bitwise its plain version at every branch "
          f"of its plan ({len(edges)} cases; failed: {[n_ for n_, ok_ in edges if not ok_]})")
    # reduce_rows_by_key of the main rows into phase 1's lists (each row's
    # nearest center by #7), as ops.linalg sorts them: the kernel's own inputs
    keys = kernels.fused_l2_argmin(x, list_centers, (list_centers * list_centers).sum(dim=1))[1]
    n_keys, width = list_centers.shape[0], x.shape[1]
    order = torch.argsort(keys.long(), stable=True)
    kp = torch.zeros(n_keys + 1, dtype=torch.int32, device=dev)
    kp[1:] = torch.cumsum(torch.bincount(keys.long(), minlength=n_keys), 0).to(torch.int32)
    ko, kw_ = order.to(torch.int32), torch.ones(n, device=dev)
    red = csr_k.csr_spmm(kp, ko, kw_, x)
    red_plain_ms, red_want = once_ms(lambda: csr_k.csr_spmm_torch(kp, ko, kw_, x))
    red_err = float((red - red_want).abs().max())
    check(torch.equal(red, red_want)
          and torch.equal(red, olinalg.reduce_rows_by_key(x, keys, n_keys)),
          f"csr_spmm bitwise its plain version at reduce_rows_by_key [{n}, {width}] into "
          f"{n_keys} keys (largest {int((kp[1:] - kp[:-1]).max())} rows), and equal to "
          f"ops.linalg.reduce_rows_by_key")
    red_ms = cuda_ms(lambda: csr_k.csr_spmm(kp, ko, kw_, x), 20)
    red_lib_ms = cuda_ms(lambda: torch.zeros((n_keys, width), device=dev).index_add_(
        0, keys.long(), x), 20)
    red_bound = cost.bound_ms(cost.csr_spmm_work(n_keys, n, n, width))[0]
    print(f"csr_spmm reduce_rows_by_key [{n}, {width}] into {n_keys} keys: {red_ms:.4f} ms, "
          f"plain {red_plain_ms:.2f} ms, index_add_ {red_lib_ms:.4f} ms, bound {red_bound:.4f} ms "
          f"(bytes); {smi}", flush=True)
    del red, red_want, order, ko, kw_

    # -- single linkage over blobs ------------------------------------------------------------
    rounds = []
    cross_nn = ssolver.cross_component_nn

    def counting_cross_nn(*a, **kw):
        out = cross_nn(*a, **kw)
        rounds.append(out.nnz)
        return out

    t0 = time.perf_counter()
    with sub("single_linkage"):
        xb, truth, _ = trandom.make_blobs(gen(6), SL_ROWS, x.shape[1], n_clusters=SL_BLOBS,
                                          cluster_std=1.0, center_box=(0.0, 10.0), res=res)
        ssolver.cross_component_nn = counting_cross_nn
        try:
            out = run_single_linkage(xb, n_clusters=SL_BLOBS, c=SL_C, res=res)
        finally:
            ssolver.cross_component_nn = cross_nn
    sl_s = time.perf_counter() - t0
    ari = float(adjusted_rand_index(out.labels, truth, res=res))
    print(f"single linkage of {SL_ROWS} x {x.shape[1]} blobs ({SL_BLOBS} blobs, c={SL_C}): "
          f"{sl_s:.1f} s, {len(rounds)} cross-component rounds (edges added {rounds})",
          flush=True)
    check(ari >= 0.99, f"single linkage ARI against the blob labels {ari:.5f} >= 0.99")
    check(out.dendrogram.shape == (SL_ROWS - 1, 2) and bool((np.diff(out.deltas) >= 0).all())
          and int(out.sizes[-1]) == SL_ROWS,
          f"single linkage: {SL_ROWS - 1} merges, non-decreasing deltas, last size "
          f"{int(out.sizes[-1])}")

    # -- the LAP ----------------------------------------------------------------------------
    costs = np.random.default_rng(SEED).random((LAP_N, LAP_N)).astype(np.float32)
    t0 = time.perf_counter()
    with sub("lap"):
        col_of, total = linear_assignment(costs, res=res)
    lap_s = time.perf_counter() - t0
    r_, c_ = scipy.optimize.linear_sum_assignment(costs)
    opt = float(costs[r_, c_].sum())
    eps = max(1e-7, 1e-4 * float(np.abs(costs).max()) / LAP_N)
    perm = np.sort(col_of.cpu().numpy())
    check(np.array_equal(perm, np.arange(LAP_N)) and abs(float(total) - opt) <= LAP_N * eps,
          f"linear_assignment {LAP_N} x {LAP_N}: total {float(total):.6f} within n eps "
          f"{LAP_N * eps:.2e} of scipy's {opt:.6f} ({lap_s:.2f} s)")

    # -- find_k ------------------------------------------------------------------------------
    t0 = time.perf_counter()
    with sub("find_k"):
        xf, _, _ = trandom.make_blobs(gen(7), FK_ROWS, x.shape[1], n_clusters=FK_BLOBS, res=res)
        k_found, fk_centers, fk_inertia = find_k(xf, FK_KMAX, res=res)
    print(f"find_k over {FK_ROWS} x {x.shape[1]} blobs ({FK_BLOBS} blobs, kmax {FK_KMAX}): "
          f"k = {k_found}, inertia {float(fk_inertia):.1f}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(1 <= k_found <= FK_KMAX and tuple(fk_centers.shape) == (k_found, x.shape[1])
          and bool(torch.isfinite(fk_centers).all()), f"find_k: k = {k_found} with finite centers")
    del xf, fk_centers

    # -- sparse kNN against the dense path --------------------------------------------------------
    def random_csr(rows, seed):
        """A canonical CSR (no repeated column in a row): one column drawn
        in each of SP_PER_ROW equal bands of the columns."""
        g = gen(seed)
        band = SP_COLS // SP_PER_ROW
        cols = (torch.arange(SP_PER_ROW, device=dev, dtype=torch.int32) * band
                + torch.randint(0, band, (rows, SP_PER_ROW), generator=g, device=dev,
                                dtype=torch.int32))
        vals = torch.rand((rows, SP_PER_ROW), generator=g, device=dev)
        ptr = torch.arange(rows + 1, dtype=torch.int32, device=dev) * SP_PER_ROW
        return CSR(ptr, cols.reshape(-1), vals.reshape(-1), (rows, SP_COLS))

    data_sp, q_sp = random_csr(SP_ROWS, 8), random_csr(SP_QUERIES, 9)
    sparse_out = {}
    t0 = time.perf_counter()
    with sub("sparse_knn"):
        for metric in ("sqeuclidean", "cosine"):
            sparse_out[metric] = sneighbors.brute_force_knn(data_sp, q_sp, SP_K, metric=metric,
                                                            res=res)
            pd = sdist.pairwise_distance_sparse(q_sp, data_sp, metric=metric, res=res)
            check(tuple(pd.shape) == (SP_QUERIES, SP_ROWS) and bool(torch.isfinite(pd).all()),
                  f"pairwise_distance_sparse {metric} [{SP_QUERIES}, {SP_ROWS}] finite")
            del pd
    print(f"sparse kNN and pairwise distances over {SP_ROWS} x {SP_COLS} CSR "
          f"({SP_PER_ROW} slots a row), {SP_QUERIES} queries: {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(phase_launches["graphs_sparse_knn"]["select_k"] > 0,
          "sparse brute_force_knn launched select_k")
    head = sop.slice_rows(data_sp, 0, SP_SLICE)
    dense_head, dense_q = head.to_dense(), q_sp.to_dense()
    for metric in ("sqeuclidean", "cosine"):
        sv, si = sneighbors.brute_force_knn(head, q_sp, SP_K, metric=metric, res=res)
        dv, di = brute_force.knn(dense_head, dense_q, SP_K, metric=metric, res=res)
        same = si == di
        tied = torch.isclose(sv, dv, rtol=1e-5, atol=1e-6)
        check(torch.allclose(sv, dv, rtol=1e-4, atol=1e-4) and bool((same | tied).all()),
              f"sparse brute_force_knn {metric} on the first {SP_SLICE} rows: values within "
              f"rtol 1e-4 of the dense path, ids equal except at {int((~same).sum())} value ties")
        pd_s = sdist.pairwise_distance_sparse(q_sp, head, metric=metric, res=res)
        pd_d = pairwise_distance(dense_q, dense_head, metric=metric, res=res)
        check(torch.allclose(pd_s, pd_d, rtol=1e-4, atol=1e-4),
              f"pairwise_distance_sparse {metric} on the first {SP_SLICE} rows within rtol 1e-4 "
              f"of the dense pairwise_distance (max abs diff {float((pd_s - pd_d).abs().max()):.2e})")
    del dense_head, dense_q

    # -- Gram matrices ----------------------------------------------------------------------------
    xg = x[:GRAM_ROWS]
    for kp in (KernelParams("rbf", gamma=1e-3),
               KernelParams("polynomial", degree=3, gamma=1.0 / x.shape[1], coef0=1.0)):
        with sub(f"gram_{kp.kernel}"):
            g_card = gram_matrix(xg, xg, kp, res=res)
        g_cpu = gram_matrix(xg.cpu(), xg.cpu(), kp, res=cpu)
        err = float(((g_card.cpu() - g_cpu).abs() / g_cpu.abs().clamp(min=1e-30)).max())
        check(torch.allclose(g_card.cpu(), g_cpu, rtol=1e-4, atol=1e-6 * float(g_cpu.abs().max())),
              f"gram_matrix {kp.kernel} {GRAM_ROWS} x {GRAM_ROWS} x {x.shape[1]} within rtol 1e-4 "
              f"of the CPU (max relative diff {err:.2e})")

    # -- the record of csr_spmm -----------------------------------------------------------------
    total = {k_: sum(phase_launches[f"graphs_{s_}"][k_] for s_ in subs)
             for k_ in kernels.KERNELS}
    print(f"phase 26 launches: { {k_: c_ for k_, c_ in total.items() if c_} }", flush=True)
    for name in ("csr_spmm", "fused_knn", "select_k", "fused_argmin"):
        check(total[name] > 0, f"phase 26 launched {name} ({total[name]})")
    main_launches["csr_spmm"] = total["csr_spmm"]
    record("csr_spmm", "raft_tpu_torch/csrc/csr_spmm.cu",
           "none (raft_tpu/sparse/linalg.py:134, XLA segment_sum)", 0.0 if knn_bitwise else
           float((got - want).abs().max()), knn_ms, plain_ms,
           cost.csr_spmm_work(n, lap.nnz, n, 1), cost.csr_spmm_work(n, lap.nnz, n, 1), lib_ms,
           f"SpMV of the normalized Laplacian of the kNN graph ({n} rows, {lap.nnz} slots, "
           f"max degree {int(deg.max()) + 1})",
           also=[{"shape": f"SpMV of R-MAT scale {RMAT_SCALE} symmetrized ({n_rmat} rows, "
                           f"{adj.nnz} slots, max degree {int(rdeg.max())})",
                  "ms": rmat_ms, "plain_ms": rmat_plain_ms, "library_ms": rmat_lib_ms,
                  "bound_ms": cost.bound_ms(cost.csr_spmm_work(n_rmat, adj.nnz, n_rmat, 1))[0],
                  "max_abs_err": 0.0},
                 {"shape": f"reduce_rows_by_key [{n}, {width}] into {n_keys} keys (k-means' "
                           f"centroid sums; library: index_add_)",
                  "ms": red_ms, "plain_ms": red_plain_ms, "library_ms": red_lib_ms,
                  "bound_ms": red_bound, "max_abs_err": red_err}])


if __name__ == "__main__":
    if sys.argv[1:2] == [SERVED_BUSY_FLAG]:
        print(json.dumps(served_busy_share(sys.argv[2], int(sys.argv[3]))), flush=True)
        sys.exit(0)
    sys.exit(main())
