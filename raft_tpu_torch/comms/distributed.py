"""Multi-device (SPMD) algorithms over the comms facade (counterpart of
``raft_tpu.comms.distributed``).

Each shard's local work goes through the port's own entry points, so on
the card it reaches the kernels: local top-k by brute force's fused path
(kernel #2; other metrics the distance tile and select_k, #1), the IVF
shards' list scans through ``_common.scan_search`` (#3 / #5), the CAGRA
walk (#8) on each shard's queries, and the k-means assignment by the
fused argmin (#7).  The merges pad each shard's candidates as raft_tpu
pads them, gather them in rank order and re-select with select_k (#1),
once, on the mesh's first device: results are "replicated" there.

- ``sharded_knn``: dataset rows sharded over the axis; local top-k, then
  the all-gather + merge (ref: neighbors/detail/knn_merge_parts.cuh).
- ``shard_ivf_flat_index`` / ``shard_ivf_pq_index`` and their searches:
  lists sharded in contiguous blocks, each shard probing its own lists.
- ``sharded_ivf_pq_build``: one trained quantizer, each shard encoding its
  rows, one assembly (byte-identical to the single-device build).
- ``sharded_cagra_search`` / ``sharded_cagra_build``: the graph index
  replicated and the queries sharded; the batch NN-descent build with its
  batches spread over the shards.
- ``kmeans_step`` / ``kmeans_fit``: Lloyd iterations with row-sharded data
  and one allreduce of the centroid statistics (cuML's MNMG k-means).

Sharded arguments are a rank-ordered list of per-shard tensors or one
tensor, cut over the axis by ``Comms.shard`` (its rows must divide).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k

Sharded = Union[torch.Tensor, np.ndarray, Sequence[torch.Tensor]]


def _shards(comms: Comms, x: Sharded, dim: int = 0) -> List[torch.Tensor]:
    """A rank-ordered list of this process's shards of ``x``."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(comms.devices):
            raise ValueError(f"{len(x)} shards for {len(comms.devices)} mesh positions")
        return [torch.as_tensor(s).to(d) for s, d in zip(x, comms.devices)]
    return comms.shard(torch.as_tensor(x), dim)


def _res(device: torch.device, res: Optional[Resources] = None) -> Resources:
    """A Resources on a shard's device, with the caller's workspace budget."""
    return Resources(device=device, workspace_limit_bytes=ensure(res).workspace_limit_bytes)


def _root(comms: Comms) -> torch.device:
    return comms.devices[0]


def _gather(comms: Comms, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The rank-ordered concatenation of every shard's tensor, on the
    mesh's first device (one all-gather's first entry)."""
    return comms.allgather(xs, axis=dim)[0]


def _pad_to(v: torch.Tensor, i: torch.Tensor, k: int, worst: float, fill_id: int):
    if v.shape[1] >= k:
        return v, i
    pad = k - v.shape[1]
    v = torch.cat([v, torch.full((v.shape[0], pad), worst, dtype=v.dtype, device=v.device)], 1)
    i = torch.cat([i, torch.full((i.shape[0], pad), fill_id, dtype=i.dtype, device=i.device)], 1)
    return v, i


def sharded_knn(
    comms: Comms,
    dataset_sharded: Sharded,
    queries,
    k: int,
    *,
    metric: str = "sqeuclidean",
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a row-sharded dataset: (distances [q, k], global ids
    [q, k]) on the mesh's first device.  Shard r's rows are global rows
    ``r * shard_rows ...`` (``shard_rows``: the rows of shard 0)."""
    from raft_tpu_torch.neighbors import brute_force

    if metric not in DISTANCE_TYPES:
        raise ValueError(f"unsupported metric {metric!r}; one of {sorted(DISTANCE_TYPES)}")
    shards = _shards(comms, dataset_sharded)
    shard_rows = int(comms.bcast([torch.tensor(s.shape[0]) for s in shards])[0])
    select_min = DISTANCE_TYPES[metric] != "inner_product"
    worst = float("inf") if select_min else float("-inf")
    k_local = min(k, shard_rows)  # a shard can contribute at most its rows
    queries = torch.as_tensor(queries)

    def local(rank, ds, q):
        v, i = brute_force.knn(ds, q, k_local, metric=metric, res=_res(ds.device, res))
        # pad so the merged pool still holds k winners (raft_tpu pads id 0)
        v, i = _pad_to(v, i, k, worst, 0)
        return v, i + rank * shard_rows      # globalize ids

    outs = comms.run(local, shards, replicated=(queries,))
    vg = _gather(comms, [o[0] for o in outs], 1)          # [q, size * k]
    ig = _gather(comms, [o[1] for o in outs], 1)
    return select_k(vg, k, select_min=select_min, input_indices=ig)


# -- sharded IVF --------------------------------------------------------------

def _shard_lists(comms: Comms, index, names_fills) -> dict:
    """Pad the list axis to a multiple of the axis size (empty lists) and
    cut every list-major array into contiguous per-shard blocks."""
    size = comms.get_size()
    L = index.n_lists
    L_pad = -(-L // size) * size
    pad = L_pad - L
    out = {}
    for name, (arr, fill) in names_fills.items():
        if pad:
            block = torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                               device=arr.device)
            arr = torch.cat([arr, block])
        out[name] = comms.shard(arr)
    valid = torch.arange(L_pad) < L
    out["list_valid"] = comms.shard(valid)
    return out


def shard_ivf_flat_index(comms: Comms, index) -> dict:
    """Shard an IVF-Flat index list-wise across the comms axis: rows in
    their stored dtype, row norms zeroed at padding slots (masked by id),
    padding lists' centers zero and masked out of the coarse selection."""
    norms = torch.where(index.list_index >= 0, index.list_norms,
                        torch.zeros_like(index.list_norms))
    out = _shard_lists(comms, index, {
        "centers": (index.centers, 0.0),
        "list_data": (index.list_data, 0),
        "list_norms": (norms, 0.0),
        "list_index": (index.list_index, -1),
    })
    out["metric"] = index.metric
    return out


def shard_ivf_pq_index(comms: Comms, index) -> dict:
    """Shard an IVF-PQ index list-wise across the comms axis: the decoded
    scan cache shards in its stored dtype (an int8 cache keeps its global
    ``scan_scale``), the rotation is replicated, and padding lists are
    masked out of the coarse selection."""
    out = _shard_lists(comms, index, {
        "centers": (index.centers, 0.0),
        "list_data": (index.list_data, 0),
        "list_y2": (index.list_y2, 0.0),
        "list_index": (index.list_index, -1),
    })
    out["rotation"] = comms.replicate(index.rotation)
    out["metric"] = index.metric
    out["scan_scale"] = float(index.scan_scale) if index.list_data.dtype == torch.int8 else 1.0
    return out


def _sharded_scan_plan(comms: Comms, sharded: dict, queries, k: int, n_probes: int,
                       strategy: str):
    """Shared pre-scan arithmetic of the sharded IVF searches (validation,
    per-shard probe and k budgets): (queries f32, plan)."""
    size = comms.get_size()
    L_shard = sharded["centers"][0].shape[0]
    cap = sharded["list_data"][0].shape[1]
    p_local = min(n_probes, L_shard)
    k_local = min(k, p_local * cap)
    if size * k_local < k:
        raise ValueError(
            f"k={k} exceeds the global candidate pool "
            f"{size}*{k_local} (shards*probed slots); raise n_probes"
        )
    queries = torch.as_tensor(queries).to(torch.float32)
    if queries.ndim != 2 or queries.shape[1] != sharded["centers"][0].shape[1]:
        raise ValueError(
            f"queries shape {tuple(queries.shape)} vs index dim "
            f"{sharded['centers'][0].shape[1]}"
        )
    if strategy not in ("auto", "query_major", "probe_major"):
        raise ValueError(f"strategy must be auto|query_major|probe_major, got {strategy!r}")
    return queries, {"p_local": p_local, "k_local": k_local}


def _masked_probes(centers: torch.Tensor, valid: torch.Tensor, metric: str, p_local: int):
    """Coarse selection over a shard's lists with padding lists masked."""
    from raft_tpu_torch.neighbors._common import coarse_scores

    def probes_fn(qt):
        coarse = coarse_scores(qt, centers, metric)
        coarse = torch.where(valid[None, :], coarse, torch.full_like(coarse, float("inf")))
        return select_k(coarse, p_local, select_min=True)[1]

    return probes_fn


def _merge_across_shards(comms: Comms, vs, is_, k: int, k_local: int):
    """Pad per-shard top-k_local to k (+inf / -1), gather in rank order,
    re-select: the knn_merge_parts-equivalent tail every sharded IVF search
    shares."""
    padded = [_pad_to(v, i, k, float("inf"), -1) for v, i in zip(vs, is_)]
    vg = _gather(comms, [p[0] for p in padded], 1)
    ig = _gather(comms, [p[1] for p in padded], 1)
    return select_k(vg, k, select_min=True, input_indices=ig)


def _sharded_scan(comms, sharded, queries, k, n_probes, strategy, y2_name, q_scan_fn_of,
                  scan_kw, res):
    from raft_tpu_torch.neighbors import _common

    metric = DISTANCE_TYPES[sharded["metric"]]
    queries, plan = _sharded_scan_plan(comms, sharded, queries, k, n_probes, strategy)
    p_local, k_local = plan["p_local"], plan["k_local"]
    ws = ensure(res).workspace_limit_bytes

    def local(rank, centers, valid, data, y2, ids, extra, q):
        lists = (data, y2, ids)
        return _common.scan_search(
            q, k_local, p_local, strategy, centers, lists, metric, q_scan_fn_of(extra),
            scan_kw, ws, None, probes_fn=_masked_probes(centers, valid, metric, p_local))

    extra = sharded.get("rotation", [None] * len(comms.devices))
    outs = comms.run(local, sharded["centers"], sharded["list_valid"], sharded["list_data"],
                     sharded[y2_name], sharded["list_index"], extra, replicated=(queries,))
    v, i = _merge_across_shards(comms, [o[0] for o in outs], [o[1] for o in outs], k, k_local)
    return _common.postprocess(v, metric), i


def sharded_ivf_flat_search(
    comms: Comms,
    sharded: dict,
    queries,
    k: int,
    *,
    n_probes: int = 20,
    strategy: str = "auto",
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed IVF-Flat search: per-shard coarse selection over its
    own lists, the local scan on the schedule raft_tpu's rule picks, and
    the all-gather + re-select merge.  (distances [q, k], ids [q, k]) on
    the mesh's first device."""
    return _sharded_scan(comms, sharded, queries, k, n_probes, strategy, "list_norms",
                         lambda _: (lambda qt: qt), {"scan_scale": None}, res)


def sharded_ivf_pq_search(
    comms: Comms,
    sharded: dict,
    queries,
    k: int,
    *,
    n_probes: int = 20,
    lut_dtype: str = "float32",
    strategy: str = "auto",
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed IVF-PQ search: each shard probes ``n_probes`` of its own
    lists and scans their decoded cache (``lut_dtype`` the product dtype;
    an int8 cache its quantized-query leg at the global ``scan_scale``);
    per-shard top-k results are gathered and re-selected.  (distances [q,
    k], ids [q, k]) on the mesh's first device."""
    if lut_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"lut_dtype must be float32|bfloat16, got {lut_dtype!r}")
    return _sharded_scan(comms, sharded, queries, k, n_probes, strategy, "list_y2",
                         lambda rot: (lambda qt: torch.matmul(qt, rot.T)),
                         {"scan_dtype": lut_dtype, "scan_scale": sharded["scan_scale"]}, res)


def sharded_ivf_pq_build(comms: Comms, x_sharded: Sharded, params, *,
                         res: Optional[Resources] = None):
    """MNMG IVF-PQ build (the raft-dask pattern: workers share one
    quantizer and index their local rows):

    1. train the coarse centers and PQ codebooks once on the trainset
       subsample (the single-device build's code, so one seed gives one
       quantizer);
    2. each shard predicts and encodes its own rows against it;
    3. the codes and labels are gathered in rank order and assembled by
       the single-device seam (``ivf_pq._extend_encoded``): the index is
       byte-identical to a single-device build of the same rows.
    """
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_pq

    shards = _shards(comms, x_sharded)
    root = _root(comms)
    full = _gather(comms, shards, 0)
    n = full.shape[0]
    skel = ivf_pq.build(replace(params, add_data_on_build=False), full,
                        res=_res(root, res))
    kb_metric = ("inner_product" if DISTANCE_TYPES[params.metric] == "inner_product"
                 else "sqeuclidean")

    def local(rank, xs, centers, rotation, codebook):
        r = _res(xs.device, res)
        tile = max(1, r.workspace_rows(
            4 * (skel.rot_dim * 3 + skel.pq_dim * skel.pq_n_centers), cap=1 << 18))
        codes, labels = [], []
        for s in range(0, xs.shape[0], tile):
            xt = xs[s:s + tile].to(torch.float32)
            lt = kmeans_balanced.predict(centers, xt, metric=kb_metric, res=r)
            codes.append(ivf_pq._encode(rotation, centers, codebook, xt, lt,
                                        skel.codebook_kind))
            labels.append(lt)
        return torch.cat(codes), torch.cat(labels)

    outs = comms.run(local, shards,
                     replicated=(skel.centers, skel.rotation, skel.codebook))
    codes = _gather(comms, [o[0] for o in outs], 0)
    labels = _gather(comms, [o[1] for o in outs], 0)
    return ivf_pq._extend_encoded(skel, codes, labels.cpu().numpy(),
                                  torch.arange(n, dtype=torch.int32))


# -- CAGRA ------------------------------------------------------------------

def sharded_cagra_search(comms: Comms, index, queries, k: int, *, params=None,
                         res: Optional[Resources] = None):
    """Data-parallel CAGRA search: the graph index replicated, the queries
    sharded over the axis, each shard walking its own queries (the walk
    kernel on the card), the results gathered back in rank order.  The
    whole batch is seeded once before the split, so each query's result
    does not depend on the split: it equals the single-device search."""
    from raft_tpu_torch.neighbors import cagra

    params = params or cagra.SearchParams()
    size = comms.get_size()
    dev = index.graph.device
    queries = as_f32(queries, dev)
    q = queries.shape[0]
    seeds = cagra.make_seed_ids(params, index, queries, k)
    q_pad = -(-q // size) * size
    if q_pad != q:
        queries = torch.cat([queries, queries.new_zeros((q_pad - q, queries.shape[1]))])
        seeds = torch.cat([seeds, seeds.new_zeros((q_pad - q, seeds.shape[1]))])
    copies = {}

    def local(rank, qs, ss):
        d = qs.device
        if d not in copies:
            copies[d] = index if d == dev else cagra.from_graph(
                index.metric, index.dataset.to(d), index.graph.to(d),
                None if index.entry_centers is None else index.entry_centers.to(d),
                None if index.entry_ids is None else index.entry_ids.to(d),
                res=_res(d, res))
        return cagra.search(params, copies[d], qs, k, seed_ids=ss, res=_res(d, res))

    outs = comms.run(local, comms.shard(queries), comms.shard(seeds))
    v = _gather(comms, [o[0] for o in outs], 0)
    i = _gather(comms, [o[1] for o in outs], 0)
    return v[:q], i[:q]


def _batch_seed(seed: int, b: int) -> int:
    """Batch ``b``'s NN-descent seed: a function of the global batch index
    alone (raft_tpu folds the batch index into its key), so the build is
    the same for any number of shards."""
    return int(np.random.SeedSequence([int(seed), int(b)]).generate_state(1)[0] & 0x7FFFFFFF)


def sharded_cagra_build(comms: Comms, params, dataset, *, max_cluster_rows: int = 65_536,
                        res: Optional[Resources] = None):
    """MNMG CAGRA build: the batch-GNND plan (balanced clustering and the
    top-2 overlap assignment, ``nn_descent.plan_batches``) runs once on the
    host; the batches' fixed-iteration NN-descent builds are spread over
    the shards (batch b on shard b mod size, its seed from b alone); the
    local graphs merge on the host as in ``nn_descent.build_batch``; the
    graph optimisation and entry points are ``cagra.finalize_index``'s.
    The index does not depend on the number of shards."""
    from raft_tpu_torch.neighbors import cagra, nn_descent

    root = _root(comms)
    r_root = _res(root, res)
    dataset_np = np.asarray(dataset.cpu() if torch.is_tensor(dataset) else dataset,
                            np.float32)
    n, d = dataset_np.shape
    inter = min(params.intermediate_graph_degree, n - 1)
    nnd = nn_descent.IndexParams(
        graph_degree=inter,
        intermediate_graph_degree=min(n - 1, max(inter + inter // 2, inter + 8)),
        max_iterations=params.nn_descent_niter,
        metric=params.metric,
        seed=params.seed,
    )
    plan = nn_descent.plan_batches(nnd, dataset_np, max_cluster_rows=max_cluster_rows,
                                   force=True, res=r_root)
    batches, pad_m, k_out = plan["batches"], plan["pad_m"], plan["k_out"]
    lp = plan["local_params"]
    k_inter = min(lp.intermediate_graph_degree, pad_m - 1)
    sample = lp.sample_size or min(k_inter, 16)
    c = sample * k_inter + sample
    tile = max(1, min(pad_m, r_root.workspace_rows(4 * c * (d + 4), cap=4096)))
    size = comms.get_size()

    def local(rank, dev):
        out = []
        for b in range(rank, len(batches), size):
            x1 = torch.from_numpy(nn_descent.pad_batch(dataset_np, batches[b], plan))
            gi, gd = nn_descent.gnnd_fixed(
                _batch_seed(lp.seed, b), x1, metric=lp.metric, k=k_inter, sample=sample,
                tile=tile, iters=lp.max_iterations, res=_res(dev, res))
            out.append((b, gi[:, :k_out].cpu(), gd[:, :k_out].cpu()))
        return out

    per_shard = comms.run(local, comms.devices)
    if comms.mesh.process_count > 1:
        raise NotImplementedError(
            "sharded_cagra_build gathers the local graphs on the host of one "
            "process; run it on a one-process mesh")
    g_ids = np.full((n, k_out), -1, np.int32)
    g_dists = np.full((n, k_out), np.inf, np.float32)
    for b, gi, gd in sorted((t for shard in per_shard for t in shard), key=lambda t: t[0]):
        nn_descent.merge_local_graph(g_ids, g_dists, batches[b], gi, gd, plan)
    knn = nn_descent.finalize_global_graph(g_ids, g_dists).graph
    return cagra.finalize_index(params, dataset, knn, res=r_root)


def take_rows(comms: Comms, shards: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global row ids over equal shards, any order, repeats
    allowed) of a row-sharded dataset, on the mesh's first device: each
    shard contributes the rows it owns and one allreduce adds the picks
    (every other entry is 0), so only the picked rows travel."""
    rows = int(comms.bcast([torch.tensor(s.shape[0]) for s in shards])[0])
    idx = torch.as_tensor(idx).to(torch.int64)

    def local(rank, xs):
        own = (idx // rows) == rank
        out = torch.zeros((idx.shape[0], xs.shape[1]), dtype=torch.float32, device=xs.device)
        out[own.to(xs.device)] = xs[(idx[own] - rank * rows).to(xs.device)].to(torch.float32)
        return out

    return comms.allreduce(comms.run(local, shards))[0]


# -- k-means ------------------------------------------------------------------

def assign_l2(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance [n] f32, label [n] int64) of each row by the
    fused L2 argmin (kernel #7 on the card): its score ``|c|^2 - 2 x.c``,
    plus ``|x|^2`` and clamped at 0 for the distance.  The sharded k-means
    fits assign with it (raft_tpu's single-device fits keep the distance
    tile; the two differ only at near ties)."""
    from raft_tpu_torch.kernels.fused_argmin import fused_l2_argmin

    x = x.to(torch.float32)
    c = centers.to(torch.float32)
    val, lab = fused_l2_argmin(x, c, (c * c).sum(dim=1))
    best = torch.clamp(val + (x * x).sum(dim=1), min=0.0)
    return best, lab.to(torch.int64)


def lloyd_stats(comms: Comms, shards: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                centers: torch.Tensor, reduce_dtype: str = "float32",
                assign=assign_l2) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One Lloyd iteration's statistics over row-sharded data, the one
    source of every sharded k-means update: each shard assigns its rows by
    ``assign(x, centers) -> (min distance [n] or None, labels [n] int64)``
    (default :func:`assign_l2`, kernel #7 on the card) and sums
    ``[x * w | w]`` by label; the partials merge in ONE packed allreduce,
    optionally quantized (``reduce_dtype``, ``quantized_psum``).  Returns
    (packed [k, d + 2]: the weighted sums | the weights' sums | the
    weighted inertia at [0, d + 1] (0 when ``assign`` gives no distance),
    on the mesh's first device; each shard's labels, rank order)."""
    from raft_tpu_torch.comms.quantized import quantized_psum
    from raft_tpu_torch.ops.matrix import segment_sum

    n_clusters = centers.shape[0]

    def local(rank, x, w, c):
        best, labels = assign(x, c)
        packed = segment_sum(torch.cat([x * w[:, None], w[:, None]], dim=1), labels, n_clusters)
        side = torch.zeros((n_clusters, 1), dtype=torch.float32, device=x.device)
        if best is not None:
            side[0, 0] = (w * best).sum()
        return torch.cat([packed, side], dim=1), labels

    outs = comms.run(local, shards, weights, replicated=(centers,))
    packed = quantized_psum(comms, [o[0] for o in outs], reduce_dtype)[0]
    return packed, [o[1] for o in outs]


def kmeans_step(comms: Comms, data_sharded: Sharded,
                centroids) -> Tuple[torch.Tensor, torch.Tensor]:
    """One distributed Lloyd iteration: each shard assigns its rows (#7)
    and sums them by label; one allreduce of the packed sums | counts |
    inertia (:func:`lloyd_stats`).  Returns (new centroids [k, d],
    inertia) on the mesh's first device; an empty cluster keeps its
    centroid."""
    shards = [s.to(torch.float32) for s in _shards(comms, data_sharded)]
    c0 = torch.as_tensor(centroids).to(torch.float32)
    d = c0.shape[1]
    ones = [torch.ones(s.shape[0], dtype=torch.float32, device=s.device) for s in shards]
    total, _ = lloyd_stats(comms, shards, ones, c0)
    sums, counts, inertia = total[:, :d], total[:, d], total[0, d + 1]
    c = c0.to(total.device)
    newc = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), c)
    return newc, inertia


def kmeans_fit(
    comms: Comms,
    data_sharded: Sharded,
    n_clusters: int,
    *,
    n_iters: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    n_init: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full distributed k-means (cuML-over-raft-comms MNMG pattern: every
    iteration one :func:`kmeans_step` allreduce).  Init is kmeans++ on a
    with-replacement subsample drawn from a ``torch.Generator`` seeded by
    ``seed`` (not raft_tpu's threefry draws).  Returns (centroids [k, d],
    inertia_history [n_iters]); iterations after convergence (shift² <
    tol · mean squared row norm) report inf.  ``n_init`` restarts keep the
    lowest final inertia."""
    from raft_tpu_torch.cluster.kmeans import kmeans_plus_plus_init

    shards = _shards(comms, data_sharded)
    n = int(comms.allreduce([torch.tensor(s.shape[0]) for s in shards])[0])
    gen = torch.Generator().manual_seed(int(seed))
    n_sub = min(n, max(4 * n_clusters, 4096))
    # with-replacement draw: O(n_sub), only the drawn rows travel
    subsample = take_rows(comms, shards, torch.randint(0, n, (n_sub,), generator=gen))
    sq = comms.allreduce([(s.to(torch.float32) ** 2).sum() for s in shards])[0]
    scale = float(sq) / n
    best = None
    for _ in range(max(1, n_init)):
        c = kmeans_plus_plus_init(gen, subsample, n_clusters)
        hist = torch.full((n_iters,), float("inf"))
        done = False
        for it in range(n_iters):
            if done:
                continue
            newc, inertia = kmeans_step(comms, shards, c)
            hist[it] = float(inertia)
            done = float(((newc - c) ** 2).sum()) < tol * scale
            if not done:
                c = newc
        finite = hist[torch.isfinite(hist)]
        cost = float(finite[-1]) if finite.numel() else float("inf")
        if best is None or cost < best[0]:
            best = (cost, c, hist)
    return best[1], best[2]
