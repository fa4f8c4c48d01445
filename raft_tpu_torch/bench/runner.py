"""Benchmark runner: algorithm wrappers and the QPS / latency / recall
counters (counterpart of ``raft_tpu.bench.runner``; the reference's ANN
interface, ann_types.hpp, and its gbench harness, benchmark.hpp).

Every wrapper drives an index through its public entry points on the
``Resources`` it is given (the card by default; ``Resources(device="cpu")``
for the CPU).  Timers stop after ``torch.cuda.synchronize()``, so QPS
counts finished work, not enqueued launches.  The kernel library is built
and loaded before any timer starts (raft_tpu's counterpart is a warmed
jit): build times exclude the kernels' ``nvcc`` build.

``HnswNativeANN`` and the ``cpp/`` engines (``_NativeANN``) run the
native C++ core (``core.native``) on the host, off the card, as the
reference's harness runs its CPU libraries.  ``SklearnANN`` raises
``NotImplementedError``: scikit-learn is not installed where the card is.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch.bench.datasets import Dataset
from raft_tpu_torch.core.resources import Resources, ensure
from raft_tpu_torch.stats.metrics import recall_at_k


def _sync(res: Resources) -> None:
    if res.device.type == "cuda":
        torch.cuda.synchronize(res.device)


def warm_kernels(res: Resources) -> None:
    """Build and load the kernel library now, so that no timed call pays
    for ``nvcc``."""
    if res.device.type == "cuda":
        from raft_tpu_torch import kernels

        kernels.library()


class ANN:
    """Algorithm wrapper interface (the reference's ``ANN<T>``)."""

    name = "base"

    def __init__(self, metric: str, build_param: Dict[str, Any], *,
                 res: Optional[Resources] = None):
        self.metric = metric
        self.build_param = build_param
        self.res = ensure(res)

    def build(self, dataset: np.ndarray) -> None:
        raise NotImplementedError

    def set_search_param(self, param: Dict[str, Any]) -> None:
        raise NotImplementedError

    def search(self, queries: torch.Tensor, k: int):
        raise NotImplementedError

    def save(self, path: str) -> None:
        pass

    def load(self, path: str) -> None:
        pass


class BruteForceANN(ANN):
    name = "raft_tpu_brute_force"

    def build(self, dataset):
        from raft_tpu_torch.neighbors import brute_force

        self._mod = brute_force
        self._index = brute_force.build(dataset, metric=self.metric, res=self.res)

    def set_search_param(self, param):
        pass

    def search(self, queries, k):
        return self._mod.search(self._index, queries, k, res=self.res)

    def save(self, path):
        self._mod.save(path, self._index)


class IvfFlatANN(ANN):
    name = "raft_tpu_ivf_flat"

    def build(self, dataset):
        from raft_tpu_torch.neighbors import ivf_flat

        self._mod = ivf_flat
        params = ivf_flat.IndexParams(metric=self.metric, **self.build_param)
        self._index = ivf_flat.build(params, dataset, res=self.res)
        self._sp = ivf_flat.SearchParams()

    def set_search_param(self, param):
        self._sp = self._mod.SearchParams(**param)

    def search(self, queries, k):
        return self._mod.search(self._sp, self._index, queries, k, res=self.res)

    def save(self, path):
        self._mod.save(path, self._index)


class IvfPqANN(ANN):
    """IVF-PQ; a search param ``refine_ratio`` > 1 searches ``k x ratio``
    candidates and refines them exactly to k."""

    name = "raft_tpu_ivf_pq"

    def build(self, dataset):
        from raft_tpu_torch.core.resources import to_device
        from raft_tpu_torch.neighbors import ivf_pq

        self._mod = ivf_pq
        self._refine_ratio = 1
        params = ivf_pq.IndexParams(metric=self.metric, **self.build_param)
        self._dataset = to_device(dataset, self.res.device)
        self._index = ivf_pq.build(params, self._dataset, res=self.res)
        self._sp = ivf_pq.SearchParams()

    def set_search_param(self, param):
        param = dict(param)
        self._refine_ratio = int(param.pop("refine_ratio", 1))
        self._sp = self._mod.SearchParams(**param)

    def search(self, queries, k):
        from raft_tpu_torch.neighbors.refine import refine

        if self._refine_ratio > 1:
            _, cand = self._mod.search(self._sp, self._index, queries, k * self._refine_ratio,
                                       res=self.res)
            return refine(self._dataset, queries, cand, k, metric=self.metric, res=self.res)
        return self._mod.search(self._sp, self._index, queries, k, res=self.res)

    def save(self, path):
        self._mod.save(path, self._index)


#: one-slot CAGRA build cache: the bf16 variant shares the plain variant's
#: graph (they differ only in the stored rows), so a sweep builds it once
_CAGRA_BUILD_CACHE: dict = {}


class CagraANN(ANN):
    name = "raft_tpu_cagra"

    def build(self, dataset):
        from raft_tpu_torch.neighbors import cagra

        self._mod = cagra
        bp = dict(self.build_param)
        # "compress": True benches the VPQ-compressed dataset (decode on gather)
        compress = bp.pop("compress", False)
        # "dataset_dtype": "bfloat16" stores the walk's rows in bf16; the
        # graph is built (and cached) from the rows as given
        ds_dtype = bp.pop("dataset_dtype", None)
        params = cagra.IndexParams(metric=self.metric, **bp)
        sample = np.asarray(dataset[:min(256, dataset.shape[0])])
        key = (tuple(dataset.shape), str(sample.dtype), hash(sample.tobytes()), self.metric,
               tuple(sorted(bp.items())), str(self.res.device))
        cached = _CAGRA_BUILD_CACHE.get(key)
        if cached is None:
            t0 = time.perf_counter()
            base = cagra.build(params, dataset, res=self.res)
            _sync(self.res)
            build_s = time.perf_counter() - t0
            _CAGRA_BUILD_CACHE.clear()
            _CAGRA_BUILD_CACHE[key] = (base, build_s)
            self._cache_hit = False
        else:
            base, build_s = cached
            self._cache_hit = True
        # a cache hit reports the shared graph build's cost too
        self.shared_build_s = build_s
        index = base
        if ds_dtype:
            index = cagra.Index(base.metric, base.dataset.to(getattr(torch, ds_dtype)),
                                base.graph, base.entry_centers, base.entry_ids)
        if compress:
            index = cagra.compress(index, res=self.res)
        self._index = index
        self._sp = cagra.SearchParams()

    def set_search_param(self, param):
        self._sp = self._mod.SearchParams(**param)

    def search(self, queries, k):
        return self._mod.search(self._sp, self._index, queries, k, res=self.res)

    def save(self, path):
        self._mod.save(path, self._index)


class CagraVpqANN(CagraANN):
    """CAGRA over a VPQ-compressed dataset (decode on gather, the plain walk)."""

    name = "raft_tpu_cagra_vpq"

    def build(self, dataset):
        self.build_param = {**self.build_param, "compress": True}
        super().build(dataset)


class CagraBf16ANN(CagraANN):
    """CAGRA walking bf16 rows (half the bytes a hop gathers)."""

    name = "raft_tpu_cagra_bf16"

    def build(self, dataset):
        self.build_param = {**self.build_param, "dataset_dtype": "bfloat16"}
        super().build(dataset)


class _NotPortedANN(ANN):
    """A wrapper whose module the port does not have yet."""

    why = ""

    def build(self, dataset):
        raise NotImplementedError(f"{self.name}: {self.why}")


class BallCoverANN(ANN):
    """Random ball cover: ``build_param`` passes to ``ball_cover.build``
    (``n_landmarks``, ``seed``), ``n_probes`` is the search parameter."""

    name = "raft_tpu_ball_cover"

    def build(self, dataset):
        from raft_tpu_torch.neighbors import ball_cover

        self._mod = ball_cover
        self._index = ball_cover.build(dataset, metric=self.metric, **self.build_param,
                                       res=self.res)
        self._n_probes = 0

    def set_search_param(self, param):
        self._n_probes = int(param.get("n_probes", 0))

    def search(self, queries, k):
        return self._mod.knn_query(self._index, queries, k, n_probes=self._n_probes,
                                   res=self.res)


class NumpyExactANN(ANN):
    """The host floor: exact kNN in numpy alone, no torch on its path."""

    name = "numpy_exact"

    def build(self, dataset):
        self._x = np.ascontiguousarray(dataset, np.float32)
        self._x2 = (self._x.astype(np.float64) ** 2).sum(-1)
        self._xn = np.sqrt(np.maximum(self._x2, 1e-30))

    def set_search_param(self, param):
        self._tile = int(param.get("tile", 2048))

    def search(self, queries, k):
        q = np.ascontiguousarray(
            queries.cpu().numpy() if isinstance(queries, torch.Tensor) else queries, np.float32)
        vals = np.empty((q.shape[0], k), np.float32)
        ids = np.empty((q.shape[0], k), np.int32)
        for s in range(0, q.shape[0], self._tile):
            qt = q[s:s + self._tile]
            if self.metric == "inner_product":
                d = -(qt @ self._x.T)
            elif self.metric == "cosine":
                qn = np.sqrt(np.maximum((qt.astype(np.float64) ** 2).sum(-1), 1e-30))
                d = 1.0 - (qt @ self._x.T) / (qn[:, None] * self._xn[None, :])
            else:
                d = self._x2[None, :] - 2.0 * (qt @ self._x.T)
                d += (qt.astype(np.float64) ** 2).sum(-1)[:, None]
            part = np.argpartition(d, k - 1, axis=1)[:, :k]
            pv = np.take_along_axis(d, part, axis=1)
            order = np.argsort(pv, axis=1)
            ids[s:s + self._tile] = np.take_along_axis(part, order, axis=1)
            vals[s:s + self._tile] = np.take_along_axis(pv, order, axis=1)
        return vals, ids


class SklearnANN(_NotPortedANN):
    name = "sklearn"
    why = "scikit-learn is not installed where the card is"


class HnswANN(ANN):
    """hnswlib-format comparator: the CAGRA graph built here, exported in
    hnswlib's binary layout, loaded back and searched on the CAGRA walk
    (``neighbors.hnsw``; stock hnswlib is not installed where the card is)."""

    name = "hnswlib_format"

    def _export(self, dataset):
        """Build the CAGRA graph (no entry-point table: the hnswlib layout
        keeps only rows and graph) and write the interchange file."""
        import tempfile

        from raft_tpu_torch.neighbors import cagra, hnsw

        self._hnsw = hnsw
        self._dim = dataset.shape[1]
        params = cagra.IndexParams(metric=self.metric, **{"entry_points": 0, **self.build_param})
        built = cagra.build(params, dataset, res=self.res)
        fd, self._path = tempfile.mkstemp(suffix=".hnsw")
        os.close(fd)
        hnsw.serialize_to_hnswlib(self._path, built, res=self.res)

    def build(self, dataset):
        self._export(dataset)
        self._index = self._hnsw.load(self._path, self._dim, metric=self.metric, res=self.res)
        self._ef = 64

    def __del__(self):
        path = getattr(self, "_path", None)
        if path and os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass

    def set_search_param(self, param):
        self._ef = int(param.get("ef", 64))

    def search(self, queries, k):
        return self._hnsw.search(self._index, queries, k, ef=self._ef, res=self.res)

    def save(self, path):
        import shutil

        shutil.copy(self._path, path)


class HnswNativeANN(HnswANN):
    """``hnswlib_format``'s exported file searched by the native C++ HNSW
    engine (``cpp/src/hnsw.cc``: greedy upper-level descent, then an
    ef-bounded best-first search at layer 0, threaded over queries) on the
    host: the role hnswlib's C++ plays in the reference's harness."""

    name = "hnsw_native"

    def build(self, dataset):
        self._export(dataset)   # the graph and its file only: no walk index to discard
        from raft_tpu_torch.neighbors import hnsw

        self._native = hnsw.load_native(self._path, self._dim)
        self._threads = 0
        self._ef = 64
        self._n_seeds = 1

    def set_search_param(self, param):
        super().set_search_param(param)
        self._threads = int(param.get("n_threads", 0))
        self._n_seeds = int(param.get("n_seeds", 1))

    def search(self, queries, k):
        d, ids = self._native.search(_host_f32(queries), k, ef=self._ef, metric=self.metric,
                                     n_seeds=self._n_seeds, n_threads=self._threads)
        return d, ids.astype(np.int32)


def _host_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                                np.float32)


class _NativeANN(ANN):
    """The C ABI's host engines (``cpp/src/ann_index.cc`` through
    ``core.native``): threaded C++ with no torch in build or search, the
    role faiss-CPU plays in the reference's harness."""

    def set_search_param(self, param):
        self._n_probes = int(param.get("n_probes", 32))
        self._itopk = int(param.get("itopk_size", 64))

    def search(self, queries, k):
        return self._index.search(_host_f32(queries), k, n_probes=self._n_probes,
                                  itopk=self._itopk)

    def save(self, path):
        self._index.save(path)


class NativeIvfFlatANN(_NativeANN):
    name = "native_ivf_flat"

    def build(self, dataset):
        from raft_tpu_torch.core import native

        self._index = native.NativeAnnIndex.ivf_flat(
            _host_f32(dataset), n_lists=int(self.build_param.get("n_lists", 256)),
            metric=self.metric, kmeans_iters=int(self.build_param.get("kmeans_n_iters", 10)))
        self.set_search_param({})


def _divisor_pq_dim(dim: int, want: int) -> int:
    """The largest divisor of ``dim`` that is <= max(1, want): the native
    engine needs dim % pq_dim == 0 (the port's IVF-PQ pads instead)."""
    want = max(1, min(want, dim))
    for cand in range(want, 0, -1):
        if dim % cand == 0:
            return cand
    return 1


class NativeIvfPqANN(_NativeANN):
    """The C ABI's IVF-PQ (ADC LUT scan) and a threaded exact host refine:
    the reference's classic CPU recipe."""

    name = "native_ivf_pq"

    def build(self, dataset):
        from raft_tpu_torch.core import native

        self._x = _host_f32(dataset)
        dim = self._x.shape[1]
        self._index = native.NativeAnnIndex.ivf_pq(
            self._x, n_lists=int(self.build_param.get("n_lists", 256)),
            pq_dim=_divisor_pq_dim(dim, int(self.build_param.get("pq_dim", dim // 4))),
            metric=self.metric, kmeans_iters=int(self.build_param.get("kmeans_n_iters", 10)))
        self.set_search_param({})

    def set_search_param(self, param):
        super().set_search_param(param)
        self._refine_ratio = int(param.get("refine_ratio", 4))

    def search(self, queries, k):
        from raft_tpu_torch.core import native

        q = _host_f32(queries)
        _, cand = self._index.search(q, k * self._refine_ratio, n_probes=self._n_probes)
        return native.refine_host(self._x, q, cand, k, metric=self.metric)


class NativeCagraANN(_NativeANN):
    name = "native_cagra"

    def build(self, dataset):
        from raft_tpu_torch.core import native

        self._index = native.NativeAnnIndex.cagra(
            _host_f32(dataset), graph_degree=int(self.build_param.get("graph_degree", 32)),
            metric=self.metric)
        self.set_search_param({})


ALGORITHMS = {
    a.name: a
    for a in (
        BruteForceANN, IvfFlatANN, IvfPqANN, CagraANN, CagraVpqANN, CagraBf16ANN,
        BallCoverANN, NumpyExactANN, SklearnANN, HnswANN, HnswNativeANN, NativeIvfFlatANN,
        NativeIvfPqANN, NativeCagraANN,
    )
}


@dataclass
class RunResult:
    """One (algo, build_param, search_param) measurement: the reference's
    counters.  ``device_time_s``: the card's busy seconds for one search
    batch (``device_time.measure_device_time``), None on the CPU."""

    algo: str
    dataset: str
    k: int
    build_param: Dict[str, Any]
    search_param: Dict[str, Any]
    build_time_s: float
    qps: float
    latency_ms: float
    recall: float
    end_to_end_s: float
    device_time_s: Optional[float] = None
    device_qps: Optional[float] = None

    def to_dict(self):
        return {
            "algo": self.algo, "dataset": self.dataset, "k": self.k,
            "build_param": self.build_param, "search_param": self.search_param,
            "build_time_s": self.build_time_s, "qps": self.qps,
            "latency_ms": self.latency_ms, "recall": self.recall,
            "end_to_end_s": self.end_to_end_s, "device_time_s": self.device_time_s,
            "device_qps": self.device_qps,
        }


def _ids_numpy(i) -> np.ndarray:
    return i.cpu().numpy() if isinstance(i, torch.Tensor) else np.asarray(i)


def run_case(ds: Dataset, algo_name: str, build_param: Dict[str, Any],
             search_params: List[Dict[str, Any]], *, k: int = 10, warmup: int = 1,
             iters: int = 3, res: Optional[Resources] = None) -> List[RunResult]:
    """Build once, then each search param: warm-up, ``iters`` timed searches
    of every query, recall against the ground truth, one device-time
    window.  Build time excludes the kernels' build (:func:`warm_kernels`)."""
    if ds.gt_neighbors is None:
        raise ValueError("dataset has no groundtruth; run generate_groundtruth")
    # imported here, so that ``python -m raft_tpu_torch.bench.device_time``
    # finds its module unloaded
    from raft_tpu_torch.bench.device_time import measure_device_time

    res = ensure(res)
    warm_kernels(res)
    algo = ALGORITHMS[algo_name](ds.metric, build_param, res=res)
    _sync(res)
    t0 = time.perf_counter()
    algo.build(ds.base)
    _sync(res)
    build_time = time.perf_counter() - t0
    # a cached CAGRA build reports the shared graph build's cost as well
    if getattr(algo, "_cache_hit", False):
        build_time += getattr(algo, "shared_build_s", 0.0)

    queries = torch.from_numpy(np.ascontiguousarray(ds.queries)).to(res.device)
    nq = ds.queries.shape[0]
    out = []
    for sp in search_params:
        algo.set_search_param(sp)
        for _ in range(warmup):
            algo.search(queries, k)
        _sync(res)
        t0 = time.perf_counter()
        for _ in range(iters):
            v, i = algo.search(queries, k)
        _sync(res)
        dt = (time.perf_counter() - t0) / iters
        rec = recall_at_k(_ids_numpy(i), ds.gt_neighbors[:, :k])
        dev_s = measure_device_time(lambda qq: algo.search(qq, k), queries)
        out.append(RunResult(
            algo=algo_name, dataset=ds.name, k=k, build_param=build_param, search_param=sp,
            build_time_s=build_time, qps=nq / dt, latency_ms=dt / nq * 1e3, recall=rec,
            end_to_end_s=dt, device_time_s=dev_s,
            device_qps=None if not dev_s else nq / dev_s))
    return out


def run_config(ds: Dataset, config: Dict[str, Any], *, k: int = 10,
               res: Optional[Resources] = None) -> List[RunResult]:
    """Run a config of the reference's shape: ``{"algos": [{"name",
    "build_param", "search_params": [...]}, ...]}``; an entry's ``label``
    (a conf's entry name) replaces the engine name in the results."""
    results = []
    for spec in config["algos"]:
        rs = run_case(ds, spec["name"], spec.get("build_param", {}),
                      spec.get("search_params", [{}]), k=k, res=res)
        label = spec.get("label")
        if label:
            for r in rs:
                r.algo = label
        results.extend(rs)
    return results


def save_results(results: List[RunResult], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump([r.to_dict() for r in results], fh, indent=2)
