"""ctypes binding to the native C++ core (counterpart of
``raft_tpu.core.native``): the C ABI of ``cpp/include/raft_tpu/c_api.h``
(resources and workspace arena, logger, .npy serializer, interruptible
tokens, host algorithms, the hnswlib-format engine and the host ANN
indexes), playing the reference's ``raft_runtime`` role.

The library is compiled from ``cpp/src/*.cc`` with ``g++ -O2 -std=c++17
-fPIC -shared -Icpp/include`` into ``raft_tpu_torch/_build/`` (never into
``cpp/``), one ``g++`` a source, all started together, on first use.  The
build holds a file lock and renames its output into place, so concurrent
processes never race; the file name carries a digest of the sources,
headers and flags.  ``available()`` is False where there is no compiler
(or the sources are missing): everything here is then unavailable.

The native core is a host engine: nothing on a device path of the port
falls back to it.  It serves the bench runner's native engines,
``hnsw.load_native``, the native interruptible token, the logger bridge
and ``Resources.native``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

_LIB = None
_LOCK = threading.Lock()
CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("serialize", "c_api", "algorithms", "hnsw", "ann_index")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC")

_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int8): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint32): 6,
    np.dtype(np.float16): 7,
}
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}

LOG_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(CPP_DIR.joinpath("src").glob("*.cc")) + sorted(
            CPP_DIR.joinpath("include").rglob("*.h*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the native core into ``_build/libraft_tpu_core_<digest>.so``
    (an up-to-date library is not rebuilt) and return its path.  Raises
    RuntimeError when there is no compiler or a compile fails."""
    cxx = _cxx()
    if cxx is None or not all(CPP_DIR.joinpath("src", f"{s}.cc").exists() for s in SOURCES):
        raise RuntimeError("native core unavailable: no C++ compiler or no cpp/ sources")
    out = BUILD_DIR / f"libraft_tpu_core_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # built by another process while this one waited
            return out
        tag = f"{os.getpid()}_{threading.get_ident()}"
        objs = [BUILD_DIR / f"native_{s}_{tag}.o" for s in SOURCES]

        def compile_one(src, obj):
            return subprocess.run(
                [cxx, *CXX_FLAGS, f"-I{CPP_DIR / 'include'}", "-c",
                 str(CPP_DIR / "src" / f"{src}.cc"), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        try:
            with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
                done = list(pool.map(compile_one, SOURCES, objs))
            failed = [f"{s}.cc:\n{p.stdout}" for s, p in zip(SOURCES, done) if p.returncode]
            if failed:
                raise RuntimeError("native core build failed:\n" + "\n".join(failed))
            tmp = out.with_suffix(f".{tag}.tmp")
            link = subprocess.run([cxx, "-shared", "-o", str(tmp), *map(str, objs), "-lpthread"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode:
                raise RuntimeError(f"native core link failed:\n{link.stdout}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, out)
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError):
            _LIB = False
            return _LIB
        lib.rt_last_error.restype = ctypes.c_char_p
        lib.rt_resources_create.restype = ctypes.c_void_p
        lib.rt_resources_create.argtypes = [ctypes.c_size_t]
        lib.rt_resources_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_resources_copy.restype = ctypes.c_void_p
        lib.rt_resources_copy.argtypes = [ctypes.c_void_p]
        lib.rt_workspace_alloc.restype = ctypes.c_void_p
        lib.rt_workspace_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_workspace_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.rt_workspace_used.restype = ctypes.c_size_t
        lib.rt_workspace_used.argtypes = [ctypes.c_void_p]
        lib.rt_workspace_high_water.restype = ctypes.c_size_t
        lib.rt_workspace_high_water.argtypes = [ctypes.c_void_p]
        lib.rt_log_set_level.argtypes = [ctypes.c_int]
        lib.rt_log_get_level.restype = ctypes.c_int
        lib.rt_log.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.rt_log_set_callback.argtypes = [LOG_CALLBACK, ctypes.c_void_p]
        lib.rt_npy_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ]
        lib.rt_npy_read_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.rt_npy_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_interruptible_token.restype = ctypes.c_void_p
        lib.rt_interruptible_cancel.argtypes = [ctypes.c_void_p]
        lib.rt_interruptible_cancelled.restype = ctypes.c_int
        lib.rt_interruptible_cancelled.argtypes = [ctypes.c_void_p]
        lib.rt_interruptible_check.restype = ctypes.c_int
        lib.rt_interruptible_check.argtypes = [ctypes.c_void_p]
        # algorithm entry points (ref: raft_runtime/neighbors/*.hpp role)
        lib.rt_alg_last_error.restype = ctypes.c_char_p
        lib.rt_refine_host.restype = ctypes.c_int
        lib.rt_refine_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # dataset
            ctypes.c_void_p, ctypes.c_int64,                   # queries
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # candidates, k
            ctypes.c_int,                                      # metric
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,    # outs, threads
        ]
        lib.rt_pack_list_layout.restype = ctypes.c_int
        lib.rt_pack_list_layout.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rt_knn_host.restype = ctypes.c_int
        lib.rt_knn_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # dataset
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # queries, k
            ctypes.c_int,                                     # metric
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # outs, threads
        ]
        lib.rt_select_k_host.restype = ctypes.c_int
        lib.rt_select_k_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.rt_pairwise_distance_host.restype = ctypes.c_int
        lib.rt_pairwise_distance_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,                  # x, m
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # y, n, d
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,      # metric, out, threads
        ]
        lib.rt_kmeans_fit_host.restype = ctypes.c_int
        lib.rt_kmeans_fit_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.rt_rmat_host.restype = ctypes.c_int
        lib.rt_rmat_host.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        # native hnswlib-format engine (ref: the hnswlib role of
        # cpp/bench/ann/src/hnswlib/hnswlib_wrapper.h)
        lib.rt_hnsw_last_error.restype = ctypes.c_char_p
        lib.rt_hnsw_load.restype = ctypes.c_int
        lib.rt_hnsw_load.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.rt_hnsw_info.restype = ctypes.c_int
        lib.rt_hnsw_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rt_hnsw_element.restype = ctypes.c_int
        lib.rt_hnsw_element.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ]
        lib.rt_hnsw_search.restype = ctypes.c_int
        lib.rt_hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.rt_hnsw_free.argtypes = [ctypes.c_void_p]
        # ANN-index C ABI (ref: raft_runtime/neighbors/*.hpp span)
        lib.rt_ann_last_error.restype = ctypes.c_char_p
        lib.rt_ann_index_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_ann_index_info.restype = ctypes.c_int
        lib.rt_ann_index_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rt_ivf_flat_build.restype = ctypes.c_void_p
        lib.rt_ivf_flat_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rt_ivf_flat_search.restype = ctypes.c_int
        lib.rt_ivf_flat_search.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.rt_ivf_pq_build.restype = ctypes.c_void_p
        lib.rt_ivf_pq_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rt_ivf_pq_search.restype = ctypes.c_int
        lib.rt_ivf_pq_search.argtypes = lib.rt_ivf_flat_search.argtypes
        lib.rt_cagra_build.restype = ctypes.c_void_p
        lib.rt_cagra_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.rt_cagra_search.restype = ctypes.c_int
        lib.rt_cagra_search.argtypes = lib.rt_ivf_flat_search.argtypes
        lib.rt_ann_serialize.restype = ctypes.c_int
        lib.rt_ann_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_ann_deserialize.restype = ctypes.c_void_p
        lib.rt_ann_deserialize.argtypes = [ctypes.c_char_p]
        lib.rt_eps_neighbors_host.restype = ctypes.c_int
        lib.rt_eps_neighbors_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not False


def _lib():
    lib = _load()
    if lib is False:
        raise RuntimeError("native core unavailable (no toolchain?)")
    return lib


def _check(code: int):
    if code != 0:
        raise RuntimeError(_lib().rt_last_error().decode())


class NativeResources:
    """Handle over the C++ resources container (ref: raft::resources)."""

    def __init__(self, workspace_limit_bytes: int = 256 * 1024 * 1024, _h=None):
        self._h = _h or _lib().rt_resources_create(workspace_limit_bytes)
        if not self._h:
            raise RuntimeError("resources creation failed")

    def copy(self) -> "NativeResources":
        return NativeResources(_h=_lib().rt_resources_copy(self._h))

    def workspace_alloc(self, bytes_: int) -> int:
        p = _lib().rt_workspace_alloc(self._h, bytes_)
        if not p:
            raise MemoryError(_lib().rt_last_error().decode())
        return p

    def workspace_free(self, ptr: int) -> None:
        _check(_lib().rt_workspace_free(self._h, ptr))

    @property
    def workspace_used(self) -> int:
        return _lib().rt_workspace_used(self._h)

    @property
    def workspace_high_water(self) -> int:
        return _lib().rt_workspace_high_water(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and _LIB not in (None, False):
            _LIB.rt_resources_destroy(h)


def npy_write(path: str, arr: np.ndarray) -> None:
    """Write through the native .npy serializer (byte-compatible with
    np.save; ref: core/serialize.hpp serialize_mdspan)."""
    arr = np.ascontiguousarray(arr)
    dt = _DTYPES[arr.dtype]
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    _check(
        _lib().rt_npy_write(
            path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
            shape, arr.ndim, dt,
        )
    )


def npy_read(path: str) -> np.ndarray:
    shape = (ctypes.c_int64 * 16)()
    rank = ctypes.c_int()
    dt = ctypes.c_int()
    _check(_lib().rt_npy_read_info(path.encode(), shape, ctypes.byref(rank),
                                   ctypes.byref(dt), 16))
    sh = tuple(shape[i] for i in range(rank.value))
    out = np.empty(sh, _DTYPES_INV[dt.value])
    _check(_lib().rt_npy_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                              out.nbytes))
    return out


def log_set_level(level: int) -> None:
    _lib().rt_log_set_level(level)


def log(level: int, msg: str) -> None:
    _lib().rt_log(level, msg.encode())


_cb_keepalive = []


def log_set_callback(fn) -> None:
    """fn(level: int, msg: str) — mirrors the reference's callback sink
    (core/detail/callback_sink.hpp) used for Python log integration."""
    if fn is None:
        _lib().rt_log_set_callback(LOG_CALLBACK(0), None)
        return
    cb = LOG_CALLBACK(lambda lvl, msg, _u: fn(lvl, msg.decode()))
    _cb_keepalive.append(cb)
    _lib().rt_log_set_callback(cb, None)


_METRIC_CODES = {"sqeuclidean": 0, "euclidean": 1, "inner_product": 2, "cosine": 3}


def refine_host(
    dataset: np.ndarray,
    queries: np.ndarray,
    candidates: np.ndarray,
    k: int,
    metric: str = "sqeuclidean",
    n_threads: int = 0,
):
    """Native exact candidate re-rank, threaded over queries
    (ref: neighbors/detail/refine_host-inl.hpp via the raft_runtime-style
    C ABI). Returns (distances [q, k] f32, indices [q, k] i32)."""
    if metric not in _METRIC_CODES:
        raise ValueError(f"unsupported native refine metric {metric!r}")
    dataset = np.ascontiguousarray(dataset, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    candidates = np.ascontiguousarray(candidates, np.int32)
    if dataset.ndim != 2 or queries.ndim != 2 or candidates.ndim != 2:
        raise ValueError("dataset, queries and candidates must be 2-D")
    if queries.shape[1] != dataset.shape[1]:
        raise ValueError(
            f"queries dim {queries.shape[1]} != dataset dim {dataset.shape[1]}"
        )
    if candidates.shape[0] != queries.shape[0]:
        raise ValueError(
            f"candidates rows {candidates.shape[0]} != query count {queries.shape[0]}"
        )
    n_q, k_cand = candidates.shape
    out_d = np.empty((n_q, k), np.float32)
    out_i = np.empty((n_q, k), np.int32)
    code = _lib().rt_refine_host(
        dataset.ctypes.data_as(ctypes.c_void_p), dataset.shape[0], dataset.shape[1],
        queries.ctypes.data_as(ctypes.c_void_p), n_q,
        candidates.ctypes.data_as(ctypes.c_void_p), k_cand, k,
        _METRIC_CODES[metric],
        out_d.ctypes.data_as(ctypes.c_void_p),
        out_i.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return out_d, out_i


def knn_host(
    dataset: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str = "sqeuclidean",
    n_threads: int = 0,
):
    """Native exact brute-force kNN, threaded over queries — the
    groundtruth-generation path (ref: raft-ann-bench generate_groundtruth;
    raft_runtime/neighbors/brute_force.hpp role). Returns
    (distances [q, k] f32, indices [q, k] i32)."""
    if metric not in _METRIC_CODES:
        raise ValueError(f"unsupported native knn metric {metric!r}")
    dataset = np.ascontiguousarray(dataset, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    if dataset.ndim != 2 or queries.ndim != 2:
        raise ValueError("dataset and queries must be 2-D")
    if queries.shape[1] != dataset.shape[1]:
        raise ValueError(
            f"queries dim {queries.shape[1]} != dataset dim {dataset.shape[1]}"
        )
    n_q = queries.shape[0]
    out_d = np.empty((n_q, k), np.float32)
    out_i = np.empty((n_q, k), np.int32)
    code = _lib().rt_knn_host(
        dataset.ctypes.data_as(ctypes.c_void_p), dataset.shape[0], dataset.shape[1],
        queries.ctypes.data_as(ctypes.c_void_p), n_q, k,
        _METRIC_CODES[metric],
        out_d.ctypes.data_as(ctypes.c_void_p),
        out_i.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return out_d, out_i


def select_k_host(
    scores: np.ndarray, k: int, select_min: bool = True, n_threads: int = 0
):
    """Native batched top-k over host rows (ref: raft_runtime/matrix/
    select_k.hpp role). Returns (values [rows, k] f32, indices i32)."""
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.ndim != 2:
        raise ValueError("scores must be 2-D")
    rows, cols = scores.shape
    out_v = np.empty((rows, k), np.float32)
    out_i = np.empty((rows, k), np.int32)
    code = _lib().rt_select_k_host(
        scores.ctypes.data_as(ctypes.c_void_p), rows, cols, k,
        1 if select_min else 0,
        out_v.ctypes.data_as(ctypes.c_void_p),
        out_i.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return out_v, out_i


def pack_list_layout(labels: np.ndarray, n_lists: int, max_cap: int):
    """Native IVF list layout: (slot [n] i32, list [n] i64,
    center_map [n_lists'] i64, cap) with oversized lists split into shards
    (ref: the list layout of ivf_flat_build.cuh:88-154 + codepacker role)."""
    labels = np.ascontiguousarray(labels, np.int64)
    n = labels.shape[0]
    max_out = n_lists + (n // max(max_cap, 1)) + 1
    slot = np.empty(n, np.int32)
    lst = np.empty(n, np.int64)
    cmap = np.empty(max_out, np.int64)
    n_out = ctypes.c_int64()
    cap = ctypes.c_int64()
    code = _lib().rt_pack_list_layout(
        labels.ctypes.data_as(ctypes.c_void_p), n, n_lists, max_cap,
        slot.ctypes.data_as(ctypes.c_void_p),
        lst.ctypes.data_as(ctypes.c_void_p),
        cmap.ctypes.data_as(ctypes.c_void_p), max_out,
        ctypes.byref(n_out), ctypes.byref(cap),
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return slot, lst, cmap[: n_out.value].copy(), int(cap.value)


def pairwise_distance_host(
    x: np.ndarray, y: np.ndarray, metric: str = "sqeuclidean",
    n_threads: int = 0,
) -> np.ndarray:
    """Native host pairwise distance matrix (ref: raft_runtime/distance/
    pairwise_distance.hpp role). Returns [m, n] f32."""
    if metric not in _METRIC_CODES:
        raise ValueError(f"unsupported native metric {metric!r}")
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError("x and y must be 2-D with equal dims")
    out = np.empty((x.shape[0], y.shape[0]), np.float32)
    code = _lib().rt_pairwise_distance_host(
        x.ctypes.data_as(ctypes.c_void_p), x.shape[0],
        y.ctypes.data_as(ctypes.c_void_p), y.shape[0], x.shape[1],
        _METRIC_CODES[metric], out.ctypes.data_as(ctypes.c_void_p), n_threads,
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return out


def kmeans_fit_host(
    x: np.ndarray, init_centers: np.ndarray, n_iters: int = 20,
    n_threads: int = 0,
):
    """Native Lloyd iterations from given init centers (ref:
    raft_runtime/cluster/kmeans.hpp fit/cluster_cost/compute_new_centroids
    role). Returns (centers [k, d] f32, labels [n] i32, inertia float)."""
    x = np.ascontiguousarray(x, np.float32)
    centers = np.array(init_centers, np.float32, copy=True, order="C")
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError("x and init_centers must be 2-D with equal dims")
    labels = np.empty(x.shape[0], np.int32)
    inertia = ctypes.c_float()
    code = _lib().rt_kmeans_fit_host(
        x.ctypes.data_as(ctypes.c_void_p), x.shape[0], x.shape[1],
        centers.shape[0], int(n_iters),
        centers.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(inertia), n_threads,
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return centers, labels, float(inertia.value)


def rmat_host(
    r_scale: int, c_scale: int, n_edges: int,
    theta=(0.57, 0.19, 0.19), seed: int = 0,
):
    """Native R-MAT rectangular edge generator (ref: raft_runtime/random/
    rmat_rectangular_generator.hpp role; distribution parity, not bitwise).
    Returns (rows [n_edges] i64, cols [n_edges] i64)."""
    rows = np.empty(n_edges, np.int64)
    cols = np.empty(n_edges, np.int64)
    a, b, c = (float(t) for t in theta)
    code = _lib().rt_rmat_host(
        int(r_scale), int(c_scale), int(n_edges),
        a, b, c, int(seed) or 0,
        rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
    )
    if code != 0:
        raise RuntimeError(_lib().rt_alg_last_error().decode())
    return rows, cols


class HnswNativeIndex:
    """Native hnswlib-format index: independent C++ parser + true
    hierarchical HNSW search (ref: the hnswlib dependency's role in
    neighbors/hnsw.hpp and cpp/bench/ann/src/hnswlib/hnswlib_wrapper.h).

    Shares no code with the Python writer / parser in
    ``raft_tpu_torch/neighbors/hnsw.py``: loading a file written there
    through this class is a cross-language check of the binary format.
    """

    def __init__(self, path: str, dim: int):
        self._h = None
        h = ctypes.c_void_p()
        code = _lib().rt_hnsw_load(
            os.fsencode(path), int(dim), ctypes.byref(h)
        )
        if code != 0:
            raise RuntimeError(_lib().rt_hnsw_last_error().decode())
        self._h = h
        self.dim = int(dim)

    @property
    def info(self) -> dict:
        n = ctypes.c_int64()
        dim = ctypes.c_int64()
        max_m0 = ctypes.c_int64()
        max_level = ctypes.c_int32()
        entry = ctypes.c_int32()
        code = _lib().rt_hnsw_info(
            self._h, ctypes.byref(n), ctypes.byref(dim), ctypes.byref(max_m0),
            ctypes.byref(max_level), ctypes.byref(entry),
        )
        if code != 0:
            raise RuntimeError(_lib().rt_hnsw_last_error().decode())
        return {
            "n": n.value, "dim": dim.value, "max_m0": max_m0.value,
            "max_level": max_level.value, "entrypoint": entry.value,
        }

    def element(self, i: int):
        """(vector [dim] f32, label int, level-0 links [max_m0] i32,
        -1 padded) — the cross-check surface for other parsers."""
        inf = self.info
        vec = np.empty(inf["dim"], np.float32)
        links = np.empty(inf["max_m0"], np.int32)
        label = ctypes.c_int64()
        code = _lib().rt_hnsw_element(
            self._h, int(i), vec.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(label), links.ctypes.data_as(ctypes.c_void_p),
        )
        if code != 0:
            raise RuntimeError(_lib().rt_hnsw_last_error().decode())
        return vec, int(label.value), links

    def search(
        self, queries: np.ndarray, k: int, ef: int = 64,
        metric: str = "sqeuclidean", n_seeds: int = 1, n_threads: int = 0,
    ):
        """hnswlib-semantics knn_query: greedy upper-level descent then
        ef-bounded best-first at layer 0. ``n_seeds > 1`` adds evenly-
        strided extra layer-0 starts — the escape hatch for directed
        CAGRA graphs / MIP spaces where a single-entry search routes
        poorly (stock hnswlib has no analog; default 1 keeps its exact
        semantics). Returns (distances [q, k] f32, labels [q, k] i64)."""
        if metric not in _METRIC_CODES:
            raise ValueError(f"unsupported hnsw metric {metric!r}")
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"queries must be [q, {self.dim}]")
        n_q = queries.shape[0]
        out_d = np.empty((n_q, k), np.float32)
        out_i = np.empty((n_q, k), np.int64)
        code = _lib().rt_hnsw_search(
            self._h, queries.ctypes.data_as(ctypes.c_void_p), n_q, int(k),
            int(ef), int(n_seeds), _METRIC_CODES[metric],
            out_d.ctypes.data_as(ctypes.c_void_p),
            out_i.ctypes.data_as(ctypes.c_void_p), n_threads,
        )
        if code != 0:
            raise RuntimeError(_lib().rt_hnsw_last_error().decode())
        return out_d, out_i

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                _lib().rt_hnsw_free(self._h)
            except Exception:
                pass


class InterruptibleToken:
    """(ref: core/interruptible.hpp; pylibraft common/interruptible.pyx)"""

    def __init__(self):
        self._tok = _lib().rt_interruptible_token()

    def cancel(self) -> None:
        _lib().rt_interruptible_cancel(self._tok)

    @property
    def cancelled(self) -> bool:
        return bool(_lib().rt_interruptible_cancelled(self._tok))

    def check(self) -> None:
        code = _lib().rt_interruptible_check(self._tok)
        if code != 0:
            raise InterruptedError(_lib().rt_last_error().decode())


class NativeAnnIndex:
    """Host ANN index over the stable C ABI (ref: the consumer side of
    raft_runtime/neighbors/{ivf_flat,ivf_pq,cagra}.hpp).  Build with the
    ``ivf_flat``/``ivf_pq``/``cagra`` classmethods or :meth:`load`; search
    returns (distances, ids) numpy arrays.  The native engines are the
    non-Python half of the ABI, off every device path, and double as
    cross-language checks of the port's indexes."""

    _KINDS = {0: "ivf_flat", 1: "ivf_pq", 2: "cagra"}

    def __init__(self, handle):
        if not handle:
            raise RuntimeError(_lib().rt_ann_last_error().decode())
        self._h = handle

    # -- constructors ------------------------------------------------------
    @staticmethod
    def _metric_code(metric: str) -> int:
        if metric not in _METRIC_CODES:
            raise ValueError(f"unsupported native ANN metric {metric!r}")
        return _METRIC_CODES[metric]

    @classmethod
    def ivf_flat(cls, dataset: np.ndarray, n_lists: int,
                 metric: str = "sqeuclidean", *, kmeans_iters: int = 10,
                 n_threads: int = 0) -> "NativeAnnIndex":
        x = np.ascontiguousarray(dataset, np.float32)
        return cls(_lib().rt_ivf_flat_build(
            x.ctypes.data_as(ctypes.c_void_p), x.shape[0], x.shape[1],
            n_lists, cls._metric_code(metric), kmeans_iters, n_threads))

    @classmethod
    def ivf_pq(cls, dataset: np.ndarray, n_lists: int, pq_dim: int,
               metric: str = "sqeuclidean", *, kmeans_iters: int = 10,
               n_threads: int = 0) -> "NativeAnnIndex":
        x = np.ascontiguousarray(dataset, np.float32)
        return cls(_lib().rt_ivf_pq_build(
            x.ctypes.data_as(ctypes.c_void_p), x.shape[0], x.shape[1],
            n_lists, pq_dim, cls._metric_code(metric), kmeans_iters, n_threads))

    @classmethod
    def cagra(cls, dataset: np.ndarray, graph_degree: int = 32,
              metric: str = "sqeuclidean", *,
              n_threads: int = 0) -> "NativeAnnIndex":
        x = np.ascontiguousarray(dataset, np.float32)
        return cls(_lib().rt_cagra_build(
            x.ctypes.data_as(ctypes.c_void_p), x.shape[0], x.shape[1],
            graph_degree, cls._metric_code(metric), n_threads))

    @classmethod
    def load(cls, path: str) -> "NativeAnnIndex":
        return cls(_lib().rt_ann_deserialize(path.encode()))

    # -- introspection -----------------------------------------------------
    @property
    def info(self) -> dict:
        kind = ctypes.c_int64()
        n = ctypes.c_int64()
        d = ctypes.c_int64()
        extra = ctypes.c_int64()
        _lib().rt_ann_index_info(self._h, ctypes.byref(kind), ctypes.byref(n),
                                 ctypes.byref(d), ctypes.byref(extra))
        out = {"kind": self._KINDS.get(kind.value, kind.value),
               "size": n.value, "dim": d.value}
        out["graph_degree" if kind.value == 2 else "n_lists"] = extra.value
        return out

    # -- search / persist --------------------------------------------------
    def search(self, queries: np.ndarray, k: int, *, n_probes: int = 32,
               itopk: int = 64, n_threads: int = 0):
        """(dists [q, k] f32, ids [q, k] i32).  ``n_probes`` drives the IVF
        kinds, ``itopk`` the CAGRA beam."""
        q = np.ascontiguousarray(queries, np.float32)
        info = self.info
        if q.ndim != 2 or q.shape[1] != info["dim"]:
            raise ValueError(
                f"queries must be [n_q, {info['dim']}], got {q.shape}")
        n_q = q.shape[0]
        out_d = np.empty((n_q, k), np.float32)
        out_i = np.empty((n_q, k), np.int32)
        kind = info["kind"]
        fn = {"ivf_flat": _lib().rt_ivf_flat_search,
              "ivf_pq": _lib().rt_ivf_pq_search,
              "cagra": _lib().rt_cagra_search}[kind]
        knob = itopk if kind == "cagra" else n_probes
        code = fn(self._h, q.ctypes.data_as(ctypes.c_void_p), n_q, knob, k,
                  out_d.ctypes.data_as(ctypes.c_void_p),
                  out_i.ctypes.data_as(ctypes.c_void_p), n_threads)
        if code != 0:
            raise RuntimeError(_lib().rt_ann_last_error().decode())
        return out_d, out_i

    def save(self, path: str) -> None:
        code = _lib().rt_ann_serialize(self._h, path.encode())
        if code != 0:
            raise RuntimeError(_lib().rt_ann_last_error().decode())

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                _lib().rt_ann_index_destroy(self._h)
            except Exception:
                pass


def eps_neighbors_host(dataset: np.ndarray, queries: np.ndarray,
                       eps: float, *, n_threads: int = 0):
    """Dense epsilon-neighborhood adjacency + degrees on the host C ABI
    (ref: raft_runtime/neighbors/eps_neighborhood.hpp).  ``eps`` is the
    L2 radius (squared internally, matching the reference's eps^2)."""
    x = np.ascontiguousarray(dataset, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    if x.ndim != 2 or q.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"dataset/queries must be 2-D with equal dims, got "
            f"{x.shape} vs {q.shape}")
    n, n_q = x.shape[0], q.shape[0]
    adj = np.empty((n_q, n), np.uint8)
    vd = np.empty(n_q, np.int64)
    code = _lib().rt_eps_neighbors_host(
        x.ctypes.data_as(ctypes.c_void_p), n, x.shape[1],
        q.ctypes.data_as(ctypes.c_void_p), n_q,
        ctypes.c_float(eps * eps),
        adj.ctypes.data_as(ctypes.c_void_p),
        vd.ctypes.data_as(ctypes.c_void_p), n_threads)
    if code != 0:
        raise RuntimeError(_lib().rt_ann_last_error().decode())
    # C writes exactly 0/1 — reinterpret in place, no second dense copy
    return adj.view(bool), vd
