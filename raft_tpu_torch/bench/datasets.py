"""Benchmark datasets: the big-ann and TEXMEX binary readers and writers,
seeded synthetic generators, ground truth (counterpart of
``raft_tpu.bench.datasets``).

Files: ``.fbin`` / ``.u8bin`` / ``.i8bin`` / ``.ibin`` (int32 rows, int32
dim, then the row-major payload) and ``.fvecs`` / ``.ivecs`` / ``.bvecs``
(every row [dim:int32][payload]); ann-benchmarks HDF5 files through
``h5py``, imported when called.  The synthetic generators draw the same
numpy numbers as raft_tpu's, so one seed gives the same rows in both
packages.  Downloads are ``bench.get_dataset``'s alone (its tests serve
local bytes in place of the network).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure
from raft_tpu_torch.neighbors import brute_force

_DTYPES = {"fbin": np.float32, "u8bin": np.uint8, "i8bin": np.int8, "ibin": np.int32}


def write_bin(path: str, arr: np.ndarray) -> None:
    """big-ann writer: [n:int32][dim:int32][payload row-major], in row chunks
    (a memmap input never enters memory whole)."""
    with open(path, "wb") as fh:
        fh.write(np.asarray(arr.shape, np.int32).tobytes())
        chunk = max(1, (1 << 28) // max(1, arr.shape[1] * arr.itemsize))
        for i in range(0, arr.shape[0], chunk):
            fh.write(np.ascontiguousarray(arr[i:i + chunk]).tobytes())


def read_bin(path: str, dtype=None, *, rows: Optional[int] = None,
             mmap: bool = False) -> np.ndarray:
    """A big-ann file: the first ``rows`` rows (all by default); ``mmap``
    returns the mapping itself.  ``dtype`` defaults from the extension."""
    if dtype is None:
        dtype = _DTYPES.get(path.rsplit(".", 1)[-1], np.float32)
    with open(path, "rb") as fh:
        n, dim = (int(x) for x in np.frombuffer(fh.read(8), np.int32))
    if rows is not None:
        n = min(n, int(rows))
    data = np.memmap(path, dtype, mode="r", offset=8, shape=(n, dim))
    return data if mmap else np.asarray(data).copy()


_VECS_DTYPES = {"fvecs": np.float32, "ivecs": np.int32, "bvecs": np.uint8}


def write_vecs(path: str, arr: np.ndarray) -> None:
    """TEXMEX writer: every row [dim:int32][payload]."""
    dtype = _VECS_DTYPES[path.rsplit(".", 1)[-1]]
    arr = np.ascontiguousarray(arr, dtype)
    n, d = arr.shape
    dims = np.full((n, 1), d, np.int32)
    if dtype == np.uint8:
        rows = np.concatenate([dims.view(np.uint8).reshape(n, 4), arr], axis=1)
    else:
        rows = np.concatenate([dims.view(dtype), arr], axis=1)
    with open(path, "wb") as fh:
        fh.write(rows.tobytes())


def read_vecs(path: str) -> np.ndarray:
    dtype = _VECS_DTYPES[path.rsplit(".", 1)[-1]]
    raw = np.fromfile(path, np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype)
    d = int(np.frombuffer(raw[:4].tobytes(), np.int32)[0])
    row_bytes = 4 + d * np.dtype(dtype).itemsize
    if raw.size % row_bytes:
        raise ValueError(f"{path}: size {raw.size} not a multiple of row {row_bytes}")
    rows = raw.reshape(-1, row_bytes)
    return rows[:, 4:].reshape(-1).view(dtype).reshape(rows.shape[0], d).copy()


@dataclass
class Dataset:
    name: str
    base: np.ndarray        # [n, d]
    queries: np.ndarray     # [q, d]
    gt_neighbors: Optional[np.ndarray] = None   # [q, k]
    gt_distances: Optional[np.ndarray] = None
    metric: str = "sqeuclidean"


def load_hdf5(path: str, name: str = "") -> Dataset:
    """An ann-benchmarks HDF5 file (train / test / neighbors / distances);
    needs ``h5py``."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("load_hdf5 needs h5py; convert the file to the big-ann .fbin "
                           "layout (write_bin) where it is installed") from e
    with h5py.File(path, "r") as f:
        dist = f.attrs.get("distance", "euclidean")
        if isinstance(dist, bytes):
            dist = dist.decode()
        metric = {"euclidean": "sqeuclidean", "angular": "cosine"}.get(dist, "sqeuclidean")
        ds = Dataset(name=name or os.path.basename(path), base=np.asarray(f["train"]),
                     queries=np.asarray(f["test"]), metric=metric)
        if "neighbors" in f:
            ds.gt_neighbors = np.asarray(f["neighbors"], np.int32)
        if "distances" in f:
            ds.gt_distances = np.asarray(f["distances"], np.float32)
        return ds


#: (rows, dim, queries, metric) of the million-scale suite
SYNTH_SHAPES = {
    "sift-128-euclidean": (1_000_000, 128, 10_000, "sqeuclidean"),
    "glove-100-inner": (1_183_514, 100, 10_000, "inner_product"),
    "fashion-mnist-784-euclidean": (60_000, 784, 10_000, "sqeuclidean"),
    "nytimes-256-angular": (290_000, 256, 10_000, "cosine"),
    "mnist-784-euclidean": (60_000, 784, 10_000, "sqeuclidean"),
    "deep-image-96-inner": (9_990_000, 96, 10_000, "inner_product"),
}


def synthetic(name: str = "sift-128-euclidean", *, scale: float = 1.0, n_queries: int = 0,
              seed: int = 0, clustered: bool = True) -> Dataset:
    """A seeded stand-in with a standard dataset's geometry; ``scale``
    shrinks the rows (0.01: 1 %)."""
    if name not in SYNTH_SHAPES:
        raise ValueError(f"unknown dataset {name}; have {sorted(SYNTH_SHAPES)}")
    n, d, q, metric = SYNTH_SHAPES[name]
    return synthetic_geometry(name, n, d, metric, scale=scale, n_queries=n_queries,
                              default_queries=q, seed=seed, clustered=clustered)


def synthetic_geometry(name: str, n: int, d: int, metric: str, *, scale: float = 1.0,
                       n_queries: int = 0, default_queries: int = 10_000, seed: int = 0,
                       clustered: bool = True) -> Dataset:
    """Mixture-of-gaussians (``clustered``) or uniform rows and queries of a
    given geometry.  An explicit ``n_queries`` wins; 0 scales
    ``default_queries`` down with small n."""
    n = max(1000, int(n * scale))
    q = n_queries or min(default_queries, max(100, n // 100))
    rng = np.random.default_rng(seed)
    if clustered:
        n_clusters = max(16, int(np.sqrt(n) / 4))
        centers = rng.random((n_clusters, d), dtype=np.float32) * 10
        lab = rng.integers(0, n_clusters, n)
        base = centers[lab] + rng.normal(0, 1.0, (n, d)).astype(np.float32)
        qlab = rng.integers(0, n_clusters, q)
        queries = centers[qlab] + rng.normal(0, 1.0, (q, d)).astype(np.float32)
    else:
        base = rng.random((n, d), dtype=np.float32)
        queries = rng.random((q, d), dtype=np.float32)
    return Dataset(name=name, base=base, queries=queries, metric=metric)


#: bytes of f32 base rows a ground-truth pass holds on the device at once
_GT_BASE_CHUNK_BYTES = 1 << 30


def generate_groundtruth(ds: Dataset, k: int = 100, *, batch: int = 2048,
                         res: Optional[Resources] = None) -> Dataset:
    """Exact ground truth by ``brute_force.knn`` (kernel #2 on the card).  A
    base past ~1 GiB of f32 (or a memmap) streams through the device in row
    chunks with a host top-k merge."""
    res = ensure(res)
    dev = res.device
    f32_bytes = ds.base.shape[0] * ds.base.shape[1] * 4
    if f32_bytes <= _GT_BASE_CHUNK_BYTES and not isinstance(ds.base, np.memmap):
        base = torch.from_numpy(np.ascontiguousarray(ds.base)).to(dev)
        dists, ids = [], []
        for s in range(0, ds.queries.shape[0], batch):
            v, i = brute_force.knn(base, torch.from_numpy(ds.queries[s:s + batch]).to(dev), k,
                                   metric=ds.metric, res=res)
            dists.append(v.cpu().numpy())
            ids.append(i.cpu().numpy())
        ds.gt_distances = np.concatenate(dists)
        ds.gt_neighbors = np.concatenate(ids)
        return ds
    n, d = ds.base.shape
    rows = max(k, _GT_BASE_CHUNK_BYTES // (d * 4))
    largest = ds.metric == "inner_product"
    best_v = np.full((ds.queries.shape[0], k), -np.inf if largest else np.inf, np.float32)
    best_i = np.full((ds.queries.shape[0], k), -1, np.int64)
    for cs in range(0, n, rows):
        chunk = torch.from_numpy(np.ascontiguousarray(ds.base[cs:cs + rows],
                                                      dtype=np.float32)).to(dev)
        kk = min(k, int(chunk.shape[0]))
        for s in range(0, ds.queries.shape[0], batch):
            qs = torch.from_numpy(np.ascontiguousarray(ds.queries[s:s + batch],
                                                       dtype=np.float32)).to(dev)
            v, i = brute_force.knn(chunk, qs, kk, metric=ds.metric, res=res)
            cand_v = np.concatenate([best_v[s:s + batch], v.cpu().numpy()], 1)
            cand_i = np.concatenate([best_i[s:s + batch],
                                     i.cpu().numpy().astype(np.int64) + cs], 1)
            key = -cand_v if largest else cand_v
            part = np.argpartition(key, k - 1, axis=1)[:, :k]
            order = np.argsort(np.take_along_axis(key, part, 1), 1)
            top = np.take_along_axis(part, order, 1)
            best_v[s:s + batch] = np.take_along_axis(cand_v, top, 1)
            best_i[s:s + batch] = np.take_along_axis(cand_i, top, 1)
    ds.gt_distances = best_v
    ds.gt_neighbors = best_i.astype(np.int32)
    return ds


#: the big-ann extension of each storable vector dtype
_EXTS = {np.dtype(np.float32): "fbin", np.dtype(np.uint8): "u8bin", np.dtype(np.int8): "i8bin"}


def save(ds: Dataset, directory: str) -> None:
    """The big-ann layout (base.fbin / query.fbin /
    groundtruth.neighbors.ibin / groundtruth.distances.fbin); uint8 / int8
    bases keep their dtype and extension."""
    os.makedirs(directory, exist_ok=True)
    for stem, arr in (("base", ds.base), ("query", ds.queries)):
        ext = _EXTS.get(np.dtype(arr.dtype))
        if ext is None:
            arr, ext = np.asarray(arr, np.float32), "fbin"
        write_bin(os.path.join(directory, f"{stem}.{ext}"), arr)
    if ds.gt_neighbors is not None:
        write_bin(os.path.join(directory, "groundtruth.neighbors.ibin"),
                  ds.gt_neighbors.astype(np.int32))
        write_bin(os.path.join(directory, "groundtruth.distances.fbin"),
                  ds.gt_distances.astype(np.float32))


def load(directory: str, name: str = "", metric: str = "sqeuclidean", *,
         mmap: bool = False) -> Dataset:
    """A dataset directory in the big-ann layout (base.{fbin,u8bin,i8bin},
    query.*, groundtruth.*) or the TEXMEX one (<name>_base.fvecs, _query,
    _groundtruth.ivecs); ``mmap`` leaves the base on disk."""
    base_path = next((p for e in ("fbin", "u8bin", "i8bin")
                      if os.path.exists(p := os.path.join(directory, f"base.{e}"))), None)
    if base_path is None:
        bases = sorted(glob.glob(os.path.join(directory, "*_base.*vecs")))
        if bases:
            prefix = bases[0].rsplit("_base.", 1)[0]
            ext = bases[0].rsplit(".", 1)[-1]
            ds = Dataset(name=name or os.path.basename(prefix),
                         base=read_vecs(f"{prefix}_base.{ext}"),
                         queries=read_vecs(f"{prefix}_query.{ext}"), metric=metric)
            gt = f"{prefix}_groundtruth.ivecs"
            if os.path.exists(gt):
                ds.gt_neighbors = read_vecs(gt).astype(np.int32)
            return ds
        raise FileNotFoundError(f"no base.{{fbin,u8bin,i8bin}} in {directory}")
    ext = base_path.rsplit(".", 1)[-1]
    ds = Dataset(name=name or os.path.basename(directory.rstrip("/")),
                 base=read_bin(base_path, mmap=mmap),
                 queries=read_bin(os.path.join(directory, f"query.{ext}")), metric=metric)
    gtn = os.path.join(directory, "groundtruth.neighbors.ibin")
    if os.path.exists(gtn):
        ds.gt_neighbors = read_bin(gtn, np.int32)
        ds.gt_distances = read_bin(os.path.join(directory, "groundtruth.distances.fbin"),
                                   np.float32)
    return ds
