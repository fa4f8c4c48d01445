"""hnswlib interop (counterpart of ``raft_tpu.neighbors.hnsw``): export a
CAGRA index in hnswlib's binary layout, parse such a file back into a CAGRA
index, and search it on the CAGRA walk.

The layout is raft's ``serialize_to_hnswlib``, field for field,
little-endian: a header of ``size_t`` / ``int32`` fields, then per element
``[link_count:uint16, flags:uint16, links:uint32 x deg, vector:f32 x dim,
label:size_t]``, then each element's upper-level link lists.  As raft_tpu
does, the export builds real upper HNSW layers (:func:`_build_hierarchy`:
geometric levels from numpy's generator, each level a kNN graph of its
members by ``brute_force.knn``, the fused kNN kernel on the card), so a
single-entry hierarchical searcher (stock hnswlib) navigates the file;
``hierarchy=False`` writes raft's level-0-only layout.  The bytes are
raft_tpu's for the same index and seed.

:func:`load` keeps what hnswlib's search takes from the upper levels:
hnswlib descends them greedily to an entry point of the base layer, and the
port gives the loaded CAGRA index an entry-point table of every element on
level 1 or above, so :func:`search` (``cagra.search`` with ``itopk_size =
max(ef, k)``, the walk kernel on the card) seeds each query's walk with its
nearest upper-level elements.  raft_tpu's ``load`` drops the upper levels
and seeds with random rows only, which on clustered data leaves most of a
large file's queries in the wrong cluster (recall@10 0.39 at ef 64 over 1M
clustered rows on an NVIDIA H100, PERF.md).  A file without upper levels loads without the table,
as in raft_tpu.  :func:`load_native` loads a file into the native C++
engine (``core.native``), a host search off the card.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources, ensure, to_numpy
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import brute_force, cagra


def _build_hierarchy(data: np.ndarray, max_m: int, seed: int, metric: str = "sqeuclidean",
                     res: Optional[Resources] = None):
    """Geometric level assignment (P(level >= l) = M^-l, capped near
    log_M n) and each upper level's links: the ``max_m`` nearest members of
    every member under the index metric, its own id dropped.  Returns
    (levels [n] int64, {level: (member_ids, links [m, <= max_m] uint32)})."""
    n = data.shape[0]
    mult = 1.0 / np.log(max(max_m, 2))
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    levels = np.floor(-np.log(np.maximum(u, 1e-300)) * mult).astype(np.int64)
    cap = max(1, int(np.log(max(n, 2)) * mult) + 1)
    levels = np.minimum(levels, cap)
    upper = {}
    for lvl in range(1, int(levels.max()) + 1):
        members = np.flatnonzero(levels >= lvl)
        k_l = min(max_m, len(members) - 1)
        if k_l <= 0:
            upper[lvl] = (members, np.zeros((len(members), 0), np.uint32))
            continue
        sub = data[members]
        _, nb = brute_force.knn(sub, sub, k_l + 1, metric=metric, res=res)
        nb = to_numpy(nb).astype(np.int64)
        # drop self (usually rank 0): self slots sorted last, the first k_l kept
        is_self = nb == np.arange(len(members))[:, None]
        order = np.argsort(is_self, axis=1, kind="stable")
        keep = np.take_along_axis(nb, order, 1)[:, :k_l]
        upper[lvl] = (members, members[keep].astype(np.uint32))
    return levels, upper


def _as_deleted_bools(deleted, n: int) -> Optional[np.ndarray]:
    """A tombstone spec (Bitset, bool mask or id list) as a [n] bool array."""
    if deleted is None:
        return None
    if isinstance(deleted, Bitset):
        if deleted.n_bits < n:
            raise ValueError(f"tombstone mask covers {deleted.n_bits} ids, index has {n}")
        words = deleted.words.cpu().numpy().view(np.uint32)
        return np.unpackbits(words.view(np.uint8), bitorder="little")[:n].astype(bool)
    deleted = np.asarray(deleted)
    if deleted.dtype == bool:
        if deleted.shape != (n,):
            raise ValueError(f"bool mask shape {deleted.shape} != ({n},)")
        return deleted
    out = np.zeros(n, bool)
    out[deleted.astype(np.int64)] = True
    return out


def _rows(index: "cagra.Index") -> np.ndarray:
    ds = index.dataset
    if not isinstance(ds, torch.Tensor):   # a VPQ dataset: its decoded rows
        ds = ds.decode(torch.arange(ds.shape[0], device=ds.device))
    return to_numpy(ds.to(torch.float32))


@traced("hnsw.serialize_to_hnswlib")
def serialize_to_hnswlib(filename: str, index: "cagra.Index", *, hierarchy: bool = True,
                         seed: int = 0, deleted=None, res: Optional[Resources] = None) -> None:
    """Write a CAGRA index as an hnswlib index file (see the module
    docstring).  ``deleted`` (a Bitset with set bit = deleted, a [n] bool
    mask, or an id list) sets hnswlib's delete flag (bit 0x01 of the flags
    half of the link-count field).  The upper levels' kNN runs on ``res``'s
    device."""
    data = _rows(index)
    graph = to_numpy(index.graph).astype(np.uint32)
    n, dim = data.shape
    del_bools = _as_deleted_bools(deleted, n)
    deg = graph.shape[1]
    max_m = deg // 2
    if hierarchy:
        levels, upper = _build_hierarchy(data, max_m, seed, metric=index.metric,
                                         res=ensure(res))
        max_level = int(levels.max())
        entrypoint = int(np.argmax(levels))
    else:
        levels = np.zeros(n, np.int64)
        upper = {}
        max_level = 1
        entrypoint = n // 2
    size_per = deg * 4 + 4 + dim * 4 + 8
    per_level = 4 + max_m * 4  # [u32 count][max_M links] per upper level
    # level 0: one fixed-size block per element
    block = np.zeros((n, size_per), np.uint8)
    head = np.zeros((n, 2), np.uint16)
    head[:, 0] = deg
    if del_bools is not None:
        head[:, 1] = del_bools.astype(np.uint16)
    block[:, 0:4] = head.view(np.uint8)
    block[:, 4:4 + deg * 4] = np.ascontiguousarray(graph).view(np.uint8)
    off = 4 + deg * 4
    block[:, off:off + dim * 4] = np.ascontiguousarray(data, np.float32).view(np.uint8)
    block[:, off + dim * 4:] = np.arange(n, dtype="<u8")[:, None].view(np.uint8)
    with open(filename, "wb") as fh:
        fh.write(struct.pack("<6Q", 0, n, n, size_per, size_per - 8, deg * 4 + 4))
        fh.write(struct.pack("<2i", max_level, entrypoint))
        fh.write(struct.pack("<3Q", max_m, deg, max_m))
        fh.write(struct.pack("<d", 1.0 / np.log(max(max_m, 2))))
        fh.write(struct.pack("<Q", 500))                      # ef_construction
        fh.write(block.tobytes())
        if not hierarchy:
            fh.write(np.zeros(n, np.int32).tobytes())
            return
        # per element: u32 byte count, then one [u32 count][max_M links,
        # zero padded] block per upper level it reaches
        sizes = 4 + levels * (per_level // 4) * 4
        out = np.zeros(int(sizes.sum()) // 4, "<u4")
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) // 4
        out[starts] = levels * per_level
        for lvl, (mem, links) in upper.items():
            pos = starts[mem] + 1 + (lvl - 1) * (per_level // 4)
            out[pos] = links.shape[1]
            for j in range(links.shape[1]):
                out[pos + 1 + j] = links[:, j]
        fh.write(out.tobytes())


def _upper_elements(section: bytes, n: int) -> np.ndarray:
    """Sorted positions of the elements that reach level 1 or above: each
    element's record in the upper-level section is a uint32 byte count
    (0 for a base-layer-only element) followed by that many bytes."""
    view = memoryview(section)
    out = []
    off = 0
    for i in range(n):
        size = int.from_bytes(view[off:off + 4], "little")
        if size:
            out.append(i)
        off += 4 + size
    return np.asarray(out, np.int64)


@traced("hnsw.load")
def load(filename: str, dim: int, *, metric: str = "sqeuclidean", return_deleted: bool = False,
         res: Optional[Resources] = None):
    """Parse an hnswlib file's base layer into a CAGRA index on ``res``'s
    device, rows ordered by their stored labels (returned ids are labels,
    as hnswlib's ``knn_query`` gives), unused link slots pointing at the
    element itself, and the elements of the upper levels as its entry-point
    table (see the module docstring).  With ``return_deleted`` returns
    ``(index, Bitset)`` of the delete flags (set bit = deleted)."""
    with open(filename, "rb") as fh:
        (_, _max_el, n, size_per, label_off, offset_data) = struct.unpack("<6Q", fh.read(48))
        _max_level, _entry = struct.unpack("<2i", fh.read(8))
        _max_m, _max_m0, _m = struct.unpack("<3Q", fh.read(24))
        fh.read(16)   # mult (double), ef_construction (size_t)
        level0 = np.frombuffer(fh.read(n * size_per), np.uint8).reshape(n, size_per)
        upper = fh.read()
    deg = (offset_data - 4) // 4
    if label_off != size_per - 8 or offset_data + dim * 4 != label_off:
        raise ValueError(f"file geometry inconsistent with dim={dim}: "
                         f"size_per={size_per}, offset_data={offset_data}")
    # the 4-byte field is a uint16 link count and uint16 flags (0x01: deleted)
    counts = level0[:, 0:2].copy().view(np.uint16)[:, 0].astype(np.int64)
    deleted = (level0[:, 2:4].copy().view(np.uint16)[:, 0] & 1).astype(bool)
    links = level0[:, 4:4 + deg * 4].copy().view(np.uint32).reshape(n, deg)
    data = level0[:, offset_data:offset_data + dim * 4].copy().view(np.float32).reshape(n, dim)
    labels = level0[:, label_off:].copy().view(np.uint64)[:, 0].astype(np.int64)
    slot = np.arange(deg)[None, :]
    links = np.where(slot < counts[:, None], links, np.arange(n, dtype=np.uint32)[:, None])
    order = np.argsort(labels)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    data = data[order]
    links = inv[links.astype(np.int64)][order].astype(np.int32)
    entries = inv[_upper_elements(upper, n)]
    index = cagra.from_graph(metric, data, links,
                             data[entries] if entries.size else None,
                             entries.astype(np.int32) if entries.size else None, res=res)
    if return_deleted:
        return index, Bitset.from_mask(torch.from_numpy(deleted[order]).to(index.graph.device))
    return index


@traced("hnsw.search")
def search(index: "cagra.Index", queries, k: int, *, ef: int = 64, sample_filter=None,
           deleted_mask=None, res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an hnsw-loaded (or any CAGRA) index: ``cagra.search`` with
    ``itopk_size = max(ef, k)``; ``deleted_mask`` (set bit = skip) as the
    one :func:`load` recovers from a file's delete flags."""
    params = cagra.SearchParams(itopk_size=max(ef, k))
    return cagra.search(params, index, queries, k, sample_filter=sample_filter,
                        deleted_mask=deleted_mask, res=res)


def load_native(filename: str, dim: int):
    """Load an hnswlib index file into the native C++ engine
    (``core.native``, ``cpp/src/hnsw.cc``: an independent parser and a
    hierarchical HNSW search on the host).  Returns a handle with
    ``.search(queries, k, ef=, metric=)`` → (distances, labels) numpy, and
    ``.info`` / ``.element(i)``.  Raises RuntimeError where the native
    core is unavailable or the file disagrees with ``dim``."""
    from raft_tpu_torch.core import native

    if not native.available():
        raise RuntimeError("native core unavailable (no C++ compiler?)")
    return native.HnswNativeIndex(filename, dim)
