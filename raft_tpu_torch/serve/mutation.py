"""Streaming mutation for served indexes (counterpart of
``raft_tpu.serve.mutation``): upsert + tombstone delete.

* **delete(ids)** sets bits in a host tombstone mask over the main index's
  rows, packed into a ``Bitset`` that every backend search takes as its
  ``deleted_mask``: a tombstoned row is filtered inside the main search
  (id -1 at the worst distance), visible at once, with the built
  structure untouched.
* **upsert(vectors)** appends to a host side buffer.  Queries scan the side
  buffer by brute force (``brute_force.knn``, kernel #2 on the card) and
  the two candidate lists merge through one ``ops.matrix.select_k``
  (kernel #1).  Upserting an existing id tombstones the old row first, so
  an id never yields two results.

The side buffer grows in powers of two (occupancy kept on the host, dead
slots masked by the same kind of filter), as raft_tpu's does.  Mutations
and snapshot-taking hold one lock; a search runs on an immutable snapshot
rebuilt at mutation time, on the index's device, so a search never sees a
half-applied mutation and a hot-swap never tears a batch.

The index lives on one device (its tensors' device): searches run there
(``Resources(device=...)``), so an index built on the CPU is served on the
CPU and one built on the card is served on the card.  :meth:`save` /
:meth:`load` read and write raft_tpu's files (``serve_mutable`` version 1
plus the main index at ``path + ".main"``), pagination included.
"""

from __future__ import annotations

import importlib
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset, RowFilter
from raft_tpu_torch.core.resources import Resources, as_f32
from raft_tpu_torch.core.trace import trace_range, traced
from raft_tpu_torch.distance import DISTANCE_TYPES
from raft_tpu_torch.ops.matrix import mask_row_k, select_k

KINDS = ("brute_force", "ivf_flat", "ivf_pq", "cagra")

_SERVE_SERIALIZATION_VERSION = 1

_MIN_SIDE_CAP = 8


def _next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _kind_module(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown index kind {kind!r}; expected one of {KINDS}")
    return importlib.import_module(f"raft_tpu_torch.neighbors.{kind}")


def _infer_kind(index) -> str:
    mod = type(index).__module__.rsplit(".", 1)[-1]
    if mod not in KINDS:
        raise ValueError(
            f"cannot infer index kind from {type(index)!r}; pass kind="
        )
    return mod


def _index_device(index) -> torch.device:
    """The device a built index's tensors live on."""
    for attr in ("centers", "graph", "dataset"):
        t = getattr(index, attr, None)
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError(f"cannot tell the device of {type(index)!r}")


def _bitset_from_np(mask: np.ndarray, device: torch.device) -> Bitset:
    """Pack a host bool mask into a Bitset with numpy packing."""
    n = mask.shape[0]
    nw = (n + 31) // 32
    padded = np.zeros(nw * 32, np.uint8)
    padded[:n] = mask
    words = np.packbits(padded, bitorder="little").view(np.uint32)
    return Bitset.from_numpy(words, n, device=device)


_tls = threading.local()


def consume_pins():
    """The ``(index, snapshot)`` pairs that searches on this thread read
    while a CUDA stream other than the default one was current, since the
    last call (None if none).  The batcher keeps them with the in-flight
    batch until its completion event: the kernels queued on its stream
    read those tensors, and a swap or mutation that dropped the last other
    reference would otherwise hand their memory back to the default
    stream's pool while the batch still reads it."""
    pins = getattr(_tls, "pins", None)
    _tls.pins = None
    return pins


def _pin(index: "MutableIndex", snap: "_Snapshot") -> None:
    if index.device.type != "cuda":
        return
    if torch.cuda.current_stream(index.device) == torch.cuda.default_stream(index.device):
        return
    pins = getattr(_tls, "pins", None)
    if pins is None:
        _tls.pins = pins = []
    pins.append((index, snap))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    nb = getattr(x, "nbytes", None)
    return int(nb) if isinstance(nb, (int, np.integer)) else 0


def _host_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclass(frozen=True)
class _Snapshot:
    """Immutable view a search runs against (see the module docstring)."""

    tombstones: Optional[Bitset]          # over main rows, None when no deletes
    side_data: Optional[torch.Tensor]     # [cap, dim] padded, None when empty
    side_ids: Optional[torch.Tensor]      # [cap] int32 global ids (-1 on dead slots)
    side_live: Optional[Bitset]           # pass-filter over side slots
    generation: int
    main_ids: Optional[torch.Tensor] = None  # row → global id, None = identity


class MutableIndex:
    """A served index: main (built) structure + tombstones + side buffer.

    ``index`` is a built ``brute_force`` / ``ivf_flat`` / ``ivf_pq`` /
    ``cagra`` index whose rows carry ids ``0..index.size-1``; ``kind`` is
    inferred from its type when omitted; ``search_params`` are the main
    search's (the backend's defaults when omitted; none for brute force).
    ``main_ids`` (``[index.size]`` ints) maps main row i to its global id —
    a compacted shadow packs survivors densely but keeps serving the
    original ids; tombstones stay row-indexed.  ``None`` means identity.
    """

    def __init__(self, index, *, kind: Optional[str] = None, search_params=None,
                 main_ids: Optional[np.ndarray] = None):
        self.kind = kind if kind is not None else _infer_kind(index)
        mod = _kind_module(self.kind)  # validates kind
        self.index = index
        self.metric = index.metric
        self.dim = int(index.dim)
        self.main_size = int(index.size)
        self.device = _index_device(index)
        self._res = Resources(device=self.device)
        if search_params is None and self.kind != "brute_force":
            search_params = mod.SearchParams()
        self.search_params = search_params

        if main_ids is not None:
            main_ids = np.asarray(main_ids, dtype=np.int64).reshape(-1)
            if main_ids.shape[0] != self.main_size:
                raise ValueError(
                    f"main_ids has {main_ids.shape[0]} entries for "
                    f"{self.main_size} main rows"
                )
            if np.array_equal(main_ids, np.arange(self.main_size)):
                main_ids = None  # identity: keep the remap off the search

        self._lock = threading.Lock()
        # row → global id map; immutable like the main structure, so its
        # device copy is made once here
        self._main_ids = main_ids
        self._main_ids_dev = (
            torch.from_numpy(main_ids.astype(np.int32)).to(self.device)
            if main_ids is not None else None
        )
        # main-row tombstones, host side; packed into a Bitset per snapshot
        self._deleted = np.zeros((self.main_size,), dtype=bool)
        self._n_deleted = 0
        # rows tombstoned at construction (compaction padding sentinels):
        # filter state, not mutation backlog
        self._n_structural = 0
        # side buffer, host-side source of truth
        self._side_data = np.zeros((0, self.dim), dtype=np.float32)
        self._side_ids = np.zeros((0,), dtype=np.int64)
        self._side_live = np.zeros((0,), dtype=bool)
        self._side_count = 0          # occupied slots (live or dead)
        self._next_id = (
            self.main_size if main_ids is None
            else (int(main_ids.max()) + 1 if main_ids.size else 0)
        )
        self._generation = 0
        # monotonic stamp of when the mutation backlog last became
        # non-empty; None while empty (the freshness signal)
        self._backlog_since: Optional[float] = None
        # set by a compaction promote: later mutations forward here
        self._retired_to: Optional["MutableIndex"] = None
        self._snapshot_cache: Optional[_Snapshot] = None
        self._refresh_snapshot_locked()

    # -- introspection -------------------------------------------------------
    @property
    def size(self) -> int:
        """Live vectors (main minus tombstones, plus live side rows)."""
        with self._lock:
            return self.main_size - self._n_deleted + int(self._side_live.sum())

    @property
    def generation(self) -> int:
        """Monotonic mutation counter (bumps on every upsert/delete)."""
        with self._lock:
            return self._generation

    def device_bytes(self) -> int:
        """Bytes held by this index's arrays (main structure + serve
        state); feeds ``obs.cost.refresh_live_buffer_gauges``."""
        total = sum(_nbytes(v) for v in vars(self.index).values())
        total += _nbytes(self._main_ids) + _nbytes(self._main_ids_dev)
        with self._lock:
            total += _nbytes(self._side_data) + _nbytes(self._side_ids)
            total += _nbytes(self._side_live) + _nbytes(self._deleted)
            snap = self._snapshot_cache
        if snap is not None:
            for arr in (snap.side_data, snap.side_ids):
                total += _nbytes(arr)
            for bs in (snap.tombstones, snap.side_live):
                if bs is not None:
                    total += _nbytes(bs.words)
        return total

    def contains(self, id_: int) -> bool:
        with self._lock:
            if self._retired_to is not None:
                succ = self._retired_to
            else:
                if self._main_ids is None:
                    if 0 <= id_ < self.main_size and not self._deleted[id_]:
                        return True
                else:
                    rows = np.flatnonzero(self._main_ids == id_)
                    if rows.size and not self._deleted[rows[0]]:
                        return True
                hits = (self._side_ids == id_) & self._side_live
                return bool(hits.any())
        return succ.contains(id_)

    # -- mutation ------------------------------------------------------------
    @traced("serve.upsert")
    def upsert(self, vectors, ids=None) -> np.ndarray:
        """Insert (or replace) vectors; returns their global ids.  Without
        ``ids`` fresh ids are allocated past the main index's range; with
        ``ids`` any live row under the same id is tombstoned first."""
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.to(torch.float32).cpu().numpy()
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"expected vectors of dim {self.dim}, got {vectors.shape}"
            )
        m = vectors.shape[0]
        with self._lock:
            if self._retired_to is not None:
                succ = self._retired_to
            else:
                if ids is None:
                    ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
                    self._next_id += m
                else:
                    ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
                    if ids.shape != (m,):
                        raise ValueError(
                            f"ids shape {ids.shape} does not match {m} vectors"
                        )
                    self._delete_locked(ids)
                    self._next_id = max(self._next_id, int(ids.max()) + 1)
                self._reserve_locked(self._side_count + m)
                sl = slice(self._side_count, self._side_count + m)
                self._side_data[sl] = vectors
                self._side_ids[sl] = ids
                self._side_live[sl] = True
                self._side_count += m
                self._bump_locked()
                return ids
        return succ.upsert(vectors, ids)

    @traced("serve.delete")
    def delete(self, ids) -> int:
        """Tombstone ids (main or side); returns how many were live."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        with self._lock:
            if self._retired_to is None:
                n = self._delete_locked(ids)
                self._bump_locked()
                return n
            succ = self._retired_to
        return succ.delete(ids)

    def _delete_locked(self, ids: np.ndarray) -> int:
        n_removed = 0
        if self._main_ids is None:
            rows = ids[(ids >= 0) & (ids < self.main_size)]
        else:
            rows = np.flatnonzero(np.isin(self._main_ids, ids))
        if rows.size:
            was_live = ~self._deleted[rows]
            n_removed += int(np.unique(rows[was_live]).size)
            self._deleted[rows] = True
            self._n_deleted = int(self._deleted.sum())
        if self._side_count:
            hits = np.isin(self._side_ids, ids) & self._side_live
            n_removed += int(hits.sum())
            self._side_live[hits] = False
        return n_removed

    def _reserve_locked(self, n: int) -> None:
        cap = self._side_data.shape[0]
        if n <= cap:
            return
        new_cap = max(_MIN_SIDE_CAP, _next_pow2(n))
        grown = np.zeros((new_cap, self.dim), dtype=np.float32)
        grown[:cap] = self._side_data
        self._side_data = grown
        ids = np.full((new_cap,), -1, dtype=np.int64)
        ids[:cap] = self._side_ids
        self._side_ids = ids
        live = np.zeros((new_cap,), dtype=bool)
        live[:cap] = self._side_live
        self._side_live = live

    def _bump_locked(self) -> None:
        self._generation += 1
        deletes = self._n_deleted - self._n_structural
        side = int(self._side_live.sum()) if self._side_count else 0
        if deletes <= 0 and side <= 0:
            self._backlog_since = None
        elif self._backlog_since is None:
            self._backlog_since = time.monotonic()
        self._refresh_snapshot_locked()

    def _refresh_snapshot_locked(self) -> None:
        """Rebuild the search snapshot now, at mutation time: the device
        copies are made once per mutation, never per search."""
        dev = self.device
        tomb = _bitset_from_np(self._deleted, dev) if self._n_deleted else None
        if self._side_count:
            side_data = torch.from_numpy(self._side_data.copy()).to(dev)
            side_ids = torch.from_numpy(
                np.where(self._side_live, self._side_ids, -1).astype(np.int32)
            ).to(dev)
            side_live = _bitset_from_np(self._side_live, dev)
        else:
            side_data = side_ids = side_live = None
        self._snapshot_cache = _Snapshot(
            tomb, side_data, side_ids, side_live, self._generation,
            self._main_ids_dev,
        )

    # -- search --------------------------------------------------------------
    def _snapshot(self) -> _Snapshot:
        with self._lock:
            return self._snapshot_cache

    def _main_search(self, queries, k, tombstones, sample_filter=None,
                     search_params=None):
        mod = _kind_module(self.kind)
        if self.kind == "brute_force":
            return mod.search(
                self.index, queries, k,
                deleted_mask=tombstones, sample_filter=sample_filter, res=self._res,
            )
        params = self.search_params if search_params is None else search_params
        return mod.search(
            params, self.index, queries, k,
            deleted_mask=tombstones, sample_filter=sample_filter, res=self._res,
        )

    @staticmethod
    def _filter_bits(sample_filter, gids: torch.Tensor, covered: torch.Tensor):
        """Each id of ``gids``'s bit of ``sample_filter`` ([rows, n] for a
        RowFilter, [n] for a Bitset); ids outside ``covered`` pass."""
        g = gids.clamp(min=0).to(torch.int64)
        words = sample_filter.words
        word_ix = (g // 32).clamp(max=words.shape[-1] - 1)
        bit_ix = (g % 32).to(torch.int32)
        if isinstance(sample_filter, RowFilter):
            bit = (words[:, word_ix] >> bit_ix[None, :]) & 1
            return torch.where(covered[None, :], bit == 1, torch.ones_like(bit, dtype=torch.bool))
        bit = (words[word_ix] >> bit_ix) & 1
        return torch.where(covered, bit == 1, torch.ones_like(bit, dtype=torch.bool))

    def _side_passes(self, snap: _Snapshot, sample_filter):
        """Slot-space view of ``sample_filter`` for the side-buffer scan:
        each slot's bit through ``side_ids``, AND slot liveness.  Ids past
        the filter's bit range pass (upserted rows get ids past any
        pre-registered filter's range)."""
        if sample_filter is None:
            return snap.side_live
        live = snap.side_live.to_mask()
        in_range = snap.side_ids < sample_filter.n_bits
        mask = self._filter_bits(sample_filter, snap.side_ids, in_range)
        if isinstance(sample_filter, RowFilter):
            return RowFilter.from_mask_rows(mask & live[None, :])
        return Bitset.from_mask(mask & live)

    def _main_filter_rows(self, snap: _Snapshot, sample_filter):
        """Row-space view of ``sample_filter`` for a compacted main index:
        each stored row's bit through the compaction id map (padding
        sentinels, gid -1, pass here but are structural tombstones)."""
        gids = snap.main_ids
        covered = (gids >= 0) & (gids < sample_filter.n_bits)
        mask = self._filter_bits(sample_filter, gids, covered)
        if isinstance(sample_filter, RowFilter):
            return RowFilter.from_mask_rows(mask)
        return Bitset.from_mask(mask)

    def search(self, queries, k: int, *, sample_filter=None,
               row_k=None, search_params=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merged top-k over main (tombstone-filtered) + side buffer:
        (distances [q, k], ids [q, k]) on the index's device; pruned /
        padding slots are id -1 at the worst distance.

        ``sample_filter`` (a ``Bitset``, or a ``RowFilter`` with one row per
        query) restricts results by global id: it composes with tombstones
        inside the main search and is remapped to slot space for the side
        scan (and to row space on a compacted index).  ``row_k`` ([q] ints)
        caps each row below ``k`` (:func:`ops.matrix.mask_row_k`).
        ``search_params`` overrides the index's own for this call (the
        degraded-mode ladder's hook)."""
        queries = as_f32(queries, self.device)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(
                f"queries shape {tuple(queries.shape)} vs index dim {self.dim}"
            )
        snap = self._snapshot()
        _pin(self, snap)
        main_filter = sample_filter
        if sample_filter is not None and snap.main_ids is not None:
            main_filter = self._main_filter_rows(snap, sample_filter)
        select_min = DISTANCE_TYPES[self.metric] != "inner_product"
        with trace_range("serve.mutable_search"):
            dist, ids = self._main_search(
                queries, k, snap.tombstones, main_filter, search_params
            )
            if snap.main_ids is not None:
                # compacted index: dense row ids → global ids (-1 stays -1)
                ids = torch.where(ids >= 0, snap.main_ids[ids.clamp(min=0).long()],
                                  torch.full_like(ids, -1))
            if snap.side_data is None:
                if row_k is not None:
                    dist, ids = mask_row_k(dist, ids, row_k, select_min=select_min)
                return dist, ids
            from raft_tpu_torch.neighbors import brute_force

            cap = snap.side_data.shape[0]
            k_side = min(k, cap)
            s_dist, s_slot = brute_force.knn(
                snap.side_data, queries, k_side, metric=self.metric,
                sample_filter=self._side_passes(snap, sample_filter), res=self._res,
            )
            # slot → global id (-1 stays -1)
            s_ids = torch.where(s_slot >= 0, snap.side_ids[s_slot.clamp(min=0).long()],
                                torch.full_like(s_slot, -1))
            return select_k(
                torch.cat([dist, s_dist], dim=1), k, select_min=select_min,
                input_indices=torch.cat([ids.to(torch.int32), s_ids.to(torch.int32)], dim=1),
                row_k=row_k,
            )

    # -- maintenance ---------------------------------------------------------
    def pending_mutations(self) -> Tuple[int, int]:
        """(tombstoned main rows, live side rows) — rebuild pressure;
        compaction padding sentinels excluded."""
        with self._lock:
            return self._n_deleted - self._n_structural, int(self._side_live.sum())

    def backlog_age_s(self) -> float:
        """Seconds since the mutation backlog last became non-empty (0.0
        while it is empty)."""
        with self._lock:
            deletes = self._n_deleted - self._n_structural
            side = int(self._side_live.sum()) if self._side_count else 0
            if deletes <= 0 and side <= 0:
                self._backlog_since = None
                return 0.0
            if self._backlog_since is None:
                self._backlog_since = time.monotonic()
            return time.monotonic() - self._backlog_since

    def live_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(vectors, ids) of every live row, as host arrays."""
        with self._lock:
            keep = ~self._deleted
            main_rows = self._main_dataset()[keep]
            if self._main_ids is None:
                main_ids = np.nonzero(keep)[0].astype(np.int64)
            else:
                main_ids = self._main_ids[keep]
            side_rows = self._side_data[self._side_live]
            side_ids = self._side_ids[self._side_live]
        return (
            np.concatenate([main_rows, side_rows], axis=0),
            np.concatenate([main_ids, side_ids], axis=0),
        )

    def iter_main_rows(self, chunk_rows: int = 65536):
        """Yield ``(row_indices, rows)`` host chunks of the main dataset
        (f32, at most about ``chunk_rows`` rows a step): what a compaction
        rebuild decodes instead of the whole structure at once."""
        chunk_rows = max(1, int(chunk_rows))
        if self.kind in ("brute_force", "cagra"):
            data = self.index.dataset
            for a in range(0, self.main_size, chunk_rows):
                b = min(a + chunk_rows, self.main_size)
                yield np.arange(a, b, dtype=np.int64), _host_f32(data[a:b])
            return
        # IVF kinds: rows lie scattered over padded lists; chunk by lists
        list_index = _host(self.index.list_index)
        n_lists, cap = list_index.shape
        lists_per = max(1, chunk_rows // max(cap, 1))
        if self.kind == "ivf_pq":
            rot = _host_f32(self.index.rotation)
            scale = float(self.index.scan_scale)
        for l0 in range(0, n_lists, lists_per):
            l1 = min(l0 + lists_per, n_lists)
            idx = list_index[l0:l1]
            valid = idx >= 0
            if not valid.any():
                continue
            rows = _host_f32(self.index.list_data[l0:l1])[valid]
            if self.kind == "ivf_pq":
                # decoded reconstructions live in rotated space
                rows = (rows * scale) @ rot
            yield idx[valid].astype(np.int64), rows

    def _main_dataset(self) -> np.ndarray:
        """The main rows in id order (f32 host array)."""
        if self.kind in ("brute_force", "cagra"):
            return _host_f32(self.index.dataset)
        out = np.zeros((self.main_size, self.dim), dtype=np.float32)
        data = _host_f32(self.index.list_data)
        idx = _host(self.index.list_index)
        valid = idx >= 0
        if self.kind == "ivf_pq":
            rot = _host_f32(self.index.rotation)
            out[idx[valid]] = (data[valid] * float(self.index.scan_scale)) @ rot
        else:
            out[idx[valid]] = data[valid]
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Serve state to ``path`` + the main index to ``path + ".main"``
        (raft_tpu's layout)."""
        mod = _kind_module(self.kind)
        with self._lock:
            scalars = {
                "kind": self.kind,
                "main_size": self.main_size,
                "side_count": self._side_count,
                "next_id": self._next_id,
                "generation": self._generation,
                "n_structural": self._n_structural,
                "dim": self.dim,
            }
            arrays = {
                "deleted": self._deleted,
                "side_data": self._side_data,
                "side_ids": self._side_ids,
                "side_live": self._side_live,
            }
            if self._main_ids is not None:
                arrays["main_ids"] = self._main_ids
            tiered = getattr(self.index, "paged", None)
            if tiered is not None:
                # the paged layout survives the roundtrip: load
                # re-paginates at the same page size and re-warms the
                # saved residency set
                scalars["paged"] = 1
                scalars["page_rows"] = int(tiered.page_rows)
                scalars["pinned"] = int(bool(tiered.stats()["pinned"]))
                arrays["resident_pages"] = np.asarray(tiered.resident_pages())
            ser.save_tree(path, "serve_mutable", _SERVE_SERIALIZATION_VERSION, scalars, arrays)
        if self.kind == "cagra":
            mod.save(path + ".main", self.index, include_dataset=True)
        else:
            mod.save(path + ".main", self.index)

    @classmethod
    def load(cls, path: str, *, search_params=None,
             res: Optional[Resources] = None) -> "MutableIndex":
        """Load a :meth:`save` (the port's or raft_tpu's) onto ``res``'s
        device (the card unless the caller asks for the CPU)."""
        scalars, arrays = ser.load_tree(path, "serve_mutable", _SERVE_SERIALIZATION_VERSION)
        mod = _kind_module(scalars["kind"])
        index = mod.load(path + ".main", res=res)
        if scalars.get("paged"):
            from raft_tpu_torch.store import paginate_index

            tiered = paginate_index(
                index, page_rows=int(scalars["page_rows"]),
                name=f"load:{scalars['kind']}",
            )
            if int(scalars.get("pinned", 0)):
                tiered.pin_identity()
            else:
                resident = np.asarray(arrays.get("resident_pages", ()))
                if resident.size:
                    tiered.ensure_resident(resident.tolist())
        out = cls(index, kind=scalars["kind"], search_params=search_params,
                  main_ids=arrays.get("main_ids"))
        with out._lock:
            out._deleted = np.asarray(arrays["deleted"], dtype=bool)
            out._n_deleted = int(out._deleted.sum())
            out._side_data = np.asarray(arrays["side_data"], dtype=np.float32)
            out._side_ids = np.asarray(arrays["side_ids"], dtype=np.int64)
            out._side_live = np.asarray(arrays["side_live"], dtype=bool)
            out._side_count = int(scalars["side_count"])
            out._next_id = int(scalars["next_id"])
            out._generation = int(scalars["generation"])
            out._n_structural = int(scalars.get("n_structural", 0))
            out._refresh_snapshot_locked()
        return out
