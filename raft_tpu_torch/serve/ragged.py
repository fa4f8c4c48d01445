"""Continuous ragged batching (counterpart of ``raft_tpu.serve.ragged``):
one packed dispatch for heterogeneous requests.

Every dispatch computes the spec's ``k_max`` result columns; each
request's own ``k`` rides in a ``[cap]`` int column that
:func:`raft_tpu_torch.ops.matrix.mask_row_k` applies (positions past a
row's k surface as id -1 at the worst distance), and the future slices its
``[:k]`` columns after copy-out.  Filters are registered up front in a
:class:`FilterRegistry`, packed as rows of one ``[F, W]`` uint32 table; a
request carries only its ``fid`` (0 is the all-pass row).  The dispatcher
turns the batch's fids into a ``RowFilter`` through
``RowFilter.from_table`` (the table uploaded once per registry version),
whose ``fid`` / ``table`` descriptor is what sends the IVF searches to the
scan kernels' ``query_fid`` leg (kernel #6).  Tombstones compose unchanged:
the mutable search folds the deleted mask into each row's pass words.

Register filters before warmup.  Admission turns continuous with the
pipeline enabled: the batcher claims the in-flight slot before cutting the
batch, so requests keep packing while the device window is full.

A ``ShardedIndex`` behind the searcher (raft_tpu's other branch) is
multi-GPU serving: it raises, naming ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.bitset import Bitset, RowFilter
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import explain as _explain
from raft_tpu_torch.serve.mutation import MutableIndex, _host


def _params_info(search_params) -> Optional[dict]:
    """Host-side summary of a SearchParams object for explain stamps —
    only the effort-relevant Python values, never the object itself."""
    if search_params is None:
        return None
    out = {}
    for attr in ("n_probes", "itopk_size", "search_width", "lut_dtype"):
        val = getattr(search_params, attr, None)
        if val is not None:
            out[attr] = str(val) if attr == "lut_dtype" else val
    return out or None


@dataclass(frozen=True)
class RaggedSpec:
    """Ragged-mode configuration for a service (or one batcher).

    ``k_max`` is the static top-k capacity every dispatch computes;
    per-request k may not exceed it.  ``filters`` controls whether the
    per-request filter-id column is wired through (off saves the
    RowFilter gather for services that never register filters).
    """

    k_max: int = 32
    filters: bool = True

    @classmethod
    def from_env(cls) -> "RaggedSpec":
        return cls(
            k_max=_env.env_int("RAFT_TPU_RAGGED_KMAX", 32),
            filters=_env.env_bool("RAFT_TPU_RAGGED_FILTERS", True),
        )


class FilterRegistry:
    """Registered sample filters for one ragged-served index.

    Filters pack as rows of one ``[F, W] uint32`` table over a fixed
    global-id space of ``n_bits`` ids; requests reference them by row
    index (fid).  fid 0 is the reserved all-pass row.  Registration is
    append-only — fids stay stable for the life of the served index.

    Semantics: a filter *allows* exactly the ids whose bit is set.  Ids
    past a registered mask's length are denied (zero-filled), but ids
    past the registry's own ``n_bits`` — e.g. side-buffer rows upserted
    after construction — pass every filter (the serve layer treats
    uncovered ids as unconstrained; see ``MutableIndex._side_passes``).
    """

    def __init__(self, n_bits: int):
        if n_bits < 1:
            raise ValueError(f"n_bits must be >= 1, got {n_bits}")
        self.n_bits = int(n_bits)
        self._n_words = (self.n_bits + 31) // 32
        self._lock = threading.Lock()
        all_pass = np.full((1, self._n_words), 0xFFFFFFFF, dtype=np.uint32)
        tail = self.n_bits % 32
        if tail:
            # mask the tail bits so pass counts (cagra's search-width
            # input) stay exact
            all_pass[0, -1] = np.uint32((1 << tail) - 1)
        self._table = all_pass
        self._pass_counts = [self.n_bits]

    def __len__(self) -> int:
        with self._lock:
            return self._table.shape[0]

    def register(self, mask) -> int:
        """Register one filter; returns its fid.

        ``mask`` is a bool array over global ids (shorter than ``n_bits``
        is zero-extended: uncovered ids are denied) or a
        :class:`~raft_tpu_torch.core.bitset.Bitset`.
        """
        if isinstance(mask, Bitset):
            if mask.n_bits > self.n_bits:
                raise ValueError(
                    f"filter covers {mask.n_bits} ids but the registry "
                    f"was sized for {self.n_bits}"
                )
            src = np.ascontiguousarray(_host(mask.words)).view(np.uint32)
            words = np.zeros((self._n_words,), dtype=np.uint32)
            words[: src.shape[0]] = src
            count = int(np.unpackbits(
                words.view(np.uint8), bitorder="little"
            ).sum())
        else:
            mask = np.asarray(mask, dtype=bool).reshape(-1)
            if mask.shape[0] > self.n_bits:
                raise ValueError(
                    f"filter covers {mask.shape[0]} ids but the registry "
                    f"was sized for {self.n_bits}"
                )
            padded = np.zeros((self._n_words * 32,), dtype=np.uint8)
            padded[: mask.shape[0]] = mask
            words = np.packbits(padded, bitorder="little").view(np.uint32)
            count = int(mask.sum())
        with self._lock:
            fid = self._table.shape[0]
            # replace, never mutate: snapshot() hands out the old array
            # without copying and dispatches may still hold it
            self._table = np.concatenate(
                [self._table, words[None, :]], axis=0
            )
            self._pass_counts.append(count)
        return fid

    def contains(self, fid: int) -> bool:
        with self._lock:
            return 0 <= fid < self._table.shape[0]

    def snapshot(self) -> Tuple[np.ndarray, int]:
        """(table [F, W], min pass count) — one consistent view.

        The min pass count is the registry-wide floor, pinned so CAGRA's
        filter-aware search widening sees the same host int on every batch
        whichever fids are present; it changes only on registration.
        """
        with self._lock:
            return self._table, min(self._pass_counts)


class RaggedSearcher:
    """The batcher-facing search fn for one ragged-served index.

    ``__call__(queries [cap, d], row_k [cap], row_fid [cap])`` resolves the
    registry once per batch (the hot-swap atomicity boundary), builds the
    batch's ``RowFilter`` from the filter table, and runs the merged
    mutable search at the spec's ``k_max`` with per-row k masking.
    ``row_fid`` is read on the host (the batcher passes it as a host
    array, so building the filter reads nothing back from the card)."""

    def __init__(self, service, name: str, spec: RaggedSpec,
                 filters: Optional[FilterRegistry], degraded=None,
                 effort=None):
        self._service = service
        self._name = name
        self._spec = spec
        self._filters = filters
        # optional serve.overload.DegradedModeManager: under sustained
        # pressure its level prescribes reduced-effort search params
        self._degraded = degraded
        # optional serve.effort.EffortArbiter: when present it is the single
        # source of the effective effort level
        self._effort = effort
        # (host table, its device copy): the registry replaces its table
        # on registration, so the identity of the host array keys the copy
        self._table_cache: Tuple[Optional[np.ndarray], Optional[torch.Tensor]] = (None, None)

    @property
    def filters(self) -> Optional[FilterRegistry]:
        return self._filters

    def _device_table(self, table: np.ndarray, device: torch.device) -> torch.Tensor:
        host, dev = self._table_cache
        if host is not table or dev is None or dev.device != device:
            dev = torch.from_numpy(np.ascontiguousarray(table).view(np.int32).copy()).to(device)
            self._table_cache = (table, dev)
        return dev

    @traced("serve.ragged.dispatch")
    def __call__(self, queries, row_k, row_fid):
        # resolve once per BATCH: the whole packed batch is answered by one
        # index version (hot-swap atomicity boundary)
        index, _version = self._service.registry.get_versioned(self._name)
        if not isinstance(index, MutableIndex):
            raise NotImplementedError(
                "ragged serving of a sharded index is multi-GPU serving "
                "(ROADMAP Queue 1 item 7)")
        sample_filter = None
        if self._filters is not None:
            table, min_pass = self._filters.snapshot()
            sample_filter = RowFilter.from_table(
                self._device_table(table, index.device),
                _host(row_fid).astype(np.int32), self._filters.n_bits,
                pass_count=min_pass, device=index.device,
            )
        search_params = None
        if self._effort is not None:
            # arbitrated effort level (overload clamp); every (bucket,
            # level) variant was warmed by the batcher's level-pinned warmup
            search_params = self._effort.apply(index)
        elif self._degraded is not None:
            search_params = self._degraded.params_for(index)
        if _explain.enabled():
            # effective effort params handed to the backend, recorded where
            # the decision is made
            _explain.stamp_dispatch({
                "k_max": self._spec.k_max,
                "filters": sample_filter is not None,
                "effort_params": _params_info(search_params),
            })
        return index.search(
            queries, self._spec.k_max,
            sample_filter=sample_filter, row_k=row_k,
            search_params=search_params,
        )
