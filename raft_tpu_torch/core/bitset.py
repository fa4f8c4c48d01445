"""Bitsets over 32-bit words: the pass filters of filtered search
(counterpart of ``raft_tpu.core.bitset``; the sample filter of the
reference is ``bitset_filter``, cpp/include/raft/neighbors/sample_filter_types.hpp).

raft_tpu keeps uint32 words; PyTorch's uint32 support is partial, so the
port keeps the same 32 bits in int32 tensors.  Bit j of word w covers id
32·w + j.  A bit is tested as ``(word >> j) & 1``: the copies of the sign
bit that an arithmetic shift brings in drop out at ``& 1``.
``Bitset.from_numpy`` / ``RowFilter.from_numpy`` take raft_tpu's uint32
words as they are (``.view(np.int32)``).

Every constructor takes a ``device``; without one the words land on the
device of the tensor they were made from, or on ``cuda`` (the port's
default) when they were made from numpy or from nothing.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

WORD_BITS = 32
_MASK32 = (1 << WORD_BITS) - 1

Device = Union[str, torch.device, None]


def _n_words(n_bits: int) -> int:
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def _device(device: Device, like=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cuda")


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a writable copy
    return torch.as_tensor(x).to(device)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → int32 carrying the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bool [..., n] → words [..., ceil(n / 32)] int32 (bit j of word w:
    element 32 w + j); bits past n are 0."""
    n = bits.shape[-1]
    nw = _n_words(n)
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, nw * WORD_BITS - n))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(*bits.shape[:-1], nw, WORD_BITS) << shifts).sum(dim=-1)
    return _wrap_i32(words)


def unpack_words(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Words [..., W] → bool [..., n_bits] (``n_bits <= 32 W``)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n_bits] == 1


def bits_at(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bit ``ids`` of the words [W], any shape of ids (negative ids read id
    0 and word indexes past the end read the last word, as JAX's clamped
    gathers in raft_tpu do)."""
    safe = ids.long().clamp(min=0)
    word = words[(safe // WORD_BITS).clamp(max=words.shape[-1] - 1)]
    return ((word >> (safe % WORD_BITS).to(torch.int32)) & 1) == 1


def _popcount_words(words: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each word (any shape) → int32 counts; the words are
    widened to int64 first, so no step depends on the sign bit."""
    x = words.to(torch.int64) & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _MASK32) >> 24).to(torch.int32)


def _tail_masked(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The words with the bits past ``n_bits`` of the last word cleared."""
    tail = n_bits - (words.shape[-1] - 1) * WORD_BITS
    if tail == WORD_BITS:
        return words
    out = words.clone()
    out[..., -1] &= (1 << tail) - 1
    return out


class Bitset:
    """A fixed-size set of ids as packed words (int32 tensor [W])."""

    def __init__(self, words: torch.Tensor, n_bits: int):
        self.words = words
        self.n_bits = int(n_bits)

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def create(cls, n_bits: int, default: bool = True, *, device: Device = None) -> "Bitset":
        fill = -1 if default else 0
        return cls(torch.full((_n_words(n_bits),), fill, dtype=torch.int32,
                              device=_device(device)), n_bits)

    @classmethod
    def from_mask(cls, mask, *, device: Device = None) -> "Bitset":
        """Pack a boolean vector [n_bits]."""
        dev = _device(device, mask)
        mask = _as_tensor(mask, dev).to(torch.bool)
        return cls(pack_bits(mask), mask.shape[0])

    @classmethod
    def from_numpy(cls, words_u32: np.ndarray, n_bits: int, *, device: Device = None) -> "Bitset":
        """raft_tpu's uint32 words (``np.asarray(bitset.words)``)."""
        words = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
        return cls(torch.from_numpy(words.copy()).to(_device(device)), n_bits)

    def test(self, idx) -> torch.Tensor:
        """Membership of each id of ``idx`` (any integer shape) → bool."""
        return bits_at(self.words, _as_tensor(idx, self.device))

    def set(self, idx, value: bool = True) -> "Bitset":
        """A new bitset with the bits of ``idx`` set (or cleared).  The ids
        go through a boolean mask, so a repeated id, or several ids in one
        word, all take effect."""
        idx = _as_tensor(idx, self.device).long().reshape(-1)
        mask = torch.zeros(self.n_bits, dtype=torch.bool, device=self.device)
        mask[idx] = True
        touched = pack_bits(mask)
        words = self.words | touched if value else self.words & ~touched
        return Bitset(words, self.n_bits)

    def flip(self) -> "Bitset":
        return Bitset(~self.words, self.n_bits)

    def count(self) -> int:
        """Set bits among the first ``n_bits`` (a host int)."""
        return int(_popcount_words(_tail_masked(self.words, self.n_bits)).sum())

    def to_mask(self) -> torch.Tensor:
        return unpack_words(self.words, self.n_bits)


class RowFilter:
    """One pass bitset per query row: ``words`` [rows, W] int32.

    ``fid`` [rows] / ``table`` [n_filters, W] optionally carry the
    descriptor form (each row's filter id into a table of filters); the
    IVF searches then scan with each query's own plane of the table packed
    per list (kernel leg ``query_fid``).  ``pass_count`` is a host-int
    lower bound on the passing ids of any row; :meth:`count` reads it
    before it counts."""

    def __init__(self, words: torch.Tensor, n_bits: int, *, fid: Optional[torch.Tensor] = None,
                 table: Optional[torch.Tensor] = None, pass_count: Optional[int] = None):
        self.words = words
        self.n_bits = int(n_bits)
        self.fid = fid
        self.table = table
        self.pass_count = pass_count

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def from_mask_rows(cls, masks, *, device: Device = None) -> "RowFilter":
        """Pack a boolean [rows, n_bits] matrix into per-row words."""
        dev = _device(device, masks)
        masks = _as_tensor(masks, dev).to(torch.bool)
        return cls(pack_bits(masks), masks.shape[1])

    @classmethod
    def from_table(cls, table, fid, n_bits: int, *, pass_count: Optional[int] = None,
                   device: Device = None) -> "RowFilter":
        """From a filter table [n_filters, W] (int32 words, or raft_tpu's
        uint32 words as numpy) and each row's filter id [rows]."""
        dev = _device(device, table)
        if isinstance(table, np.ndarray) and table.dtype == np.uint32:
            table = table.view(np.int32)
        table = _as_tensor(table, dev).to(torch.int32)
        if isinstance(fid, np.ndarray):
            # checked on the host, before the upload: no device read
            fid = fid.reshape(-1).astype(np.int64)
            bad = fid.size and (int(fid.min()) < 0 or int(fid.max()) >= table.shape[0])
            fid = _as_tensor(fid, dev)
        else:
            fid = _as_tensor(fid, dev).to(torch.int64).reshape(-1)
            bad = fid.numel() and (int(fid.min()) < 0 or int(fid.max()) >= table.shape[0])
        if bad:
            raise ValueError(f"filter ids must lie in [0, {table.shape[0]})")
        return cls(table[fid], n_bits, fid=fid.to(torch.int32), table=table,
                   pass_count=pass_count)

    @classmethod
    def from_numpy(cls, words_u32: np.ndarray, n_bits: int, *, device: Device = None
                   ) -> "RowFilter":
        """raft_tpu's uint32 words [rows, W], no descriptor."""
        words = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
        return cls(torch.from_numpy(words.copy()).to(_device(device)), n_bits)

    def test_rows(self, ids) -> torch.Tensor:
        """Row r's membership of each id of ``ids`` [rows, ...] → bool."""
        ids = _as_tensor(ids, self.device).long()
        r = ids.shape[0]
        safe = ids.clamp(min=0)
        w = (safe // WORD_BITS).clamp(max=self.words.shape[1] - 1).reshape(r, -1)
        word = torch.gather(self.words, 1, w).reshape(ids.shape)
        return ((word >> (safe % WORD_BITS).to(torch.int32)) & 1) == 1

    def count(self) -> int:
        """The least passing population of any row (a host int)."""
        if self.pass_count is not None:
            return int(self.pass_count)
        per_row = _popcount_words(_tail_masked(self.words, self.n_bits)).sum(dim=1)
        return int(per_row.min())
